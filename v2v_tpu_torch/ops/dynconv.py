"""HyperE2VID's dynamic shift-sum K4 as a CUDA kernel, with its plain
PyTorch version.

    out[b,y,x,o] = sum_{l, m} atoms[b,y,x,m,l] * zpad[b,y+dy_l,x+dx_l,m,o]

`dynamic_shift_sum` replaces v2v_tpu/ops/dynconv.py::dynamic_shift_sum
(Pallas body `_fwd_kernel`) and keeps its public layout: z (B,H,W,M,CO)
in float32 or bfloat16, atoms (B,H,W,M,k*k) float32, out (B,H,W,CO)
float32; the window offset l = i*k + j is torch-unfold row-major. The
source is v2v_tpu_torch/csrc/dynconv.cu (design and bound there), built
at first use (ops/_build.py).

Gradients go through `_ShiftSum`, whose backward is
`dynamic_shift_sum_backward`: dz as a gather of the 25 mirrored source
pixels and datoms as a per-pixel channel reduction, two kernels in
v2v_tpu_torch/csrc/dynconv_bwd.cu (design and bound there). It replaces
the JAX package's jnp `_shift_sum_bwd`, which has no Pallas kernel (its
fused Pallas backward was retired for an on-chip mismatch); that loop,
carried over to PyTorch, is `dynamic_shift_sum_backward_plain`.

Given CUDA tensors the forward and the backward launch their kernels
(and add one to `dynamic_shift_sum.launches` or
`dynamic_shift_sum_backward.launches`) or raise; they run their plain
versions only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaLibrary, check, stream

KERNEL_SIZE = 5          # the kernel's k (csrc/dynconv.cu kK)
CHANNELS_PER_BLOCK = 128  # csrc/dynconv.cu kCo
TILE = 8                  # csrc/dynconv.cu kTh = kTw
SMEM_LIMIT = 232_448      # dynamic shared memory a block may opt into


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.v2v_shift_sum.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.v2v_shift_sum.restype = i


def _bind_bwd(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.v2v_shift_sum_bwd.argtypes = [p, p, p, ll, ll, ll, ll, p, p,
                                      i, i, i, i, i, i, p]
    lib.v2v_shift_sum_bwd.restype = i


LIB = CudaLibrary("dynconv.cu", bind=_bind)
LIB_BWD = CudaLibrary("dynconv_bwd.cu", bind=_bind_bwd)


def _smem_bytes(m: int) -> int:
    """The kernel's dynamic shared memory: the tile's atoms and one
    atom's haloed z tile, both float32."""
    halo = TILE + KERNEL_SIZE - 1
    return 4 * (TILE * TILE * m * KERNEL_SIZE ** 2
                + halo * halo * CHANNELS_PER_BLOCK)


def _pad32(z: torch.Tensor, k: int) -> torch.Tensor:
    """z widened to float32 (exactly) and zero-padded by k//2 in H, W."""
    p = k // 2
    return torch.nn.functional.pad(z.to(torch.float32),
                                   (0, 0, 0, 0, p, p, p, p))


def _shifted(zp: torch.Tensor, l: int, k: int, h: int, w: int
             ) -> torch.Tensor:
    i, j = divmod(l, k)
    return zp[:, i:i + h, j:j + w]


def dynamic_shift_sum_plain(z: torch.Tensor, atoms: torch.Tensor, k: int
                            ) -> torch.Tensor:
    """The 25-slice loop of v2v_tpu/models/hyper.py DynamicConv: zero-pad
    z by k//2, then for each window offset add the atom-weighted sum over
    m of the shifted slice, in float32. A broadcast multiply and a sum,
    not a matmul, so no TF32 rounding reaches it on the card."""
    b, h, w, _, co = z.shape
    zp = _pad32(z, k)
    atoms = atoms.to(torch.float32)
    out = torch.zeros((b, h, w, co), dtype=torch.float32, device=z.device)
    for l in range(k * k):
        out = out + (atoms[..., l, None] * _shifted(zp, l, k, h, w)).sum(
            dim=3)
    return out


def _shift_sum_kernel(z: torch.Tensor, atoms: torch.Tensor, k: int
                      ) -> torch.Tensor:
    if z.dtype not in (torch.float32, torch.bfloat16) or \
            atoms.dtype != torch.float32 or atoms.device != z.device:
        raise ValueError(f"dynamic_shift_sum: z must be float32 or bfloat16 "
                         f"and atoms float32 on {z.device}, got z {z.dtype}, "
                         f"atoms {atoms.dtype} on {atoms.device}")
    if z.dim() != 5 or not z.is_contiguous() or not atoms.is_contiguous():
        raise ValueError("dynamic_shift_sum: z (B,H,W,M,CO) and atoms "
                         "(B,H,W,M,L) must be contiguous")
    b, h, w, m, co = z.shape
    if k != KERNEL_SIZE or atoms.shape != (b, h, w, m, k * k):
        raise ValueError(f"dynamic_shift_sum: z {tuple(z.shape)}, atoms "
                         f"{tuple(atoms.shape)}, k {k}; the kernel takes "
                         f"k = {KERNEL_SIZE} and atoms (B,H,W,M,k*k)")
    if min(b, h, w, m, co) == 0 or b > 65535 or _smem_bytes(m) > SMEM_LIMIT:
        raise ValueError(f"dynamic_shift_sum: z {tuple(z.shape)} is empty, "
                         f"has B > 65535 or M too large for shared memory")
    out = torch.empty((b, h, w, co), dtype=torch.float32, device=z.device)
    err = LIB.get().v2v_shift_sum(
        z.data_ptr(), atoms.data_ptr(), out.data_ptr(), b, h, w, m, co,
        int(z.dtype == torch.bfloat16), stream())
    check(err, "dynamic_shift_sum")
    dynamic_shift_sum.launches += 1
    return out


def dynamic_shift_sum_backward_plain(z: torch.Tensor, atoms: torch.Tensor,
                                    g: torch.Tensor, k: int
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's jnp backward (_shift_sum_bwd) in plain PyTorch:
    for each window offset, datoms[..., l] is the channel sum of g times
    the shifted z, and a_l * g is added into the window of a zero-padded
    float32 dz (the transposed shift-sum). Returns dz in z's type and
    datoms in atoms' type; ~117 launches a call on the card."""
    h, w = z.shape[1:3]
    p = k // 2
    g32 = g.to(torch.float32)[:, :, :, None, :]          # (B,H,W,1,CO)
    a32 = atoms.to(torch.float32)
    zp = _pad32(z, k)
    dzp = torch.zeros_like(zp)
    da = torch.empty(atoms.shape, dtype=torch.float32, device=z.device)
    for l in range(k * k):
        # datoms[..., l] = <g, shift_l(z)> over channels
        da[..., l] = (_shifted(zp, l, k, h, w) * g32).sum(dim=4)
        # dz_m[window l] += a_l * g (the transposed shift-sum)
        _shifted(dzp, l, k, h, w).add_(a32[..., l, None] * g32)
    dz = dzp[:, p:p + h, p:p + w]
    return dz.to(z.dtype), da.to(atoms.dtype)


def dynamic_shift_sum_backward(z: torch.Tensor, atoms: torch.Tensor,
                               g: torch.Tensor, k: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's gradient: (dz, datoms) of dynamic_shift_sum(z, atoms, k) under
    the cotangent g (B,H,W,CO). For CUDA tensors it launches the two
    kernels of csrc/dynconv_bwd.cu (dz, then datoms) and adds one to
    `dynamic_shift_sum_backward.launches` for the pair; it raises unless z
    is float32 or bfloat16, atoms and g float32, k = 5, the shapes agree,
    z and atoms are contiguous and B, M <= 65535. g may have any strides (the
    model hands back an NCHW tensor's (B,H,W,CO) view), so it is read in
    place, not copied. The kernels' shared memory (99,072 and 109,824 B)
    does not depend on the shape. dz comes out in z's type, datoms in
    float32. For CPU tensors it runs dynamic_shift_sum_backward_plain."""
    if z.device.type == "cpu" and atoms.device == g.device == z.device:
        return dynamic_shift_sum_backward_plain(z, atoms, g, k)
    if z.device.type != "cuda" or atoms.device != z.device or \
            g.device != z.device:
        raise ValueError(f"dynamic_shift_sum_backward: z, atoms and g must "
                         f"lie on one CUDA device, got {z.device}, "
                         f"{atoms.device}, {g.device}")
    if z.dtype not in (torch.float32, torch.bfloat16) or \
            atoms.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"dynamic_shift_sum_backward: z must be float32 or "
                         f"bfloat16, atoms and g float32, got z {z.dtype}, "
                         f"atoms {atoms.dtype}, g {g.dtype}")
    if z.dim() != 5 or not z.is_contiguous() or not atoms.is_contiguous():
        raise ValueError("dynamic_shift_sum_backward: z (B,H,W,M,CO) and "
                         "atoms (B,H,W,M,L) must be contiguous")
    b, h, w, m, co = z.shape
    if k != KERNEL_SIZE or atoms.shape != (b, h, w, m, k * k) or \
            g.shape != (b, h, w, co):
        raise ValueError(f"dynamic_shift_sum_backward: z {tuple(z.shape)}, "
                         f"atoms {tuple(atoms.shape)}, g {tuple(g.shape)}, "
                         f"k {k}; the kernels take k = {KERNEL_SIZE}, atoms "
                         f"(B,H,W,M,k*k) and g (B,H,W,CO)")
    if min(b, h, w, m, co) == 0 or max(b, m) > 65535:
        raise ValueError(f"dynamic_shift_sum_backward: z {tuple(z.shape)} "
                         f"is empty or has B or M > 65535")
    dz = torch.empty(z.shape, dtype=z.dtype, device=z.device)
    da = torch.empty(atoms.shape, dtype=torch.float32, device=z.device)
    err = LIB_BWD.get().v2v_shift_sum_bwd(
        z.data_ptr(), atoms.data_ptr(), g.data_ptr(), *g.stride(),
        dz.data_ptr(), da.data_ptr(), b, h, w, m, co,
        int(z.dtype == torch.bfloat16), stream())
    check(err, "dynamic_shift_sum_backward")
    dynamic_shift_sum_backward.launches += 1
    return dz, da


dynamic_shift_sum_backward.launches = 0


class _ShiftSum(torch.autograd.Function):
    """K4 forward and its gradient: kernels for CUDA tensors, the plain
    versions for CPU tensors."""

    @staticmethod
    def forward(ctx, z, atoms, k):
        ctx.k = k
        ctx.save_for_backward(z, atoms)
        if z.device.type != "cuda":
            return dynamic_shift_sum_plain(z, atoms, k)
        return _shift_sum_kernel(z, atoms, k)

    @staticmethod
    def backward(ctx, g):
        z, atoms = ctx.saved_tensors
        dz, da = dynamic_shift_sum_backward(z, atoms, g, ctx.k)
        return dz, da, None


def dynamic_shift_sum(z: torch.Tensor, atoms: torch.Tensor,
                      kernel_size: int) -> torch.Tensor:
    """Atom-weighted k*k shift-sum. z (B,H,W,M,CO) float32 or bfloat16,
    atoms (B,H,W,M,k*k) -> (B,H,W,CO) float32. Launches K4 for CUDA
    tensors (contiguous, k = 5), runs the plain loop for CPU tensors."""
    return _ShiftSum.apply(z, atoms, kernel_size)


dynamic_shift_sum.launches = 0
