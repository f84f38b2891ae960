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
v2v_tpu_torch/csrc/dynconv_bwd.cu with a block per (tile, batch item,
group of atoms) each, their tiles loaded by TMA (design and bound
there). It replaces
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
import functools

import torch

from ._build import CudaLibrary, check, stream

KERNEL_SIZE = 5          # the kernel's k (csrc/dynconv.cu kK)
CHANNELS_PER_BLOCK = 128  # csrc/dynconv.cu kCo, 4 a lane
TILE_COLS = 8             # csrc/dynconv.cu kTw; a tile has 4 or 8 rows
TAPS_PADDED = 8           # csrc/dynconv.cu kAp: an offset row's 5 taps
# csrc/dynconv_bwd.cu kDzRows, kDaRows: the gradient kernels' tile rows
DZ_ROWS, DATOMS_ROWS = 8, 4
# csrc/dynconv_bwd.cu's errors besides cudaError_t values
_BWD_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled",
               -2: "cuTensorMapEncodeTiled refused a tensor map"}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.v2v_shift_sum.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.v2v_shift_sum.restype = i


def _bind_bwd(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.v2v_shift_sum_bwd.argtypes = [p, p, p, ll, ll, ll, ll, p, p,
                                      i, i, i, i, i, i, i, i, p]
    lib.v2v_shift_sum_bwd.restype = i
    pi = ctypes.POINTER(ctypes.c_int)
    lib.v2v_shift_sum_bwd_occupancy.argtypes = [i, pi, pi]
    lib.v2v_shift_sum_bwd_occupancy.restype = i


LIB = CudaLibrary("dynconv.cu", bind=_bind)
LIB_BWD = CudaLibrary("dynconv_bwd.cu", bind=_bind_bwd)


def _smem_bytes(rows: int, z_itemsize: int) -> int:
    """The kernel's dynamic shared memory: one atom's haloed (rows+4) x 12
    z tile of 128 channels in z's own type, then the tile's taps of that
    atom, each offset row's 5 padded to 8, float32."""
    halo = KERNEL_SIZE - 1
    z_tile = (rows + halo) * (TILE_COLS + halo) * CHANNELS_PER_BLOCK
    taps = rows * TILE_COLS * KERNEL_SIZE * TAPS_PADDED
    return z_tile * z_itemsize + taps * 4


def _tile_rows(b: int, h: int, w: int, co: int, sms: int) -> int:
    """8-row tiles, or 4-row ones where 8 would give the card fewer than
    two blocks an SM (the train shape: 384 blocks against 192 on 132)."""
    blocks = (b * -(-h // 8) * -(-w // TILE_COLS)
              * -(-co // CHANNELS_PER_BLOCK))
    return 8 if blocks >= 2 * sms else 4


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


@functools.cache
def _sm_count(index: int | None) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _shift_sum_kernel(z: torch.Tensor, atoms: torch.Tensor, k: int,
                      rows: int | None = None) -> torch.Tensor:
    """K4 on the card (csrc/dynconv.cu) with tiles of `rows` (4 or 8,
    default `_tile_rows`) x 8 outputs."""
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
    if min(b, h, w, m, co) == 0 or b > 65535:
        raise ValueError(f"dynamic_shift_sum: z {tuple(z.shape)} is empty "
                         f"or has B > 65535")
    if z.device.type != "cuda":
        raise ValueError(f"dynamic_shift_sum: the kernel takes CUDA tensors, "
                         f"got {z.device}")
    if rows is None:
        rows = _tile_rows(b, h, w, co, _sm_count(z.device.index))
    out = torch.empty((b, h, w, co), dtype=torch.float32, device=z.device)
    err = LIB.get().v2v_shift_sum(
        z.data_ptr(), atoms.data_ptr(), out.data_ptr(), b, h, w, m, co,
        int(z.dtype == torch.bfloat16), rows, stream())
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


def _bwd_blocks(b: int, h: int, w: int, m: int, co: int, tiling
                ) -> tuple[int, int]:
    """Blocks of the dz and datoms kernels under `tiling`, (dz atoms a
    block, datoms atoms a block): one per tile (DZ_ROWS or DATOMS_ROWS x
    8), batch item and group of atoms, and for dz per 128-channel chunk
    too. dz's tiles start 2 columns left of a multiple of 8 (its TMA box
    of g must start 16-byte aligned), so a row of the image takes one
    more of them where W is a multiple of 8."""
    dz_atoms, da_atoms = tiling
    dz = (-(-h // DZ_ROWS) * -(-(w + 2) // TILE_COLS) * b * -(-m // dz_atoms)
          * -(-co // CHANNELS_PER_BLOCK))
    return dz, (-(-h // DATOMS_ROWS) * -(-w // TILE_COLS) * b
                * -(-m // da_atoms))


@functools.cache
def _bwd_tiling(b: int, h: int, w: int, m: int, co: int, sms: int
                ) -> tuple[int, int]:
    """The gradient kernels' atoms a block, as `_bwd_blocks` takes them:
    for each kernel the most that still gives every SM a block (at the
    train shape all 6: 240 dz and 384 datoms blocks on 132 SMs). More
    atoms a block read the g tile fewer times. Cached: the wrapper asks
    on every call."""
    def atoms(which: int) -> int:
        return max(a for a in range(1, m + 1) if a == 1 or _bwd_blocks(
            b, h, w, m, co, (a, a))[which] >= sms)
    return atoms(0), atoms(1)


def _bwd_smem_bytes(z_itemsize: int) -> tuple[int, int]:
    """The gradient kernels' dynamic shared memory (csrc/dynconv_bwd.cu).
    dz: the haloed (DZ_ROWS+4) x 12 g tile of 128 channels, float32; one
    atom's taps of the haloed tile, each offset row's 5 padded to 8; the
    next atom's taps as they arrive. datoms: the haloed (DATOMS_ROWS+4) x
    12 z tile of one atom in z's own type (two of them for bfloat16 z: the
    next atom's lands during the sums), then the tile's g, float32. Each
    adds an mbarrier (16 B) a TMA destination and the 128 B that align the
    tiles for TMA."""
    halo = KERNEL_SIZE - 1
    taps = KERNEL_SIZE * KERNEL_SIZE
    pixels = (DZ_ROWS + halo) * (TILE_COLS + halo)
    dz = (pixels * (CHANNELS_PER_BLOCK + KERNEL_SIZE * TAPS_PADDED + taps)
          * 4 + 16 + 128)
    pixels = (DATOMS_ROWS + halo) * (TILE_COLS + halo)
    buffers = 2 if z_itemsize == 2 else 1
    datoms = (buffers * (pixels * CHANNELS_PER_BLOCK * z_itemsize + 16)
              + DATOMS_ROWS * TILE_COLS * CHANNELS_PER_BLOCK * 4 + 128)
    return dz, datoms


def _bwd_blocks_per_sm(z_bf16: bool) -> tuple[int, int]:
    """Blocks an SM of the dz and datoms kernels, as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them on the
    current device."""
    dz, da = ctypes.c_int(), ctypes.c_int()
    check(LIB_BWD.get().v2v_shift_sum_bwd_occupancy(
        int(z_bf16), ctypes.byref(dz), ctypes.byref(da)),
        "dynamic_shift_sum_backward occupancy")
    return dz.value, da.value


def _shift_sum_bwd_kernel(z: torch.Tensor, atoms: torch.Tensor,
                          g: torch.Tensor, k: int, tiling=None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's gradient on the card (csrc/dynconv_bwd.cu): the dz kernel,
    then the datoms kernel, each with the atoms a block of `tiling` (dz,
    datoms), default `_bwd_tiling`."""
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
    if min(b, h, w, m, co) == 0 or max(b, m * -(-co // CHANNELS_PER_BLOCK)) \
            > 65535:
        raise ValueError(f"dynamic_shift_sum_backward: z {tuple(z.shape)} "
                         f"is empty or has B or M * chunks > 65535")
    if z.device.type != "cuda" or atoms.device != z.device or \
            g.device != z.device:
        raise ValueError(f"dynamic_shift_sum_backward: z, atoms and g must "
                         f"lie on one CUDA device, got {z.device}, "
                         f"{atoms.device}, {g.device}")
    if tiling is None:
        tiling = _bwd_tiling(b, h, w, m, co, _sm_count(z.device.index))
    dz = torch.empty(z.shape, dtype=z.dtype, device=z.device)
    da = torch.empty(atoms.shape, dtype=torch.float32, device=z.device)
    err = LIB_BWD.get().v2v_shift_sum_bwd(
        z.data_ptr(), atoms.data_ptr(), g.data_ptr(), *g.stride(),
        dz.data_ptr(), da.data_ptr(), b, h, w, m, co,
        int(z.dtype == torch.bfloat16), *tiling, stream())
    if err in _BWD_ERRORS:
        raise RuntimeError(f"dynamic_shift_sum_backward: {_BWD_ERRORS[err]}")
    check(err, "dynamic_shift_sum_backward")
    dynamic_shift_sum_backward.launches += 1
    return dz, da


def dynamic_shift_sum_backward(z: torch.Tensor, atoms: torch.Tensor,
                               g: torch.Tensor, k: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's gradient: (dz, datoms) of dynamic_shift_sum(z, atoms, k) under
    the cotangent g (B,H,W,CO). For CUDA tensors it launches the two
    kernels of csrc/dynconv_bwd.cu (dz, then datoms) and adds one to
    `dynamic_shift_sum_backward.launches` for the pair; it raises unless z
    is float32 or bfloat16, atoms and g float32, k = 5, the shapes agree,
    z and atoms are contiguous, B <= 65535 and M times the 128-channel
    chunks of CO <= 65535. g may have any strides (the model hands back an
    NCHW tensor's (B,H,W,CO) view), so it is read in place, not copied.
    dz comes out in z's type, datoms in float32. For CPU tensors it runs
    dynamic_shift_sum_backward_plain."""
    if z.device.type == "cpu" and atoms.device == g.device == z.device:
        return dynamic_shift_sum_backward_plain(z, atoms, g, k)
    return _shift_sum_bwd_kernel(z, atoms, g, k)


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
