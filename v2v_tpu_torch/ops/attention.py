"""Long-sequence attention K3 as a CUDA kernel, with its plain PyTorch
version.

`attention` replaces v2v_tpu/models/eitr.py::_flash_attention_padded:
softmax(Q K^T / sqrt(dh)) V over every key, float32, on (B, h, N, dh)
tensors with dh = 32. The source is v2v_tpu_torch/csrc/attention.cu
(design and bound there: wgmma and TMA, three TF32 passes for float32
accuracy), built at first use (ops/_build.py).

Given CUDA tensors the wrapper launches the kernel (and adds one to
`attention.launches`: one call is one launch, though it runs the split
pre-pass and the attention kernel) or raises; it runs `attention_plain`
only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import CudaLibrary, check, stream

HEAD_DIM = 32           # the kernel's dh (csrc/attention.cu kDh)
QUERY_BLOCK = 2048      # attention_plain's query block (eitr.py:111)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.v2v_attention.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, i, i,
                                  ctypes.c_float, p]
    lib.v2v_attention.restype = i
    lib.v2v_attention_key_tile.restype = i
    lib.v2v_attention_smem_bytes.restype = i


LIB = CudaLibrary("attention.cu", bind=_bind)
# v2v_attention's own return codes, beside CUDA's errors
_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled",
           -2: "the scratch is too small",
           -3: "cuTensorMapEncodeTiled refused a tensor map"}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """The chunked query-block attention of v2v_tpu/models/eitr.py:110-125:
    per block of 2048 queries, float32 logits divided by sqrt(dh),
    softmax over the keys, product with V. Never holds more than one
    (B, h, 2048, Nk) block of logits."""
    scale = math.sqrt(q.shape[-1])
    kt = k.transpose(-1, -2)
    outs = []
    for i in range(0, q.shape[2], QUERY_BLOCK):
        logits = torch.matmul(q[:, :, i:i + QUERY_BLOCK], kt) / scale
        outs.append(torch.matmul(torch.softmax(logits, dim=-1), v))
    return torch.cat(outs, dim=2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """q (B, h, Nq, dh), k and v (B, h, Nk, dh) float32 -> (B, h, Nq, dh).
    Launches K3 for CUDA tensors (contiguous, dh = 32), runs the plain
    version for CPU tensors."""
    if q.device.type != "cuda":
        return attention_plain(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"attention: {name} must be float32 on "
                             f"{q.device}, got {t.dtype} on {t.device}")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"attention: {name} must be a contiguous, "
                             f"16-byte aligned (B, h, N, dh) tensor")
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    if dh != HEAD_DIM or k.shape != (b, h, nk, dh) or v.shape != k.shape:
        raise ValueError(f"attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; the kernel "
                         f"takes dh = {HEAD_DIM}")
    if nq == 0 or nk == 0 or not 0 < b * h <= 65535:
        raise ValueError(f"attention: B*h = {b * h} must be in [1, 65535] "
                         f"and Nq = {nq}, Nk = {nk} nonzero")
    lib = LIB.get()
    tile = lib.v2v_attention_key_tile()
    nk_pad = -(-nk // tile) * tile
    if b * h * nk_pad >= 2 ** 31:
        raise ValueError(f"attention: B*h*Nk = {b * h * nk_pad} keys exceed "
                         f"the kernel's 32-bit TMA coordinates")
    # K_hi, K_lo, Vt_hi, Vt_lo, each (B*h, Nk rounded up to the key tile,
    # dh) floats; the caching allocator hands this memory to later work on
    # the same stream only, after the kernels that use it
    scratch = torch.empty(4 * b * h * nk_pad * dh, dtype=torch.float32,
                          device=q.device)
    o = torch.empty_like(q)
    err = lib.v2v_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        scratch.data_ptr(), scratch.numel(), b * h, nq, nk,
        math.log2(math.e) / math.sqrt(dh), stream())
    if err in _ERRORS:
        raise RuntimeError(f"attention: {_ERRORS[err]}")
    check(err, "attention")
    attention.launches += 1
    return o


attention.launches = 0
