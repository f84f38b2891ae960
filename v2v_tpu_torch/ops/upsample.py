"""Bilinear x2 upsample (align_corners=False) of NCHW or channels-last
tensors as a CUDA kernel pair, forward and backward, with `F.interpolate`
as its plain version.

    upsample2x_bilinear(x)  ==  F.interpolate(x, scale_factor=2,
                                              mode="bilinear",
                                              align_corners=False)

It replaces no TPU kernel (the JAX package resizes with
`jax.image.resize`); on the card it stands in for ATen's NCHW kernels,
which give a thread to each output pixel and loop it over all N*C planes,
so they slow as the image shrinks and N*C grows (design, bound and
rounding in v2v_tpu_torch/csrc/upsample.cu, built at first use by
ops/_build.py). The UNet decoders' `UpsampleConvLayer` and HyperE2VID's
dynamic decoder call it.

Given a CUDA tensor of float32, bfloat16 or float16, `upsample2x_bilinear`
launches the forward kernel (and adds one to `upsample2x_bilinear.launches`)
or raises; its gradient goes through `upsample2x_bilinear_backward`, a
gather kernel (one to `upsample2x_bilinear_backward.launches` a launch),
which takes CUDA tensors only. A CPU tensor takes `F.interpolate` itself,
forward and gradient, so the CPU tests see ATen's numbers. The layout
follows the tensor, as ATen's does: an NCHW-contiguous tensor gives an
NCHW one, a channels-last tensor a channels-last one (HyperE2VID's
dynamic decoder hands one over, and its dynamic conv reads it as NHWC);
any other view is made NCHW-contiguous first. An empty batch launches
nothing.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ._build import CudaLibrary, check, stream

# csrc/upsample.cu's dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.v2v_upsample2x, lib.v2v_upsample2x_backward):
        fn.argtypes = [p, p, ll, i, i, i, i, i, p]
        fn.restype = i


LIB = CudaLibrary("upsample.cu", bind=_bind)


def upsample2x_bilinear_plain(x: torch.Tensor) -> torch.Tensor:
    """ATen's bilinear x2 resize, align_corners=False."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def upsample2x_bilinear_backward_plain(g: torch.Tensor) -> torch.Tensor:
    """ATen's gradient of `upsample2x_bilinear_plain` for an output
    gradient g (N, C, 2h, 2w)."""
    n, c, h2, w2 = g.shape
    return torch.ops.aten.upsample_bilinear2d_backward(
        g, [h2, w2], [n, c, h2 // 2, w2 // 2], False, 2.0, 2.0)


def _checked(t: torch.Tensor, what: str):
    """`t` as the kernels take it, and whether it goes channels-last
    (NHWC-contiguous and not NCHW-contiguous, where ATen's kernels take
    their NHWC path too); else NCHW-contiguous. ValueError for a tensor
    the kernels do not take."""
    if t.dim() != 4 or t.dtype not in _DTYPES:
        raise ValueError(f"{what}: takes an (N, C, H, W) float32, bfloat16 "
                         f"or float16 tensor, got {tuple(t.shape)} {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got "
                         f"{t.device}")
    if t.shape[2] == 0 or t.shape[3] == 0:
        raise ValueError(f"{what}: empty image {tuple(t.shape)}")
    if t.is_contiguous():
        return t, False
    if t.is_contiguous(memory_format=torch.channels_last):
        return t, True
    return t.contiguous(), False


def _launch(fn, what: str, src: torch.Tensor, nhwc: bool, h: int, w: int,
            shape) -> torch.Tensor:
    """`fn`, a C entry of csrc/upsample.cu, from src to a new tensor of
    `shape` in src's layout, for an input of h x w; nothing launched for an
    empty batch."""
    out = torch.empty(shape, dtype=src.dtype, device=src.device,
                      memory_format=torch.channels_last if nhwc
                      else torch.contiguous_format)
    n, c = src.shape[:2]
    if n * c:
        check(fn(src.data_ptr(), out.data_ptr(), n, c, h, w, int(nhwc),
                 _DTYPES[src.dtype], stream()), what)
    return out


def upsample2x_bilinear_forward(x: torch.Tensor) -> torch.Tensor:
    """The forward kernel alone: (N, C, h, w) -> (N, C, 2h, 2w) on the card,
    in x's layout, no autograd."""
    x, nhwc = _checked(x, "upsample2x_bilinear")
    n, c, h, w = x.shape
    out = _launch(LIB.get().v2v_upsample2x, "upsample2x_bilinear", x, nhwc,
                  h, w, (n, c, 2 * h, 2 * w))
    if n * c:
        upsample2x_bilinear.launches += 1
    return out


def upsample2x_bilinear_backward(g: torch.Tensor) -> torch.Tensor:
    """The gather kernel: the input's gradient (N, C, h, w) for an output
    gradient g (N, C, 2h, 2w) on the card, in g's layout."""
    g, nhwc = _checked(g, "upsample2x_bilinear_backward")
    n, c, h2, w2 = g.shape
    if h2 % 2 or w2 % 2:
        raise ValueError(f"upsample2x_bilinear_backward: an output gradient "
                         f"has even H and W, got {tuple(g.shape)}")
    out = _launch(LIB.get().v2v_upsample2x_backward,
                  "upsample2x_bilinear_backward", g, nhwc, h2 // 2, w2 // 2,
                  (n, c, h2 // 2, w2 // 2))
    if n * c:
        upsample2x_bilinear_backward.launches += 1
    return out


class _Upsample2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return upsample2x_bilinear_forward(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return upsample2x_bilinear_backward(g)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 upsample, align_corners=False, of an (N, C, H, W)
    tensor: the kernel pair on a CUDA tensor, `F.interpolate` on a CPU
    one."""
    if x.device.type != "cuda":
        return upsample2x_bilinear_plain(x)
    return _Upsample2x.apply(x)


upsample2x_bilinear.launches = 0
upsample2x_bilinear_backward.launches = 0
