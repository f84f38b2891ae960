"""The reference in the precision just below the configuration's, the
control that a correct run must beat: the step a later change could be
tempted to take.

- `fp8()`: every convolution, linear layer and matrix product takes its
  two operands rounded to float8 e4m3 with a per-tensor scale (amax to
  448), as an fp8 recipe does; gradients pass straight through the
  rounding. The control of a bfloat16 configuration.
- `tf32()`: every matrix product (the attention's too) and every
  convolution in TF32, as the tensor cores take float32 in one pass. The
  control of a float32 configuration whose matmuls and attention keep
  float32's accuracy: the step a later change could take by switching
  TF32 on or by dropping K3's extra passes.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode


@contextlib.contextmanager
def allow_tf32(matmul: bool, cudnn: bool):
    """TF32 in float32 matmuls (`matmul`) and in cuDNN's convolutions
    (`cudnn`); the settings before are restored."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def strict_fp32():
    """float32 matmuls and convolutions with TF32 off, as the reference
    of a train step runs."""
    return allow_tf32(False, False)


def tf32():
    """float32 matmuls and convolutions in TF32 (the control of a float32
    configuration)."""
    return allow_tf32(True, True)

_OPS = {F.conv2d, F.linear, torch.matmul, torch.bmm}


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    if not x.is_floating_point():
        return x
    d = x.detach()
    scale = 448.0 / d.abs().amax().clamp_min(1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).to(d.dtype) / scale
    return x + (q - d)


class fp8(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _OPS:
            args = tuple(round_fp8(a) if torch.is_tensor(a) and i < 2 else a
                         for i, a in enumerate(args))
            if "weight" in kwargs:
                kwargs = dict(kwargs, weight=round_fp8(kwargs["weight"]))
        return func(*args, **kwargs)
