"""The chip's peaks and the work of the program's hand-written kernels,
from their shapes: the yardstick of the roofline metrics.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s bfloat16, 495 TFLOP/s TF32, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
HBM_BYTES = 3.35e12


def k1_bytes(batch: int, frames: int, height: int, width: int) -> int:
    """K1 (csrc/esim.cu), the event simulator: the uint8 video read once
    and the bfloat16 counts, one frame fewer, written once."""
    pixels = batch * height * width
    return pixels * frames + 2 * pixels * (frames - 1)


def k1_seconds(batch: int, frames: int, height: int, width: int) -> float:
    """The least time K1 can take: its bytes at the HBM peak."""
    return k1_bytes(batch, frames, height, width) / HBM_BYTES


def attention_flops(batch: int, heads: int, nq: int, nk: int, dh: int
                    ) -> int:
    """softmax(Q K^T) V over every key: two products, 4 B h Nq Nk dh."""
    return 4 * batch * heads * nq * nk * dh


def attention_bytes(batch: int, heads: int, nq: int, nk: int, dh: int
                    ) -> int:
    """float32 q and o of Nq rows, k and v of Nk rows, each moved once."""
    return 4 * batch * heads * dh * (2 * nq + 2 * nk)


def k3_seconds(batch: int, heads: int, nq: int, nk: int, dh: int) -> float:
    """The least time K3 (csrc/attention.cu), a float32 attention, can
    take: the algorithm's products at the TF32 peak, or its bytes at the
    HBM peak, whichever is longer. Not K3's three TF32 passes: those are
    its way of keeping float32's accuracy, not the work."""
    return max(attention_flops(batch, heads, nq, nk, dh) / TF32_FLOPS,
               attention_bytes(batch, heads, nq, nk, dh) / HBM_BYTES)
