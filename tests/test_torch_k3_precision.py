"""K3's precision scheme (v2v_tpu_torch/csrc/attention.cu), emulated in
plain PyTorch on the CPU.

The kernel runs Q K^T and P V on the TF32 tensor cores in three passes:
each float32 operand x splits into hi = x rounded to nearest TF32 (10
mantissa bits, cvt.rna) and lo = x - hi, which the tensor cores truncate
to TF32, and x*y is taken as lo*hi + hi*lo + hi*hi, summed in float32.
Here the same splits and products go through float32 matmuls, and the
result is held against softmax(Q K^T / sqrt(dh)) V in float64 at the
shape of ETNet's 720p cross attention cut to 2 heads and 1024 queries:
14,400 keys, dh = 32. One TF32 pass is held to miss chip_smoke's K3
tolerance there, which is why the kernel takes three.

The tensor cores' own float32 adds round toward zero. Summing all 14,400
keys' P V into one such accumulator biases O (~9e-6 here, and beyond the
1e-5 tolerance at (1, 8, 14400, 32) on the card), so the kernel sums
each tile of 64 keys on the tensor cores and adds the tiles with
round-to-nearest float32 adds; the last test holds that scheme.
"""
import math

import numpy as np
import pytest
import torch

import chip_smoke

SHAPE_Q = (1, 2, 1024, 32)
NK = 14400
QUERY_CHUNK = 256           # bounds the float64 logits held at once


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Nearest TF32, ties away from zero (cvt.rna.tf32.f32)."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """TF32 by truncation, as the tensor cores read a float32 operand."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32_round(x)
    return hi, _tf32_trunc(x - hi)


def _product(a, b, passes):
    """a @ b on the tensor cores: one pass of rounded operands, or three
    (lo*hi + hi*lo + hi*hi) accumulated in float32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _emulated(q, k, v, passes):
    """The kernel's arithmetic in float32: logits in `passes` TF32 passes,
    the scale folded into exp2, P split like any operand, one divide by
    the row sum at the end."""
    scale_log2 = math.log2(math.e) / math.sqrt(q.shape[-1])
    s = _product(q, k.transpose(-1, -2), passes)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s * scale_log2 - m * scale_log2)
    return _product(p, v, passes) / p.sum(-1, keepdim=True)


def _float64(q, k, v):
    q, k, v = (t.double() for t in (q, k, v))
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return (p @ v) / p.sum(-1, keepdim=True)


def _inputs(shape_q, nk):
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal(shape_q, dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal(shape_q[:-2] + (nk, 32),
                                                 dtype=np.float32))
            for _ in range(2))
    return q, k, v


def _max_err(passes):
    q, k, v = _inputs(SHAPE_Q, NK)
    err = 0.0
    for i in range(0, SHAPE_Q[2], QUERY_CHUNK):
        qc = q[:, :, i:i + QUERY_CHUNK]
        got = _emulated(qc, k, v, passes)
        err = max(err, float((got.double() - _float64(qc, k, v)).abs().max()))
    return err


def test_tf32_split_rounds_and_truncates():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, -1.0 - 2 ** -11,
                      1.0 + 2 ** -10 + 2 ** -20, 3.0e-3])
    hi = _tf32_round(x)
    # a tie rounds away from zero; 1 + 3/4 ulp rounds up
    assert hi.tolist()[:3] == [1.0 + 2 ** -10, 1.0 + 2 ** -10,
                               -1.0 - 2 ** -10]
    # every hi and truncated lo has 10 mantissa bits; hi + lo holds x to
    # 2^-21 of |x|
    h, lo = _split(x)
    for t in (h, lo):
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    assert bool(((h + lo - x).abs() <= 2 ** -21 * x.abs()).all())


@pytest.mark.parametrize("passes,within_tolerance", [(3, True), (1, False)])
def test_three_tf32_passes_hold_float32_accuracy(passes, within_tolerance):
    """Three passes stay within 1e-6 of float64 at 14,400 keys; one pass
    misses chip_smoke.K3_ATOL (1e-5), the kernel's tolerance against its
    float32 plain version."""
    err = _max_err(passes)
    if within_tolerance:
        assert err <= 1e-6, err
    else:
        assert err > chip_smoke.K3_ATOL, err


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


@pytest.mark.parametrize("per_tile", [True, False])
def test_pv_sums_per_key_tile_against_round_toward_zero_adds(per_tile):
    """P V of 256 queries over 14,400 keys, tile by tile of 64 keys in
    three passes, each k-step of 8 keys added to a float32 accumulator
    that rounds toward zero: a fresh accumulator per tile, the tiles
    summed with round-to-nearest adds (the kernel), stays within 1e-7 of
    float64; one accumulator across all tiles drifts to ~9e-6."""
    q, k, v = _inputs((256, 32), NK)
    scale_log2 = math.log2(math.e) / math.sqrt(32)
    s = _product(q, k.T, 3)
    p = torch.exp2(s * scale_log2 - s.amax(-1, keepdim=True) * scale_log2)
    (ph, pl), (vh, vl) = _split(p), _split(v)
    acc = torch.zeros(q.shape)
    for k0 in range(0, NK, 64):
        part = torch.zeros(q.shape) if per_tile else acc
        for a, b in ((pl, vh), (ph, vl), (ph, vh)):
            for j in range(k0, k0 + 64, 8):
                part = _round_toward_zero(part.double() + a[:, j:j + 8].double()
                                          @ b[j:j + 8].double())
        acc = acc + part if per_tile else part
    err = float((acc / p.sum(-1, keepdim=True) - _float64(q, k, v)).abs()
                .max())
    if per_tile:
        assert err <= 1e-7, err
    else:
        assert 4e-6 < err <= chip_smoke.K3_ATOL, err
