"""The train step's event simulator in plain PyTorch: per-clip parameters
drawn from the step's generator, the noisy ESIM-style simulation of
HYLZ-2019/V2V (data/v2v_core_esim.py:26-69) with its noise drawn as
Philox4x32-10 words in int64 arithmetic, the sum of the counts into
voxel bins and the choice of the ground-truth frames.

The draws follow the layout the benchmarked program documents for its
simulator (one Philox call a pixel for the initial potential and the hot
pixels, one a pixel for four frames of base noise; uniforms from the top
24 bits, gaussians as a scaled sum of four bytes), so the two give the
same counts bit for bit: the counts are compared exactly.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_INV_STD = 1.0 / 147.7950834
STREAM_INIT, STREAM_NOISE = 0, 1
DROPOUT_FOLD = 0x5eed


def step_seed(seed: int, *folds: int) -> int:
    """`seed` with `folds` mixed in, in 63 bits."""
    return int(np.random.SeedSequence([seed, *folds]).generate_state(
        1, np.uint64)[0]) >> 1


def dropout_generator(generator: torch.Generator) -> torch.Generator:
    """The dropout masks' generator of a step whose generator is
    `generator`."""
    return torch.Generator(device=generator.device).manual_seed(
        step_seed(generator.initial_seed(), DROPOUT_FOLD))


def _mulhilo(a: int, b):
    p = a * (b >> 16)
    s = ((p & 0xFFFF) << 16) + a * (b & 0xFFFF)
    return (p >> 16) + (s >> 32), s & _M32


def philox(c0, c1, c2, c3, k0, k1):
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _M32
            k1 = (k1 + _W1) & _M32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _draws(seed, pixel, c1: int, stream: int):
    zero = torch.zeros((), dtype=torch.int64, device=pixel.device)
    return philox(pixel, zero + c1, zero + stream, zero, seed, zero)


def _uniform(w):
    return (w >> 8).to(torch.float32) * (1.0 / 16777216.0) + (
        1.0 / 16777216.0)


def _gaussian(w):
    s = (w & 0xFF) + ((w >> 8) & 0xFF) + ((w >> 16) & 0xFF) + (w >> 24)
    inv = torch.tensor(_INV_STD, dtype=torch.float32, device=w.device)
    return (s.to(torch.float32) - 510.0) * inv


def log_intensity(v: torch.Tensor) -> torch.Tensor:
    """log(0.001 + reverse-gamma(v) / 255), the original's x255/255 round
    trip kept."""
    return torch.log(0.001 + ((v.to(torch.float32) / 255.0) ** 2.2
                              * 255.0) / 255.0)


def sample_params(generator: torch.Generator, sim: dict, b: int):
    """(B,) pos, neg, base-noise std, hot fraction, hot std
    (data/v2v_datasets.py:368-386)."""
    u = torch.rand((6, b), generator=generator, device=generator.device,
                   dtype=torch.float32)
    uni = lambda row, lo, hi: lo + (hi - lo) * u[row]
    lo, hi = sim["threshold_range"]
    t1 = uni(0, lo, hi)
    t2 = t1 * uni(1, 1.0, sim["max_thres_pos_neg_gap"])
    swap = u[2] > 0.5
    return (torch.where(swap, t1, t2), torch.where(swap, t2, t1),
            uni(3, *sim["base_noise_std_range"]),
            uni(4, *sim["hot_pixel_fraction_range"]),
            uni(5, *sim["hot_pixel_std_range"]))


def simulate(video: torch.Tensor, seeds: torch.Tensor, params
             ) -> torch.Tensor:
    """(B, N, H, W) uint8 video -> (B, N-1, H, W) signed counts, rounded
    to bfloat16 as the original stores them."""
    b, n, h, w = video.shape
    dev = video.device
    logs = log_intensity(torch.arange(256, dtype=torch.float32,
                                      device=dev))[video.long()]
    col = lambda v: v.view(b, 1, 1)
    pos, neg, std, hot_frac, hot_std = map(col, params)
    seed = col(seeds.to(torch.int64) & _M32)
    pixel = torch.arange(h * w, dtype=torch.int64, device=dev).view(1, h, w)
    u, um, g, _ = _draws(seed, pixel, 0, STREAM_INIT)
    pot = _uniform(u) * (pos + neg) - neg
    hot = torch.where(_uniform(um) < hot_frac, hot_std * _gaussian(g), 0.0)
    out = torch.empty((b, n - 1, h, w), dtype=torch.bfloat16, device=dev)
    for i in range(1, n):
        pot = pot + (logs[:, i] - logs[:, i - 1])
        if (i - 1) % 4 == 0:
            words = _draws(seed, pixel, (i - 1) // 4, STREAM_NOISE)
        pot = pot + std * _gaussian(words[(i - 1) % 4])
        pot = pot + hot
        fire_p = torch.where(pot >= pos, torch.floor(pot / pos), 0.0)
        fire_n = torch.where(pot <= -neg, torch.floor(-pot / neg), 0.0)
        pot = pot - fire_p * pos + fire_n * neg
        out[:, i - 1] = (fire_p - fire_n).to(torch.bfloat16)
    return out


def synthesize(video: torch.Tensor, generator: torch.Generator, sim: dict,
               bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A step's simulator stage: (B, N, H, W) uint8 video -> events
    (B, T, H, W, bins) float32 and frames (B, T, H, W, 1) in [0, 1],
    frame t being video[(t + 1) * bins] (one frame a bin)."""
    b, n, h, w = video.shape
    params = sample_params(generator, sim, b)
    seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=generator,
                          device=video.device, dtype=torch.int32)
    counts = simulate(video, seeds, params)
    t = (n - 1) // bins
    events = counts.reshape(b, t, bins, h, w).float().permute(0, 1, 3, 4, 2)
    idx = (torch.arange(t, device=video.device) + 1) * bins
    frames = video[:, idx].to(torch.float32) / 255.0
    return events, frames[..., None]
