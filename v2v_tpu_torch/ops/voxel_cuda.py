"""The event simulator K1 and its gaussian sampler K2 as CUDA kernels,
with their plain PyTorch versions.

K1 (`simulate_batch`) replaces v2v_tpu/ops/voxel_pallas.py::
simulate_batch_pallas; K2 (`sample_gaussian`) replaces ::
sample_gaussian_pallas. The sources are v2v_tpu_torch/csrc/esim.cu and
philox.cuh (design, bound and rounding notes there). They are built at
first use (ops/_build.py) and loaded with ctypes.

A wrapper given CUDA tensors launches its kernel (and adds one to its
`launches` count) or raises; it takes the plain version only for CPU
tensors. The plain versions draw the same Philox4x32-10 bits, written in
int64 tensor arithmetic, so kernel and plain version agree bit for bit,
noise included.
"""
from __future__ import annotations

import ctypes

import torch

from .. import resolve_device
from ._build import CudaLibrary, check as _check, stream as _stream
from .voxel import SimParams, _quantize_events, log_intensity

# Philox stream ids (csrc/philox.cuh)
STREAM_INIT, STREAM_HOT_MASK, STREAM_HOT_VAL, STREAM_NOISE = 0, 1, 2, 3

_M32 = 0xFFFFFFFF
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.v2v_simulate_batch.argtypes = [p, i, p, p, p, p, p, p, p, p,
                                       i, i, i, i, i, p]
    lib.v2v_simulate_batch.restype = i
    lib.v2v_sample_gaussian.argtypes = [i, p, ctypes.c_longlong, p]
    lib.v2v_sample_gaussian.restype = i


# -fmad=false: the plain versions run separate multiplies and adds
LIB = CudaLibrary("esim.cu", headers=("philox.cuh",),
                  extra_flags=("-fmad=false",), bind=_bind)
_load = LIB.get


# ---------------------------------------------------------------------------
# Philox4x32-10 in int64 tensor arithmetic (the plain versions' bits)
# ---------------------------------------------------------------------------

def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) words of the 64-bit product a*b of 32-bit values, with no
    intermediate above 2^49: b is split into 16-bit halves."""
    p = a * (b >> 16)
    s = ((p & 0xFFFF) << 16) + a * (b & 0xFFFF)
    return (p >> 16) + (s >> 32), s & _M32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors (or ints) holding 32-bit words;
    returns the four output words. Broadcasts like its arguments."""
    as_t = lambda v: v if torch.is_tensor(v) else torch.tensor(
        v, dtype=torch.int64)
    c0, c1, c2, c3, k0, k1 = map(as_t, (c0, c1, c2, c3, k0, k1))
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _philox_word(seed, pixel, frame: int, stream: int) -> torch.Tensor:
    """First Philox word at counter (pixel, frame, stream, 0), key
    (seed, 0) — csrc/philox.cuh::philox_word."""
    zero = torch.zeros((), dtype=torch.int64, device=pixel.device)
    return philox4x32_10(pixel, zero + frame, zero + stream, zero,
                         zero + seed, zero)[0]


def _uniform01(w: torch.Tensor) -> torch.Tensor:
    return (w >> 8).to(torch.float32) * (1.0 / 16777216.0) + (
        1.0 / 16777216.0)


_INV_STD = 1.0 / 147.7950834


def _gaussian(w: torch.Tensor) -> torch.Tensor:
    s = (w & 0xFF) + ((w >> 8) & 0xFF) + ((w >> 16) & 0xFF) + (w >> 24)
    inv = torch.tensor(_INV_STD, dtype=torch.float32, device=w.device)
    return (s.to(torch.float32) - 510.0) * inv


# ---------------------------------------------------------------------------
# K2: raw gaussian samples
# ---------------------------------------------------------------------------

def sample_gaussian_plain(seed: int, n: int, device) -> torch.Tensor:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return _gaussian(_philox_word(seed & _M32, idx, 0, STREAM_NOISE))


def sample_gaussian(seed: int, shape=(256, 256), device=None
                    ) -> torch.Tensor:
    """Raw samples of K1's gaussian generator (for its moment checks)."""
    device = resolve_device(device)
    n = 1
    for s in shape:
        n *= int(s)
    if device.type != "cuda":
        return sample_gaussian_plain(seed, n, device).reshape(shape)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    _check(_load().v2v_sample_gaussian(int(seed), out.data_ptr(), n,
                                       _stream()), "sample_gaussian")
    sample_gaussian.launches += 1
    return out


sample_gaussian.launches = 0


# ---------------------------------------------------------------------------
# K1: the event simulator
# ---------------------------------------------------------------------------

def log_table(device) -> torch.Tensor:
    """log_intensity of the 256 uint8 levels, computed with the plain
    version's expression on `device`."""
    return log_intensity(torch.arange(256, dtype=torch.float32,
                                      device=device))


def _batch_params(params: SimParams, b: int, device) -> SimParams:
    return SimParams(*(torch.as_tensor(v, dtype=torch.float32,
                                       device=device).expand(b).contiguous()
                       for v in params))


def simulate_batch_plain(video: torch.Tensor, seeds: torch.Tensor,
                         params: SimParams, *, noise_free: bool = False
                         ) -> torch.Tensor:
    """K1's plain version: (B, N, H, W) uint8/float32 video, (B,) int32
    seeds, SimParams of (B,) -> (B, N-1, H, W) float32 counts, with the
    kernel's Philox draws."""
    b, n, h, w = video.shape
    dev = video.device
    if video.dtype == torch.uint8:
        logs = log_table(dev)[video.long()]
    else:
        logs = log_intensity(video)
    prm = _batch_params(params, b, dev)
    col = lambda v: v.view(b, 1, 1)
    pos, neg = col(prm.pos_thres), col(prm.neg_thres)
    if noise_free:
        pot = torch.zeros((b, h, w), dtype=torch.float32, device=dev)
        hot = None
    else:
        seed = col(seeds.to(torch.int64) & _M32)
        pixel = torch.arange(h * w, dtype=torch.int64,
                             device=dev).view(1, h, w)
        u = _uniform01(_philox_word(seed, pixel, 0, STREAM_INIT))
        pot = u * (pos + neg) - neg
        um = _uniform01(_philox_word(seed, pixel, 0, STREAM_HOT_MASK))
        hv = col(prm.hot_pixel_std) * _gaussian(
            _philox_word(seed, pixel, 0, STREAM_HOT_VAL))
        hot = torch.where(um < col(prm.hot_pixel_fraction), hv, 0.0)
        std = col(prm.base_noise_std)
    out = torch.empty((b, n - 1, h, w), dtype=torch.float32, device=dev)
    for i in range(1, n):
        pot = pot + (logs[:, i] - logs[:, i - 1])
        if hot is not None:
            g = _gaussian(_philox_word(seed, pixel, i, STREAM_NOISE))
            pot = pot + std * g
            pot = pot + hot
        out[:, i - 1], pot = _quantize_events(pot, pos, neg)
    return out


def simulate_batch(video: torch.Tensor, seeds: torch.Tensor,
                   params: SimParams, *, noise_free: bool = False
                   ) -> torch.Tensor:
    """(B, N, H, W) uint8 or float32 video + (B,) int32 seeds + per-sample
    SimParams -> (B, N-1, H, W) float32 signed event counts. Launches K1
    for CUDA tensors, runs the plain version for CPU tensors."""
    if video.dtype not in (torch.uint8, torch.float32):
        video = video.to(torch.float32)
    if video.dim() != 4 or video.shape[1] < 2:
        raise ValueError(f"video must be (B, N>=2, H, W), got "
                         f"{tuple(video.shape)}")
    if video.device.type != "cuda":
        return simulate_batch_plain(video, seeds, params,
                                    noise_free=noise_free)
    b, n, h, w = video.shape
    dev = video.device
    if seeds.device != dev or seeds.shape != (b,):
        raise ValueError("seeds must be a (B,) tensor on the video's device")
    video = video.contiguous()
    seeds = seeds.to(torch.int32).contiguous()
    prm = _batch_params(params, b, dev)
    table = log_table(dev)
    out = torch.empty((b, n - 1, h, w), dtype=torch.float32, device=dev)
    err = _load().v2v_simulate_batch(
        video.data_ptr(), int(video.dtype == torch.uint8), table.data_ptr(),
        seeds.data_ptr(), *(v.data_ptr() for v in prm), out.data_ptr(),
        b, n, h, w, int(noise_free), _stream())
    _check(err, "simulate_batch")
    simulate_batch.launches += 1
    return out


simulate_batch.launches = 0
