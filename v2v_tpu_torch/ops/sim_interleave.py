"""K5: the event simulator with the chains of `spp` clips interleaved in
one thread, as a CUDA kernel, with its plain PyTorch version.

`simulate_interleave` replaces scripts/exp_sim_interleave.py::simulate,
an experiment on whether several independent per-pixel state chains in
one program hide the latency of the simulator's float32 chain. It is
K1's chain (ops/voxel_cuda.py) with a hot-pixel gaussian of std 0.05 on
every pixel, written as bfloat16 counts, in K1's thread looped over
`spp` clips. The source is v2v_tpu_torch/csrc/sim_interleave.cu (design
and bound notes there), built at first use and loaded with ctypes.

Where the port differs from the TPU kernel, by design:

- Random bits: every draw is Philox4x32-10 keyed by the clip's own seed
  with a per-pixel counter, in K1's layout (csrc/philox.cuh), where the TPU
  kernel seeds its on-core generator once per group of `spp` clips and
  row tile. So the result depends on neither `spp` nor the launch shape,
  and equals K1's with the hot-pixel fraction above 1 and hot std 0.05.
- Leftover clips: the TPU kernel's grid leaves the clips past a multiple
  of `spp` unsimulated; the wrapper raises ValueError for B % spp != 0.
- The TPU kernel's row tile (`tile_h`) is a VMEM budget with no
  counterpart on the card and is not a parameter.
- Size: the kernel offsets a group of `spp` clips in 32 bits, so the
  wrapper raises ValueError for a CUDA video when spp*N*H*W or B*H*W
  reaches 2^31 (the plain version has no such limit).
"""
from __future__ import annotations

import ctypes

import torch

from . import voxel_cuda as vc
from ._build import CudaLibrary, check as _check, stream as _stream
from .voxel import _quantize_events, log_intensity

# the hot-pixel gaussian's std (scripts/exp_sim_interleave.py:46)
HOT_STD = 0.05
# clips a thread simulates: the kernel's template instances
SPPS = (1, 2, 4, 8)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.v2v_simulate_interleave.argtypes = [p, i, p, p, p, p, p, p,
                                            i, i, i, i, i, p]
    lib.v2v_simulate_interleave.restype = i


# -fmad=false: the plain version runs separate multiplies and adds
LIB = CudaLibrary("sim_interleave.cu", headers=("esim.cuh", "philox.cuh"),
                  extra_flags=("-fmad=false",), bind=_bind)


def _per_clip(v, b: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype, device=device).expand(b).contiguous()


def simulate_interleave_plain(video: torch.Tensor, seeds: torch.Tensor,
                              pos, neg, noise) -> torch.Tensor:
    """K5's plain version: (B, N, H, W) uint8/float32 video, (B,) int32
    seeds and (B,) float32 pos/neg thresholds and noise std -> (B, N-1,
    H, W) bfloat16 counts, with the kernel's Philox draws."""
    b, n, h, w = video.shape
    dev = video.device
    if video.dtype == torch.uint8:
        logs = vc.cached_log_table(dev)[video.long()]
    else:
        logs = log_intensity(video)
    col = lambda v: _per_clip(v, b, torch.float32, dev).view(b, 1, 1)
    pos, neg, std = col(pos), col(neg), col(noise)
    seed = _per_clip(seeds, b, torch.int64, dev).view(b, 1, 1) & vc._M32
    pixel = torch.arange(h * w, dtype=torch.int64, device=dev).view(1, h, w)
    u, _, g, _ = vc._philox_draws(seed, pixel, 0, vc.STREAM_INIT)
    pot = vc._uniform01(u) * (pos + neg) - neg
    hot = torch.tensor(HOT_STD, dtype=torch.float32, device=dev) * \
        vc._gaussian(g)
    out = torch.empty((b, n - 1, h, w), dtype=torch.bfloat16, device=dev)
    for i in range(1, n):
        if (i - 1) % 4 == 0:
            words = vc._philox_draws(seed, pixel, (i - 1) // 4,
                                     vc.STREAM_NOISE)
        pot = pot + (logs[:, i] - logs[:, i - 1])
        pot = pot + std * vc._gaussian(words[(i - 1) % 4])
        pot = pot + hot
        counts, pot = _quantize_events(pot, pos, neg)
        out[:, i - 1] = counts.to(torch.bfloat16)
    return out


def simulate_interleave(video: torch.Tensor, seeds: torch.Tensor, pos, neg,
                        noise, *, spp: int) -> torch.Tensor:
    """(B, N, H, W) uint8 or float32 video + (B,) int32 seeds and (B,)
    pos/neg/noise -> (B, N-1, H, W) bfloat16 signed event counts, `spp`
    clips a thread. Launches K5 for CUDA tensors, runs the plain version
    for CPU tensors."""
    if spp not in SPPS:
        raise ValueError(f"spp must be one of {SPPS}, got {spp}")
    if video.dtype not in (torch.uint8, torch.float32):
        video = video.to(torch.float32)
    if video.dim() != 4 or video.shape[1] < 2:
        raise ValueError(f"video must be (B, N>=2, H, W), got "
                         f"{tuple(video.shape)}")
    b, n, h, w = video.shape
    if b % spp:
        raise ValueError(f"B={b} clips is not a multiple of spp={spp}")
    if video.device.type != "cuda":
        return simulate_interleave_plain(video, seeds, pos, neg, noise)
    if max(spp * n, b) * h * w >= 2 ** 31:
        raise ValueError(f"video {tuple(video.shape)} at spp={spp}: a group "
                         f"of clips or B*H*W reaches 2^31 elements")
    dev = video.device
    if seeds.device != dev or seeds.shape != (b,):
        raise ValueError("seeds must be a (B,) tensor on the video's device")
    video = video.contiguous()
    seeds = seeds.to(torch.int32).contiguous()
    prm = [_per_clip(v, b, torch.float32, dev) for v in (pos, neg, noise)]
    out = torch.empty((b, n - 1, h, w), dtype=torch.bfloat16, device=dev)
    err = LIB.get().v2v_simulate_interleave(
        video.data_ptr(), int(video.dtype == torch.uint8),
        vc.cached_log_table(dev).data_ptr(),
        seeds.data_ptr(), *(v.data_ptr() for v in prm), out.data_ptr(),
        b, n, h, w, spp, _stream())
    _check(err, "simulate_interleave")
    simulate_interleave.launches += 1
    return out


simulate_interleave.launches = 0
