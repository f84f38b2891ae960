"""Experiment: do several clips' per-pixel chains in one thread (K5,
ops/sim_interleave.py) hide the latency of the simulator's float32
chain on the card? The port's counterpart of the JAX package's
scripts/exp_sim_interleave.py, on the same workload.

    python -m v2v_tpu_torch.scripts.exp_sim_interleave [--iters 50]

Workload: B=12 clips of N=201 uint8 frames (L=40 steps of 5 bins, + 1)
at 128x128, a random base level per pixel plus a random walk from
np.random.RandomState(0); thresholds 0.4/0.5, noise std 0.05. Each
variant (`spp` clips a thread: 1, 2, 4) runs `iters` launches chained
through a device scalar (each launch's seeds are 7 + i plus a zero taken
from the previous output), once warm and 3 times timed with CUDA
events; the median gives one `clips/s` line per variant. Any failure
exits non-zero.
"""
from __future__ import annotations

import argparse
import math
import statistics
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops.sim_interleave import simulate_interleave

B, L, BINS, H, W = 12, 40, 5, 128, 128
N = L * BINS + 1
SPPS = (1, 2, 4)
ITERS = 50
# timed runs of each variant, after one warm run
REPEATS = 3


def make_video(shape, seed: int = 0) -> np.ndarray:
    """(B, N, H, W) uint8: a random level per pixel plus a random walk
    of std 4 a frame, clipped (the JAX experiment's video)."""
    b, n, h, w = shape
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (b, 1, h, w)).astype(np.float32)
    drift = np.cumsum(rng.randn(b, n, h, w).astype(np.float32) * 4, axis=1)
    return np.clip(base + drift, 0, 255).astype(np.uint8)


def _seconds(fn, dev: torch.device) -> float:
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def run(device=None, shape=(B, N, H, W), iters: int = ITERS,
        spps=SPPS) -> dict:
    """Clips per second of each `spp` variant, {spp: rate}. It runs on
    the card unless `device` says otherwise; `len(spps) * (REPEATS + 1) *
    iters` launches in all."""
    dev = resolve_device(device)
    b = shape[0]
    video = torch.from_numpy(make_video(shape)).to(dev)
    pos, neg, noise = (torch.full((b,), v, dtype=torch.float32, device=dev)
                       for v in (0.4, 0.5, 0.05))
    seeds0 = torch.full((b,), 7, dtype=torch.int32, device=dev)

    def chained(spp):
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(iters):
            seeds = seeds0 + i + (acc * 0).to(torch.int32)
            out = simulate_interleave(video, seeds, pos, neg, noise, spp=spp)
            acc = acc + out[0, 0, 0, 0].to(torch.float32)
        return acc

    rates = {}
    for spp in spps:
        if not math.isfinite(float(chained(spp))):
            raise RuntimeError(f"spp={spp}: non-finite counts")
        dt = statistics.median(_seconds(lambda: chained(spp), dev)
                               for _ in range(REPEATS))
        rates[spp] = b * iters / dt
    return rates


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    print(f"{torch.cuda.get_device_name(dev)}: B={B} N={N} {H}x{W} uint8, "
          f"{args.iters} chained launches a run", flush=True)
    for spp, rate in run(dev, iters=args.iters).items():
        print(f"spp={spp}: {rate:8.0f} clips/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
