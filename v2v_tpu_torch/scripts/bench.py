"""Simulator throughput: uint8 video -> event voxels, clips/s (the port of
the repo-root bench.py).

    python -m v2v_tpu_torch.scripts.bench [--device DEV] [--repeats 5]

The workload is the flagship train config's (train_v2v_e2vid_10k.yaml:
B=12 clips of N=201 uint8 frames at 128x128, T=40 steps of 5 bins): a
random level per pixel plus a random walk, from np.random.RandomState(0).
On the card one call is training/steps.py::synthesize_batch, the train
step's video -> voxel conversion (the simulator parameters drawn on the
card, K1, the bin sums and the GT frames); `--iters` calls run back to
back between two CUDA events, once warm and `--repeats` times timed. On
the same host and in the same run, the port's numpy simulator
(ops/voxel.py::esim_video_to_voxel_np, the reference's emulator) runs
`--host-clips` of the same clips at thresholds 0.4/0.5 and noise std
0.05, each timed `--repeats` times. Prints one JSON line: the median
clips/s and its spread over the repeats, the numpy simulator's clips/s
and the ratio, the device and, on the card, its name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops.voxel import SimConfig, esim_video_to_voxel_np
from ..training.steps import synthesize_batch
from .exp_sim_interleave import _seconds, make_video

SHAPE = (12, 201, 128, 128)
BINS = 5


def describe_device(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU's note: a CPU run gives no device metric."""
    if dev.type != "cuda":
        return "cpu (host times; no device metric)"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def run(device=None, shape=SHAPE, iters: int = 50, repeats: int = 5,
        host_clips: int = 3) -> dict:
    dev = resolve_device(device)
    b, n, h, w = shape
    if (n - 1) % BINS:
        raise ValueError(f"N - 1 = {n - 1} frames do not split into "
                         f"{BINS} bins")
    videos = make_video(shape)
    video = torch.as_tensor(videos, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    cfg = SimConfig()

    def calls():
        for _ in range(iters):
            synthesize_batch(video, g, cfg, BINS, 1)

    calls()                                               # warm
    per_s = [b * iters / _seconds(calls, dev) for _ in range(repeats)]

    host = []
    for ci in range(min(host_clips, b)):
        clip = videos[ci].astype(np.float32)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            esim_video_to_voxel_np(clip, 0.4, 0.5, base_noise_std=0.05,
                                   rng=np.random.RandomState(ci))
            times.append(time.perf_counter() - t0)
        host.append(statistics.median(times))
    host_per_s = 1.0 / float(np.mean(host))
    value = statistics.median(per_s)
    return {"metric": "webvid_to_voxel_clips_per_sec", "value": value,
            "unit": "clips/s", "spread": [min(per_s), max(per_s)],
            "repeats": repeats, "iters": iters, "shape": list(shape),
            "host_numpy_clips_per_sec": host_per_s,
            "vs_host_numpy": value / host_per_s,
            "device": str(dev), "card": describe_device(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m v2v_tpu_torch.scripts.bench",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--shape", type=int, nargs=4, default=list(SHAPE),
                    metavar=("B", "N", "H", "W"))
    ap.add_argument("--iters", type=int, default=50,
                    help="back-to-back calls a timed repeat")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--host-clips", type=int, default=3,
                    help="clips through the numpy simulator")
    args = ap.parse_args(argv)
    result = run(args.device, tuple(args.shape), args.iters, args.repeats,
                 args.host_clips)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
