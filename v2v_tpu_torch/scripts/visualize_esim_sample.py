"""Render one simulator sample as images (port of
scripts/visualize_esim_sample.py, used for paper figures): 41 frames at
128x128 through ops/voxel.py::simulate_sequence at 5 bins with the
simulator's default randomization, then each voxel's bin sum
(`voxel_NNN.png`, 0 events at mid grey) and the frame it ends on
(`frame_NNN.png`).

    python -m v2v_tpu_torch.scripts.visualize_esim_sample [<video.mp4>|synthetic] [out_dir=debug/esim_sample] [--device DEV]

`synthetic` is a gradient drifting 2 px a frame. A video file is read
with cv2 (its first 41 frames, grey, resized). The parameters and noise
come from a torch.Generator on the device, seeded with 0; it runs
on the card unless --device cpu. PNGs are written without cv2
(utils/png.py).
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict

import numpy as np
import torch

from .. import resolve_device
from ..ops.voxel import SimConfig, simulate_sequence
from ..utils.png import write_png

N, H, W, BINS = 41, 128, 128, 5


def synthetic_frames() -> np.ndarray:
    """(N, H, W) float32 in [0, 255): a horizontal gradient drifting 2 px a
    frame."""
    xx = np.mgrid[0:H, 0:W][1]
    return np.stack([((xx + 2.0 * t) % W) / W * 255
                     for t in range(N)]).astype(np.float32)


def video_frames(path: str) -> np.ndarray:
    """The first N frames of a video file, grey and resized to H x W."""
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    for _ in range(N):
        ret, f = cap.read()
        if not ret:
            break
        g = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
        frames.append(cv2.resize(g, (W, H)))
    cap.release()
    return np.stack(frames).astype(np.float32)


def render(source: str, out_dir: str, device=None,
           seed: int = 0) -> Dict[str, Any]:
    """Simulate `source` and write its PNGs into `out_dir`. Returns the
    voxels ((N-1)/BINS, BINS, H, W) on the host, the sampled thresholds
    and the paths written."""
    dev = resolve_device(device)
    frames = synthetic_frames() if source == "synthetic" else \
        video_frames(source)
    os.makedirs(out_dir, exist_ok=True)
    generator = torch.Generator(device=dev).manual_seed(seed)
    voxels, params = simulate_sequence(
        torch.from_numpy(frames).to(dev), generator, SimConfig(),
        num_bins=BINS)
    v = voxels.cpu().numpy()
    paths = []
    for i in range(v.shape[0]):
        s = v[i].sum(axis=0)
        lim = max(np.abs(s).max(), 1)
        vis = np.clip((s / lim + 1) / 2 * 255, 0, 255).astype(np.uint8)
        paths.append(os.path.join(out_dir, f"voxel_{i:03d}.png"))
        write_png(paths[-1], vis)
        paths.append(os.path.join(out_dir, f"frame_{i:03d}.png"))
        write_png(paths[-1], frames[(i + 1) * BINS].astype(np.uint8))
    return {"voxels": v, "pos_thres": float(params.pos_thres),
            "neg_thres": float(params.neg_thres), "paths": paths}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("source", nargs="?", default="synthetic")
    ap.add_argument("out_dir", nargs="?", default="debug/esim_sample")
    ap.add_argument("--device", default=None,
                    help="default: the card; cpu runs the plain path")
    args = ap.parse_args(argv)
    out = render(args.source, args.out_dir, args.device)
    print(f"thresholds pos={out['pos_thres']:.3f} "
          f"neg={out['neg_thres']:.3f}")
    print(f"wrote {len(out['paths'])} images to {args.out_dir}")


if __name__ == "__main__":
    main()
