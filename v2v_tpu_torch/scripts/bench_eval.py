"""Streaming inference time: ms/frame of each family of the zoo at the
benchmarks' resolutions (the port of the repo-root scripts/bench_eval.py).

    python -m v2v_tpu_torch.scripts.bench_eval [families...]
        [--hw 180x240 ...] [--frames 10] [--repeats 5] [--device DEV]

Families: e2vid++, etnet, hyper, eraft, evflow, nernet (default all),
each the `module` of its test config (configs/test_*_original.yaml,
copied here without its loss; tests hold them equal), at random weights,
float32, in eval. Resolutions: 180x240 (HQF, IJRR), 260x346 (MVSEC) and
720x1280 (EVAID). B=1 streaming as the harness runs it, the state
carried from frame to frame: a frame is one voxel (for ERAFT a pair of
voxels, both encoded, with the warm-start flow carried; for NerNet one
frame's raw events, 0.434 events a pixel, EVAID's 400,000 at 720p),
random from np.random.RandomState(0). Each repeat streams `--frames`
frames from a reset state after one warm repeat of 2 frames; each frame
is timed on the host clock up to a synchronize, a repeat's ms/frame is
the mean of its frames, and a row gives the median over the repeats and
their spread. ETNet at 720p (14,400 tokens) attends through K3 and
HyperE2VID's dynamic conv runs K4, on the card. Prints a row a
(family, resolution) and one JSON line of every row.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .. import resolve_device
from .bench import describe_device

RESOLUTIONS = ((180, 240), (260, 346), (720, 1280))
EVENTS_PER_PIXEL = 400_000 / (720 * 1280)
_UNET = {"num_bins": 5, "skip_type": "sum",
         "recurrent_block_type": "convlstm", "num_encoders": 3,
         "base_num_channels": 32, "num_residual_blocks": 2,
         "use_upsample_conv": True}
# family -> (the test config's `module` without its loss, voxel bins,
# kind): kind "e2vid" (ModelInterface), "flow" (FlowModelInterface),
# "eraft" (its pairs) or "nernet" (raw events)
FAMILIES: Dict[str, Tuple[Dict[str, Any], int, str]] = {
    "e2vid++": ({"normalize_voxels": False, "model": {
        "target": "model.model.FlowNet", "params": {"unet_kwargs": dict(
            _UNET, norm="none", num_output_channels=3)}}}, 5, "e2vid"),
    "etnet": ({"normalize_voxels": False, "model": {
        "target": "model.eitr.eitr.EITR",
        "params": {"eitr_kwargs": {"num_bins": 5, "norm": "none"}}}},
        5, "e2vid"),
    "hyper": ({"normalize_voxels": False, "model": {
        "target": "model.hyper_model.HyperE2VID",
        "params": {"unet_kwargs": dict(
            _UNET, norm="none", kernel_size=5, channel_multiplier=2,
            num_output_channels=1, use_dynamic_decoder=True)}}},
        5, "e2vid"),
    "eraft": ({"normalize_voxels": False, "model": {
        "target": "model.eraft.eraft.ERAFT",
        "params": {"config": {"subtype": "warm_start"},
                   "n_first_channels": 15}}, "forward_type": "eraft"},
        15, "eraft"),
    "evflow": ({"normalize_voxels": False, "model": {
        "target": "model.model.EVFlowNet", "params": {"unet_kwargs": {
            "num_bins": 5, "base_num_channels": 32, "num_encoders": 4,
            "num_residual_blocks": 2, "num_output_channels": 2,
            "skip_type": "concat", "norm": None, "use_upsample_conv": True,
            "kernel_size": 3, "channel_multiplier": 2}}}}, 5, "flow"),
    "nernet": ({"normalize_voxels": False, "model": {
        "target": "model.nernet_model.RepresentationRecurrent",
        "params": {"unet_kwargs": dict(
            _UNET, recurrent_network="NIAM_STcell_GCB",
            recurrent_block_type="", norm="", crop_size=224,
            mlp_layers=[1, 50, 50, 50, 1], use_cnn_representation=True,
            normalize=False, combine_voxel=False, RepCNN_kernel_size=3,
            RepCNN_padding=1, RepCNN_channel=64, RepCNN_num_layers=1,
            num_output_channels=1)}}, "is_nernet": True}, 5, "nernet"),
}


def _frames(kind: str, bins: int, hw, n: int, dev: torch.device):
    """`n` frames of the family's input: voxels (1, n, H, W, bins) with
    integer counts in [-3, 3] (n + 1 for ERAFT's pairs), or NerNet's n
    raw-event arrays (N, 5) [x, y, t, p, 0]."""
    rng = np.random.RandomState(0)
    h, w = hw
    if kind == "nernet":
        k = int(round(EVENTS_PER_PIXEL * h * w))
        return [np.stack([rng.randint(0, w, k).astype(np.float64),
                          rng.randint(0, h, k).astype(np.float64),
                          np.sort(rng.uniform(i / 30.0, (i + 1) / 30.0, k)),
                          rng.randint(0, 2, k) * 2.0 - 1.0, np.zeros(k)],
                         axis=1) for i in range(n)]
    t = n + 1 if kind == "eraft" else n
    return torch.as_tensor(rng.randint(-3, 4, (1, t, h, w, bins)).astype(
        np.float32), device=dev)


def bench_family(family: str, hws, frames: int, repeats: int,
                 dev: torch.device) -> List[dict]:
    from ..training.flow_interface import FlowModelInterface
    from ..training.interface import ModelInterface
    module, bins, kind = FAMILIES[family]
    cls = FlowModelInterface if kind in ("flow", "eraft") else ModelInterface
    iface = cls(module, dev, generator=torch.Generator(
        device=dev).manual_seed(0))

    @torch.no_grad()
    def frame(inputs, i, state):
        if kind == "nernet":
            return iface.forward_sequence_nernet([inputs[i]], state)
        span = 2 if kind == "eraft" else 1
        return iface.forward_sequence(inputs[:, i:i + span], state)

    def stream(inputs, n, h, w) -> List[float]:
        state = iface.init_state(1, h, w)
        times = []
        for i in range(n):
            t0 = time.perf_counter()
            _, state = frame(inputs, i, state)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    rows = []
    for h, w in hws:
        inputs = _frames(kind, bins, (h, w), frames, dev)
        stream(inputs, min(2, frames), h, w)                    # warm
        per_repeat = [statistics.mean(stream(inputs, frames, h, w))
                      for _ in range(repeats)]
        ms = statistics.median(per_repeat)
        rows.append({"family": family, "hw": [h, w], "ms_per_frame": ms,
                     "spread": [min(per_repeat), max(per_repeat)],
                     "fps": 1e3 / ms, "frames": frames,
                     "repeats": repeats})
        print(f"{family:8s} {h}x{w:<5d} {ms:8.3f} ms/frame "
              f"({min(per_repeat):.3f}-{max(per_repeat):.3f}) "
              f"{1e3 / ms:8.1f} fps", flush=True)
    return rows


def run(families=tuple(FAMILIES), hws=RESOLUTIONS, frames: int = 10,
        repeats: int = 5, device=None) -> dict:
    dev = resolve_device(device)
    rows = []
    for family in families:
        rows += bench_family(family, hws, frames, repeats, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"rows": rows, "device": str(dev), "card": describe_device(dev)}


def _hw(text: str) -> Tuple[int, int]:
    h, w = text.lower().split("x")
    return int(h), int(w)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m v2v_tpu_torch.scripts.bench_eval",
        description=__doc__.split("\n")[0])
    ap.add_argument("families", nargs="*", default=list(FAMILIES),
                    help=f"of {list(FAMILIES)} (default all)")
    ap.add_argument("--hw", type=_hw, nargs="+", default=list(RESOLUTIONS),
                    help="resolutions HxW (default 180x240 260x346 "
                         "720x1280)")
    ap.add_argument("--frames", type=int, default=10,
                    help="frames a repeat")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    unknown = set(args.families) - set(FAMILIES)
    if unknown:
        ap.error(f"unknown families {sorted(unknown)}; of {list(FAMILIES)}")
    print(json.dumps(run(args.families, args.hw, args.frames, args.repeats,
                         args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
