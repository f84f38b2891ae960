"""K5 (csrc/sim_interleave.cu) and K2 (csrc/esim.cu's gaussian_kernel)
timed on the card through their wrappers, each held to its plain
version in equal bits first.

- K5 at the experiment's shape (12, 201, 128, 128), uint8 video, for
  each spp of the experiment: back to back (20 calls between two CUDA
  events), beside K1 on the same clips with every pixel hot (equal bits),
  and the instructions a pixel-frame of each instance's quad loop in the
  SASS with the issue bound they set.
- K2 back to back at 512x512 (its callers' shape), at n = 4 (one thread:
  the launch floor of the route) and at 4096x4096 (67.1 MB written),
  through its wrapper; at n = 4 and 4096x4096 also through the C entry
  into a preallocated output (50 calls): the n = 4 time is that route's
  floor, and the 4096x4096 time is the card's where the floor lies
  below it (chip_smoke.py's [k2] times both in a CUDA graph).

With `--parent DIR`, the K5 and K2 of the tree unpacked in DIR (its own
package and build) are held to this tree's and timed back to back in
turns with this tree's: parent, this, this, parent.

    python -m v2v_tpu_torch.scripts.k5_designs [--parent DIR]
"""
from __future__ import annotations

import argparse
import importlib
import subprocess
from pathlib import Path

import torch

from v2v_tpu_torch.ops import _sass
from v2v_tpu_torch.ops import sim_interleave as si
from v2v_tpu_torch.ops import voxel_cuda as vc
from v2v_tpu_torch.ops._build import check, stream
from v2v_tpu_torch.ops.voxel import SimParams
from v2v_tpu_torch.scripts.k1_designs import (SHAPE, back_to_back_ms,
                                              inputs, load_parent)

SPPS = (1, 2, 4)
K2_SHAPES = vc.K2_SHAPES
K2_SEED = 1234


def k5_inputs(dev):
    """K1's design inputs (k1_designs.inputs) as K5's: the video, the
    seeds and the (pos, neg, noise) per-clip tensors."""
    video, seeds, params = inputs(dev)
    return video, seeds, (params.pos_thres, params.neg_thres,
                          params.base_noise_std)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="a tree whose K5 and K2 are timed beside these")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    video, seeds, prm = k5_inputs(dev)
    b, n, h, w = SHAPE
    want = si.simulate_interleave_plain(video, seeds, *prm)
    hot = SimParams(*prm, torch.full_like(prm[0], 2.0),
                    torch.full_like(prm[0], si.HOT_STD))
    k1 = vc.simulate_batch(video, seeds, hot)
    for spp in SPPS:
        got = si.simulate_interleave(video, seeds, *prm, spp=spp)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, k1)):
            raise RuntimeError(f"K5 spp={spp}: bits differ from the plain "
                               f"version or K1")
    print(f"K5 spp {list(SPPS)}: equal bits with the plain version and K1 "
          f"(every pixel hot)", flush=True)
    numels = {}
    for name, shape in K2_SHAPES.items():
        got = vc.sample_gaussian(K2_SEED, shape, device=dev)
        numels[name] = got.numel()
        if not torch.equal(got.flatten(), vc.sample_gaussian_plain(
                K2_SEED, got.numel(), dev)):
            raise RuntimeError(f"K2 {name}: bits differ")
    print(f"K2 {list(K2_SHAPES)}: equal bits with the plain version",
          flush=True)
    for lib, kernel in ((si.LIB, "sim_interleave_kernel"),
                        (vc.LIB, "gaussian_kernel")):
        for line in _sass.ptxas_summary(lib.build()["log"]):
            if line.startswith(kernel):
                print(f"ptxas: {line}", flush=True)

    trees = {"this": (si, vc)}
    order = ["this"]
    if args.parent:
        pvc = load_parent(args.parent.resolve())
        psi = importlib.import_module("v2v_parent.ops.sim_interleave")
        for spp in SPPS:
            theirs = psi.simulate_interleave(video, seeds, *prm, spp=spp)
            torch.cuda.synchronize()
            if not torch.equal(theirs, want):
                raise RuntimeError(f"the parent's K5 spp={spp} differs")
        print(f"parent ({args.parent}): K5 equal to this tree's", flush=True)
        trees["parent"] = (psi, pvc)
        order = ["parent", "this", "this", "parent"]
    fns = {}
    for tree, (tsi, tvc) in trees.items():
        for spp in SPPS:
            fns[(tree, f"K5 spp={spp}")] = (
                lambda tsi=tsi, spp=spp: tsi.simulate_interleave(
                    video, seeds, *prm, spp=spp))
        for name, shape in K2_SHAPES.items():
            fns[(tree, f"K2 {name}")] = (
                lambda tvc=tvc, shape=shape: tvc.sample_gaussian(
                    K2_SEED, shape, device=dev))
    times = {k: [] for k in fns}
    for tree in order:
        for k in fns:
            if k[0] == tree:
                times[k].append(back_to_back_ms(fns[k]))
    for (tree, what), ms in times.items():
        print(f"{tree} {what}: {' '.join(f'{t:.4f}' for t in ms)} ms back "
              f"to back", flush=True)
    k1_ms = back_to_back_ms(lambda: vc.simulate_batch(video, seeds, hot))
    px_frames = b * (n - 1) * h * w
    print(f"K1 (every pixel hot): {k1_ms:.4f} ms back to back; K5 spp=1 / "
          f"K1: {min(times[('this', 'K5 spp=1')]) / k1_ms:.3f}", flush=True)
    for spp, (_, per, pix, _) in _sass.k5_issue_report(
            si.LIB.build()["path"]).items():
        if spp in SPPS and per is not None:
            print(f"K5 spp={spp} ({pix} pixels a thread): {per:.2f} "
                  f"instructions a pixel-frame, issue bound "
                  f"{_sass.issue_ms(per * px_frames):.4f} ms", flush=True)
    for name in ("n=4", "4096x4096"):
        out = torch.empty(numels[name], dtype=torch.float32, device=dev)
        ms = back_to_back_ms(lambda out=out: check(
            vc.LIB.get().v2v_sample_gaussian(K2_SEED, out.data_ptr(),
                                             out.numel(), stream()), "K2"),
            reps=50)
        print(f"K2 {name} through the C entry: {ms:.4f} ms back to back",
              flush=True)
    for name, numel in numels.items():
        print(f"K2 {name}: bytes bound {numel * 4 / 3.35e12 * 1e3:.5f} ms",
              flush=True)


if __name__ == "__main__":
    main()
