"""K1 (csrc/esim.cu) timed on the card at the flagship shape (12, 201,
128, 128), uint8 video with noise, through its wrapper: back to back (20
calls between two CUDA events), a call (CUDA events around each call),
the host's time a call, and its quad loop's instructions a pixel-frame
counted in the SASS. With `--parent DIR`, the K1 of the tree unpacked in
DIR (its own package and build) is held to this tree's noise-free counts
and timed back to back in turns with this tree's: parent, this, this,
parent. `--sass FILE` writes the loop's listing there.

    python -m v2v_tpu_torch.scripts.k1_designs [--parent DIR] [--sass FILE]
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from v2v_tpu_torch.ops import _sass
from v2v_tpu_torch.ops import voxel_cuda as vc
from v2v_tpu_torch.ops.voxel import SimConfig, sample_sim_params

SHAPE = (12, 201, 128, 128)


def back_to_back_ms(fn, reps: int = 20) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def a_call_ms(fn, reps: int = 20) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def load_parent(root: Path):
    """The voxel_cuda module of the v2v_tpu_torch package in `root`,
    imported as the package `v2v_parent` (it builds into root/build)."""
    init = root / "v2v_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "v2v_parent", init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["v2v_parent"] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module("v2v_parent.ops.voxel_cuda")


def inputs(dev):
    """uint8 video at SHAPE, a smoothed random texture a clip moving one
    pixel a frame to the left, and per-clip parameters drawn from the
    flagship config's ranges (SimConfig's defaults), on `dev`, seed 0."""
    b, n, h, w = SHAPE
    g = torch.Generator(device=dev).manual_seed(0)
    tex = torch.nn.functional.avg_pool2d(torch.rand(
        (b, 1, h, 2 * w), generator=g, device=dev), 3, 1, 1) * 255.0
    shift = torch.arange(n, device=dev).view(1, n, 1, 1)
    cols = (torch.arange(w, device=dev).view(1, 1, 1, w) + shift) % (2 * w)
    video = tex.expand(b, n, h, 2 * w).gather(
        3, cols.expand(b, n, h, w)).to(torch.uint8)
    params = sample_sim_params(g, SimConfig(), b)
    seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=g, device=dev,
                          dtype=torch.int32)
    return video, seeds, params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="a tree whose K1 is timed beside this one's")
    ap.add_argument("--sass", type=Path,
                    help="where to write the quad loop's listing")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    video, seeds, params = inputs(dev)
    want = vc.simulate_batch_plain(video, seeds, params)
    got = vc.simulate_batch(video, seeds, params)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError("K1's bits differ from the plain version")
    fns = {"this": lambda: vc.simulate_batch(video, seeds, params)}
    order = ["this"]
    if args.parent:
        pvc = load_parent(args.parent.resolve())
        theirs = pvc.simulate_batch(video, seeds, params, noise_free=True)
        mine = vc.simulate_batch(video, seeds, params, noise_free=True)
        torch.cuda.synchronize()
        if not torch.equal(theirs.to(torch.bfloat16), mine):
            raise RuntimeError("the parent's noise-free counts differ")
        print(f"parent ({args.parent}): noise-free counts equal this "
              f"tree's", flush=True)
        fns["parent"] = lambda: pvc.simulate_batch(video, seeds, params)
        order = ["parent", "this", "this", "parent"]
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(back_to_back_ms(fns[k]))
    for k, ms in times.items():
        print(f"{k}: {' '.join(f'{t:.4f}' for t in ms)} ms back to back",
              flush=True)
    call = fns["this"]
    ms = a_call_ms(call)
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        call()
    host_ms = (time.perf_counter() - t0) * 10
    torch.cuda.synchronize()
    print(f"this: {ms:.4f} ms a call; the host's time a call, 100 calls "
          f"enqueued: {host_ms:.4f} ms", flush=True)
    _, per, pix, listing = _sass.k1_issue_report(vc.LIB.build()["path"])
    if per is not None:
        b, n, h, w = SHAPE
        print(f"this ({pix} pixels a thread): {per:.2f} instructions a "
              f"pixel-frame, issue bound "
              f"{_sass.issue_ms(per * b * (n - 1) * h * w):.4f} ms",
              flush=True)
    if args.sass and listing:
        args.sass.parent.mkdir(parents=True, exist_ok=True)
        args.sass.write_text(listing + "\n")


if __name__ == "__main__":
    main()
