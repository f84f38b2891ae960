"""Host-RSS attribution for the train loop (the port of the repo-root
scripts/diag_rss.py): each leakable layer of the soak's loop runs alone
in a fresh process, with its RSS and tracemalloc's Python heap sampled,
so that a climb is named, not guessed.

    python -m v2v_tpu_torch.scripts.diag_rss [--phases loader,transfer,
        step,full] [--iters 300] [--sample-every 10] [--workers 0]
        [--workdir DIR] [--smoke] [--device cpu]

    loader    stand-in clips (data/synthetic.py::DriftingClips) through
              the port's DataLoader threads, batches collated on the
              host; no device contact
    transfer  the same uint8 batch shipped over and over through
              training/train.py::_prefetch_to_device (a pinned copy of
              each batch and a non_blocking copy to the card), with a
              synchronize: the pinned host allocator alone
    step      training/steps.py::make_train_step on one batch preloaded
              on the card: the step's buffers, the caching allocator,
              the optimizer state, the lazily built teacher and LPIPS
    full      loader + transfer + step: the soak's loop, condensed

The flagship's shapes (B=12, T=40, 201 frames of 128x128: 39.5 MB a
batch) and module (soak_train.make_config's); --smoke takes the soak
smoke's (B=2, T=8, 32x32, a width-4 model). Each phase prints the JAX
script's lines: an RSS series (MB every --sample-every iterations),
tracemalloc's Python heap, the native residual (RSS - heap: C/C++
allocations, pinned and pageable host buffers, the CUDA driver) and RSS
after gc and malloc_trim (a fall there is freed heap that glibc kept, not
a live leak); on the card also the caching allocator's reserved-memory
series. Writes DIR/diag_rss_summary.json; exits 1 if a phase failed.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import tracemalloc
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np

PHASE_NAMES = ("loader", "transfer", "step", "full")


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def _malloc_trim() -> float:
    """gc and glibc's malloc_trim(0), then RSS: if RSS falls here, the
    climb was freed heap that glibc's per-thread arenas kept (bounded by
    MALLOC_ARENA_MAX), not live objects."""
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    return rss_mb()


def _report(tag: str, series, traced_mb: float,
            reserved: Optional[list] = None) -> Dict[str, Any]:
    first = series[0][1]
    peak = max(v for _, v in series)
    last = series[-1][1]
    trimmed = _malloc_trim()
    print(f"[{tag}] RSS first={first:.0f} last={last:.0f} "
          f"peak={peak:.0f} MB  python-heap={traced_mb:.0f} MB  "
          f"native-residual={last - traced_mb:.0f} MB  "
          f"after-gc+malloc_trim={trimmed:.0f} MB", flush=True)
    print(f"[{tag}] RSS series (iter, MB): "
          + " ".join(f"{i}:{v:.0f}" for i, v in series), flush=True)
    if reserved:
        print(f"[{tag}] reserved series (iter, MB): "
              + " ".join(f"{i}:{v:.0f}" for i, v in reserved), flush=True)
    return {"tag": tag, "first_mb": first, "last_mb": last,
            "peak_mb": peak, "python_heap_mb": traced_mb,
            "trimmed_mb": trimmed, "series": series,
            "reserved_series": reserved}


def _soak_config(smoke: bool) -> Dict[str, Any]:
    from .soak_train import make_config
    return make_config(smoke)


def _shapes(cfg: Dict[str, Any]):
    """(B, frames, H, W) of the config's train batch."""
    stage = cfg["train_stages"][0]["dataset"]
    train = stage["train"][0]
    n = train["sequence_length"] * train["num_bins"] + 1
    return stage["train_batch_size"], n, train["crop_size"], \
        train["crop_size"]


def _stand_in(cfg: Dict[str, Any], n_items: int = 72):
    from ..data.synthetic import DriftingClips
    return DriftingClips(cfg["train_stages"][0]["dataset"]["train"][0],
                         cfg["seed"], n_items)


class _Sampler:
    """RSS (and, on the card, reserved memory) every `every` iterations."""

    def __init__(self, dev, every: int):
        import torch
        self.torch, self.dev, self.every = torch, dev, every
        self.series = [(0, rss_mb())]
        self.reserved = [] if dev.type == "cuda" else None
        self._reserved(0)

    def _reserved(self, it):
        if self.reserved is not None:
            self.reserved.append(
                (it, self.torch.cuda.memory_reserved(self.dev) / 2 ** 20))

    def __call__(self, it: int, sync=None) -> None:
        if it % self.every == 0:
            if sync is not None:
                sync()
            self.series.append((it, rss_mb()))
            self._reserved(it)


def _loader(cfg, dataset, workers: int):
    from ..data.interface import DataLoader
    b = cfg["train_stages"][0]["dataset"]["train_batch_size"]
    return DataLoader(dataset, b, shuffle=True, drop_last=True,
                      num_workers=max(1, workers))


def phase_loader(args, dataset=None) -> Dict[str, Any]:
    """Stand-in clips through the DataLoader's threads and the collate,
    nothing on the device. Leak candidates: the loader's threads, started
    afresh each epoch, and its queue of batches."""
    from .. import resolve_device
    cfg = _soak_config(args.smoke)
    loader = _loader(cfg, dataset or _stand_in(cfg), args.workers)
    tracemalloc.start()
    sample = _Sampler(resolve_device("cpu"), args.sample_every)
    it, epoch = 0, 0
    while it < args.iters:
        loader.set_epoch(epoch)
        for _ in loader:
            it += 1
            sample(it)
            if it >= args.iters:
                break
        epoch += 1
    traced = tracemalloc.get_traced_memory()[0] / 1e6
    for s in tracemalloc.take_snapshot().statistics("lineno")[:5]:
        print(f"[loader] top-alloc {s}", flush=True)
    tracemalloc.stop()
    return _report("loader", sample.series, traced)


def phase_transfer(args) -> Dict[str, Any]:
    """One uint8 batch shipped over and over through the driver's
    _prefetch_to_device: a pinned host copy of each batch, a non_blocking
    copy to the card, a synchronize. Leak candidate: the pinned host
    allocator (a 39.5 MB flagship batch a step, 83 GB over 2,100 steps
    if each were kept)."""
    import torch
    from .. import resolve_device
    from ..training.train import _prefetch_to_device
    dev = resolve_device(args.device)
    cfg = _soak_config(args.smoke)
    b, n, h, w = _shapes(cfg)
    video = np.random.RandomState(0).randint(0, 255, (b, n, h, w)).astype(
        np.uint8)

    def batches():
        for it in range(1, args.iters + 1):
            video[0, 0, 0, 0] = it % 251
            yield {"video": video, "data_source_idx": np.full((b,), 11)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    tracemalloc.start()
    sample = _Sampler(dev, args.sample_every)
    shipped = 0
    for it, (batch, _) in enumerate(_prefetch_to_device(batches(), dev), 1):
        float(batch["video"][0, 0, 0, 0])
        shipped += video.nbytes
        del batch
        sample(it, sync)
    traced = tracemalloc.get_traced_memory()[0] / 1e6
    tracemalloc.stop()
    print(f"[transfer] shipped {shipped / 1e9:.1f} GB in all "
          f"({video.nbytes / 1e6:.1f} MB an iteration)", flush=True)
    out = _report("transfer", sample.series, traced, sample.reserved)
    out["shipped_gb"] = shipped / 1e9
    return out


def _train_step(cfg, dev):
    """The soak config's train step, its LPIPS trunk random where no
    weights exist, its teacher from $V2V_WEIGHTS_DIR or random under
    V2V_RANDOM_TEACHER (which `run` sets for its children where no
    teacher's weights exist)."""
    import torch
    from ..training.interface import ModelInterface
    from ..training.steps import make_train_step
    from ..training.train import (make_optimizer, make_scheduler,
                                  sim_config_from_dataset)
    stage = cfg["train_stages"][0]
    g = torch.Generator(device=dev).manual_seed(cfg["seed"])
    iface = ModelInterface(cfg["module"], dev, generator=g)
    opt_cfg = make_optimizer(stage["optimizer"])
    opt = opt_cfg.make(iface.model.parameters())
    for group in opt.param_groups:
        group["lr"] = opt_cfg.base_lr * make_scheduler(
            stage["lr_scheduler"])(0)
    train = stage["dataset"]["train"][0]
    return make_train_step(iface, opt, sim_config_from_dataset(train),
                           train["num_bins"])


def _k1_launches() -> int:
    """K1's launches in this process (the parent cannot read them)."""
    from ..ops.voxel_cuda import simulate_batch
    return simulate_batch.launches


def _step_generator(dev, it: int):
    import torch
    from ..training.steps import step_seed
    return torch.Generator(device=dev).manual_seed(step_seed(1, it))


def phase_step(args) -> Dict[str, Any]:
    """The train step on one batch preloaded on the card, no loader and no
    transfer a step. Leak candidates: the step's outputs, the caching
    allocator, the optimizer state, the lazily built teacher and LPIPS."""
    import torch
    from .. import resolve_device
    dev = resolve_device(args.device)
    cfg = _soak_config(args.smoke)
    b, n, h, w = _shapes(cfg)
    step = _train_step(cfg, dev)
    batch = {"video": torch.as_tensor(np.random.RandomState(0).randint(
        0, 255, (b, n, h, w)).astype(np.uint8), device=dev),
        "data_source_idx": torch.full((b,), 11, dtype=torch.int64)}
    tracemalloc.start()
    sample = _Sampler(dev, args.sample_every)
    loss = None
    for it in range(1, args.iters + 1):
        loss, _ = step(batch, _step_generator(dev, it))
        sample(it, lambda: float(loss))
    print(f"[step] final loss {float(loss):.4f}", flush=True)
    traced = tracemalloc.get_traced_memory()[0] / 1e6
    tracemalloc.stop()
    return dict(_report("step", sample.series, traced, sample.reserved),
                k1_launches=_k1_launches())


def phase_full(args, dataset=None) -> Dict[str, Any]:
    """Loader, transfer and step: the soak's loop, condensed. A climb here
    that the three alone do not show belongs to their interaction (the
    prefetch holding device batches, say)."""
    from .. import resolve_device
    from ..training.train import _prefetch_to_device
    dev = resolve_device(args.device)
    cfg = _soak_config(args.smoke)
    loader = _loader(cfg, dataset or _stand_in(cfg), args.workers)
    step = _train_step(cfg, dev)
    tracemalloc.start()
    sample = _Sampler(dev, args.sample_every)
    it, epoch, loss = 0, 0, None
    while it < args.iters:
        loader.set_epoch(epoch)
        batches = _prefetch_to_device(iter(loader), dev)
        for batch, _ in batches:
            it += 1
            loss, _ = step(batch, _step_generator(dev, it))
            sample(it, lambda: float(loss))
            if it >= args.iters:
                break
        batches.close()
        epoch += 1
    print(f"[full] final loss {float(loss):.4f}", flush=True)
    traced = tracemalloc.get_traced_memory()[0] / 1e6
    tracemalloc.stop()
    return dict(_report("full", sample.series, traced, sample.reserved),
                k1_launches=_k1_launches())


PHASES = {"loader": phase_loader, "transfer": phase_transfer,
          "step": phase_step, "full": phase_full}


def run(phases: List[str], iters: int = 300, sample_every: int = 10,
        workers: int = 0, workdir: Optional[str] = None, smoke: bool = False,
        device: Optional[str] = None, concurrent: bool = False
        ) -> Dict[str, Any]:
    """Each phase in a fresh `python -m v2v_tpu_torch.scripts.diag_rss
    --child PHASE` process, one after another, or all at once with
    `concurrent` (each RSS is still its own process's; only the times
    mix); {phase: its report}. Each child's output goes to
    WORKDIR/PHASE.log and is printed when it ends. Raises if a phase
    failed, after running the others."""
    from .. import resolve_device
    resolve_device(device)         # on the card unless asked for the CPU
    workdir = workdir or tempfile.mkdtemp(prefix="diag_rss_")
    os.makedirs(workdir, exist_ok=True)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in [env.get("PYTHONPATH")] if p])
    if not os.path.exists(os.path.join(
            env.get("V2V_WEIGHTS_DIR", "pretrained"), "raft_small.pth")):
        env["V2V_RANDOM_TEACHER"] = "1"     # the compute of the real one
    results, failed = {}, []

    def start(phase):
        cmd = [sys.executable, "-u", "-m", "v2v_tpu_torch.scripts.diag_rss",
               "--child", phase, "--iters", str(iters),
               "--sample-every", str(sample_every),
               "--workers", str(workers), "--json-out",
               os.path.join(workdir, f"{phase}.json")] \
            + (["--smoke"] if smoke else []) \
            + (["--device", str(device)] if device else [])
        with open(os.path.join(workdir, f"{phase}.log"), "w") as log:
            proc = subprocess.Popen(cmd, env=env, stdout=log,
                                    stderr=subprocess.STDOUT)
        return phase, proc, time.perf_counter()

    def finish(phase, proc, t0):
        rc = proc.wait()
        seconds = time.perf_counter() - t0
        print(f"\n=== phase {phase} ===", flush=True)
        with open(os.path.join(workdir, f"{phase}.log")) as f:
            print(f.read(), end="", flush=True)
        jout = os.path.join(workdir, f"{phase}.json")
        if rc == 0 and os.path.isfile(jout):
            with open(jout) as f:
                results[phase] = dict(json.load(f), process_s=seconds)
        else:
            failed.append(f"{phase} (rc {rc})")

    if concurrent:
        for started in [start(p) for p in phases]:
            finish(*started)
    else:
        for p in phases:
            finish(*start(p))
    summary = os.path.join(workdir, "diag_rss_summary.json")
    with open(summary, "w") as f:
        json.dump(results, f, indent=1)
    print(f"\nwrote {summary}", flush=True)
    for tag, r in results.items():
        print(f"  {tag:9s} growth {r['last_mb'] - r['first_mb']:+8.0f} MB "
              f"(python heap {r['python_heap_mb']:.0f} MB; its process "
              f"{r['process_s']:.1f} s)", flush=True)
    if failed:
        raise RuntimeError(f"diag_rss: phases failed: {', '.join(failed)}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m v2v_tpu_torch.scripts.diag_rss",
        description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASE_NAMES))
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--sample-every", type=int, default=10)
    ap.add_argument("--workers", type=int, default=0,
                    help="loader threads (at least 1)")
    ap.add_argument("--workdir", default=None,
                    help="where the phases' JSON go (default: a temp dir)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--child", choices=PHASE_NAMES,
                    help="(internal) run one phase in this process")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if args.child:
        out = PHASES[args.child](SimpleNamespace(
            iters=args.iters, sample_every=args.sample_every,
            workers=args.workers, smoke=args.smoke, device=args.device))
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(out, f)
        return 0
    run([p.strip() for p in args.phases.split(",")], args.iters,
        args.sample_every, args.workers, args.workdir, args.smoke,
        args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
