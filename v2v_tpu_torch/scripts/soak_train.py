"""Training soak: the port's train driver at the flagship shape for
thousands of steps, with a SIGKILL mid-epoch and a resume in a fresh
process (the port of the repo-root scripts/soak_train.py).

    python -m v2v_tpu_torch.scripts.soak_train --workdir DIR [--scale 1]
        [--kill-after-epochs 4] [--segment-epochs N] [--finish-only]
        [--malloc-arena-max N] [--smoke] [--device cpu]

What it drives (training/train.py::main in a child process,
`python -u -m v2v_tpu_torch.scripts.soak_train --child DIR`):
  * the flagship `module` block verbatim (bench_full_step.CONFIGS
    ["flagship"]: bf16, LPIPS-VGG, temporal consistency with the
    RAFT-small teacher) over two train stages: 6*scale epochs of Adam
    (amsgrad) at lr 1e-4 with a StepLR of step 3*scale and gamma 0.5,
    then 4*scale epochs at 3e-5 (step 10*scale, gamma 1.0): a stage
    boundary and an LR boundary; B=12, T=40, 128x128 crops;
  * seeded stand-in WebVid clips (data/synthetic.py::DriftingClips; no
    mp4 decode: the card's machine has no cv2), 30 "videos" x 84 samples
    = 2,520 clips, 210 steps an epoch, so 2,100 steps at --scale 1;
  * validation and a checkpoint every epoch on one held-out stand-in
    clip of 16 frames through the port's simulator, in TestH5Dataset's
    contract (data/synthetic.py::SimulatedSequence; no h5py there
    either): its events are its frames', so the probe's MSE can fall as
    the model learns (the JAX soak's val h5 has random events and random
    frames, unrelated, where only the frames' mean can be learned);
  * one SIGKILL mid-epoch: once --kill-after-epochs epochs have
    finished and the next epoch's `lr=` line is out (after the last
    checkpoint, the harshest resume), then a fresh process that must
    resume from the last ckpt_paths line and run to the end.

The parent samples the child's VmRSS from /proc at every poll; the
child prints, at each epoch's end, the caching allocator's reserved and
allocated memory and its K1 launches in that epoch (the parent cannot
read a child's counters). After the run every checkpoint is scored on
the fixed val sequence (MSE and SSIM, eval/metrics.py, through
make_eval_step).

Checks, as the JAX script makes them: every loss finite; the planned
resume at epoch kill_after; at least 3 distinct LRs; the mean of the last
3 losses below that of the first 3 (epoch-summary losses where the
driver printed fewer than 6 step lines: it prints one every 50 steps);
the probe's MSE better over the last two checkpoints than over the first
two where there are >= 3. On the card K1 must launch once a step,
summed over both processes. The host RSS peak and its first-quarter
peak and the reserved-memory series are reported, not bounded.
Writes DIR/soak_summary.json and prints `SOAK OK` last.

`--smoke` runs the JAX smoke's tiny model (base 4 channels, 1 residual
block, no LPIPS, TC L0 2, T=8, crop 32, B=2, 2+2 epochs, 24 clips) and
kills after epoch 1.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import re
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

EXPERIMENT = "soak_e2vid"
CONFIG_NAME = "soak_config.json"
LOG_NAME = "train_log.txt"
# stand-in corpus: "videos" x samples a video (the JAX soak's 30 mp4s of
# 84 samples); the smoke's 3 x 8, 12 steps an epoch
CORPUS = (30, 84)
SMOKE_CORPUS = (3, 8)
# the val clip: a stand-in clip no train batch holds (train items are
# 0 .. n_items - 1 of the same seed's)
VAL_SEED_OFFSET = 30

LOSS_RE = re.compile(
    r"epoch (\d+) step (\d+)/(\d+) loss=([-\d.naif]+) \(([\d.]+) steps/s\)")
EPOCH_RE = re.compile(
    r"Stage (\d+), epoch (\d+): (\d+) steps in ([\d.]+)s, loss=([-\d.naif]+)")
LR_RE = re.compile(r"Stage (\d+), epoch (\d+): lr=([\d.e+-]+)")
RESUME_RE = re.compile(r"Resumed from (.*) at epoch (\d+)")
MEM_RE = re.compile(
    r"soak memory: epoch (\d+) reserved_mb=([\d.]+|None) "
    r"allocated_mb=([\d.]+|None) k1_launches=(\d+)")


def make_config(smoke: bool = False, scale: int = 1,
                stage_epochs: Optional[Tuple[int, int]] = None,
                steps_per_epoch: Optional[int] = None, seed: int = 0
                ) -> Dict[str, Any]:
    """The soak's train config (scripts/soak_train.py::make_config's, as
    a dict: the card's machine has no PyYAML). `stage_epochs` and
    `steps_per_epoch` cut the schedule (chip_smoke.py's [soak]); the
    StepLR halves the LR every e1 // 2 epochs of stage 1. The `soak`
    block tells the child how to build its stand-in data."""
    from .bench_full_step import CONFIGS
    module, stage0 = copy.deepcopy(CONFIGS["flagship"])
    if smoke:
        uk = module["model"]["params"]["unet_kwargs"]
        uk["base_num_channels"] = 4
        uk["num_residual_blocks"] = 1
        module["loss"]["lpips_weight"] = 0.0
        module["loss"]["temporal_consistency_L0"] = 2
    videos, samples = SMOKE_CORPUS if smoke else CORPUS
    dtrain = dict(stage0["dataset"]["train"][0], step_size=1,
                  max_samples_per_shot=samples)
    if smoke:
        dtrain.update(sequence_length=8, crop_size=32)
    dval = {"class_name": "data.testh5.TestH5Dataset",
            "dataset_name": "hqf", "num_bins": 5,
            "sequence_length": 8 if smoke else 16,
            "interpolate_bins": False, "image_range": 1}
    batch = 2 if smoke else 12
    e1, e2 = stage_epochs or ((2, 2) if smoke else (6 * scale, 4 * scale))

    def stage(name, epochs, lr, step_size, gamma):
        return {"stage_name": name, "max_epochs": epochs,
                "optimizer": {"target": "torch.optim.Adam",
                              "params": {"lr": lr, "weight_decay": 0,
                                         "amsgrad": True}},
                "lr_scheduler": {
                    "target": "torch.optim.lr_scheduler.StepLR",
                    "params": {"step_size": step_size, "gamma": gamma}},
                "dataset": {"train": [dtrain], "val": [dval],
                            "train_batch_size": batch,
                            "num_workers": 2 if smoke else 8}}

    n_items = (steps_per_epoch * batch if steps_per_epoch
               else videos * samples)
    return {
        "experiment_name": EXPERIMENT, "seed": seed,
        "check_val_every_n_epoch": 1,
        "module": module,
        # stage 1: the LR halves every e1 // 2 epochs (the LR boundary);
        # stage 2: a fresh optimizer at a lower LR (the stage boundary)
        "train_stages": [stage("stage1", e1, 1e-4, max(1, e1 // 2), 0.5),
                         stage("stage2", e2, 3e-5, 10 * scale, 1.0)],
        "soak": {"n_items": n_items, "val_frames": dval["sequence_length"]},
    }


def _datasets(cfg: Dict[str, Any]):
    """The child's stand-in train set and the fixed val clip."""
    from ..data.synthetic import DriftingClips, SimulatedSequence
    ds = cfg["train_stages"][0]["dataset"]
    seed = cfg["seed"]
    train = DriftingClips(ds["train"][0], seed, cfg["soak"]["n_items"])
    val = SimulatedSequence("val", ds["train"][0], seed + VAL_SEED_OFFSET,
                            0, cfg["soak"]["val_frames"],
                            ds["val"][0]["dataset_name"])
    return train, val


def child(workdir: str, device: Optional[str]) -> int:
    """Train the workdir's config to its end (or a resume of it), printing
    the memory and K1 line at each epoch's end."""
    import torch
    from .. import resolve_device
    from ..ops import voxel_cuda
    from ..training import train
    dev = resolve_device(device)
    with open(os.path.join(workdir, CONFIG_NAME)) as f:
        cfg = json.load(f)
    train_ds, val_ds = _datasets(cfg)
    voxel_cuda.simulate_batch.launches = 0

    def report(epoch: int) -> None:
        if dev.type == "cuda":
            reserved = f"{torch.cuda.memory_reserved(dev) / 2 ** 20:.1f}"
            allocated = f"{torch.cuda.memory_allocated(dev) / 2 ** 20:.1f}"
        else:
            reserved = allocated = "None"
        print(f"soak memory: epoch {epoch} reserved_mb={reserved} "
              f"allocated_mb={allocated} "
              f"k1_launches={voxel_cuda.simulate_batch.launches}",
              flush=True)
        voxel_cuda.simulate_batch.launches = 0

    train.main(cfg, root=workdir, device=dev, train_dataset=train_ds,
               val_dataset=val_ds, on_epoch_end=report)
    return 0


def _rss_mb(pid: int) -> Optional[int]:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) // 1024
    except OSError:
        pass
    return None


def run_phase(cmd: List[str], cwd: str, log_path: str,
              kill_after_epochs: Optional[int] = None,
              rss_samples: Optional[list] = None, timeout_s: float = 9000,
              poll_s: float = 5.0, env: Optional[Dict[str, str]] = None
              ) -> Tuple[int, bool]:
    """Run the child, its output appended to `log_path`, sampling its RSS
    into `rss_samples` as (seconds, MB). With `kill_after_epochs`,
    SIGKILL it once that many epoch-summary lines are in the log and the
    next epoch's `lr=` line is out, `poll_s` later. Returns (exit code,
    killed)."""
    rss_samples = [] if rss_samples is None else rss_samples
    with open(log_path, "ab") as log:
        proc = subprocess.Popen(cmd, cwd=cwd, stdout=log,
                                stderr=subprocess.STDOUT, env=env)
    try:
        t0 = time.time()
        last_flush = t0
        while True:
            rc = proc.poll()
            if rc is not None:
                return rc, False
            if time.time() - t0 > timeout_s:
                raise TimeoutError(f"phase exceeded {timeout_s}s")
            mb = _rss_mb(proc.pid)
            if mb is not None:
                rss_samples.append((round(time.time() - t0, 1), mb))
            if rss_samples and time.time() - last_flush > 60:
                # the evidence survives a parent cut by a time limit
                last_flush = time.time()
                with open(os.path.join(cwd, "soak_progress.json"),
                          "w") as f:
                    json.dump({"elapsed_s": round(time.time() - t0, 1),
                               "rss_series": rss_samples[::6],
                               "rss_mb_peak": max(v for _, v
                                                  in rss_samples)}, f)
            if kill_after_epochs is not None:
                with open(log_path, errors="replace") as f:
                    text = f.read()
                done = len(EPOCH_RE.findall(text))
                started_next = [m for m in LR_RE.finditer(text)
                                if int(m.group(2)) >= kill_after_epochs]
                if done >= kill_after_epochs and started_next:
                    time.sleep(poll_s)     # let a few steps of it run
                    proc.send_signal(signal.SIGKILL)
                    proc.wait()
                    return -9, True
            time.sleep(poll_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def quality_probe(workdir: str, device) -> List[Tuple[int, float, float]]:
    """Every ckpt_paths checkpoint scored on the fixed val sequence with
    MSE and SSIM (data_range 2 on [-1, 1] images, as the JAX probe):
    metrics that need no LPIPS trunk, so their trend means something with
    the random one. [(epoch, mse, ssim)], oldest first."""
    import torch
    from ..eval.metrics import mse as mse_fn
    from ..eval.metrics import ssim as ssim_fn
    from ..training.checkpoint import all_ckpt_paths, load_params_only
    from ..training.interface import ModelInterface
    from ..training.steps import make_eval_step
    with open(os.path.join(workdir, CONFIG_NAME)) as f:
        cfg = json.load(f)
    _, val = _datasets(cfg)
    item = val[0]
    events = torch.as_tensor(item["events"], device=device)[None]
    frames = np.asarray(item["frame"])[None]
    b, _, h, w, _ = events.shape
    # no loss: the probe needs no LPIPS trunk
    iface = ModelInterface(dict(cfg["module"], loss={}), device,
                           generator=torch.Generator(
                               device=device).manual_seed(0))
    eval_step = make_eval_step(iface)
    out = []
    for path in all_ckpt_paths(EXPERIMENT, workdir):
        if not os.path.isabs(path):
            path = os.path.join(workdir, path)
        load_params_only(path, iface.model)
        pred, _ = eval_step(events, iface.init_state(b, h, w))
        pred = pred.float().cpu().numpy()
        m = float(np.mean([mse_fn(pred[0, t], frames[0, t])
                           for t in range(pred.shape[1])]))
        s = float(np.mean([ssim_fn(pred[0, t, ..., 0] * 2 - 1,
                                   frames[0, t, ..., 0] * 2 - 1)
                           for t in range(pred.shape[1])]))
        ep = int(re.search(r"epoch_(\d+)", path).group(1))
        out.append((ep, m, s))
        print(f"quality probe: epoch {ep} MSE={m:.5f} SSIM={s:.4f}",
              flush=True)
    return out


def summarize(workdir: str, kill_after: int, rss, device,
              extra: Dict[str, Any]) -> Dict[str, Any]:
    """Parse the log, run the quality probe, write soak_summary.json with
    every series and the checks that failed, then raise if any did."""
    with open(os.path.join(workdir, LOG_NAME), errors="replace") as f:
        text = f.read()
    steps = [(int(m.group(1)), int(m.group(2)), float(m.group(4)),
              float(m.group(5))) for m in LOSS_RE.finditer(text)]
    epochs = [(int(m.group(1)), int(m.group(2)), int(m.group(3)),
               float(m.group(4)), float(m.group(5)))
              for m in EPOCH_RE.finditer(text)]
    lrs = sorted({(int(m.group(2)), float(m.group(3)))
                  for m in LR_RE.finditer(text)})
    resumes = RESUME_RE.findall(text)
    mem = [(int(m.group(1)),
            None if m.group(2) == "None" else float(m.group(2)),
            None if m.group(3) == "None" else float(m.group(3)),
            int(m.group(4))) for m in MEM_RE.finditer(text)]
    with open(os.path.join(workdir, "tensorboard_logs", EXPERIMENT,
                           "val_loss.txt")) as f:
        val_lines = [ln for ln in f if ln.strip()]
    failed: List[str] = []

    def check(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    # step-granular losses where the driver printed them (every 50
    # steps), else the epoch summaries' (a short epoch prints none)
    losses = [x for (_, _, x, _) in steps]
    epoch_losses = [x for (_, _, _, _, x) in epochs]
    check(bool(epochs) and all(np.isfinite(losses + epoch_losses)),
          f"non-finite loss or no epoch ran: {epoch_losses}")
    if len(losses) < 6:
        losses = epoch_losses
    resume_epoch = int(resumes[0][1]) if resumes else None
    check(resume_epoch == kill_after,
          f"resumed at epoch {resume_epoch}, expected {kill_after}")
    check(len({lr for (_, lr) in lrs}) >= 3,
          f"expected >= 3 distinct LRs (StepLR + stage 2): {lrs}")
    total_steps = sum(e[2] for e in epochs)
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    check(last < first, f"loss did not trend down: {first} -> {last}")
    k1 = sum(x[3] for x in mem)
    check(len(mem) == len(epochs),
          f"{len(mem)} memory lines for {len(epochs)} epochs")
    if device.type == "cuda":
        check(k1 == total_steps and all(
            x[3] == e[2] for x, e in zip(mem, epochs)),
            f"K1 launched {k1} times in {total_steps} steps, "
            f"{[x[3] for x in mem]} by epoch")
    rss_vals = [v for (_, v) in rss] or [0]
    quality = quality_probe(workdir, device)
    if len(quality) >= 3:
        q_first = np.mean([m for (_, m, _) in quality[:2]])
        q_last = np.mean([m for (_, m, _) in quality[-2:]])
        check(q_last < q_first,
              f"probe MSE did not improve: {q_first:.5f} -> {q_last:.5f}")
    summary = {
        "device": str(device),
        "failed_checks": failed,
        "quality_by_epoch": quality,
        **extra,
        "rss_series": rss[::6],
        "total_steps": total_steps,
        "epochs": len(epochs),
        "resume_epoch": resume_epoch,
        "loss_first3_mean": float(first),
        "loss_last3_mean": float(last),
        "val_losses": [float(ln.rsplit(":", 1)[1]) for ln in val_lines],
        "lr_by_epoch": lrs,
        "steps_per_sec_last": steps[-1][3] if steps else None,
        "epoch_seconds": [e[3] for e in epochs],
        "rss_mb_peak": max(rss_vals),
        "rss_mb_first_quarter_peak": max(
            rss_vals[:max(1, len(rss_vals) // 4)]),
        "reserved_mb_by_epoch": [(x[0], x[1]) for x in mem],
        "allocated_mb_by_epoch": [(x[0], x[2]) for x in mem],
        "k1_launches": k1,
        "loss_by_step": [(e * 1000 + s, x) for (e, s, x, _) in steps],
        "loss_by_epoch": [(e[1], e[4]) for e in epochs],
    }
    with open(os.path.join(workdir, "soak_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if failed:
        raise RuntimeError("soak: " + "; ".join(failed))
    return summary


def run(workdir: str, smoke: bool = False, scale: int = 1,
        kill_after: Optional[int] = None, finish_only: bool = False,
        segment_epochs: Optional[int] = None,
        malloc_arena_max: Optional[int] = None, device=None,
        stage_epochs: Optional[Tuple[int, int]] = None,
        steps_per_epoch: Optional[int] = None,
        poll_s: Optional[float] = None,
        timeout_s: float = 9000) -> Dict[str, Any]:
    """Phase 1 (to the kill), phase 2 (the resume to the end, or
    `segment_epochs`-epoch segments each in a fresh process), then the
    checks; returns the summary."""
    from .. import resolve_device
    dev = resolve_device(device)
    wd = os.path.abspath(workdir)
    os.makedirs(wd, exist_ok=True)
    kill_after = kill_after or (1 if smoke else 4)
    log_path = os.path.join(wd, LOG_NAME)
    if not finish_only:
        cfg = make_config(smoke, scale, stage_epochs, steps_per_epoch)
        with open(os.path.join(wd, CONFIG_NAME), "w") as f:
            json.dump(cfg, f, indent=1)
    env = dict(os.environ)
    if not os.path.exists(os.path.join(
            env.get("V2V_WEIGHTS_DIR", "pretrained"), "raft_small.pth")):
        # no pretrained teacher: the random one (the same compute and
        # memory; the loss is consistent only with itself)
        env["V2V_RANDOM_TEACHER"] = "1"
    if malloc_arena_max is not None:
        env["MALLOC_ARENA_MAX"] = str(malloc_arena_max)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-u", "-m", "v2v_tpu_torch.scripts.soak_train",
           "--child", wd] + (["--device", str(dev)] if device else [])
    poll = poll_s if poll_s is not None else (0.2 if smoke else 5.0)
    rss: list = []

    def phase(kill):
        return run_phase(cmd, wd, log_path, kill, rss, timeout_s, poll, env)

    t0 = time.time()
    if not finish_only:
        print(f"phase 1: train until the mid-epoch-{kill_after} kill",
              flush=True)
        rc1, killed = phase(kill_after)
        if not (killed and rc1 == -9):
            raise RuntimeError(f"soak: phase 1 ended rc={rc1} "
                               f"killed={killed}")
        print("phase 1 killed as planned; phase 2: resume to the end",
              flush=True)
    n_segments = 0
    if segment_epochs:
        while True:
            with open(log_path, errors="replace") as f:
                done = len(EPOCH_RE.findall(f.read()))
            rc2, killed = phase(done + segment_epochs)
            if not killed:
                if rc2 != 0:
                    raise RuntimeError(f"soak: segmented run exited "
                                       f"rc={rc2}")
                break
            n_segments += 1
            print(f"segment {n_segments}: restarted after epoch "
                  f"{done + segment_epochs}", flush=True)
    else:
        rc2, _ = phase(None)
        if rc2 != 0:
            raise RuntimeError(f"soak: resume run exited rc={rc2}")
    wall = time.time() - t0
    return summarize(wd, kill_after, rss, dev, {
        "malloc_arena_max": malloc_arena_max,
        "segment_epochs": segment_epochs, "n_segments": n_segments,
        "wall_s": wall})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m v2v_tpu_torch.scripts.soak_train",
        description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", help="the run's directory")
    ap.add_argument("--child", metavar="DIR",
                    help="(internal) train DIR's config in this process")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="the tiny model and shapes: the driver's logic")
    ap.add_argument("--kill-after-epochs", type=int, default=None,
                    help="SIGKILL mid-epoch after this many epochs "
                         "(default 1 with --smoke, else 4)")
    ap.add_argument("--finish-only", action="store_true",
                    help="skip the kill: resume the workdir's run to its "
                         "end and check it (its log must already hold the "
                         "kill and the resume)")
    ap.add_argument("--scale", type=int, default=1,
                    help="multiply the stage epochs (5: 10,500 steps)")
    ap.add_argument("--segment-epochs", type=int, default=None,
                    help="restart the child from its last checkpoint every "
                         "N epochs (each a resume in a fresh process)")
    ap.add_argument("--malloc-arena-max", type=int, default=None,
                    help="MALLOC_ARENA_MAX for the child (glibc's "
                         "per-thread arenas; scripts/diag_rss.py)")
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.device)
    if not args.workdir:
        ap.error("--workdir is required")
    summary = run(args.workdir, args.smoke, args.scale,
                  args.kill_after_epochs, args.finish_only,
                  args.segment_epochs, args.malloc_arena_max, args.device)
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("loss_by_step", "rss_series")},
                     indent=1), flush=True)
    print("SOAK OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
