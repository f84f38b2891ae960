"""Experiment orchestration: the stage loop, resume, checkpoints,
validation and TensorBoard logging (port of v2v_tpu/training/train.py;
reference train.py:71-252), on one process or, under torchrun, one
process a card (parallel/mesh.py).

The host loader ships uint8 video; `_prefetch_to_device` keeps it ahead
of the card as pinned host tensors copied without blocking, and each
step (training/steps.py) simulates the events on the card (K1), runs the
forward, the loss, the backward and the update. Checkpoints follow the
reference's `ckpt_paths` resume protocol.

Under torchrun each process trains on its own rows: `train_batch_size`
is the batch of one process, so the global batch is that times the world
size (the JAX driver's per-host rule and the reference's DDP rule). Only
rank 0 writes TensorBoard, val_loss.txt, ckpt_paths and checkpoints;
every rank resumes from the same file.
"""
from __future__ import annotations

import collections
import datetime
import math
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import resolve_target
from ..data.interface import DataLoader, make_concat_multi_dataset
from ..ops.voxel import SimConfig
from ..parallel import mesh
from ..utils import timers
from .checkpoint import (append_ckpt_path, last_ckpt_path, load_checkpoint,
                         load_optimizer_state, save_checkpoint)
from .flow_interface import FlowModelInterface
from .interface import ModelInterface, aggregate_per_source
from .preview import make_flow_preview, make_preview
from .steps import make_eval_step, make_train_step, step_seed


def sim_config_from_dataset(cfg: Dict[str, Any]) -> SimConfig:
    """The device simulator config from a WebVid dataset config block
    (the reference passes these to imgs_to_voxels,
    data/v2v_datasets.py:54-60)."""
    return SimConfig(
        threshold_range=tuple(cfg.get("threshold_range", [0.05, 2])),
        max_thres_pos_neg_gap=cfg.get("max_thres_pos_neg_gap", 1.5),
        base_noise_std_range=tuple(cfg.get("base_noise_std_range", [0, 0.2])),
        hot_pixel_fraction_range=tuple(
            cfg.get("hot_pixel_fraction_range", [0, 0.001])),
        hot_pixel_std_range=tuple(cfg.get("hot_pixel_std_range", [0, 0.2])),
        put_noise_external=cfg.get("put_noise_external", False),
        scale_noise_strength=cfg.get("scale_noise_strength", False),
    )


def make_optimizer(cfg: Dict[str, Any]):
    return resolve_target(cfg["target"])(**cfg.get("params", {}))


def make_scheduler(cfg: Dict[str, Any]):
    return resolve_target(cfg["target"])(**cfg.get("params", {}))


def _prefetch_to_device(iterator, device: torch.device, size: int = 2
                        ) -> Iterator[Tuple[Dict[str, torch.Tensor],
                                            np.ndarray]]:
    """(batch on `device`, data_source_idx on the host), with `size`
    batches in flight: each numpy field becomes a pinned host tensor
    copied with non_blocking=True, so the copy overlaps the step before
    it. Other fields stay behind."""
    buf: collections.deque = collections.deque()
    pin = device.type == "cuda"

    def put(item):
        dev = {}
        for k, v in item.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(v)
                dev[k] = (t.pin_memory() if pin else t).to(device,
                                                           non_blocking=True)
        return dev, np.asarray(item["data_source_idx"]).reshape(-1)

    for item in iterator:
        buf.append(put(item))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def _log(msg: str) -> None:
    if mesh.rank0():
        print(msg, flush=True)


class _Writer:
    """TensorBoard writer (tensorboardX); every method is a no-op when
    tensorboardX is absent or the writer is not `enabled`."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.w = None
        if not enabled:
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self.w = SummaryWriter(log_dir)

    @property
    def enabled(self) -> bool:
        return self.w is not None

    def add_scalar(self, tag, value, step):
        if self.w is not None:
            self.w.add_scalar(tag, value, step)

    def add_video_grid(self, tag, frames_uint8, step):
        if self.w is not None:
            self.w.add_video(tag, frames_uint8, step, fps=8)

    def close(self):
        if self.w is not None:
            self.w.close()


@torch.no_grad()
def _validate(iface: ModelInterface, val_loader: DataLoader,
              max_batches: Optional[int], writer: _Writer,
              global_epoch: int) -> float:
    """Mean val loss, each val batch from a fresh state, the flow term
    removed (JAX train.py:374-423); per-source scalars and a preview of
    the first batch to the writer. For the flow task a source other than
    'gt' fills the flow target from the frames, replacing a stored one
    (reference train_flow_utils.py:305-326). Every process validates on
    the whole set; their mean makes the schedulers agree."""
    eval_step = make_eval_step(iface)
    flow_task = isinstance(iface, FlowModelInterface)
    val_losses = []
    for vidx, vbatch in enumerate(val_loader):
        if max_batches is not None and vidx >= max_batches:
            break
        vb = {k: torch.as_tensor(v, device=iface.device)
              for k, v in vbatch.items() if isinstance(v, np.ndarray)}
        b, _, h, w, _ = vb["events"].shape
        pred, _ = eval_step(vb["events"], iface.init_state(b, h, w))
        if flow_task and iface.loss_cfg.optical_flow_source != "gt":
            vb["flow"] = iface.prepare_flow({"frame": vb["frame"]})["flow"]
        vloss, vaux = iface.calc_loss(pred, vb, remove_flow_loss=True)
        val_losses.append(float(vloss))
        # per-source val tags (scripts/select_best_checkpoint.py averages
        # val/perceptual_loss/{source})
        vlogs = aggregate_per_source(
            vaux, np.asarray(vbatch["data_source_idx"]).reshape(-1))
        for k, v in vlogs.items():
            writer.add_scalar(f"val/{k}", v, global_epoch)
        if vidx == 0 and writer.enabled:
            if flow_task:
                grid = make_flow_preview(dict(
                    vbatch, flow=vb["flow"].cpu().numpy()),
                    pred.cpu().numpy())
            else:
                grid = make_preview(vbatch, pred.cpu().numpy())
            writer.add_video_grid("val/preview", grid, global_epoch)
    total = float(np.mean(val_losses)) if val_losses else 0.0
    return float(mesh.all_reduce_mean(torch.tensor(
        total, dtype=torch.float64, device=iface.device)))


def main(configs: Dict[str, Any], max_batches_per_epoch: Optional[int] = None,
         root: str = ".", device=None, train_dataset=None,
         val_dataset=None, on_epoch_end: Optional[Callable[[int], None]]
         = None) -> Dict[str, Any]:
    """Run all training stages; returns the model, the last optimizer, the
    next epoch and what the run measured (for tests and chip_smoke.py).

    `max_batches_per_epoch` caps the train and val batches an epoch.
    The config key `trace: true` turns the span tracer on for the run
    (utils/timers.py): every 50 steps the snapshot of the steps since the
    last one goes to TensorBoard (`_check_and_log`).
    `device=None` means the card (raises without one): under torchrun
    cuda:LOCAL_RANK, in a process group on NCCL; `device="cpu"` takes
    gloo. `train_dataset` / `val_dataset` replace the datasets the
    config's stages build.
    Returns {"model", "optimizer", "epoch", "losses": {global epoch:
    per-step losses}, "timings": {"loader_wait_ms", "step_ms" (host wall
    from one step's fetch to the next's, the last to the epoch's loss
    read), "checkpoint_s", "checkpoint_bytes"}}.
    """
    cpu = device is not None and torch.device(device).type == "cpu"
    created = mesh.init_from_env(cpu)
    try:
        return _main(configs, max_batches_per_epoch, root, device,
                     train_dataset, val_dataset, on_epoch_end)
    finally:
        if created:
            mesh.destroy()


def _main(configs: Dict[str, Any], max_batches_per_epoch: Optional[int] = None,
          root: str = ".", device=None, train_dataset=None,
          val_dataset=None, on_epoch_end=None) -> Dict[str, Any]:
    device = resolve_device(device)
    experiment_name = configs["experiment_name"]
    task = configs.get("task", "e2vid")
    if task not in ("e2vid", "flow"):
        raise ValueError(f"task {task!r}")
    seed = configs.get("seed", 0)
    iface_cls = FlowModelInterface if task == "flow" else ModelInterface
    iface = iface_cls(configs["module"], device,
                      generator=torch.Generator(
                          device=device).manual_seed(seed))
    model = iface.model
    log_dir = os.path.join(root, "tensorboard_logs", experiment_name)
    os.makedirs(log_dir, exist_ok=True)
    val_loss_txt = os.path.join(log_dir, "val_loss.txt")
    ckpt_dir = os.path.join(root, "checkpoints", experiment_name)
    os.makedirs(ckpt_dir, exist_ok=True)

    epochs_of_stages = [s["max_epochs"] for s in configs["train_stages"]]

    # the stage of a cumulative epoch (reference train.py:216-222)
    def stage_of_epoch(epoch):
        total = 0
        for i, e in enumerate(epochs_of_stages):
            if epoch < total + e:
                return i
            total += e
        return len(epochs_of_stages) - 1

    cur_epoch, resumed = 0, None
    checkpoint_path = last_ckpt_path(experiment_name, root)
    if checkpoint_path is not None:
        resumed = load_checkpoint(checkpoint_path, model)
        cur_epoch = int(resumed["epoch"]) + 1
        _log(f"Resumed from {checkpoint_path} at epoch {cur_epoch}")

    out: Dict[str, Any] = {
        "losses": {},
        "timings": {"loader_wait_ms": [], "step_ms": [], "checkpoint_s": [],
                    "checkpoint_bytes": []}}
    timings = out["timings"]
    optimizer = None
    writer = _Writer(log_dir, enabled=mesh.rank0())
    if configs.get("trace", False):
        timers.trace_on(device)
    try:
        for stage_idx, stage_cfg in enumerate(configs["train_stages"]):
            if stage_of_epoch(cur_epoch) > stage_idx:
                continue    # this stage finished before the resume
            ds_cfg = stage_cfg["dataset"]
            train_cfgs = ds_cfg["train"]
            train_ds = (train_dataset if train_dataset is not None
                        else make_concat_multi_dataset(train_cfgs))
            val_ds = (val_dataset if val_dataset is not None
                      else make_concat_multi_dataset(ds_cfg.get("val", [])))
            # `worker_type: process` for decode-heavy video; threads by
            # default
            train_loader = DataLoader(
                train_ds, ds_cfg["train_batch_size"], shuffle=True,
                drop_last=True, num_workers=ds_cfg.get("num_workers", 4),
                process_index=mesh.rank(), process_count=mesh.world_size(),
                prefetch=ds_cfg.get("prefetch", 4),
                worker_type=ds_cfg.get("worker_type", "thread"))
            val_loader = DataLoader(
                val_ds, ds_cfg.get("val_batch_size", 1),
                num_workers=2) if len(val_ds) else None

            # the simulator config when the train data is raw video
            first = train_cfgs[0]
            video_mode = first.get("class_name", "").endswith(
                "WebvidDatasetV2") and first.get("output", "video") == "video"
            sim_cfg = sim_config_from_dataset(first) if video_mode else None

            optimizer_spec = make_optimizer(stage_cfg["optimizer"])
            optimizer = optimizer_spec.make(model.parameters())
            scheduler = (make_scheduler(stage_cfg["lr_scheduler"])
                         if "lr_scheduler" in stage_cfg else None)
            if hasattr(scheduler, "base_lr"):
                # CosineAnnealingLR's eta_min is an absolute lr
                scheduler.base_lr = optimizer_spec.base_lr
            if resumed is not None:
                # the optimizer and scheduler state go into the stage the
                # run resumes in (reference train.py:240-242)
                if load_optimizer_state(optimizer, resumed["optimizer"]):
                    _log("Restored the optimizer state")
                if scheduler is not None and resumed["lr_scheduler"]:
                    scheduler.load_state_dict(resumed["lr_scheduler"])
                resumed = None
            train_step = make_train_step(
                iface, optimizer, sim_cfg, first.get("num_bins", 5),
                first.get("frames_per_bin", 1),
                extra_frame=first.get("output_additional_frame", False),
                extra_evs=first.get("output_additional_evs", False))

            epochs_before = sum(epochs_of_stages[:stage_idx])
            rel_epoch = cur_epoch - epochs_before
            for epoch in range(rel_epoch, stage_cfg["max_epochs"]):
                global_epoch = epochs_before + epoch
                _train_epoch(
                    configs, iface, train_step, optimizer, train_loader,
                    writer, log_dir, max_batches_per_epoch, stage_idx, epoch,
                    global_epoch, optimizer_spec.base_lr
                    * (scheduler(epoch) if scheduler else 1.0),
                    profile=epoch == rel_epoch, out=out)

                if (global_epoch % configs.get("check_val_every_n_epoch", 1)
                        == 0 or epoch == stage_cfg["max_epochs"] - 1):
                    total_val = 0.0 if val_loader is None else _validate(
                        iface, val_loader, max_batches_per_epoch, writer,
                        global_epoch)
                    writer.add_scalar("val/loss", total_val, global_epoch)
                    if scheduler is not None:
                        scheduler.observe(total_val)
                    if mesh.rank0():
                        ckpt_path = os.path.join(
                            ckpt_dir, f"epoch_{global_epoch:04d}.pth")
                        t0 = time.perf_counter()
                        with timers.span("v2v.checkpoint"):
                            save_checkpoint(ckpt_path, model, optimizer,
                                            global_epoch, scheduler)
                        timings["checkpoint_s"].append(
                            time.perf_counter() - t0)
                        timings["checkpoint_bytes"].append(
                            os.path.getsize(ckpt_path))
                        append_ckpt_path(experiment_name, ckpt_path, root)
                        stamp = datetime.datetime.now().strftime(
                            "%Y-%m-%d %H:%M:%S")
                        with open(val_loss_txt, "a") as f:
                            f.write(f"{stamp} Epoch {global_epoch}: "
                                    f"{total_val}\n")
                    mesh.barrier()
                if on_epoch_end is not None:
                    on_epoch_end(global_epoch)
            cur_epoch = sum(epochs_of_stages[:stage_idx + 1])
    finally:
        timers.trace_off()
        writer.close()
    out.update(model=model, optimizer=optimizer, epoch=cur_epoch)
    return out


def _train_epoch(configs, iface, train_step, optimizer, train_loader,
                 writer, log_dir, max_batches, stage_idx, epoch,
                 global_epoch, lr, profile, out) -> None:
    """One epoch of train steps at learning rate `lr`; its per-step
    losses go to out["losses"][global_epoch], its host times to
    out["timings"]."""
    device = iface.device
    seed = configs.get("seed", 0)
    train_loader.set_epoch(global_epoch)
    for group in optimizer.param_groups:
        group["lr"] = lr
    writer.add_scalar("train/lr", lr, global_epoch)
    _log(f"Stage {stage_idx}, epoch {global_epoch}: lr={lr:.3e}")
    # HyperE2VID's GT-mixing curriculum: beta decays over hyper_epochs of
    # the stage's own epochs (train_utils.py:307,329)
    hyper_beta = 0.0
    if iface.hyper_epochs > 0:
        hyper_beta = max(0.0, 1.0 - epoch / iface.hyper_epochs)
    # `profile_steps: [start, end)` traces those steps of the first epoch
    # this run visits into the log dir (rank 0's)
    prof_steps = (configs.get("profile_steps") if profile and mesh.rank0()
                  else None)
    profiler = None

    t0 = time.perf_counter()
    loader_iter = iter(train_loader)
    batches = _prefetch_to_device(loader_iter, device)
    losses, starts = [], []
    try:
        for batch_idx in range(len(train_loader)):
            if max_batches is not None and batch_idx >= max_batches:
                break
            starts.append(time.perf_counter())
            with timers.span("v2v.loader_wait"):
                batch, src_idx = next(batches)
            out["timings"]["loader_wait_ms"].append(
                (time.perf_counter() - starts[-1]) * 1e3)
            if prof_steps and batch_idx == prof_steps[0]:
                profiler = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]
                    + ([torch.profiler.ProfilerActivity.CUDA]
                       if device.type == "cuda" else []))
                profiler.start()
            generator = torch.Generator(device=device).manual_seed(
                step_seed(seed, global_epoch * 100003 + batch_idx,
                          mesh.rank()))
            loss, aux = train_step(batch, generator, hyper_beta)
            losses.append(loss)
            if profiler is not None and batch_idx == prof_steps[1] - 1:
                _stop_profiler(profiler, device, log_dir, global_epoch,
                               prof_steps)
                profiler = None
            if batch_idx % 50 == 0:
                _check_and_log(configs, loss, aux, src_idx, writer,
                               global_epoch, batch_idx, len(train_loader), t0)
    finally:
        if profiler is not None:
            _stop_profiler(profiler, device, log_dir, global_epoch,
                           prof_steps)
        batches.close()
        loader_iter.close()
    values = torch.stack(losses).tolist() if losses else []
    starts.append(time.perf_counter())
    out["timings"]["step_ms"] += [(b - a) * 1e3
                                  for a, b in zip(starts, starts[1:])]
    out["losses"][global_epoch] = values
    _log(f"Stage {stage_idx}, epoch {global_epoch}: {len(values)} steps in "
         f"{time.perf_counter() - t0:.1f}s, loss="
         f"{values[-1] if values else float('nan'):.4f}")


def _check_and_log(configs, loss, aux, src_idx, writer, global_epoch,
                   batch_idx, n_batches, t0) -> None:
    """The finite guard (the reference's per-module NaN hooks,
    model/train_utils.py:90-113,178-179) and the per-source scalars, over
    every process's rows (each process calls it at the same steps)."""
    value = float(loss)
    if configs.get("check_finite", True) and not math.isfinite(value):
        raise FloatingPointError(
            f"non-finite loss at epoch {global_epoch} batch {batch_idx}: "
            f"{value} (pred range [{float(aux['pred_min_val'])}, "
            f"{float(aux['pred_max_val'])}], grad norm "
            f"{float(aux['grad_norm'])}); rerun with "
            f"torch.autograd.set_detect_anomaly(True) to localize")
    if mesh.world_size() > 1:
        aux = {k: mesh.all_gather(v) if v.ndim == 1 else v
               for k, v in aux.items()}
        src_idx = mesh.all_gather(torch.as_tensor(
            src_idx, device=loss.device)).cpu().numpy()
    logs = aggregate_per_source(aux, src_idx)
    step = global_epoch * max(n_batches, 1) + batch_idx
    for k, v in logs.items():
        writer.add_scalar(f"train/{k}", v, step)
    snap = timers.snapshot()
    if snap is not None:
        # perf/<span>_stream_ms, the step's, the smallest lead, the loader's
        # host wait, the allocator's cudaMallocs and the tracer's own us, a
        # step over the steps since the last snapshot
        perf = {f"{k.removeprefix('v2v.')}_stream_ms": v["stream_ms"]
                for k, v in snap["spans"].items()}
        perf.update({k: snap[k] for k in ("step_stream_ms", "launch_lead_ms",
                                          "device_allocs", "tracer_us")})
        perf["loader_wait_ms"] = snap["spans"].get(
            "v2v.loader_wait", {}).get("host_ms")
        for k, v in perf.items():
            if v is not None:
                writer.add_scalar(f"perf/{k}", v, step)
    if batch_idx > 0:
        rate = batch_idx / max(time.perf_counter() - t0, 1e-9)
        _log(f"  epoch {global_epoch} step {batch_idx}/{n_batches} "
             f"loss={logs.get('loss', value):.4f} ({rate:.2f} steps/s)")


def _stop_profiler(profiler, device, log_dir, global_epoch,
                   prof_steps) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    profiler.export_chrome_trace(os.path.join(
        log_dir, f"trace_epoch{global_epoch:04d}_steps{prof_steps[0]}-"
        f"{prof_steps[1]}.json"))
