"""Train-step time: ms/step of a train config at full size (the port of
the repo-root scripts/bench_full_step.py).

    python -m v2v_tpu_torch.scripts.bench_full_step [--config flagship|
        hyper|etnet|evflow|eraft|CONFIG.yaml] [--steps 3] [--repeats 5]
        [--flops] [--device DEV]

`--config` names a built-in config, `flagship` (the default:
configs/train_v2v_e2vid_10k.yaml, E2VID, B=12, T=40, 128x128, bf16,
LPIPS-VGG + L1 + temporal consistency with the RAFT-small teacher, Adam
amsgrad), `hyper` (configs/train_v2v_hyper_10k.yaml, HyperE2VID at
hyper_beta 1.0, epoch 0 of its curriculum), `etnet`, `evflow` or `eraft`
(configs/train_v2v_etnet_10k.yaml, _evflow_10k.yaml, _eraft_10k.yaml),
each a copy of its YAML's `module` and first stage (tests hold them
equal), or any train YAML (needs PyYAML). The step is
training/steps.py::make_train_step's, from uint8 video on the card
through K1, with a random LPIPS trunk and a random teacher (the compute
of the pretrained ones); video from np.random.RandomState(0).

One warm step, then `--repeats` repeats of `--steps` steps in this
process, each step timed on the host clock up to a synchronize. A
repeat's ms/step is the mean of its steps; the line gives the median
over the repeats and their spread. `--flops` counts the warm step's
matmul and convolution FLOPs (utils/flops.py) and states the rate
achieved against the card's dense bf16 peak (989 TFLOP/s, NVIDIA's data
sheet for the H100 SXM), with the card's name and power limit. Prints
one JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .. import resolve_device
from .bench import describe_device
from .exp_sim_interleave import make_video

BF16_PEAK_FLOPS = 989e12
_E2VID_UNET = {"num_bins": 5, "skip_type": "sum",
               "recurrent_block_type": "convlstm", "num_encoders": 3,
               "base_num_channels": 32, "num_residual_blocks": 2,
               "use_upsample_conv": True}
_TRAIN_SET = {
    "data_file": "configs/webvid_root.txt",
    "class_name": "data.v2v_datasets.WebvidDatasetV2",
    "video_list_file": "configs/webvid10000_unfiltered.txt",
    "data_source_name": "webvid", "video_reader": "opencv",
    "sequence_length": 40, "pause_granularity": 5,
    "proba_pause_when_running": 0.0102, "proba_pause_when_paused": 0.9791,
    "crop_size": 128, "random_flip": True, "num_bins": 5,
    "min_resize_scale": 1, "max_resize_scale": 1, "frames_per_bin": 1,
    "threshold_range": [0.05, 2], "max_thres_pos_neg_gap": 1.5,
    "base_noise_std_range": [0, 0.1], "hot_pixel_std_range": [0, 10],
    "max_samples_per_shot": 10}
_LOSS = {"lpips_weight": 1.0, "lpips_type": "vgg", "l2_weight": 0,
         "l1_weight": 1.0, "ssim_weight": 0,
         "temporal_consistency_weight": 1.0,
         "optical_flow_source": "raft_small", "temporal_consistency_L0": 20}


_FLOW_LOSS = {"l1_weight": 1.0, "optical_flow_source": "raft_large",
              "raft_num_flow_updates": 12}


def _stage(lr: float, batch: int = 12, optimizer: str = "torch.optim.Adam",
           opt_params=None, scheduler=None, **train) -> Dict[str, Any]:
    return {"optimizer": {"target": optimizer, "params": opt_params or {
                "lr": lr, "weight_decay": 0, "amsgrad": True}},
            "lr_scheduler": scheduler or {
                "target": "torch.optim.lr_scheduler.StepLR",
                "params": {"step_size": 50, "gamma": 1.0}},
            "dataset": {"train_batch_size": batch,
                        "train": [dict(_TRAIN_SET, **train)]}}


# the `module` and first train stage (its optimizer, scheduler, batch and
# train set) of configs/train_v2v_e2vid_10k.yaml, _hyper_10k.yaml,
# _etnet_10k.yaml, _evflow_10k.yaml and _eraft_10k.yaml
CONFIGS: Dict[str, Tuple[Dict[str, Any], Dict[str, Any]]] = {
    "flagship": ({
        "loss": _LOSS, "normalize_voxels": False,
        "model": {"target": "model.model.E2VIDRecurrent",
                  "params": {"unet_kwargs": dict(
                      _E2VID_UNET, final_activation="", norm="none")}},
        "compute_dtype": "bfloat16"}, _stage(1e-4)),
    "hyper": ({
        "loss": _LOSS, "normalize_voxels": False,
        "model": {"target": "model.hyper_model.HyperE2VID",
                  "params": {"unet_kwargs": dict(
                      _E2VID_UNET, norm="none", kernel_size=5,
                      channel_multiplier=2, num_output_channels=1,
                      use_dynamic_decoder=True)}},
        "compute_dtype": "bfloat16", "hyper_epochs": 16}, _stage(1e-3)),
    "etnet": ({
        "loss": _LOSS, "normalize_voxels": False,
        "model": {"target": "model.eitr.eitr.EITR",
                  "params": {"eitr_kwargs": {"num_bins": 5,
                                             "norm": "none"}}},
        "compute_dtype": "bfloat16"}, _stage(
            2e-4, 6, "torch.optim.AdamW",
            {"lr": 0.0002, "weight_decay": 0.01, "amsgrad": True},
            {"target": "torch.optim.lr_scheduler.ExponentialLR",
             "params": {"gamma": 0.94}},
            video_list_file="configs/webvid10000_filtered.txt")),
    "evflow": ({
        "loss": _FLOW_LOSS, "normalize_voxels": False,
        "model": {"target": "model.model.EVFlowNet", "params": {
            "unet_kwargs": {"num_bins": 5, "base_num_channels": 32,
                            "num_encoders": 4, "num_residual_blocks": 2,
                            "num_output_channels": 2, "skip_type": "concat",
                            "norm": None, "use_upsample_conv": True,
                            "kernel_size": 3, "channel_multiplier": 2}}},
        "compute_dtype": "bfloat16"}, _stage(
            1e-4, 10, video_list_file="configs/webvid10000_full.txt",
            output_additional_frame=True)),
    "eraft": ({
        "loss": _FLOW_LOSS, "normalize_voxels": False,
        "model": {"target": "model.eraft.eraft.ERAFT",
                  "params": {"config": {"subtype": "warm_start"},
                             "n_first_channels": 5}},
        "compute_dtype": "bfloat16", "forward_type": "eraft"}, _stage(
            1e-4, 10, output_additional_frame=True,
            output_additional_evs=True)),
}
# the YAMLs' `task`, where it is not "e2vid"
TASKS = {"evflow": "flow", "eraft": "flow"}


def load_config(name: str) -> Tuple[str, Dict[str, Any], Dict[str, Any],
                                     str]:
    """(name, module, first stage, task) of a built-in or a YAML."""
    if name in CONFIGS:
        module, stage = CONFIGS[name]
        return name, module, stage, TASKS.get(name, "e2vid")
    from ..config import load_yaml
    full = load_yaml(name)
    return (name, full["module"], full["train_stages"][0],
            full.get("task", "e2vid"))


class Built(NamedTuple):
    """A built train step: `step(batch, generator, **kwargs)` on its
    interface `iface`; `shape` (B, T, H, W); `synthesize()` the step's
    simulator stage (K1, the bin sums, the GT frames) on the batch."""
    name: str
    step: Callable
    batch: Dict[str, torch.Tensor]
    generator: torch.Generator
    kwargs: Dict[str, Any]
    shape: Tuple[int, int, int, int]
    iface: Any
    synthesize: Callable


def build(config: str, dev: torch.device, flow: Optional[str] = None,
          batch: Optional[int] = None, sequence_length: Optional[int] = None,
          crop: Optional[int] = None) -> "Built":
    """The config's train step and what it runs on (`Built`).
    `flow` replaces the loss's optical_flow_source (`zeros` takes the
    teacher out of the step); `batch`, `sequence_length` and `crop` cut
    the train set's B, T and crop size."""
    from ..losses.lpips import LPIPS
    from ..training.flow_interface import FlowModelInterface
    from ..training.interface import LossConfig, ModelInterface
    from ..training.raft import random_teacher
    from ..training.steps import make_train_step, synthesize_batch
    from ..training.train import (make_optimizer, make_scheduler,
                                  sim_config_from_dataset)
    name, module, stage, task = load_config(config)
    if flow is not None:
        module = dict(module, loss=dict(module.get("loss", {}),
                                        optical_flow_source=flow))
    ds = stage["dataset"]
    train = ds["train"][0]
    b = batch or ds["train_batch_size"]
    t, bins = sequence_length or train["sequence_length"], train["num_bins"]
    fpb, hw = train.get("frames_per_bin", 1), crop or train["crop_size"]
    extra_frame = train.get("output_additional_frame", False)
    extra_evs = train.get("output_additional_evs", False)
    g = torch.Generator(device=dev).manual_seed(0)
    loss = module.get("loss", {})
    lp = (LPIPS(loss.get("lpips_type", "vgg"), dev, generator=g)
          if loss.get("lpips_weight") else None)
    loss_cfg = LossConfig.from_dict(loss)
    teacher = (random_teacher(loss_cfg.raft_num_flow_updates, dev,
                              generator=g,
                              source=loss_cfg.optical_flow_source)
               if loss_cfg.optical_flow_source.startswith("raft") else None)
    cls = FlowModelInterface if task == "flow" else ModelInterface
    iface = cls(module, dev, generator=g, lpips=lp, teacher=teacher)
    opt_cfg = make_optimizer(stage["optimizer"])
    sched = make_scheduler(stage["lr_scheduler"])
    opt = opt_cfg.make(iface.model.parameters())
    for group in opt.param_groups:
        group["lr"] = opt_cfg.base_lr * sched(0)
    sim_cfg = sim_config_from_dataset(train)
    step = make_train_step(iface, opt, sim_cfg, num_bins=bins,
                           frames_per_bin=fpb, extra_frame=extra_frame,
                           extra_evs=extra_evs)
    # WebvidDataset's clip: the extra frame is the first of the clip's
    # own frames, the extra event group adds a group's frames
    n = (t + (1 if extra_evs else 0)) * bins * fpb + 1
    video = torch.as_tensor(make_video((b, n, hw, hw)), device=dev)
    batch = {"video": video,
             "data_source_idx": torch.full((b,), 11, dtype=torch.int64)}
    kw = {"hyper_beta": 1.0} if iface.hyper_epochs else {}

    def synthesize():
        return synthesize_batch(video, g, sim_cfg, bins, fpb,
                                extra_frame=extra_frame, extra_evs=extra_evs)

    return Built(name, step, batch, g, kw, (b, t, hw, hw), iface, synthesize)


def time_steps(step, batch, g, kw, dev: torch.device, steps: int,
               repeats: int) -> dict:
    """`repeats` repeats of `steps` steps, each timed on the host clock up
    to a synchronize: the median of the repeats' means, their spread, the
    times and the last loss."""
    step_ms, loss = [], None
    for _ in range(repeats):
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            loss, _ = step(batch, g, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms.append(times)
    per_repeat = [statistics.mean(x) for x in step_ms]
    return {"ms_per_step": statistics.median(per_repeat),
            "spread": [min(per_repeat), max(per_repeat)],
            "repeats": repeats, "steps": steps, "step_ms": step_ms,
            "last_loss": float(loss)}


def run(config: str = "flagship", device=None, steps: int = 3,
        repeats: int = 5, flops: bool = False) -> dict:
    dev = resolve_device(device)
    name, step, batch, g, kw, (b, t, h, w), _, _ = build(config, dev)
    result = {"config": name, "batch": b, "T": t, "hw": [h, w]}
    if flops:
        from ..utils.flops import step_flops
        n_flops, _ = step_flops(step, batch, g, **kw)       # the warm step
        result["flop_per_step"] = n_flops
    else:
        time_steps(step, batch, g, kw, dev, 1, 1)          # the warm step
    result.update(time_steps(step, batch, g, kw, dev, steps, repeats),
                  device=str(dev), card=describe_device(dev))
    ms = result["ms_per_step"]
    if flops:
        rate = result["flop_per_step"] / (ms / 1e3)
        result["flop_per_s"] = rate
        # a share of a device peak only from a device's time
        result["bf16_peak_share"] = (rate / BF16_PEAK_FLOPS
                                     if dev.type == "cuda" else None)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m v2v_tpu_torch.scripts.bench_full_step",
        description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="flagship",
                    help=f"one of {sorted(CONFIGS)} or a train YAML")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--steps", type=int, default=3,
                    help="timed steps a repeat")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--flops", action="store_true",
                    help="count the step's FLOPs and the rate achieved")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.config, args.device, args.steps, args.repeats,
                         args.flops)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
