#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (v2v_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--steps 3] [--profile]

Phases, one line each, any failure exits non-zero:
  1. device: nvidia-smi name and power limit, torch/CUDA versions, TF32
  2. build: nvcc builds the CUDA kernels from v2v_tpu_torch/csrc, one
     process per source, all at once
  3. K2 (sample_gaussian) against its plain version: equal bits
  4. K1 (simulate_batch) against its plain version at the flagship shape
     (12, 201, 128, 128): uint8 and float32 video, noise-free and noisy,
     and a 180x240 crop; then both timed with CUDA events
  5. K3 (attention) against its plain version at ETNet's 720p shape
     (1, 8, 14400, 32) and at a ragged 5001 tokens (TF32 off); kernel,
     plain version and scaled_dot_product_attention timed
  6. reference check: a small train step on the card equals the same
     step on the CPU (float32, TF32 off)
  7. the train slice: the flagship config (configs/train_v2v_e2vid_10k.
     yaml) at full width with a random LPIPS trunk and a random
     RAFT-small teacher, `--steps` train steps from uint8 video; K1's
     launch count must equal the step count
  8. eval reference: full-width ETNet on two 64x64 sequences of 3 frames
     with chunk_threshold forced to 16, card (K3) against CPU (plain)
  9. the eval slice: configs/test_etnet_original.yaml's ETNet through
     the port's run_test on two synthetic 720x1280 sequences of 8
     frames (EVAID's size; sequence_length cut from 80 to 8), random
     ETNet and LPIPS-Alex trunks; K3's launch count must be 21 a frame
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
v2v_tpu_torch package beside it, the script exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# The flagship config's `module` and `train_stages[0]` sections
# (configs/train_v2v_e2vid_10k.yaml; the card's machine has no PyYAML).
# tests/test_torch_train_step.py holds them equal to the YAML.
FLAGSHIP_MODULE = {
    "loss": {"lpips_weight": 1.0, "lpips_type": "vgg", "l2_weight": 0,
             "l1_weight": 1.0, "ssim_weight": 0,
             "temporal_consistency_weight": 1.0,
             "optical_flow_source": "raft_small",
             "temporal_consistency_L0": 20},
    "normalize_voxels": False,
    "model": {"target": "model.model.E2VIDRecurrent",
              "params": {"unet_kwargs": {
                  "num_bins": 5, "skip_type": "sum",
                  "recurrent_block_type": "convlstm", "num_encoders": 3,
                  "base_num_channels": 32, "num_residual_blocks": 2,
                  "use_upsample_conv": True, "final_activation": "",
                  "norm": "none"}}},
    "compute_dtype": "bfloat16",
}
_TEST_SET = {"class_name": "data.testh5.TestH5Dataset", "num_bins": 5,
             "sequence_length": 80, "interpolate_bins": False,
             "image_range": 1}
FLAGSHIP_STAGE = {
    "stage_name": "stage1",
    "max_epochs": 80,
    "optimizer": {"target": "torch.optim.Adam",
                  "params": {"lr": 0.0001, "weight_decay": 0,
                             "amsgrad": True}},
    "lr_scheduler": {"target": "torch.optim.lr_scheduler.StepLR",
                     "params": {"step_size": 50, "gamma": 1.0}},
    "dataset": {
        "train_batch_size": 12,
        "num_workers": 9,
        "val_batch_size": 1,
        "persistent_workers": True,
        "pin_memory": True,
        "train": [{
            "data_file": "configs/webvid_root.txt",
            "class_name": "data.v2v_datasets.WebvidDatasetV2",
            "video_list_file": "configs/webvid10000_unfiltered.txt",
            "data_source_name": "webvid",
            "video_reader": "opencv",
            "sequence_length": 40,
            "pause_granularity": 5,
            "proba_pause_when_running": 0.0102,
            "proba_pause_when_paused": 0.9791,
            "crop_size": 128,
            "random_flip": True,
            "num_bins": 5,
            "min_resize_scale": 1,
            "max_resize_scale": 1,
            "frames_per_bin": 1,
            "threshold_range": [0.05, 2],
            "max_thres_pos_neg_gap": 1.5,
            "base_noise_std_range": [0, 0.1],
            "hot_pixel_std_range": [0, 10],
            "max_samples_per_shot": 10,
        }],
        "val": [
            dict(_TEST_SET, data_file="configs/evaid_test.txt",
                 dataset_name="evaid", max_samples=1),
            dict(_TEST_SET, data_file="configs/ijrr_test.txt",
                 dataset_name="ijrr"),
            dict(_TEST_SET, data_file="configs/hqf_test.txt",
                 dataset_name="hqf"),
            dict(_TEST_SET, data_file="configs/mvsec_test.txt",
                 dataset_name="mvsec"),
        ],
    },
}

# configs/test_etnet_original.yaml (the card's machine has no PyYAML);
# tests/test_torch_eval.py holds it equal to the YAML.
_ETNET_SET = {"class_name": "data.testh5.TestH5Dataset", "num_bins": 5,
              "sequence_length": 80, "interpolate_bins": True}
ETNET_CONFIG = {
    "experiment_name": "etnet_original",
    "test_output_dir": "results/etnet_original",
    "module": {
        "loss": {"lpips_weight": 1.0, "lpips_type": "alex", "l2_weight": 0,
                 "l1_weight": 0, "ssim_weight": 0,
                 "temporal_consistency_weight": 1.0},
        "normalize_voxels": False,
        "model": {"target": "model.eitr.eitr.EITR",
                  "params": {"eitr_kwargs": {"num_bins": 5,
                                             "norm": "none"}}}},
    "test_stage": {
        "test_batch_size": 1,
        "test_num_workers": 4,
        "test": [dict(data_file=f"configs/{name}_test.txt", **_ETNET_SET,
                      dataset_name=name)
                 for name in ("evaid", "ijrr", "hqf", "mvsec")]},
}
# EVAID's frame size; frames per sequence in the eval slice (the config's
# sequence_length of 80, cut to stay inside the run's time limit);
# events per frame, of EVAID's order (1e5-1e6)
EVAL_HW = (720, 1280)
EVAL_FRAMES = 8
EVAL_EVENTS_PER_FRAME = 400_000
# K3 launches per ETNet frame: 3 streams x (3 encoder self-attentions +
# 2 decoder layers x (self + cross))
K3_PER_FRAME = 21
# K3's shapes: ETNet at 720p (B, heads, 90*160 tokens, dh), and a token
# count that is not a multiple of the kernel's tiles
K3_SHAPES = ((1, 8, 14400, 32), (1, 8, 5001, 32))
# |K3 - plain| on unit-normal q, k, v: float32 sums over 14,400 keys in
# another order, and the scale folded into the exponent
K3_ATOL = 1e-5
# card (cuDNN, K3) against CPU (oneDNN, plain attention) on the full-width
# ETNet in float32 with TF32 off, over 3 recurrent steps
EVAL_REF_ATOL = 1e-4

# K1's flagship shape (B, N, H, W) and the off-multiple crop it is also
# held at; the flagship E2VID's parameter count
K1_SHAPE = (12, 201, 128, 128)
CROP_HW = (180, 240)
FLAGSHIP_PARAMS = 10_710_401

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# dense TF32 tensor-core FLOP/s (a yardstick for K3; the kernel runs on
# the float32 CUDA cores)
TF32_FLOPS = 495e12
# float32 operations per simulated pixel and frame, counted from
# csrc/esim.cu: log diff and add (2), quantization (2 divisions, 2
# multiplies, 2 adds), noise (Irwin-Hall 2, scale 1, two adds 2); the
# Philox integer work has no entry in the data sheet's rate table
K1_FLOPS_NOISY = 13
# Flip budget of two float32 log implementations (docs/PERF.md, "Round 4:
# device-log flip budget"): |delta| <= 1 at a rate <= 5e-4.
FLIP_RATE = 5e-4


def _log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of `fn()` over `reps` runs, CUDA events."""
    import torch
    for _ in range(warmup):
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


def _drifting_video(b, n, h, w, seed, device):
    """uint8 (B, N, H, W): a random texture per clip, drifting by a random
    sub-pixel velocity per frame, with slow global brightness changes."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    tex = torch.rand((b, 1, 2 * h, 2 * w), generator=g, device=device)
    tex = torch.nn.functional.avg_pool2d(tex, 3, 1, 1)
    tex = ((tex - 0.5) * 3.0 + 0.5).clamp(0.0, 1.0) * 255.0
    vel = (torch.rand((b, 2), generator=g, device=device) - 0.5) * 2.0
    t = torch.arange(n, device=device, dtype=torch.float32)
    ys = torch.arange(h, device=device, dtype=torch.float32)
    xs = torch.arange(w, device=device, dtype=torch.float32)
    frames = []
    for i in range(b):
        oy = (t * vel[i, 0]).view(n, 1, 1) + ys.view(1, h, 1) + h / 2
        ox = (t * vel[i, 1]).view(n, 1, 1) + xs.view(1, 1, w) + w / 2
        grid = torch.stack([ox.expand(n, h, w) / (w - 0.5) - 1.0,
                            oy.expand(n, h, w) / (h - 0.5) - 1.0], dim=-1)
        f = torch.nn.functional.grid_sample(
            tex[i:i + 1].expand(n, -1, -1, -1).contiguous(), grid,
            align_corners=False,
            padding_mode="reflection")[:, 0]
        gain = 1.0 + 0.3 * torch.sin(t / 17.0 + i).view(n, 1, 1)
        frames.append((f * gain).clamp(0, 255))
    return torch.stack(frames).round().to(torch.uint8)


def _bound(bytes_: int, flops: int):
    """Least time on the card (ms) and what sets it: each input read and
    each output written once at the HBM rate, or the float32 operations
    at the float32 rate."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _counts_diff(got, want):
    d = (got - want).abs()
    return float(d.max()), float((d > 0).float().mean())


def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    _require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    _log(smi.stdout.strip().splitlines()[0])
    _log(f"[device] {torch.cuda.get_device_name(0)} x"
         f"{torch.cuda.device_count()}  python {sys.version.split()[0]}  "
         f"torch {torch.__version__}  cuda {torch.version.cuda}")
    # the train step runs with TF32 convolutions and matmuls; every
    # float32 comparison below switches both off
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    _log("[device] tf32: cudnn.allow_tf32=True cuda.matmul.allow_tf32=True "
         "(off for the float32 comparisons)")


def _kernels():
    """Every kernel wrapper of the port, by the name the JSON line uses."""
    from v2v_tpu_torch.ops import attention as at
    from v2v_tpu_torch.ops import voxel_cuda as vc
    return {"simulate_batch": vc.simulate_batch,
            "sample_gaussian": vc.sample_gaussian,
            "attention": at.attention}


def _zero_launches() -> None:
    for fn in _kernels().values():
        fn.launches = 0


def _read_launches() -> dict:
    return {name: fn.launches for name, fn in _kernels().items()}


def _tf32(torch, on: bool):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def phase_build():
    """One nvcc per CUDA source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from v2v_tpu_torch.ops import attention, voxel_cuda
    libs = (voxel_cuda.LIB, attention.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:
        infos = list(pool.map(lambda lib: lib.build(verbose=True), libs))
    for lib, info in zip(libs, infos):
        _log(f"[build] {info['path'].name} in {info['seconds']:.1f} s "
             f"(nvcc {' '.join(lib.flags)})")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                _log(f"[build]   {line.strip()}")


def phase_k2(torch, dev, seed):
    from v2v_tpu_torch.ops import voxel_cuda as vc
    shape = (512, 512)
    n = shape[0] * shape[1]
    got = vc.sample_gaussian(seed, shape, device=dev)
    want = vc.sample_gaussian_plain(seed, n, dev).view(shape)
    torch.cuda.synchronize()
    _require(torch.equal(got, want), "K2 differs from its plain version")
    s = got.double().flatten()
    kurt = float(((s - s.mean()) ** 4).mean() / s.var(unbiased=False) ** 2)
    ms = _cuda_ms(lambda: vc.sample_gaussian(seed, shape, device=dev), 20)
    plain_ms = _cuda_ms(lambda: vc.sample_gaussian_plain(seed, n, dev), 5)
    bound_ms, bound_by = _bound(n * 4, 2 * n)
    _log(f"[k2] equal bits, mean {float(s.mean()):+.5f} var "
         f"{float(s.var()):.5f} kurtosis {kurt:.4f} max|x| "
         f"{float(s.abs().max()):.4f}; kernel {ms:.4f} ms, plain "
         f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms")
    return {"name": "sample_gaussian", "route": "cuda",
            "source": "v2v_tpu_torch/csrc/esim.cu",
            "replaces": "v2v_tpu/ops/voxel_pallas.py:71",
            "max_abs_err": float((got - want).abs().max()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def phase_k1(torch, dev, seed):
    from v2v_tpu_torch.ops import voxel_cuda as vc
    from v2v_tpu_torch.ops.voxel import sample_sim_params
    from v2v_tpu_torch.training.train import sim_config_from_dataset
    b, n, h, w = K1_SHAPE
    sim_cfg = sim_config_from_dataset(FLAGSHIP_STAGE["dataset"]["train"][0])
    g = torch.Generator(device=dev).manual_seed(seed)
    video = _drifting_video(b, n, h, w, seed, dev)
    params = sample_sim_params(g, sim_cfg, b)
    seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=g, device=dev,
                          dtype=torch.int32)
    worst = 0.0
    cases = [("uint8 noise-free", video, True), ("uint8 noisy", video, False),
             ("float32 noisy", video.float(), False),
             ("float32 noise-free", video.float(), True)]
    crop = _drifting_video(b, n, *CROP_HW, seed + 1, dev)
    cases.append((f"uint8 noisy {CROP_HW[0]}x{CROP_HW[1]}", crop, False))
    for name, v, nf in cases:
        got = vc.simulate_batch(v, seeds, params, noise_free=nf)
        want = vc.simulate_batch_plain(v, seeds, params, noise_free=nf)
        torch.cuda.synchronize()
        dmax, rate = _counts_diff(got, want)
        events = float(want.abs().mean())
        _log(f"[k1] {name}: shape {tuple(got.shape)} mean|events| "
             f"{events:.4f} max|diff| {dmax} mismatch rate {rate:.2e}")
        _require(bool(torch.isfinite(got).all()), f"K1 {name}: non-finite")
        _require(events > 0, f"K1 {name}: no events")
        _require(dmax <= 1.0 and rate <= FLIP_RATE,
                 f"K1 {name}: beyond the flip budget")
        worst = max(worst, dmax)
    ms = _cuda_ms(lambda: vc.simulate_batch(video, seeds, params), 20)
    plain_ms = _cuda_ms(lambda: vc.simulate_batch_plain(video, seeds, params),
                        3, warmup=1)
    px_frames = b * (n - 1) * h * w
    bytes_ = b * n * h * w + px_frames * 4
    bound_ms, bound_by = _bound(bytes_, K1_FLOPS_NOISY * px_frames)
    _log(f"[k1] flagship uint8 noisy: kernel {ms:.4f} ms (bound "
         f"{bound_ms:.4f} ms, bytes {bytes_ / 1e6:.1f} MB), plain "
         f"{plain_ms:.2f} ms; {b / (ms / 1e3):.0f} clips/s")
    return {"name": "simulate_batch", "route": "cuda",
            "source": "v2v_tpu_torch/csrc/esim.cu",
            "replaces": "v2v_tpu/ops/voxel_pallas.py:172",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_k3(torch, dev, seed):
    """K3 against its plain version on the same tensors, TF32 off (the
    plain version's matmuls would be TF32-accurate otherwise)."""
    from v2v_tpu_torch.ops import attention as at
    _tf32(torch, False)
    g = torch.Generator(device=dev).manual_seed(seed)
    worst = 0.0
    for shape in K3_SHAPES:
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   for _ in range(3))
        got = at.attention(q, k, v)
        want = at.attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        _log(f"[k3] {shape}: max|diff| {err:.3e} (tolerance {K3_ATOL}), "
             f"max|out| {float(want.abs().max()):.4f}")
        _require(bool(torch.isfinite(got).all()), f"K3 {shape}: non-finite")
        _require(err <= K3_ATOL, f"K3 {shape}: beyond the tolerance")
        worst = max(worst, err)
    q, k, v = (torch.randn(K3_SHAPES[0], generator=g, device=dev)
               for _ in range(3))
    ms = _cuda_ms(lambda: at.attention(q, k, v), 20)
    plain_ms = _cuda_ms(lambda: at.attention_plain(q, k, v), 3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _cuda_ms(lambda: sdpa(q, k, v), 20)
    b, h, n, dh = K3_SHAPES[0]
    flops = 4 * b * h * n * n * dh
    bytes_ = 4 * b * h * n * dh * 4
    bound_ms, bound_by = _bound(bytes_, flops)
    _log(f"[k3] {K3_SHAPES[0]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
         f"ms, scaled_dot_product_attention (float32) {library_ms:.4f} ms; "
         f"{flops:.4g} FLOP, {bytes_ / 1e6:.1f} MB; bound at the float32 "
         f"CUDA-core rate {bound_ms:.4f} ms ({bound_by}), at the dense TF32 "
         f"tensor-core rate {flops / TF32_FLOPS * 1e3:.4f} ms; "
         f"{flops / (ms / 1e3) / 1e12:.1f} TFLOP/s achieved")
    _tf32(torch, True)
    return {"name": "attention", "route": "cuda",
            "source": "v2v_tpu_torch/csrc/attention.cu",
            "replaces": "v2v_tpu/models/eitr.py:42",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _tiny_module(l0: int):
    mod = json.loads(json.dumps(FLAGSHIP_MODULE))
    mod["loss"]["temporal_consistency_L0"] = l0
    mod["model"]["params"]["unet_kwargs"].update(base_num_channels=4,
                                                 num_residual_blocks=1)
    mod.pop("compute_dtype")
    return mod


def phase_reference(torch, dev, seed):
    """One float32 train step of the slice (flagship loss, tiny model, 64
    px) on the card against the same step on the CPU, same weights and
    voxels: the CPU path is the one the tier-1 tests hold against JAX."""
    import copy
    from v2v_tpu_torch.losses.lpips import LPIPS
    from v2v_tpu_torch.ops.voxel import SimConfig
    from v2v_tpu_torch.training.interface import ModelInterface
    from v2v_tpu_torch.training.optim import Adam
    from v2v_tpu_torch.training.raft import random_teacher
    from v2v_tpu_torch.training.steps import make_train_step, synthesize_batch
    _tf32(torch, False)
    cpu = torch.device("cpu")
    lr = 1e-4
    mod = _tiny_module(l0=2)
    g = torch.Generator(device=dev).manual_seed(seed)
    video = _drifting_video(2, 4 * 5 + 1, 64, 64, seed, dev)
    events, frame = synthesize_batch(video, g, SimConfig(), 5, 1)
    runs = []
    lp = LPIPS("vgg", cpu)
    teacher = random_teacher(12, cpu)
    for d in (dev, cpu):
        lp_d = copy.copy(lp)
        lp_d.module = copy.deepcopy(lp.module).to(d)
        iface = ModelInterface(mod, d, lpips=lp_d,
                               teacher=copy.deepcopy(teacher).to(d))
        iface.teacher_dtype = None
        if d == dev:
            state = {k: v.to(cpu) for k, v in iface.model.state_dict().items()}
        else:
            iface.model.load_state_dict(state)
        opt = Adam(lr=lr, amsgrad=True).make(iface.model.parameters())
        step = make_train_step(iface, opt)
        loss, aux = step({"events": events.to(d), "frame": frame.to(d)})
        runs.append((float(loss), float(aux["grad_norm"]),
                     {k: v.detach().to(cpu)
                      for k, v in iface.model.state_dict().items()}))
    (lc, gc, pc), (lh, gh, ph) = runs
    perr = max(float((pc[k] - ph[k]).abs().max()) for k in pc)
    _log(f"[reference] loss cuda {lc:.6f} cpu {lh:.6f}  grad_norm cuda "
         f"{gc:.6f} cpu {gh:.6f}  max|param diff| after step {perr:.2e}")
    _require(math.isfinite(lc) and abs(lc - lh) <= 1e-4 * abs(lh),
             "reference: loss differs between card and CPU")
    _require(abs(gc - gh) <= 1e-3 * abs(gh), "reference: grad norm differs")
    # Adam's first step moves each weight by lr*g/(|g|+eps), under lr in
    # size: a gradient near zero may flip sign between the devices
    _require(perr <= 2 * lr * (1 + 1e-3),
             "reference: params after the step differ")
    _tf32(torch, True)


def _profile(torch, tag, fn):
    """fn() once more under torch.profiler: the GPU span of each v2v.*
    range, kernel busy time against the wall clock, and the kernels that
    take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_ms(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0) / 1e3

    on_gpu = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    spans = {e.key: dev_ms(e) for e in on_gpu if e.key.startswith("v2v.")}
    kernels = sorted((e for e in on_gpu if not e.key.startswith("v2v.")),
                     key=lambda e: -dev_ms(e))
    busy = sum(dev_ms(e) for e in kernels)
    _log(f"[{tag}] wall {wall_ms:.1f} ms, kernels busy {busy:.1f} "
         f"ms, device idle share {1 - busy / wall_ms:.3f}")
    if spans:
        _log(f"[{tag}] GPU span per stage (ms): " + ", ".join(
            f"{k[4:]} {v:.1f}" for k, v in sorted(spans.items())))
    for e in kernels[:15]:
        _log(f"[{tag}]   {dev_ms(e):8.2f} ms x{e.count:<5d} {e.key[:110]}")


def phase_slice(torch, dev, seed, steps, profile=False):
    from v2v_tpu_torch.losses.lpips import LPIPS
    from v2v_tpu_torch.training.interface import (ModelInterface,
                                                  aggregate_per_source)
    from v2v_tpu_torch.training.raft import random_teacher
    from v2v_tpu_torch.training.steps import make_train_step
    from v2v_tpu_torch.training.train import (make_optimizer, make_scheduler,
                                              sim_config_from_dataset)
    ds = FLAGSHIP_STAGE["dataset"]
    train_ds = ds["train"][0]
    b = ds["train_batch_size"]
    bins, fpb, t = train_ds["num_bins"], train_ds["frames_per_bin"], \
        train_ds["sequence_length"]
    hw = train_ds["crop_size"]
    g = torch.Generator(device=dev).manual_seed(seed)
    lp = LPIPS(FLAGSHIP_MODULE["loss"]["lpips_type"], dev, generator=g)
    teacher = random_teacher(12, dev, generator=g)
    iface = ModelInterface(FLAGSHIP_MODULE, dev, generator=g, lpips=lp,
                           teacher=teacher)
    n_params = sum(p.numel() for p in iface.model.parameters())
    _require(n_params == FLAGSHIP_PARAMS, f"E2VID has {n_params} parameters")
    opt_cfg = make_optimizer(FLAGSHIP_STAGE["optimizer"])
    sched = make_scheduler(FLAGSHIP_STAGE["lr_scheduler"])
    opt = opt_cfg.make(iface.model.parameters())
    for group in opt.param_groups:
        group["lr"] = opt_cfg.base_lr * sched(0)
    step = make_train_step(iface, opt, sim_config_from_dataset(train_ds),
                           num_bins=bins, frames_per_bin=fpb)
    video = _drifting_video(b, t * bins * fpb + 1, hw, hw, seed + 2, dev)
    batch = {"video": video,
             "data_source_idx": torch.full((b,), 11, dtype=torch.int64)}
    _log(f"[slice] E2VID {n_params} params, B={b} N={video.shape[1]} "
         f"T={t} {hw}x{hw}, compute {FLAGSHIP_MODULE['compute_dtype']}, "
         f"Adam amsgrad lr {opt.param_groups[0]['lr']}, random LPIPS trunk "
         f"and random RAFT-small teacher")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        loss, aux = step(batch, g)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        logs = aggregate_per_source(aux, batch["data_source_idx"].numpy())
        _log(f"[slice] step {i}: loss {losses[-1]:.5f} grad_norm "
             f"{float(aux['grad_norm']):.5f} l1 {logs['l1_loss']:.4f} "
             f"lpips {logs['perceptual_loss']:.4f} tc "
             f"{logs['temporal_consistency_loss']:.4f} "
             f"({times[-1]:.1f} ms)")
        _require(math.isfinite(losses[-1]), "slice: loss is not finite")
        _require(math.isfinite(float(aux["grad_norm"])),
                 "slice: grad norm is not finite")
        _require(aux["l1_loss"].shape == (b,), "slice: per-sample terms")
    launches = _read_launches()
    _require(launches["simulate_batch"] == steps,
             f"slice: K1 launched {launches['simulate_batch']} times in "
             f"{steps} steps")
    if profile:
        _profile(torch, "profile", lambda: step(batch, g))
    after_first = times[1:] or times
    _log(f"[slice] ms/step after the first: "
         f"{statistics.median(after_first):.1f} (all: "
         f"{', '.join(f'{x:.1f}' for x in times)}); max_memory_allocated "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
         f"{launches}")
    return launches


class _SyntheticSequence:
    """One sequence of `frames` frames held in memory, in the sample
    contract of TestH5Dataset (frame (T,H,W,1) in [0,255], events
    (T,H,W,bins)): a drifting texture as GT and uniform random events at
    a fixed rate, both from numpy with `seed`, voxelized on the host by
    the port's events_to_voxel_np with the data config's settings. It
    stands in for an h5 file: the card's machine has no h5py."""

    def __init__(self, name, seed, frames, hw, events_per_frame, data_cfg):
        self.name, self.seed, self.frames, self.hw = name, seed, frames, hw
        self.events_per_frame = events_per_frame
        self.data_cfg = data_cfg

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        import numpy as np
        from v2v_tpu_torch.data.sources import DATA_SOURCES
        from v2v_tpu_torch.ops.voxel import events_to_voxel_np
        rng = np.random.default_rng(self.seed)
        h, w = self.hw
        cell = 16
        coarse = rng.random((h // cell + 2, w // cell + 2)) * 255.0
        texture = np.kron(coarse, np.ones((cell, cell)))
        frames, voxels = [], []
        for t in range(self.frames):
            dy, dx = t % cell, (2 * t) % cell
            frames.append(texture[dy:dy + h, dx:dx + w])
            n = self.events_per_frame
            ts = np.sort(rng.uniform(t / 30.0, (t + 1) / 30.0, n))
            voxels.append(events_to_voxel_np(
                ts, rng.integers(0, w, n), rng.integers(0, h, n),
                rng.integers(0, 2, n).astype(np.uint8),
                num_bins=self.data_cfg["num_bins"], height=h, width=w,
                interpolate_bins=self.data_cfg["interpolate_bins"]))
        return {
            "frame": np.stack(frames)[..., None].astype(np.float32),
            "events": np.stack(voxels).transpose(0, 2, 3, 1).astype(
                np.float32),
            "data_source_idx": np.int64(DATA_SOURCES.index(
                self.data_cfg["dataset_name"])),
            "sequence_name": self.name,
            "real_begin_idx": np.zeros((self.frames,), np.int64),
            "frame_idx": np.arange(self.frames, dtype=np.int64),
        }


def phase_eval_reference(torch, dev, seed):
    """The eval step of the full-width ETNet on two 64x64 sequences of 3
    frames, with chunk_threshold forced to 16 so every attention takes
    the long-sequence route: K3 on the card, its plain version on the
    CPU; same weights, float32, TF32 off."""
    from v2v_tpu_torch.models.eitr import MultiheadAttention
    from v2v_tpu_torch.training.interface import ModelInterface
    from v2v_tpu_torch.training.steps import make_eval_step
    _tf32(torch, False)
    cpu = torch.device("cpu")
    frames, hw = 3, (64, 64)
    seqs = [_SyntheticSequence(f"reference{i}", seed + 10 + i, frames, hw,
                               2000, ETNET_CONFIG["test_stage"]["test"][0])[0]
            for i in range(2)]
    old = MultiheadAttention.chunk_threshold
    MultiheadAttention.chunk_threshold = 16
    runs, weights = [], None
    try:
        for d in (dev, cpu):
            iface = ModelInterface(
                ETNET_CONFIG["module"], d,
                generator=torch.Generator(device=d).manual_seed(seed))
            if weights is None:
                weights = {k: v.to(cpu)
                           for k, v in iface.model.state_dict().items()}
            else:
                iface.model.load_state_dict(weights)
            step = make_eval_step(iface)
            _zero_launches()
            preds = []
            for sq in seqs:
                events = torch.as_tensor(sq["events"][None], device=d)
                pred, _ = step(events, iface.init_state(1, *hw))
                preds.append(pred.to(cpu))
            runs.append((torch.cat(preds), _read_launches()["attention"]))
    finally:
        MultiheadAttention.chunk_threshold = old
    (pc, lc), (ph, lh) = runs
    err = float((pc - ph).abs().max())
    want = K3_PER_FRAME * frames * len(seqs)
    _log(f"[eval-reference] ETNet {hw[0]}x{hw[1]}, {len(seqs)} sequences x "
         f"{frames} frames, chunk_threshold 16: max|pred cuda - pred cpu| "
         f"{err:.3e} (tolerance {EVAL_REF_ATOL}); K3 launches {lc} on the "
         f"card (want {want}), {lh} on the CPU")
    _require(bool(torch.isfinite(pc).all()), "eval-reference: non-finite")
    _require(err <= EVAL_REF_ATOL, "eval-reference: card and CPU differ")
    _require(lc == want and lh == 0, "eval-reference: K3 launch count")
    _tf32(torch, True)


def phase_eval(torch, dev, seed, profile=False):
    """configs/test_etnet_original.yaml's ETNet through the port's
    run_test on two synthetic 720x1280 sequences, timed per frame."""
    from v2v_tpu_torch.data.interface import ConcatDataset
    from v2v_tpu_torch.eval.harness import run_test
    from v2v_tpu_torch.losses.lpips import LPIPS
    from v2v_tpu_torch.training.interface import ModelInterface
    from v2v_tpu_torch.training.steps import make_eval_step
    cfg = json.loads(json.dumps(ETNET_CONFIG))
    cfg.pop("test_output_dir")     # PNG output needs cv2, absent here
    data_cfg = cfg["test_stage"]["test"][0]          # evaid
    g = torch.Generator(device=dev).manual_seed(seed)
    lp = LPIPS("alex", dev, generator=g)
    iface = ModelInterface(cfg["module"], dev, generator=g, lpips=lp,
                           lpips_test=lp)
    n_params = sum(p.numel() for p in iface.model.parameters())
    seqs = [_SyntheticSequence(f"synthetic{i}", seed + 20 + i, EVAL_FRAMES,
                               EVAL_HW, EVAL_EVENTS_PER_FRAME, data_cfg)
            for i in range(2)]
    model, plain_step = iface.model, iface.model.step
    times, outs = [], []

    def timed_step(x, states):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, states = plain_step(x, states)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out["image"].detach().clone())
        return out, states

    model.step = timed_step
    _log(f"[eval] ETNet {n_params} params at {EVAL_HW[0]}x{EVAL_HW[1]} "
         f"({EVAL_HW[0] // 8 * EVAL_HW[1] // 8} tokens a stream), 2 "
         f"sequences x {EVAL_FRAMES} frames, {EVAL_EVENTS_PER_FRAME} events "
         f"a frame, random ETNet and LPIPS-Alex trunks")
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    try:
        final = run_test(iface, cfg, root=root,
                         dataset=ConcatDataset(seqs))
    finally:
        model.step = plain_step
    wall = time.perf_counter() - t0
    launches = _read_launches()
    n_frames = 2 * EVAL_FRAMES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _require(launches["attention"] == K3_PER_FRAME * n_frames,
             f"eval: K3 launched {launches['attention']} times in "
             f"{n_frames} frames")
    _require(len(outs) == n_frames, f"eval: {len(outs)} model steps")
    for img in outs:
        _require(bool(torch.isfinite(img).all()), "eval: non-finite pred")
        _require(float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
                 "eval: pred outside [0, 1]")
    # the harness reset the state at the second sequence: its first frame
    # equals a run from a fresh state
    first = torch.as_tensor(seqs[1][0]["events"][None, :1], device=dev)
    eval_step = make_eval_step(iface)
    fresh, state = eval_step(first, iface.init_state(1, *EVAL_HW))
    reset_err = float((fresh[0, 0, ..., 0]
                       - outs[EVAL_FRAMES][0, 0]).abs().max())
    carried, _ = eval_step(first, state)
    carried_diff = float((carried - fresh).abs().max())
    _log(f"[eval] sequence 2, frame 1: max|harness - fresh state| "
         f"{reset_err:.3e}; the same frame on a carried state differs by "
         f"{carried_diff:.3e}")
    _require(reset_err <= 1e-5, "eval: the state was not reset")
    with open(os.path.join(root, "tensorboard_logs",
                           cfg["experiment_name"], "test_metrics.txt")) as f:
        metrics = {k: float(v) for k, v in
                   (line.rsplit(": ", 1) for line in f if line.strip())}
    _require(len(metrics) == 6 and all(math.isfinite(v)
                                       for v in metrics.values()),
             f"eval: test_metrics.txt holds {metrics}")
    _log("[eval] test_metrics.txt: " + ", ".join(
        f"{k} {v:.5f}" for k, v in sorted(metrics.items())))
    after_first = times[1:]
    _log(f"[eval] ms/frame after the first: "
         f"{statistics.median(after_first):.1f} (min {min(after_first):.1f}"
         f", max {max(after_first):.1f}, first {times[0]:.1f}); run_test "
         f"{wall:.1f} s for {n_frames} frames; max_memory_allocated "
         f"{peak:.2f} GiB; launches {launches}")
    if profile:
        _profile(torch, "eval-profile", lambda: eval_step(first, state))
    return launches, final


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--profile", action="store_true",
                    help="profile one more train step and one more eval "
                         "frame")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import v2v_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: v2v_tpu_torch not importable ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    try:
        phase_device(torch)
        phase_build()
        k2 = phase_k2(torch, dev, args.seed)
        k1 = phase_k1(torch, dev, args.seed)
        k3 = phase_k3(torch, dev, args.seed)
        phase_reference(torch, dev, args.seed)
        train_launches = phase_slice(torch, dev, args.seed, args.steps,
                                     args.profile)
        phase_eval_reference(torch, dev, args.seed)
        eval_launches, _ = phase_eval(torch, dev, args.seed, args.profile)
    except Exception as e:   # every phase failure ends the run non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    k1["launches"] = train_launches["simulate_batch"]
    k2["launches"] = train_launches["sample_gaussian"]
    k3["launches"] = eval_launches["attention"]
    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
