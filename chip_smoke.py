#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (v2v_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--steps 3] [--profile]

Phases, one line each, any failure exits non-zero:
  1. device: nvidia-smi name and power limit, torch/CUDA versions, TF32
  2. build: nvcc builds the CUDA kernels from v2v_tpu_torch/csrc, one
     process per source, all at once, and prints each kernel's registers
     and spills; an instance of esim.cu or dynconv_bwd.cu must not spill
  3. K2 (sample_gaussian) against its plain version: equal bits
  4. K1 (simulate_batch) against its plain version at the flagship shape
     (12, 201, 128, 128), a 180x240 crop and a ragged (2, 9, 7, 9): equal
     bits on uint8 video, noise-free and noisy, and the flip budget on
     float32 video; the kernel timed a call and back to back (with the SM
     clock under load) beside the plain version, its bytes bound (counts
     at 2 bytes) and an issue bound from the instructions a pixel-frame
     counted in its SASS (cuobjdump)
  5. K3 (attention) against its plain version (TF32 off) at ETNet's 720p
     shape (1, 8, 14400, 32), at a ragged 5001 tokens, with 50 keys (fewer
     than one key tile) and at (2, 8, 300, 32) against 777 keys; its
     registers, shared memory and spills from ptxas, and its HGMMA
     (tensor-core) and UTMALDG (TMA) instructions counted in its SASS;
     kernel (per call and back to back), plain version and float32
     scaled_dot_product_attention timed beside the bound terms
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
 10. hyper eval reference: full-width HyperE2VID on two 64x64 sequences
     of 3 frames, card (K4) against CPU (plain loop)
 11. the hyper eval: configs/test_hypere2vid_original.yaml's HyperE2VID
     through run_test on the same two synthetic 720x1280 sequences; K4
     must launch once a frame
 12. hyper reference: a small float32 HyperE2VID train step with the
     GT-mixing curriculum, card (K4 and its gradient kernels) against CPU
     (plain loops)
 13. the hyper train slice: configs/train_v2v_hyper_10k.yaml at full
     width, `--steps` steps at hyper_beta 1.0 (epoch 0 of hyper_epochs);
     K1 once a step, K4 and its gradient once a time step each (40 a
     step), BatchNorm running statistics that move
 14. the K5 experiment: v2v_tpu_torch/scripts/exp_sim_interleave.py at
     its full workload (12 clips of 201 uint8 frames at 128x128, spp 1,
     2 and 4, 50 chained launches a run); K5's launch count must equal
     the runs' launches
K4 (dynamic_shift_sum) is held against its plain version, values and
gradients, after K3 (phase 5); its gradient (dynamic_shift_sum_backward,
csrc/dynconv_bwd.cu, whose instances must not spill) is held against the
plain backward at the train, a ragged and a two-chunk shape, with equal
bits across two calls, its grid and blocks an SM printed, and timed
beside the plain backward and the bound. K5 (simulate_interleave) is held
against its plain version and against K1 with every pixel hot at K1's
flagship shape, for spp 1, 2 and 4, after K1 (phase 4).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
v2v_tpu_torch package beside it, the script exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
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
# configs/train_v2v_hyper_10k.yaml's `module` and `train_stages[0]`, and
# configs/test_hypere2vid_original.yaml; tests/test_torch_hyper.py holds
# them equal to the YAMLs
HYPER_UNET = {"num_bins": 5, "skip_type": "sum",
              "recurrent_block_type": "convlstm", "num_encoders": 3,
              "base_num_channels": 32, "num_residual_blocks": 2,
              "use_upsample_conv": True, "norm": "none", "kernel_size": 5,
              "channel_multiplier": 2, "num_output_channels": 1,
              "use_dynamic_decoder": True}
HYPER_MODEL = {"target": "model.hyper_model.HyperE2VID",
               "params": {"unet_kwargs": HYPER_UNET}}
HYPER_TRAIN_MODULE = dict(FLAGSHIP_MODULE, model=HYPER_MODEL, hyper_epochs=16)
HYPER_TRAIN_STAGE = dict(
    FLAGSHIP_STAGE, optimizer={"target": "torch.optim.Adam",
                               "params": {"lr": 0.001, "weight_decay": 0,
                                          "amsgrad": True}})
HYPER_EVAL_CONFIG = dict(ETNET_CONFIG, experiment_name="hypere2vid_original",
                         test_output_dir="results/hypere2vid_original",
                         module=dict(ETNET_CONFIG["module"],
                                     model=HYPER_MODEL))
HYPER_PARAMS = 10_149_881
# the curriculum's beta in the train phase: epoch 0 of hyper_epochs,
# 1 - 0/16
HYPER_BETA = 1.0
# K4's shapes on the path: the 720p eval's decoder 0 (B, H/4, W/4, M, CO)
# float32, the train step's bfloat16 (B=12 at 128/4 = 32), a shape whose
# H, W are not multiples of the tiles and whose CO is odd, and CO = 256,
# two channel chunks
K4_SHAPES = (((1, 180, 320, 6, 128), "float32"),
             ((12, 32, 32, 6, 128), "bfloat16"),
             ((2, 37, 53, 6, 97), "float32"),
             ((2, 16, 24, 6, 256), "float32"))
# K4's gradient: the train step's shape in bfloat16, a ragged shape with
# odd CO, and CO = 256, two channel chunks in the datoms kernel
K4_BWD_SHAPES = (((12, 32, 32, 6, 128), "bfloat16"),
                 ((2, 37, 53, 6, 97), "float32"),
                 ((2, 16, 24, 6, 256), "float32"))
# |K4 - plain| on unit-normal z and atoms (|out| up to ~60): float32 sums
# of 150 products in another order (fused multiply-adds, m before the
# offsets). Its gradients too: datoms sums CO products (|datoms| up to
# ~80 at CO = 256), dz 25 (up to ~30), in other orders
K4_ATOL = 1e-4

# EVAID's frame size; frames per sequence in the eval slice (the config's
# sequence_length of 80, cut to stay inside the run's time limit);
# events per frame, of EVAID's order (1e5-1e6)
EVAL_HW = (720, 1280)
EVAL_FRAMES = 8
EVAL_EVENTS_PER_FRAME = 400_000
# K3 launches per ETNet frame: 3 streams x (3 encoder self-attentions +
# 2 decoder layers x (self + cross))
K3_PER_FRAME = 21
# K3's shapes, (q shape, Nk): ETNet at 720p (B, heads, 90*160 tokens, dh),
# a token count that is not a multiple of the kernel's tiles, fewer keys
# than one key tile, and B*h = 16 with ragged Nq and Nk (cross attention)
K3_SHAPES = (((1, 8, 14400, 32), 14400), ((1, 8, 5001, 32), 5001),
             ((1, 8, 14400, 32), 50), ((2, 8, 300, 32), 777))
# |K3 - plain| on unit-normal q, k, v: the kernel's three TF32 passes keep
# float32 accuracy (csrc/attention.cu); float32 sums over up to 14,400
# keys in another order, and the scale folded into the exponent
K3_ATOL = 1e-5
# card (cuDNN, K3 or K4) against CPU (oneDNN, the plain versions) on the
# full-width ETNet or HyperE2VID in float32 with TF32 off, over 3
# recurrent steps
EVAL_REF_ATOL = 1e-4

# K1's flagship shape (B, N, H, W), the off-multiple crop it is also
# held at, and a ragged shape (H*W odd, N-1 not a multiple of 4); the
# flagship E2VID's parameter count
K1_SHAPE = (12, 201, 128, 128)
CROP_HW = (180, 240)
K1_RAGGED = (2, 9, 7, 9)
FLAGSHIP_PARAMS = 10_710_401

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# dense TF32 tensor-core FLOP/s: K3 runs its products there, in three
# passes for float32 accuracy
TF32_FLOPS = 495e12
# K3's exponentials go to the special-function units: 16 a clock on each
# of the 132 SMs, at the 1.98 GHz boost clock
EXP_PER_S = 16 * 132 * 1.98e9
# float32 operations per simulated pixel and frame, counted from
# csrc/esim.cu and esim.cuh: log diff and add (2), quantization (1
# division, 2 multiplies, 2 adds), noise (Irwin-Hall 2, scale 1, two adds
# 2); the Philox integer work has no entry in the data sheet's rate table,
# so [k1] also counts K1's issued instructions in its SASS
K1_FLOPS_NOISY = 12
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


def _cuda_ms_back_to_back(fn, reps: int) -> float:
    """Milliseconds a call of `fn()` over `reps` calls between one pair of
    CUDA events: the host enqueues ahead of the card, so its time between
    calls is hidden, which `_cuda_ms`'s events around each call include."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def _clocks_while(fn, seconds: float = 1.0):
    """Runs fn() back to back for about `seconds` while nvidia-smi samples
    the SM clock (MHz) and power draw (W) every 20 ms; returns the median
    clock and the highest draw, or None where nvidia-smi gave nothing."""
    import torch
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.5)          # nvidia-smi's own start
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = []
    for line in out.splitlines()[-int(seconds / 0.02):]:
        try:
            samples.append(tuple(float(x) for x in line.split(",")))
        except ValueError:
            pass
    if not samples:
        return None, None
    return (statistics.median(c for c, _ in samples),
            max(p for _, p in samples))


def _bound(bytes_: int, flops: int, flops_per_s: float = F32_FLOPS):
    """Least time on the card (ms) and what sets it: each input read and
    each output written once at the HBM rate, or the operations at their
    type's rate (default float32 outside the tensor cores)."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / flops_per_s
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
    from v2v_tpu_torch.ops import dynconv as dc
    from v2v_tpu_torch.ops import sim_interleave as si
    from v2v_tpu_torch.ops import voxel_cuda as vc
    return {"simulate_batch": vc.simulate_batch,
            "sample_gaussian": vc.sample_gaussian,
            "attention": at.attention,
            "dynamic_shift_sum": dc.dynamic_shift_sum,
            "dynamic_shift_sum_backward": dc.dynamic_shift_sum_backward,
            "simulate_interleave": si.simulate_interleave}


def _zero_launches() -> None:
    for fn in _kernels().values():
        fn.launches = 0


def _read_launches() -> dict:
    return {name: fn.launches for name, fn in _kernels().items()}


def _tf32(torch, on: bool):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def phase_build() -> dict:
    """One nvcc per CUDA source, all started together; returns each
    build's {'path', 'seconds', 'log', 'cached'} by source name (a
    library already built gives the ptxas report kept beside it)."""
    from concurrent.futures import ThreadPoolExecutor
    from v2v_tpu_torch.ops import (attention, dynconv, sim_interleave,
                                   voxel_cuda)
    libs = (voxel_cuda.LIB, attention.LIB, dynconv.LIB, dynconv.LIB_BWD,
            sim_interleave.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:
        infos = list(pool.map(lambda lib: lib.build(), libs))
    for lib, info in zip(libs, infos):
        _log(f"[build] {info['path'].name} "
             + ("cached" if info["cached"] else f"in {info['seconds']:.1f} s")
             + f" (nvcc {' '.join(lib.flags)})")
        for line in _ptxas_summary(info["log"]):
            _log(f"[build]   {line}")
    # K4's gradient kernels and K1 on uint8 video (the train step's) were
    # designed not to spill (csrc/dynconv_bwd.cu, csrc/esim.cu); K1 on
    # float32 video (no main path's) calls powf and logf, whose slow paths
    # are out-of-line calls, and ptxas may spill a few bytes around them
    bwd = infos[libs.index(dynconv.LIB_BWD)]["log"]
    _require(" 0 bytes spill stores" in bwd and not
             re.search(r" [1-9]\d* bytes spill stores", bwd),
             "dynconv_bwd.cu: a kernel instance spills, or its ptxas "
             "report is missing")
    esim = [line for line in _ptxas_summary(
        infos[libs.index(voxel_cuda.LIB)]["log"])
        if line.startswith("esim_kernel<true")]
    _require(bool(esim) and all(" 0 B spill stores" in line for line in esim),
             "esim.cu: a uint8 instance spills, or its ptxas report is "
             "missing")
    return {lib.source: info for lib, info in zip(libs, infos)}


def _ptxas_summary(log: str) -> list:
    """One line per kernel of an `nvcc -Xptxas -v` log: its name
    (demangled by the toolkit's cu++filt, without its parameters),
    registers and spill bytes."""
    kernels, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"entry function '(\S+)'", line):
            name = m.group(1)
            kernels[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", line)):
            kernels[name]["spills"] = f"{m.group(1)} B spill stores, " \
                                      f"{m.group(2)} B spill loads"
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            kernels[name]["registers"] = int(m.group(1))
    from v2v_tpu_torch.ops._sass import demangle, kernel_name
    shown = demangle(list(kernels))
    return [f"{kernel_name(full)}: {k.get('registers')} registers, "
            f"{k.get('spills')}" for full, k in zip(shown, kernels.values())]


def _csrc_kernels() -> set:
    """The names of the `__global__` functions in v2v_tpu_torch/csrc."""
    from v2v_tpu_torch.ops._build import CSRC
    return {name for path in CSRC.glob("*.cu") for name in re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
        path.read_text())}


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


def phase_k1(torch, dev, seed, build):
    """K1 against its plain version: equal bits on uint8 video (noise-free
    and noisy) at the flagship shape, the 180x240 crop and a ragged shape,
    the flip budget on float32 video; timed a call and back to back beside
    its bytes bound and the issue bound of its SASS."""
    from v2v_tpu_torch.ops import _sass as sa
    from v2v_tpu_torch.ops import voxel_cuda as vc
    from v2v_tpu_torch.ops.voxel import SimParams, sample_sim_params
    from v2v_tpu_torch.training.train import sim_config_from_dataset
    b, n, h, w = K1_SHAPE
    sim_cfg = sim_config_from_dataset(FLAGSHIP_STAGE["dataset"]["train"][0])
    g = torch.Generator(device=dev).manual_seed(seed)
    video = _drifting_video(b, n, h, w, seed, dev)
    params = sample_sim_params(g, sim_cfg, b)
    seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=g, device=dev,
                          dtype=torch.int32)
    crop = _drifting_video(b, n, *CROP_HW, seed + 1, dev)
    rb = K1_RAGGED[0]
    ragged = _drifting_video(*K1_RAGGED, seed + 2, dev)
    r_params = SimParams(*(v[:rb] for v in params))
    worst = 0.0
    cases = [("uint8 noise-free", video, True), ("uint8 noisy", video, False),
             ("float32 noisy", video.float(), False),
             ("float32 noise-free", video.float(), True)]
    crop_name = f"{CROP_HW[0]}x{CROP_HW[1]}"
    cases += [(f"uint8 noise-free {crop_name}", crop, True),
              (f"uint8 noisy {crop_name}", crop, False),
              ("uint8 noise-free ragged", ragged, True),
              ("uint8 noisy ragged", ragged, False),
              ("float32 noisy ragged", ragged.float(), False)]
    for name, v, nf in cases:
        s, prm = (seeds, params) if v.shape[0] == b else (seeds[:rb],
                                                           r_params)
        got = vc.simulate_batch(v, s, prm, noise_free=nf)
        want = vc.simulate_batch_plain(v, s, prm, noise_free=nf)
        torch.cuda.synchronize()
        _require(got.dtype == torch.bfloat16 and got.shape == want.shape,
                 f"K1 {name}: {got.dtype} {tuple(got.shape)}")
        dmax, rate = _counts_diff(got.float(), want.float())
        events = float(want.float().abs().mean())
        _log(f"[k1] {name}: shape {tuple(got.shape)} mean|events| "
             f"{events:.4f} max|diff| {dmax} mismatch rate {rate:.2e}")
        _require(bool(torch.isfinite(got).all()), f"K1 {name}: non-finite")
        _require(events > 0, f"K1 {name}: no events")
        if v.dtype == torch.uint8:
            _require(torch.equal(got, want),
                     f"K1 {name}: bits differ from the plain version")
        _require(dmax <= 1.0 and rate <= FLIP_RATE,
                 f"K1 {name}: beyond the flip budget")
        worst = max(worst, dmax)
    fn = lambda: vc.simulate_batch(video, seeds, params)
    ms = _cuda_ms(fn, 20)
    b2b = _cuda_ms_back_to_back(fn, 20)
    clock, power = _clocks_while(fn)
    plain_ms = _cuda_ms(lambda: vc.simulate_batch_plain(video, seeds, params),
                        3, warmup=1)
    px_frames = b * (n - 1) * h * w
    bytes_ = b * n * h * w + px_frames * 2
    bound_ms, bound_by = _bound(bytes_, K1_FLOPS_NOISY * px_frames)
    static_px, per_px, pix, _ = sa.k1_issue_report(build["path"])
    issue_ms = None if per_px is None else sa.issue_ms(per_px * px_frames)
    _log(f"[k1] SASS: esim_kernel<true, true, true, {pix}>'s quad loop "
         + (f"{static_px * 4 * pix:.0f} instructions for 4 frames of {pix} "
            f"pixels, {per_px * 4 * pix:.0f} issued without the divisions' "
            f"slow paths: {per_px:.2f} a pixel-frame ({static_px:.2f} "
            f"with them); issue bound {issue_ms:.4f} ms "
            f"({sa.ISSUE_PER_CLOCK} warp instructions a clock, {sa.SMS} "
            f"SMs, {sa.BOOST_HZ / 1e9} GHz)"
            if per_px is not None else "not found: issue bound not "
                                       "measured"))
    _log(f"[k1] flagship uint8 noisy: kernel {ms:.4f} ms a call, "
         f"{b2b:.4f} ms back to back (SM clock "
         f"{clock if clock is None else f'{clock:.0f} MHz'}, power "
         f"{power if power is None else f'{power:.0f} W'}); bound "
         f"{bound_ms:.4f} ms ({bound_by}: {bytes_ / 1e6:.1f} MB, counts at "
         f"2 bytes); plain {plain_ms:.2f} ms; {b / (b2b / 1e3):.0f} clips/s "
         f"back to back")
    return {"name": "simulate_batch", "route": "cuda",
            "source": "v2v_tpu_torch/csrc/esim.cu",
            "replaces": "v2v_tpu/ops/voxel_pallas.py:172",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "back_to_back_ms": b2b, "issue_bound_ms": issue_ms,
            "sass_instructions_per_pixel_frame": per_px}


def phase_k5(torch, dev, seed, k1_ms):
    """K5 at K1's flagship shape, per-clip parameters and seeds from
    `seed`: against its plain version for each spp the experiment runs
    (equal bits on uint8, the flip budget on float32) and against K1 with
    every pixel hot (fraction 2.0, std 0.05) in bfloat16 (equal bits);
    the kernel timed per spp beside K1's time from [k1]."""
    from v2v_tpu_torch.ops import sim_interleave as si
    from v2v_tpu_torch.ops import voxel_cuda as vc
    from v2v_tpu_torch.ops.voxel import SimParams, sample_sim_params
    from v2v_tpu_torch.scripts.exp_sim_interleave import SPPS
    from v2v_tpu_torch.training.train import sim_config_from_dataset
    b, n, h, w = K1_SHAPE
    sim_cfg = sim_config_from_dataset(FLAGSHIP_STAGE["dataset"]["train"][0])
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    video = _drifting_video(b, n, h, w, seed, dev)
    prm = sample_sim_params(g, sim_cfg, b)
    pos, neg, noise = prm.pos_thres, prm.neg_thres, prm.base_noise_std
    seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=g, device=dev,
                          dtype=torch.int32)
    # per-clip tensors on the card, so that K1's wrapper copies nothing
    # from the host when it is timed back to back below
    k1_prm = SimParams(pos, neg, noise, torch.full_like(pos, 2.0),
                       torch.full_like(pos, si.HOT_STD))
    k1 = vc.simulate_batch(video, seeds, k1_prm)
    worst = 0.0
    for name, v in (("uint8", video), ("float32", video.float())):
        want = si.simulate_interleave_plain(v, seeds, pos, neg, noise)
        events = float(want.float().abs().mean())
        _require(events > 0, f"K5 {name}: no events")
        for spp in SPPS:
            got = si.simulate_interleave(v, seeds, pos, neg, noise, spp=spp)
            torch.cuda.synchronize()
            _require(got.dtype == torch.bfloat16 and got.shape == want.shape,
                     f"K5 {name} spp={spp}: {got.dtype} {tuple(got.shape)}")
            _require(bool(torch.isfinite(got).all()),
                     f"K5 {name} spp={spp}: non-finite")
            dmax, rate = _counts_diff(got.float(), want.float())
            _log(f"[k5] {name} spp={spp}: shape {tuple(got.shape)} "
                 f"mean|events| {events:.4f} max|diff| {dmax} mismatch rate "
                 f"{rate:.2e}")
            if name == "uint8":
                _require(torch.equal(got, want),
                         f"K5 uint8 spp={spp}: bits differ from the plain "
                         f"version")
                _require(torch.equal(got, k1),
                         f"K5 uint8 spp={spp}: bits differ from K1 with "
                         f"every pixel hot")
            _require(dmax <= 1.0 and rate <= FLIP_RATE,
                     f"K5 {name} spp={spp}: beyond the flip budget")
            worst = max(worst, dmax)
    _log(f"[k5] uint8: equal bits with K1 (hot fraction 2.0, hot std "
         f"{si.HOT_STD}) in bfloat16 for spp {list(SPPS)}")
    k5 = {spp: (lambda s=spp: si.simulate_interleave(
        video, seeds, pos, neg, noise, spp=s)) for spp in SPPS}
    ms = {spp: _cuda_ms(fn, 20) for spp, fn in k5.items()}
    b2b = {spp: _cuda_ms_back_to_back(fn, 20) for spp, fn in k5.items()}
    k1_b2b = _cuda_ms_back_to_back(
        lambda: vc.simulate_batch(video, seeds, k1_prm), 20)
    plain_ms = _cuda_ms(lambda: si.simulate_interleave_plain(
        video, seeds, pos, neg, noise), 3, warmup=1)
    px_frames = b * (n - 1) * h * w
    bytes_ = b * n * h * w + px_frames * 2
    bound_ms, bound_by = _bound(bytes_, K1_FLOPS_NOISY * px_frames)
    _log(f"[k5] flagship uint8: kernel " + ", ".join(
        f"spp={s} {t:.4f} ms ({b / (t / 1e3):.0f} clips/s)"
        for s, t in ms.items())
        + f"; K1 {k1_ms:.4f} ms; plain {plain_ms:.2f} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by}: {bytes_ / 1e6:.1f} MB)")
    _log(f"[k5] back to back, 20 calls: " + ", ".join(
        f"spp={s} {t:.4f} ms" for s, t in b2b.items())
        + f"; K1 {k1_b2b:.4f} ms")
    return {"name": "simulate_interleave", "route": "cuda",
            "source": "v2v_tpu_torch/csrc/sim_interleave.cu",
            "replaces": "scripts/exp_sim_interleave.py:78",
            "max_abs_err": worst, "ms": ms[1], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "ms_by_spp": ms, "back_to_back_ms_by_spp": b2b,
            "k1_back_to_back_ms": k1_b2b}


def phase_sim_interleave(torch, dev):
    """The K5 experiment's path: the port's script at its full workload
    (v2v_tpu_torch/scripts/exp_sim_interleave.py); K5 must launch as
    many times as the script's chained runs."""
    from v2v_tpu_torch.scripts import exp_sim_interleave as exp
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    rates = exp.run(dev)
    wall = time.perf_counter() - t0
    launches = _read_launches()
    want = len(exp.SPPS) * (exp.REPEATS + 1) * exp.ITERS
    _require(launches["simulate_interleave"] == want,
             f"sim-interleave: K5 launched "
             f"{launches['simulate_interleave']} times, want {want}")
    _require(all(r > 0 and math.isfinite(r) for r in rates.values()),
             f"sim-interleave: rates {rates}")
    _log(f"[sim-interleave] B={exp.B} N={exp.N} {exp.H}x{exp.W} uint8, "
         f"{exp.ITERS} chained launches a run, median of {exp.REPEATS}: "
         + ", ".join(f"spp={s} {r:.0f} clips/s" for s, r in rates.items())
         + f"; {wall:.1f} s; launches {launches}")
    return launches


def _k3_build_report(build: dict) -> dict:
    """attention.cu's ptxas report (registers, shared memory, spills of
    each kernel) and its tensor-core (HGMMA) and TMA (UTMALDG) SASS
    instructions, counted with cuobjdump in the built library."""
    from v2v_tpu_torch.ops import attention as at
    from v2v_tpu_torch.ops._sass import sass as read_sass
    sass = read_sass(build["path"])
    counts = {op: sum(1 for line in sass.splitlines()
                      if f" {op}" in line)
              for op in ("HGMMA", "UTMALDG")}
    lines = [line.strip() for line in build["log"].splitlines()
             if any(w in line for w in ("registers", "spill", "smem",
                                        "warning", "entry function"))]
    for line in lines:
        _log(f"[k3] ptxas: {line}")
    spills = [line for line in lines if "spill" in line]
    _log(f"[k3] SASS: {counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG; "
         f"dynamic shared memory {at.LIB.get().v2v_attention_smem_bytes()} "
         f"B a block" + ("" if lines else " (library cached: no ptxas "
                                         "report)"))
    _require(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
             "K3: no tensor-core or TMA instructions in its SASS")
    _require(all(" 0 bytes spill stores, 0 bytes spill loads" in line
                 for line in spills), "K3: registers spill")
    return counts


def phase_k3(torch, dev, seed, build):
    """K3 against its plain version on the same tensors, TF32 off (the
    plain version's matmuls would be TF32-accurate otherwise), at every
    shape of K3_SHAPES; its build and SASS report; kernel, plain version
    and float32 SDPA timed at the 720p shape beside the bound terms."""
    from v2v_tpu_torch.ops import attention as at
    sass = _k3_build_report(build)
    _tf32(torch, False)
    g = torch.Generator(device=dev).manual_seed(seed)
    worst = 0.0
    for shape, nk in K3_SHAPES:
        q = torch.randn(shape, generator=g, device=dev)
        k, v = (torch.randn(shape[:2] + (nk, shape[3]), generator=g,
                            device=dev) for _ in range(2))
        got = at.attention(q, k, v)
        want = at.attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        _log(f"[k3] q {shape} x {nk} keys: max|diff| {err:.3e} (tolerance "
             f"{K3_ATOL}), max|out| {float(want.abs().max()):.4f}")
        _require(bool(torch.isfinite(got).all()), f"K3 {shape}: non-finite")
        _require(err <= K3_ATOL, f"K3 {shape} x {nk}: beyond the tolerance")
        worst = max(worst, err)
    (b, h, n, dh), nk = K3_SHAPES[0]
    q, k, v = (torch.randn((b, h, n, dh), generator=g, device=dev)
               for _ in range(3))
    ms = _cuda_ms(lambda: at.attention(q, k, v), 20)
    b2b_ms = _cuda_ms_back_to_back(lambda: at.attention(q, k, v), 20)
    plain_ms = _cuda_ms(lambda: at.attention_plain(q, k, v), 3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _cuda_ms(lambda: sdpa(q, k, v), 20)
    library_b2b_ms = _cuda_ms_back_to_back(lambda: sdpa(q, k, v), 20)
    clock_mhz, power_w = _clocks_while(lambda: at.attention(q, k, v))
    flops = 4 * b * h * n * nk * dh
    bytes_ = 4 * b * h * (2 * n + 2 * nk) * dh
    bound_ms, bound_by = _bound(bytes_, 3 * flops, TF32_FLOPS)
    terms = {"tf32_3_pass": 3 * flops / TF32_FLOPS * 1e3,
             "tf32_1_pass": flops / TF32_FLOPS * 1e3,
             "exponentials": b * h * n * nk / EXP_PER_S * 1e3,
             "float32_cuda_cores": flops / F32_FLOPS * 1e3,
             "bytes": bytes_ / HBM_BYTES_PER_S * 1e3}
    _log(f"[k3] {(b, h, n, dh)}: kernel {ms:.4f} ms a call, {b2b_ms:.4f} "
         f"ms back to back (20 calls); plain {plain_ms:.4f} ms; "
         f"scaled_dot_product_attention (float32) {library_ms:.4f} ms a "
         f"call, {library_b2b_ms:.4f} ms back to back; "
         f"{flops / (b2b_ms / 1e3) / 1e12:.1f} TFLOP/s of the function "
         f"achieved")
    _log(f"[k3] bound terms (ms): 3-pass TF32 {terms['tf32_3_pass']:.4f} "
         f"(the bound: {3 * flops:.4g} FLOP), 1-pass TF32 "
         f"{terms['tf32_1_pass']:.4f}, exponentials "
         f"{terms['exponentials']:.4f} ({b * h * n * nk:.4g}), float32 "
         f"CUDA cores {terms['float32_cuda_cores']:.4f}, bytes "
         f"{terms['bytes']:.4f} ({bytes_ / 1e6:.1f} MB)")
    _log(f"[k3] under 1 s of back-to-back calls: SM clock median "
         f"{clock_mhz} MHz, power draw up to {power_w} W (nvidia-smi every "
         f"20 ms)")
    _tf32(torch, True)
    return {"name": "attention", "route": "cuda",
            "source": "v2v_tpu_torch/csrc/attention.cu",
            "replaces": "v2v_tpu/models/eitr.py:42",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "back_to_back_ms": b2b_ms,
            "library_back_to_back_ms": library_b2b_ms,
            "bound_terms_ms": terms, "sass": sass,
            "sm_clock_mhz": clock_mhz, "power_draw_w": power_w}


def _shift_sum_bound(z, atoms):
    """K4's least time: z and atoms read once, the float32 output written
    once; 2 operations per multiply-add, k*k*M of them per output."""
    b, h, w, m, co = z.shape
    bytes_ = (z.numel() * z.element_size() + atoms.numel() * 4
              + b * h * w * co * 4)
    return _bound(bytes_, 2 * atoms.shape[-1] * m * b * h * w * co), bytes_


def phase_k4(torch, dev, seed):
    """K4 against its plain version on the same tensors at K4_SHAPES, TF32
    off, with equal bits over two calls; _ShiftSum's gradients (its
    backward kernels) at the train shape against autograd through the
    plain loop; K4 timed at the two path shapes, a call and back to back,
    beside the plain version and the bound."""
    from v2v_tpu_torch.ops import dynconv as dc
    _tf32(torch, False)
    g = torch.Generator(device=dev).manual_seed(seed)
    worst, inputs = 0.0, []
    for shape, dtype in K4_SHAPES:
        z = torch.randn(shape, generator=g, device=dev).to(
            getattr(torch, dtype))
        atoms = torch.randn(shape[:4] + (25,), generator=g, device=dev)
        got = dc.dynamic_shift_sum(z, atoms, 5)
        again = dc.dynamic_shift_sum(z, atoms, 5)
        want = dc.dynamic_shift_sum_plain(z, atoms, 5)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        same = torch.equal(got, again)
        _log(f"[k4] z {shape} {dtype}: max|diff| {err:.3e} (tolerance "
             f"{K4_ATOL}), max|out| {float(want.abs().max()):.3f}; two calls "
             f"equal bits: {same}")
        _require(got.dtype == torch.float32 and got.shape == shape[:3]
                 + shape[4:], f"K4 {shape}: output {got.dtype} "
                 f"{tuple(got.shape)}")
        _require(bool(torch.isfinite(got).all()), f"K4 {shape}: non-finite")
        _require(err <= K4_ATOL, f"K4 {shape}: beyond the tolerance")
        _require(same, f"K4 {shape}: two calls differ")
        worst = max(worst, err)
        inputs.append((z, atoms))
    # gradients at the train shape (bfloat16 z), through the backward
    # kernels: dz is a float32 sum rounded once to bfloat16 (half an ulp,
    # 2^-8 relative), datoms is float32 against autograd on the same
    # values widened to float32
    z, atoms = inputs[1]
    cot = torch.randn(z.shape[:3] + z.shape[4:], generator=g, device=dev)
    zk = z.detach().requires_grad_()
    ak = atoms.detach().requires_grad_()
    before = dc.dynamic_shift_sum_backward.launches
    dc.dynamic_shift_sum(zk, ak, 5).backward(cot)
    _require(dc.dynamic_shift_sum_backward.launches == before + 1,
             "K4: the gradient did not go through its kernels")
    zp = z.detach().to(torch.float32).requires_grad_()
    ap = atoms.detach().requires_grad_()
    dc.dynamic_shift_sum_plain(zp, ap, 5).backward(cot)
    torch.cuda.synchronize()
    _require(zk.grad.dtype == torch.bfloat16, "K4: dz is not bfloat16")
    dz_excess = float(((zk.grad.float() - zp.grad).abs()
                       - 2 ** -8 * zp.grad.abs()).max())
    da_err = float((ak.grad - ap.grad).abs().max())
    _log(f"[k4] gradients at {tuple(z.shape)} bfloat16: max(|dz - ref| - "
         f"2^-8 |ref|) {dz_excess:.3e} (tolerance {K4_ATOL}), max|datoms - "
         f"ref| {da_err:.3e} (tolerance {K4_ATOL})")
    _require(dz_excess <= K4_ATOL and da_err <= K4_ATOL,
             "K4: gradients differ from autograd through the plain loop")
    times = []
    for z, atoms in inputs[:2]:
        ms = _cuda_ms(lambda: dc.dynamic_shift_sum(z, atoms, 5), 20)
        # back to back through the kernel's own wrapper: at the train shape
        # the autograd entry's host time a call exceeds the kernel's
        b2b_ms = _cuda_ms_back_to_back(
            lambda: dc._shift_sum_kernel(z, atoms, 5), 20)
        plain_ms = _cuda_ms(lambda: dc.dynamic_shift_sum_plain(z, atoms, 5),
                            5, warmup=1)
        (bound_ms, bound_by), bytes_ = _shift_sum_bound(z, atoms)
        b, h, w, _, co = z.shape
        _log(f"[k4] z {tuple(z.shape)} {str(z.dtype)[6:]} ("
             f"{dc._tile_rows(b, h, w, co, dc._sm_count(dev.index))}-row "
             f"tiles): kernel {ms:.4f} "
             f"ms a call, {b2b_ms:.4f} ms back to back (20 calls); plain "
             f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
             f"{bytes_ / 1e6:.1f} MB); {bytes_ / (ms / 1e3) / 1e12:.2f} TB/s "
             f"a call, {bytes_ / (b2b_ms / 1e3) / 1e12:.2f} back to back")
        times.append({"ms": ms, "back_to_back_ms": b2b_ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by})
    _tf32(torch, True)
    eval_, train = times
    return {"name": "dynamic_shift_sum", "route": "cuda",
            "source": "v2v_tpu_torch/csrc/dynconv.cu",
            "replaces": "v2v_tpu/ops/dynconv.py:145",
            "max_abs_err": worst, **eval_, "library_ms": None,
            "train_shape": train}


def _shift_sum_bwd_bound(z, atoms):
    """K4's gradient's least time: z, atoms and g read once, dz (z's type)
    and datoms (float32) written once; 2 operations per multiply-add,
    k*k*M of them per (pixel, channel) for dz and as many for datoms."""
    b, h, w, m, co = z.shape
    bytes_ = (2 * (z.numel() * z.element_size() + atoms.numel() * 4)
              + b * h * w * co * 4)
    flops = 2 * 2 * atoms.shape[-1] * m * b * h * w * co
    return _bound(bytes_, flops), bytes_


def phase_k4_backward(torch, dev, seed):
    """K4's gradient kernels (csrc/dynconv_bwd.cu) against the plain
    backward on the same tensors, TF32 off, at K4_BWD_SHAPES, with the
    cotangent as the model hands it back (an NCHW tensor's (B,H,W,CO)
    view). datoms and float32 dz within K4_ATOL; bfloat16 dz, one rounding
    of a float32 sum, within K4_ATOL + 2^-8 |ref| of the plain backward on
    z widened to float32 (the record's max_abs_err takes that excess for
    bfloat16 dz). Two calls give equal bits. Timed at the train shape, a
    call and back to back, beside the plain backward and the bound."""
    from v2v_tpu_torch.ops import dynconv as dc
    _tf32(torch, False)
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    worst, train = 0.0, None
    for shape, dtype in K4_BWD_SHAPES:
        z = torch.randn(shape, generator=g, device=dev).to(
            getattr(torch, dtype))
        atoms = torch.randn(shape[:4] + (25,), generator=g, device=dev)
        cot = torch.randn((shape[0], shape[4]) + shape[1:3], generator=g,
                          device=dev).permute(0, 2, 3, 1)
        dz, da = dc.dynamic_shift_sum_backward(z, atoms, cot, 5)
        dz2, da2 = dc.dynamic_shift_sum_backward(z, atoms, cot, 5)
        ref_dz, ref_da = dc.dynamic_shift_sum_backward_plain(
            z.float(), atoms, cot, 5)
        torch.cuda.synchronize()
        _require(dz.dtype == z.dtype and dz.shape == z.shape
                 and da.dtype == torch.float32 and da.shape == atoms.shape,
                 f"K4 backward {shape}: dz {dz.dtype} {tuple(dz.shape)}, "
                 f"datoms {da.dtype} {tuple(da.shape)}")
        _require(bool(torch.isfinite(dz).all() and torch.isfinite(da).all()),
                 f"K4 backward {shape}: non-finite")
        same = torch.equal(dz, dz2) and torch.equal(da, da2)
        rel = 2 ** -8 if z.dtype == torch.bfloat16 else 0.0
        dz_err = float(((dz.float() - ref_dz).abs()
                        - rel * ref_dz.abs()).max())
        da_err = float((da - ref_da).abs().max())
        _log(f"[k4] backward z {shape} {dtype}: max|datoms - ref| "
             f"{da_err:.3e}, max(|dz - ref|" + (" - 2^-8 |ref|" if rel else "")
             + f") {dz_err:.3e} (tolerance {K4_ATOL}); max|datoms| "
             f"{float(ref_da.abs().max()):.3f}, max|dz| "
             f"{float(ref_dz.abs().max()):.3f}; two calls equal bits: {same}")
        _require(same, f"K4 backward {shape}: two calls differ")
        _require(dz_err <= K4_ATOL and da_err <= K4_ATOL,
                 f"K4 backward {shape}: beyond the tolerance")
        worst = max(worst, da_err, dz_err)
        if train is None:
            train = (z, atoms, cot)
    z, atoms, cot = train
    ms = _cuda_ms(lambda: dc.dynamic_shift_sum_backward(z, atoms, cot, 5), 20)
    b2b_ms = _cuda_ms_back_to_back(
        lambda: dc.dynamic_shift_sum_backward(z, atoms, cot, 5), 20)
    plain_ms = _cuda_ms(lambda: dc.dynamic_shift_sum_backward_plain(
        z, atoms, cot, 5), 5, warmup=1)
    (bound_ms, bound_by), bytes_ = _shift_sum_bwd_bound(z, atoms)
    b, h, w, m, co = z.shape
    sms = dc._sm_count(dev.index)
    tiling = dz_atoms, da_atoms = dc._bwd_tiling(b, h, w, m, co, sms)
    dz_sm, da_sm = dc._bwd_blocks_per_sm(z.dtype == torch.bfloat16)
    dz_blocks, da_blocks = dc._bwd_blocks(b, h, w, m, co, tiling)
    dz_smem, da_smem = dc._bwd_smem_bytes(z.element_size())
    _log(f"[k4] backward grid at {tuple(z.shape)}: dz {dc.DZ_ROWS}-row "
         f"tiles, {dz_atoms} atoms a block, {dz_blocks} blocks, {dz_sm} an SM "
         f"({dz_smem} B shared); datoms {dc.DATOMS_ROWS}-row tiles, "
         f"{da_atoms} atoms "
         f"a block, {da_blocks} blocks, {da_sm} an SM ({da_smem} B shared); "
         f"{sms} SMs")
    _log(f"[k4] backward z {tuple(z.shape)} {str(z.dtype)[6:]}: kernels "
         f"{ms:.4f} ms a call, {b2b_ms:.4f} ms back to back (20 calls); "
         f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
         f"{bytes_ / 1e6:.1f} MB); {bytes_ / (ms / 1e3) / 1e12:.2f} TB/s a "
         f"call, {bytes_ / (b2b_ms / 1e3) / 1e12:.2f} back to back")
    _tf32(torch, True)
    return {"name": "dynamic_shift_sum_backward", "route": "cuda",
            "source": "v2v_tpu_torch/csrc/dynconv_bwd.cu",
            "replaces": "v2v_tpu/ops/dynconv.py:118",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "back_to_back_ms": b2b_ms}


def _tiny_module(l0: int, module=None):
    mod = json.loads(json.dumps(module or FLAGSHIP_MODULE))
    mod["loss"]["temporal_consistency_L0"] = l0
    mod["model"]["params"]["unet_kwargs"].update(base_num_channels=4,
                                                 num_residual_blocks=1)
    mod.pop("compute_dtype")
    return mod


def phase_reference(torch, dev, seed, module=None, tag="reference",
                    hyper_beta=None):
    """One float32 train step of a slice (its loss, a tiny model, 64 px)
    on the card against the same step on the CPU, same weights and
    voxels: the CPU path is the one the tier-1 tests hold against JAX.
    With `hyper_beta` the HyperE2VID curriculum runs, K4 and its gradient
    must launch once a time step each on the card, and the BatchNorm
    running statistics (in the state_dict) must agree too."""
    import copy
    from v2v_tpu_torch.losses.lpips import LPIPS
    from v2v_tpu_torch.ops.voxel import SimConfig
    from v2v_tpu_torch.training.interface import ModelInterface
    from v2v_tpu_torch.training.optim import Adam
    from v2v_tpu_torch.training.raft import random_teacher
    from v2v_tpu_torch.training.steps import make_train_step, synthesize_batch
    _tf32(torch, False)
    cpu = torch.device("cpu")
    lr, t = 1e-4, 4
    mod = _tiny_module(l0=2, module=module)
    g = torch.Generator(device=dev).manual_seed(seed)
    video = _drifting_video(2, t * 5 + 1, 64, 64, seed, dev)
    events, frame = synthesize_batch(video, g, SimConfig(), 5, 1)
    kw = {} if hyper_beta is None else {"hyper_beta": hyper_beta}
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
        _zero_launches()
        loss, aux = step({"events": events.to(d), "frame": frame.to(d)}, **kw)
        runs.append((float(loss), float(aux["grad_norm"]),
                     {k: v.detach().to(cpu)
                      for k, v in iface.model.state_dict().items()},
                     _read_launches()))
    (lc, gc, pc, nc), (lh, gh, ph, nh) = runs
    # (card, CPU) launches of K4 and of its gradient
    fwd = [n["dynamic_shift_sum"] for n in (nc, nh)]
    bwd = [n["dynamic_shift_sum_backward"] for n in (nc, nh)]
    perr = max(float((pc[k] - ph[k]).abs().max()) for k in pc)
    _log(f"[{tag}] loss cuda {lc:.6f} cpu {lh:.6f}  grad_norm cuda "
         f"{gc:.6f} cpu {gh:.6f}  max|state_dict diff| after step "
         f"{perr:.2e}; K4 launches {fwd[0]} on the card, {fwd[1]} on the "
         f"CPU; its gradient {bwd[0]} on the card, {bwd[1]} on the CPU")
    _require(math.isfinite(lc) and abs(lc - lh) <= 1e-4 * abs(lh),
             f"{tag}: loss differs between card and CPU")
    _require(abs(gc - gh) <= 1e-3 * abs(gh), f"{tag}: grad norm differs")
    # Adam's first step moves each weight by lr*g/(|g|+eps), under lr in
    # size: a gradient near zero may flip sign between the devices
    _require(perr <= 2 * lr * (1 + 1e-3),
             f"{tag}: params or running statistics after the step differ")
    want = t if hyper_beta is not None else 0
    _require(fwd == [want, 0] and bwd == [want, 0],
             f"{tag}: K4 or K4 backward launch count")
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
    from v2v_tpu_torch.ops._sass import kernel_name
    ours = _csrc_kernels()
    own = [e for e in kernels
           if kernel_name(e.key).split("<")[0] in ours]
    if own:
        _log(f"[{tag}] the port's kernels: " + ", ".join(
            f"{kernel_name(e.key)} {dev_ms(e):.4f} ms x{e.count}"
            for e in own))


def phase_slice(torch, dev, seed, steps, profile=False, module=None,
                stage=None, n_params_want=FLAGSHIP_PARAMS, tag="slice",
                hyper_beta=None):
    """A train config at full width (default the flagship) with a random
    LPIPS trunk and a random RAFT-small teacher, `steps` train steps from
    uint8 video; K1 must launch once a step. With `hyper_beta` (the
    HyperE2VID config) K4 and its gradient must launch once a time step
    each and the BatchNorm running statistics must move."""
    from v2v_tpu_torch.losses.lpips import LPIPS
    from v2v_tpu_torch.training.interface import (ModelInterface,
                                                  aggregate_per_source)
    from v2v_tpu_torch.training.raft import random_teacher
    from v2v_tpu_torch.training.steps import make_train_step
    from v2v_tpu_torch.training.train import (make_optimizer, make_scheduler,
                                              sim_config_from_dataset)
    module = module or FLAGSHIP_MODULE
    stage = stage or FLAGSHIP_STAGE
    ds = stage["dataset"]
    train_ds = ds["train"][0]
    b = ds["train_batch_size"]
    bins, fpb, t = train_ds["num_bins"], train_ds["frames_per_bin"], \
        train_ds["sequence_length"]
    hw = train_ds["crop_size"]
    g = torch.Generator(device=dev).manual_seed(seed)
    lp = LPIPS(module["loss"]["lpips_type"], dev, generator=g)
    teacher = random_teacher(12, dev, generator=g)
    iface = ModelInterface(module, dev, generator=g, lpips=lp,
                           teacher=teacher)
    n_params = sum(p.numel() for p in iface.model.parameters())
    _require(n_params == n_params_want,
             f"{tag}: the model has {n_params} parameters")
    opt_cfg = make_optimizer(stage["optimizer"])
    sched = make_scheduler(stage["lr_scheduler"])
    opt = opt_cfg.make(iface.model.parameters())
    for group in opt.param_groups:
        group["lr"] = opt_cfg.base_lr * sched(0)
    step = make_train_step(iface, opt, sim_config_from_dataset(train_ds),
                           num_bins=bins, frames_per_bin=fpb)
    kw = {} if hyper_beta is None else {"hyper_beta": hyper_beta}
    video = _drifting_video(b, t * bins * fpb + 1, hw, hw, seed + 2, dev)
    batch = {"video": video,
             "data_source_idx": torch.full((b,), 11, dtype=torch.int64)}
    stats0 = {k: v.clone() for k, v in iface.model.named_buffers()
              if k.endswith(("running_mean", "running_var"))}
    _log(f"[{tag}] {type(iface.model).__name__} {n_params} params, B={b} "
         f"N={video.shape[1]} T={t} {hw}x{hw}, compute "
         f"{module['compute_dtype']}, Adam amsgrad lr "
         f"{opt.param_groups[0]['lr']}, random LPIPS trunk and random "
         f"RAFT-small teacher" + (f", hyper_beta {hyper_beta}"
                                  if kw else ""))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        loss, aux = step(batch, g, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        logs = aggregate_per_source(aux, batch["data_source_idx"].numpy())
        _log(f"[{tag}] step {i}: loss {losses[-1]:.5f} grad_norm "
             f"{float(aux['grad_norm']):.5f} l1 {logs['l1_loss']:.4f} "
             f"lpips {logs['perceptual_loss']:.4f} tc "
             f"{logs['temporal_consistency_loss']:.4f} "
             f"({times[-1]:.1f} ms)")
        _require(math.isfinite(losses[-1]), f"{tag}: loss is not finite")
        _require(math.isfinite(float(aux["grad_norm"])),
                 f"{tag}: grad norm is not finite")
        _require(aux["l1_loss"].shape == (b,), f"{tag}: per-sample terms")
    launches = _read_launches()
    _require(launches["simulate_batch"] == steps,
             f"{tag}: K1 launched {launches['simulate_batch']} times in "
             f"{steps} steps")
    want_k4 = t * steps if kw else 0
    for name in ("dynamic_shift_sum", "dynamic_shift_sum_backward"):
        _require(launches[name] == want_k4,
                 f"{tag}: {name} launched {launches[name]} times, want "
                 f"{want_k4}")
    if stats0:
        moved = {k: float((v - stats0[k]).abs().max())
                 for k, v in iface.model.named_buffers() if k in stats0}
        _log(f"[{tag}] BatchNorm running statistics moved by up to "
             + ", ".join(f"{k.split('.', 3)[-1]} {v:.4f}"
                         for k, v in moved.items()))
        _require(all(v > 0 and math.isfinite(v) for v in moved.values()),
                 f"{tag}: BatchNorm running statistics did not move")
    if profile:
        _profile(torch, f"{tag}-profile", lambda: step(batch, g, **kw))
    after_first = times[1:] or times
    _log(f"[{tag}] ms/step after the first: "
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


def phase_eval_reference(torch, dev, seed, module=None, kernel="attention",
                         per_frame=K3_PER_FRAME, tag="eval-reference"):
    """The eval step of a full-width model (default ETNet, whose caller
    forces chunk_threshold to 16 so every attention takes the
    long-sequence route) on two 64x64 sequences of 3 frames: the
    kernel on the card, its plain version on the CPU; same weights,
    float32, TF32 off."""
    from v2v_tpu_torch.training.interface import ModelInterface
    from v2v_tpu_torch.training.steps import make_eval_step
    _tf32(torch, False)
    cpu = torch.device("cpu")
    frames, hw = 3, (64, 64)
    seqs = [_SyntheticSequence(f"reference{i}", seed + 10 + i, frames, hw,
                               2000, ETNET_CONFIG["test_stage"]["test"][0])[0]
            for i in range(2)]
    runs, weights = [], None
    for d in (dev, cpu):
        iface = ModelInterface(
            module or ETNET_CONFIG["module"], d,
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
        runs.append((torch.cat(preds), _read_launches()[kernel]))
    (pc, lc), (ph, lh) = runs
    err = float((pc - ph).abs().max())
    want = per_frame * frames * len(seqs)
    _log(f"[{tag}] {type(iface.model).__name__} {hw[0]}x{hw[1]}, "
         f"{len(seqs)} sequences x {frames} frames: max|pred cuda - pred "
         f"cpu| {err:.3e} (tolerance {EVAL_REF_ATOL}); {kernel} launches "
         f"{lc} on the card (want {want}), {lh} on the CPU")
    _require(bool(torch.isfinite(pc).all()), f"{tag}: non-finite")
    _require(err <= EVAL_REF_ATOL, f"{tag}: card and CPU differ")
    _require(lc == want and lh == 0, f"{tag}: {kernel} launch count")
    _tf32(torch, True)


def phase_eval(torch, dev, seed, profile=False, config=None,
               kernel="attention", per_frame=K3_PER_FRAME, tag="eval",
               sigmoid_output=True):
    """A test config's model (default configs/test_etnet_original.yaml's
    ETNet) through the port's run_test on two synthetic 720x1280
    sequences, timed per frame; `kernel` must launch `per_frame` times a
    frame. Every prediction is finite; a model whose output ends in a
    sigmoid (ETNet's) must also predict in [0, 1] before the harness
    clips. HyperE2VID's has no final activation, so no range holds for
    it."""
    from v2v_tpu_torch.data.interface import ConcatDataset
    from v2v_tpu_torch.eval import harness
    from v2v_tpu_torch.losses.lpips import LPIPS
    from v2v_tpu_torch.training.interface import ModelInterface
    from v2v_tpu_torch.training.steps import make_eval_step
    cfg = json.loads(json.dumps(config or ETNET_CONFIG))
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
    model = iface.model
    times, outs = [], []

    def timed_forward(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, states = type(model).forward(model, *args, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out["image"].detach().clone())
        return out, states

    model.forward = timed_forward
    _log(f"[{tag}] {type(model).__name__} {n_params} params at "
         f"{EVAL_HW[0]}x{EVAL_HW[1]}, 2 sequences x {EVAL_FRAMES} frames, "
         f"{EVAL_EVENTS_PER_FRAME} events a frame, random weights and "
         f"LPIPS-Alex trunk")
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    try:
        final = harness.run_test(iface, cfg, root=root,
                                 dataset=ConcatDataset(seqs))
    finally:
        del model.forward
    wall = time.perf_counter() - t0
    launches = _read_launches()
    n_frames = 2 * EVAL_FRAMES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _require(launches[kernel] == per_frame * n_frames,
             f"{tag}: {kernel} launched {launches[kernel]} times in "
             f"{n_frames} frames")
    _require(len(outs) == n_frames, f"{tag}: {len(outs)} model steps")
    for img in outs:
        _require(bool(torch.isfinite(img).all()), f"{tag}: non-finite pred")
        _require(not sigmoid_output or (float(img.min()) >= 0.0
                                        and float(img.max()) <= 1.0),
                 f"{tag}: pred outside [0, 1]")
    lo = min(float(img.min()) for img in outs)
    hi = max(float(img.max()) for img in outs)
    # the harness reset the state at the second sequence: its first frame
    # equals a run from a fresh state
    first = torch.as_tensor(seqs[1][0]["events"][None, :1], device=dev)
    eval_step = make_eval_step(iface)
    fresh, state = eval_step(first, iface.init_state(1, *EVAL_HW))
    reset_err = float((fresh[0, 0, ..., 0]
                       - outs[EVAL_FRAMES][0, 0]).abs().max())
    carried, _ = eval_step(first, state)
    carried_diff = float((carried - fresh).abs().max())
    _log(f"[{tag}] model output range [{lo:.4f}, {hi:.4f}]; sequence 2, "
         f"frame 1: max|harness - fresh state| {reset_err:.3e}; the same "
         f"frame on a carried state differs by {carried_diff:.3e}")
    _require(reset_err <= 1e-5, f"{tag}: the state was not reset")
    with open(os.path.join(root, "tensorboard_logs",
                           cfg["experiment_name"], "test_metrics.txt")) as f:
        metrics = {k: float(v) for k, v in
                   (line.rsplit(": ", 1) for line in f if line.strip())}
    _require(len(metrics) == 6 and all(math.isfinite(v)
                                       for v in metrics.values()),
             f"{tag}: test_metrics.txt holds {metrics}")
    _log(f"[{tag}] test_metrics.txt: " + ", ".join(
        f"{k} {v:.5f}" for k, v in sorted(metrics.items())))
    after_first = times[1:]
    _log(f"[{tag}] ms/frame after the first: "
         f"{statistics.median(after_first):.1f} (min {min(after_first):.1f}"
         f", max {max(after_first):.1f}, first {times[0]:.1f}); run_test "
         f"{wall:.1f} s for {n_frames} frames; max_memory_allocated "
         f"{peak:.2f} GiB; launches {launches}")
    if profile:
        _profile(torch, f"{tag}-profile", lambda: eval_step(first, state))
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
        builds = phase_build()
        k2 = phase_k2(torch, dev, args.seed)
        k1 = phase_k1(torch, dev, args.seed, builds["esim.cu"])
        k5 = phase_k5(torch, dev, args.seed, k1["ms"])
        k3 = phase_k3(torch, dev, args.seed, builds["attention.cu"])
        k4 = phase_k4(torch, dev, args.seed)
        k4_bwd = phase_k4_backward(torch, dev, args.seed)
        phase_reference(torch, dev, args.seed)
        paths = {"slice": phase_slice(torch, dev, args.seed, args.steps,
                                      args.profile)}
        from v2v_tpu_torch.models.eitr import MultiheadAttention
        old = MultiheadAttention.chunk_threshold
        MultiheadAttention.chunk_threshold = 16
        try:
            phase_eval_reference(torch, dev, args.seed)
        finally:
            MultiheadAttention.chunk_threshold = old
        paths["eval"], _ = phase_eval(torch, dev, args.seed, args.profile)
        phase_eval_reference(torch, dev, args.seed, HYPER_EVAL_CONFIG[
            "module"], "dynamic_shift_sum", 1, "hyper-eval-reference")
        paths["hyper-eval"], _ = phase_eval(
            torch, dev, args.seed, args.profile, HYPER_EVAL_CONFIG,
            "dynamic_shift_sum", 1, "hyper-eval", sigmoid_output=False)
        phase_reference(torch, dev, args.seed, HYPER_TRAIN_MODULE,
                        "hyper-reference", hyper_beta=0.7)
        paths["hyper-train"] = phase_slice(
            torch, dev, args.seed, args.steps, args.profile,
            HYPER_TRAIN_MODULE, HYPER_TRAIN_STAGE, HYPER_PARAMS,
            "hyper-train", HYPER_BETA)
        paths["sim-interleave"] = phase_sim_interleave(torch, dev)
    except Exception as e:   # every phase failure ends the run non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # launches of each kernel on the main paths, each counted from 0 just
    # before its path ran
    kernels = [k1, k2, k3, k4, k4_bwd, k5]
    for rec in kernels:
        by_path = {p: n[rec["name"]] for p, n in paths.items()
                   if n[rec["name"]]}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
        _log(f"[launches] {rec['name']}: {rec['launches']} {by_path}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
