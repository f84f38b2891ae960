#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (v2v_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--steps 3] [--profile]

Phases, one line each, any failure exits non-zero:
  1. device: nvidia-smi name and power limit, torch/CUDA versions, TF32
  2. build: nvcc builds the CUDA kernels from v2v_tpu_torch/csrc, one
     process per source, all at once, and prints each kernel's registers
     and spills; an instance of dynconv_bwd.cu, esim.cu's uint8 K1 and
     sim_interleave.cu's uint8 K5 at spp 1, 2 and 4 must not spill
  2b. the C++ voxel builder of the h5 eval path ([native-voxel]): g++
     builds v2v_tpu_torch/csrc/voxel_builder.cpp; on a 720x1280 frame of
     400,000 events at 5 bins (EVAID) and a 260x346 one at 15 bins
     (ERAFT's MVSEC setting) it equals events_to_voxel_np for discrete
     bins and is within 1e-9 for bilinear ones; both timed on the host
     (ms a frame, Mev/s); the stand-in eval sequences voxelize with it,
     as the port's TestH5Dataset does by default
  3. K2 (sample_gaussian) against its plain version: equal bits at
     512x512, n = 4, 4096x4096, ragged n and an unaligned output; timed
     back to back at the three sizes (n = 4: the launch floor)
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
  7b. the train driver: the flagship config through the port's
     training/train.py::main for 2 epochs of 3 batches on seeded stand-in
     clips (no cv2 there to decode WebVid) with validation on 2 synthetic
     128x128 sequences, checkpoints and the ckpt_paths file in a temp
     root; then 1 more epoch, resumed from epoch_0001.pth with the Adam
     state. K1 must launch once a driver step (9); the checkpoints, the
     val losses, each epoch's lr and the resume are checked
  7c. ETNet training: a float32 ETNet train step at dropout 0 on the
     card against the CPU ([etnet-reference]); then
     configs/train_v2v_etnet_10k.yaml (ETNet at full width, B=6, T=40,
     bf16, AdamW, ExponentialLR 0.94, dropout 0.1) through main as in
     7b ([etnet-train]: K1 9 launches, lr 2e-4 * 0.94^epoch, AdamW at
     step 9 after the resume); one step's dropout masks keep 0.9 +-
     0.005 at each of the 72 draws, and a step seed repeats its loss bit
     for bit
  7d. data parallelism ([ddp]): a process group of one on NCCL; two
     ETNet steps at dropout 0 with the gradients all-reduced equal two
     steps without a group; then one HyperE2VID step whose BatchNorms
     all-reduce their moments in the group equals one without, its
     running statistics moving; the group is destroyed
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
 14. the flow family: a float32 EVFlowNet flow step with the random
     RAFT-large teacher, card against CPU ([flow-reference]);
     configs/train_v2v_evflow_10k.yaml (EVFlowNet, B=10, T=40 with the
     extra frame, bf16, Adam amsgrad, StepLR, RAFT-large at 12 updates)
     through main as in 7b ([flow-train]: K1 9 launches, lr 1e-4 each
     epoch, finite train and val flow losses, the second val sequence
     with a stored flow); configs/test_evflow_original.yaml's EVFlowNet
     through the flow run_test on three synthetic 260x346 sequences, two
     with stored GT flow and one scored against RAFT-large pseudo-GT
     ([flow-eval]: finite EPE/1PE/3PE, a state reset a sequence)
 14a. the rest of the reconstruction zoo: a float32 train step of each
     new model and UNet option (FlowNet, ColorE2VID, WFlowNet,
     FlowNetNoRecur, FireNet, FireNet_legacy; E2VID with convgru, IN, BN
     and transposed-conv decoders; HyperE2VID with its 3-channel head and
     the curriculum, K4 and its gradient once a time step), card against
     CPU, running statistics moving ([zoo-reference]);
     configs/test_e2vid++_original.yaml's FlowNet at full width through
     run_test on the two synthetic 720x1280 sequences of [eval], random
     weights and LPIPS-Alex trunk ([e2vidpp-eval]: finite metrics, a
     reset a sequence, a finite (1, 2, 720, 1280) flow each frame, no
     kernel of the port launched); the flagship train config with its
     model swapped in memory for E2VID++'s FlowNet (the split forward),
     FireNet at its defaults (the per-step loop) and FlowNetNoRecur (one
     call over B*T), `--steps` steps each ([zoo-train-*]: K1 once a
     step)
 14b. ERAFT: a float32 ERAFT step (12 refinements, the extra event
     group) with the random RAFT-large teacher, card against CPU
     ([eraft-reference]); configs/train_v2v_eraft_10k.yaml (B=10, T=40
     with the extra frame and event group, bf16) through main as in 7b
     ([eraft-train]: K1 9 launches, lr 1e-4 each epoch, finite losses,
     cnet's running statistics moved, checkpoint bytes within their
     tensors' bound, as every driver phase's); test_eraft_original.yaml's
     15-bin ERAFT through the flow run_test on two synthetic 720x1280
     sequences of 10 frames against RAFT-large pseudo-GT and two 260x346
     ones with stored flow ([eraft-eval]: T-1 flows, finite metrics, a
     reset a sequence)
 14c. NerNet: test_nernet_original.yaml's model at full width on two
     raw-event sequences of 3 frames at 64x80, forward_sequence_nernet on
     the card against the CPU, float32, TF32 off, and the scatter's sums
     equal bit for bit on both ([nernet-reference]); the same model
     through run_test on two synthetic EVAID 720x1280 raw-event
     sequences of 8 frames (cut from 80), 400,000 events a frame stamped
     in absolute seconds ([nernet-eval]: ms/frame, the voxelization's
     share of a frame, peak memory, finite metrics, a reset a sequence,
     one frame twice from one state in equal bits, no kernel of the port
     launched)
 14d. the ESIM ablation: a float32 step of its module (the flagship's)
     on two stand-in ESIM items of 4 steps at 64x64, pre-voxelized, card
     against CPU ([esim-reference]); configs/train_ablation_e2vid_esim.
     yaml (B=12, T=40, crop 128, full-width E2VID, bf16) through main as
     in 7b on seeded stand-in windows through the port's ESIMTransform
     (no h5py there) ([esim-train]: K1 0 launches, the data comes
     voxelized)
 14e. the event ops ([events-ops]): each function of ops/events.py and
     ops/voxel.py::events_to_voxel on a 720x1280 frame of 400,000 events
     padded to 2^19, card against CPU (integer-valued outputs equal,
     float ones within 1e-5 x (1 + max|cpu|)), events_to_voxel equal to
     events_to_voxel_np and to events_to_voxel_sorted; ms each on the card
 14f. the V2E pixel model ([v2e]): each threshold model on a (201, 128,
     128) uint8 stand-in clip, noise off card against CPU within the flip
     budget, noise on within 5% of the CPU's mean |count|; ms a clip
 14g. WebVid's output="voxel" ([webvid-voxel]): the flagship's stand-in
     clips through data/webvid.py::VoxelOutput (the numpy emulator on the
     host, ms a clip), then `--steps` flagship train steps at full width
     from those voxels: finite losses, K1 launched 0 times
 14h. the legacy datasets ([legacy-data]): a seeded 260x346 memmap
     recording (100 frames, 2,000,000 events, optic flow) through
     SequenceDataset at L=40 with the pause chain, voxel noise, hot
     pixels, hot events filtered, RandomCrop 128, flips and LegacyNorm
     for each voxel method (items/s on the host); one between_frames
     window through the flagship E2VID's eval step on the card, finite
     and equal twice from a reset state
 14i. the release kit ([release]): eval/release.py::validate_release
     (the port's `cli validate_release`) on the card, fed configs as
     dicts and synthetic sequences through its `inputs` seam (no PyYAML
     or h5py there): e2vid++ with a .pth saved from the port's FlowNet
     under the reference's key names (`module.`-prefixed, inside
     {"state_dict": ...}) on two HQF-sized 180x240 sequences named as
     HQF's boxes and desk converts strictly, scores, prints FAIL rows
     against the e2vid+ table and returns 2; etnet and hyper, random-init
     dry runs on two EVAID 720x1280 sequences of 3 frames, return 0, NOT
     GATED, with K3 21 launches an ETNet frame and K4 one a HyperE2VID
     frame; the .pth with one key renamed fails the strict conversion
     (rc 1); each family's kit wall
 14j. the bench scripts through their main, at their defaults with 3
     repeats: [bench-sim] (scripts/bench.py: synthesize_batch's clips/s
     through K1 at (12, 201, 128, 128) uint8 against the host numpy
     simulator), [bench-step] and [bench-step-hyper]
     (scripts/bench_full_step.py --flops: the flagship's and HyperE2VID's
     synchronized ms/step, the step's counted FLOPs and their share of the
     dense bf16 peak; K1 once a step, K4 and its gradient 40 a step) and
     [bench-eval] (scripts/bench_eval.py: ms/frame of six families at
     180x240, 260x346 and 720x1280, each frame synchronized; K3 at
     ETNet's 720p only, K4 once a HyperE2VID frame); each a median and a
     spread over its repeats
 14k. training at scale: [soak] (scripts/soak_train.py: the flagship
     at full width, B=12, T=40, through the train driver in a child
     process on a cut schedule, 3 + 2 epochs of 6 steps of stand-in
     clips, SIGKILLed mid-epoch 2 and resumed in a fresh process; the
     losses finite and falling, the resume at epoch 2, >= 3 LRs, the
     probe's MSE falling over the checkpoints, K1 once a step summed over
     both processes; the child's host RSS and the allocator's reserved
     memory printed); [rss] (scripts/diag_rss.py: the loader, the pinned
     transfer, the step and the three together, each in its own process
     (the four at once) at the flagship's shape for 4 iterations, their
     RSS, heap and reserved series; K1 once a step); [floor]
     (scripts/roofline_floor.py for the flagship and HyperE2VID: the
     step's calls recorded, the top 12 replayed alone in CUDA graphs,
     the floor beside the step's measured ms/step and the gap, K3's,
     K4's and its gradient's bound x launches apart; K1 once a step, K4
     and its gradient 40 a step);
     [close-floor] (scripts/close_floor.py: ETNet, and ERAFT with T cut
     from 40 to 8: the step, the step with a zeros teacher, the
     simulator, the model's constituents forward and backward, the
     residual and the fill, which sum to the step)
 14l. the last tools ([tools]): v2v_tpu_torch/scripts/minimal_train.py
     (the library example: 5 steps of a width-8 E2VID on drifting video,
     K1 once a step, losses finite and falling, ms a step); the ESIM
     renderer (scripts/visualize_esim_sample.py on its synthetic source:
     8 voxel and 8 frame PNGs of 128x128 written without cv2, counts
     finite and integral); the h5 voxel-cache writer's core
     (scripts/testh5_to_voxel_cache.py::cache_arrays) on an HQF-layout
     file of 5 EVAID-sized 720x1280 frames held in memory, read by the
     port's TestH5Dataset through the C++ builder: equal to
     events_to_voxel_np, host ms a frame
 15. the K5 experiment: v2v_tpu_torch/scripts/exp_sim_interleave.py at
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
flagship shape, for spp 1, 2 and 4, and at a ragged shape from unaligned
video and into an unaligned output, after K1 (phase 4); it is timed
beside K1 and the issue bound of each spp's quad loop in its SASS.
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

try:
    # the seeded stand-in data (v2v_tpu_torch/data/synthetic.py): WebVid
    # clips and h5 test sequences, which the card's machine cannot read
    from v2v_tpu_torch.data.synthetic import SYNTHETIC_FLOW
    from v2v_tpu_torch.data.synthetic import DriftingClips as _DriftingClips
    from v2v_tpu_torch.data.synthetic import \
        SyntheticSequence as _SyntheticSequence
except ImportError:     # the script alone: main() exits 2
    SYNTHETIC_FLOW = _DriftingClips = _SyntheticSequence = None

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
# configs/train_v2v_etnet_10k.yaml's `module` and `train_stages[0]`;
# tests/test_torch_etnet_train.py holds them equal to the YAML
ETNET_TRAIN_MODULE = dict(
    FLAGSHIP_MODULE, model={"target": "model.eitr.eitr.EITR",
                            "params": {"eitr_kwargs": {"num_bins": 5,
                                                       "norm": "none"}}})
ETNET_TRAIN_STAGE = dict(
    FLAGSHIP_STAGE, max_epochs=100,
    optimizer={"target": "torch.optim.AdamW",
               "params": {"lr": 0.0002, "weight_decay": 0.01,
                          "amsgrad": True}},
    lr_scheduler={"target": "torch.optim.lr_scheduler.ExponentialLR",
                  "params": {"gamma": 0.94}},
    dataset=dict(FLAGSHIP_STAGE["dataset"], train_batch_size=6, train=[dict(
        FLAGSHIP_STAGE["dataset"]["train"][0],
        video_list_file="configs/webvid10000_filtered.txt")]))
ETNET_PARAMS = 22_175_361
# configs/train_v2v_evflow_10k.yaml's `module` and `train_stages[0]`, and
# configs/test_evflow_original.yaml; tests/test_torch_flow_train.py holds
# them equal to the YAMLs
EVFLOW_MODEL = {"target": "model.model.EVFlowNet", "params": {"unet_kwargs": {
    "num_bins": 5, "base_num_channels": 32, "num_encoders": 4,
    "num_residual_blocks": 2, "num_output_channels": 2,
    "skip_type": "concat", "norm": None, "use_upsample_conv": True,
    "kernel_size": 3, "channel_multiplier": 2}}}
EVFLOW_LOSS = {"l1_weight": 1.0, "optical_flow_source": "raft_large",
               "raft_num_flow_updates": 12}
EVFLOW_TRAIN_MODULE = {"loss": EVFLOW_LOSS, "normalize_voxels": False,
                       "model": EVFLOW_MODEL, "compute_dtype": "bfloat16"}
_FLOW_VAL = {"num_bins": 5, "sequence_length": 80, "interpolate_bins": False,
             "output_additional_frame": True, "image_range": 1}
EVFLOW_TRAIN_STAGE = dict(
    FLAGSHIP_STAGE, max_epochs=50,
    dataset=dict(
        FLAGSHIP_STAGE["dataset"], train_batch_size=10, num_workers=10,
        train=[dict(FLAGSHIP_STAGE["dataset"]["train"][0],
                    video_list_file="configs/webvid10000_full.txt",
                    output_additional_frame=True)],
        val=[dict(_FLOW_VAL, data_file="configs/hqf_test.txt",
                  class_name="data.testh5.TestH5Dataset",
                  dataset_name="hqf", max_samples=1),
             dict(_FLOW_VAL, data_file="configs/mvsec_test_flow.txt",
                  class_name="data.testh5.TestH5FlowDataset",
                  dataset_name="mvsec")]))
_FLOW_TEST = {"class_name": "data.testh5.TestH5Dataset", "num_bins": 5,
              "sequence_length": 80, "interpolate_bins": True,
              "output_additional_frame": True, "image_range": 1,
              "max_samples": 2}
EVFLOW_TEST_CONFIG = {
    "task": "flow", "use_compile": False, "experiment_name": "evflow_original",
    "test_output_dir": "results/evflow_original",
    "module": {"loss": EVFLOW_LOSS, "normalize_voxels": False,
               "model": EVFLOW_MODEL},
    "test_stage": {"test_batch_size": 1, "test_num_workers": 4, "test": [
        dict(_FLOW_TEST, data_file="configs/evaid_test.txt",
             dataset_name="evaid", sequence_length=10),
        dict(_FLOW_TEST, data_file="configs/ijrr_test.txt",
             dataset_name="ijrr"),
        dict(_FLOW_TEST, data_file="configs/hqf_test.txt",
             dataset_name="hqf"),
        {"data_file": "configs/mvsec_test_flow.txt",
         "class_name": "data.testh5.TestH5FlowDataset",
         "dataset_name": "mvsec", "num_bins": 5, "sequence_length": 80,
         "interpolate_bins": True, "output_additional_frame": True,
         "image_range": 1}]},
}
EVFLOW_PARAMS = 14_125_346
# configs/train_v2v_eraft_10k.yaml's `module` and `train_stages[0]`, and
# configs/test_eraft_original.yaml: the EVFlowNet configs with ERAFT, the
# extra leading event group and, for the eval, 15 bins;
# tests/test_torch_eraft_train.py holds them equal to the YAMLs
ERAFT_MODEL = {"target": "model.eraft.eraft.ERAFT",
               "params": {"config": {"subtype": "warm_start"},
                          "n_first_channels": 5}}
ERAFT_TRAIN_MODULE = dict(EVFLOW_TRAIN_MODULE, model=ERAFT_MODEL,
                          forward_type="eraft")
ERAFT_TRAIN_STAGE = dict(
    EVFLOW_TRAIN_STAGE,
    dataset=dict(
        EVFLOW_TRAIN_STAGE["dataset"],
        train=[dict(EVFLOW_TRAIN_STAGE["dataset"]["train"][0],
                    video_list_file="configs/webvid10000_unfiltered.txt",
                    output_additional_evs=True)],
        val=[dict(v, output_additional_evs=True)
             for v in EVFLOW_TRAIN_STAGE["dataset"]["val"]]))
ERAFT_TEST_CONFIG = dict(
    EVFLOW_TEST_CONFIG, experiment_name="eraft_original",
    test_output_dir="results/eraft_original", save_npy=False, save_png=True,
    module={"loss": EVFLOW_LOSS, "normalize_voxels": False,
            "model": dict(ERAFT_MODEL, params=dict(ERAFT_MODEL["params"],
                                                   n_first_channels=15)),
            "forward_type": "eraft"},
    test_stage=dict(EVFLOW_TEST_CONFIG["test_stage"], test=[
        dict(t, num_bins=15, output_additional_evs=True)
        for t in EVFLOW_TEST_CONFIG["test_stage"]["test"]]))
ERAFT_PARAMS = 5_270_080
ERAFT_EVAL_PARAMS = 5_332_800      # 15 input bins in fnet's and cnet's conv1
# configs/test_e2vid++_original.yaml: E2VID++ (FlowNet: E2VID's recurrent
# UNet with an image + flow head); tests/test_torch_zoo_train.py holds it
# equal to the YAML
E2VIDPP_MODEL = {"target": "model.model.FlowNet", "params": {"unet_kwargs": {
    "num_bins": 5, "skip_type": "sum", "recurrent_block_type": "convlstm",
    "num_encoders": 3, "base_num_channels": 32, "num_residual_blocks": 2,
    "use_upsample_conv": True, "norm": "none", "num_output_channels": 3}}}
E2VIDPP_CONFIG = dict(ETNET_CONFIG, experiment_name="e2vid++_original",
                      test_output_dir="results/e2vid++_original",
                      module=dict(ETNET_CONFIG["module"],
                                  model=E2VIDPP_MODEL))
# configs/test_nernet_original.yaml: NerNet (a learned voxelizer on raw
# events, a NIAM ST-cell UNet with GCB attention); configs/
# train_ablation_e2vid_esim.yaml: the flagship's module on ESIM's
# pre-voxelized caches. tests/test_torch_nernet.py and test_torch_esim.py
# hold them equal to the YAMLs
NERNET_CONFIG = {
    "experiment_name": "nernet_original",
    "test_output_dir": "results/nernet_original",
    "module": {
        "loss": dict(ETNET_CONFIG["module"]["loss"]),
        "normalize_voxels": False,
        "model": {"target": "model.nernet_model.RepresentationRecurrent",
                  "params": {"unet_kwargs": {
                      "num_bins": 5, "skip_type": "sum",
                      "recurrent_network": "NIAM_STcell_GCB",
                      "recurrent_block_type": "", "num_encoders": 3,
                      "base_num_channels": 32, "num_residual_blocks": 2,
                      "use_upsample_conv": True, "norm": "",
                      "crop_size": 224, "mlp_layers": [1, 50, 50, 50, 1],
                      "use_cnn_representation": True, "normalize": False,
                      "combine_voxel": False, "RepCNN_kernel_size": 3,
                      "RepCNN_padding": 1, "RepCNN_channel": 64,
                      "RepCNN_num_layers": 1, "num_output_channels": 1}}},
        "is_nernet": True},
    "test_stage": {
        "test_batch_size": 1,
        "test_num_workers": 0,
        "test": [dict(_ETNET_SET, class_name="data.testh5.TestH5EventDataset",
                      data_file=f"configs/{name}_test.txt",
                      dataset_name=name)
                 for name in ("evaid", "ijrr", "hqf", "mvsec")]},
}
NERNET_PARAMS = 19_364_754
ESIM_TRAIN_MODULE = FLAGSHIP_MODULE
ESIM_TRAIN_STAGE = dict(FLAGSHIP_STAGE, dataset=dict(
    FLAGSHIP_STAGE["dataset"],
    train=[{"data_file": "configs/esim_h5.txt",
            "class_name": "data.esim_dataset.ESIMH5Dataset",
            "data_source_name": "esim", "sequence_length": 40,
            "proba_pause_when_running": 0.05,
            "proba_pause_when_paused": 0.9, "noise_std": 0.1,
            "noise_fraction": 1.0, "hot_pixel_std": 0.1,
            "max_hot_pixel_fraction": 0.001, "random_crop_size": 128,
            "random_flip": True}],
    val=[dict(v, interpolate_bins=True)
         for v in FLAGSHIP_STAGE["dataset"]["val"]]))
# the stand-in ESIM caches' frame size (a DAVIS240 sensor's 240x180),
# which the config's 128 crop cuts
ESIM_HW = (180, 240)
# [zoo-train]: the flagship train config with its model swapped in memory
# (no such YAML in configs/) for E2VID++ (the split forward through
# UNetFlow's tail), FireNet at its published defaults (the per-step loop,
# ConvGRU) and FlowNetNoRecur on E2VID++'s unet_kwargs (one batched call
# over B*T); each with its parameter count
ZOO_TRAIN = {
    "flownet": (dict(FLAGSHIP_MODULE, model=E2VIDPP_MODEL), 10_710_467),
    "firenet": (dict(FLAGSHIP_MODULE, model={
        "target": "model.model.FireNet", "params": {}}), 37_777),
    "flownet-norecur": (dict(FLAGSHIP_MODULE, model={
        "target": "model.model.FlowNetNoRecur",
        "params": E2VIDPP_MODEL["params"]}), 4_515_523),
}
# [zoo-reference]: each new model and UNet option in a float32 train step
# card against CPU (_tiny_module cuts the UNets to width 4), in the
# flagship's loss: its model, the loss terms it changes, and the
# HyperE2VID curriculum's beta. E2VID with IN on its pred standardizes
# each predicted frame to mean 0, where the temporal-consistency term's
# |p1 - p0w| / (|p1| + |p0w| + 1e-5) amplifies float32 rounding (on the
# CPU alone float32 and float64 grad norms differ by 9.0e-3 at seed 4,
# 1.1e-4 without the term: tests/test_torch_zoo_train.py), so that case
# runs without it
_FLAGSHIP_UNET = FLAGSHIP_MODULE["model"]["params"]["unet_kwargs"]
_E2VID = FLAGSHIP_MODULE["model"]["target"]


def _e2vid(**unet):
    return {"target": _E2VID,
            "params": {"unet_kwargs": dict(_FLAGSHIP_UNET, **unet)}}


ZOO_REFERENCE = {
    "flownet": (E2VIDPP_MODEL, {}, None),
    "color-e2vid": ({"target": "model.model.ColorE2VID",
                     "params": E2VIDPP_MODEL["params"]}, {}, None),
    "wflownet": ({"target": "model.model.WFlowNet",
                  "params": E2VIDPP_MODEL["params"]}, {}, None),
    "flownet-norecur": (ZOO_TRAIN["flownet-norecur"][0]["model"], {}, None),
    "firenet": (ZOO_TRAIN["firenet"][0]["model"], {}, None),
    "firenet-legacy": ({"target": "model.legacy.FireNet_legacy",
                        "params": {"unet_kwargs": {
                            "num_bins": 5, "base_num_channels": 32,
                            "recurrent_blocks": {"resblock": [0]}}}}, {},
                       None),
    "e2vid-convgru": (_e2vid(recurrent_block_type="convgru"), {}, None),
    "e2vid-in": (_e2vid(norm="IN"), {"temporal_consistency_weight": 0.0},
                 None),
    "e2vid-bn": (_e2vid(norm="BN"), {}, None),
    "e2vid-transposed": (_e2vid(use_upsample_conv=False), {}, None),
    "hypere2vid-3ch": ({"target": HYPER_MODEL["target"], "params": {
        "unet_kwargs": dict(HYPER_UNET, num_output_channels=3)}}, {}, 0.7),
}
# [flow-eval]: MVSEC's DAVIS346 frame (EVAL_FRAMES frames a sequence,
# the config's sequence_length of 80 cut as the other evals' are);
# events a frame, of MVSEC's order (~1e4-1e5 between flow timestamps)
FLOW_EVAL_HW = (260, 346)
FLOW_EVAL_EVENTS_PER_FRAME = 20_000
# ETNet's dropout rate (the reference fixes it at 0.1) and the band the
# kept share of each of a step's mask draws must fall in: a draw of the
# tail covers B*T = 240 frames, at least 240 * 256 tokens * 256 = 1.6e7
# elements (binomial sigma 7.5e-5)
ETNET_DROPOUT = 0.1
KEEP_BAND = 0.005
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
# The x2 upsample's inputs on the main paths (path, shape, dtype, channels
# last): the flagship's three decoders (B*T = 480), EVFlowNet's four
# (B*T = 400), HyperE2VID's dynamic decoder in training (B = 12) and at
# 720p, which hand it channels-last tensors, and E2VID's and ETNet's three
# at 720p (N = 1)
UP_SHAPES = (("flagship", (480, 256, 16, 16), "bfloat16", False),
             ("flagship", (480, 128, 32, 32), "bfloat16", False),
             ("flagship", (480, 64, 64, 64), "bfloat16", False),
             ("evflow", (400, 1024, 8, 8), "bfloat16", False),
             ("evflow", (400, 512, 16, 16), "bfloat16", False),
             ("evflow", (400, 256, 32, 32), "bfloat16", False),
             ("evflow", (400, 128, 64, 64), "bfloat16", False),
             ("hyper", (12, 256, 16, 16), "bfloat16", True),
             ("hyper-eval720", (1, 256, 90, 160), "float32", True),
             ("eval720", (1, 256, 90, 160), "float32", False),
             ("eval720", (1, 128, 180, 320), "float32", False),
             ("eval720", (1, 64, 360, 640), "float32", False))
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
# card against CPU on NerNet's learned voxel at 64x80: float32 MLP rows
# (|voxel| ~0.2 on random weights) summed a few a pixel in the same
# order, the MLP's products in another
NERNET_VOXEL_ATOL = 1e-5

# K1's flagship shape (B, N, H, W), the off-multiple crop it is also
# held at, and a ragged shape (H*W odd, N-1 not a multiple of 4); the
# flagship E2VID's parameter count
K1_SHAPE = (12, 201, 128, 128)
CROP_HW = (180, 240)
K1_RAGGED = (2, 9, 7, 9)
# K5's ragged shape: B a multiple of every spp, H*W odd, N-1 = 10
K5_RAGGED = (4, 11, 7, 9)
FLAGSHIP_PARAMS = 10_710_401
# the [driver] and [etnet-train] phases: epochs before the resume,
# batches of stand-in clips an epoch, and events a frame of the 128x128
# val sequences (EVAID's density of 400,000 a 720x1280 frame, over
# 128x128)
DRIVER_EPOCHS = 2
DRIVER_BATCHES = 3
DRIVER_VAL_EVENTS = 7_000

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
# [native-voxel]: one frame of EVAID's eval (720x1280, 5 bins, EVAL_EVENTS_
# PER_FRAME) and of ERAFT's MVSEC setting (260x346, 15 bins); the C++
# builder against events_to_voxel_np: equal for discrete bins, within this
# for bilinear ones (its weights come from t_us * scale, numpy's from
# t_us / (dt + 1e-4) * (B - 1); tests/test_native.py's bound)
NATIVE_FRAMES = (("EVAID", EVAL_HW, 5, EVAL_EVENTS_PER_FRAME),
                 ("MVSEC", FLOW_EVAL_HW, 15, FLOW_EVAL_EVENTS_PER_FRAME))
NATIVE_BILINEAR_ATOL = 1e-9
# [events-ops]: EVAID's frame padded to 2^19 events; float sums on the
# card add in atomic order, so they agree with the CPU's to float32
# rounding: |card - cpu| <= EVENTS_RTOL * (1 + max|cpu|)
EVENTS_PAD = 1 << 19
EVENTS_RTOL = 1e-5
# [v2e]: the flagship's clip shape; with noise on, the card's mean
# |count| a pixel-frame within this share of the CPU's (other streams)
V2E_CLIP = (201, 128, 128)
V2E_NOISY_BAND = 0.05
# [legacy-data]: an MVSEC-sized (DAVIS346) memmap recording
LEGACY_HW = (260, 346)
LEGACY_FRAMES = 100
LEGACY_EVENTS = 2_000_000
LEGACY_SEQUENCES = 2          # sequence items timed a voxel method

# Flip budget of two float32 log implementations (docs/PERF.md, "Round 4:
# device-log flip budget"): |delta| <= 1 at a rate <= 5e-4.
FLIP_RATE = 5e-4
# [release]: the kit on two registry-named HQF-sized sequences (e2vid++,
# its reference rows) and two EVAID-sized ones (etnet, hyper) of
# RELEASE_FRAMES frames; HQF's events a frame at EVAID's density
RELEASE_FRAMES = 3
RELEASE_HQF_HW = (180, 240)
RELEASE_HQF_EVENTS = 20_000
# [bench-*]: the bench scripts at their defaults with the repeats cut
BENCH_REPEATS = 3


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


def _host_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn()` on the host over `reps` runs after
    one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
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


def _cuda_ms_graph(fn, reps: int) -> float:
    """Milliseconds a call of `fn()` on the card alone: `reps` calls
    captured in one CUDA graph, whose replay is timed between two CUDA
    events, so that no host time a call shows, however busy the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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
    card = smi.stdout.strip().splitlines()[0]
    _log(card)
    _log(f"[device] {torch.cuda.get_device_name(0)} x"
         f"{torch.cuda.device_count()}  python {sys.version.split()[0]}  "
         f"torch {torch.__version__}  cuda {torch.version.cuda}")
    # the train step runs with TF32 convolutions and matmuls; every
    # float32 comparison below switches both off
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    _log("[device] tf32: cudnn.allow_tf32=True cuda.matmul.allow_tf32=True "
         "(off for the float32 comparisons)")
    return card


def _kernels():
    """Every kernel wrapper of the port, by the name the JSON line uses."""
    from v2v_tpu_torch.ops import attention as at
    from v2v_tpu_torch.ops import dynconv as dc
    from v2v_tpu_torch.ops import sim_interleave as si
    from v2v_tpu_torch.ops import upsample as up
    from v2v_tpu_torch.ops import voxel_cuda as vc
    return {"simulate_batch": vc.simulate_batch,
            "sample_gaussian": vc.sample_gaussian,
            "attention": at.attention,
            "dynamic_shift_sum": dc.dynamic_shift_sum,
            "dynamic_shift_sum_backward": dc.dynamic_shift_sum_backward,
            "simulate_interleave": si.simulate_interleave,
            "upsample2x_bilinear": up.upsample2x_bilinear,
            "upsample2x_bilinear_backward": up.upsample2x_bilinear_backward}


def _zero_launches() -> None:
    for fn in _kernels().values():
        fn.launches = 0


def _read_launches() -> dict:
    return {name: fn.launches for name, fn in _kernels().items()}


def _upsample_decoders(model) -> int:
    """The model's x2 upsample decoders (UpsampleConvLayer, HyperE2VID's
    DynamicUpsampleLayer): each launches the upsample kernel once a frame
    in eval and once a train step (the split forward runs the UNet's tail
    once over B*T), its gradient once a train step."""
    from v2v_tpu_torch.models.hyper import DynamicUpsampleLayer
    from v2v_tpu_torch.models.submodules import UpsampleConvLayer
    return sum(isinstance(m, (UpsampleConvLayer, DynamicUpsampleLayer))
               for m in model.modules())


def _require_launches(tag: str, launches: dict, **want) -> None:
    """Each kernel in `want` launched that many times, every other none."""
    full = dict(dict.fromkeys(launches, 0), **want)
    _require(launches == full, f"{tag}: launches {launches}, want {full}")


def _tf32(torch, on: bool):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def phase_build() -> dict:
    """One nvcc per CUDA source, all started together; returns each
    build's {'path', 'seconds', 'log', 'cached'} by source name (a
    library already built gives the ptxas report kept beside it)."""
    from concurrent.futures import ThreadPoolExecutor
    from v2v_tpu_torch.ops import (attention, dynconv, sim_interleave,
                                   upsample, voxel_cuda)
    from v2v_tpu_torch.ops._sass import ptxas_summary
    libs = (voxel_cuda.LIB, attention.LIB, dynconv.LIB, dynconv.LIB_BWD,
            sim_interleave.LIB, upsample.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:
        infos = list(pool.map(lambda lib: lib.build(), libs))
    for lib, info in zip(libs, infos):
        _log(f"[build] {info['path'].name} "
             + ("cached" if info["cached"] else f"in {info['seconds']:.1f} s")
             + f" (nvcc {' '.join(lib.flags)})")
        for line in ptxas_summary(info["log"]):
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
    esim = [line for line in ptxas_summary(
        infos[libs.index(voxel_cuda.LIB)]["log"])
        if line.startswith("esim_kernel<true")]
    _require(bool(esim) and all(" 0 B spill stores" in line for line in esim),
             "esim.cu: a uint8 instance spills, or its ptxas report is "
             "missing")
    # K5's kept shapes for the experiment's spp were chosen not to spill
    # on uint8 video (csrc/sim_interleave.cu; spp 8 spills)
    k5 = [line for line in ptxas_summary(
        infos[libs.index(sim_interleave.LIB)]["log"])
        if re.match(r"sim_interleave_kernel<[124], true", line)]
    _require(len(k5) >= 3 and all(" 0 B spill stores" in line
                                  for line in k5),
             "sim_interleave.cu: a uint8 instance of spp 1, 2 or 4 spills, "
             "or its ptxas report is missing")
    return {lib.source: info for lib, info in zip(libs, infos)}


def _csrc_kernels() -> set:
    """The names of the `__global__` functions in v2v_tpu_torch/csrc."""
    from v2v_tpu_torch.ops._build import CSRC
    return {name for path in CSRC.glob("*.cu") for name in re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
        path.read_text())}


def _unaligned(torch, t):
    """`t`'s values in a view that starts one element into its storage,
    so that no vector path of a kernel takes it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.flatten()
    return buf[1:].view(t.shape)


def phase_k2(torch, dev, seed):
    """K2 against its plain version in equal bits at its callers' 512x512,
    at n = 4 (one thread), at 4096x4096, at n = 4k+1 .. 4k+3 and into an
    unaligned output (the library's C entry); its moments at 512x512;
    timed a call at 512x512 and back to back (20 calls) through the
    wrapper at the three sizes: the n = 4 time is the launch floor of
    that route on this host. The wrapper's host time a call is about
    the kernel's at 4096x4096 (67.1 MB), so the kernel's own time there,
    and its share of the bytes bound, come from 50 calls of the C entry
    into a preallocated output captured in a CUDA graph, beside the
    same at n = 4: the card's own floor a call."""
    from v2v_tpu_torch.ops import voxel_cuda as vc
    from v2v_tpu_torch.ops._build import check, stream
    for name, shape in vc.K2_SHAPES.items():
        got = vc.sample_gaussian(seed, shape, device=dev)
        want = vc.sample_gaussian_plain(seed, got.numel(), dev).view(shape)
        torch.cuda.synchronize()
        _require(torch.equal(got, want), f"K2 {name} differs from its plain "
                                         f"version")
        if name == "512x512":
            first, first_want = got, want
    for n in range(4001, 4004):
        _require(torch.equal(vc.sample_gaussian(seed, (n,), device=dev),
                             vc.sample_gaussian_plain(seed, n, dev)),
                 f"K2 n={n} differs from its plain version")
        out = _unaligned(torch, torch.zeros(n, device=dev))
        _require(vc.LIB.get().v2v_sample_gaussian(seed, out.data_ptr(), n,
                                                  stream()) == 0,
                 "K2 unaligned: launch failed")
        torch.cuda.synchronize()
        _require(torch.equal(out, vc.sample_gaussian_plain(seed, n, dev)),
                 f"K2 n={n} unaligned differs from its plain version")
    s = first.double().flatten()
    n = s.numel()
    kurt = float(((s - s.mean()) ** 4).mean() / s.var(unbiased=False) ** 2)
    ms = _cuda_ms(lambda: vc.sample_gaussian(seed, (512, 512), device=dev),
                  20)
    b2b = {name: _cuda_ms_back_to_back(
        lambda shape=shape: vc.sample_gaussian(seed, shape, device=dev), 20)
        for name, shape in vc.K2_SHAPES.items()}
    graph = {}
    for name in ("n=4", "4096x4096"):
        out = torch.empty(vc.K2_SHAPES[name], dtype=torch.float32,
                          device=dev)
        graph[name] = _cuda_ms_graph(lambda out=out: check(
            vc.LIB.get().v2v_sample_gaussian(seed, out.data_ptr(),
                                             out.numel(), stream()), "K2"),
            50)
    plain_ms = _cuda_ms(lambda: vc.sample_gaussian_plain(seed, n, dev), 5)
    bound_ms, bound_by = _bound(n * 4, 2 * n)
    large = 4096 * 4096
    large_bound_ms, _ = _bound(large * 4, 2 * large)
    _log(f"[k2] equal bits at {list(vc.K2_SHAPES)}, n = 4001-4003 and "
         f"unaligned; 512x512: mean {float(s.mean()):+.5f} var "
         f"{float(s.var()):.5f} kurtosis {kurt:.4f} max|x| "
         f"{float(s.abs().max()):.4f}; kernel {ms:.4f} ms a call, plain "
         f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms")
    _log(f"[k2] the wrapper back to back, 20 calls: 512x512 "
         f"{b2b['512x512']:.4f} ms ({b2b['512x512'] / b2b['n=4']:.2f}x the "
         f"floor); n=4 (the launch floor) {b2b['n=4']:.4f} ms; 4096x4096 "
         f"{b2b['4096x4096']:.4f} ms (the host's route)")
    _log(f"[k2] the card alone, 50 calls of the C entry in a CUDA graph: "
         f"n=4 (its floor) {graph['n=4']:.4f} ms; 4096x4096 "
         f"{graph['4096x4096']:.4f} ms against a bytes bound of "
         f"{large_bound_ms:.4f} ms ({large * 4 / 1e6:.1f} MB; "
         f"{large_bound_ms / graph['4096x4096']:.2f} of it)")
    return {"name": "sample_gaussian", "route": "cuda",
            "source": "v2v_tpu_torch/csrc/esim.cu",
            "replaces": "v2v_tpu/ops/voxel_pallas.py:71",
            "max_abs_err": float((first - first_want).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "back_to_back_ms": b2b["512x512"], "floor_ms": b2b["n=4"],
            "large_wrapper_back_to_back_ms": b2b["4096x4096"],
            "graph_floor_ms": graph["n=4"],
            "large_back_to_back_ms": graph["4096x4096"],
            "large_bound_ms": large_bound_ms}


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


def phase_k5(torch, dev, seed, k1_ms, build):
    """K5 at K1's flagship shape, per-clip parameters and seeds from
    `seed`: against its plain version for each spp the experiment runs
    (equal bits on uint8, the flip budget on float32) and against K1 with
    every pixel hot (fraction 2.0, std 0.05) in bfloat16 (equal bits);
    equal bits on a ragged H*W with an odd N and on unaligned views of
    the video and the output; a group of 2^31 elements refused; the
    kernel timed per spp beside K1's time
    from [k1] and K1 back to back on the same clips, and the issue bound
    of each spp's quad loop, counted in its SASS."""
    from v2v_tpu_torch.ops import _sass as sa
    from v2v_tpu_torch.ops import sim_interleave as si
    from v2v_tpu_torch.ops._build import stream
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
    rb, rn, rh, rw = K5_RAGGED
    ragged = _drifting_video(rb, rn, rh, rw, seed + 3, dev)
    r_prm = [v[:rb] for v in (pos, neg, noise)]
    r_want = si.simulate_interleave_plain(ragged, seeds[:rb], *r_prm)
    r_out = _unaligned(torch, torch.zeros_like(r_want))
    for spp in SPPS:
        for name, v in (("ragged", ragged), ("unaligned video",
                                             _unaligned(torch, ragged))):
            got = si.simulate_interleave(v, seeds[:rb], *r_prm, spp=spp)
            torch.cuda.synchronize()
            _require(torch.equal(got, r_want),
                     f"K5 {name} {K5_RAGGED} spp={spp}: bits differ")
        _require(si.LIB.get().v2v_simulate_interleave(
            ragged.data_ptr(), 1, vc.cached_log_table(dev).data_ptr(),
            seeds.data_ptr(), *(v.data_ptr() for v in r_prm),
            r_out.data_ptr(), rb, rn, rh, rw, spp, stream()) == 0,
            f"K5 unaligned output spp={spp}: launch failed")
        torch.cuda.synchronize()
        _require(torch.equal(r_out, r_want),
                 f"K5 unaligned output {K5_RAGGED} spp={spp}: bits differ")
    _log(f"[k5] uint8 {K5_RAGGED} (H*W {rh * rw}, N-1 {rn - 1}): equal bits "
         f"for spp {list(SPPS)}, also from unaligned video and into an "
         f"unaligned output")
    # the kernel's 32-bit offsets: a group of spp clips of 2^31 elements
    # is refused by the wrapper (an expanded view allocates nothing) and
    # by the C entry (cudaErrorInvalidValue), with nothing launched
    big = (4, 201, 2048, 2048)
    launches = si.simulate_interleave.launches
    try:
        si.simulate_interleave(video[:1, :1, :1, :1].expand(big), seeds[:4],
                               pos[:4], neg[:4], noise[:4], spp=4)
        refused = False
    except ValueError:
        refused = True
    _require(refused and si.simulate_interleave.launches == launches,
             f"K5 {big} spp=4: the wrapper did not refuse 2^31 elements")
    _require(si.LIB.get().v2v_simulate_interleave(
        video.data_ptr(), 1, vc.cached_log_table(dev).data_ptr(),
        seeds.data_ptr(), *(v.data_ptr() for v in r_prm), r_out.data_ptr(),
        *big, 4, stream()) == 1,
        f"K5 {big} spp=4: the C entry did not refuse 2^31 elements")
    _log(f"[k5] {big} at spp=4 (2^31 elements a group): refused by the "
         f"wrapper and the C entry")
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
        + f"; K1 {k1_b2b:.4f} ms; K5 spp=1 / K1 {b2b[1] / k1_b2b:.3f}")
    report = sa.k5_issue_report(build["path"])
    issue = {}
    for spp in SPPS:
        static, per, pix, _ = report[spp]
        issue[spp] = None if per is None else sa.issue_ms(per * px_frames)
        _log(f"[k5] SASS: sim_interleave_kernel<{spp}, true, true>'s quad "
             f"loop ({pix} pixels of {spp} clips a thread) "
             + (f"{per:.2f} instructions a pixel-frame issued without the "
                f"divisions' slow paths ({static:.2f} with them); issue "
                f"bound {issue[spp]:.4f} ms, back to back at "
                f"{issue[spp] / b2b[spp]:.2f} of it"
                if per is not None else "not found: issue bound not "
                                        "measured"))
    return {"name": "simulate_interleave", "route": "cuda",
            "source": "v2v_tpu_torch/csrc/sim_interleave.cu",
            "replaces": "scripts/exp_sim_interleave.py:78",
            "max_abs_err": worst, "ms": ms[1], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "ms_by_spp": ms, "back_to_back_ms_by_spp": b2b,
            "k1_back_to_back_ms": k1_b2b, "issue_bound_ms_by_spp": issue}


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


def phase_upsample(torch, dev, seed):
    """[upsample]: the x2 upsample's kernels (csrc/upsample.cu) against
    ATen's on the same card tensors at UP_SHAPES. The forward equal to
    F.interpolate's, or within one unit in the last place of the output
    type at ATen's value, in ATen's layout; the gather backward within one
    unit of the output type of ATen's float64 gradient on the card, plus
    float32's rounding of its 16 terms (2^-20 of sum w|g|), and no farther
    from it than ATen's own backward; each equal bits over two calls, one
    launch counted a call. Timed a call and back to back beside ATen's
    kernels and the bytes bound (the input read once, the output written
    once); back to back no slower than ATen at each NCHW shape. Returns
    the forward's and the backward's records, their times summed over the
    flagship's three shapes (a train step's calls)."""
    from v2v_tpu_torch.ops import upsample as up
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    rows = []
    for path, shape, dtype, last in UP_SHAPES:
        dt = getattr(torch, dtype)
        fmt = torch.channels_last if last else torch.contiguous_format
        fi = torch.finfo(dt)
        n, c, h, w = shape
        x = torch.randn(shape, generator=gen, device=dev).to(
            dt, memory_format=fmt)
        gy = torch.randn((n, c, 2 * h, 2 * w), generator=gen,
                         device=dev).to(dt, memory_format=fmt)
        tag = f"upsample {path} {shape} {dtype}" + (" channels-last"
                                                     if last else "")
        _zero_launches()
        got = up.upsample2x_bilinear_forward(x)
        same = torch.equal(got, up.upsample2x_bilinear_forward(x))
        want = up.upsample2x_bilinear_plain(x)
        _require(got.dtype == dt and got.stride() == want.stride(),
                 f"{tag}: forward {got.dtype} strides {got.stride()}, ATen "
                 f"{want.stride()}")
        unequal = int((got != want).sum())
        # the gap in units of the output type, in a type that holds it
        wide = torch.float64 if dt == torch.float32 else torch.float32
        ulps = float(((got.to(wide) - want.to(wide)).abs() / (
            fi.eps * want.to(wide).abs().clamp(min=fi.tiny))).max())
        del got, want
        gx = up.upsample2x_bilinear_backward(gy)
        same = same and torch.equal(gx, up.upsample2x_bilinear_backward(gy))
        aten = up.upsample2x_bilinear_backward_plain(gy)
        _require(gx.dtype == dt and gx.stride() == aten.stride(),
                 f"{tag}: backward {gx.dtype} strides {gx.stride()}, ATen "
                 f"{aten.stride()}")
        g64 = gy.double()
        ref = up.upsample2x_bilinear_backward_plain(g64)
        scale = up.upsample2x_bilinear_backward_plain(g64.abs())
        del g64
        room = fi.eps * ref.abs().clamp(min=fi.tiny) + 2.0 ** -20 * scale
        err = (gx.double() - ref).abs()
        over = float((err / room).max())
        err_max = float(err.max())
        aten_max = float((aten.double() - ref).abs().max())
        del gx, aten, ref, scale, room, err
        _require_launches(tag, _read_launches(), upsample2x_bilinear=2,
                          upsample2x_bilinear_backward=2)
        fwd = lambda: up.upsample2x_bilinear_forward(x)
        bwd = lambda: up.upsample2x_bilinear_backward(gy)
        row = {"path": path, "shape": list(shape), "dtype": dtype,
               "channels_last": last, "unequal": unequal, "max_ulps": ulps,
               "bwd_err_over_room": over, "bwd_max_err": err_max,
               "aten_bwd_max_err": aten_max,
               "fwd_ms": _cuda_ms(fwd, 20),
               "fwd_b2b_ms": _cuda_ms_back_to_back(fwd, 20),
               "aten_fwd_b2b_ms": _cuda_ms_back_to_back(
                   lambda: up.upsample2x_bilinear_plain(x), 10),
               "bwd_ms": _cuda_ms(bwd, 20),
               "bwd_b2b_ms": _cuda_ms_back_to_back(bwd, 20),
               "aten_bwd_b2b_ms": _cuda_ms_back_to_back(
                   lambda: up.upsample2x_bilinear_backward_plain(gy), 10)}
        nbytes = 5 * x.numel() * x.element_size()
        row["bound_ms"], _ = _bound(nbytes, 0)
        rows.append(row)
        _log(f"[{tag}]: forward {unequal} elements differ from ATen's, at "
             f"most {ulps:.3g} ulp; backward at most {over:.3f} of its room "
             f"(max|err| {err_max:.3e}, ATen's {aten_max:.3e}); two calls "
             f"equal bits: {same}; forward {row['fwd_ms']:.4f} ms a call, "
             f"{row['fwd_b2b_ms']:.4f} back to back (ATen "
             f"{row['aten_fwd_b2b_ms']:.4f}), backward {row['bwd_ms']:.4f}, "
             f"{row['bwd_b2b_ms']:.4f} (ATen {row['aten_bwd_b2b_ms']:.4f}); "
             f"bound {row['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB): "
             f"{row['bound_ms'] / row['fwd_b2b_ms']:.1%} and "
             f"{row['bound_ms'] / row['bwd_b2b_ms']:.1%} of it back to back")
        _require(same, f"{tag}: two calls of a kernel differ")
        _require(ulps <= 1.0, f"{tag}: the forward is {ulps:.3g} ulp from "
                              f"ATen's")
        _require(over <= 1.0 and err_max <= aten_max,
                 f"{tag}: the backward's error {err_max:.3e} is beyond its "
                 f"room or ATen's {aten_max:.3e}")
        _require(last or (row["fwd_b2b_ms"] <= row["aten_fwd_b2b_ms"]
                          and row["bwd_b2b_ms"] <= row["aten_bwd_b2b_ms"]),
                 f"{tag}: slower than ATen back to back")
        del x, gy
        torch.cuda.empty_cache()
    step = [r for r in rows if r["path"] == "flagship"]
    total = lambda k: sum(r[k] for r in step)
    common = {"route": "cuda", "source": "v2v_tpu_torch/csrc/upsample.cu",
              "replaces": "no TPU kernel (the JAX package's "
                          "jax.image.resize); ATen's upsample_bilinear2d on "
                          "the card",
              "bound_ms": total("bound_ms"), "bound_by": "bytes",
              "library_ms": None, "rows": rows}
    records = [dict(common, name="upsample2x_bilinear",
                    max_ulps=max(r["max_ulps"] for r in rows),
                    ms=total("fwd_ms"), back_to_back_ms=total("fwd_b2b_ms"),
                    plain_ms=total("aten_fwd_b2b_ms")),
               dict(common, name="upsample2x_bilinear_backward",
                    max_err_over_room=max(r["bwd_err_over_room"]
                                          for r in rows),
                    ms=total("bwd_ms"), back_to_back_ms=total("bwd_b2b_ms"),
                    plain_ms=total("aten_bwd_b2b_ms"))]
    for rec, way in zip(records, ("forward", "backward")):
        _log(f"[upsample] {way} over the flagship's three shapes (a train "
             f"step): {rec['ms']:.4f} ms a call, {rec['back_to_back_ms']:.4f} "
             f"back to back, ATen {rec['plain_ms']:.4f}; bound "
             f"{rec['bound_ms']:.4f} ms, "
             f"{rec['bound_ms'] / rec['back_to_back_ms']:.1%} of it")
    return records


def _tiny_module(l0: int, module=None):
    """A train config's module in float32 with L0 cut to `l0`: a UNet
    model cut to width 4 and 1 residual block, ETNet at full width with
    dropout 0 (the card and the CPU draw different streams), FireNet
    (no unet_kwargs) at its own width."""
    mod = json.loads(json.dumps(module or FLAGSHIP_MODULE))
    mod["loss"]["temporal_consistency_L0"] = l0
    params = mod["model"]["params"]
    if "eitr_kwargs" in params:
        params["eitr_kwargs"]["dropout"] = 0.0
    elif "unet_kwargs" in params:
        params["unet_kwargs"].update(base_num_channels=4,
                                     num_residual_blocks=1)
    mod.pop("compute_dtype")
    return mod


def phase_reference(torch, dev, seed, module=None, tag="reference",
                    hyper_beta=None, batch=None):
    """One float32 train step of a slice (its loss, a tiny model, 64 px)
    on the card against the same step on the CPU, same weights and
    voxels (simulated from video, or `batch`'s events, frames and flow
    as a pre-voxelized train set gives them): the CPU path is the one the
    tier-1 tests hold against JAX.
    With `hyper_beta` the HyperE2VID curriculum runs, K4 and its gradient
    must launch once a time step each on the card. Running statistics
    (BatchNorm, InstanceNorm; in the state_dict) must agree too, and
    move on the card."""
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
    if batch is None:
        g = torch.Generator(device=dev).manual_seed(seed)
        video = _drifting_video(2, t * 5 + 1, 64, 64, seed, dev)
        events, frame = synthesize_batch(video, g, SimConfig(), 5, 1)
        batch = {"events": events, "frame": frame}
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
            state = {k: v.to(cpu, copy=True)
                     for k, v in iface.model.state_dict().items()}
        else:
            iface.model.load_state_dict(state)
        opt = Adam(lr=lr, amsgrad=True).make(iface.model.parameters())
        step = make_train_step(iface, opt)
        _zero_launches()
        loss, aux = step({k: v.to(d) for k, v in batch.items()}, **kw)
        runs.append((float(loss), float(aux["grad_norm"]),
                     {k: v.detach().to(cpu)
                      for k, v in iface.model.state_dict().items()},
                     _read_launches()))
    (lc, gc, pc, nc), (lh, gh, ph, nh) = runs
    # (card, CPU) launches of K4 and of its gradient
    fwd = [n["dynamic_shift_sum"] for n in (nc, nh)]
    bwd = [n["dynamic_shift_sum_backward"] for n in (nc, nh)]
    perr = max(float((pc[k] - ph[k]).abs().max()) for k in pc)
    stats = [k for k in pc if k.endswith(("running_mean", "running_var"))]
    moved = min((float((pc[k] - state[k]).abs().max()) for k in stats),
                default=None)
    _log(f"[{tag}] {type(iface.model).__name__}: loss cuda {lc:.6f} cpu "
         f"{lh:.6f}  grad_norm cuda {gc:.6f} cpu {gh:.6f}  max|state_dict "
         f"diff| after step {perr:.2e}; K4 launches {fwd[0]} on the card, "
         f"{fwd[1]} on the CPU; its gradient {bwd[0]} on the card, {bwd[1]} "
         f"on the CPU" + (f"; {len(stats)} running statistics, each moved "
                          f"by at least {moved:.2e}" if stats else ""))
    _require(not stats or moved > 0,
             f"{tag}: a running statistic did not move")
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


def phase_zoo_reference(torch, dev, seed):
    """[zoo-reference]: phase_reference for each model and UNet option of
    ZOO_REFERENCE in the flagship's loss with its changes (HyperE2VID's
    3-channel head in its own train config, with the curriculum)."""
    for name, (model, loss, hyper_beta) in ZOO_REFERENCE.items():
        base = FLAGSHIP_MODULE if hyper_beta is None else HYPER_TRAIN_MODULE
        phase_reference(torch, dev, seed, dict(
            base, model=model, loss=dict(base["loss"], **loss)),
            f"zoo-reference {name}", hyper_beta)


def _profile(torch, tag, fn):
    """fn() once more under torch.profiler: the GPU span of each v2v.*
    range, kernel busy time against the wall clock, and the kernels that
    take the most device time. Returns (wall ms, busy ms, {span: ms})."""
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
    return wall_ms, busy, spans


def phase_slice(torch, dev, seed, steps, profile=False, module=None,
                stage=None, n_params_want=FLAGSHIP_PARAMS, tag="slice",
                hyper_beta=None):
    """A train config at full width (default the flagship) with a random
    LPIPS trunk and a random RAFT-small teacher, `steps` train steps from
    uint8 video; K1 must launch once a step. With `hyper_beta` (the
    HyperE2VID config) K4 and its gradient must launch once a time step
    each and the BatchNorm running statistics must move. Returns the
    launches and the median ms/step after the first step."""
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
    ms = statistics.median(after_first)
    _log(f"[{tag}] ms/step after the first: {ms:.1f} (all: "
         f"{', '.join(f'{x:.1f}' for x in times)}); max_memory_allocated "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
         f"{launches}")
    return launches, ms


class _ESIMStandIn:
    """A seeded stand-in for an ESIM cache set, in ESIMH5Dataset's item
    contract: a window of sequence_length frames of the cache's layout
    (frames (T,1,H,W) in [0, 1], flow (T,2,H,W), voxels (T,5,H,W) of
    signed event counts at `hw`) through the port's ESIMTransform
    (crop, flip, pause chain, noise; its draws from the global `random`
    and `np.random` streams, as the dataset's). One base window is made
    in numpy from `seed`; item `idx` is it rolled by idx frames. It
    stands in for the h5 caches, which the card's machine cannot read (no
    h5py)."""

    def __init__(self, data_cfg, seed, n_items, hw=ESIM_HW):
        import numpy as np
        from v2v_tpu_torch.data.esim import ESIMTransform
        self.transform = ESIMTransform(data_cfg)
        self.n_items = n_items
        t = data_cfg["sequence_length"]
        h, w = hw
        rng = np.random.default_rng(seed)
        tex = rng.random((h, w + t))
        self.frames = np.stack([tex[None, :, i:i + w] for i in range(t)])
        self.flow = np.zeros((t, 2, h, w), np.float32)
        self.flow[:, 0] = -1.0
        self.voxels = (rng.integers(-2, 3, (t, 5, h, w))
                       * (rng.random((t, 5, h, w)) < 0.1)).astype(np.float32)

    def __len__(self):
        return self.n_items

    def __getitem__(self, idx):
        import numpy as np
        return self.transform(*(np.roll(a, idx, axis=0) for a in (
            self.frames, self.flow, self.voxels)))


class _Tee:
    """A stream that writes to each of `streams`."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def _checkpoint_bound(torch, model, optimizer):
    """The bytes a checkpoint of `model` and `optimizer` should take: at
    least every distinct storage of the model's state_dict and the
    optimizer's state (a BatchNorm registered twice is stored once), at
    most that plus 1 KiB a tensor (zip record and pickled name) and 64
    KiB."""
    tensors = list(model.state_dict().values()) + [
        v for st in optimizer.state.values() for v in st.values()
        if torch.is_tensor(v)]
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}
    low = sum(storages.values())
    return low, low + 1024 * len(tensors) + 65536


def phase_driver(torch, dev, seed, slice_ms=None, module=None, stage=None,
                 tag="driver", task="e2vid", stand_in=None, k1_per_step=1):
    """A train config (default the flagship: full width, random LPIPS-VGG
    trunk and RAFT-small teacher, bf16) through the port's train driver,
    training/train.py::main, rooted in a temp dir: DRIVER_EPOCHS epochs
    of DRIVER_BATCHES batches on `stand_in` (default _DriftingClips;
    _ESIMStandIn for a pre-voxelized set), each validated on two
    synthetic 128x128 sequences of the val config's length (for the flow
    `task` the second with a stored flow, which the teacher's replaces)
    and checkpointed; then one more epoch, resumed from the last checkpoint
    with the optimizer state. K1 must launch `k1_per_step` times a
    driver step (0 where the data comes voxelized); the
    ckpt_paths file, val_loss.txt, the losses, each epoch's lr (the
    config's base lr times its scheduler's multiplier), the optimizer's
    step count after the resume, load_params_only of the last checkpoint,
    the resume, the checkpoint bytes against their tensors' bytes
    (_checkpoint_bound) and, for a model with BatchNorms, running
    statistics that moved are checked. Prints the driver's ms/step
    (beside the [slice] phase's `slice_ms` when given), the host's wait on
    the loader a step, checkpoint time and bytes, and the peak memory."""
    import contextlib
    import copy
    import io
    import shutil
    from v2v_tpu_torch.config import instantiate_from_config
    from v2v_tpu_torch.data.interface import ConcatDataset
    from v2v_tpu_torch.models.init import materialize
    from v2v_tpu_torch.training import train
    from v2v_tpu_torch.training.checkpoint import (all_ckpt_paths,
                                                   load_params_only)
    stage = copy.deepcopy(stage or FLAGSHIP_STAGE)
    stage["max_epochs"] = DRIVER_EPOCHS
    exp = f"chip_smoke_{tag}"
    cfg = {"experiment_name": exp, "seed": seed, "task": task,
           "check_val_every_n_epoch": 1,
           "module": copy.deepcopy(module or FLAGSHIP_MODULE),
           "train_stages": [stage]}
    data_cfg = stage["dataset"]["train"][0]
    hw = data_cfg.get("crop_size") or data_cfg["random_crop_size"]
    batch = stage["dataset"]["train_batch_size"]
    train_ds = (stand_in or _DriftingClips)(data_cfg, seed,
                                            DRIVER_BATCHES * batch)
    val_cfg = stage["dataset"]["val"][0]              # evaid, image_range 1
    val_ds = ConcatDataset([
        _SyntheticSequence(f"val{i}", seed + 30 + i,
                           val_cfg["sequence_length"], (hw, hw),
                           DRIVER_VAL_EVENTS, val_cfg,
                           flow=task == "flow" and i == 1)
        for i in range(2)])
    opt_cfg = train.make_optimizer(stage["optimizer"])
    sched = train.make_scheduler(stage["lr_scheduler"])
    root = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_")
    env = {"V2V_RANDOM_TEACHER": "1",
           "V2V_WEIGHTS_DIR": os.path.join(root, "no_weights")}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    _log(f"[{tag}] {exp}: {cfg['module']['model']['target']}, "
         f"{stage['optimizer']['target']} {stage['optimizer']['params']}, "
         f"{stage['lr_scheduler']['target']}, {DRIVER_EPOCHS} epochs of "
         f"{DRIVER_BATCHES} batches of {batch} stand-in clips, then 1 "
         f"resumed epoch; val on 2 sequences of "
         f"{val_cfg['sequence_length']} frames at {hw}x{hw}; root {root}")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        runs, logs = [], []
        for epochs in (DRIVER_EPOCHS, DRIVER_EPOCHS + 1):
            stage["max_epochs"] = epochs
            logs.append(io.StringIO())
            with contextlib.redirect_stdout(_Tee(sys.stdout, logs[-1])):
                runs.append(train.main(cfg, DRIVER_BATCHES, root, dev,
                                       train_ds, val_ds))
        torch.cuda.synchronize()
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = DRIVER_BATCHES * (DRIVER_EPOCHS + 1)
        _require(launches["simulate_batch"] == k1_per_step * steps,
                 f"{tag}: K1 launched {launches['simulate_batch']} times in "
                 f"{steps} driver steps, want {k1_per_step} a step")
        paths = all_ckpt_paths(exp, root)
        _require(len(paths) == DRIVER_EPOCHS + 1 and paths[-1].endswith(
            f"epoch_{DRIVER_EPOCHS:04d}.pth"),
            f"{tag}: ckpt_paths holds {paths}")
        with open(os.path.join(root, "tensorboard_logs", exp,
                               "val_loss.txt")) as f:
            val = [float(line.rsplit(": ", 1)[1]) for line in f
                   if line.strip()]
        _require(len(val) == DRIVER_EPOCHS + 1
                 and all(math.isfinite(v) for v in val),
                 f"{tag}: val_loss.txt holds {val}")
        losses = {e: v for r in runs for e, v in r["losses"].items()}
        _require(sorted(losses) == list(range(DRIVER_EPOCHS + 1))
                 and all(len(v) == DRIVER_BATCHES and all(map(math.isfinite,
                                                              v))
                         for v in losses.values()),
                 f"{tag}: losses {losses}")
        text = [lg.getvalue() for lg in logs]
        lrs = {int(e): lr for e, lr in re.findall(
            r"^Stage \d+, epoch (\d+): lr=(\S+)$", "".join(text), re.M)}
        want_lrs = {e: f"{opt_cfg.base_lr * sched(e):.3e}"
                    for e in range(DRIVER_EPOCHS + 1)}
        _require(lrs == want_lrs, f"{tag}: lr by epoch {lrs}, want "
                                  f"{want_lrs}")
        printed = {int(m) for m in re.findall(r"^Stage \d+, epoch (\d+):",
                                              text[1], re.M)}
        _require(printed == {DRIVER_EPOCHS}
                 and f"epoch_{DRIVER_EPOCHS - 1:04d}.pth at epoch "
                     f"{DRIVER_EPOCHS}" in text[1]
                 and "Restored the optimizer state" in text[1],
                 f"{tag}: the resumed run printed epochs {sorted(printed)}")
        last = runs[-1]
        opt_steps = {float(st["step"]) for st in
                     last["optimizer"].state.values()}
        _require(opt_steps == {float(steps)},
                 f"{tag}: the optimizer's step counts after the resume "
                 f"{opt_steps}, want {steps}")
        fresh = materialize(
            lambda: instantiate_from_config(cfg["module"]["model"]), dev,
            torch.Generator(device=dev).manual_seed(seed + 99))
        load_params_only(paths[-1], fresh)
        final = last["model"].state_dict()
        _require(all(torch.equal(v, final[k])
                     for k, v in fresh.state_dict().items()),
                 f"{tag}: load_params_only of the last checkpoint differs "
                 f"from the driver's final parameters")
        optimizer = type(last["optimizer"]).__name__
        low, high = _checkpoint_bound(torch, last["model"], last["optimizer"])
        ckpt_bytes = runs[-1]["timings"]["checkpoint_bytes"]
        _require(all(low <= x <= high for x in ckpt_bytes),
                 f"{tag}: checkpoints of {ckpt_bytes} bytes, want "
                 f"{low}-{high}")
        bn_var = {k: float((v - 1).abs().max()) for k, v in final.items()
                  if k.endswith("running_var")}
        _require(all(v > 0 and math.isfinite(v) for v in bn_var.values()),
                 f"{tag}: BatchNorm running variances did not move")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    step_ms = [r["timings"]["step_ms"] for r in runs]
    wait_ms = [x for r in runs for x in r["timings"]["loader_wait_ms"]]
    after_first = [x for ms in step_ms for x in ms[1:]]
    ckpt_s = [x for r in runs for x in r["timings"]["checkpoint_s"]]
    ckpt_b = [x for r in runs for x in r["timings"]["checkpoint_bytes"]]
    ms = statistics.median(after_first)
    # the driver reads a loss only every 50 steps and at an epoch's end,
    # so where a step never waits for the card the host runs ahead and
    # one step's host time holds another's card time: the mean of the
    # steps that are not an epoch's first (those wait on the loader's
    # restart) is the card's rate
    mean_ms = statistics.mean(x for ms in step_ms for i, x in enumerate(ms)
                              if i % DRIVER_BATCHES)
    _log(f"[{tag}] losses by epoch: " + "; ".join(
        f"{e}: {', '.join(f'{x:.5f}' for x in v)}"
        for e, v in sorted(losses.items())) + f"; val losses "
        f"{', '.join(f'{v:.5f}' for v in val)}; lr by epoch "
        + ", ".join(f"{e}: {lr}" for e, lr in sorted(lrs.items())))
    _log(f"[{tag}] ms/step through the driver, median after each run's "
         f"first step: {ms:.1f}; mean of the steps after each epoch's "
         f"first {mean_ms:.1f} (all: "
         + " | ".join(", ".join(f"{x:.1f}" for x in ms_) for ms_ in step_ms)
         + ")" + ("" if slice_ms is None else
                  f"; the [slice] phase's step alone {slice_ms:.1f}"))
    _log(f"[{tag}] host wait on the loader and the prefetch a step (ms): "
         f"median {statistics.median(wait_ms):.2f}, max {max(wait_ms):.2f} "
         f"(all: {', '.join(f'{x:.2f}' for x in wait_ms)})")
    if bn_var:
        _log(f"[{tag}] {len(bn_var)} BatchNorm running variances moved "
             f"from 1 by {min(bn_var.values()):.4f}-"
             f"{max(bn_var.values()):.4f}")
    _log(f"[{tag}] checkpoints: {len(ckpt_s)} saved, "
         f"{', '.join(f'{s:.3f}' for s in ckpt_s)} s, "
         f"{', '.join(str(b) for b in ckpt_b)} bytes (predicted "
         f"{low}-{high}); max_memory_allocated "
         f"{peak:.2f} GiB; resumed from epoch_{DRIVER_EPOCHS - 1:04d}.pth "
         f"at epoch {DRIVER_EPOCHS} with {optimizer} at step {steps}; "
         f"launches {launches}")
    return launches, ms


def phase_etnet_dropout(torch, dev, seed, profile=False):
    """ETNet's dropout at the train config's full width (B 6, T 40,
    128x128, bf16, dropout 0.1) on the card: one train step's mask draws
    (each redrawn from a copy of the generator's state to count what it
    kept) must keep a share within KEEP_BAND of 0.9 at every site, and
    the step's loss must repeat bit for bit at the same step seed and
    differ at another. The optimizer's lr is 0, so the three steps see
    the same weights. `profile` profiles one more step."""
    import v2v_tpu_torch.models.eitr as eitr
    from v2v_tpu_torch.losses.lpips import LPIPS
    from v2v_tpu_torch.training.interface import ModelInterface
    from v2v_tpu_torch.training.optim import AdamW
    from v2v_tpu_torch.training.raft import random_teacher
    from v2v_tpu_torch.training.steps import make_train_step
    from v2v_tpu_torch.training.train import sim_config_from_dataset
    tag = "etnet-train"
    ds = ETNET_TRAIN_STAGE["dataset"]
    data_cfg = ds["train"][0]
    b, t, hw = (ds["train_batch_size"], data_cfg["sequence_length"],
                data_cfg["crop_size"])
    g = torch.Generator(device=dev).manual_seed(seed)
    iface = ModelInterface(ETNET_TRAIN_MODULE, dev, generator=g,
                           lpips=LPIPS("vgg", dev, generator=g),
                           teacher=random_teacher(12, dev, generator=g))
    n_params = sum(p.numel() for p in iface.model.parameters())
    _require(n_params == ETNET_PARAMS,
             f"{tag}: the model has {n_params} parameters")
    step = make_train_step(
        iface, AdamW(lr=0.0, weight_decay=0.0).make(
            iface.model.parameters()),
        sim_config_from_dataset(data_cfg), data_cfg["num_bins"],
        data_cfg["frames_per_bin"])
    video = _drifting_video(b, t * data_cfg["num_bins"] + 1, hw, hw,
                            seed + 5, dev)
    batch = {"video": video,
             "data_source_idx": torch.full((b,), 11, dtype=torch.int64)}
    draws = []
    orig = eitr.dropout

    def recording(x, p, training, generator):
        if training and p > 0:
            copy_g = torch.Generator(device=generator.device)
            copy_g.set_state(generator.get_state())
            keep = torch.rand(x.shape, generator=copy_g, device=x.device,
                              dtype=torch.float32) >= p
            draws.append((keep.numel(), int(keep.sum())))
        return orig(x, p, training, generator)

    eitr.dropout = recording
    try:
        first, _ = step(batch, torch.Generator(device=dev).manual_seed(seed))
    finally:
        eitr.dropout = orig
    again, _ = step(batch, torch.Generator(device=dev).manual_seed(seed))
    other, _ = step(batch,
                    torch.Generator(device=dev).manual_seed(seed + 1))
    shares = [kept / n for n, kept in draws]
    # 3 streams x (3 encoder layers x 4 + 2 decoder layers x 6), one
    # draw each over the tail's B*T frames
    _log(f"[{tag}] dropout {ETNET_DROPOUT}: {len(draws)} mask draws in one "
         f"step, {min(n for n, _ in draws)}-{max(n for n, _ in draws)} "
         f"elements each, kept share {min(shares):.6f}-{max(shares):.6f} "
         f"(band {1 - ETNET_DROPOUT} +- {KEEP_BAND}); loss at step seed "
         f"{seed} {float(first)!r} then {float(again)!r}, at {seed + 1} "
         f"{float(other)!r}")
    _require(len(draws) == 3 * (3 * 4 + 2 * 6),
             f"{tag}: {len(draws)} dropout draws in a step")
    _require(all(abs(x - (1 - ETNET_DROPOUT)) <= KEEP_BAND for x in shares),
             f"{tag}: a kept share is outside the band")
    _require(torch.equal(first, again), f"{tag}: the same step seed gave "
                                        f"other loss bits")
    _require(not torch.equal(first, other), f"{tag}: another step seed "
                                            f"gave the same loss")
    if profile:
        _profile(torch, f"{tag}-profile", lambda: step(
            batch, torch.Generator(device=dev).manual_seed(seed)))


def phase_ddp(torch, dev, seed, steps=2, module=None, stage=None,
              hyper_beta=None):
    """Data parallelism on the card: a process group of one on NCCL
    (tcp://localhost), and `steps` train steps of a config's full-width
    model at B=2, T=4, 64x64, bf16 (default ETNet at dropout 0 with
    AdamW) with the gradients reduced by
    parallel/mesh.py::all_reduce_gradients, against the same steps
    without a group. At world 1 the mean is the gradient itself, so the
    parameters agree up to the card's run-to-run nondeterminism: 2 lr a
    step and 1% (Adam's move, at most ~1.0014 lr a step over two steps,
    where a gradient that rounds to zero flips sign).
    A model with BatchNorm (HyperE2VID, its curriculum at `hyper_beta`)
    takes TorchBatchNorm's global-moment path in the group: at world 1
    the driver keeps each process's own moments, so the phase has
    mesh.group_live report the group live, and every BatchNorm call
    all-reduces its moments (forward and backward) over NCCL; its running
    statistics must move and agree with the run without a group.
    The reduce must have issued NCCL all-reduces; the group is destroyed
    at the end."""
    import copy
    import socket
    import torch.distributed as dist
    from v2v_tpu_torch.losses.lpips import LPIPS
    from v2v_tpu_torch.models.submodules import TorchBatchNorm
    from v2v_tpu_torch.parallel import mesh
    from v2v_tpu_torch.training.interface import ModelInterface
    from v2v_tpu_torch.training.raft import random_teacher
    from v2v_tpu_torch.training.steps import make_train_step
    from v2v_tpu_torch.training.train import (make_optimizer,
                                              sim_config_from_dataset)
    tag = "ddp"
    module = copy.deepcopy(module or ETNET_TRAIN_MODULE)
    stage = stage or ETNET_TRAIN_STAGE
    if "eitr_kwargs" in module["model"]["params"]:
        module["model"]["params"]["eitr_kwargs"]["dropout"] = 0.0
    module["loss"]["temporal_consistency_L0"] = 2
    data_cfg = stage["dataset"]["train"][0]
    opt_cfg = make_optimizer(stage["optimizer"])
    b, t, hw = 2, 4, 64
    kw = {} if hyper_beta is None else {"hyper_beta": hyper_beta}
    video = _drifting_video(b, t * data_cfg["num_bins"] + 1, hw, hw,
                            seed + 6, dev)
    batch = {"video": video,
             "data_source_idx": torch.full((b,), 11, dtype=torch.int64)}
    calls = []
    all_reduce, group_live = dist.all_reduce, mesh.group_live

    def counting(tensor, *a, **k):
        calls.append(tensor.numel())
        return all_reduce(tensor, *a, **k)

    runs = []
    for grouped in (False, True):
        g = torch.Generator(device=dev).manual_seed(seed)
        iface = ModelInterface(module, dev, generator=g,
                               lpips=LPIPS("vgg", dev, generator=g),
                               teacher=random_teacher(12, dev, generator=g))
        params = list(iface.model.parameters())
        bns = [m for m in iface.model.modules()
               if isinstance(m, TorchBatchNorm)]
        stats0 = [m.running_var.clone() for m in bns]
        step = make_train_step(iface, opt_cfg.make(params),
                               sim_config_from_dataset(data_cfg),
                               data_cfg["num_bins"],
                               data_cfg["frames_per_bin"])
        if grouped:
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            dist.init_process_group("nccl",
                                    init_method=f"tcp://localhost:{port}",
                                    rank=0, world_size=1, device_id=dev)
            dist.all_reduce = counting
            mesh.group_live = dist.is_initialized
        try:
            _require(mesh.world_size() == 1
                     and dist.is_initialized() == grouped,
                     f"{tag}: process group state")
            if grouped:
                _require(dist.get_backend() == "nccl", f"{tag}: backend "
                                                       f"{dist.get_backend()}")
            losses, norms = [], []
            for i in range(steps):
                loss, aux = step(batch, torch.Generator(
                    device=dev).manual_seed(seed + i), **kw)
                losses.append(float(loss))
                norms.append(float(aux["grad_norm"]))
            torch.cuda.synchronize()
        finally:
            if grouped:
                dist.all_reduce, mesh.group_live = all_reduce, group_live
                dist.destroy_process_group()
        moved = [float((m.running_var - v).abs().max())
                 for m, v in zip(bns, stats0)]
        runs.append((losses, [p.detach().clone() for p in params],
                     [m.running_var.clone() for m in bns], moved, norms))
    (l0, p0, s0, m0, n0), (l1, p1, s1, m1, n1) = runs
    perr = max(float((a - c).abs().max()) for a, c in zip(p0, p1))
    tol = 2 * opt_cfg.base_lr * steps * 1.01
    # TorchBatchNorm's all-reduces carry 2 C + 1 numbers: sums, sums of
    # squares and the count; one a call forward and one backward
    bn_sizes = {2 * m.num_features + 1 for m in bns}
    n_bn = sum(1 for n in calls if n in bn_sizes)
    want_bn = 2 * len(bns) * t * steps
    serr = max((float((a - c).abs().max() / c.abs().max())
                for a, c in zip(s0, s1)), default=0.0)
    name = type(iface.model).__name__
    _log(f"[{tag}] NCCL group of 1: {steps} {name} step(s) (B={b}, T={t}, "
         f"{hw}x{hw}, bf16, {stage['optimizer']['target'].split('.')[-1]} "
         f"lr {opt_cfg.base_lr}), losses "
         f"{', '.join(f'{x:.6f}' for x in l1)} against "
         f"{', '.join(f'{x:.6f}' for x in l0)} without a group, grad norms "
         f"{', '.join(f'{x:.6f}' for x in n1)} against "
         f"{', '.join(f'{x:.6f}' for x in n0)}; "
         f"{len(calls)} NCCL all-reduces ({sum(calls)} elements), "
         f"{len(calls) / steps:.0f} a step, {n_bn} of them BatchNorm "
         f"moments; max|param diff| {perr:.3e} (tolerance {tol:.1e}); "
         f"group destroyed: {not dist.is_initialized()}")
    if bns:
        _log(f"[{tag}] {name}: {len(bns)} BatchNorms, running var moved by "
             f"up to {', '.join(f'{x:.4f}' for x in m1)} (without a group "
             f"{', '.join(f'{x:.4f}' for x in m0)}); relative max|diff| "
             f"{serr:.2e}")
    _require(all(math.isfinite(x) for x in l0 + l1), f"{tag}: loss")
    _require(all(abs(a - c) <= 1e-3 * abs(c) for a, c in zip(l1, l0)),
             f"{tag}: the losses differ")
    # the card's backward is not deterministic (atomics in cuDNN's
    # weight gradients); a step's gradient norm moves by far less than 1%
    _require(all(abs(a - c) <= 1e-2 * abs(c) for a, c in zip(n1, n0)),
             f"{tag}: the gradient norms differ")
    _require(perr <= tol, f"{tag}: the parameters differ")
    n_params = sum(p.numel() for p in p0)
    _require(len(calls) >= 2 * steps and sum(calls) >= steps * n_params,
             f"{tag}: the gradients did not go through NCCL")
    _require(n_bn == want_bn, f"{tag}: {n_bn} BatchNorm all-reduces, want "
                              f"{want_bn}")
    _require(all(x > 0 and math.isfinite(x) for x in m0 + m1),
             f"{tag}: BatchNorm running statistics did not move")
    # the moments in another order (sums of squares): float32 rounding,
    # through a bf16 forward
    _require(serr <= 1e-2, f"{tag}: BatchNorm running statistics differ")
    _require(not dist.is_initialized(), f"{tag}: the group outlived the "
                                        f"phase")


def _write_memmap(root, seed, hw, frames, n_events, duration=2.0):
    """An RPG MemMap recording (the layout data/legacy.py::MemMapDataset
    reads) written with numpy from `seed` into `root`: `n_events` uniform
    events over `duration` seconds (t.npy, xy.npy, p.npy), `frames` uint8
    images stamped evenly over it (images.npy (N,H,W,1), timestamps.npy)
    and a smooth optic flow a frame (optic_flow.npy (N,2,H,W), px/s). It
    stands in for a recording: none is in the repository."""
    import numpy as np
    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(root, exist_ok=True)
    np.save(os.path.join(root, "t.npy"),
            np.sort(rng.uniform(0.0, duration, n_events)))
    np.save(os.path.join(root, "xy.npy"), np.stack(
        [rng.integers(0, w, n_events), rng.integers(0, h, n_events)],
        axis=1).astype(np.int16))
    np.save(os.path.join(root, "p.npy"),
            rng.integers(0, 2, n_events).astype(np.uint8))
    np.save(os.path.join(root, "images.npy"),
            rng.integers(0, 256, (frames, h, w, 1), dtype=np.uint8))
    np.save(os.path.join(root, "timestamps.npy"),
            np.linspace(0.0, duration, frames))
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    flow = np.stack([np.sin(3 * yy), np.cos(2 * xx)]).astype(np.float32)
    np.save(os.path.join(root, "optic_flow.npy"),
            np.repeat(flow[None] * 20.0, frames, axis=0))


class _SyntheticEventSequence:
    """One sequence of `frames` frames held in memory, in the sample
    contract of TestH5EventDataset (frame (T,H,W,1) in [0,255], events a
    list of T float64 (N,5) arrays [x, y, t, 2p-1, 0]): a drifting
    texture as GT and `events_per_frame` uniform random events a frame,
    stamped in absolute seconds (from 1.6e9, 30 frames a second, as raw h5
    captures are), from numpy with `seed`. It stands in for an h5 file:
    the card's machine has no h5py."""

    def __init__(self, name, seed, frames, hw, events_per_frame, data_cfg):
        self.name, self.seed, self.frames, self.hw = name, seed, frames, hw
        self.events_per_frame = events_per_frame
        self.data_cfg = data_cfg

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        import numpy as np
        from v2v_tpu_torch.data.sources import DATA_SOURCES
        rng = np.random.default_rng(self.seed)
        h, w = self.hw
        cell = 16
        coarse = rng.random((h // cell + 2, w // cell + 2)) * 255.0
        texture = np.kron(coarse, np.ones((cell, cell)))
        frames, events = [], []
        n = self.events_per_frame
        for t in range(self.frames):
            dy, dx = t % cell, (2 * t) % cell
            frames.append(texture[dy:dy + h, dx:dx + w])
            events.append(np.stack([
                rng.integers(0, w, n).astype(np.float64),
                rng.integers(0, h, n).astype(np.float64),
                1.6e9 + np.sort(rng.uniform(t / 30.0, (t + 1) / 30.0, n)),
                rng.integers(0, 2, n) * 2.0 - 1.0, np.zeros(n)], axis=1))
        return {
            "frame": np.stack(frames)[..., None].astype(np.float32),
            "events": events,
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
    frame (`kernel` None: no kernel of the port launches). Every
    prediction is finite; a model whose output ends in a sigmoid
    (ETNet's) must also predict in [0, 1] before the harness clips.
    HyperE2VID's has no final activation, so no range holds for it. A
    model with a flow output (E2VID++) must give a finite (B, 2, H, W)
    flow each frame, which the harness does not score."""
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
    times, outs, flows = [], [], []

    def timed_forward(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, states = type(model).forward(model, *args, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out["image"].detach().clone())
        if "flow" in out:
            flows.append((tuple(out["flow"].shape),
                          bool(torch.isfinite(out["flow"]).all())))
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
    want = {"upsample2x_bilinear": _upsample_decoders(model) * n_frames}
    if kernel is not None:
        want[kernel] = per_frame * n_frames
    _require_launches(f"{tag} ({n_frames} frames)", launches, **want)
    _require(len(outs) == n_frames, f"{tag}: {len(outs)} model steps")
    if flows:
        want = (1, 2) + EVAL_HW
        _log(f"[{tag}] flow output: {len(flows)} frames, shapes "
             f"{sorted(set(f[0] for f in flows))}, finite "
             f"{all(f[1] for f in flows)}")
        _require(len(flows) == n_frames and all(
            f == (want, True) for f in flows),
            f"{tag}: the flow output is not a finite {want} each frame")
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


def phase_nernet_reference(torch, dev, seed):
    """[nernet-reference]: test_nernet_original.yaml's NerNet at full
    width on two sequences of 3 frames at 64x80 (2,000 events a frame,
    near EVAID's density), through forward_sequence_nernet on the card
    against the CPU, same weights and events, float32, TF32 off: the
    predictions within EVAL_REF_ATOL and the first frame's voxel within
    NERNET_VOXEL_ATOL. The scatter (scatter_rows) sums each pixel's rows
    in event order on both, so on the same keys and rows the card's sums
    equal the CPU's bit for bit."""
    from v2v_tpu_torch.models.nernet import scatter_rows
    from v2v_tpu_torch.training.interface import ModelInterface
    tag = "nernet-reference"
    _tf32(torch, False)
    cpu = torch.device("cpu")
    frames, hw = 3, (64, 80)
    module = dict(NERNET_CONFIG["module"], loss={})
    seqs = [_SyntheticEventSequence(
        f"reference{i}", seed + 40 + i, frames, hw, 2000,
        NERNET_CONFIG["test_stage"]["test"][0])[0] for i in range(2)]
    runs, weights = [], None
    for d in (dev, cpu):
        iface = ModelInterface(
            module, d, generator=torch.Generator(device=d).manual_seed(seed))
        if weights is None:
            weights = {k: v.to(cpu)
                       for k, v in iface.model.state_dict().items()}
        else:
            iface.model.load_state_dict(weights)
        _zero_launches()
        preds = [iface.forward_sequence_nernet(
            sq["events"], iface.init_state(1, *hw))[0].to(cpu)
            for sq in seqs]
        first = seqs[0]["events"][0].copy()
        first[:, 2] -= first[0, 2]
        with torch.no_grad():
            vox = iface.model.representation(
                torch.as_tensor(first, dtype=torch.float32, device=d), *hw)
        runs.append((torch.cat(preds), vox.to(cpu), _read_launches()))
    (pc, vxc, lc), (ph, vxh, lh) = runs
    err, verr = float((pc - ph).abs().max()), float((vxc - vxh).abs().max())
    g = torch.Generator().manual_seed(seed)
    n_pix = 2 * hw[0] * hw[1]
    pix = torch.randint(0, n_pix, (2000,), generator=g)
    rows = torch.randn(2000, 5, generator=g)
    scatter_cpu = scatter_rows(pix, rows, n_pix)
    scatter_dev = scatter_rows(pix.to(dev), rows.to(dev), n_pix).to(cpu)
    same = torch.equal(scatter_cpu, scatter_dev)
    _log(f"[{tag}] {type(iface.model).__name__} {hw[0]}x{hw[1]}, "
         f"{len(seqs)} sequences x {frames} frames, 2000 events a frame: "
         f"max|pred cuda - pred cpu| {err:.3e} (tolerance {EVAL_REF_ATOL}); "
         f"voxel {verr:.3e} (tolerance {NERNET_VOXEL_ATOL}; |voxel| up to "
         f"{float(vxh.abs().max()):.3f}); scatter_rows on the same keys and "
         f"rows equal on card and CPU: {same}; launches on the card "
         f"{ {k: v for k, v in lc.items() if v} }")
    _require(bool(torch.isfinite(pc).all()), f"{tag}: non-finite")
    _require(float(vxh.abs().max()) > 0, f"{tag}: an empty voxel")
    _require(err <= EVAL_REF_ATOL, f"{tag}: card and CPU differ")
    _require(verr <= NERNET_VOXEL_ATOL, f"{tag}: the voxels differ")
    _require(same, f"{tag}: the scatter's bits differ between card and CPU")
    _require_launches(f"{tag} (card)", lc, upsample2x_bilinear=(
        _upsample_decoders(iface.model) * frames * len(seqs)))
    _require_launches(f"{tag} (CPU)", lh)
    _tf32(torch, True)


def phase_nernet_eval(torch, dev, seed, profile=False):
    """[nernet-eval]: configs/test_nernet_original.yaml's NerNet at full
    width through the port's run_test on two synthetic EVAID 720x1280
    raw-event sequences of EVAL_FRAMES frames, EVAL_EVENTS_PER_FRAME
    events a frame stamped in absolute seconds, random weights and
    LPIPS-Alex trunk. Timed a frame (synchronized), the voxelization's
    part (ValueLayer and the scatter, CUDA events) beside it; no kernel of
    the port launches; finite predictions and metrics; the state reset at
    the second sequence; one frame run twice from one state gives equal
    bits."""
    from torch.profiler import record_function
    from v2v_tpu_torch.data.interface import ConcatDataset
    from v2v_tpu_torch.eval import harness
    from v2v_tpu_torch.losses.lpips import LPIPS
    from v2v_tpu_torch.training.interface import ModelInterface
    tag = "nernet-eval"
    cfg = json.loads(json.dumps(NERNET_CONFIG))
    cfg.pop("test_output_dir")     # PNG output needs cv2, absent here
    data_cfg = cfg["test_stage"]["test"][0]          # evaid
    g = torch.Generator(device=dev).manual_seed(seed)
    lp = LPIPS("alex", dev, generator=g)
    iface = ModelInterface(cfg["module"], dev, generator=g, lpips=lp,
                           lpips_test=lp)
    model = iface.model
    n_params = sum(p.numel() for p in model.parameters())
    _require(n_params == NERNET_PARAMS,
             f"{tag}: the model has {n_params} parameters")
    seqs = [_SyntheticEventSequence(f"synthetic{i}", seed + 20 + i,
                                    EVAL_FRAMES, EVAL_HW,
                                    EVAL_EVENTS_PER_FRAME, data_cfg)
            for i in range(2)]
    quant = model.representation.quantization_layer
    times, vox_ms, outs, pending = [], [], [], []

    def timed_quant(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        with record_function("v2v.voxelize"):
            vox = type(quant).forward(quant, *args, **kw)
        ev[1].record()
        pending.append(ev)
        return vox

    def timed_forward(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, state = type(model).forward(model, *args, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vox_ms.append(pending[-1][0].elapsed_time(pending[-1][1]))
        outs.append(out["image"].detach().clone())
        return out, state

    model.forward, quant.forward = timed_forward, timed_quant
    _log(f"[{tag}] {type(model).__name__} {n_params} params at "
         f"{EVAL_HW[0]}x{EVAL_HW[1]}, 2 sequences x {EVAL_FRAMES} frames, "
         f"{EVAL_EVENTS_PER_FRAME} raw events a frame, random weights and "
         f"LPIPS-Alex trunk")
    root = tempfile.mkdtemp(prefix="chip_smoke_nernet_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    try:
        final = harness.run_test(iface, cfg, root=root,
                                 dataset=ConcatDataset(seqs))
    finally:
        del model.forward, quant.forward
    wall = time.perf_counter() - t0
    launches = _read_launches()
    n_frames = 2 * EVAL_FRAMES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _require_launches(f"{tag} ({n_frames} frames)", launches,
                      upsample2x_bilinear=_upsample_decoders(model)
                      * n_frames)
    _require(len(outs) == n_frames, f"{tag}: {len(outs)} model steps")
    _require(all(o.shape == (1, 1) + EVAL_HW for o in outs),
             f"{tag}: prediction shapes {outs[0].shape}")
    _require(all(bool(torch.isfinite(o).all()) for o in outs),
             f"{tag}: non-finite pred")
    # the harness reset the state at the second sequence: its first frame
    # equals a run from a fresh state; that frame again from the same
    # state gives the same bits (the scatter's fixed order)
    first = seqs[1][0]["events"][:1]
    fresh = [iface.forward_sequence_nernet(
        first, iface.init_state(1, *EVAL_HW)) for _ in range(2)]
    reset_err = float((fresh[0][0][0, 0, ..., 0]
                       - outs[EVAL_FRAMES][0, 0]).abs().max())
    repeat = torch.equal(fresh[0][0], fresh[1][0])
    carried, _ = iface.forward_sequence_nernet(first, fresh[0][1])
    carried_diff = float((carried - fresh[0][0]).abs().max())
    _log(f"[{tag}] model output range [{min(float(o.min()) for o in outs):.4f}"
         f", {max(float(o.max()) for o in outs):.4f}]; sequence 2, frame 1: "
         f"max|harness - fresh state| {reset_err:.3e}, the same frame again "
         f"equal bits: {repeat}; on a carried state it differs by "
         f"{carried_diff:.3e}")
    _require(reset_err <= 1e-5, f"{tag}: the state was not reset")
    _require(repeat, f"{tag}: a frame run twice gave other bits")
    _require(carried_diff > 0, f"{tag}: the state does not carry")
    with open(os.path.join(root, "tensorboard_logs",
                           cfg["experiment_name"], "test_metrics.txt")) as f:
        metrics = {k: float(v) for k, v in
                   (line.rsplit(": ", 1) for line in f if line.strip())}
    _require(len(metrics) == 6 and all(math.isfinite(v)
                                       for v in metrics.values()),
             f"{tag}: test_metrics.txt holds {metrics}")
    _log(f"[{tag}] test_metrics.txt: " + ", ".join(
        f"{k} {v:.5f}" for k, v in sorted(metrics.items())))
    ms = statistics.median(times[1:])
    vms = statistics.median(vox_ms[1:])
    _log(f"[{tag}] ms/frame after the first: {ms:.1f} (min "
         f"{min(times[1:]):.1f}, max {max(times[1:]):.1f}, first "
         f"{times[0]:.1f}); the voxelization (ValueLayer + scatter) "
         f"{vms:.2f} ms a frame, {vms / ms:.3f} of it; run_test {wall:.1f} "
         f"s for {n_frames} frames; max_memory_allocated {peak:.2f} GiB; "
         f"launches {launches}")
    if profile:
        quant.forward = timed_quant
        try:
            wall_ms, busy, spans = _profile(
                torch, f"{tag}-profile",
                lambda: iface.forward_sequence_nernet(first, fresh[0][1]))
        finally:
            del quant.forward
        vox = spans.get("v2v.voxelize", 0.0)
        _log(f"[{tag}-profile] the voxelization's GPU span {vox:.2f} ms: "
             f"{vox / busy:.3f} of the busy time, {vox / wall_ms:.3f} of "
             f"the wall")
    return launches, final


def phase_esim_reference(torch, dev, seed):
    """[esim-reference]: phase_reference on the ESIM config's module (the
    flagship's, cut to width 4, float32, L0 2) with a batch of two
    stand-in ESIM items of 4 time steps at 64x64: their events come
    voxelized, their stored flow is replaced by the teacher's; the
    tolerances of [zoo-reference]."""
    import random
    import numpy as np
    from v2v_tpu_torch.data.interface import collate
    data_cfg = dict(ESIM_TRAIN_STAGE["dataset"]["train"][0],
                    sequence_length=4, random_crop_size=64)
    items = _ESIMStandIn(data_cfg, seed, 2)
    random.seed(seed)
    np.random.seed(seed)
    b = collate([items[i] for i in range(2)])
    batch = {k: torch.from_numpy(b[k]) for k in ("events", "frame", "flow")}
    phase_reference(torch, dev, seed, ESIM_TRAIN_MODULE, "esim-reference",
                    batch=batch)


def phase_flow_reference(torch, dev, seed):
    """One float32 EVFlowNet flow train step (the train config's model,
    which fixes its own width, with the config's RAFT-large teacher at 12
    updates, random; 2 clips of 4 time steps at 64x64 and the extra
    frame) on the card against the same step on the CPU, same weights,
    teacher and voxels, TF32 off: the teacher's pseudo-GT, the batched
    forward, the flow L1, the backward and Adam. The CPU path is the one
    the tier-1 tests hold against JAX."""
    import copy
    from v2v_tpu_torch.ops.voxel import SimConfig
    from v2v_tpu_torch.training.flow_interface import FlowModelInterface
    from v2v_tpu_torch.training.optim import Adam
    from v2v_tpu_torch.training.raft import random_teacher
    from v2v_tpu_torch.training.steps import make_train_step, synthesize_batch
    tag = "flow-reference"
    _tf32(torch, False)
    cpu = torch.device("cpu")
    lr, t = 1e-4, 4
    mod = json.loads(json.dumps(EVFLOW_TRAIN_MODULE))
    mod.pop("compute_dtype")
    g = torch.Generator(device=dev).manual_seed(seed)
    video = _drifting_video(2, t * 5 + 1, 64, 64, seed + 7, dev)
    events, frame = synthesize_batch(video, g, SimConfig(), 5, 1,
                                     extra_frame=True)
    _require(frame.shape[1] == t + 1, f"{tag}: {frame.shape[1]} frames")
    teacher = random_teacher(12, cpu, torch.Generator().manual_seed(seed),
                             source="raft_large")
    runs = []
    for d in (dev, cpu):
        iface = FlowModelInterface(mod, d,
                                   teacher=copy.deepcopy(teacher).to(d))
        iface.teacher_dtype = None
        if d == dev:
            state = {k: v.to(cpu) for k, v in iface.model.state_dict().items()}
        else:
            iface.model.load_state_dict(state)
        opt = Adam(lr=lr, amsgrad=True).make(iface.model.parameters())
        step = make_train_step(iface, opt)
        batch = {"events": events.to(d), "frame": frame.to(d)}
        target = iface.prepare_flow(batch)["flow"].to(cpu)
        loss, aux = step(batch)
        runs.append((float(loss), float(aux["grad_norm"]),
                     {k: v.detach().to(cpu)
                      for k, v in iface.model.state_dict().items()}, target))
    (lc, gc, pc, fc), (lh, gh, ph, fh) = runs
    perr = max(float((pc[k] - ph[k]).abs().max()) for k in pc)
    ferr = float((fc - fh).abs().max())
    _log(f"[{tag}] EVFlowNet {sum(v.numel() for v in pc.values())} params "
         f"+ random RAFT-large (12 updates), B=2 T={t} 64x64, float32: "
         f"teacher flow max|cuda - cpu| {ferr:.2e} px (|flow| up to "
         f"{float(fh.abs().max()):.3f}); loss cuda {lc:.6f} cpu {lh:.6f}  "
         f"grad_norm cuda {gc:.6f} cpu {gh:.6f}  max|state_dict diff| "
         f"after step {perr:.2e}")
    _require(math.isfinite(lc) and float(fh.abs().max()) > 0,
             f"{tag}: loss or teacher flow")
    # 12 refinements of float32 convs in other orders: ~1e-5 px, as the
    # CPU port against JAX (tests/test_torch_raft_large.py)
    _require(ferr <= 1e-3 * (1 + float(fh.abs().max())),
             f"{tag}: the teacher's flow differs between card and CPU")
    _require(abs(lc - lh) <= 1e-4 * abs(lh), f"{tag}: loss differs")
    _require(abs(gc - gh) <= 1e-3 * abs(gh), f"{tag}: grad norm differs")
    _require(perr <= 2 * lr * (1 + 1e-3), f"{tag}: params after the step "
                                          f"differ")
    _tf32(torch, True)


def phase_eraft_reference(torch, dev, seed):
    """One float32 ERAFT flow train step (the train config's model at
    full width and 12 refinements, with the config's RAFT-large teacher at
    12 updates, random; 2 clips of 3 time steps at 64x64 with the extra
    frame and the extra leading event group) on the card against the same
    step on the CPU, same weights, teacher and voxels, TF32 off: first the
    eval-mode flows and carry, then the teacher's pseudo-GT, the 3 pairs
    with cnet's live BatchNorm, the flow L1, the backward and Adam. The
    CPU path is the one the tier-1 tests hold against JAX."""
    import copy
    from v2v_tpu_torch.ops.voxel import SimConfig
    from v2v_tpu_torch.training.flow_interface import FlowModelInterface
    from v2v_tpu_torch.training.optim import Adam
    from v2v_tpu_torch.training.raft import random_teacher
    from v2v_tpu_torch.training.steps import make_train_step, synthesize_batch
    tag = "eraft-reference"
    _tf32(torch, False)
    cpu = torch.device("cpu")
    lr, t = 1e-4, 3
    mod = json.loads(json.dumps(ERAFT_TRAIN_MODULE))
    mod.pop("compute_dtype")
    g = torch.Generator(device=dev).manual_seed(seed)
    video = _drifting_video(2, (t + 1) * 5 + 1, 64, 64, seed + 9, dev)
    events, frame = synthesize_batch(video, g, SimConfig(), 5, 1,
                                     extra_frame=True, extra_evs=True)
    _require(events.shape[1] == frame.shape[1] == t + 1,
             f"{tag}: {events.shape[1]} event groups, {frame.shape[1]} "
             f"frames")
    teacher = random_teacher(12, cpu, torch.Generator().manual_seed(seed),
                             source="raft_large")
    runs = []
    for d in (dev, cpu):
        iface = FlowModelInterface(mod, d,
                                   teacher=copy.deepcopy(teacher).to(d))
        iface.teacher_dtype = None
        if d == dev:
            state = {k: v.to(cpu) for k, v in iface.model.state_dict().items()}
            n_params = sum(p.numel() for p in iface.model.parameters())
        else:
            iface.model.load_state_dict(state)
        with torch.no_grad():
            flows, carry = iface.forward_sequence(
                events.to(d), iface.init_state(2, 64, 64))
        opt = Adam(lr=lr, amsgrad=True).make(iface.model.parameters())
        step = make_train_step(iface, opt)
        batch = {"events": events.to(d), "frame": frame.to(d)}
        target = iface.prepare_flow(batch)["flow"].to(cpu)
        loss, aux = step(batch)
        runs.append((float(loss), float(aux["grad_norm"]),
                     {k: v.detach().to(cpu)
                      for k, v in iface.model.state_dict().items()}, target,
                     flows.to(cpu), carry.to(cpu)))
    (lc, gc, pc, tc, fc, cc), (lh, gh, ph, th, fh, ch) = runs
    _require(fc.shape == (2, t, 64, 64, 2) and cc.shape == (2, 8, 8, 2),
             f"{tag}: flows {tuple(fc.shape)}, carry {tuple(cc.shape)}")
    perr = max(float((pc[k] - ph[k]).abs().max()) for k in pc
               if "running" not in k and "num_batches" not in k)
    serr = max(float((pc[k] - ph[k]).abs().max()) for k in pc
               if "running" in k)
    terr = float((tc - th).abs().max())
    ferr = float((fc - fh).abs().max())
    cerr = float((cc - ch).abs().max())
    fmax = float(fh.abs().max())
    _require(n_params == ERAFT_PARAMS,
             f"{tag}: the model has {n_params} parameters")
    _log(f"[{tag}] ERAFT {n_params} params + random RAFT-large (12 "
         f"updates), B=2 T={t}+1 64x64, "
         f"float32: flow max|cuda - cpu| {ferr:.2e} px (|flow| up to "
         f"{fmax:.3f}), carry {cerr:.2e} px; teacher flow {terr:.2e} px; "
         f"loss cuda {lc:.6f} cpu {lh:.6f}  grad_norm cuda {gc:.6f} cpu "
         f"{gh:.6f}  max|param diff| after step {perr:.2e}  max|running "
         f"statistics diff| {serr:.2e}")
    _require(math.isfinite(lc) and fmax > 0, f"{tag}: loss or flow")
    # 12 refinements of float32 convs in other orders, as the CPU port
    # against JAX (tests/test_torch_eraft.py: 1e-3 at 12 refinements)
    _require(ferr <= 1e-3 * (1 + fmax) and cerr <= 1e-3 * (1 + fmax),
             f"{tag}: the flows differ between card and CPU")
    _require(terr <= 1e-3 * (1 + float(th.abs().max())),
             f"{tag}: the teacher's flow differs between card and CPU")
    _require(abs(lc - lh) <= 1e-4 * abs(lh), f"{tag}: loss differs")
    _require(abs(gc - gh) <= 1e-3 * abs(gh), f"{tag}: grad norm differs")
    _require(perr <= 2 * lr * (1 + 1e-3), f"{tag}: params after the step "
                                          f"differ")
    _require(serr <= 1e-4, f"{tag}: BatchNorm running statistics differ")
    _tf32(torch, True)


def phase_flow_profile(torch, dev, seed, module=None, stage=None,
                       tag="flow-train-profile"):
    """One train step of a flow train config at full width (default
    configs/train_v2v_evflow_10k.yaml: B=10, T=40, 128x128 with the extra
    frame, bf16, random RAFT-large teacher at 12 updates) under
    torch.profiler: the GPU span of v2v.teacher, v2v.forward, v2v.loss and
    v2v.optimizer, and the kernels that take the most device time."""
    from v2v_tpu_torch.training.flow_interface import FlowModelInterface
    from v2v_tpu_torch.training.raft import random_teacher
    from v2v_tpu_torch.training.steps import make_train_step
    from v2v_tpu_torch.training.train import (make_optimizer,
                                              sim_config_from_dataset)
    module, stage = module or EVFLOW_TRAIN_MODULE, stage or EVFLOW_TRAIN_STAGE
    data_cfg = stage["dataset"]["train"][0]
    b = stage["dataset"]["train_batch_size"]
    t, hw = data_cfg["sequence_length"], data_cfg["crop_size"]
    extra_evs = data_cfg.get("output_additional_evs", False)
    fpi = data_cfg["num_bins"] * data_cfg["frames_per_bin"]
    g = torch.Generator(device=dev).manual_seed(seed)
    iface = FlowModelInterface(module, dev, generator=g,
                               teacher=random_teacher(12, dev, g,
                                                      source="raft_large"))
    step = make_train_step(
        iface, make_optimizer(stage["optimizer"]).make(
            iface.model.parameters()),
        sim_config_from_dataset(data_cfg), data_cfg["num_bins"],
        data_cfg["frames_per_bin"], extra_frame=True, extra_evs=extra_evs)
    batch = {"video": _drifting_video(b, (t + extra_evs) * fpi + 1, hw, hw,
                                      seed + 8, dev),
             "data_source_idx": torch.full((b,), 11, dtype=torch.int64)}
    step(batch, g)                      # warm up
    _profile(torch, tag, lambda: step(batch, g))


def _evflow_eval_sequences(seed):
    """[flow-eval]'s sequences: three MVSEC-sized ones of EVAL_FRAMES
    frames, two named as MVSEC's flow sequences with a stored GT flow
    (TestH5FlowDataset's layout), one without flow (TestH5Dataset's, with
    the extra frame), scored against the teacher's pseudo-GT."""
    flow_cfg = EVFLOW_TEST_CONFIG["test_stage"]["test"][3]   # mvsec
    names = ("indoor_flying1", "indoor_flying2", "outdoor_day1")
    return [_SyntheticSequence(name, seed + 40 + i, EVAL_FRAMES,
                               FLOW_EVAL_HW, FLOW_EVAL_EVENTS_PER_FRAME,
                               flow_cfg, flow=i < 2)
            for i, name in enumerate(names)]


def _eraft_eval_sequences(seed):
    """[eraft-eval]'s sequences at test_eraft_original.yaml's 15 bins with
    the extra frame and event group: two EVAID-sized (720x1280) ones of the
    config's sequence_length (10) without flow, scored against the
    teacher's pseudo-GT, and two MVSEC-sized ones of EVAL_FRAMES with a
    stored GT flow."""
    evaid, _, _, mvsec = ERAFT_TEST_CONFIG["test_stage"]["test"]
    return ([_SyntheticSequence(name, seed + 50 + i,
                                evaid["sequence_length"], EVAL_HW,
                                EVAL_EVENTS_PER_FRAME, evaid)
             for i, name in enumerate(("ball", "bear"))]
            + [_SyntheticSequence(name, seed + 52 + i, EVAL_FRAMES,
                                  FLOW_EVAL_HW, FLOW_EVAL_EVENTS_PER_FRAME,
                                  mvsec, flow=True)
               for i, name in enumerate(("indoor_flying1",
                                         "indoor_flying2"))])


def phase_flow_eval(torch, dev, seed, profile=False, config=None,
                    seqs=None, n_params_want=EVFLOW_PARAMS, tag="flow-eval"):
    """A flow test config (default configs/test_evflow_original.yaml's
    EVFlowNet), random weights, through the port's flow run_test on
    synthetic sequences (default _evflow_eval_sequences), the sequences
    without flow scored against the pseudo-GT of a random RAFT-large
    teacher at 12 updates. Dense and sparse EPE/1PE/3PE must be finite
    for each sequence, the state must be reset once a sequence, the flows
    finite, of the frame's size and one fewer than the event groups for
    ERAFT (its voxel pairs), as many for EVFlowNet. Prints ms/frame of the
    model (a sequence's forward_sequence call over its flows: EVFlowNet
    batched over its frames, ERAFT pair by pair) and of the teacher, and
    the peak memory."""
    from v2v_tpu_torch.data.interface import ConcatDataset
    from v2v_tpu_torch.eval import flow_harness
    from v2v_tpu_torch.training.flow_interface import FLOW_METRICS
    from v2v_tpu_torch.training.flow_interface import FlowModelInterface
    from v2v_tpu_torch.training.raft import random_teacher
    from v2v_tpu_torch.training.steps import make_eval_step
    cfg = json.loads(json.dumps(config or EVFLOW_TEST_CONFIG))
    cfg.pop("test_output_dir")     # PNG output needs cv2, absent here
    seqs = seqs or _evflow_eval_sequences(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    iface = FlowModelInterface(cfg["module"], dev, generator=g,
                               teacher=random_teacher(12, dev, g,
                                                      source="raft_large"))
    pairs = iface.forward_type == "eraft"
    n_params = sum(p.numel() for p in iface.model.parameters())
    _require(n_params == n_params_want,
             f"{tag}: the model has {n_params} parameters")
    times, outs, resets, teacher_ms = [], [], [], []

    def timed_forward(events, state, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flows, state = type(iface).forward_sequence(iface, events, state,
                                                    **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / flows.shape[1])
        outs.append((tuple(events.shape), flows.detach().clone()))
        return flows, state

    def counted_init(*args, **kw):
        resets.append(args)
        return type(iface).init_state(iface, *args, **kw)

    def timed_prepare(batch, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = type(iface).prepare_flow(iface, batch, **kw)
        torch.cuda.synchronize()
        teacher_ms.append((time.perf_counter() - t0) * 1e3
                          / out["flow"].shape[1])
        return out

    iface.forward_sequence, iface.init_state = timed_forward, counted_init
    iface.prepare_flow = timed_prepare
    _log(f"[{tag}] {type(iface.model).__name__} {n_params} params, "
         + "; ".join(f"{q.name} {q.hw[0]}x{q.hw[1]} {q.frames} frames "
                     f"{q.data_cfg['num_bins']} bins {q.events_per_frame} "
                     f"events a frame"
                     + (", stored flow" if q.flow else ", pseudo-GT")
                     for q in seqs))
    root = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        final = flow_harness.run_test(iface, cfg, root=root,
                                      dataset=ConcatDataset(seqs))
    finally:
        del iface.forward_sequence, iface.init_state, iface.prepare_flow
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _require(len(resets) == len(seqs), f"{tag}: the state was reset "
                                       f"{len(resets)} times")
    n_teacher = sum(not q.flow for q in seqs)
    _require(len(teacher_ms) == n_teacher, f"{tag}: the teacher ran "
                                           f"{len(teacher_ms)} times")
    _require(len(outs) == len(seqs), f"{tag}: {len(outs)} model calls")
    for (b, t_in, h, w, _), f in outs:
        _require(f.shape == (b, t_in - pairs, h, w, 2)
                 and bool(torch.isfinite(f).all()),
                 f"{tag}: flow {tuple(f.shape)} from events "
                 f"{(b, t_in, h, w)}")
    src = {q.name: q.data_cfg["dataset_name"].upper() for q in seqs}
    want = {f"{src[q.name]}/{q.name}/{m}" for q in seqs for m in FLOW_METRICS}
    _require(set(final) == want and all(math.isfinite(v)
                                        for v in final.values()),
             f"{tag}: metrics {final}")
    with open(os.path.join(root, "tensorboard_logs", cfg["experiment_name"],
                           "test_metrics.txt")) as f:
        _require(len([ln for ln in f if ln.strip()]) == len(want),
                 f"{tag}: test_metrics.txt")
    for q in seqs:
        _log(f"[{tag}] {q.name}: " + ", ".join(
            f"{m} {final[f'{src[q.name]}/{q.name}/{m}']:.4f}"
            for m in FLOW_METRICS))
    _log(f"[{tag}] model ms/frame (a sequence's call over its flows): "
         + ", ".join(f"{q.name} {x:.2f}" for q, x in zip(seqs, times))
         + "; RAFT-large pseudo-GT ms/frame: "
         + ", ".join(f"{x:.2f}" for x in teacher_ms) + f"; run_test "
         f"{wall:.1f} s; max_memory_allocated {peak:.2f} GiB")
    if profile:
        ev = torch.as_tensor(seqs[0][0]["events"][None], device=dev)
        eval_step = make_eval_step(iface)
        state = iface.init_state(1, *ev.shape[2:4])
        _profile(torch, f"{tag}-profile", lambda: eval_step(ev, state))
    return final

def _frame_events(seed, hw, n):
    """One frame's window of `n` uniform events at `hw` over 1/30 s, from
    100 s into a recording, as an h5 file stores them: float64 second
    stamps, uint16 pixels, polarities in {0, 1}."""
    import numpy as np
    rng = np.random.default_rng(seed)
    h, w = hw
    return (100.0 + np.sort(rng.uniform(0.0, 1 / 30, n)),
            rng.integers(0, w, n).astype(np.uint16),
            rng.integers(0, h, n).astype(np.uint16),
            rng.integers(0, 2, n).astype(np.uint8))


def phase_native_voxel(seed, card):
    """[native-voxel]: build csrc/voxel_builder.cpp with g++, hold it
    against events_to_voxel_np on EVAID's and MVSEC's frame (equal for
    discrete bins, within NATIVE_BILINEAR_ATOL for bilinear), time both on
    the host (median of 5), then 8 EVAID frames on 4 threads as the eval
    loader's test_num_workers voxelize them, and check that
    _SyntheticSequence, like the port's TestH5Dataset, voxelizes with the
    builder by default."""
    import numpy as np
    from v2v_tpu_torch.data import native
    from v2v_tpu_torch.ops.voxel import events_to_voxel_np
    tag = "native-voxel"
    built = native.LIB.build()
    _log(f"[{tag}] g++ {' '.join(native.FLAGS)}: {built['seconds']:.2f} s"
         f"{' (cached)' if built['cached'] else ''}, {built['path']}")
    for name, hw, bins, n in NATIVE_FRAMES:
        ev = _frame_events((seed, hw[0]), hw, n)
        for interp in (False, True):
            kw = dict(num_bins=bins, height=hw[0], width=hw[1],
                      interpolate_bins=interp)
            got = native.events_to_voxel_native(*ev, **kw)
            want = events_to_voxel_np(*ev, **kw)
            err = float(np.abs(got - want).max())
            binning = "bilinear" if interp else "discrete"
            _require(got.dtype == want.dtype and got.shape == want.shape
                     and np.abs(want).sum() > 0, f"{tag}: {name} {binning}")
            _require(err <= NATIVE_BILINEAR_ATOL if interp
                     else np.array_equal(got, want),
                     f"{tag}: {name} {binning}: the builder differs from "
                     f"numpy by {err:.2e}")
            ms = _host_ms(lambda: native.events_to_voxel_native(*ev, **kw), 5)
            np_ms = _host_ms(lambda: events_to_voxel_np(*ev, **kw), 5)
            _log(f"[{tag}] {name} {hw[0]}x{hw[1]} {bins} bins {n} events "
                 f"{binning}: builder {ms:.2f} ms/frame ({n / ms / 1e3:.1f} "
                 f"Mev/s), numpy {np_ms:.2f} ms/frame ({n / np_ms / 1e3:.1f} "
                 f"Mev/s), {np_ms / ms:.2f}x; max|builder - numpy| {err:.2e}"
                 f"; host of {card}")
    # the eval harness's loader voxelizes on test_num_workers threads (4
    # in the test configs); the builder's ctypes call lets go of the GIL
    from concurrent.futures import ThreadPoolExecutor
    name, hw, bins, n = NATIVE_FRAMES[0]
    frames = [_frame_events((seed, i), hw, n) for i in range(8)]
    for interp in (False, True):
        kw = dict(num_bins=bins, height=hw[0], width=hw[1],
                  interpolate_bins=interp)
        for label, fn in (("builder", native.events_to_voxel_native),
                          ("numpy", events_to_voxel_np)):
            with ThreadPoolExecutor(4) as pool:
                ms = _host_ms(lambda: list(pool.map(
                    lambda ev: fn(*ev, **kw), frames)), 3) / len(frames)
            _log(f"[{tag}] {name} {'bilinear' if interp else 'discrete'} "
                 f"on 4 threads, 8 frames: {label} {ms:.2f} ms a frame")
    cfg = ETNET_CONFIG["test_stage"]["test"][0]
    seqs = [_SyntheticSequence("s", seed, 2, EVAL_HW, EVAL_EVENTS_PER_FRAME,
                               c)[0]["events"]
            for c in (cfg, dict(cfg, use_native_voxel_builder=False))]
    err = float(np.abs(seqs[0] - seqs[1]).max())
    _require("use_native_voxel_builder" not in cfg
             and err <= (NATIVE_BILINEAR_ATOL if cfg["interpolate_bins"]
                         else 0.0) and np.abs(seqs[0]).sum() > 0,
             f"{tag}: _SyntheticSequence's voxels differ between builders "
             f"by {err:.2e}")
    _log(f"[{tag}] _SyntheticSequence (ETNet's test set, interpolate_bins "
         f"{cfg['interpolate_bins']}) voxelizes with the builder by "
         f"default: max|builder - numpy| {err:.2e}")


def phase_events_ops(torch, dev, seed):
    """[events-ops]: each function of ops/events.py and ops/voxel.py::
    events_to_voxel on EVAID's frame (720x1280, EVAL_EVENTS_PER_FRAME
    events padded to EVENTS_PAD, the tail off the sensor) on the card
    against the same call on the CPU: integer-valued outputs equal, float
    ones within EVENTS_RTOL. events_to_voxel (discrete) also equals the
    host's events_to_voxel_np, and events_to_voxel_sorted equals it."""
    import numpy as np
    from v2v_tpu_torch.ops import events as eo
    from v2v_tpu_torch.ops.voxel import (events_to_voxel, events_to_voxel_np,
                                         relative_us)
    tag = "events-ops"
    (h, w), n, e = EVAL_HW, EVAL_EVENTS_PER_FRAME, EVENTS_PAD
    ts, xs, ys, ps = _frame_events((seed, 7), EVAL_HW, n)
    rng = np.random.default_rng((seed, 8))

    def pad(a, fill, dtype):
        out = np.full(e, fill, dtype)
        out[:n] = a
        return out

    host = {"xi": pad(xs, w + 5, np.float32), "yi": pad(ys, -3, np.float32),
            "xs": pad(xs + rng.random(n) - 0.5, w + 5, np.float32),
            "ys": pad(ys + rng.random(n) - 0.5, -3, np.float32),
            "ts": pad(ts - ts[0], 1.0, np.float32),
            "ps": pad(ps * 2.0 - 1.0, 50.0, np.float32),
            "t_us": pad(relative_us(ts), 0, np.int32),
            "x32": pad(xs, w + 5, np.int32), "y32": pad(ys, h + 5, np.int32),
            "p01": pad(ps, 1, np.uint8),
            "flow": (rng.standard_normal((h, w, 2)) * 3).astype(np.float32)}
    t_ref = float(host["ts"][n // 2])
    hw, vb = (h, w), dict(num_bins=5, height=h, width=w)
    cases = (
        ("events_to_image", True, lambda d: eo.events_to_image(
            d["xi"], d["yi"], d["ps"], n, sensor_size=hw)),
        ("events_to_image bilinear", False, lambda d: eo.events_to_image(
            d["xs"], d["ys"], d["ps"], n, sensor_size=hw,
            interpolation="bilinear")),
        ("events_to_voxel_bilinear", False,
         lambda d: eo.events_to_voxel_bilinear(
             d["xi"], d["yi"], d["ts"], d["ps"], n, num_bins=5,
             sensor_size=hw)),
        ("events_to_voxel_bilinear discrete", True,
         lambda d: eo.events_to_voxel_bilinear(
             d["xi"], d["yi"], d["ts"], d["ps"], n, num_bins=5,
             sensor_size=hw, temporal_bilinear=False)),
        ("events_to_neg_pos_voxel", False,
         lambda d: eo.events_to_neg_pos_voxel(
             d["xi"], d["yi"], d["ts"], d["ps"], n, num_bins=5,
             sensor_size=hw)),
        ("events_to_timestamp_image", False,
         lambda d: eo.events_to_timestamp_image(
             d["xs"], d["ys"], d["ts"], d["ps"], n, sensor_size=hw)),
        ("warp_events_by_flow", False, lambda d: eo.warp_events_by_flow(
            d["xs"], d["ys"], d["ts"], d["flow"], t_ref)),
        ("events_to_voxel_sorted", True, lambda d: eo.events_to_voxel_sorted(
            d["t_us"], d["x32"], d["y32"], d["p01"], n, **vb)),
        ("events_to_voxel", True, lambda d: events_to_voxel(
            d["t_us"], d["x32"], d["y32"], d["p01"], n, **vb)),
        ("events_to_voxel bilinear", False, lambda d: events_to_voxel(
            d["t_us"], d["x32"], d["y32"], d["p01"], n, **vb,
            interpolate_bins=True)),
    )
    cpu = {k: torch.from_numpy(v) for k, v in host.items()}
    card = {k: v.to(dev) for k, v in cpu.items()}
    outs = {}
    for name, exact, fn in cases:
        want, got = fn(cpu), fn(card)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        errs = []
        for g, c in zip(got, want):
            g = g.cpu()
            _require(g.shape == c.shape and g.dtype == c.dtype
                     and bool(torch.isfinite(g).all()) and bool(c.any()),
                     f"{tag}: {name}: {tuple(g.shape)} {g.dtype}")
            err = float((g - c).abs().max())
            scale = 1.0 + float(c.abs().max())
            _require(torch.equal(g, c) if exact
                     else err <= EVENTS_RTOL * scale,
                     f"{tag}: {name}: card and CPU differ by {err:.3e}")
            errs.append(err)
        ms = _cuda_ms(lambda: fn(card), 5)
        outs[name] = got[0]
        _log(f"[{tag}] {name}: {ms:.3f} ms on the card; max|card - cpu| "
             f"{max(errs):.2e}" + (" (equal)" if exact else
                                   f" (tolerance {EVENTS_RTOL:g} x "
                                   f"(1 + max|cpu|))"))
    want = events_to_voxel_np(ts, xs, ys, ps, **vb)
    _require(np.array_equal(outs["events_to_voxel"].cpu().numpy(), want),
             f"{tag}: events_to_voxel differs from events_to_voxel_np")
    _require(torch.equal(outs["events_to_voxel_sorted"],
                         outs["events_to_voxel"]),
             f"{tag}: events_to_voxel_sorted differs from events_to_voxel")
    _log(f"[{tag}] events_to_voxel on the card equals events_to_voxel_np "
         f"and events_to_voxel_sorted ({n} events, {h}x{w}, 5 bins)")


def phase_v2e(torch, dev, seed):
    """[v2e]: ops/voxel_v2e.py on a (201, 128, 128) uint8 stand-in clip
    for each threshold model: noise off (threshold stds, the noise-rate
    spread, jitter and shot noise 0; low pass, leak and refractory clip
    on) on the card against the CPU within the flip budget (FLIP_RATE, at
    most 1 count); noise on (the defaults with a 30 Hz low pass and 5 Hz
    shot noise): finite counts whose mean |count| is within V2E_NOISY_BAND
    of the CPU run's."""
    from v2v_tpu_torch.ops.voxel_v2e import (THRESHOLD_MODELS, V2EConfig,
                                             v2e_video_to_voxel)
    tag = "v2e"
    video = _drifting_video(1, *V2E_CLIP, seed + 11, dev)[0]
    quiet = dict(thres_mean_std=0.0, thres_diff_std=0.0,
                 noise_rate_cov_decades=0.0, leak_jitter_fraction=0.0,
                 shot_noise_rate_hz=0.0, cutoff_hz=30.0, leak_rate_hz=0.5,
                 refractory_period_s=0.01, thres_diff_mean=0.04)
    noisy = dict(cutoff_hz=30.0, shot_noise_rate_hz=5.0)
    cpu = torch.device("cpu")
    for model in THRESHOLD_MODELS:
        res = {}
        for kind, kw in (("noise-free", quiet), ("noisy", noisy)):
            cfg = V2EConfig(threshold_model=model, **kw)
            runs = [v2e_video_to_voxel(
                video.to(d), cfg, torch.Generator(device=d).manual_seed(
                    seed)).cpu() for d in (dev, cpu)]
            for r in runs:
                _require(r.shape == (V2E_CLIP[0] - 1,) + V2E_CLIP[1:]
                         and bool(torch.isfinite(r).all())
                         and bool(r.any()), f"{tag}: {model} {kind}")
            res[kind] = runs
        dmax, rate = _counts_diff(*res["noise-free"])
        _require(dmax <= 1.0 and rate <= FLIP_RATE,
                 f"{tag}: {model} noise-free: card and CPU differ by "
                 f"{dmax} at a rate {rate:.2e}")
        mc, mh = (float(r.abs().mean()) for r in res["noisy"])
        _require(abs(mc - mh) <= V2E_NOISY_BAND * mh,
                 f"{tag}: {model} noisy: mean |count| card {mc:.5f} cpu "
                 f"{mh:.5f}")
        cfg = V2EConfig(threshold_model=model, **noisy)
        g = torch.Generator(device=dev).manual_seed(seed)
        ms = _cuda_ms(lambda: v2e_video_to_voxel(video, cfg, g), 3, 1)
        _log(f"[{tag}] {model}: noise-free card vs CPU max|diff| {dmax:g} "
             f"at a rate {rate:.2e} (budget {FLIP_RATE:g}), "
             f"{float(res['noise-free'][1].abs().sum()):.0f} events; noisy "
             f"mean |count| card {mc:.5f} cpu {mh:.5f} (band "
             f"{V2E_NOISY_BAND:g}); {ms:.2f} ms a clip on the card")


def phase_webvid_voxel(torch, dev, seed, steps):
    """[webvid-voxel]: the flagship's seeded stand-in clips through the
    port's WebVid voxel branch (data/webvid.py::VoxelOutput, the numpy
    emulator on the host), then `steps` flagship train steps at full width
    on the card from those voxels (make_train_step without a simulator):
    finite losses and K1 launched 0 times."""
    import numpy as np
    from v2v_tpu_torch.data.interface import collate
    from v2v_tpu_torch.data.webvid import VoxelOutput
    from v2v_tpu_torch.losses.lpips import LPIPS
    from v2v_tpu_torch.training.interface import ModelInterface
    from v2v_tpu_torch.training.raft import random_teacher
    from v2v_tpu_torch.training.steps import make_train_step
    from v2v_tpu_torch.training.train import make_optimizer
    tag = "webvid-voxel"
    stage = FLAGSHIP_STAGE
    data_cfg = dict(stage["dataset"]["train"][0], output="voxel")
    b = stage["dataset"]["train_batch_size"]
    t, hw = data_cfg["sequence_length"], data_cfg["crop_size"]
    clips = _DriftingClips(data_cfg, seed + 13, b)
    voxel = VoxelOutput(data_cfg)
    items, host_ms = [], []
    for i in range(b):
        clip = clips[i]
        t0 = time.perf_counter()
        item = voxel(clip["video"], clip["video"][..., None],
                     np.random.RandomState(seed * 1000 + i))
        host_ms.append((time.perf_counter() - t0) * 1e3)
        items.append(dict(item, data_source_idx=clip["data_source_idx"]))
    host = collate(items)
    _require(host["events"].shape == (b, t, hw, hw, 5)
             and host["frame"].shape == (b, t, hw, hw, 1)
             and np.isfinite(host["events"]).all()
             and np.abs(host["events"]).sum() > 0,
             f"{tag}: events {host['events'].shape}, frames "
             f"{host['frame'].shape}")
    batch = {k: torch.from_numpy(host[k]).to(dev)
             for k in ("events", "frame", "data_source_idx")}
    g = torch.Generator(device=dev).manual_seed(seed)
    iface = ModelInterface(FLAGSHIP_MODULE, dev, generator=g,
                           lpips=LPIPS("vgg", dev, generator=g),
                           teacher=random_teacher(12, dev, generator=g))
    opt = make_optimizer(stage["optimizer"]).make(iface.model.parameters())
    step = make_train_step(iface, opt)
    torch.cuda.synchronize()
    _zero_launches()
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, aux = step(batch, g)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        _require(math.isfinite(losses[-1])
                 and math.isfinite(float(aux["grad_norm"])),
                 f"{tag}: loss {losses[-1]}")
    launches = _read_launches()
    ups = _upsample_decoders(iface.model) * steps
    _require_launches(f"{tag} ({steps} steps)", launches,
                      upsample2x_bilinear=ups,
                      upsample2x_bilinear_backward=ups)
    _log(f"[{tag}] {b} clips of {clips[0]['video'].shape[0]} frames at "
         f"{hw}x{hw} through VoxelOutput: {statistics.median(host_ms):.1f} "
         f"host ms a clip (median; {sum(host_ms) / 1e3:.2f} s for the "
         f"batch); mean |count| {float(np.abs(host['events']).mean()):.4f}")
    _log(f"[{tag}] flagship B={b} T={t} bf16 from voxels: losses "
         + ", ".join(f"{x:.5f}" for x in losses) + f"; ms/step after the "
         f"first {statistics.median(times[1:] or times):.1f} (all: "
         + ", ".join(f"{x:.1f}" for x in times) + f"); launches {launches}")
    return launches


def phase_legacy_data(torch, dev, seed):
    """[legacy-data]: a seeded MVSEC-sized memmap recording written into a
    temporary directory (LEGACY_HW, LEGACY_FRAMES frames, LEGACY_EVENTS
    events, optic flow) read by SequenceDataset at L=40 with a pause
    chain, voxel noise, hot pixels, hot events filtered, RandomCrop 128,
    flips and LegacyNorm, for each voxel method (items/s on the host);
    then one between_frames window through the flagship E2VID's eval step
    at full width on the card, twice from a reset state: finite and
    equal."""
    import random
    import shutil
    import numpy as np
    from v2v_tpu_torch.data.legacy import SequenceDataset
    from v2v_tpu_torch.training.interface import ModelInterface
    from v2v_tpu_torch.training.steps import make_eval_step
    tag = "legacy-data"
    root = tempfile.mkdtemp(prefix="chip_smoke_memmap_")
    try:
        t0 = time.perf_counter()
        _write_memmap(root, seed, LEGACY_HW, LEGACY_FRAMES, LEGACY_EVENTS)
        _log(f"[{tag}] memmap recording {LEGACY_HW[0]}x{LEGACY_HW[1]}, "
             f"{LEGACY_FRAMES} frames, {LEGACY_EVENTS} events, optic flow: "
             f"written in {time.perf_counter() - t0:.2f} s")
        per_frame = LEGACY_EVENTS // LEGACY_FRAMES
        methods = {
            "between_frames": {"method": "between_frames"},
            "k_events": {"method": "k_events", "k": per_frame,
                         "sliding_window_w": per_frame // 4},
            "t_seconds": {"method": "t_seconds", "t": 0.02,
                          "sliding_window_t": 0.005}}
        window = None
        for name, method in methods.items():
            random.seed(seed)
            np.random.seed(seed)
            t0 = time.perf_counter()
            seq = SequenceDataset(
                root, 40, step_size=20, proba_pause_when_running=0.05,
                proba_pause_when_paused=0.9,
                noise_kwargs={"noise_std": 0.1, "noise_fraction": 0.1},
                hot_pixel_kwargs={"hot_pixel_std": 0.1},
                dataset_kwargs={"voxel_method": method,
                                "filter_hot_events": True,
                                "transforms": {"RandomCrop": {"size": 128},
                                               "RandomFlip": {},
                                               "LegacyNorm": {}}})
            open_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = [seq[i] for i in range(LEGACY_SEQUENCES)]
            dt = time.perf_counter() - t0
            for sample in got:
                _require(len(sample) == 40 and all(
                    it["events"].shape == (128, 128, 5)
                    and it["events"].dtype == np.float32
                    and np.isfinite(it["events"]).all() for it in sample),
                    f"{tag}: {name}: an item's events")
                _require(name != "between_frames" or all(
                    it["frame"].shape == (128, 128, 1)
                    and it["flow"].shape == (128, 128, 2) for it in sample),
                    f"{tag}: {name}: an item's frame or flow")
            _log(f"[{tag}] {name}: {len(seq.dataset)} windows, {len(seq)} "
                 f"sequences; opened in {open_s:.2f} s (hot-event mask); "
                 f"{LEGACY_SEQUENCES / dt:.2f} sequences/s, "
                 f"{LEGACY_SEQUENCES * 40 / dt:.1f} items/s on the host")
            if name == "between_frames":
                window = got[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    events = torch.from_numpy(np.stack([it["events"] for it in window])
                              )[None].to(dev)
    iface = ModelInterface(FLAGSHIP_MODULE, dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               seed))
    step = make_eval_step(iface)
    _zero_launches()
    preds = [step(events, iface.init_state(1, 128, 128))[0]
             for _ in range(2)]
    launches = _read_launches()
    _require(preds[0].shape[:2] == (1, 40)
             and bool(torch.isfinite(preds[0]).all()),
             f"{tag}: prediction {tuple(preds[0].shape)}")
    _require(torch.equal(*preds), f"{tag}: two runs from a reset state "
                                  f"differ")
    _require_launches(f"{tag} (2 x 40 frames)", launches,
                      upsample2x_bilinear=_upsample_decoders(iface.model)
                      * 2 * preds[0].shape[1])
    _log(f"[{tag}] one between_frames window (1, 40, 128, 128, 5) through "
         f"the flagship E2VID's eval step: finite, equal from a reset "
         f"state twice; launches {launches}")
    return launches


def _release_inputs(seed):
    """[release]'s seam into the kit: a family -> (its config as a dict,
    its test sequences in memory), as `phase_eval` feeds run_test (the
    card's machine has no PyYAML or h5py). e2vid++: two HQF-sized
    sequences named as HQF's `boxes` and `desk`, so the reference table
    has rows for them; etnet and hyper: two EVAID 720x1280 ones named as
    EVAID's `ball` and `bear`. No PNGs (no cv2 there)."""
    from v2v_tpu_torch.data.interface import ConcatDataset
    plans = {"e2vid++": (E2VIDPP_CONFIG, "hqf", ("boxes", "desk"),
                         RELEASE_HQF_HW, RELEASE_HQF_EVENTS),
             "etnet": (ETNET_CONFIG, "evaid", ("ball", "bear"), EVAL_HW,
                       EVAL_EVENTS_PER_FRAME),
             "hyper": (HYPER_EVAL_CONFIG, "evaid", ("ball", "bear"),
                       EVAL_HW, EVAL_EVENTS_PER_FRAME)}

    def inputs(family):
        if family not in plans:
            return None
        config, ds, names, hw, events = plans[family]
        cfg = json.loads(json.dumps(config))
        cfg.pop("test_output_dir")
        entry = next(e for e in cfg["test_stage"]["test"]
                     if e["dataset_name"] == ds)
        cfg["test_stage"]["test"] = [entry]
        return cfg, ConcatDataset([
            _SyntheticSequence(name, seed + 60 + i, RELEASE_FRAMES, hw,
                               events, entry)
            for i, name in enumerate(names)])

    return inputs


def _kit(torch, tag, **kw):
    """eval/release.py::validate_release(**kw) on the card with its output
    kept; returns (rc, output, wall s)."""
    import contextlib
    import io
    from v2v_tpu_torch.eval.release import validate_release
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = validate_release(**kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _log(f"[{tag}] validate_release({', '.join(sorted(kw))}) -> rc {rc} in "
         f"{wall:.1f} s")
    return rc, buf.getvalue(), wall


def phase_release(torch, dev, seed):
    """[release]: the release kit (eval/release.py, the port's
    `cli validate_release`) on the card, fed through its `inputs` seam
    (`_release_inputs`). e2vid++ with a .pth saved from the port's
    FlowNet under the reference's key names, `module.`-prefixed, inside
    {"state_dict": ...}: it must convert strictly, score, print FAIL rows
    against the e2vid+ table (random weights) and return 2. etnet and
    hyper, random-init dry runs: rc 0, NOT GATED; K3 21 launches an ETNet
    frame, K4 one a HyperE2VID frame. The same .pth with one key renamed
    must fail the strict conversion (rc 1: nothing ran). Returns the
    launches and each family's wall (s), the setup column of
    `--budget`."""
    from v2v_tpu_torch.config import instantiate_from_config
    from v2v_tpu_torch.models.init import materialize
    root = tempfile.mkdtemp(prefix="chip_smoke_release_")
    assets = os.path.join(root, "assets")
    os.makedirs(os.path.join(assets, "checkpoints"))
    model = materialize(lambda: instantiate_from_config(E2VIDPP_MODEL),
                        torch.device("cpu"),
                        torch.Generator().manual_seed(seed))
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd},
               os.path.join(assets, "checkpoints", "e2vid++.pth"))
    inputs = _release_inputs(seed)
    walls = {}
    _zero_launches()
    rc, text, walls["e2vid++"] = _kit(
        torch, "release", assets=assets, out=os.path.join(root, "out1"),
        families=["e2vid++"], inputs=inputs)
    n_fail = sum(line.rstrip().endswith("FAIL") for line in text.splitlines())
    _log(f"[release] e2vid++: {n_fail} FAIL rows against the e2vid+ table")
    _require(rc == 2 and "converted" in text and n_fail > 0
             and "HQF/boxes/MSE" in text and "HQF/desk/SSIM" in text,
             "release: e2vid++ did not convert, score and fail the table")
    for family in ("etnet", "hyper"):
        rc, text, walls[family] = _kit(
            torch, "release", assets=assets,
            out=os.path.join(root, f"out_{family}"), families=[family],
            allow_random_init=True, inputs=inputs)
        _require(rc == 0 and "RANDOM INIT dry run" in text
                 and f"{family}: NOT GATED (random init)" in text,
                 f"release: the {family} dry run")
    launches = _read_launches()
    n_frames = 2 * RELEASE_FRAMES
    _require(launches["attention"] == K3_PER_FRAME * n_frames
             and launches["dynamic_shift_sum"] == n_frames
             and not launches["simulate_batch"],
             f"release: launches {launches}, want K3 {K3_PER_FRAME} an "
             f"ETNet frame and K4 one a HyperE2VID frame over {n_frames}")
    bad = os.path.join(root, "bad_assets")
    os.makedirs(os.path.join(bad, "checkpoints"))
    key = next(k for k in sd if k.endswith(".weight"))
    sd[key + "_renamed"] = sd.pop(key)
    torch.save({"state_dict": sd},
               os.path.join(bad, "checkpoints", "e2vid++.pth"))
    rc, text, _ = _kit(torch, "release", assets=bad,
                       out=os.path.join(root, "out_bad"),
                       families=["e2vid++"], inputs=inputs)
    _require(rc == 1 and "CONVERSION FAILED" in text
             and key[len("module."):] in text,
             f"release: a .pth with {key} renamed was not refused")
    _log(f"[release] a .pth with {key!r} renamed fails the strict "
         f"conversion (rc 1); kit wall on the card: " + ", ".join(
             f"{f} {w:.1f} s" for f, w in walls.items()) +
         f"; launches {launches}")
    return launches, walls


def _bench_json(torch, tag, main, argv):
    """A bench script's main(argv) on the card, its output kept; returns
    its last JSON line, the launches and the command's wall (s)."""
    import contextlib
    import io
    buf = io.StringIO()
    _zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = main(argv)
    wall = time.perf_counter() - t0
    _require(rc == 0, f"{tag}: main({argv}) returned {rc}")
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    return result, _read_launches(), wall


def phase_bench(torch, dev):
    """[bench-sim], [bench-step], [bench-eval]: the port's bench scripts
    (v2v_tpu_torch/scripts/bench*.py) through their main on the card, at
    their defaults with BENCH_REPEATS repeats; `bench_full_step` for the
    flagship and for HyperE2VID, with --flops. Each prints a median and a
    spread over synchronized repeats; the kernels each must launch are
    counted. Returns the launches by path and bench_eval's rows."""
    from v2v_tpu_torch.scripts import bench, bench_eval, bench_full_step
    paths = {}
    rep = ["--repeats", str(BENCH_REPEATS)]
    sim, paths["bench-sim"], wall = _bench_json(torch, "bench-sim",
                                                bench.main, rep)
    want = (BENCH_REPEATS + 1) * sim["iters"]
    _log(f"[bench-sim] {sim['value']:.1f} clips/s (spread "
         f"{sim['spread'][0]:.1f}-{sim['spread'][1]:.1f}) against the host "
         f"numpy simulator's {sim['host_numpy_clips_per_sec']:.3f}: "
         f"{sim['vs_host_numpy']:.0f}x; {wall:.1f} s; K1 "
         f"{paths['bench-sim']['simulate_batch']} launches (want {want})")
    _require(paths["bench-sim"]["simulate_batch"] == want,
             "bench-sim: K1 launch count")
    for config, tag in (("flagship", "bench-step"),
                        ("hyper", "bench-step-hyper")):
        step, paths[tag], wall = _bench_json(
            torch, tag, bench_full_step.main,
            ["--config", config, "--flops"] + rep)
        n = 1 + BENCH_REPEATS * step["steps"]
        k4 = step["T"] * n if config == "hyper" else 0
        _log(f"[{tag}] {step['ms_per_step']:.1f} ms/step (spread "
             f"{step['spread'][0]:.1f}-{step['spread'][1]:.1f}, "
             f"{BENCH_REPEATS} x {step['steps']} steps), "
             f"{step['flop_per_step'] / 1e12:.3f} TFLOP/step, "
             f"{step['flop_per_s'] / 1e12:.1f} TFLOP/s = "
             f"{step['bf16_peak_share']:.4f} of the dense bf16 peak "
             f"({step['card']}); {wall:.1f} s; launches {paths[tag]}")
        _require(math.isfinite(step["last_loss"]), f"{tag}: loss")
        _require(paths[tag]["simulate_batch"] == n
                 and paths[tag]["dynamic_shift_sum"] == k4
                 and paths[tag]["dynamic_shift_sum_backward"] == k4,
                 f"{tag}: launches {paths[tag]}, want K1 {n}, K4 {k4}")
    ev, paths["bench-eval"], wall = _bench_json(torch, "bench-eval",
                                                bench_eval.main, rep)
    per_stream = ev["rows"][0]["frames"] * BENCH_REPEATS + 2
    k3_streams = sum(r["family"] == "etnet" and r["hw"][0] * r["hw"][1]
                     // 64 > 4096 for r in ev["rows"])
    want = {"attention": K3_PER_FRAME * per_stream * k3_streams,
            "dynamic_shift_sum": per_stream * sum(
                r["family"] == "hyper" for r in ev["rows"])}
    _log(f"[bench-eval] {len(ev['rows'])} rows in {wall:.1f} s; launches "
         f"{paths['bench-eval']} (want {want})")
    _require(all(paths["bench-eval"][k] == v for k, v in want.items())
             and len(ev["rows"]) == 18
             and all(math.isfinite(r["ms_per_frame"]) for r in ev["rows"]),
             "bench-eval: rows or launches")
    return paths, ev["rows"]


# [soak]: the flagship shape on a cut schedule (the soak's stages of
# 6 and 4 epochs of 210 steps cut to 3 and 2 of SOAK_STEPS), killed
# mid-epoch SOAK_KILL_AFTER and resumed; [rss]: diag_rss's four phases
# for RSS_ITERS iterations; [floor]: the flagship's and HyperE2VID's
# floors over the top FLOOR_TOP calls; [close-floor]: ETNet at its shape,
# ERAFT with T cut from 40 to CLOSE_ERAFT_T (its step is the host's:
# 3.5-4.4 s at T = 40)
SOAK_STAGE_EPOCHS = (3, 2)
SOAK_STEPS = 6
SOAK_KILL_AFTER = 2
RSS_ITERS = 4
FLOOR_TOP = 12
CLOSE_ERAFT_T = 8


def _no_launches() -> dict:
    return {name: 0 for name in _kernels()}


def phase_soak(torch, dev):
    """[soak]: scripts/soak_train.py at the flagship's full width, B=12,
    T=40, 128x128, on a cut schedule: two stages of SOAK_STAGE_EPOCHS
    epochs of SOAK_STEPS steps of stand-in clips, a SIGKILL mid-epoch
    SOAK_KILL_AFTER and the resume in a fresh process. The script checks
    the losses, the resume, the LRs, the probe's MSE and K1 once a step
    (summed over both processes, from their own counts); this phase
    prints the RSS and reserved-memory series. Returns K1's launches."""
    from v2v_tpu_torch.scripts import soak_train
    root = tempfile.mkdtemp(prefix="chip_smoke_soak_")
    t0 = time.perf_counter()
    try:
        s = soak_train.run(root, stage_epochs=SOAK_STAGE_EPOCHS,
                           steps_per_epoch=SOAK_STEPS,
                           kill_after=SOAK_KILL_AFTER, poll_s=0.5,
                           device=dev, timeout_s=600)
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0
    _log(f"[soak] {s['total_steps']} steps over {s['epochs']} epochs, "
         f"resumed at epoch {s['resume_epoch']} after the kill; losses by "
         f"epoch {[round(x, 4) for _, x in s['loss_by_epoch']]} (first 3 "
         f"{s['loss_first3_mean']:.4f} -> last 3 "
         f"{s['loss_last3_mean']:.4f}); lr by epoch {s['lr_by_epoch']}; "
         f"probe MSE {[round(m, 5) for _, m, _ in s['quality_by_epoch']]}")
    _log(f"[soak] host RSS (s, MB) {s['rss_series']}; peak "
         f"{s['rss_mb_peak']} MB, first-quarter peak "
         f"{s['rss_mb_first_quarter_peak']} MB; reserved MB by epoch "
         f"{s['reserved_mb_by_epoch']}; allocated MB by epoch "
         f"{s['allocated_mb_by_epoch']}; K1 {s['k1_launches']} launches in "
         f"{s['total_steps']} steps; epoch s {s['epoch_seconds']}; "
         f"{wall:.1f} s")
    return dict(_no_launches(), simulate_batch=s["k1_launches"])


def phase_rss(torch, dev):
    """[rss]: scripts/diag_rss.py's four phases (loader, transfer, step,
    full) at the flagship's shape for RSS_ITERS iterations each, each in
    a fresh process, the four at once (their RSS stays each process's;
    one after another they took ~2 minutes, most of it starting
    processes); each prints its RSS, heap and reserved series. Returns
    K1's launches, counted in the step and full processes."""
    from v2v_tpu_torch.scripts import diag_rss
    root = tempfile.mkdtemp(prefix="chip_smoke_rss_")
    t0 = time.perf_counter()
    try:
        res = diag_rss.run(list(diag_rss.PHASE_NAMES), RSS_ITERS, 2, 4,
                           root, device=str(dev), concurrent=True)
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    k1 = sum(res[p].get("k1_launches", 0) for p in ("step", "full"))
    _require(k1 == 2 * RSS_ITERS, f"rss: K1 launched {k1} times in "
                                  f"{2 * RSS_ITERS} steps")
    _log(f"[rss] growth MB: " + ", ".join(
        f"{p} {r['last_mb'] - r['first_mb']:+.0f} (heap "
        f"{r['python_heap_mb']:.0f}, after trim {r['trimmed_mb']:.0f}; "
        f"{r['process_s']:.1f} s)" for p, r in res.items())
        + f"; K1 {k1} launches; "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(_no_launches(), simulate_batch=k1)


def phase_floor(torch, dev):
    """[floor]: scripts/roofline_floor.py for the flagship and HyperE2VID:
    the step's calls recorded, the top FLOOR_TOP replayed alone in CUDA
    graphs, the floor beside the step's measured ms/step and the gap; K3,
    K4 and its gradient's bound x launches apart. Returns the launches by
    path."""
    from v2v_tpu_torch.scripts import roofline_floor
    paths = {}
    for config in ("flagship", "hyper"):
        _zero_launches()
        t0 = time.perf_counter()
        out = roofline_floor.run(config, dev, FLOOR_TOP, steps=2, repeats=1)
        torch.cuda.synchronize()
        paths[f"floor-{config}"] = launches = _read_launches()
        steps = 1 + 2
        k4 = out["T"] * steps if config == "hyper" else 0
        _require(out["floor_ms"] > 0 and math.isfinite(out["gap"]),
                 f"floor {config}: floor {out['floor_ms']} ms, gap "
                 f"{out['gap']}")
        _require(launches["simulate_batch"] == steps
                 and launches["dynamic_shift_sum"] == k4
                 and launches["dynamic_shift_sum_backward"] == k4
                 and out["hidden_launches"]["dynamic_shift_sum"] == k4 // 3,
                 f"floor {config}: launches {launches}, hidden "
                 f"{out['hidden_launches']}")
        _log(f"[floor] {config}: FLOOR {out['floor_ms']:.2f} ms/step, "
             f"measured {out['measured_ms_per_step']:.1f}, gap "
             f"{out['gap']:.3f}; {out['flop_per_step'] / 1e12:.3f} TFLOP, "
             f"top {out['top']} {out['top_share'] * 100:.1f}%; calibration "
             f"{(out['calibration_flop_per_s'] or 0) / 1e12:.1f} TF/s; "
             f"hidden bound ms {out['hidden_bound_ms']}; {out['card']}; "
             f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    return paths


def phase_close_floor(torch, dev):
    """[close-floor]: scripts/close_floor.py for ETNet at its shape and
    ERAFT at T = CLOSE_ERAFT_T: S_all, S_zeros, the simulator, the
    constituents, the residual and the fill. Returns the launches."""
    from v2v_tpu_torch.scripts import close_floor
    paths = {}
    for config, cut in (("etnet", {}),
                        ("eraft", {"sequence_length": CLOSE_ERAFT_T})):
        _zero_launches()
        t0 = time.perf_counter()
        out = close_floor.run(config, dev, steps=2, iters=3, **cut)
        torch.cuda.synchronize()
        paths[f"close-floor-{config}"] = _read_launches()
        parts = (out["teacher_ms"] + out["sim_ms"] + out["constituents_ms"]
                 + out["residual_ms"])
        _require(abs(parts - out["s_all_ms"]) <= 1e-6 * out["s_all_ms"]
                 and out["constituents_ms"] > 0 and out["sim_ms"] > 0,
                 f"close-floor {config}: {out}")
        _require(paths[f"close-floor-{config}"]["simulate_batch"] > 0,
                 f"close-floor {config}: K1 not launched")
        _log(f"[close-floor] {config} (B={out['batch']}, T={out['T']}): "
             f"S_all {out['s_all_ms']:.1f} ms, S_zeros "
             f"{out['s_zeros_ms']:.1f}, teacher {out['teacher_ms']:.1f}, sim "
             f"{out['sim_ms']:.3f}, scan {out['scan_ms']:.1f}, P "
             f"{out['constituents_ms']:.1f}, residual "
             f"{out['residual_ms']:.1f}, fill {out['fill']:.3f}; "
             f"{time.perf_counter() - t0:.1f} s")
    return paths


# [tools]: minimal_train's steps, the ESIM renderer's PNGs (41 frames of
# 5 bins) and the cache writer's core on a few EVAID-sized frames
TOOLS_STEPS = 5
TOOLS_ESIM_PNGS = 8
TOOLS_CACHE_FRAMES = 5


def _png_shape(path):
    """(height, width) of an 8-bit grayscale PNG, from its IHDR, after
    checking that its IDAT inflates to one filter byte and `width` pixels
    a row (the card's machine has no cv2 to read it)."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    _require(data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR",
             f"{path}: not a PNG")
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    _require(depth == 8 and color == 0
             and len(zlib.decompress(idat)) == h * (w + 1),
             f"{path}: {w}x{h}, depth {depth}, color type {color}")
    return h, w


def phase_tools(torch, dev, seed):
    """[tools]: the port's last tools on the card. minimal_train.main
    (the library example: TOOLS_STEPS steps of the width-8 E2VID on
    drifting video, K1 once a step, the losses finite and falling, then a
    streaming forward); visualize_esim_sample.render on its synthetic
    source (ops/voxel.py::simulate_sequence on the card) into a temporary
    directory, TOOLS_ESIM_PNGS voxel and frame PNGs of 128x128 and counts
    finite and integral; testh5_to_voxel_cache.cache_arrays on an
    EVAID-sized HQF-layout file held in memory (data/synthetic.py::
    SyntheticH5Sequence, TOOLS_CACHE_FRAMES frames, 400,000 events
    between each two; no h5py there), read by the port's TestH5Dataset
    through the C++ builder, equal to events_to_voxel_np on each window's
    events and to the stored frames, its host ms a frame (a median of 3)
    beside the builder's alone on the same windows. Returns the
    launches."""
    import shutil
    import numpy as np
    from v2v_tpu_torch.data.native import events_to_voxel_native
    from v2v_tpu_torch.data.synthetic import SyntheticH5Sequence
    from v2v_tpu_torch.ops.voxel import events_to_voxel_np
    from v2v_tpu_torch.scripts import (minimal_train, testh5_to_voxel_cache,
                                       visualize_esim_sample)
    tag = "tools"
    _zero_launches()
    t0 = time.perf_counter()
    out = minimal_train.main(dev, TOOLS_STEPS)
    torch.cuda.synchronize()
    launches = _read_launches()
    losses = out["losses"]
    _require(out["k1_launches"] == TOOLS_STEPS
             and launches["simulate_batch"] == TOOLS_STEPS,
             f"{tag}: K1 launched {out['k1_launches']} times in "
             f"{TOOLS_STEPS} steps ({launches})")
    _require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
             and all(math.isfinite(x) for x in out["pred_range"]),
             f"{tag}: minimal_train losses {losses}, prediction range "
             f"{out['pred_range']}")
    _log(f"[{tag}] minimal_train B={minimal_train.B} T={minimal_train.T} "
         f"{minimal_train.H}x{minimal_train.W}: losses "
         + ", ".join(f"{x:.4f}" for x in losses) + f"; synchronized ms a "
         f"step after the first {statistics.median(out['step_ms'][1:]):.2f} "
         f"(all: " + ", ".join(f"{x:.2f}" for x in out["step_ms"])
         + f"); prediction {out['pred_shape']} in {out['pred_range']}; K1 "
         f"{out['k1_launches']} launches")

    root = tempfile.mkdtemp(prefix="chip_smoke_esim_")
    try:
        t1 = time.perf_counter()
        vis = visualize_esim_sample.render("synthetic", root, dev, seed)
        vis_s = time.perf_counter() - t1
        shapes = {os.path.basename(p): _png_shape(p) for p in vis["paths"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    v = vis["voxels"]
    for kind in ("voxel", "frame"):
        named = [k for k in shapes if k.startswith(kind + "_")]
        _require(len(named) == TOOLS_ESIM_PNGS and all(
            shapes[k] == (visualize_esim_sample.H, visualize_esim_sample.W)
            for k in named), f"{tag}: {kind} PNGs {sorted(named)}")
    _require(np.isfinite(v).all() and np.array_equal(v, np.round(v))
             and np.abs(v).sum() > 0,
             f"{tag}: the ESIM sample's counts are not finite integers")
    _log(f"[{tag}] visualize_esim_sample synthetic: {len(shapes)} PNGs of "
         f"128x128, voxels {v.shape}, |counts| {float(np.abs(v).sum()):.0f}, "
         f"thresholds {vis['pos_thres']:.3f}/{vis['neg_thres']:.3f}; "
         f"{vis_s:.2f} s")

    bins = 5
    ds = SyntheticH5Sequence("cache", seed, TOOLS_CACHE_FRAMES, EVAL_HW,
                             EVAL_EVENTS_PER_FRAME,
                             testh5_to_voxel_cache.reader_config(bins,
                                                                 False))
    frames, events = testh5_to_voxel_cache.cache_arrays(ds)
    arr = ds.file.arrays
    e = arr["event_idx"]
    t = TOOLS_CACHE_FRAMES - 1
    h, w = EVAL_HW
    windows = [[arr[k][e[i]:e[i + 1]] for k in ("ts", "xs", "ys", "ps")]
               for i in range(t)]
    ms = _host_ms(lambda: testh5_to_voxel_cache.cache_arrays(ds), 3) / t
    builder_ms = _host_ms(lambda: [events_to_voxel_native(
        *ev, num_bins=bins, height=h, width=w) for ev in windows], 3) / t
    _require(frames.shape == (t, h, w) and events.shape == (t, bins, h, w)
             and frames.dtype == events.dtype == np.float32
             and np.array_equal(frames, arr["images"][1:].astype(np.float32)),
             f"{tag}: cache frames {frames.shape}, events {events.shape}")
    for i, ev in enumerate(windows):
        want = events_to_voxel_np(*ev, num_bins=bins, height=h,
                                  width=w).astype(np.float32)
        _require(np.array_equal(events[i], want),
                 f"{tag}: the cache's window {i} differs from numpy by "
                 f"{float(np.abs(events[i] - want).max()):.3g}")
    launches_after = _read_launches()
    _require(launches_after == launches,
             f"{tag}: kernels launched after minimal_train: "
             f"{launches_after}")
    _log(f"[{tag}] testh5_to_voxel_cache core: {t} frames of {h}x{w}, "
         f"{EVAL_EVENTS_PER_FRAME} events each, {bins} bins: {ms:.2f} host "
         f"ms a frame through TestH5Dataset and the C++ builder (the "
         f"builder alone {builder_ms:.2f}), equal to events_to_voxel_np; "
         f"{time.perf_counter() - t0:.1f} s in all")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--profile", action="store_true",
                    help="profile one more train step and one more eval "
                         "frame (a sequence for the flow eval)")
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
        card = phase_device(torch)
        builds = phase_build()
        phase_native_voxel(args.seed, card)
        k2 = phase_k2(torch, dev, args.seed)
        k1 = phase_k1(torch, dev, args.seed, builds["esim.cu"])
        k5 = phase_k5(torch, dev, args.seed, k1["ms"],
                      builds["sim_interleave.cu"])
        k3 = phase_k3(torch, dev, args.seed, builds["attention.cu"])
        k4 = phase_k4(torch, dev, args.seed)
        k4_bwd = phase_k4_backward(torch, dev, args.seed)
        ups = phase_upsample(torch, dev, args.seed)
        phase_reference(torch, dev, args.seed)
        paths = {}
        paths["slice"], slice_ms = phase_slice(torch, dev, args.seed,
                                               args.steps, args.profile)
        paths["driver"], _ = phase_driver(torch, dev, args.seed, slice_ms)
        phase_reference(torch, dev, args.seed, ETNET_TRAIN_MODULE,
                        "etnet-reference")
        paths["etnet-train"], _ = phase_driver(
            torch, dev, args.seed, module=ETNET_TRAIN_MODULE,
            stage=ETNET_TRAIN_STAGE, tag="etnet-train")
        phase_etnet_dropout(torch, dev, args.seed, args.profile)
        phase_ddp(torch, dev, args.seed)
        phase_ddp(torch, dev, args.seed, 1, HYPER_TRAIN_MODULE,
                  HYPER_TRAIN_STAGE, HYPER_BETA)
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
        paths["hyper-train"], _ = phase_slice(
            torch, dev, args.seed, args.steps, args.profile,
            HYPER_TRAIN_MODULE, HYPER_TRAIN_STAGE, HYPER_PARAMS,
            "hyper-train", HYPER_BETA)
        phase_flow_reference(torch, dev, args.seed)
        paths["flow-train"], _ = phase_driver(
            torch, dev, args.seed, module=EVFLOW_TRAIN_MODULE,
            stage=EVFLOW_TRAIN_STAGE, tag="flow-train", task="flow")
        if args.profile:
            phase_flow_profile(torch, dev, args.seed)
        phase_flow_eval(torch, dev, args.seed, args.profile)
        phase_zoo_reference(torch, dev, args.seed)
        paths["e2vidpp-eval"], _ = phase_eval(
            torch, dev, args.seed, args.profile, E2VIDPP_CONFIG, None, 0,
            "e2vidpp-eval", sigmoid_output=False)
        for name, (module, n_params) in ZOO_TRAIN.items():
            paths[f"zoo-train-{name}"], _ = phase_slice(
                torch, dev, args.seed, args.steps,
                args.profile and name == "flownet", module, FLAGSHIP_STAGE,
                n_params, f"zoo-train-{name}")
        phase_eraft_reference(torch, dev, args.seed)
        paths["eraft-train"], _ = phase_driver(
            torch, dev, args.seed, module=ERAFT_TRAIN_MODULE,
            stage=ERAFT_TRAIN_STAGE, tag="eraft-train", task="flow")
        if args.profile:
            phase_flow_profile(torch, dev, args.seed, ERAFT_TRAIN_MODULE,
                               ERAFT_TRAIN_STAGE, "eraft-train-profile")
        phase_flow_eval(torch, dev, args.seed, args.profile,
                        ERAFT_TEST_CONFIG, _eraft_eval_sequences(args.seed),
                        ERAFT_EVAL_PARAMS, "eraft-eval")
        phase_nernet_reference(torch, dev, args.seed)
        paths["nernet-eval"], _ = phase_nernet_eval(torch, dev, args.seed,
                                                    args.profile)
        phase_esim_reference(torch, dev, args.seed)
        paths["esim-train"], _ = phase_driver(
            torch, dev, args.seed, module=ESIM_TRAIN_MODULE,
            stage=ESIM_TRAIN_STAGE, tag="esim-train", stand_in=_ESIMStandIn,
            k1_per_step=0)
        phase_events_ops(torch, dev, args.seed)
        phase_v2e(torch, dev, args.seed)
        paths["webvid-voxel"] = phase_webvid_voxel(torch, dev, args.seed,
                                                   args.steps)
        paths["legacy-data"] = phase_legacy_data(torch, dev, args.seed)
        paths["release"], _ = phase_release(torch, dev, args.seed)
        bench_paths, _ = phase_bench(torch, dev)
        paths.update(bench_paths)
        paths["soak"] = phase_soak(torch, dev)
        paths["rss"] = phase_rss(torch, dev)
        paths.update(phase_floor(torch, dev))
        paths.update(phase_close_floor(torch, dev))
        paths["tools"] = phase_tools(torch, dev, args.seed)
        paths["sim-interleave"] = phase_sim_interleave(torch, dev)
    except Exception as e:   # every phase failure ends the run non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # launches of each kernel on the main paths, each counted from 0 just
    # before its path ran
    kernels = [k1, k2, k3, k4, k4_bwd, k5] + ups
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
