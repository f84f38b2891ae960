"""Train step with voxel synthesis inside it, and the eval step (port of
v2v_tpu/training/steps.py: synthesize_batch, make_train_step and
make_eval_step).

The host ships uint8 video; threshold sampling, event simulation (K1 on
the card), bin summation, GT frame selection, the teacher's pseudo-GT
flow, the forward, the loss, the backward and the optimizer update all
run in one `step(batch, generator)`.

Batch contract (simulator path): video (B, N, H, W) uint8/float,
N = L*num_bins*frames_per_bin + 1, data_source_idx (B,), optional
pos_thres / neg_thres (B,). Pre-voxelized path (sim_cfg=None): events
(B,T,H,W,bins), frame (B,T,H,W,1) [, flow (B,T,H,W,2)].
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from ..ops import voxel_cuda
from ..ops.voxel import (SimConfig, SimParams, esim_video_to_voxel,
                         sample_sim_params)
from .interface import ModelInterface


def bin_and_select(counts: torch.Tensor, video: torch.Tensor,
                   num_bins: int, frames_per_bin: int,
                   extra_frame: bool = False, extra_evs: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N-1, H, W) counts (K1's bfloat16, or float32) -> float32
    events (B,G,H,W,bins) NHWC, and GT frames (B,F,H,W,1) in [0, 1]
    picked from the video. The bins are summed in float32 straight from
    the counts, with no float32 copy of them.

    Default: G = F = L, frame i is video[(i+1)*fpi]. extra_frame: F = L+1
    frames at i*fpi. extra_evs: the video carries fpi extra leading
    frames, G = L+1 groups and the frames shift by fpi."""
    b, n1, h, w = counts.shape
    fpi = num_bins * frames_per_bin
    groups = n1 // fpi
    voxels = counts.reshape(b, groups, num_bins, frames_per_bin, h,
                            w).sum(3, dtype=torch.float32)
    events = voxels.permute(0, 1, 3, 4, 2)
    base = fpi if extra_evs else 0
    n_frames = groups - (1 if extra_evs else 0)
    idx = torch.arange(n_frames + (1 if extra_frame else 0),
                       device=video.device)
    gt_idx = base + (idx if extra_frame else idx + 1) * fpi
    gt = video[:, gt_idx].to(torch.float32) / 255.0
    return events, gt[..., None]


def synthesize_batch(video: torch.Tensor, generator: torch.Generator,
                     sim_cfg: SimConfig, num_bins: int, frames_per_bin: int,
                     extra_frame: bool = False, extra_evs: bool = False,
                     fixed_pos: Optional[torch.Tensor] = None,
                     fixed_neg: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,N,H,W) video -> events (B,G,H,W,bins) NHWC and GT frames
    (B,F,H,W,1). Parameters and seeds come from `generator` (on the
    video's device); the counts from K1 for a CUDA video, from its plain
    version for a CPU one. `put_noise_external` stays on the plain
    generator path (the kernel implements potential noise only)."""
    b = video.shape[0]
    if (fixed_pos is None) != (fixed_neg is None):
        raise ValueError("fixed_pos and fixed_neg must be given together "
                         "(per-video fixed thresholds pin both polarities)")
    if generator.device != video.device:
        raise ValueError(f"generator on {generator.device}, video on "
                         f"{video.device}")
    params = sample_sim_params(generator, sim_cfg, b, fixed_pos, fixed_neg)
    if sim_cfg.put_noise_external:
        counts = torch.stack([
            esim_video_to_voxel(video[i], SimParams(*(p[i] for p in params)),
                                generator=generator, put_noise_external=True)
            for i in range(b)])
    else:
        seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=generator,
                              device=video.device, dtype=torch.int32)
        counts = voxel_cuda.simulate_batch(video, seeds, params)
    return bin_and_select(counts, video, num_bins, frames_per_bin,
                          extra_frame, extra_evs)


def make_train_step(interface: ModelInterface,
                    optimizer: torch.optim.Optimizer,
                    sim_cfg: Optional[SimConfig] = None,
                    num_bins: int = 5, frames_per_bin: int = 1,
                    extra_frame: bool = False, extra_evs: bool = False):
    """Build `step(batch, generator=None, hyper_beta=0.0) -> (loss, aux)`.
    With `sim_cfg` the batch follows the raw-video contract and
    `generator` (on the interface's device) draws the simulator
    parameters and seeds. When the interface's `hyper_epochs` > 0 the
    forward runs HyperE2VID's GT-mixing curriculum with `hyper_beta`.
    BatchNorm running statistics are buffers: the forward updates them
    in place, step after step, and the optimizer never sees them. `aux`
    holds the per-sample loss terms (B,), pred stats and grad_norm."""
    params = [p for p in interface.model.parameters() if p.requires_grad]
    use_hyper = interface.hyper_epochs > 0
    if interface.loss_cfg.temporal_consistency_weight and \
            interface.loss_cfg.optical_flow_source.startswith("raft"):
        interface.teacher    # build the teacher before the first step

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             hyper_beta: float = 0.0):
        if sim_cfg is not None:
            if generator is None:
                raise ValueError("the simulator path needs a generator")
            with record_function("v2v.synthesize"):
                events, gt = synthesize_batch(
                    batch["video"], generator, sim_cfg, num_bins,
                    frames_per_bin, extra_frame=extra_frame,
                    extra_evs=extra_evs, fixed_pos=batch.get("pos_thres"),
                    fixed_neg=batch.get("neg_thres"))
            batch = dict(batch, events=events, frame=gt)
        with record_function("v2v.teacher"):
            batch = interface.prepare_flow(batch)
        b, _, h, w, _ = batch["events"].shape
        state0 = interface.init_state(b, h, w)
        optimizer.zero_grad(set_to_none=True)
        with record_function("v2v.forward"):
            pred, _ = interface.forward_sequence(
                batch["events"], state0, train=True,
                gt_frames=batch["frame"] if use_hyper else None,
                hyper_beta=hyper_beta if use_hyper else None)
        with record_function("v2v.loss"):
            loss, aux = interface.calc_loss(pred, batch)
        with record_function("v2v.backward"):
            loss.backward()
        with record_function("v2v.optimizer"):
            aux["grad_norm"] = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(p.grad) for p in params
                 if p.grad is not None]))
            optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    return step


def make_eval_step(interface: ModelInterface):
    """Streaming-eval step: forward a chunk with carried state, no
    gradients (reset handled by the caller per sequence,
    test_e2vid.py:53-61)."""

    @torch.no_grad()
    def step(events: torch.Tensor, state):
        return interface.forward_sequence(events, state, train=False)

    return step
