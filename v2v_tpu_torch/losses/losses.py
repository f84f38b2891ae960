"""Training losses over NHWC tensors (port of v2v_tpu/losses/losses.py:
l1_loss, l2_loss and temporal_consistency_loss).

Per-batch losses return (B,) when reduce_batch=False, for the
per-source bookkeeping of calc_loss.
"""
from __future__ import annotations

import torch

from ..ops.warp import warp_by_flow


def _reduce(x: torch.Tensor, reduce_batch: bool) -> torch.Tensor:
    if reduce_batch:
        return x.mean()
    return x.reshape(x.shape[0], -1).mean(dim=1)


def l1_loss(pred: torch.Tensor, target: torch.Tensor, weight: float = 1.0,
            reduce_batch: bool = True) -> torch.Tensor:
    """Reference model/loss.py:135-147."""
    return weight * _reduce((pred - target).abs(), reduce_batch)


def l2_loss(pred: torch.Tensor, target: torch.Tensor, weight: float = 1.0,
            reduce_batch: bool = True) -> torch.Tensor:
    """Reference model/loss.py:121-133: the mean squared error."""
    return weight * _reduce((pred - target) ** 2, reduce_batch)


def temporal_consistency_loss(image0, image1, processed0, processed1,
                              flow01, alpha: float = 50.0,
                              reduce_batch: bool = True) -> torch.Tensor:
    """Lai et al. ECCV'18 temporal loss (reference utils/loss.py:6-69).

    Warps the previous image and reconstruction to the current frame by
    `flow01` (the caller negates the flow, model/loss.py:166-182), masks
    by a visibility map from the ground-truth frames, and measures the
    relative absolute error. `processed0` is clamped to [0, 255], which
    closes the +inf prediction exploit (utils/loss.py:45-46)."""
    processed0 = processed0.clamp(0.0, 255.0)
    c0 = image0.shape[-1]
    warped = warp_by_flow(torch.cat([image0, processed0], dim=-1), flow01)
    image0_warped, processed0_warped = warped[..., :c0], warped[..., c0:]
    visibility = torch.exp(-alpha * (image1 - image0_warped) ** 2)
    div = processed1.abs() + processed0_warped.abs() + 1e-5
    tc_map = visibility * (processed1 - processed0_warped).abs() / div
    return _reduce(tc_map, reduce_batch)
