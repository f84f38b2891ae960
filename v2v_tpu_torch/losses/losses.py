"""Training losses and metrics over NHWC tensors, (B, H, W, C): images,
voxels with their bins as channels, and flow with its (x, y) channels
(port of v2v_tpu/losses/losses.py; reference model/loss.py and
utils/loss.py). NHWC is the layout the port's loss boundary shares with
`warp_by_flow` and LPIPS's inputs.

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


def _align_corners_false_flow(flow: torch.Tensor, h: int, w: int
                              ) -> torch.Tensor:
    """Fold torch grid_sample(align_corners=False) into a flow (B,H,W,2)
    for the align_corners=True `warp_by_flow`. The reference's
    warping_flow and voxel_warping losses normalize their grids by
    (size-1) but sample without align_corners=True (utils/loss.py:105,
    146), so intended coordinate c samples c*S/(S-1) - 0.5 per axis."""
    jj = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
    ii = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
    fx = jj / (w - 1) - 0.5 + flow[..., 0] * (w / (w - 1))
    fy = ii / (h - 1) - 0.5 + flow[..., 1] * (h / (h - 1))
    return torch.stack([fx, fy], dim=-1)


def warping_flow_loss(image0: torch.Tensor, image1: torch.Tensor,
                      flow01: torch.Tensor) -> torch.Tensor:
    """Photometric warp error for self-supervised flow: images (B,H,W,C),
    flow01 (B,H,W,2) in pixels (reference utils/loss.py:72-111,
    align_corners=False there)."""
    _, h, w, _ = image0.shape
    image0_warped = warp_by_flow(image0,
                                 _align_corners_false_flow(flow01, h, w))
    return (image1 - image0_warped).abs().mean()


def voxel_warping_flow_loss(voxel: torch.Tensor, displacement: torch.Tensor,
                            reverse_time: bool = False) -> torch.Tensor:
    """Contrast maximization: warp each bin of `voxel` (B,H,W,bins) along
    `displacement` (B,H,W,2) scaled by the bin's time, and take the
    negative unbiased variance of the summed image; forward plus reverse
    passes (reference utils/loss.py:114-159). The reference's channel
    swap, square meshgrid and [y, x] stacking cancel, so this is the
    x = channel 0, y = channel 1 warp with align_corners=False sampling,
    as the JAX package's. `reverse_time` is the reference's unused
    argument."""
    _, h, w, c = voxel.shape
    increment = 1.0 / (c - 1.0)

    def one_direction(disp: torch.Tensor, reverse: bool) -> torch.Tensor:
        warped_sum = voxel.new_zeros(voxel.shape[:-1] + (1,))
        for i in range(c):
            ratio = (1.0 - i * increment) if reverse else i * increment
            flow = _align_corners_false_flow(disp * ratio, h, w)
            warped_sum = warped_sum + warp_by_flow(voxel[..., i:i + 1], flow)
        # torch's Tensor.var() is unbiased by default (utils/loss.py:149)
        return -warped_sum.var()

    return one_direction(displacement, False) + \
        one_direction(-displacement, True)


def mse_metric(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over every element, any layout."""
    return ((pred - target) ** 2).mean()


def combined_perceptual_loss(lpips, pred_img: torch.Tensor,
                             pred_flow: torch.Tensor,
                             target_img: torch.Tensor,
                             target_flow: torch.Tensor,
                             weight: float = 1.0) -> torch.Tensor:
    """LPIPS of the image (B,H,W,1) and flow (B,H,W,2) channels
    concatenated into one 3-channel NHWC input (reference
    model/loss.py:8-24). `lpips(a, b, normalize=False)` -> (B,)."""
    pred = torch.cat([pred_img, pred_flow], dim=-1)
    target = torch.cat([target_img, target_flow], dim=-1)
    return weight * lpips(pred, target, normalize=False).mean()


def flow_perceptual_loss(lpips, pred: torch.Tensor, target: torch.Tensor,
                         weight: float = 1.0) -> torch.Tensor:
    """LPIPS of each flow component of (B,H,W,2), averaged (reference
    model/loss.py:64-79)."""
    dx = lpips(pred[..., 0:1], target[..., 0:1], normalize=False)
    dy = lpips(pred[..., 1:2], target[..., 1:2], normalize=False)
    return weight * (dx + dy).mean() / 2
