"""The reconstruction loss of HYLZ-2019/V2V's train configs in plain
PyTorch (model/loss.py, utils/loss.py): L1, LPIPS-VGG and the temporal
consistency of Lai et al. (ECCV 2018) against the teacher's flow, each
averaged over the T frames of a clip, weighed and summed. Returns one
number a clip, so that the batch's loss is their mean and a block of
clips can be differentiated alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(i, j) = img(i + fy, j + fx), bilinear with zero padding,
    align_corners True: img (N, H, W, C), flow (N, H, W, 2) in pixels."""
    n, h, w, _ = img.shape
    xx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None]
    yy = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
    grid = torch.stack([(xx + flow[..., 0]) * (2.0 / (w - 1)) - 1.0,
                        (yy + flow[..., 1]) * (2.0 / (h - 1)) - 1.0], -1)
    return F.grid_sample(img.permute(0, 3, 1, 2), grid.to(img.dtype),
                         mode="bilinear", padding_mode="zeros",
                         align_corners=True).permute(0, 2, 3, 1)


def temporal_consistency(image0, image1, pred0, pred1, flow01,
                         alpha: float = 50.0) -> torch.Tensor:
    """(N,) mean of the visibility-masked relative error of pred1 against
    pred0 warped by flow01."""
    pred0 = pred0.clamp(0.0, 255.0)
    c = image0.shape[-1]
    warped = warp(torch.cat([image0, pred0], -1), flow01)
    vis = torch.exp(-alpha * (image1 - warped[..., :c]) ** 2)
    pw = warped[..., c:]
    tc = vis * (pred1 - pw).abs() / (pred1.abs() + pw.abs() + 1e-5)
    return tc.reshape(tc.shape[0], -1).mean(1)


def clip_losses(loss_cfg: dict, pred: torch.Tensor, frames: torch.Tensor,
                flow: torch.Tensor, lpips) -> torch.Tensor:
    """pred, frames (B, T, H, W, 1), flow (B, T, H, W, 2) -> (B,) the sum
    of the weighed terms of each clip."""
    b, t = pred.shape[:2]
    flat = lambda x: x.reshape(-1, *x.shape[2:])
    total = torch.zeros(b, dtype=torch.float32, device=pred.device)
    if loss_cfg.get("l1_weight"):
        l1 = (pred - frames).abs().reshape(b, t, -1).mean(2).mean(1)
        total = total + loss_cfg["l1_weight"] * l1
    if loss_cfg.get("lpips_weight"):
        d = lpips(flat(pred), flat(frames)).reshape(b, t).mean(1)
        total = total + loss_cfg["lpips_weight"] * d
    l0 = loss_cfg.get("temporal_consistency_L0", 1)
    if loss_cfg.get("temporal_consistency_weight") and t > l0:
        tc = temporal_consistency(
            flat(frames[:, l0 - 1:-1]), flat(frames[:, l0:]),
            flat(pred[:, l0 - 1:-1]), flat(pred[:, l0:]),
            -flat(flow[:, l0:]))
        total = total + loss_cfg["temporal_consistency_weight"] * tc.reshape(
            b, t - l0).sum(1) / t
    return total
