"""Validation preview grids: (events | prediction | ground truth) video
strips for TensorBoard (port of v2v_tpu/training/preview.py::
make_preview; reference model/train_utils.py:460-481). The flow task's
preview waits for the flow family (ROADMAP P8)."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..ops.normalize import normalize_nobias


def make_preview(batch: Dict[str, np.ndarray], pred: np.ndarray) -> np.ndarray:
    """batch['events'] (B,T,H,W,C), batch['frame'] (B,T,H,W,1|3),
    pred (B,T,H,W,1|3) in [0,1] -> (B,T,3,H,3W) uint8 video grid
    (tensorboardX add_video layout)."""
    events = np.asarray(batch["events"])
    frames = np.asarray(batch["frame"])
    pred = np.asarray(pred)
    t = pred.shape[1]
    frames = frames[:, -t:]
    if events.shape[1] > t:
        events = events[:, 1:]

    ev_vis = normalize_nobias(events.sum(axis=-1)) * 255
    ev_vis = np.repeat(ev_vis[..., None], 3, axis=-1)
    pred_vis = pred * 255
    if pred_vis.shape[-1] == 1:
        pred_vis = np.repeat(pred_vis, 3, axis=-1)
    pred_vis = pred_vis[..., ::-1]            # BGR -> RGB
    gt_vis = frames * 255
    if gt_vis.shape[-1] == 1:
        gt_vis = np.repeat(gt_vis, 3, axis=-1)
    gt_vis = gt_vis[..., ::-1]

    vis = np.concatenate([ev_vis, pred_vis, gt_vis], axis=3)  # along W
    vis = np.clip(vis, 0, 255).astype(np.uint8)
    return vis.transpose(0, 1, 4, 2, 3)       # (B,T,3,H,3W)
