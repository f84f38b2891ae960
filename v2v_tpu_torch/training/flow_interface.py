"""The flow task's interface (port of v2v_tpu/training/flow_interface.py;
reference model/train_flow_utils.py:200-467) for EVFlowNet and ERAFT.

ModelInterface's skeleton, with a per-step voxel -> flow forward
(`forward_type: evflow`) or ERAFT's voxel pairs with its warm-start
carry (`forward_type: eraft`), the flow L1 loss, and the dense/sparse
EPE/1PE/3PE test metrics with validity and event masks. Flows are
channels-last (B,T,H,W,2), as at the base interface.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..losses import losses as L
from ..ops.pad import crop_from_multiple, pad_to_multiple
from .interface import ModelInterface


class FlowModelInterface(ModelInterface):
    """ModelInterface for flow models: `forward_type` 'evflow' (a flow
    for each voxel) or 'eraft' (a flow for each pair of voxels)."""

    def __init__(self, configs: Dict[str, Any], *args, **kwargs):
        self.forward_type = configs.get("forward_type", "evflow")
        if self.forward_type not in ("evflow", "eraft"):
            raise ValueError(f"forward_type {self.forward_type!r}")
        super().__init__(configs, *args, **kwargs)

    @property
    def uses_teacher(self) -> bool:
        """A RAFT source is the flow target itself."""
        return self.loss_cfg.optical_flow_source.startswith("raft")

    def prepare_flow(self, batch: Dict[str, torch.Tensor],
                     test: bool = False) -> Dict[str, torch.Tensor]:
        """The flow target (train_flow_utils.py:305-326): the stored flow
        when the source is 'gt', or at test time when the batch carries
        flow (MVSEC); else zeros, or a RAFT source's pseudo-GT over the
        T+1 frames (flow[t] = teacher(frame[t], frame[t+1])), which
        replaces any stored flow. Flow training always needs a target,
        whatever the loss weights."""
        src = self.loss_cfg.optical_flow_source
        if src == "gt" or (test and "flow" in batch):
            if "flow" not in batch:
                raise KeyError("optical_flow_source=gt but batch has no "
                               "'flow'")
            return batch
        frames = batch["frame"]                     # (B, T+1, H, W, C)
        b, tp1, h, w, _ = frames.shape
        if src == "zeros":
            return dict(batch, flow=frames.new_zeros((b, tp1 - 1, h, w, 2)))
        from .raft import raft_flow
        return dict(batch, flow=raft_flow(self.teacher, frames, 1,
                                          self.teacher_dtype)[:, 1:])

    def forward_sequence(self, events: torch.Tensor, state: Any,
                         train: bool = False, **_
                         ) -> Tuple[torch.Tensor, Any]:
        """events (B,T,H,W,bins) -> (flow (B,T,H,W,2) float32, final
        state); for ERAFT (B,T-1,H,W,2), see `_forward_eraft`. EVFlowNet's
        events are padded to a multiple of 16 and cropped back. A model
        with no state and no BatchNorm runs once over B*T (the same math
        as a step a time step); otherwise one model step per time step."""
        self.model.train(train)
        if self.forward_type == "eraft":
            return self._forward_eraft(events, state, train)
        events, hw = pad_to_multiple(events, 16)
        events, state = self._cast_compute(events, state, train)
        call = self._caller(train)
        b, t = events.shape[:2]
        if self.scan_split and isinstance(state, tuple) and not state:
            flat = events.reshape(b * t, *events.shape[2:])
            out, _ = call(flat.permute(0, 3, 1, 2), state, method="step")
            flows = out["flow"].reshape(b, t, *out["flow"].shape[1:])
            flows = flows.permute(0, 1, 3, 4, 2)
        else:
            outs = []
            for i in range(t):
                out, state = call(events[:, i].permute(0, 3, 1, 2), state,
                                  method="step")
                outs.append(out["flow"].permute(0, 2, 3, 1))
            flows = torch.stack(outs, dim=1)
        return crop_from_multiple(flows, hw).to(torch.float32), state

    def _forward_eraft(self, events: torch.Tensor, state: torch.Tensor,
                       train: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """ERAFT on voxel pairs: flow[t] from (events[t], events[t+1]),
        T_in - 1 flows, with the warm-start flow carried in `state`
        (model/eraft/eraft.py:141-146). No pad here: ERAFT pads to 32
        itself. fnet encodes each voxel once, batched over (T+1)*B (each
        voxel is the second of one pair and the first of the next; fnet's
        instance norm is per sample, so this equals encoding pair by
        pair); then the pairs run in order, and in training cnet's
        BatchNorms take each pair's live statistics, as the reference's
        pair-by-pair training does. In bf16 training the parameters and
        events are cast, the carry stays float32 (a coordinate). Each
        pair's activations stay live for the backward: the JAX package
        rematerializes a pair in the backward to fit a TPU's memory, which
        the card's does not need (PERF.md §3)."""
        if train and self.compute_dtype is not None:
            events = events.to(self.compute_dtype)
        call = self._caller(train)
        b, tp1 = events.shape[:2]
        voxels = events.permute(1, 0, 4, 2, 3)           # (T+1,B,bins,H,W)
        fmaps = call(voxels.reshape(tp1 * b, *voxels.shape[2:]),
                     method="encode")
        fmaps = fmaps.reshape(tp1, b, *fmaps.shape[1:])
        flows = []
        for t in range(tp1 - 1):
            out, state = call(fmaps[t], fmaps[t + 1], voxels[t + 1], state,
                              method="step_with_fmaps")
            flows.append(out["flow"])
        flows = torch.stack(flows, dim=1).permute(0, 1, 3, 4, 2)
        return flows.to(torch.float32), state

    def calc_loss(self, pred: torch.Tensor, batch: Dict[str, torch.Tensor],
                  remove_flow_loss: bool = False
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The flow L1 against the (pseudo-)GT, per (b, t) and averaged
        over T (train_flow_utils.py:371-430). `remove_flow_loss` is
        ignored: the flow target is the task's only one."""
        cfg = self.loss_cfg
        gt = batch["flow"]
        b, t = pred.shape[:2]
        terms: Dict[str, torch.Tensor] = {}
        if cfg.l1_weight:
            per_bt = L.l1_loss(pred.reshape(b * t, *pred.shape[2:]),
                               gt.reshape(b * t, *gt.shape[2:]),
                               cfg.l1_weight, reduce_batch=False)
            terms["l1_loss"] = per_bt.reshape(b, t).mean(dim=1)
        total = sum(v.mean() for v in terms.values())
        aux = dict(terms)
        aux["pred_max_val"] = pred.max()
        aux["pred_min_val"] = pred.min()
        return total, aux


FLOW_METRICS = ["dense_EPE", "dense_1PE", "dense_3PE",
                "sparse_EPE", "sparse_1PE", "sparse_3PE"]


def flow_metrics(pred_flow: np.ndarray, gt_flow: np.ndarray,
                 events: np.ndarray, prefix: str) -> Dict[str, list]:
    """Per-frame dense and sparse EPE, 1PE, 3PE (train_flow_utils.py:
    229-294). All arrays (1,T,H,W,C). Dense counts the pixels whose GT is
    finite and nonzero, sparse those of them with events."""
    t = pred_flow.shape[1]
    out = defaultdict(list)
    for ti in range(t):
        pf = pred_flow[0, ti]                      # (H,W,2)
        gf = gt_flow[0, ti]
        valid = ~(np.isnan(gf[..., 0]) | np.isnan(gf[..., 1])
                  | ((gf[..., 0] == 0) & (gf[..., 1] == 0)))
        ev_mask = np.abs(events[0, ti]).sum(axis=-1) > 0
        sparse = valid & ev_mask
        ee = np.sqrt(((pf - np.nan_to_num(gf)) ** 2).sum(axis=-1))

        def stats(mask):
            cnt = mask.sum()
            if cnt == 0:
                return 0.0, 0.0, 0.0
            mee = np.where(mask, ee, 0.0)
            return (float(mee.sum() / cnt),
                    float((mee > 1).sum() / cnt),
                    float((mee > 3).sum() / cnt))

        for name, val in zip(FLOW_METRICS, stats(valid) + stats(sparse)):
            out[f"{prefix}/{name}"].append(val)
    return out


def flow2rgb_np(disp_x: np.ndarray, disp_y: np.ndarray,
                max_magnitude: Optional[float] = None) -> np.ndarray:
    """HSV flow picture, hue the direction and value the magnitude
    (train_flow_utils.py:22-106). Returns (H,W,3) uint8 RGB."""
    magnitude = np.sqrt(disp_x ** 2 + disp_y ** 2)
    angle = np.arctan2(disp_y, disp_x)
    h = (angle + np.pi) / (2 * np.pi)
    if max_magnitude is None:
        v = magnitude / max(float(magnitude.max()), 1e-5)
    else:
        v = np.clip(magnitude / max_magnitude, 0, 1)
    hp = h * 6.0
    i = np.floor(hp).astype(int) % 6
    f = hp - np.floor(hp)
    p = np.zeros_like(v)
    q = v * (1.0 - f)
    t = v * f
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return (np.stack([r, g, b], axis=-1) * 255.0).astype(np.uint8)
