"""Task interface: sequence forward + loss for the reconstruction
models (E2VID and the rest of the UNet zoo, FireNet, ETNet, HyperE2VID,
NerNet's raw-event path; port of
v2v_tpu/training/interface.py::ModelInterface).

Batch layout at this interface is the JAX package's channels-last one:
events (B,T,H,W,bins), frame (B,T,H,W,1), flow (B,T,H,W,2). The model
runs NCHW inside.

`compute_dtype: bfloat16` follows the JAX semantics rather than
autocast: the forward runs on bf16 copies of the f32 master parameters
(torch.func.functional_call), with bf16 events and recurrent state; the
gradients reach the f32 parameters, and predictions and loss are f32.
LPIPS runs in the same compute dtype; the RAFT teacher runs in bf16
under no_grad.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..config import instantiate_from_config
from ..losses import losses as L
from ..losses.lpips import LPIPS
from ..models.eitr import EITR
from ..models.init import materialize
from ..ops.normalize import normalize_batch_voxel
from ..ops.pad import crop_from_multiple, pad_to_multiple


class LossConfig(NamedTuple):
    """The `module.loss` config block (train_utils.py:250-279)."""
    lpips_weight: float = 0.0
    lpips_type: str = "vgg"
    lpips_remat: str = "full"
    l1_weight: float = 0.0
    l2_weight: float = 0.0
    temporal_consistency_weight: float = 0.0
    temporal_consistency_L0: int = 1
    optical_flow_source: str = "gt"   # gt | zeros | raft_small | raft_large
    raft_num_flow_updates: int = 12

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LossConfig":
        if d.get("lpips_remat", "full") not in ("full", "none"):
            raise ValueError(f"lpips_remat must be 'full' or 'none', got "
                             f"{d['lpips_remat']!r}")
        if d.get("ssim_weight", 0):
            # disabled in the reference too (model/loss.py:149-157)
            raise ValueError("ssim_weight != 0 is unsupported, as in the "
                             "reference; set it to 0")
        return cls(**{k: v for k, v in d.items() if k in cls._fields})


_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


class ModelInterface:
    """Builds the model from config on `device` (parameters drawn from
    `generator`) and runs the sequence forward and the loss.

    `lpips`, `lpips_test` and `teacher` may be passed in (e.g. an
    explicitly random trunk or teacher); otherwise they are built from
    config, and the teacher needs $V2V_WEIGHTS_DIR/<source>.pth or
    V2V_RANDOM_TEACHER.
    """

    _lpips_lock = threading.Lock()

    def __init__(self, configs: Dict[str, Any], device=None,
                 generator: Optional[torch.Generator] = None,
                 lpips: Optional[LPIPS] = None, teacher=None,
                 lpips_test: Optional[LPIPS] = None):
        self.configs = configs
        self.device = resolve_device(device)
        self.model = materialize(
            lambda: instantiate_from_config(configs["model"]), self.device,
            generator)
        self.loss_cfg = LossConfig.from_dict(configs.get("loss", {}))
        self.normalize_voxels = configs.get("normalize_voxels", False)
        self.compute_dtype = _DTYPES[configs.get("compute_dtype", None)]
        # the split and batched forwards run over B*T at once, which would
        # change the live statistics of a norm with running statistics
        # (BatchNorm, TorchInstanceNorm) in training
        self.scan_split = configs.get("scan_split", True) and not any(
            isinstance(m, torch.nn.modules.batchnorm._NormBase)
            and m.track_running_stats for m in self.model.modules())
        # the HyperE2VID GT-mixing curriculum: beta = 1 - epoch/hyper_epochs
        self.hyper_epochs = configs.get("hyper_epochs", 0)
        # NerNet voxelizes raw events inside the model, one sample at a
        # time (forward_sequence_nernet)
        self.is_nernet = configs.get("is_nernet", False)
        # the pseudo-GT teacher's dtype (v2v_tpu raft_flow's default)
        self.teacher_dtype: Optional[torch.dtype] = torch.bfloat16
        self.lpips_train = lpips
        if self.loss_cfg.lpips_weight and lpips is None:
            self.lpips_train = LPIPS(self.loss_cfg.lpips_type, self.device)
        self._lpips_test = lpips_test
        self._teacher = teacher

    @property
    def lpips_test(self) -> LPIPS:
        """The test metric's LPIPS, always AlexNet (train_utils.py:198),
        built at first use; locked, since the eval harness's metric
        threads reach it."""
        if self._lpips_test is None:
            with self._lpips_lock:
                if self._lpips_test is None:
                    self._lpips_test = LPIPS("alex", self.device)
        return self._lpips_test

    @property
    def uses_teacher(self) -> bool:
        """Whether a train step needs the RAFT teacher's pseudo-GT."""
        return bool(self.loss_cfg.temporal_consistency_weight) and \
            self.loss_cfg.optical_flow_source.startswith("raft")

    @property
    def teacher(self):
        if self._teacher is None:
            from .raft import load_teacher
            self._teacher = load_teacher(self.loss_cfg.optical_flow_source,
                                         self.loss_cfg.raft_num_flow_updates,
                                         self.device)
        return self._teacher

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32):
        """The model's zero state for (height, width) frames: at the
        multiple of 16 that forward_sequence pads to, or, for NerNet,
        which pads inside, at the frames' own size."""
        if self.is_nernet:
            return self.model.init_state(batch, height, width, dtype,
                                         self.device)
        ph = -(-height // 16) * 16
        pw = -(-width // 16) * 16
        return self.model.init_state(batch, ph, pw, dtype, self.device)

    # -- forward --------------------------------------------------------
    def _caller(self, train: bool):
        """model(*args, method=m, **kw), on compute-dtype parameter copies
        when training in bf16. A module registered under two names (ERAFT
        cnet's norm3, also its downsample.1) is one object, swapped once:
        with tie_weights, functional_call swaps it under both names and
        restores the second from the first's copy, which left the bf16
        copies in the model after the call."""
        if train and self.compute_dtype is not None:
            params = {k: v.to(self.compute_dtype)
                      for k, v in self.model.named_parameters()}
            return lambda *a, method, **kw: functional_call(
                self.model, params, a, {"method": method, **kw},
                tie_weights=False)
        return lambda *a, method, **kw: self.model(*a, method=method, **kw)

    def _cast_compute(self, events: torch.Tensor, state: Any, train: bool
                      ) -> Tuple[torch.Tensor, Any]:
        """The events and the recurrent state in the compute dtype when
        training in bf16 (`_caller` gives the parameters)."""
        if train and self.compute_dtype is not None:
            return (events.to(self.compute_dtype),
                    _cast(state, self.compute_dtype))
        return events, state

    def forward_sequence(self, events: torch.Tensor, state: Any,
                         train: bool = False,
                         gt_frames: Optional[torch.Tensor] = None,
                         hyper_beta: Optional[float] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, Any]:
        """events (B,T,H,W,bins) -> (pred (B,T,H,W,C) float32, final
        state); the model's "image" output, any "flow" output is dropped.
        With `normalize_voxels` the events are normalized first
        (normalize_batch_voxel). In training, unless the model has norms
        with running statistics or the HyperE2VID curriculum is on
        (`gt_frames` (B,T,H,W,1) and `hyper_beta` given: its prediction
        feeds back), a model with the split entry points runs the split
        forward and a model with no state (`state == ()`) one call over
        B*T; otherwise one model step per time step. The model is in
        training mode only when `train`. `generator` draws ETNet's
        dropout masks: the split forward's tail takes them in one draw
        over B*T (as the JAX package's one dropout key does), the
        per-step path a draw a time step; a model without dropout
        ignores it."""
        self.model.train(train)
        if self.normalize_voxels:
            events = normalize_batch_voxel(events)
        events, hw = pad_to_multiple(events, 16)
        use_hyper = gt_frames is not None and hyper_beta is not None
        if use_hyper:
            gt_frames, _ = pad_to_multiple(gt_frames, 16)
        events, state = self._cast_compute(events, state, train)
        if use_hyper and train and self.compute_dtype is not None:
            gt_frames = gt_frames.to(self.compute_dtype)
        call = self._caller(train)
        kw = {"generator": generator} if isinstance(self.model, EITR) else {}
        batched = train and self.scan_split and not use_hyper
        if batched and hasattr(self.model, "spine_step"):
            imgs, state = self._forward_split(call, events, state, kw)
        elif batched and isinstance(state, tuple) and not state:
            b, t = events.shape[:2]
            flat = events.reshape(b * t, *events.shape[2:])
            out, _ = call(flat.permute(0, 3, 1, 2), state, method="step")
            img = out["image"]
            imgs = img.reshape(b, t, *img.shape[1:]).permute(0, 1, 3, 4, 2)
        else:
            outs = []
            for i in range(events.shape[1]):
                args = (events[:, i].permute(0, 3, 1, 2), state)
                if use_hyper:
                    args += (gt_frames[:, i].permute(0, 3, 1, 2), hyper_beta)
                out, state = call(*args, method="step", **kw)
                outs.append(out["image"].permute(0, 2, 3, 1))
            imgs = torch.stack(outs, dim=1)
        return crop_from_multiple(imgs, hw).to(torch.float32), state

    @torch.no_grad()
    def forward_sequence_nernet(self, events_list: List[np.ndarray], state
                                ) -> Tuple[torch.Tensor, Any]:
        """NerNet's raw-event path (train_utils.py:350-378), in eval: B=1,
        one model step a time step over `events_list`, each (N,5) float64
        [x,y,t,p,b]. Returns (pred (1,T,H,W,1) float32, final state).

        The timestamps are shifted to a zero origin in float64 before the
        float32 cast: raw h5 stamps are absolute seconds, whose float32
        values collapse the per-event deltas (the reference normalizes in
        float64 for the same reason, testh5.py:329-330)."""
        self.model.eval()
        preds = []
        for evs in events_list:
            evs = np.array(evs, np.float64)
            if evs.shape[0]:
                evs[:, 2] -= evs[0, 2]
            out, state = self.model(
                torch.as_tensor(evs.astype(np.float32), device=self.device),
                state)
            preds.append(out["image"].permute(0, 2, 3, 1))
        return torch.stack(preds, dim=1).to(torch.float32), state

    def _forward_split(self, call, events: torch.Tensor, state, tail_kw):
        """pre over B*T, a loop over T for the recurrent spine, tail over
        B*T (v2v_tpu interface._forward_split: same math, reassociated);
        `tail_kw` goes to the tail, which holds ETNet's dropout."""
        b, t = events.shape[:2]
        flat = events.reshape(b * t, *events.shape[2:]).permute(0, 3, 1, 2)
        head, pre0 = call(flat, method="pre")
        pre0 = pre0.reshape(b, t, *pre0.shape[1:])
        per_step = []
        for i in range(t):
            blocks, state = call(pre0[:, i], state, method="spine_step")
            per_step.append(blocks)
        blocks = [torch.stack(z, dim=1).reshape(b * t, *z[0].shape[1:])
                  for z in zip(*per_step)]
        img = call(head, blocks, method="tail", **tail_kw)["image"]
        img = img.reshape(b, t, *img.shape[1:]).permute(0, 1, 3, 4, 2)
        return img, state

    # -- loss -----------------------------------------------------------
    def _lpips_term(self, pred: torch.Tensor, frames: torch.Tensor
                    ) -> torch.Tensor:
        """(B,) LPIPS averaged over T, chunked over T: the GT branch's
        features once under no_grad, each pred chunk rematerialized in
        the backward unless lpips_remat is 'none'."""
        b, t = pred.shape[:2]
        chunk = max(c for c in (10, 8, 5, 4, 2, 1) if t % c == 0)
        chunk_env = os.environ.get("V2V_LPIPS_CHUNK")
        if chunk_env:
            chunk = int(chunk_env)
            if chunk < 1 or t % chunk != 0:
                raise ValueError(f"V2V_LPIPS_CHUNK={chunk} must be a "
                                 f"positive divisor of T={t}")
        lp, cd = self.lpips_train, self.compute_dtype
        pt = pred.transpose(0, 1).reshape(t // chunk, chunk * b,
                                          *pred.shape[2:])
        gt = frames.transpose(0, 1).reshape(t // chunk, chunk * b,
                                            *frames.shape[2:])

        def dist(p, *gf):
            return lp.dist_from_features(lp.features(lp.prep(p, True, cd)),
                                         list(gf))

        d = []
        for p, g in zip(pt, gt):
            with torch.no_grad():
                gf = lp.features(lp.prep(g, True, cd))
            if self.loss_cfg.lpips_remat != "none" and torch.is_grad_enabled():
                d.append(checkpoint(dist, p, *gf, use_reentrant=False))
            else:
                d.append(dist(p, *gf))
        return torch.stack(d).reshape(t, b).T.mean(dim=1)

    def calc_loss(self, pred: torch.Tensor, batch: Dict[str, torch.Tensor],
                  remove_flow_loss: bool = False
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(scalar loss, dict of per-sample (B,) terms + pred stats). Every
        term averages over T, then the terms are weight-summed.
        `remove_flow_loss` drops the temporal-consistency term, as
        validation does (the h5 val sets carry no flow)."""
        cfg = self.loss_cfg
        frames = batch["frame"]
        b, t = pred.shape[:2]
        terms: Dict[str, torch.Tensor] = {}
        if cfg.l1_weight:
            per_bt = L.l1_loss(pred.reshape(b * t, *pred.shape[2:]),
                               frames.reshape(b * t, *frames.shape[2:]),
                               cfg.l1_weight, reduce_batch=False)
            terms["l1_loss"] = per_bt.reshape(b, t).mean(dim=1)
        if cfg.l2_weight:
            per_bt = L.l2_loss(pred.reshape(b * t, *pred.shape[2:]),
                               frames.reshape(b * t, *frames.shape[2:]),
                               cfg.l2_weight, reduce_batch=False)
            terms["l2_loss"] = per_bt.reshape(b, t).mean(dim=1)
        if cfg.lpips_weight:
            terms["perceptual_loss"] = cfg.lpips_weight * self._lpips_term(
                pred, frames)
        l0 = cfg.temporal_consistency_L0
        if cfg.temporal_consistency_weight and not remove_flow_loss and \
                t > l0:
            flat = lambda x: x.reshape(b * (t - l0), *x.shape[2:])
            tc = L.temporal_consistency_loss(
                flat(frames[:, l0 - 1:-1]), flat(frames[:, l0:]),
                flat(pred[:, l0 - 1:-1]), flat(pred[:, l0:]),
                -flat(batch["flow"][:, l0:]), reduce_batch=False)
            # the reference averages over all T, zeros for t < L0
            terms["temporal_consistency_loss"] = (
                cfg.temporal_consistency_weight
                * tc.reshape(b, t - l0).sum(dim=1) / t)
        total = sum(v.mean() for v in terms.values())
        aux = dict(terms)
        aux["pred_max_val"] = pred.max()
        aux["pred_min_val"] = pred.min()
        aux["pred_var"] = pred.var(unbiased=False)
        return total, aux

    def prepare_flow(self, batch: Dict[str, torch.Tensor],
                     test: bool = False) -> Dict[str, torch.Tensor]:
        """Fill batch['flow'] per optical_flow_source, only when the TC
        loss is on and not at test (train_utils.py:281-305)."""
        cfg = self.loss_cfg
        if cfg.temporal_consistency_weight == 0 or test:
            return batch
        if cfg.optical_flow_source == "gt":
            if "flow" not in batch:
                raise KeyError("optical_flow_source=gt but batch has no "
                               "'flow'")
            return batch
        frames = batch["frame"]
        if cfg.optical_flow_source == "zeros":
            b, t, h, w, _ = frames.shape
            return dict(batch, flow=frames.new_zeros((b, t, h, w, 2)))
        from .raft import raft_flow
        return dict(batch, flow=raft_flow(self.teacher, frames,
                                          cfg.temporal_consistency_L0,
                                          self.teacher_dtype))


def _cast(state: Any, dtype: torch.dtype) -> Any:
    """Every tensor of a nested list/tuple state in `dtype`."""
    if torch.is_tensor(state):
        return state.to(dtype)
    return type(state)(_cast(s, dtype) for s in state)


def aggregate_per_source(terms: Dict[str, Any],
                         data_source_idx: np.ndarray) -> Dict[str, float]:
    """Host-side per-data-source bookkeeping (train_utils.py:427-456):
    mean of each term over the samples of each source, plus global
    means."""
    from ..data.sources import DATA_SOURCES
    data_source_idx = np.asarray(data_source_idx)
    out: Dict[str, float] = {}
    loss_total = None
    for name, vals in terms.items():
        vals = np.asarray(vals.detach().cpu() if torch.is_tensor(vals)
                          else vals)
        if vals.ndim == 0:
            out[name] = float(vals)
            continue
        out[name] = float(vals.mean())
        loss_total = vals if loss_total is None else loss_total + vals
        for idx in np.unique(data_source_idx):
            mask = data_source_idx == idx
            out[f"{name}/{DATA_SOURCES[int(idx)]}"] = float(vals[mask].mean())
    if loss_total is not None:
        out["loss"] = float(loss_total.mean())
        for idx in np.unique(data_source_idx):
            mask = data_source_idx == idx
            out[f"loss/{DATA_SOURCES[int(idx)]}"] = float(
                loss_total[mask].mean())
    return out
