"""A train configuration's first steps in plain PyTorch: the simulator,
the teacher's flow, the network, the loss, the backward and the
optimizer, from the benchmark's weights and inputs, in float32 unless a
lower-precision mode (lowp.py) is active. The network and the loss run a
block of clips at a time and the gradients add up, so that a float32 step
of a configuration that the program runs in bfloat16 fits on one card.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from . import lpips_vgg, nets, raft_small, sim
from .loss import clip_losses
from .optim import Adam


def _load(module: torch.nn.Module, state: Dict[str, torch.Tensor], device,
          dtype=torch.float32) -> torch.nn.Module:
    module = module.to_empty(device=device)
    module.load_state_dict({k: v.to(dtype) for k, v in state.items()})
    return module.to(dtype)


def train_steps(cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]],
                videos: List[torch.Tensor], seeds: List[int],
                block: int) -> Dict[str, object]:
    """`cfg`: a configuration file's contents; `weights`: {"model",
    "lpips", "teacher"} state dicts; `videos`: one (B, N, H, W) uint8
    batch a step; `seeds`: one generator seed a step. Returns per step
    (lists) `events`, `frames`, `flow`, `pred`, `loss`, and `grad1` (the
    first step's gradient by leaf) and `params` (by leaf, after the
    last step)."""
    dev = videos[0].device
    module, train = cfg["module"], cfg["train"]
    loss_cfg = module["loss"]
    net = _load(nets.build(module["model"]["target"]), weights["model"], dev)
    lp = (_load(lpips_vgg.build(), weights["lpips"], dev).requires_grad_(
        False) if loss_cfg.get("lpips_weight") else None)
    teacher = _load(raft_small.build(loss_cfg.get("raft_num_flow_updates",
                                                  12)),
                    weights["teacher"], dev).requires_grad_(False)
    names = [k for k, _ in net.named_parameters()]
    tensors = [p for _, p in net.named_parameters()]
    opt = Adam(train["optimizer"]["target"], train["optimizer"]["params"],
               tensors)
    p_drop = float(module["model"]["params"].get("eitr_kwargs", {}).get(
        "dropout", 0.1)) if module["model"]["target"].endswith("EITR") else 0
    bins = train["num_bins"]
    l0 = loss_cfg["temporal_consistency_L0"]
    out = {k: [] for k in ("events", "frames", "flow", "pred", "loss")}
    for video, seed in zip(videos, seeds):
        g = torch.Generator(device=dev).manual_seed(seed)
        events, frames = sim.synthesize(video, g, train["sim"], bins)
        flow = raft_small.pseudo_flow(teacher, frames, l0)
        b, t = events.shape[:2]
        loss = torch.zeros((), device=dev)
        preds = []
        for c0 in range(0, b, block):
            c1 = min(b, c0 + block)
            drop = nets.Dropout(p_drop, sim.dropout_generator(g)
                                if p_drop else None, b * t, c0 * t, c1 * t)
            pred = nets.forward_clips(net, events[c0:c1], drop)
            part = clip_losses(loss_cfg, pred, frames[c0:c1], flow[c0:c1],
                               lp).sum() / b
            part.backward()
            loss += part.detach()
            preds.append(pred.detach())
        grads = [p.grad for p in tensors]
        if not out["loss"]:
            out["grad1"] = {k: gr.clone() for k, gr in zip(names, grads)}
        opt.step(tensors, grads)
        for p in tensors:
            p.grad = None
        for k, v in (("events", events), ("frames", frames), ("flow", flow),
                     ("pred", torch.cat(preds)), ("loss", float(loss))):
            out[k].append(v)
    out["params"] = {k: p.detach() for k, p in zip(names, tensors)}
    return out
