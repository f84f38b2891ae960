"""Adam and AdamW (decoupled weight decay), each with amsgrad as torch's
keeps it (the maximum of the raw second moment), written out per tensor
in plain PyTorch (Kingma and Ba, 2015; Loshchilov and Hutter, 2019;
Reddi et al., 2018)."""
from __future__ import annotations

import math
from typing import Dict, List

import torch


class Adam:
    """`target` torch.optim.Adam or torch.optim.AdamW, `params` as the
    configuration gives them."""

    def __init__(self, target: str, params: Dict, tensors: List[torch.Tensor]):
        self.decoupled = target.endswith("AdamW")
        self.lr = params["lr"]
        self.wd = params.get("weight_decay") or 0.0
        self.amsgrad = bool(params.get("amsgrad"))
        self.b1, self.b2 = params.get("betas", (0.9, 0.999))
        self.eps = params.get("eps", 1e-8)
        self.m = [torch.zeros_like(p) for p in tensors]
        self.v = [torch.zeros_like(p) for p in tensors]
        self.vmax = [torch.zeros_like(p) for p in tensors]
        self.t = 0

    @torch.no_grad()
    def step(self, tensors: List[torch.Tensor], grads: List[torch.Tensor]):
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = math.sqrt(1 - self.b2 ** self.t)
        for p, g, m, v, vmax in zip(tensors, grads, self.m, self.v,
                                    self.vmax):
            if self.decoupled:
                p.mul_(1 - self.lr * self.wd)
            elif self.wd:
                g = g + self.wd * p
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            if self.amsgrad:
                torch.maximum(vmax, v, out=vmax)
                denom = vmax.sqrt() / bc2 + self.eps
            else:
                denom = v.sqrt() / bc2 + self.eps
            p.addcdiv_(m, denom, value=-self.lr / bc1)
