"""Random weights made on the card from the run's seed, one uniform draw
for a whole network, then scaled leaf by leaf; the same tensors load into
the program's modules and into the reference's (their state_dict keys
agree).

Scales: a convolution's or linear layer's weight and bias uniform in
+-gain/sqrt(fan_in) (torch's default, gain 1; the LPIPS trunk He-uniform,
gain sqrt(6), so that its 13 layers keep their activations); a
LayerNorm's weight 1 + U(-0.1, 0.1) and bias U(-0.1, 0.1); LPIPS's linear
heads U(0, 0.2), about the published heads' range.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


def _scales(module: nn.Module, gain: float):
    """(name, shape, scale, offset) of each parameter, in order."""
    kinds = {}
    for mname, m in module.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            kinds[f"{mname}.{pname}" if mname else pname] = m
    params = dict(module.named_parameters())
    out = []
    for name, p in params.items():
        owner = kinds[name]
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(owner, nn.LayerNorm):
            out.append((name, p.shape, 0.1, 1.0 if leaf == "weight" else 0.0))
            continue
        if p.dim() == 1 and leaf.startswith("lin"):
            out.append((name, p.shape, 0.1, 0.1))
            continue
        w = p if p.dim() > 1 else params.get(
            name[:-len(leaf)] + leaf.replace("bias", "weight"))
        fan_in = w.shape[1] * math.prod(w.shape[2:])
        out.append((name, p.shape, gain / math.sqrt(fan_in), 0.0))
    return out


@torch.no_grad()
def make(module: nn.Module, seed: int, device, gain: float = 1.0
         ) -> Dict[str, torch.Tensor]:
    """A float32 state_dict for `module` (any device, meta included) on
    `device`, from `seed`."""
    plan = _scales(module, gain)
    total = sum(math.prod(s) for _, s, _, _ in plan)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=g)
    out, i = {}, 0
    for name, shape, scale, offset in plan:
        n = math.prod(shape)
        out[name] = (flat[i:i + n].view(shape) * scale + offset).contiguous()
        i += n
    return out
