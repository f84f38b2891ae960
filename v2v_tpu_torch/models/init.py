"""Parameter sampling from an explicit torch.Generator.

Modules are built on the meta device (no global-RNG draws), moved to
the target device empty, and filled from the caller's generator.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn


def default_generator(device: torch.device, seed: int = 0
                      ) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator,
                 scheme: str = "uniform") -> nn.Module:
    """Refill every Conv2d and ConvTranspose2d. 'uniform': torch's
    default, weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)). 'he':
    weight ~ N(0, 2/fan_in), bias 0. Linear layers get torch's default
    uniform, LayerNorms ones and zeros, BatchNorms (and instance norms
    with running statistics) ones and zeros with mean 0, var 1 and no
    batch counted, and a module with an `init_params_(generator)` method fills
    its own parameters and buffers."""
    for m in module.modules():
        if isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            continue
        if isinstance(m, nn.modules.batchnorm._NormBase):
            m.reset_parameters()
            continue
        if hasattr(m, "init_params_"):
            m.init_params_(generator)
            continue
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
            continue
        if not isinstance(m, nn.modules.conv._ConvNd):
            continue
        # torch's fan_in: weight.shape[1] (in/groups for a conv, out/groups
        # for a transposed conv) times the kernel's area
        fan_in = m.weight.shape[1] * m.kernel_size[0] * m.kernel_size[1]
        if scheme == "uniform":
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif scheme == "he":
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        else:
            raise ValueError(f"unknown init scheme {scheme!r}")
    return module


def materialize(factory: Callable[[], nn.Module], device: torch.device,
                generator: Optional[torch.Generator] = None,
                scheme: str = "uniform") -> nn.Module:
    """Build `factory()` on the meta device, allocate it on `device` and
    sample its parameters from `generator` (default: seed 0 on
    `device`)."""
    with torch.device("meta"):
        module = factory()
    module = module.to_empty(device=device)
    if generator is None:
        generator = default_generator(device)
    return init_params_(module, generator, scheme)
