"""Optimizer and LR schedule factories resolved from the reference's torch
target strings (port of v2v_tpu/training/optim.py for the flagship's
`torch.optim.Adam` and `torch.optim.lr_scheduler.StepLR`).

`Adam(**params).make(parameters)` returns a torch.optim.Adam. Note one
difference from the JAX reference: with amsgrad, optax keeps the maximum
of the bias-corrected second moment, torch the maximum of the raw one;
the two agree on the first step.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable

import torch


class Adam:
    """torch.optim.Adam(lr, weight_decay, amsgrad, betas, eps)."""

    def __init__(self, lr: float, weight_decay: float = 0.0,
                 amsgrad: bool = False, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.base_lr = lr
        self.kwargs = dict(lr=lr, weight_decay=weight_decay or 0.0,
                           amsgrad=amsgrad, betas=tuple(betas), eps=eps)

    def make(self, parameters: Iterable[torch.nn.Parameter]
             ) -> torch.optim.Adam:
        return torch.optim.Adam(parameters, **self.kwargs)


class StepLR:
    """epoch -> lr multiplier gamma^(epoch // step_size) (torch steps the
    scheduler once per epoch, reference train.py:140). It keeps the JAX
    package's Scheduler protocol, which the train driver calls:
    `observe(val_loss)` after each validation, `state_dict()` into the
    checkpoint and `load_state_dict` on resume; StepLR is stateless."""

    def __init__(self, step_size: int, gamma: float = 0.1, **_):
        self.step_size = step_size
        self.gamma = gamma

    def __call__(self, epoch: int) -> float:
        return self.gamma ** (epoch // self.step_size)

    def observe(self, val_loss: float) -> None:
        pass

    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        pass
