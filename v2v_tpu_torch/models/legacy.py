"""The legacy FireNet (reference model/legacy.py; port of
v2v_tpu/models/legacy.py): a recurrent head conv and residual blocks of
which those listed in `recurrent_blocks={'resblock': [...]}` carry a
recurrent cell (-1 lists them all). NCHW; the state is one cell state
for the head and one for each recurrent residual block, at full
resolution."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from .submodules import (RecurrentConvLayer, ResidualBlock, recurrent_cell,
                         zero_cell_state)


class RecurrentResidualLayer(nn.Module):
    """A ResidualBlock (`conv`) followed by a recurrent cell
    (model/submodules.py:281-304)."""

    def __init__(self, channels: int, recurrent_block_type: str = "convgru",
                 norm: Optional[str] = None):
        super().__init__()
        self.conv = ResidualBlock(channels, channels, norm)
        self.recurrent_block = recurrent_cell(recurrent_block_type, channels)

    def forward(self, x: torch.Tensor, state):
        return self.recurrent_block(self.conv(x), state)


class _PredConv2d(nn.Conv2d):
    """The 1x1 prediction conv: torch's default weight, its bias filled
    with 0.5 (model/legacy.py:146)."""

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        bound = 1.0 / self.in_channels ** 0.5
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.fill_(0.5)


class _Pred(nn.Module):
    """Holds the pred conv under the reference's key `pred.conv2d`."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv2d = _PredConv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2d(x)


class UNetFire(nn.Module):
    """model/legacy.py:103-181: recurrent head, residual blocks (some
    recurrent), a sum or concat skip from the head, the pred conv."""

    def __init__(self, num_input_channels: int, num_output_channels: int = 1,
                 skip_type: str = "sum",
                 recurrent_block_type: str = "convgru",
                 base_num_channels: int = 32, num_residual_blocks: int = 2,
                 norm: Optional[str] = None, kernel_size: int = 3,
                 recurrent_resblocks: Sequence[int] = (0,)):
        super().__init__()
        self.skip_type = skip_type
        self.recurrent = [i in recurrent_resblocks or -1 in recurrent_resblocks
                          for i in range(num_residual_blocks)]
        c = base_num_channels
        self.head = RecurrentConvLayer(num_input_channels, c, kernel_size, 1,
                                       recurrent_block_type, norm=norm)
        self.resblocks = nn.ModuleList(
            RecurrentResidualLayer(c, recurrent_block_type, norm) if rec
            else ResidualBlock(c, c, norm) for rec in self.recurrent)
        self.pred = _Pred(2 * c if skip_type == "concat" else c,
                          num_output_channels)

    def forward(self, x: torch.Tensor, states: List[Any]):
        x, s = self.head(x, states[0])
        head, new_states = x, [s]
        for rec, block in zip(self.recurrent, self.resblocks):
            if rec:
                x, s = block(x, states[len(new_states)])
                new_states.append(s)
            else:
                x = block(x)
        if self.skip_type == "concat":
            x = torch.cat([x, head], dim=1)
        elif self.skip_type == "sum":
            x = x + head
        return self.pred(x), new_states


class FireNetLegacy(nn.Module):
    """Reference target `model.legacy.FireNet_legacy`: UNetFire (`net`)
    from `unet_kwargs` (num_bins 5, skip sum, base 32, 2 residual blocks,
    kernel 3, convgru and recurrent_blocks {'resblock': [0]} by default).
    `forward(x, state, method="step")` returns ({"image"}, state)."""

    def __init__(self, unet_kwargs: Dict[str, Any]):
        super().__init__()
        c = unet_kwargs
        self.base = int(c.get("base_num_channels", 32))
        self.rec_type = c.get("recurrent_block_type", "convgru")
        rec_blocks = tuple(c.get("recurrent_blocks", {"resblock": [0]})
                           .get("resblock", [0]))
        self.net = UNetFire(
            int(c.get("num_bins", 5)), 1, c.get("skip_type", "sum"),
            self.rec_type, self.base, int(c.get("num_residual_blocks", 2)),
            c.get("norm"), int(c.get("kernel_size", 3)), rec_blocks)

    def forward(self, x: torch.Tensor, state: List[Any],
                method: str = "step"):
        if method != "step":
            raise ValueError(f"FireNet_legacy has no entry point {method!r}")
        img, new_states = self.net(x, state)
        return {"image": img}, new_states

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None) -> List[Any]:
        return [zero_cell_state(self.rec_type, batch, height, width,
                                self.base, dtype, device)
                for _ in range(1 + sum(self.net.recurrent))]
