"""E2VID's recurrent UNet (NCHW, explicit state lists).

Port of v2v_tpu/models/unet.py (UNetConfig, _RecurrentUNetBase,
UNetRecurrent, _encoder_states) for the E2VID family. The step splits
into three entry points so the task interface can run the temporally
independent convs batched over B*T:

    pre(x)               -> (head, pre0)   head conv + encoder-0 conv
    spine_step(pre0, st) -> (blocks, st')  encoder-0 cell, encoders 1..
    tail(head, blocks)   -> {'image'}      resblocks, decoders, pred

`forward` composes the three (one recurrent step).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .submodules import (ConvLayer, LSTMState, RecurrentConvLayer,
                         ResidualBlock, UpsampleConvLayer, activation_fn)


@dataclasses.dataclass
class UNetConfig:
    """The `unet_kwargs` config block (model/unet.py:14-43 defaults)."""
    num_bins: int = 5
    base_num_channels: int = 32
    num_encoders: int = 3
    num_residual_blocks: int = 2
    num_output_channels: int = 1
    skip_type: str = "sum"
    norm: Optional[str] = None
    use_upsample_conv: bool = True
    kernel_size: int = 5
    channel_multiplier: float = 2
    recurrent_block_type: str = "convlstm"
    final_activation: Optional[str] = None

    # unet_kwargs keys that wrapper models read rather than the core UNet
    # (v2v_tpu/models/unet.py UNetConfig._PASS_THROUGH): never a typo
    _PASS_THROUGH = frozenset({
        "crop_size", "mlp_layers", "use_cnn_representation", "normalize",
        "combine_voxel", "RepCNN_num_layers", "RepCNN_kernel_size",
        "RepCNN_padding", "RepCNN_channel", "recurrent_network",
        "use_dynamic_decoder", "unet_kwargs", "num_bins_events",
    })

    @classmethod
    def from_kwargs(cls, kwargs: Dict[str, Any]) -> "UNetConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(kwargs) - known - cls._PASS_THROUGH)
        if unknown:
            warnings.warn(f"unet_kwargs keys not recognized (typo?): "
                          f"{unknown} — the reference would reject these")
        cfg = cls(**{k: v for k, v in kwargs.items() if k in known})
        if cfg.norm in ("none", "None", ""):
            cfg.norm = None
        if cfg.final_activation in ("", "none", "None"):
            cfg.final_activation = None
        if cfg.skip_type != "sum" or not cfg.use_upsample_conv:
            raise NotImplementedError(
                "the port covers E2VID with skip_type sum and "
                "use_upsample_conv only")
        return cfg

    @property
    def encoder_input_sizes(self) -> List[int]:
        return [int(self.base_num_channels * self.channel_multiplier ** i)
                for i in range(self.num_encoders)]

    @property
    def encoder_output_sizes(self) -> List[int]:
        return [int(self.base_num_channels * self.channel_multiplier ** (i + 1))
                for i in range(self.num_encoders)]

    @property
    def max_num_channels(self) -> int:
        return self.encoder_output_sizes[-1]


class UNetRecurrent(nn.Module):
    """E2VID backbone (model/unet.py:252-310)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        k = cfg.kernel_size
        self.head = ConvLayer(cfg.num_bins, cfg.base_num_channels, k, 1)
        self.encoders = nn.ModuleList(
            RecurrentConvLayer(cin, cout, k, 2, cfg.recurrent_block_type,
                               norm=cfg.norm)
            for cin, cout in zip(cfg.encoder_input_sizes,
                                 cfg.encoder_output_sizes))
        self.resblocks = nn.ModuleList(
            ResidualBlock(cfg.max_num_channels, cfg.max_num_channels,
                          cfg.norm)
            for _ in range(cfg.num_residual_blocks))
        self.decoders = nn.ModuleList(
            UpsampleConvLayer(cin, cout, k, norm=cfg.norm)
            for cin, cout in zip(reversed(cfg.encoder_output_sizes),
                                 reversed(cfg.encoder_input_sizes)))
        self.pred = ConvLayer(cfg.base_num_channels, cfg.num_output_channels,
                              1, activation=None, norm=cfg.norm)
        self.final_activation = activation_fn(cfg.final_activation)

    def pre(self, x: torch.Tensor):
        head = self.head(x)
        return head, self.encoders[0].apply_conv(head)

    def spine_step(self, pre0: torch.Tensor, states: List[LSTMState]):
        blocks, new_states = [], []
        x, s = self.encoders[0].apply_cell(pre0, states[0])
        blocks.append(x)
        new_states.append(s)
        for enc, st in zip(self.encoders[1:], states[1:]):
            x, s = enc(x, st)
            blocks.append(x)
            new_states.append(s)
        return blocks, new_states

    def tail(self, head: torch.Tensor, blocks: List[torch.Tensor],
             dec0_args: tuple = ()) -> Dict[str, torch.Tensor]:
        """Resblocks, decoders with sum skips, pred; `dec0_args` go to the
        first decoder after its input (HyperE2VID's dynamic decoder)."""
        x = blocks[-1]
        for rb in self.resblocks:
            x = rb(x)
        n = self.cfg.num_encoders
        for i, dec in enumerate(self.decoders):
            x = dec(x + blocks[n - i - 1], *(dec0_args if i == 0 else ()))
        img = self.pred(x + head)
        if self.final_activation is not None:
            img = self.final_activation(img)
        return {"image": img}

    def forward(self, x: torch.Tensor, states: List[LSTMState]):
        head, pre0 = self.pre(x)
        blocks, new_states = self.spine_step(pre0, states)
        return self.tail(head, blocks), new_states


def _encoder_states(cfg: UNetConfig, batch: int, height: int, width: int,
                    dtype=torch.float32, device=None) -> List[LSTMState]:
    states = []
    h, w = height, width
    for features in cfg.encoder_output_sizes:
        h, w = h // 2, w // 2
        z = torch.zeros((batch, features, h, w), dtype=dtype, device=device)
        states.append((z, z))
    return states
