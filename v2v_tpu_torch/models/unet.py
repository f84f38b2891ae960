"""The UNet family (NCHW, explicit state lists).

Port of v2v_tpu/models/unet.py: UNetConfig, the recurrent UNets
(UNetRecurrent for E2VID, UNetFlow for E2VID++ and ColorE2VID, WNet for
WFlowNet), UNetFlowNoRecur and the plain UNet of EVFlowNet. The
recurrent step splits into three entry points so the task interface can
run the temporally independent convs batched over B*T:

    pre(x)               -> (head, pre0)   head conv + encoder-0 conv
    spine_step(pre0, st) -> (blocks, st')  encoder-0 cell, encoders 1..
    tail(head, blocks)   -> out dict       resblocks, decoders, pred

`forward` composes the three (one recurrent step).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .submodules import (ConvLayer, RecurrentConvLayer, ResidualBlock,
                         TransposedConvLayer, UpsampleConvLayer,
                         activation_fn, zero_cell_state)


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
        if cfg.skip_type not in ("sum", "concat"):
            raise ValueError(f"skip_type {cfg.skip_type!r}")
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

    @property
    def skip_width(self) -> int:
        """2 when a skip concatenates (the reference's `2 * input_size`),
        else 1."""
        return 2 if self.skip_type == "concat" else 1

    @property
    def decoder_input_sizes(self) -> List[int]:
        """Each decoder's input width, its skip included."""
        return [self.skip_width * c
                for c in reversed(self.encoder_output_sizes)]

    def skip(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """skip_sum or skip_concat (over channels)."""
        return x + y if self.skip_type == "sum" else torch.cat([x, y], 1)

    def decoders(self) -> nn.ModuleList:
        """The decoder stack: UpsampleConvLayer, or TransposedConvLayer
        when use_upsample_conv is false, each halving the width."""
        layer = (UpsampleConvLayer if self.use_upsample_conv
                 else TransposedConvLayer)
        return nn.ModuleList(
            layer(cin, cout, self.kernel_size, norm=self.norm)
            for cin, cout in zip(self.decoder_input_sizes,
                                 reversed(self.encoder_input_sizes)))

    def resblocks(self) -> nn.ModuleList:
        return nn.ModuleList(
            ResidualBlock(self.max_num_channels, self.max_num_channels,
                          self.norm)
            for _ in range(self.num_residual_blocks))


def _decode(cfg: UNetConfig, decoders: nn.ModuleList, x: torch.Tensor,
            blocks: List[torch.Tensor], dec0_args: tuple = ()
            ) -> torch.Tensor:
    """The decoder stack over `x` with the encoders' skips; `dec0_args`
    go to the first decoder after its input (HyperE2VID's dynamic
    decoder)."""
    n = cfg.num_encoders
    for i, dec in enumerate(decoders):
        x = dec(cfg.skip(x, blocks[n - i - 1]), *(dec0_args if i == 0
                                                   else ()))
    return x


class _RecurrentUNetBase(nn.Module):
    """The recurrent UNets' head, recurrent encoders and residual
    blocks, with the split entry points; a subclass adds its decoders
    and `tail`."""

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
        self.resblocks = cfg.resblocks()

    def pre(self, x: torch.Tensor):
        head = self.head(x)
        return head, self.encoders[0].apply_conv(head)

    def spine_step(self, pre0: torch.Tensor, states: List[Any]):
        blocks, new_states = [], []
        x, s = self.encoders[0].apply_cell(pre0, states[0])
        blocks.append(x)
        new_states.append(s)
        for enc, st in zip(self.encoders[1:], states[1:]):
            x, s = enc(x, st)
            blocks.append(x)
            new_states.append(s)
        return blocks, new_states

    def _bottleneck(self, blocks: List[torch.Tensor]) -> torch.Tensor:
        x = blocks[-1]
        for rb in self.resblocks:
            x = rb(x)
        return x

    def forward(self, x: torch.Tensor, states: List[Any]):
        head, pre0 = self.pre(x)
        blocks, new_states = self.spine_step(pre0, states)
        return self.tail(head, blocks), new_states


class UNetRecurrent(_RecurrentUNetBase):
    """E2VID backbone (model/unet.py:252-310)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__(cfg)
        self.decoders = cfg.decoders()
        self.pred = ConvLayer(cfg.skip_width * cfg.base_num_channels,
                              cfg.num_output_channels, 1, activation=None,
                              norm=cfg.norm)
        self.final_activation = activation_fn(cfg.final_activation)

    def tail(self, head: torch.Tensor, blocks: List[torch.Tensor],
             dec0_args: tuple = ()) -> Dict[str, torch.Tensor]:
        """Resblocks, decoders with skips, pred; `dec0_args` go to the
        first decoder after its input (HyperE2VID's dynamic decoder)."""
        x = _decode(self.cfg, self.decoders, self._bottleneck(blocks),
                    blocks, dec0_args)
        img = self.pred(self.cfg.skip(x, head))
        if self.final_activation is not None:
            img = self.final_activation(img)
        return {"image": img}


class UNetFlow(_RecurrentUNetBase):
    """E2VID++ backbone (model/unet.py:133-194): one decoder stack and a
    3-channel pred, split into image [0:1] and flow [1:3], or all three
    channels as the image when `img_3c` (ColorE2VID)."""

    def __init__(self, cfg: UNetConfig, img_3c: bool = False):
        super().__init__(cfg)
        self.img_3c = img_3c
        self.decoders = cfg.decoders()
        self.pred = ConvLayer(cfg.skip_width * cfg.base_num_channels, 3, 1,
                              activation=None)

    def tail(self, head: torch.Tensor, blocks: List[torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        x = _decode(self.cfg, self.decoders, self._bottleneck(blocks),
                    blocks)
        img_flow = self.pred(self.cfg.skip(x, head))
        if self.img_3c:
            return {"image": img_flow}
        return {"image": img_flow[:, 0:1], "flow": img_flow[:, 1:3]}


class WNet(_RecurrentUNetBase):
    """The dual-decoder recurrent UNet (model/unet.py:66-130): separate
    flow and image decoder stacks and preds (2 and 1 channels)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__(cfg)
        self.flow_decoders = cfg.decoders()
        self.image_decoders = cfg.decoders()
        width = cfg.skip_width * cfg.base_num_channels
        self.flow_pred = ConvLayer(width, 2, 1, activation=None)
        self.image_pred = ConvLayer(width, 1, 1, activation=None)

    def tail(self, head: torch.Tensor, blocks: List[torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        x = self._bottleneck(blocks)
        flow_x = _decode(cfg, self.flow_decoders, x, blocks)
        img_x = _decode(cfg, self.image_decoders, x, blocks)
        return {"image": self.image_pred(cfg.skip(img_x, head)),
                "flow": self.flow_pred(cfg.skip(flow_x, head))}


class UNetFlowNoRecur(nn.Module):
    """UNetFlow without recurrence (model/unet.py:197-249): strided conv
    encoders, residual blocks, decoders, a 3-channel pred split into
    image [0:1] and flow [1:3]."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        k = cfg.kernel_size
        self.head = ConvLayer(cfg.num_bins, cfg.base_num_channels, k, 1)
        self.encoders = nn.ModuleList(
            ConvLayer(cin, cout, k, 2, norm=cfg.norm)
            for cin, cout in zip(cfg.encoder_input_sizes,
                                 cfg.encoder_output_sizes))
        self.resblocks = cfg.resblocks()
        self.decoders = cfg.decoders()
        self.pred = ConvLayer(cfg.skip_width * cfg.base_num_channels, 3, 1,
                              activation=None)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        head = x = self.head(x)
        blocks = []
        for enc in self.encoders:
            x = enc(x)
            blocks.append(x)
        for rb in self.resblocks:
            x = rb(x)
        x = _decode(self.cfg, self.decoders, x, blocks)
        img_flow = self.pred(self.cfg.skip(x, head))
        return {"image": img_flow[:, 0:1], "flow": img_flow[:, 1:3]}


class UNet(nn.Module):
    """The plain UNet without a head conv (EVFlowNet's backbone,
    model/unet.py:313-352): strided encoders, residual blocks, upsampling
    decoders with skips, a 1x1 pred. No state."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        k = cfg.kernel_size
        self.encoders = nn.ModuleList(
            ConvLayer(cin, cout, k, 2, norm=cfg.norm)
            for cin, cout in zip([cfg.num_bins]
                                 + cfg.encoder_output_sizes[:-1],
                                 cfg.encoder_output_sizes))
        self.resblocks = cfg.resblocks()
        self.decoders = cfg.decoders()
        self.pred = ConvLayer(cfg.base_num_channels, cfg.num_output_channels,
                              1, activation=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        blocks = []
        for enc in self.encoders:
            x = enc(x)
            blocks.append(x)
        for rb in self.resblocks:
            x = rb(x)
        return self.pred(_decode(self.cfg, self.decoders, x, blocks))


def _encoder_states(cfg: UNetConfig, batch: int, height: int, width: int,
                    dtype=torch.float32, device=None) -> List[Any]:
    """The zero state of each recurrent encoder: (h, c) for convlstm, h
    for convgru, at 1/2, 1/4, ... of the input's size."""
    states = []
    h, w = height, width
    for features in cfg.encoder_output_sizes:
        h, w = h // 2, w // 2
        states.append(zero_cell_state(cfg.recurrent_block_type, batch, h, w,
                                      features, dtype, device))
    return states
