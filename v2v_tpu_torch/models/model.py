"""The model zoo's wrappers (reference model/model.py; port of
v2v_tpu/models/model.py): E2VIDRecurrent, FlowNet (E2VID++),
ColorE2VID, WFlowNet, FlowNetNoRecur, EVFlowNet and FireNet.

Every model follows one stateful-step contract: `init_state(B, H, W)`
is the reference's `reset_states()`, and `forward(x, state,
method="step")` returns (out dict, state), NCHW in and out. `out` has
"image" (B,1|3,H,W) and, for the flow models, "flow" (B,2,H,W). The
non-recurrent models take and return `state=()`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from .submodules import ConvGRU, ConvLayer, ResidualBlock
from .unet import (UNet, UNetConfig, UNetFlow, UNetFlowNoRecur,
                   UNetRecurrent, WNet, _encoder_states)


class _SplitForward(nn.Module):
    """A recurrent UNet wrapper: `forward(*args, method=...)` dispatches
    to one recurrent step ("step": x, states -> (out, states)) or to the
    forward-split entry points ("pre", "spine_step", "tail"), which are
    also methods, so that torch.func.functional_call can run any of them
    with substituted (e.g. bf16) parameters. `net` is the backbone."""

    def _setup(self, attr: str, net: nn.Module, cfg: UNetConfig) -> None:
        self.cfg = cfg
        self._attr = attr
        setattr(self, attr, net)

    @property
    def net(self) -> nn.Module:
        return getattr(self, self._attr)

    def pre(self, x):
        return self.net.pre(x)

    def spine_step(self, pre0, states):
        return self.net.spine_step(pre0, states)

    def tail(self, head, blocks):
        return self.net.tail(head, blocks)

    def forward(self, *args, method: str = "step"):
        fn = {"step": self.net.forward, "pre": self.pre,
              "spine_step": self.spine_step, "tail": self.tail}[method]
        return fn(*args)

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None) -> List[Any]:
        return _encoder_states(self.cfg, batch, height, width, dtype, device)

    @property
    def num_encoders(self) -> int:
        return self.cfg.num_encoders


def _config(unet_kwargs: Dict[str, Any], out_channels: int) -> UNetConfig:
    cfg = UNetConfig.from_kwargs(dict(unet_kwargs))
    cfg.num_output_channels = out_channels
    return cfg


class E2VIDRecurrent(_SplitForward):
    """E2VID: recurrent UNet reconstruction (model/model.py:194-223)."""

    def __init__(self, unet_kwargs: Dict[str, Any]):
        super().__init__()
        cfg = _config(unet_kwargs, 1)
        self._setup("unetrecurrent", UNetRecurrent(cfg), cfg)


class FlowNet(_SplitForward):
    """E2VID++: a recurrent UNet whose 3-channel pred is image + flow
    (model/model.py:111-139)."""

    def __init__(self, unet_kwargs: Dict[str, Any]):
        super().__init__()
        cfg = _config(unet_kwargs, 3)
        self._setup("unetflow", UNetFlow(cfg), cfg)


class ColorE2VID(_SplitForward):
    """E2VID++'s network emitting a 3-channel (BGR) image
    (model/model.py:164-192)."""

    def __init__(self, unet_kwargs: Dict[str, Any]):
        super().__init__()
        cfg = _config(unet_kwargs, 3)
        self._setup("unetflow", UNetFlow(cfg, img_3c=True), cfg)


class WFlowNet(_SplitForward):
    """W-Net: separate image and flow decoders (model/model.py:80-108)."""

    def __init__(self, unet_kwargs: Dict[str, Any]):
        super().__init__()
        cfg = _config(unet_kwargs, 3)
        self._setup("wnet", WNet(cfg), cfg)


class FlowNetNoRecur(nn.Module):
    """The non-recurrent image + flow UNet (model/model.py:142-162);
    `forward(x, state=(), method="step")` returns (out, state)."""

    def __init__(self, unet_kwargs: Dict[str, Any]):
        super().__init__()
        self.cfg = _config(unet_kwargs, 3)
        self.unetflow = UNetFlowNoRecur(self.cfg)

    def forward(self, x: torch.Tensor, state: Tuple = (),
                method: str = "step"):
        if method != "step":
            raise ValueError(f"FlowNetNoRecur has no entry point {method!r}")
        return self.unetflow(x), state

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None) -> Tuple:
        return ()


# Hardcoded EVFlowNet hyperparameters (reference model/model.py:233-245),
# applied over the config's unet_kwargs
_EVFLOWNET_KWARGS = dict(
    base_num_channels=32, num_encoders=4, num_residual_blocks=2,
    num_output_channels=2, skip_type="concat", norm=None,
    use_upsample_conv=True, kernel_size=3, channel_multiplier=2)


class EVFlowNet(nn.Module):
    """EV-FlowNet (Zhu et al. 2018): a non-recurrent flow UNet. NCHW in
    and out; `forward(x, state=(), method="step")` returns
    ({"flow", "image": a zero image}, state), the stateful-step contract
    of the other models with an empty state."""

    def __init__(self, unet_kwargs: Dict[str, Any]):
        super().__init__()
        cfg = UNetConfig.from_kwargs({**unet_kwargs, **_EVFLOWNET_KWARGS})
        self.cfg = cfg
        self.unet = UNet(cfg)

    def forward(self, x: torch.Tensor, state: Tuple = (),
                method: str = "step"):
        if method != "step":
            raise ValueError(f"EVFlowNet has no entry point {method!r}")
        flow = self.unet(x)
        # the reference's dummy zero image (model/model.py:261)
        return {"flow": flow, "image": 0.0 * flow[:, :1]}, state

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None) -> Tuple:
        return ()


class FireNet(nn.Module):
    """FireNet (Scheerlinck et al. 2019; model/model.py:264-311): head
    conv, ConvGRU G1, ResidualBlock R1, ConvGRU G2, R2, a 1x1 pred. Its
    num_bins, base_num_channels and kernel_size come from `unet_kwargs`
    where it has them, else from its own arguments. The state is the two
    GRUs' hidden maps at full resolution; no split entry points."""

    def __init__(self, num_bins: int = 5, base_num_channels: int = 16,
                 kernel_size: int = 3, unet_kwargs: Dict[str, Any] = None):
        super().__init__()
        kw = unet_kwargs or {}
        bins = kw.get("num_bins", num_bins)
        c = self.channels = kw.get("base_num_channels", base_num_channels)
        k = kw.get("kernel_size", kernel_size)
        self.head = ConvLayer(bins, c, k)
        self.G1 = ConvGRU(c, c, k)
        self.R1 = ResidualBlock(c, c)
        self.G2 = ConvGRU(c, c, k)
        self.R2 = ResidualBlock(c, c)
        self.pred = ConvLayer(c, 1, 1, activation=None)

    def forward(self, x: torch.Tensor, state: List[torch.Tensor],
                method: str = "step"):
        if method != "step":
            raise ValueError(f"FireNet has no entry point {method!r}")
        x, s0 = self.G1(self.head(x), state[0])
        x, s1 = self.G2(self.R1(x), state[1])
        return {"image": self.pred(self.R2(x))}, [s0, s1]

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None) -> List[torch.Tensor]:
        z = ConvGRU.zero_state(batch, height, width, self.channels, dtype,
                               device)
        return [z, z]
