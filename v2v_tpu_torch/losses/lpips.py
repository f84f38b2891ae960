"""LPIPS perceptual distance (port of v2v_tpu/losses/lpips.py: net="vgg",
the flagship's training loss, net="alex", the test metric, and
net="squeeze", SqueezeNet 1.1).

Frozen trunk -> per-layer channel-unit-normalized activations ->
squared difference -> non-negative 1x1 linear calibration -> spatial
mean -> sum over the taps (PerceptualSimilarity v0.1; five taps for VGG
and AlexNet, seven for SqueezeNet). The linear heads ship with this
package (losses/weights/lpips_lin_{vgg,alex,squeeze}.npz). The ImageNet
trunks are torchvision checkpoints that cannot be shipped: put
`vgg16-397923af.pth` / `alexnet-owt-7be5be79.pth` /
`squeezenet1_1-b8a52dc0.pth` in $V2V_WEIGHTS_DIR (default ./pretrained)
or pass `torch_backbone_path`. Without one the trunk is fixed random
features (He init from the given generator) — a valid training signal
but NOT comparable to published LPIPS numbers; a loud warning says so.

Module names mirror the JAX tree (`features.conv{i}`,
`features.fire{i}.{squeeze,expand1x1,expand3x3}`, `lin{i}`), so
v2v_tpu/models/convert.py::torch_state_dict_to_flax maps this module's
state_dict onto the JAX LPIPS params.
"""
from __future__ import annotations

import os
import warnings
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..models.init import materialize
from ..ops.conv import conv_as_input

_WEIGHTS_DIR = os.path.join(os.path.dirname(__file__), "weights")
_BACKBONE_FILES = {"alex": "alexnet-owt-7be5be79.pth",
                   "vgg": "vgg16-397923af.pth",
                   "squeeze": "squeezenet1_1-b8a52dc0.pth"}

# ScalingLayer constants (PerceptualSimilarity/models/networks_basic.py)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# Trunks: convs as (out_ch, kernel, stride, pad) and "M" max pools, the
# pool's (kernel, stride), and the conv indices whose relu is tapped.
_TRUNKS = {
    "vgg": ([(64, 3, 1, 1), (64, 3, 1, 1), "M", (128, 3, 1, 1),
             (128, 3, 1, 1), "M", (256, 3, 1, 1), (256, 3, 1, 1),
             (256, 3, 1, 1), "M", (512, 3, 1, 1), (512, 3, 1, 1),
             (512, 3, 1, 1), "M", (512, 3, 1, 1), (512, 3, 1, 1),
             (512, 3, 1, 1)],
            (2, 2), (1, 3, 6, 9, 12)),           # relu1_2 ... relu5_3
    # v2v_tpu/losses/lpips.py:53-56: every relu is tapped
    "alex": ([(64, 11, 4, 2), "M", (192, 5, 1, 2), "M", (384, 3, 1, 1),
              (256, 3, 1, 1), (256, 3, 1, 1)],
             (3, 2), (0, 1, 2, 3, 4)),
}

# SqueezeNet 1.1's features (v2v_tpu/losses/lpips.py:150-182): a
# stride-2 3x3 conv, then by torchvision Sequential index the Fire
# modules (squeeze, expand) and the ceil-mode 3x3/2 max pools; seven taps
_SQUEEZE_FIRES = {3: (16, 64), 4: (16, 64), 6: (32, 128), 7: (32, 128),
                  9: (48, 192), 10: (48, 192), 11: (64, 256), 12: (64, 256)}
_SQUEEZE_POOLS = (2, 5, 8)
_SQUEEZE_TAPS = (1, 4, 7, 9, 10, 11, 12)
_TAP_CHANNELS = {"alex": [64, 192, 384, 256, 256],
                 "vgg": [64, 128, 256, 512, 512],
                 "squeeze": [64, 128, 256, 384, 384, 512, 512]}

_warned = set()


class _Features(nn.Module):
    def __init__(self, net: str):
        super().__init__()
        self.arch, self.pool, self.taps = _TRUNKS[net]
        cin, idx = 3, 0
        for spec in self.arch:
            if spec == "M":
                continue
            ch, k, stride, pad = spec
            self.add_module(f"conv{idx}",
                            nn.Conv2d(cin, ch, k, stride, padding=pad))
            cin, idx = ch, idx + 1

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats, idx = [], 0
        for spec in self.arch:
            if spec == "M":
                x = F.max_pool2d(x, *self.pool)
                continue
            x = torch.relu(conv_as_input(getattr(self, f"conv{idx}"), x))
            if idx in self.taps:
                feats.append(x)
            idx += 1
        return feats


class _Fire(nn.Module):
    """torchvision's SqueezeNet Fire: a 1x1 squeeze, relu, then parallel
    1x1 and 3x3 expands, relu, concatenated over channels."""

    def __init__(self, cin: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(conv_as_input(self.squeeze, x))
        return torch.cat([torch.relu(conv_as_input(self.expand1x1, x)),
                          torch.relu(conv_as_input(self.expand3x3, x))], 1)


class _SqueezeFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(3, 64, 3, 2)
        cin = 64
        for i, (sq, ex) in _SQUEEZE_FIRES.items():
            self.add_module(f"fire{i}", _Fire(cin, sq, ex))
            cin = 2 * ex

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = torch.relu(conv_as_input(self.conv0, x))
        feats = [x]
        for i in range(2, 13):
            if i in _SQUEEZE_POOLS:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            else:
                x = getattr(self, f"fire{i}")(x)
            if i in _SQUEEZE_TAPS:
                feats.append(x)
        return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + eps)


class _LPIPSModule(nn.Module):
    def __init__(self, net: str):
        super().__init__()
        self.features = (_SqueezeFeatures() if net == "squeeze"
                         else _Features(net))
        for i, ch in enumerate(_TAP_CHANNELS[net]):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(ch)))


class LPIPS:
    """Frozen LPIPS("vgg", "alex" or "squeeze"). Inputs NHWC; `__call__`
    returns (B,) float32.

    `features` / `dist_from_features` split the computation so the
    training loss computes the GT branch once, outside autograd."""

    def __init__(self, net: str = "vgg", device=None,
                 generator: Optional[torch.Generator] = None,
                 torch_backbone_path: Optional[str] = None):
        if net not in _TAP_CHANNELS:
            raise ValueError(f"LPIPS({net!r}): the nets are vgg, alex and "
                             f"squeeze")
        self.net = net
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(7)
        self.module = materialize(lambda: _LPIPSModule(net), self.device,
                                  generator, "he")
        path = torch_backbone_path or self._find_backbone(net)
        if path is not None:
            self._load_backbone(path)
        elif net not in _warned:
            _warned.add(net)
            warnings.warn(
                f"LPIPS({net}): no pretrained backbone found (set "
                f"V2V_WEIGHTS_DIR or pass torch_backbone_path for "
                f"{_BACKBONE_FILES[net]}); using fixed random features — NOT "
                f"comparable to published LPIPS numbers.")
        lins = np.load(os.path.join(_WEIGHTS_DIR, f"lpips_lin_{net}.npz"))
        with torch.no_grad():
            for k in lins.files:
                getattr(self.module, k).copy_(torch.from_numpy(lins[k]))
        self.module.requires_grad_(False)

    @staticmethod
    def _find_backbone(net: str) -> Optional[str]:
        path = os.path.join(os.environ.get("V2V_WEIGHTS_DIR", "pretrained"),
                            _BACKBONE_FILES[net])
        return path if os.path.exists(path) else None

    def _load_backbone(self, path: str) -> None:
        """torchvision vgg16/alexnet `features.{i}` convs, in order, ->
        conv{n}; squeezenet1_1's `features.0` -> conv0 and its Fire
        modules `features.{i}.*` -> fire{i}.*."""
        sd = torch.load(path, map_location="cpu")
        if self.net == "squeeze":
            names = {"conv0": "features.0"}
            names.update({f"fire{i}.{c}": f"features.{i}.{c}"
                          for i in _SQUEEZE_FIRES
                          for c in ("squeeze", "expand1x1", "expand3x3")})
        else:
            idxs = sorted({int(k.split(".")[1]) for k in sd
                           if k.startswith("features")
                           and k.endswith("weight")})
            names = {f"conv{n}": f"features.{i}" for n, i in enumerate(idxs)}
        with torch.no_grad():
            for ours, theirs in names.items():
                conv = self.module.features.get_submodule(ours)
                conv.weight.copy_(sd[f"{theirs}.weight"])
                conv.bias.copy_(sd[f"{theirs}.bias"])

    def prep(self, x: torch.Tensor, normalize: bool,
             compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """NHWC [0,1] (normalize) or [-1,1] -> NCHW 3-channel, >= 64 px
        (the small-input guard of v2v_tpu/losses/lpips.py:282-288: tiny
        inputs would leave AlexNet's pools empty)."""
        if normalize:
            x = 2.0 * x - 1.0
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        x = x.permute(0, 3, 1, 2)
        h, w = x.shape[-2:]
        if h < 64 or w < 64:
            x = F.interpolate(x, size=(max(h, 64), max(w, 64)),
                              mode="bilinear", align_corners=False)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        return x

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Unit-normalized tap activations of prepared (NCHW) input."""
        shift = torch.tensor(_SHIFT, dtype=x.dtype,
                             device=x.device).view(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, dtype=x.dtype,
                             device=x.device).view(1, 3, 1, 1)
        return [_unit_normalize(f)
                for f in self.module.features((x - shift) / scale)]

    def dist_from_features(self, f0: List[torch.Tensor],
                           f1: List[torch.Tensor]) -> torch.Tensor:
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            lin = torch.relu(getattr(self.module, f"lin{i}")).to(a.dtype)
            val = ((a - b) ** 2 * lin.view(1, -1, 1, 1)).sum(dim=1)
            total = total + val.mean(dim=(1, 2))
        return total.to(torch.float32)

    def __call__(self, in0: torch.Tensor, in1: torch.Tensor,
                 normalize: bool = True,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return self.dist_from_features(
            self.features(self.prep(in0, normalize, compute_dtype)),
            self.features(self.prep(in1, normalize, compute_dtype)))
