"""LPIPS perceptual distance (port of v2v_tpu/losses/lpips.py for
net="vgg", the training loss, and net="alex", the test metric).

Frozen VGG16 or AlexNet trunk -> per-layer channel-unit-normalized
activations -> squared difference -> non-negative 1x1 linear
calibration -> spatial mean -> sum over the five taps
(PerceptualSimilarity v0.1). The linear heads ship with this package
(losses/weights/lpips_lin_{vgg,alex}.npz). The ImageNet trunks are
torchvision checkpoints that cannot be shipped: put
`vgg16-397923af.pth` / `alexnet-owt-7be5be79.pth` in $V2V_WEIGHTS_DIR
(default ./pretrained) or pass `torch_backbone_path`. Without one the
trunk is fixed random features (He init from the given generator) — a
valid training signal but NOT comparable to published LPIPS numbers; a
loud warning says so.

Module names mirror the JAX tree (`features.conv{i}`, `lin{i}`), so
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
                   "vgg": "vgg16-397923af.pth"}

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


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + eps)


class _LPIPSModule(nn.Module):
    def __init__(self, net: str):
        super().__init__()
        self.features = _Features(net)
        for i, idx in enumerate(self.features.taps):
            ch = self.features.get_submodule(f"conv{idx}").out_channels
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(ch)))


class LPIPS:
    """Frozen LPIPS("vgg" or "alex"). Inputs NHWC; `__call__` returns (B,)
    float32.

    `features` / `dist_from_features` split the computation so the
    training loss computes the GT branch once, outside autograd."""

    def __init__(self, net: str = "vgg", device=None,
                 generator: Optional[torch.Generator] = None,
                 torch_backbone_path: Optional[str] = None):
        if net not in _TRUNKS:
            raise NotImplementedError(
                f"LPIPS({net!r}): the port covers the VGG and AlexNet "
                f"trunks")
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
        conv{n}."""
        sd = torch.load(path, map_location="cpu")
        idxs = sorted({int(k.split(".")[1]) for k in sd
                       if k.startswith("features") and k.endswith("weight")})
        with torch.no_grad():
            for n, i in enumerate(idxs):
                conv = getattr(self.module.features, f"conv{n}")
                conv.weight.copy_(sd[f"features.{i}.weight"])
                conv.bias.copy_(sd[f"features.{i}.bias"])

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
