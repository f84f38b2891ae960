"""LPIPS with the VGG-16 trunk (Zhang et al., CVPR 2018, v0.1) in plain
PyTorch: the scaling layer, the 13 convs of VGG-16's features with relus
tapped at relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, each tap unit
normalized over channels, the squared difference weighed by the
non-negative 1x1 linear heads, the spatial mean, and the sum over taps.
Module names `features.conv{i}` and `lin{i}` are the program's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_CONVS = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512]
_TAPS = (1, 3, 6, 9, 12)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _Features(nn.Module):
    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for spec in _CONVS:
            if spec == "M":
                continue
            self.add_module(f"conv{i}", nn.Conv2d(cin, spec, 3, padding=1))
            cin, i = spec, i + 1

    def forward(self, x):
        feats, i = [], 0
        for spec in _CONVS:
            if spec == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = torch.relu(getattr(self, f"conv{i}")(x))
            if i in _TAPS:
                feats.append(x)
            i += 1
        return feats


class LPIPSVGG(nn.Module):
    def __init__(self):
        super().__init__()
        self.features = _Features()
        for i, ch in enumerate((64, 128, 256, 512, 512)):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.empty(ch)))

    def _taps(self, x):
        """x NHWC in [0, 1] -> the unit-normalized taps."""
        x = (2.0 * x - 1.0).expand(*x.shape[:-1], 3).permute(0, 3, 1, 2)
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
        x = (x - shift.view(1, 3, 1, 1)) / scale.view(1, 3, 1, 1)
        return [f / (torch.sqrt((f * f).sum(1, keepdim=True)) + 1e-10)
                for f in self.features(x)]

    def forward(self, pred, target):
        """pred, target (N, H, W, 1) in [0, 1], H and W >= 64 -> (N,)."""
        with torch.no_grad():
            ft = self._taps(target)
        total = 0.0
        for i, (a, b) in enumerate(zip(self._taps(pred), ft)):
            lin = torch.relu(getattr(self, f"lin{i}"))
            total = total + ((a - b) ** 2 * lin.view(1, -1, 1, 1)).sum(
                1).mean(dim=(1, 2))
        return total


def build() -> LPIPSVGG:
    with torch.device("meta"):
        return LPIPSVGG()
