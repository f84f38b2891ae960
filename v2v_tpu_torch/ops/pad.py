"""Pad H, W of an NHWC (or ...HWC) tensor up to a multiple and crop back
(the reference pads at the bottom/right, model/train_utils.py:322-326);
`CropParameters` pads an NCHW tensor centered, as EITR does inside."""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def pad_to_multiple(x: torch.Tensor, multiple: int = 16
                    ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Zero-pad ...HWC at the bottom/right; returns (padded, (H, W))."""
    h, w = x.shape[-3], x.shape[-2]
    ph = math.ceil(h / multiple) * multiple - h
    pw = math.ceil(w / multiple) * multiple - w
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    return x, (h, w)


def crop_from_multiple(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    h, w = hw
    return x[..., :h, :w, :]


class CropParameters:
    """Centered zero-pad of NCHW (or ...HW) up to a multiple of
    2^num_encoders, and the crop back (v2v_tpu/ops/pad.py::CropParameters,
    reference model/model_util.py:56-103). EITR pads to x8 with it."""

    def __init__(self, width: int, height: int, num_encoders: int):
        f = 2 ** num_encoders
        ph = f * math.ceil(height / f) - height
        pw = f * math.ceil(width / f) - width
        self.height_crop_size, self.width_crop_size = height + ph, width + pw
        self.padding_top, self.padding_bottom = math.ceil(ph / 2), ph // 2
        self.padding_left, self.padding_right = math.ceil(pw / 2), pw // 2
        cy, cx = (height + ph) // 2, (width + pw) // 2
        self.iy0, self.iy1 = cy - height // 2, cy + math.ceil(height / 2)
        self.ix0, self.ix1 = cx - width // 2, cx + math.ceil(width / 2)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        return F.pad(x, (self.padding_left, self.padding_right,
                         self.padding_top, self.padding_bottom))

    def crop(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., self.iy0:self.iy1, self.ix0:self.ix1]
