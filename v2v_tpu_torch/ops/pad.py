"""Pad H, W of an NHWC (or ...HWC) tensor up to a multiple and crop back
(the reference pads at the bottom/right, model/train_utils.py:322-326);
`CropParameters`, `CropSize` and `CropSize3D` pad an NCHW (or ...HW,
...THW) tensor centered and crop it back (port of v2v_tpu/ops/pad.py,
reference model/model_util.py:46-192). EITR pads to x8 with
CropParameters."""
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


def _crop_size(size: int, f: int, safety_margin: int) -> int:
    return f * math.ceil(size / f) + safety_margin * f


def optimal_crop_size(max_size: int, max_subsample_factor: int,
                      safety_margin: int = 0) -> int:
    """The smallest multiple of 2^factor >= max_size, plus safety_margin
    such multiples (model/model_util.py:46-53)."""
    return _crop_size(max_size, 2 ** max_subsample_factor, safety_margin)


def _centered(size: int, crop_size: int) -> Tuple[int, int, int, int]:
    """(pad before, pad after, crop start, crop end) of one axis padded
    centered from `size` to `crop_size` (model/model_util.py:78-93)."""
    c = crop_size // 2
    return (math.ceil((crop_size - size) / 2), (crop_size - size) // 2,
            c - size // 2, c + math.ceil(size / 2))


class CropSize:
    """Centered zero-pad of NCHW (or ...HW) to multiples of a patch size
    {"h": fh, "w": fw}, plus safety_margin patches, and the crop back
    (model/model_util.py:162-192)."""

    def __init__(self, width: int, height: int, patch_size: dict,
                 safety_margin: int = 0):
        self.height, self.width = height, width
        self.height_crop_size = _crop_size(height, patch_size["h"],
                                           safety_margin)
        self.width_crop_size = _crop_size(width, patch_size["w"],
                                          safety_margin)
        (self.padding_top, self.padding_bottom, self.iy0,
         self.iy1) = _centered(height, self.height_crop_size)
        (self.padding_left, self.padding_right, self.ix0,
         self.ix1) = _centered(width, self.width_crop_size)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """x: ...HW."""
        return F.pad(x, (self.padding_left, self.padding_right,
                         self.padding_top, self.padding_bottom))

    def crop(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., self.iy0:self.iy1, self.ix0:self.ix1]


class CropParameters(CropSize):
    """Centered zero-pad of NCHW (or ...HW) up to a multiple of
    2^num_encoders, and the crop back (model/model_util.py:56-103)."""

    def __init__(self, width: int, height: int, num_encoders: int,
                 safety_margin: int = 0):
        f = 2 ** num_encoders
        super().__init__(width, height, {"h": f, "w": f}, safety_margin)


class CropSize3D:
    """Centered pad/crop of (..., T, H, W) to multiples of a patch size
    {"t": ft, "h": fh, "w": fw} (model/model_util.py:121-159)."""

    def __init__(self, width: int, height: int, time: int, patch_size: dict,
                 safety_margin: int = 0):
        self.time_crop_size = _crop_size(time, patch_size["t"],
                                         safety_margin)
        self.height_crop_size = _crop_size(height, patch_size["h"],
                                           safety_margin)
        self.width_crop_size = _crop_size(width, patch_size["w"],
                                          safety_margin)
        (self.padding_front, self.padding_back, self.it0,
         self.it1) = _centered(time, self.time_crop_size)
        (self.padding_top, self.padding_bottom, self.iy0,
         self.iy1) = _centered(height, self.height_crop_size)
        (self.padding_left, self.padding_right, self.ix0,
         self.ix1) = _centered(width, self.width_crop_size)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., T, H, W)."""
        return F.pad(x, (self.padding_left, self.padding_right,
                         self.padding_top, self.padding_bottom,
                         self.padding_front, self.padding_back))

    def crop(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., self.it0:self.it1, self.iy0:self.iy1,
                 self.ix0:self.ix1]
