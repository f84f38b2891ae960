"""Seed-synchronized augmentations of the legacy datasets (port of
v2v_tpu/data/augmentation.py; reference utils/data_augmentation.py), on
the host in numpy, channels-last.

Transforms take (..., H, W, C) arrays and an `is_flow` flag; flow fields
get their components sign-flipped or rotated along with the geometry.
Parameters come from Python's `random` in the JAX package's order, so a
dataset can re-seed (`random.seed(s)`) before transforming each tensor
of a sequence to augment frame, voxel and flow alike (reference
data/dataset.py:339-366), and the same seed gives the same transform in
both packages. The voxel and hot-pixel noise draw from `np.random`.
"""
from __future__ import annotations

import numbers
import random
from math import cos, pi, sin
from typing import List, Sequence

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x, is_flow: bool = False):
        for t in self.transforms:
            x = t(x, is_flow)
        return x


def _size2d(size):
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    return size


class CenterCrop:
    """(utils/data_augmentation.py:94-126)"""

    def __init__(self, size, preserve_mosaicing_pattern: bool = False):
        self.size = _size2d(size)
        self.preserve_mosaicing_pattern = preserve_mosaicing_pattern

    def __call__(self, x, is_flow: bool = False):
        h, w = x.shape[-3], x.shape[-2]
        th, tw = self.size
        assert th <= h and tw <= w
        i = int(round((h - th) / 2.0))
        j = int(round((w - tw) / 2.0))
        if self.preserve_mosaicing_pattern:
            i += i % 2
            j += j % 2
        return x[..., i:i + th, j:j + tw, :]


class RandomCrop:
    """(utils/data_augmentation.py:212-258)"""

    def __init__(self, size, preserve_mosaicing_pattern: bool = False):
        self.size = _size2d(size)
        self.preserve_mosaicing_pattern = preserve_mosaicing_pattern

    def __call__(self, x, is_flow: bool = False):
        h, w = x.shape[-3], x.shape[-2]
        th, tw = self.size
        if th > h or tw > w:
            raise ValueError(f"crop {th}x{tw} larger than input {h}x{w}")
        # draw-for-draw identical RNG consumption to the reference
        # (utils/data_augmentation.py:225-236): no draws only when BOTH
        # dims match; otherwise two randints (even zero-range ones), so
        # seed-synced streams stay aligned across implementations
        if h == th and w == tw:
            i = j = 0
        else:
            i = random.randint(0, h - th)
            j = random.randint(0, w - tw)
        if self.preserve_mosaicing_pattern:
            i += i % 2
            j += j % 2
        return x[..., i:i + th, j:j + tw, :]


class RandomFlip:
    """Flip along H and/or W; flow components sign-flip accordingly
    (utils/data_augmentation.py:341-375)."""

    def __init__(self, p_hflip: float = 0.5, p_vflip: float = 0.5):
        self.p_hflip = p_hflip
        self.p_vflip = p_vflip

    def __call__(self, x, is_flow: bool = False):
        if is_flow:
            assert x.shape[-1] == 2
        axes = []
        if random.random() < self.p_hflip:
            axes.append(-2)           # W
        if random.random() < self.p_vflip:
            axes.append(-3)           # H
        if not axes:
            return x
        out = np.flip(x, axis=tuple(axes)).copy()
        if is_flow:
            for a in axes:
                comp = 0 if a == -2 else 1   # x for W flip, y for H flip
                out[..., comp] *= -1
        return out


class RandomRotationFlip:
    """Random rotation + flips via an affine warp; flow vectors rotate
    with the geometry (utils/data_augmentation.py:261-337)."""

    def __init__(self, degrees, p_hflip: float = 0.5, p_vflip: float = 0.5):
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise ValueError("degrees must be positive")
            self.degrees = (-degrees, degrees)
        else:
            assert len(degrees) == 2
            self.degrees = degrees
        self.p_hflip = p_hflip
        self.p_vflip = p_vflip

    def __call__(self, x, is_flow: bool = False):
        assert x.ndim == 3            # (H, W, C)
        if is_flow:
            assert x.shape[-1] == 2
        angle = random.uniform(*self.degrees) * pi / 180.0
        m = np.array([[cos(angle), -sin(angle)],
                      [sin(angle), cos(angle)]], np.float64)
        if random.random() < self.p_hflip:
            m[:, 0] *= -1
        if random.random() < self.p_vflip:
            m[:, 1] *= -1
        m_inv = np.linalg.inv(m)

        h, w, c = x.shape
        # normalized grid, align_corners=False convention (torch
        # affine_grid): out coords in [-1,1] map through M to src coords
        ys = (np.arange(h) + 0.5) / h * 2 - 1
        xs = (np.arange(w) + 0.5) / w * 2 - 1
        gx, gy = np.meshgrid(xs, ys)
        sx = m[0, 0] * gx + m[0, 1] * gy
        sy = m[1, 0] * gx + m[1, 1] * gy
        # to pixel coords
        px = (sx + 1) / 2 * w - 0.5
        py = (sy + 1) / 2 * h - 0.5
        out = _bilinear_np(x, px, py)
        if is_flow:
            vx, vy = out[..., 0].copy(), out[..., 1].copy()
            out[..., 0] = m_inv[0, 0] * vx + m_inv[0, 1] * vy
            out[..., 1] = m_inv[1, 0] * vx + m_inv[1, 1] * vy
        return out


def _bilinear_np(img: np.ndarray, gx: np.ndarray, gy: np.ndarray) -> np.ndarray:
    """Bilinear sample (H,W,C) at pixel coords with zero padding."""
    h, w, _ = img.shape
    x0 = np.floor(gx).astype(int)
    y0 = np.floor(gy).astype(int)
    tx = (gx - x0)[..., None]
    ty = (gy - y0)[..., None]

    def gather(yi, xi):
        inb = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))
        v = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        return v * inb[..., None]

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    return (top * (1 - ty) + bot * ty).astype(img.dtype)


class RobustNorm:
    """Percentile clamp + rescale (utils/data_augmentation.py:134-185).

    Torch-exact: percentiles use kthvalue semantics
    (k = 1 + round(q/100 * (n-1)), no interpolation), and the rescale is
    (clamped - min(clamped)) / (max(clamped) + eps) — the reference does
    NOT divide by the (max - min) range."""

    def __init__(self, low_perc: float = 0, top_perc: float = 95):
        self.low_perc = low_perc
        self.top_perc = top_perc

    @staticmethod
    def percentile(x, q) -> float:
        flat = np.asarray(x).reshape(-1)
        k = 1 + round(0.01 * float(q) * (flat.size - 1))
        return float(np.partition(flat, k - 1)[k - 1])

    def __call__(self, x, is_flow: bool = False):
        t_max = self.percentile(x, self.top_perc)
        t_min = self.percentile(x, self.low_perc)
        if t_max == 0 and t_min == 0:
            return x
        eps = 1e-6
        normed = np.clip(x, t_min, t_max)
        return (normed - normed.min()) / (normed.max() + eps)


class LegacyNorm:
    """Zero-mean unit-std over nonzero entries
    (utils/data_augmentation.py:188-210)."""

    def __call__(self, x, is_flow: bool = False):
        nonzero = (x != 0)
        num = nonzero.sum()
        if num == 0:
            return x
        mean = x.sum() / num
        stddev = np.sqrt((x ** 2).sum() / num - mean ** 2)
        mask = nonzero.astype(x.dtype)
        return mask * (x - mean) / max(float(stddev), 1e-9)


def add_hot_pixels_to_sequence_(sequence: List[dict],
                                hot_pixel_std: float = 1.0,
                                max_hot_pixel_fraction: float = 0.001) -> None:
    """In-place persistent hot pixels across a sequence's voxels
    (utils/data_augmentation.py:44-56); events are (...,H,W,C)."""
    fraction = random.uniform(0, max_hot_pixel_fraction)
    voxel = sequence[0]["events"]
    h, w = voxel.shape[-3], voxel.shape[-2]
    num = int(fraction * h * w)
    x = np.random.randint(0, w, num)
    y = np.random.randint(0, h, num)
    val = np.random.randn(num) * hot_pixel_std
    for item in sequence:
        for i in range(num):
            item["events"][..., y[i], x[i], :] += val[i]


def add_noise_to_voxel(voxel: np.ndarray, noise_std: float = 1.0,
                       noise_fraction: float = 0.1) -> np.ndarray:
    """Gaussian noise on a `noise_fraction` share of the voxel's entries
    (utils/data_augmentation.py:58-64). Not data/esim.py's function of
    the same name: the noise here is cast to the voxel's dtype before it
    is added, and there is no integer (Poisson) noise."""
    noise = noise_std * np.random.randn(*voxel.shape).astype(voxel.dtype)
    if noise_fraction < 1.0:
        mask = np.random.rand(*voxel.shape) >= noise_fraction
        noise = np.where(mask, 0, noise)
    return voxel + noise
