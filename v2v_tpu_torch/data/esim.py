"""The ESIM cached-voxel train set and its voxel noise (port of
v2v_tpu/data/esim.py; reference data/esim_dataset.py).

An ESIM cache is an h5 file of pre-stacked `frames` (N,1,H,W), `flow`
(N,2,H,W) and `events` (N,bins,H,W) voxels. A sample is a window of
sequence_length of them, randomly cropped and flipped, run through a
Markov pause chain and given gaussian or integer (Poisson * +-1) voxel
and hot-pixel noise. Every draw comes from the global `random` and
`np.random` streams, in the JAX package's order, so the same seeds give
the same items bit for bit. Items are channels-last.

The h5 read (ESIMH5Dataset) and the transform (ESIMTransform) are apart:
the transform runs on any arrays of the cache's layout. `h5py` is
imported where a file is opened.
"""
from __future__ import annotations

import random
from typing import Any, Dict

import numpy as np

from .sources import DATA_SOURCES


def _integer_noise(std: float, shape) -> np.ndarray:
    """N = Poisson(lmb) * +-1 with lmb^2 + lmb = std^2, so that Var(N)
    equals the gaussian alternative's (data/esim_dataset.py:14-22)."""
    lmb = (-1 + np.sqrt(1 + 4 * std ** 2)) / 2
    mag = np.random.poisson(lam=lmb, size=shape)
    sign = 2 * np.random.randint(0, 2, size=shape) - 1
    return mag * sign


def add_noise_to_voxel(voxel: np.ndarray, noise_std: float = 1.0,
                       noise_fraction: float = 0.1,
                       integer_noise: bool = False) -> np.ndarray:
    """Noise on every element, or on a `noise_fraction` share of them
    (data/esim_dataset.py:33-46)."""
    if integer_noise:
        noise = _integer_noise(noise_std, voxel.shape)
    else:
        noise = noise_std * np.random.randn(*voxel.shape)
    if noise_fraction < 1.0:
        mask = np.random.rand(*voxel.shape) >= noise_fraction
        noise = np.where(mask, 0, noise)
    return voxel + noise


def add_hot_pixels_to_voxels(voxels: np.ndarray, hot_pixel_std: float = 1.0,
                             max_hot_pixel_fraction: float = 0.001,
                             integer_noise: bool = False) -> np.ndarray:
    """voxels (T, H, W, C): persistent noise at a random share of the
    pixels, the same in every frame and bin (data/esim_dataset.py:7-30).

    As the JAX package does, and unlike the reference, the integer branch
    adds its noise at the drawn hot-pixel rows: the reference rebinds the
    row coordinates to the Poisson magnitudes (data/esim_dataset.py:
    20-22), so it adds at row = |noise value| (and fails where that is >=
    H). No shipped config sets integer_noise. The gaussian branch draws
    as the reference does."""
    t, h, w, c = voxels.shape
    hot_pixel_fraction = random.uniform(0, max_hot_pixel_fraction)
    num = int(hot_pixel_fraction * h * w)
    x = np.random.randint(0, w, num)
    y = np.random.randint(0, h, num)
    if integer_noise:
        val = _integer_noise(hot_pixel_std, num)
    else:
        val = np.random.randn(num) * hot_pixel_std
    noise = np.zeros((h, w))
    np.add.at(noise, (y, x), val)
    return voxels + noise[None, :, :, None]


class ESIMTransform:
    """A window of an ESIM cache -> a train item: random crop, random
    horizontal flip, the pause chain and the noise
    (data/esim_dataset.py:95-153). `configs` is the data config."""

    def __init__(self, configs: Dict[str, Any]):
        c = configs
        self.sequence_length = c.get("sequence_length", 40)
        self.proba_pause_when_running = c.get("proba_pause_when_running", 0.05)
        self.proba_pause_when_paused = c.get("proba_pause_when_paused", 0.9)
        self.noise_std = c.get("noise_std", 0.1)
        self.noise_fraction = c.get("noise_fraction", 1.0)
        self.hot_pixel_std = c.get("hot_pixel_std", 0.1)
        self.max_hot_pixel_fraction = c.get("max_hot_pixel_fraction", 0.001)
        self.random_crop_size = c.get("random_crop_size", 112)
        self.random_flip = c.get("random_flip", True)
        self.integer_noise = c.get("integer_noise", False)
        self.data_source_idx = DATA_SOURCES.index("esim")

    def __call__(self, frames: np.ndarray, flow: np.ndarray,
                 voxels: np.ndarray) -> Dict[str, Any]:
        """frames (T,1,H,W), flow (T,2,H,W), voxels (T,bins,H,W), the
        cache's layout, T = sequence_length."""
        frames = np.asarray(frames, np.float32).transpose(0, 2, 3, 1)
        flow = np.asarray(flow, np.float32).transpose(0, 2, 3, 1)
        voxels = np.asarray(voxels, np.float32).transpose(0, 2, 3, 1)
        _, h, w, _ = frames.shape
        if self.random_crop_size is not None:
            th = tw = self.random_crop_size
            i = random.randint(0, h - th)
            j = random.randint(0, w - tw)
            frames = frames[:, i:i + th, j:j + tw]
            flow = flow[:, i:i + th, j:j + tw]
            voxels = voxels[:, i:i + th, j:j + tw]
        if self.random_flip and random.random() > 0.5:
            frames = np.flip(frames, axis=2)
            flow = np.flip(flow, axis=2)
            voxels = np.flip(voxels, axis=2)

        out_f = np.zeros_like(frames)
        out_fl = np.zeros_like(flow)
        out_v = np.zeros_like(voxels)
        paused = False
        k = 0
        for t_idx in range(self.sequence_length):
            u = np.random.rand()
            prob = (self.proba_pause_when_paused if paused
                    else self.proba_pause_when_running)
            paused = u < prob
            if t_idx > 0 and paused:
                # the frame holds; flow and events stay zero
                out_f[t_idx] = out_f[t_idx - 1]
            else:
                out_f[t_idx] = frames[k]
                out_fl[t_idx] = flow[k]
                out_v[t_idx] = voxels[k]
                k += 1
            # the noise is drawn in the reference's (C,H,W) layout, so the
            # flat draws land on the same elements
            out_v[t_idx] = add_noise_to_voxel(
                out_v[t_idx].transpose(2, 0, 1), self.noise_std,
                self.noise_fraction, self.integer_noise).transpose(1, 2, 0)
        out_v = add_hot_pixels_to_voxels(
            out_v, self.hot_pixel_std, self.max_hot_pixel_fraction,
            self.integer_noise)
        return {
            "frame": out_f.astype(np.float32),
            "flow": out_fl.astype(np.float32),
            "events": out_v.astype(np.float32),
            "data_source_idx": np.int64(self.data_source_idx),
        }


class ESIMH5Dataset:
    """Windows of sequence_length frames, stepping by step_size, over an
    ESIM cache (data/esim_dataset.py:49-153), through ESIMTransform."""

    def __init__(self, h5_path: str, configs: Dict[str, Any]):
        import h5py
        self.h5_path = h5_path
        self.transform = ESIMTransform(configs)
        length = self.transform.sequence_length
        step = configs.get("step_size", length)
        with h5py.File(h5_path, "r") as f:
            self.num_frames = f["frames"].shape[0]
        self.samples = [(i, i + length)
                        for i in range(0, self.num_frames - length, step)]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        import h5py
        begin, end = self.samples[index]
        with h5py.File(self.h5_path, "r") as f:
            arrays = [f[k][begin:end] for k in ("frames", "flow", "events")]
        return self.transform(*arrays)
