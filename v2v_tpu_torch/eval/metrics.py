"""Test metrics: MSE and SSIM with the reference's conventions
(model/train_utils.py:212-248), the port's copy of
v2v_tpu/eval/metrics.py (numpy and scipy, no JAX).

SSIM reimplements skimage.metrics.structural_similarity for the
reference's settings: win_size=7, uniform windows, and the deliberately
legacy `data_range=2` the reference keeps for comparability with
ET-Net-era papers (model/train_utils.py:241-242).
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def ssim(im1: np.ndarray, im2: np.ndarray, data_range: float = 2.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean structural similarity, skimage-compatible (gaussian_weights
    False, sample covariance normalization, border crop win_size//2)."""
    im1 = im1.astype(np.float64)
    im2 = im2.astype(np.float64)
    assert im1.ndim == 2 and im1.shape == im2.shape

    np_win = win_size ** 2
    cov_norm = np_win / (np_win - 1)

    def f(img):
        return uniform_filter(img, size=win_size)

    ux, uy = f(im1), f(im2)
    uxx, uyy, uxy = f(im1 * im1), f(im2 * im2), f(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
    b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def mse(pred: np.ndarray, target: np.ndarray) -> float:
    return float(((pred.astype(np.float64) - target.astype(np.float64)) ** 2
                  ).mean())
