"""Voxel normalizations (port of v2v_tpu/ops/normalize.py): the event
visualization's normalize_nobias (reference model/train_utils.py:
128-135), in numpy for the host-side previews, and in torch the train
and eval forward's normalize_batch_voxel and the legacy datasets'
robust_norm and legacy_norm (utils/data_augmentation.py:134-210; their
host twins are data/augmentation.py's RobustNorm and LegacyNorm)."""
from __future__ import annotations

import numpy as np
import torch


def _kth_smallest(flat: np.ndarray, k: int) -> np.ndarray:
    """k-th smallest (1-indexed, torch.kthvalue semantics)."""
    return np.partition(flat, k - 1)[k - 1]


def normalize_nobias(x: np.ndarray) -> np.ndarray:
    """Symmetric robust normalization to [0,1]: values clipped to the
    99th percentile of each sign, each sign divided by its own, then
    mapped from [-1, 1] to [0, 1]."""
    flat = x.reshape(-1)
    n = int(flat.shape[0] * 0.99)
    pos_max = np.maximum(_kth_smallest(flat, n), 1e-3)
    neg_max = np.maximum(_kth_smallest(-flat, n), 1e-3)
    x = np.clip(x, -neg_max, pos_max)
    x = np.where(x > 0, x / pos_max, x / neg_max)
    return x / 2 + 0.5


def normalize_batch_voxel(voxel: torch.Tensor) -> torch.Tensor:
    """Per-sample robust normalization of a (B,T,H,W,C) (or (B,T,C,H,W))
    voxel batch (v2v_tpu/ops/normalize.py::normalize_batch_voxel;
    reference model/train_utils.py:147-166): the positive values divided
    by the sample's 99th percentile, the others by minus its 1st, each
    clamped to >= 1. The percentiles are the sorted values at
    int(0.99*n)-1 and int(0.01*n)-1, as the JAX function indexes them,
    so the result is the same bits."""
    if voxel.ndim != 5:
        raise ValueError(f"normalize_batch_voxel wants 5 dims, got "
                         f"{tuple(voxel.shape)}")
    b = voxel.shape[0]
    srt = torch.sort(voxel.reshape(b, -1), dim=1).values
    n = srt.shape[1]
    pos_max = srt[:, int(0.99 * n) - 1].clamp_min(1.0).view(b, 1, 1, 1, 1)
    neg_max = (-srt[:, int(0.01 * n) - 1]).clamp_min(1.0).view(b, 1, 1, 1, 1)
    return torch.where(voxel > 0, voxel / pos_max, voxel / neg_max)


def robust_norm(x: torch.Tensor, low_perc: float = 0.0,
                top_perc: float = 95.0) -> torch.Tensor:
    """RobustNorm: clamp to the nearest-rank percentiles (torch.kthvalue
    at 1 + round(q/100 * (n-1))), then (clamped - min) / (max + 1e-6):
    the reference divides by the max, not the range. x comes back as it
    is when both percentiles are 0 (the reference's early return)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    lo = torch.kthvalue(flat, 1 + round(0.01 * low_perc * (n - 1))).values
    hi = torch.kthvalue(flat, 1 + round(0.01 * top_perc * (n - 1))).values
    normed = torch.minimum(torch.maximum(x, lo), hi)
    out = (normed - normed.min()) / (normed.max() + 1e-6)
    return torch.where((hi == 0) & (lo == 0), x, out)


def legacy_norm(x: torch.Tensor) -> torch.Tensor:
    """Zero mean and unit std over the nonzero entries; zeros stay."""
    nonzero = x != 0
    num = nonzero.sum().to(x.dtype).clamp(min=1.0)
    mean = x.sum() / num
    std = torch.sqrt(((x * x).sum() / num - mean * mean).clamp(min=0.0))
    return torch.where(nonzero, (x - mean) / std.clamp(min=1e-9), x)
