"""Event visualization normalization (port of
v2v_tpu/ops/normalize.py::normalize_nobias; reference
model/train_utils.py:128-135), in numpy for the host-side previews."""
from __future__ import annotations

import numpy as np


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
