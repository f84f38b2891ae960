"""The port's V2E pixel model (v2v_tpu_torch/ops/voxel_v2e.py) against
the JAX package's v2e_video_to_voxel: the four threshold models with the
low pass, the leak and the refractory clip on and every noise off,
within a stated flip budget; shot noise by its mean and variance, beside
JAX's. Five JAX calls in all."""
import jax
import numpy as np
import pytest
import torch

from v2v_tpu.ops import voxel_v2e as jv2e

from v2v_tpu_torch.ops import voxel_v2e as tv2e

# float32 logs and divisions may round apart (XLA's log is not libm's),
# so a count can flip by one where diff / threshold lands on an integer
FLIP_SHARE = 1e-3          # of the counts
FLIP_MAX = 1.0             # counts


def _video(n=13, h=24, w=32, seed=0):
    """A drifting texture with a brightness ramp, uint8."""
    rng = np.random.RandomState(seed)
    tex = rng.uniform(10, 245, (h + n, w + 2 * n))
    return np.stack([np.clip(tex[t:t + h, 2 * t:2 * t + w] * (0.7 + 0.05 * t),
                             0, 255) for t in range(n)]).astype(np.uint8)


def _noise_free(model):
    return dict(threshold_model=model, thres_mean_mean=0.3,
                thres_mean_std=0.0, thres_diff_mean=0.06,
                thres_diff_std=0.0, cutoff_hz=40.0, leak_rate_hz=3.0,
                refractory_period_s=1 / 24 / 3, shot_noise_rate_hz=0.0,
                leak_jitter_fraction=0.0, noise_rate_cov_decades=0.0)


@pytest.mark.parametrize("model", tv2e.THRESHOLD_MODELS)
def test_noise_free_counts_match_jax(model):
    video = _video()
    kw = _noise_free(model)
    want = np.asarray(jv2e.v2e_video_to_voxel(
        video, jv2e.V2EConfig(**kw), jax.random.PRNGKey(0)))
    got = tv2e.v2e_video_to_voxel(
        torch.from_numpy(video), tv2e.V2EConfig(**kw),
        torch.Generator().manual_seed(0)).numpy()
    assert got.shape == want.shape == (12, 24, 32)
    assert got.dtype == np.float32
    diff = np.abs(got - want)
    assert np.abs(want).sum() > 1000          # events fire
    assert np.abs(want).max() == 3            # the refractory clip binds
    assert diff.max() <= FLIP_MAX and (diff > 0).mean() <= FLIP_SHARE


def test_shot_noise_mean_and_variance():
    """A still video with every other noise off: the first frame's
    counts are pos - neg of two Poisson(lam) draws a pixel, lam =
    rate / 2 / fps (mean 0, variance 2 lam), and the later frames, where
    the shots' own compensation fires too, spread as JAX's do."""
    n, h, w, rate, fps = 9, 64, 64, 24.0, 24.0
    video = np.full((n, h, w), 128, np.uint8)
    kw = dict(_noise_free("pn_related"), cutoff_hz=0.0, leak_rate_hz=0.0,
              refractory_period_s=0.0, shot_noise_rate_hz=rate)
    got = tv2e.v2e_video_to_voxel(
        torch.from_numpy(video), tv2e.V2EConfig(**kw),
        torch.Generator().manual_seed(1), fps).numpy()
    want = np.asarray(jv2e.v2e_video_to_voxel(
        video, jv2e.V2EConfig(**kw), jax.random.PRNGKey(1), fps))
    lam = rate / 2 / fps
    m = h * w
    first = got[0]
    assert set(np.unique(first)) <= set(range(-8, 9))
    # 5 standard errors of the mean and of the variance of m draws
    assert abs(first.mean()) <= 5 * np.sqrt(2 * lam / m)
    assert abs(first.var() - 2 * lam) <= 5 * 2 * lam * np.sqrt(2 / m)
    for g, j in zip(np.abs(got).mean(axis=(1, 2)),
                    np.abs(want).mean(axis=(1, 2))):
        assert abs(g - j) <= 0.1 * j
