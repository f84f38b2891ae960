"""The port's simulator (v2v_tpu_torch ops/voxel.py, ops/voxel_cuda.py and
training/steps.py synthesis) against the JAX package on the same inputs.

The CPU runs the kernels' plain versions; the kernels themselves are
compared with those on the card (tests marked `cuda`, and
chip_smoke.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from v2v_tpu.ops import voxel as vx
from v2v_tpu.ops.voxel_pallas import simulate_batch_pallas
from golden_esim import golden_video_to_voxel

from v2v_tpu_torch.ops import voxel as tvx
from v2v_tpu_torch.ops import voxel_cuda as vc
from v2v_tpu_torch.training import steps as tsteps

# device-log flip budget (docs/PERF.md "Round 4: device-log flip
# budget"): two log implementations may differ by an ulp, which moves a
# near-threshold crossing by one frame: |delta| <= 1 at a rate <= 5e-4
FLIP_RATE = 5e-4


def _videos(b=2, n=11, h=32, w=128, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (b, 1, h, w)).astype(np.float32)
    drift = np.cumsum(rng.randn(b, n, h, w) * 6, axis=1)
    return np.round(np.clip(base + drift, 0, 255)).astype(np.float32)


def _tparams(b, pos=0.3, neg=0.25, noise=0.0, hot_frac=0.0, hot_std=0.0):
    return tvx.SimParams(*(torch.full((b,), v) for v in
                           (pos, neg, noise, hot_frac, hot_std)))


def _jparams(b, pos=0.3, neg=0.25):
    return vx.SimParams(*(jnp.full((b,), v) for v in (pos, neg, 0., 0., 0.)))


def _assert_flip_budget(got, want):
    diff = np.abs(got - want)
    assert diff.max() <= 1.0, diff.max()
    assert (diff > 0).mean() <= FLIP_RATE, (diff > 0).mean()


@pytest.mark.parametrize("ones", [False, True])
def test_philox_known_answers(ones):
    """Random123's philox4x32_10 known-answer vectors."""
    v = 0xFFFFFFFF if ones else 0
    want = ([0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd] if ones
            else [0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8])
    got = [int(w) for w in vc.philox4x32_10(v, v, v, v, v, v)]
    assert got == want


def test_plain_noise_free_matches_jax_pallas_and_golden():
    videos = _videos()
    b = videos.shape[0]
    got = vc.simulate_batch(torch.from_numpy(videos), torch.zeros(b, dtype=torch.int32),
                            _tparams(b), noise_free=True).float().numpy()
    # jnp scan: exact on every pixel whose log values agree bit for bit
    logs_t = tvx.log_intensity(torch.from_numpy(videos)).numpy()
    logs_j = np.asarray(jnp.log(0.001 + vx.reverse_gamma_correction(
        jnp.asarray(videos)) / 255.0))
    same_log = (logs_t == logs_j).all(axis=1)                 # (B, H, W)
    p = vx.SimParams(*(jnp.float32(v) for v in (0.3, 0.25, 0., 0., 0.)))
    scan = np.stack([np.asarray(vx.esim_video_to_voxel(jnp.asarray(v), p))
                     for v in videos])
    assert same_log.mean() > 0.5
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1)[same_log],
                                  scan.transpose(0, 2, 3, 1)[same_log])
    _assert_flip_budget(got, scan)
    pallas = np.asarray(simulate_batch_pallas(
        jnp.asarray(videos), jnp.zeros((b,), jnp.int32), _jparams(b),
        noise_free=True, interpret=True))
    _assert_flip_budget(got, pallas)
    for i in range(b):
        _assert_flip_budget(got[i], golden_video_to_voxel(videos[i], 0.3, 0.25))


def test_uint8_video_matches_float_video():
    """uint8 reads the log table, float32 evaluates the formula: the same
    counts within the flip budget; a black video fires nothing."""
    videos = _videos(seed=1)
    b = videos.shape[0]
    seeds = torch.zeros(b, dtype=torch.int32)
    f32 = vc.simulate_batch(torch.from_numpy(videos), seeds, _tparams(b),
                            noise_free=True).float().numpy()
    u8 = vc.simulate_batch(torch.from_numpy(videos.astype(np.uint8)), seeds,
                           _tparams(b), noise_free=True).float().numpy()
    _assert_flip_budget(u8, f32)
    black = vc.simulate_batch(torch.zeros((1, 5, 8, 8), dtype=torch.uint8),
                              seeds[:1], _tparams(1), noise_free=True)
    assert torch.isfinite(black).all() and black.abs().sum() == 0


def test_log_table_matches_float_formula():
    """The 256-entry table equals the formula's float32 value within
    4.8e-7, one float32 ulp at the table's largest magnitude
    (|log 0.001| = 6.9): pow and log differ by an ulp across libraries."""
    table = vc.log_table("cpu").numpy()
    v = np.arange(256, dtype=np.float32)
    jnp_vals = np.asarray(jnp.log(0.001 + vx.reverse_gamma_correction(
        jnp.asarray(v)) / 255.0))
    np_vals = np.log(np.float32(0.001) + (v / np.float32(255.0))
                     ** np.float32(2.2) * np.float32(255.0) / np.float32(255.0))
    np.testing.assert_allclose(table, jnp_vals, rtol=0, atol=4.8e-7)
    np.testing.assert_allclose(table, np_vals, rtol=0, atol=4.8e-7)
    np.testing.assert_array_equal(
        table, tvx.log_intensity(torch.from_numpy(v)).numpy())


@pytest.mark.parametrize("sigma,theta", [(0.05, 0.3), (0.1, 0.3),
                                         (0.2, 0.3), (0.1, 0.15)])
def test_noisy_rate_and_moments_match_jax(sigma, theta):
    """Philox + Irwin-Hall noise against the JAX jnp path's threefry
    normals on a static video (noise only): event rate within 5% and
    second moment within 8% (the statistical tolerances of
    tests/test_voxel_pallas.py), polarity balanced."""
    n, h, w = 101, 64, 128
    video = np.full((1, n, h, w), 128.0, np.float32)
    got = vc.simulate_batch(torch.from_numpy(video),
                            torch.tensor([1000], dtype=torch.int32),
                            _tparams(1, theta, theta, sigma)).float().numpy()[0]
    p = vx.SimParams(*(jnp.float32(v) for v in (theta, theta, sigma, 0., 0.)))
    want = np.asarray(jax.jit(lambda v, k: vx.esim_video_to_voxel(
        v, p, key=k))(jnp.asarray(video[0]), jax.random.PRNGKey(3)))
    rate_t, rate_j = np.abs(got).mean(), np.abs(want).mean()
    assert rate_j > 1e-3
    assert abs(rate_t - rate_j) / rate_j < 0.05, (rate_t, rate_j)
    m2_t, m2_j = (got ** 2).mean(), (want ** 2).mean()
    assert abs(m2_t - m2_j) / m2_j < 0.08, (m2_t, m2_j)
    assert abs(got.mean()) < 0.05 * rate_t + 1e-4


def test_noisy_path_seeded_and_hot_pixels_persistent():
    b, n, h, w = 1, 21, 32, 128
    video = torch.full((b, n, h, w), 128.0)
    run = lambda seed, **kw: vc.simulate_batch(
        video, torch.tensor([seed], dtype=torch.int32), _tparams(b, **kw))
    hot = dict(pos=0.3, neg=0.3, noise=0.0, hot_frac=0.05, hot_std=1.0)
    out = run(5, **hot)
    assert torch.equal(out, run(5, **hot))
    assert not torch.equal(out, run(6, **hot))
    rates = out.abs().sum(dim=1)[0]
    is_hot = rates > 5
    assert is_hot.sum() > 10
    assert (rates[~is_hot] == 0).float().mean() > 0.9


def test_plain_gaussian_moments():
    """K2's plain version: the Irwin-Hall moments of the JAX
    test_fast_gaussian_moments — mean 0, variance 1, kurtosis 2.7,
    truncation at 3.4506 sigma, values on the 1021-level grid."""
    s = np.concatenate([vc.sample_gaussian(seed, (512, 512),
                                           device="cpu").numpy().ravel()
                        for seed in range(8)]).astype(np.float64)
    n = s.size
    assert abs(s.mean()) < 4 / np.sqrt(n)
    assert abs(s.var() - 1.0) < 0.01
    kurt = ((s - s.mean()) ** 4).mean() / s.var() ** 2
    assert abs(kurt - 2.7) < 0.05, kurt
    assert np.abs(s).max() <= 3.4506 + 1e-4
    grid = s * 147.7950834 + 510.0
    assert np.abs(grid - np.round(grid)).max() < 1e-3
    assert len(np.unique(np.round(grid))) <= 1021


def _counts_from(monkeypatch, counts):
    """Both packages' synthesize_batch take the given counts instead of
    simulating (the two RNG streams differ by design)."""
    import v2v_tpu.ops.voxel_pallas as vp
    monkeypatch.setattr(vp, "simulate_batch_pallas",
                        lambda video, seeds, params: jnp.asarray(counts))
    monkeypatch.setattr(vc, "simulate_batch",
                        lambda video, seeds, params: torch.from_numpy(counts))


@pytest.mark.parametrize("extra_frame,extra_evs,fpb", [
    (False, False, 1), (True, False, 1), (True, True, 1), (False, False, 2)])
def test_synthesize_batch_binning_matches_jax(monkeypatch, extra_frame,
                                              extra_evs, fpb):
    from v2v_tpu.training.steps import synthesize_batch as j_synth
    bins, L, b, h, w = 5, 2, 2, 8, 12
    n = (L + (1 if extra_evs else 0)) * bins * fpb + 1
    rng = np.random.RandomState(0)
    video = rng.randint(0, 256, (b, n, h, w)).astype(np.uint8)
    counts = rng.randint(-3, 4, (b, n - 1, h, w)).astype(np.float32)
    _counts_from(monkeypatch, counts)
    ev_j, gt_j = j_synth(jnp.asarray(video), jax.random.split(
        jax.random.PRNGKey(0), b), vx.SimConfig(), bins, fpb,
        use_pallas=True, extra_frame=extra_frame, extra_evs=extra_evs)
    g = torch.Generator().manual_seed(0)
    ev_t, gt_t = tsteps.synthesize_batch(
        torch.from_numpy(video), g, tvx.SimConfig(), bins, fpb,
        extra_frame=extra_frame, extra_evs=extra_evs)
    np.testing.assert_array_equal(ev_t.numpy(), np.asarray(ev_j))
    np.testing.assert_array_equal(gt_t.numpy(), np.asarray(gt_j))


def test_synthesize_batch_fixed_thresholds_and_params():
    """Fixed per-video thresholds pin both polarities (impossibly high ->
    no events); sampled thresholds lie in the configured ranges."""
    bins, L, b, h, w = 5, 2, 2, 16, 16
    rng = np.random.RandomState(0)
    video = torch.from_numpy(np.cumsum(rng.randint(0, 20, (b, L * bins + 1, h, w)),
                                       axis=1).clip(0, 255).astype(np.uint8))
    cfg = tvx.SimConfig(base_noise_std_range=(0.0, 0.0),
                        hot_pixel_fraction_range=(0.0, 0.0),
                        hot_pixel_std_range=(0.0, 0.0))
    g = torch.Generator().manual_seed(3)
    big = torch.full((b,), 1e6)
    ev_fixed, _ = tsteps.synthesize_batch(video, g, cfg, bins, 1,
                                          fixed_pos=big, fixed_neg=big)
    assert ev_fixed.abs().sum() == 0
    ev, gt = tsteps.synthesize_batch(video, g, cfg, bins, 1)
    assert ev.shape == (b, L, h, w, bins) and ev.abs().sum() > 0
    assert gt.shape == (b, L, h, w, 1) and float(gt.max()) <= 1.0
    with pytest.raises(ValueError):
        tsteps.synthesize_batch(video, g, cfg, bins, 1, fixed_pos=big)
    p = tvx.sample_sim_params(torch.Generator().manual_seed(1),
                              tvx.SimConfig(), 4096)
    lo = torch.minimum(p.pos_thres, p.neg_thres)
    hi = torch.maximum(p.pos_thres, p.neg_thres)
    assert lo.min() >= 0.05 and lo.max() <= 2.0
    assert (hi / lo).max() <= 1.5 + 1e-5
    assert p.hot_pixel_fraction.max() <= 0.001


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = vc.sample_gaussian(7, (64, 64), device=dev)
    assert torch.equal(g.cpu(), vc.sample_gaussian_plain(7, 64 * 64, dev)
                       .cpu().view(64, 64))
    video = torch.from_numpy(_videos(n=21, h=40, w=72)).to(dev)
    seeds = torch.tensor([3, 4], dtype=torch.int32, device=dev)
    prm = tvx.SimParams(*(torch.full((2,), v, device=dev) for v in
                          (0.3, 0.25, 0.1, 0.01, 0.2)))
    for v in (video.to(torch.uint8), video):
        for noise_free in (True, False):
            got = vc.simulate_batch(v, seeds, prm, noise_free=noise_free)
            want = vc.simulate_batch_plain(v, seeds, prm,
                                           noise_free=noise_free)
            if v.dtype == torch.uint8:
                assert torch.equal(got, want)
            _assert_flip_budget(got.float().cpu().numpy(),
                                want.float().cpu().numpy())
