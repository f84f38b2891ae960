"""The port's event ops (v2v_tpu_torch/ops/events.py), its device
events_to_voxel (ops/voxel.py) and robust_norm / legacy_norm
(ops/normalize.py) against the JAX package's on the same padded events,
drawn with numpy from a seed; binary_search_h5_dset against JAX's on an
h5 dataset and on a memmap."""
import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2v_tpu.ops import events as jev
from v2v_tpu.ops import normalize as jnorm
from v2v_tpu.ops.voxel import events_to_voxel as j_events_to_voxel

from v2v_tpu_torch.ops import events as tev
from v2v_tpu_torch.ops import normalize as tnorm
from v2v_tpu_torch.ops.voxel import events_to_voxel, events_to_voxel_np

HW = (12, 16)
E, N = 512, 400            # padded length, valid events
# the scatters' float32 sums are equal: on the CPU the port adds in event
# order, as XLA's CPU scatter does, and each add is the same operation
ATOL = 0.0


def _events(seed=0, subpixel=False):
    """E padded events of which the first N are valid; the padded tail
    holds coordinates off the sensor and large weights, which both
    packages must drop."""
    rng = np.random.RandomState(seed)
    h, w = HW
    if subpixel:
        xs = rng.uniform(-0.5, w - 0.5, E).astype(np.float32)
        ys = rng.uniform(-0.5, h - 0.5, E).astype(np.float32)
    else:
        xs = rng.randint(0, w, E).astype(np.float32)
        ys = rng.randint(0, h, E).astype(np.float32)
    ts = np.sort(rng.uniform(0.0, 0.05, E)).astype(np.float32) + 1.0
    ps = rng.choice([-1.0, 1.0], E).astype(np.float32)
    xs[N:], ys[N:], ps[N:] = 3 * w, -7, 100.0
    return xs, ys, ts, ps


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("interpolation,padding,subpixel", [
    (None, False, False), ("bilinear", False, True), ("bilinear", True, True)])
def test_events_to_image(interpolation, padding, subpixel):
    xs, ys, _, ps = _events(1, subpixel)
    kw = dict(sensor_size=HW, interpolation=interpolation, padding=padding)
    want = jev.events_to_image(xs, ys, ps, jnp.int32(N), **kw)
    got = tev.events_to_image(*_t(xs, ys, ps), torch.tensor(N), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("temporal_bilinear", [True, False])
def test_events_to_voxel_bilinear_and_neg_pos(temporal_bilinear):
    xs, ys, ts, ps = _events(2)
    kw = dict(num_bins=5, sensor_size=HW,
              temporal_bilinear=temporal_bilinear)
    want = jev.events_to_voxel_bilinear(xs, ys, ts, ps, jnp.int32(N), **kw)
    got = tev.events_to_voxel_bilinear(*_t(xs, ys, ts, ps), N, **kw)
    assert got.shape == (5,) + HW
    _close(got, want)
    for g, w in zip(tev.events_to_neg_pos_voxel(*_t(xs, ys, ts, ps), N,
                                                **kw),
                    jev.events_to_neg_pos_voxel(xs, ys, ts, ps,
                                                jnp.int32(N), **kw)):
        _close(g, w)


def test_events_to_timestamp_image():
    xs, ys, ts, ps = _events(3, subpixel=True)
    want = jev.events_to_timestamp_image(xs, ys, ts, ps, jnp.int32(N),
                                         sensor_size=HW)
    got = tev.events_to_timestamp_image(*_t(xs, ys, ts, ps), N,
                                        sensor_size=HW)
    for g, w in zip(got, want):
        assert g.shape == (HW[0] + 1, HW[1] + 1)
        _close(g, w)


def test_warp_events_by_flow():
    xs, ys, ts, _ = _events(4, subpixel=True)
    flow = np.random.RandomState(5).randn(*HW, 2).astype(np.float32)
    want = jev.warp_events_by_flow(xs, ys, ts, flow, jnp.float32(1.02))
    got = tev.warp_events_by_flow(*_t(xs, ys, ts, flow), 1.02)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-6)


def _discrete(seed):
    """Padded events in the h5 path's form: int32 microseconds since the
    first event, int32 pixels, polarities in {0, 1}."""
    rng = np.random.RandomState(seed)
    h, w = HW
    t_us = np.sort(rng.randint(0, 50_000, E)).astype(np.int32)
    t_us -= t_us[0]
    xs = rng.randint(0, w, E).astype(np.int32)
    ys = rng.randint(0, h, E).astype(np.int32)
    ps = rng.randint(0, 2, E).astype(np.uint8)
    xs[N:], ys[N:] = w + 5, h + 9
    return t_us, xs, ys, ps


@pytest.mark.parametrize("interpolate", [False, True])
def test_events_to_voxel_matches_jax_and_numpy(interpolate):
    """The device voxelizer against JAX's; discrete bins are integer sums,
    equal, and equal to the host's events_to_voxel_np on the valid
    events; events_to_voxel_sorted equals the scatter."""
    t_us, xs, ys, ps = _discrete(6)
    kw = dict(num_bins=5, height=HW[0], width=HW[1],
              interpolate_bins=interpolate)
    want = j_events_to_voxel(t_us, xs, ys, ps, jnp.int32(N), **kw)
    got = events_to_voxel(*_t(t_us, xs, ys, ps), torch.tensor(N), **kw)
    _close(got, want)
    if interpolate:
        return
    host = events_to_voxel_np(t_us[:N] * 1e-6 + 5.0, xs[:N], ys[:N],
                              ps[:N], **kw)
    np.testing.assert_array_equal(got.numpy(), host)
    srt = tev.events_to_voxel_sorted(*_t(t_us, xs, ys, ps), N, num_bins=5,
                                     height=HW[0], width=HW[1])
    np.testing.assert_array_equal(srt.numpy(), got.numpy())
    np.testing.assert_array_equal(srt.numpy(), np.asarray(
        jev.events_to_voxel_sorted(t_us, xs, ys, ps, jnp.int32(N),
                                   num_bins=5, height=HW[0], width=HW[1])))


@pytest.mark.parametrize("low,top", [(0.0, 95.0), (2.0, 90.0)])
def test_robust_norm(low, top):
    x = np.random.RandomState(7).randn(3, 10, 11).astype(np.float32)
    x[0, :4] = 0
    want = jnorm.robust_norm(jnp.asarray(x), low, top)
    _close(tnorm.robust_norm(torch.from_numpy(x), low, top), want,
           atol=1e-6)
    zeros = np.zeros((4, 5), np.float32)
    zeros[0, 0] = 3.0         # both percentiles 0: returned as it is
    np.testing.assert_array_equal(
        tnorm.robust_norm(torch.from_numpy(zeros)).numpy(), zeros)


def test_legacy_norm():
    x = np.random.RandomState(8).randn(5, 9, 2).astype(np.float32)
    x[x < 0.2] = 0
    _close(tnorm.legacy_norm(torch.from_numpy(x)),
           jnorm.legacy_norm(jnp.asarray(x)), atol=1e-5)
    zeros = np.zeros((3, 3), np.float32)
    np.testing.assert_array_equal(
        tnorm.legacy_norm(torch.from_numpy(zeros)).numpy(), zeros)


def test_binary_search_on_h5_and_memmap(tmp_path):
    ts = np.sort(np.random.RandomState(9).randint(0, 50, 300)).astype(
        np.float64)
    path = str(tmp_path / "ts.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("ts", data=ts)
    np.save(tmp_path / "t.npy", ts)
    mm = np.load(tmp_path / "t.npy", mmap_mode="r")
    with h5py.File(path, "r") as f:
        for x in (-1.0, 0.0, 7.0, 7.5, 25.0, 49.0, 60.0):
            for side in ("left", "right"):
                want = int(np.searchsorted(ts, x, side=side))
                assert want == jev.binary_search_h5_dset(f["ts"], x, side)
                assert tev.binary_search_h5_dset(f["ts"], x, side) == want
                assert tev.binary_search_h5_dset(mm, x, side) == want
