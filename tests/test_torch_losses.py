"""The port's losses and teacher (v2v_tpu_torch losses/*, ops/warp.py,
training/raft.py) against the JAX package in float32, with the LPIPS
trunk and the RAFT-small teacher bridged from the JAX parameters."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from v2v_tpu.losses import losses as JL
from v2v_tpu.losses.lpips import LPIPS as JLPIPS
from v2v_tpu.losses.lpips import LPIPSModule, _load_lin_weights
from v2v_tpu.ops.warp import warp_by_flow as j_warp
from v2v_tpu.training import raft as jraft

from v2v_tpu_torch.losses import losses as TL
from v2v_tpu_torch.losses.lpips import LPIPS
from v2v_tpu_torch.models.convert import jax_params_to_state_dict
from v2v_tpu_torch.ops.warp import warp_by_flow
from v2v_tpu_torch.training.raft import raft_flow, random_teacher

T = torch.from_numpy


def jax_lpips(net="vgg"):
    """v2v_tpu's LPIPS(net) with its random trunk, initialized under jit:
    the constructor's key and parameters in a third of its eager time."""
    lp = JLPIPS.__new__(JLPIPS)
    lp.net = net
    lp.module = LPIPSModule(net=net)
    d = jnp.zeros((1, 64, 64, 3))
    params = jax.tree.map(np.asarray, jax.jit(lp.module.init)(
        jax.random.PRNGKey(7), d, d))
    params["params"].update(_load_lin_weights(net))
    lp.params = jax.tree.map(jnp.asarray, params)
    lp._jitted = jax.jit(lp._dist, static_argnums=(2, 3))
    return lp


def jax_raft_small(iters):
    """v2v_tpu's RAFT-small with random parameters (key 5). The refinement
    loop shares its weights, so a one-iteration init gives the same tree
    at a fraction of the compile time."""
    d = jnp.zeros((1, 64, 64, 3))
    params = jax.jit(jraft.RAFT(small=True, iters=1).init)(
        jax.random.PRNGKey(5), d, d)
    return jraft.RAFT(small=True, iters=iters), params


def _imgs(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_l1_matches_jax():
    a, b = _imgs(3, 8, 8, 1), _imgs(3, 8, 8, 1, seed=1)
    for reduce in (True, False):
        np.testing.assert_allclose(
            TL.l1_loss(T(a), T(b), 0.5, reduce_batch=reduce).numpy(),
            np.asarray(JL.l1_loss(a, b, 0.5, reduce_batch=reduce)),
            rtol=1e-6)


def test_warp_by_flow_matches_jax():
    """Bilinear, zero padding out of range; flows reach past the border.
    grid_sample's [-1,1] round trip costs ~1 ulp of the coordinate."""
    img = _imgs(2, 16, 20, 3)
    flow = (np.random.RandomState(2).randn(2, 16, 20, 2) * 4).astype(
        np.float32)
    np.testing.assert_allclose(warp_by_flow(T(img), T(flow)).numpy(),
                               np.asarray(j_warp(img, flow)), atol=2e-5)
    zero = np.zeros_like(flow)
    np.testing.assert_allclose(warp_by_flow(T(img), T(zero)).numpy(), img,
                               atol=1e-6)


def test_temporal_consistency_matches_jax():
    """Same images, predictions (one beyond the 255 clamp) and flow: the
    per-sample TC terms agree to float32 rounding."""
    i0, i1 = _imgs(2, 16, 16, 1), _imgs(2, 16, 16, 1, seed=1)
    p0, p1 = _imgs(2, 16, 16, 1, seed=2), _imgs(2, 16, 16, 1, seed=3)
    p0[0, 3, 3, 0] = 1e6
    fl = (np.random.RandomState(4).randn(2, 16, 16, 2) * 2).astype(np.float32)
    got = TL.temporal_consistency_loss(T(i0), T(i1), T(p0), T(p1), T(fl),
                                       reduce_batch=False).numpy()
    want = np.asarray(JL.temporal_consistency_loss(i0, i1, p0, p1, fl,
                                                   reduce_batch=False))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.filterwarnings("ignore:LPIPS")
@pytest.mark.parametrize("size", [64, 40])
def test_lpips_vgg_matches_jax_on_bridged_trunk(size):
    """The JAX LPIPS params (random trunk + shipped lin heads) carried
    into the port: distances agree to 1e-4 relative (float32 conv sums
    in different orders across 13 layers). 40 px exercises the <64 px
    bilinear upsample."""
    jl = jax_lpips()
    tl = LPIPS("vgg", device="cpu")
    tl.module.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, jl.params)))
    a, b = _imgs(3, size, size, 1), _imgs(3, size, size, 1, seed=1)
    want = np.asarray(jl(jnp.asarray(a), jnp.asarray(b), True))
    got = tl(T(a), T(b), normalize=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    split = tl.dist_from_features(tl.features(tl.prep(T(a), True)),
                                  tl.features(tl.prep(T(b), True)))
    np.testing.assert_array_equal(split.numpy(), got)


def test_raft_small_flow_matches_jax_on_bridged_teacher(monkeypatch):
    """raft_flow with the JAX teacher's random parameters in both
    packages, float32, 64x64 (8x8 features; the fourth pyramid level is
    1x1), 12 refinement iterations."""
    model, params = jax_raft_small(12)
    monkeypatch.setitem(jraft._cache, ("raft_small", 12), (model, params))
    teacher = random_teacher(12, "cpu")
    teacher.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, params)))
    frames = _imgs(1, 3, 64, 64, 1)
    want = np.asarray(jax.jit(lambda f: jraft.raft_flow(
        "raft_small", f, 1, compute_dtype=None))(jnp.asarray(frames)))
    got = raft_flow(teacher, T(frames), 1, compute_dtype=None).numpy()
    assert got.shape == want.shape == (1, 3, 64, 64, 2)
    assert np.abs(want[:, 1:]).max() > 1e-3
    # 12 recurrent refinements of float32 convs: ~1e-5 px differences
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
