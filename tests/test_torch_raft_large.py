"""The port's RAFT-large teacher (v2v_tpu_torch/training/raft.py with
small=False) against the JAX package's in float32, its parameters and
frozen BatchNorm statistics bridged from JAX's random ones; the convex
upsample against JAX's; load_teacher("raft_large")."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from v2v_tpu.models.eraft import convex_upsample as j_convex_upsample
from v2v_tpu.training import raft as jraft

from v2v_tpu_torch.models.convert import jax_params_to_state_dict
from v2v_tpu_torch.models.eraft import convex_upsample
from v2v_tpu_torch.training import raft as traft
from v2v_tpu_torch.training.raft import load_teacher, raft_flow, random_teacher

T = torch.from_numpy


@functools.lru_cache(maxsize=None)
def jax_raft_large(iters):
    """v2v_tpu's RAFT-large with random parameters (key 3) and frozen
    BatchNorm statistics moved off 0 / 1, so that the bridge of
    `batch_stats` shows. The refinement loop shares its weights, so a
    one-iteration init gives the same tree at a fraction of the compile
    time."""
    d = jnp.zeros((1, 64, 64, 3))
    variables = jax.jit(jraft.RAFT(small=False, iters=1).init)(
        jax.random.PRNGKey(3), d, d)
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.RandomState(4)
    stats = jax.tree.map(lambda v: v, variables["batch_stats"])

    def perturb(node):
        for k, v in node.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "mean":
                node[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                node[k] = (1 + rng.rand(*v.shape)).astype(np.float32)
    perturb(stats)
    variables = dict(variables, batch_stats=stats)
    return jraft.RAFT(small=False, iters=iters), variables


def _imgs(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def bridged():
    model, variables = jax_raft_large(12)
    teacher = random_teacher(12, "cpu", source="raft_large")
    teacher.load_state_dict(jax_params_to_state_dict(variables))
    return model, variables, teacher


def test_raft_large_flow_matches_jax_on_bridged_teacher(bridged,
                                                        monkeypatch):
    """raft_flow with the JAX teacher's random parameters in both
    packages, float32, 64x72 (8x9 features: a 1-pixel fourth pyramid
    level, a width that needs no pad), 12 refinement iterations of the
    two separable GRUs, convex upsampling."""
    model, variables, teacher = bridged
    monkeypatch.setitem(jraft._cache, ("raft_large", 12), (model, variables))
    frames = _imgs(1, 3, 64, 72, 1)
    want = np.asarray(jax.jit(lambda f: jraft.raft_flow(
        "raft_large", f, 1, compute_dtype=None))(jnp.asarray(frames)))
    got = raft_flow(teacher, T(frames), 1, compute_dtype=None).numpy()
    assert got.shape == want.shape == (1, 3, 64, 72, 2)
    assert np.abs(want[:, 1:]).max() > 1e-3
    np.testing.assert_array_equal(got[:, 0], 0.0)
    # 12 recurrent refinements of float32 convs: ~1e-5 px differences
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def test_bridged_state_dict_is_the_whole_teacher(bridged):
    """Every parameter and frozen-BN buffer of the port's RAFT-large comes
    from the JAX tree (strict load), and the context encoder's
    BatchNorms hold JAX's statistics."""
    _, variables, teacher = bridged
    sd = jax_params_to_state_dict(variables)
    assert set(sd) == set(teacher.state_dict())
    bn = teacher.context_encoder.convnormrelu[1]
    want = variables["batch_stats"]["context_encoder"]["convnormrelu"]["1"]
    np.testing.assert_array_equal(bn.running_mean.numpy(), want["mean"])
    np.testing.assert_array_equal(bn.running_var.numpy(), want["var"])
    assert not bn.training


@pytest.mark.parametrize("hw", [(2, 3), (4, 4)])
def test_convex_upsample_matches_jax(hw):
    """flow (N,2,H,W) and mask (N,576,H,W) against JAX's NHWC
    convex_upsample: float32 softmax and nine products a pixel."""
    h, w = hw
    rng = np.random.RandomState(h)
    flow = rng.randn(2, h, w, 2).astype(np.float32)
    mask = rng.randn(2, h, w, 576).astype(np.float32)
    want = np.asarray(j_convex_upsample(jnp.asarray(flow), jnp.asarray(mask)))
    got = convex_upsample(T(flow.transpose(0, 3, 1, 2).copy()),
                          T(mask.transpose(0, 3, 1, 2).copy()))
    assert got.shape == (2, 2, 8 * h, 8 * w)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=1e-5)


def test_load_teacher_random_path_and_its_error(tmp_path, monkeypatch):
    """Without $V2V_WEIGHTS_DIR/raft_large.pth: a random RAFT-large under
    V2V_RANDOM_TEACHER, with a warning; FileNotFoundError naming the file
    without it (and with it set to 0); a saved state_dict loads back."""
    monkeypatch.setenv("V2V_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("V2V_RANDOM_TEACHER", "1")
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED raft_large"):
        teacher = load_teacher("raft_large", 3, "cpu")
    assert isinstance(teacher, traft.RAFT) and not teacher.small
    assert teacher.iters == 3 and not teacher.training
    assert teacher.mask_predictor is not None
    for flag in ("0", ""):
        monkeypatch.setenv("V2V_RANDOM_TEACHER", flag)
        with pytest.raises(FileNotFoundError, match="raft_large.pth"):
            load_teacher("raft_large", 3, "cpu")
    with pytest.raises(ValueError, match="raft_huge"):
        load_teacher("raft_huge", 3, "cpu")
    sd = random_teacher(3, "cpu", torch.Generator().manual_seed(1),
                        source="raft_large").state_dict()
    torch.save({f"module.{k}": v for k, v in sd.items()},
               tmp_path / "raft_large.pth")
    loaded = load_teacher("raft_large", 3, "cpu").state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in sd.items())
