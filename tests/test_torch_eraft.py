"""The port's ERAFT (v2v_tpu_torch/models/eraft.py) against the JAX
package's (v2v_tpu/models/eraft.py) on the CPU: the functions it shares
with RAFT-large, the warm-start splat against both JAX forms, both
encoders in train and eval mode, the whole model at full width (5,270,080
parameters) on JAX's random weights, and the weight converters. float32
throughout unless a test says otherwise."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2v_tpu.models import eraft as je
from v2v_tpu.models.convert import torch_state_dict_to_flax, validate_against

from v2v_tpu_torch.config import resolve_target
from v2v_tpu_torch.models import eraft as te
from v2v_tpu_torch.models.convert import jax_params_to_state_dict
from v2v_tpu_torch.training import raft as traft

T = torch.from_numpy
CFG = {"subtype": "warm_start"}
N_PARAMS = 5_270_080


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread at these small shapes: test workers that share
    the CPU then do not stall each other's parallel regions."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return T(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


@functools.lru_cache(maxsize=None)
def jax_eraft():
    """v2v_tpu's ERAFT with random parameters (key 5) and cnet's
    BatchNorm statistics moved off 0 / 1, so that the bridge of
    `batch_stats` shows. The refinements share their weights, so a
    one-iteration init gives the tree of any `iters`."""
    x = jnp.zeros((1, 32, 32, 5))
    model = je.ERAFT(config=CFG, n_first_channels=5, iters=1)
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(5), x, x, model.init_state(1, 32, 32)))
    rng = np.random.RandomState(6)

    def perturb(node):
        return {k: perturb(v) if isinstance(v, dict) else (
            (rng.randn(*v.shape) * 0.1).astype(np.float32) if k == "mean"
            else (1 + rng.rand(*v.shape)).astype(np.float32))
            for k, v in node.items()}
    return dict(variables, batch_stats=perturb(variables["batch_stats"]))


def port_eraft(iters=2, variables=None):
    model = te.ERAFT(CFG, 5, iters)
    model.load_state_dict(jax_params_to_state_dict(variables or jax_eraft()))
    return model.eval()


def _voxels(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- the functions RAFT-large shares --------------------------------------

def test_training_raft_takes_the_moved_functions_from_models_eraft():
    for name in ("instance_norm", "convex_upsample", "correlation_pyramid",
                 "lookup_pyramid"):
        assert getattr(traft, name) is getattr(te, name), name


def test_instance_norm_matches_jax():
    x = _voxels(2, 9, 11, 4)
    want = np.asarray(je.instance_norm(jnp.asarray(x)))
    got = _nhwc(te.instance_norm(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hw", [(4, 4), (5, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_correlation_and_lookup_match_jax(hw, dtype):
    """The 4-level pyramid (1-pixel levels at 4x4; odd sizes floor) and
    the 9x9 lookup at fractional coordinates, some off the map, on
    256-channel features. float32 at 1e-5; bf16 stores the correlation and
    the tent weights in bf16 in both packages, their sums in other
    orders: 2e-2 on values up to ~3 (a few bf16 ulps)."""
    h, w = hw
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    f1, f2 = _voxels(2, h, w, 256, seed=1), _voxels(2, h, w, 256, seed=2)
    coords = (np.random.RandomState(3).rand(2, h, w, 2) * [w + 4, h + 4]
              - 2).astype(np.float32)
    jpyr = je.correlation_pyramid(jnp.asarray(f1, jd), jnp.asarray(f2, jd))
    want = np.asarray(je.lookup_pyramid(jpyr, jnp.asarray(coords)),
                      np.float32)
    pyr = te.correlation_pyramid(_nchw(f1).to(td), _nchw(f2).to(td))
    assert [tuple(p.shape[-2:]) for p in pyr] == [
        tuple(p.shape[1:3]) for p in jpyr]
    got = _nhwc(te.lookup_pyramid(pyr, _nchw(coords), 4).float())
    assert got.shape == want.shape == (2, h, w, 4 * 81)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


# -- the warm-start splat ---------------------------------------------------

def _splat_cases():
    rng = np.random.RandomState(7)
    frac = (rng.randn(2, 6, 9, 2) * 2).astype(np.float32)
    integer = rng.randint(-2, 3, (2, 6, 9, 2)).astype(np.float32)
    out = frac.copy()
    out[:, :2] += [[0.0, -20.0]]          # advected above the map
    out[:, :, -3:] += [[15.5, 0.0]]       # and right of it
    tiny = np.full((1, 3, 4, 2), 100.0, np.float32)    # all off the map
    tiny[0, 0, 0] = 1e-7          # but one: cell (1, 1) takes ~1.4e-14
    return {"fractional": frac, "integer": integer,
            "out_of_range": out, "epsilon": tiny}


@pytest.mark.parametrize("case", sorted(_splat_cases()))
def test_forward_interpolate_matches_both_jax_forms(case):
    """Against JAX's tent contraction and its scatter oracle: fractional
    flows; integer flows (floor == ceil: the scatter counts the corner
    twice, the ratio stays); sources advected off the map, dropped; a
    cell whose only weight (~1.4e-14) is near the 1e-15 epsilon, where the
    epsilon shows (the value 1e-7 comes out as ~0.93e-7). Weighted means
    of float32 sums in other orders: 1e-5 relative, 1e-5 absolute (the
    oracle divides sums of weights that round differently); the epsilon
    case at 1e-5 relative alone, its values being ~1e-7."""
    flow = _splat_cases()[case]
    got = te.forward_interpolate(T(flow)).numpy()
    atol = 0.0 if case == "epsilon" else 1e-5
    for jfn in (je.forward_interpolate, je.forward_interpolate_scatter):
        want = np.asarray(jfn(jnp.asarray(flow)))
        np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5,
                                   err_msg=jfn.__name__)
    if case == "out_of_range":
        assert np.abs(got).max() > 0 and np.all(np.isfinite(got))
    if case == "epsilon":
        assert 0.85e-7 < got[0, 1, 1, 0] < 0.95e-7
        assert got[0, 2, 2, 0] == 0.0     # nothing landed there


def test_forward_interpolate_repeats_and_ignores_the_tf32_flag():
    """Two calls give equal bits; the global matmul precision setting
    does not reach the splat (its matmul is float64)."""
    flow = T(_splat_cases()["fractional"])
    a = te.forward_interpolate(flow)
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        b = te.forward_interpolate(flow)
    finally:
        torch.set_float32_matmul_precision(old)
    assert a.dtype == torch.float32 and torch.equal(a, b)


# -- the encoders -----------------------------------------------------------

@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
@pytest.mark.parametrize("train", [False, True])
def test_encoders_match_jax(norm_fn, train):
    """fnet (instance norm) and cnet (BatchNorm) of JAX's ERAFT at full
    width on 4 voxels of 40x56: in eval mode with the stored statistics,
    in training with the live ones, the running mean and var updated as
    torch's (momentum 0.1, unbiased var)."""
    name = "fnet" if norm_fn == "instance" else "cnet"
    variables = jax_eraft()
    sub = {"params": variables["params"][name]}
    if norm_fn == "batch":
        sub["batch_stats"] = variables["batch_stats"][name]
    x = _voxels(4, 40, 56, 5, seed=8)
    jenc = je.BasicEncoder(256, norm_fn, 5)
    if train and norm_fn == "batch":
        want, upd = jenc.apply(sub, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    else:
        want = jenc.apply(sub, jnp.asarray(x), train=train)
    enc = te.BasicEncoder(256, norm_fn, 5)
    enc.load_state_dict(jax_params_to_state_dict(sub))
    got = _nhwc(enc.train(train)(_nchw(x)))
    assert got.shape == (4, 5, 7, 256)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
    if train and norm_fn == "batch":
        stats = jax_params_to_state_dict(dict(sub, batch_stats=jax.tree.map(
            np.asarray, upd["batch_stats"])))
        moved = 0
        for k, v in enc.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), stats[k].numpy(),
                                           atol=1e-5, rtol=1e-5, err_msg=k)
                moved += 1
        assert moved == 2 * (15 + 2)   # 15 BatchNorms, the 2 norm3 twice


# -- the whole model ----------------------------------------------------------

@pytest.mark.parametrize("hw", [(32, 32), (40, 56)])
def test_eraft_matches_jax_over_two_chained_calls(hw):
    """Full width, 2 refinements, eval mode: at 32x32 (4x4 features, so
    pyramid levels of 4, 2, 1 and 1 pixels) and at 40x56 (padded left and
    top to 64x64, cropped back). A second call starts from the first's
    splat (the warm start). Flows at 1e-4, the splatted states at 1e-4."""
    h, w = hw
    variables = jax_eraft()
    jmodel = je.ERAFT(config=CFG, n_first_channels=5, iters=2)
    model = port_eraft(2)
    v = [_voxels(2, h, w, 5, seed=s) for s in (10, 11, 12)]
    jstate = jmodel.init_state(2, h, w)
    state = model.init_state(2, h, w)
    assert tuple(state.shape) == tuple(jstate.shape) == (
        2, -(-h // 32) * 4, -(-w // 32) * 4, 2)
    apply = jax.jit(jmodel.apply)
    with torch.no_grad():
        for i in range(2):
            jout, jstate = apply(variables, jnp.asarray(v[i]),
                                 jnp.asarray(v[i + 1]), jstate)
            out, state = model(_nchw(v[i]), _nchw(v[i + 1]), state)
            want = np.asarray(jout["flow"])
            assert np.abs(want).max() > 1e-2
            np.testing.assert_allclose(_nhwc(out["flow"]), want, atol=1e-4,
                                       rtol=1e-4, err_msg=f"call {i}")
            np.testing.assert_allclose(state.numpy(), np.asarray(jstate),
                                       atol=1e-4, rtol=1e-4,
                                       err_msg=f"state {i}")


def test_eraft_at_twelve_iterations_matches_jax():
    """The configs' 12 refinements at 32x32, from a nonzero warm start:
    12 float32 GRU updates amplify the convs' summation-order
    differences, atol 1e-3 on flows of ~0.1-1 px."""
    h = w = 32
    variables = jax_eraft()
    jmodel = je.ERAFT(config=CFG, n_first_channels=5, iters=12)
    v1, v2 = _voxels(1, h, w, 5, seed=13), _voxels(1, h, w, 5, seed=14)
    state = (np.random.RandomState(15).randn(1, 4, 4, 2) * 0.5).astype(
        np.float32)
    jout, jstate = jax.jit(jmodel.apply)(variables, jnp.asarray(v1),
                                         jnp.asarray(v2), jnp.asarray(state))
    with torch.no_grad():
        out, tstate = port_eraft(12)(_nchw(v1), _nchw(v2), T(state))
    np.testing.assert_allclose(_nhwc(out["flow"]), np.asarray(jout["flow"]),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate),
                               atol=1e-3, rtol=1e-3)


def test_entry_points_and_the_subtype():
    """`method=` reaches encode and step_with_fmaps, whose composition is
    the pair call; the alias resolves; only the two subtypes build."""
    assert resolve_target("model.eraft.eraft.ERAFT") is te.ERAFT
    model = port_eraft(2)
    v1, v2 = _nchw(_voxels(1, 24, 40, 5, seed=16)), _nchw(
        _voxels(1, 24, 40, 5, seed=17))
    s = model.init_state(1, 24, 40)
    with torch.no_grad():
        f = model(torch.cat([v1, v2]), method="encode")
        assert f.shape == (2, 256, 4, 8)
        a, sa = model(f[:1], f[1:], v2, s, method="step_with_fmaps")
        b, sb = model(v1, v2, s)
    assert a["flow"].shape == (1, 2, 24, 40)
    assert torch.equal(a["flow"], b["flow"]) and torch.equal(sa, sb)
    te.ERAFT({"subtype": "standard"}, 5)
    with pytest.raises(ValueError, match="subtype"):
        te.ERAFT({"subtype": "other"}, 5)


# -- weights ------------------------------------------------------------------

def _reference_keys(model_keys):
    """The reference ERAFT's state_dict keys, built from its layout: cnet's
    strided blocks carry norm3 and downsample.1 (the same BatchNorm),
    fnet's only downsample.0 (InstanceNorm2d has no state)."""
    keys = set()
    bn = ("weight", "bias", "running_mean", "running_var",
          "num_batches_tracked")
    for enc in ("fnet", "cnet"):
        norms = bn if enc == "cnet" else ()
        keys |= {f"{enc}.conv1.{p}" for p in ("weight", "bias")}
        keys |= {f"{enc}.conv2.{p}" for p in ("weight", "bias")}
        keys |= {f"{enc}.norm1.{p}" for p in norms}
        for li in (1, 2, 3):
            for bi in (0, 1):
                blk = f"{enc}.layer{li}.{bi}"
                keys |= {f"{blk}.conv{c}.{p}" for c in (1, 2)
                         for p in ("weight", "bias")}
                keys |= {f"{blk}.norm{c}.{p}" for c in (1, 2) for p in norms}
                if li > 1 and bi == 0:
                    keys |= {f"{blk}.downsample.0.{p}"
                             for p in ("weight", "bias")}
                    keys |= {f"{blk}.norm3.{p}" for p in norms}
                    keys |= {f"{blk}.downsample.1.{p}" for p in norms}
    keys |= {k for k in model_keys if k.startswith("update_block.")}
    return keys


def test_converted_weights_load_strict_in_the_reference_layout():
    """jax_params_to_state_dict of JAX's params and batch_stats gives the
    reference's key set, `mask.0`/`mask.2` and the duplicate
    `downsample.1.*` filled from norm3 included; it loads strict, and the
    parameter count is ERAFT's."""
    model = te.ERAFT(CFG, 5)
    sd = jax_params_to_state_dict(jax_eraft())
    keys = set(model.state_dict())
    assert keys == set(sd) == _reference_keys(keys)
    assert {"update_block.mask.0.weight", "update_block.mask.2.weight",
            "update_block.encoder.convc1.weight",
            "update_block.gru.convq2.weight"} <= keys
    assert len([k for k in keys if ".downsample.1." in k]) == 2 * 5
    for k in [k for k in keys if ".downsample.1." in k]:
        assert torch.equal(sd[k], sd[k.replace("downsample.1", "norm3")])
    model.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS
    assert model.cnet.layer2[0].downsample[1] is model.cnet.layer2[0].norm3


def test_round_trip_through_the_jax_converter():
    """The port's state_dict carried back by v2v_tpu's
    torch_state_dict_to_flax covers JAX's tree strictly (the duplicate
    downsample.1 leaves are the extras it allows) and equals it."""
    variables = jax_eraft()
    back = validate_against(variables, torch_state_dict_to_flax(
        port_eraft().state_dict()), strict=True)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    a, b = flat(variables), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
