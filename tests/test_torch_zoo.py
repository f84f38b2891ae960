"""The rest of the reconstruction zoo in the port (v2v_tpu_torch models/
submodules.py, unet.py, model.py, legacy.py, hyper.py's 3-channel head,
color.py, utils/color.py, ops/normalize.py, losses/losses.py::l2_loss,
LPIPS-SqueezeNet, the converter) against the JAX package, in float32 on
weights carried from JAX."""
import functools
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from v2v_tpu.config import instantiate_from_config as jinstantiate
from v2v_tpu.losses import losses as JL
from v2v_tpu.models.color import ColorNet as JColorNet
from v2v_tpu.models.convert import torch_state_dict_to_flax
from v2v_tpu.models.submodules import TorchInstanceNorm as JInstanceNorm
from v2v_tpu.models.submodules import TransposedConvLayer as JTransposed
from v2v_tpu.ops.normalize import normalize_batch_voxel as j_normalize
from v2v_tpu.utils import color as jcolor

from v2v_tpu_torch.config import TARGET_ALIASES, instantiate_from_config
from v2v_tpu_torch.losses import losses as TL
from v2v_tpu_torch.losses.lpips import LPIPS
from v2v_tpu_torch.models import legacy, model
from v2v_tpu_torch.models.color import ColorNet
from v2v_tpu_torch.models.convert import jax_params_to_state_dict
from v2v_tpu_torch.models.init import materialize
from v2v_tpu_torch.models.submodules import (ConvGRU, TorchInstanceNorm,
                                             TransposedConvLayer)
from v2v_tpu_torch.ops.normalize import normalize_batch_voxel
from v2v_tpu_torch.utils import color

from test_torch_losses import jax_lpips

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
# float32 on both sides; convs and sums in different orders (XLA vs
# oneDNN), so outputs agree to ~1e-6 after a few recurrent steps
ATOL = 1e-5
B, H, W, STEPS = 2, 32, 32, 3
SMALL = dict(num_bins=5, skip_type="sum", recurrent_block_type="convlstm",
             num_encoders=2, base_num_channels=8, num_residual_blocks=1,
             use_upsample_conv=True, norm="none", kernel_size=3)


def _cfg(target, **params):
    return {"target": target, "params": params}


# every model of the slice, at 32x32, base 8 (2 encoders; HyperE2VID's
# context fusion at 1/4 needs its first decoder there, so 3)
CASES = {
    "flownet": _cfg("model.model.FlowNet", unet_kwargs=SMALL),
    "flownet-concat-bn-transposed": _cfg("model.model.FlowNet", unet_kwargs=dict(
        SMALL, skip_type="concat", norm="BN", use_upsample_conv=False)),
    "color-e2vid": _cfg("model.model.ColorE2VID", unet_kwargs=SMALL),
    "wflownet": _cfg("model.model.WFlowNet", unet_kwargs=SMALL),
    "flownet-norecur": _cfg("model.model.FlowNetNoRecur", unet_kwargs=SMALL),
    "flownet-norecur-in": _cfg("model.model.FlowNetNoRecur",
                               unet_kwargs=dict(SMALL, norm="IN")),
    "firenet": _cfg("model.model.FireNet", base_num_channels=8,
                    unet_kwargs={"kernel_size": 5}),
    "firenet-legacy": _cfg("model.legacy.FireNet_legacy", unet_kwargs={
        "num_bins": 5, "base_num_channels": 8}),
    "firenet-legacy-convlstm-concat": _cfg(
        "model.legacy.FireNet_legacy", unet_kwargs={
            "num_bins": 5, "base_num_channels": 8, "num_residual_blocks": 3,
            "skip_type": "concat", "recurrent_block_type": "convlstm",
            "recurrent_blocks": {"resblock": [-1]}}),
    "e2vid-convgru": _cfg("model.model.E2VIDRecurrent", unet_kwargs=dict(
        SMALL, recurrent_block_type="convgru")),
    "e2vid-in": _cfg("model.model.E2VIDRecurrent",
                     unet_kwargs=dict(SMALL, norm="IN")),
    "e2vid-bn": _cfg("model.model.E2VIDRecurrent",
                     unet_kwargs=dict(SMALL, norm="BN")),
    "e2vid-transposed": _cfg("model.model.E2VIDRecurrent", unet_kwargs=dict(
        SMALL, use_upsample_conv=False)),
    "e2vid-concat": _cfg("model.model.E2VIDRecurrent",
                         unet_kwargs=dict(SMALL, skip_type="concat")),
    "hypere2vid-3ch": _cfg("model.hyper_model.HyperE2VID", unet_kwargs=dict(
        SMALL, num_encoders=3, kernel_size=5, num_output_channels=3,
        use_dynamic_decoder=True)),
}


@functools.lru_cache(maxsize=None)
def _jax_model(case):
    """The JAX model and its variables as numpy, running statistics moved
    off their init (mean 0, var 1) so eval mode reads them."""
    jm = jinstantiate(CASES[case])
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((B, H, W, 5)),
                         jm.init_state(B, H, W))
    v = jax.tree.map(np.array, v)
    rng = np.random.RandomState(6)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            v.get("batch_stats", {}))[0]:
        leaf += (rng.randn(*leaf.shape) * 0.1 if path[-1].key == "mean"
                 else rng.rand(*leaf.shape)).astype(np.float32)
    return jm, v


def _port_model(case, variables):
    tm = materialize(lambda: instantiate_from_config(CASES[case]), "cpu")
    tm.load_state_dict(jax_params_to_state_dict(variables))
    return tm


def _nchw(tree):
    """A JAX state (NHWC leaves, lists and tuples) as NCHW numpy."""
    if isinstance(tree, (list, tuple)):
        return [_nchw(t) for t in tree]
    return np.asarray(tree).transpose(0, 3, 1, 2)


def _flat(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def _run_both(case, train):
    """STEPS recurrent steps, state carried, in both packages; in training
    mode the norms use live statistics and update the stored ones step
    after step."""
    jm, v = _jax_model(case)
    tm = _port_model(case, v).train(train)
    rng = np.random.RandomState(7)
    js, ts = jm.init_state(B, H, W), tm.init_state(B, H, W)
    if train:
        apply = jax.jit(functools.partial(jm.apply, train=True,
                                          mutable=["batch_stats"]))
    else:
        apply = jax.jit(jm.apply)
    for _ in range(STEPS):
        x = rng.randn(B, H, W, 5).astype(np.float32)
        if train:
            (out, js), upd = apply(v, jnp.asarray(x), js)
            v = {**v, **jax.tree.map(np.asarray, upd)}
        else:
            out, js = apply(v, jnp.asarray(x), js)
        with torch.set_grad_enabled(train):
            tout, ts = tm(T(x).permute(0, 3, 1, 2), ts)
        assert sorted(tout) == sorted(out)
        for k in out:
            np.testing.assert_allclose(
                tout[k].detach().permute(0, 2, 3, 1).numpy(),
                np.asarray(out[k]), atol=ATOL, err_msg=k)
    want_state = _flat(_nchw(js))
    got_state = _flat(ts)
    assert len(got_state) == len(want_state)
    for a, b in zip(got_state, want_state):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=ATOL)
    return tm, v


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_steps_match_jax(case):
    """Eval mode: each output key (image, and flow where the model has
    one) and the carried state over 3 steps, at 1e-5."""
    _run_both(case, train=False)


NORM_CASES = [c for c in sorted(CASES) if c.endswith(("-bn", "-in"))
              or "bn-" in c or c == "hypere2vid-3ch"]


@pytest.mark.parametrize("case", NORM_CASES)
def test_model_training_mode_matches_jax(case):
    """Training mode for the models with BN or IN: live statistics in the
    outputs, and the running statistics after 3 updates at 1e-6."""
    tm, v = _run_both(case, train=True)
    want = jax_params_to_state_dict(v)
    moved = 0
    for k, val in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(val.numpy(), want[k].numpy(),
                                       atol=1e-6, err_msg=k)
            moved += 1
        elif k.endswith("num_batches_tracked"):
            assert int(val) == STEPS, k
    assert moved


@pytest.mark.parametrize("case", sorted(CASES))
def test_weights_round_trip_through_reference_converter(case):
    """JAX variables -> jax_params_to_state_dict -> the port's keys,
    exactly -> v2v_tpu's torch_state_dict_to_flax -> every leaf back."""
    _, v = _jax_model(case)
    tm = _port_model(case, v)
    sd = jax_params_to_state_dict(v)
    assert sorted(sd) == sorted(tm.state_dict())
    back = torch_state_dict_to_flax(tm.state_dict())
    want = jax.tree_util.tree_flatten_with_path(v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)


def test_hyper_3ch_feeds_back_the_image_alone():
    """HyperE2VID with num_output_channels 3: prev_recs is the 1-channel
    image, detached."""
    _, v = _jax_model("hypere2vid-3ch")
    tm = _port_model("hypere2vid-3ch", v)
    out, (_, prev) = tm(torch.randn(B, 5, H, W), tm.init_state(B, H, W))
    assert out["image"].shape == prev.shape == (B, 1, H, W)
    assert out["flow"].shape == (B, 2, H, W)
    assert not prev.requires_grad
    torch.testing.assert_close(prev, out["image"].detach())


# -- the norms and the transposed conv -----------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_torch_instance_norm_matches_jax(train):
    """Eval: the stored statistics for every sample. Training: each
    instance's own (H, W) statistics, the running ones moved toward the
    batch mean of the per-instance mean and unbiased variance."""
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 7, 5, 4) * 2 + 0.5).astype(np.float32)    # NHWC
    jn = JInstanceNorm(4)
    v = {"params": {}, "batch_stats": {"mean": rng.randn(4).astype(np.float32),
                         "var": (rng.rand(4) + 0.5).astype(np.float32)}}
    tn = TorchInstanceNorm(4)
    tn.load_state_dict(jax_params_to_state_dict(v))
    tn.train(train)
    if train:
        want, upd = jn.apply(v, jnp.asarray(x), use_running_average=False,
                             mutable=["batch_stats"])
    else:
        want, upd = jn.apply(v, jnp.asarray(x)), v
    got = tn(T(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(tn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(tn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6)
    assert int(tn.num_batches_tracked) == int(train)
    assert not list(tn.parameters())                  # affine False
    if train:
        with pytest.raises(ValueError, match="spatial"):
            tn(torch.randn(2, 4, 1, 1))


def test_torch_instance_norm_on_bfloat16():
    """bf16 in, bf16 out; the running buffers stay float32."""
    tn = TorchInstanceNorm(3).train()
    y = tn(torch.randn(2, 3, 4, 4).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert tn.running_mean.dtype == tn.running_var.dtype == torch.float32


@pytest.mark.parametrize("k,norm", [(3, None), (5, None), (5, "BN")])
def test_transposed_conv_layer_matches_jax(k, norm):
    """ConvTranspose2d(stride 2, padding k//2, output_padding 1): twice
    the input's size, the values of flax's ConvTranspose on the converted
    kernel (kH,kW,O,I) -> (I,O,kH,kW); no bias under BN."""
    rng = np.random.RandomState(k)
    x = rng.randn(2, 7, 9, 6).astype(np.float32)
    jl = JTransposed(4, k, norm=norm)
    v = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(k),
                                         jnp.asarray(x)))
    tl = TransposedConvLayer(6, 4, k, norm=norm).eval()
    sd = jax_params_to_state_dict(v)
    assert sd["transposed_conv2d.weight"].shape == (6, 4, k, k)
    assert ("transposed_conv2d.bias" in sd) == (norm is None)
    tl.load_state_dict(sd)
    want = np.asarray(jl.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tl(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 14, 18, 4)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_materialize_fills_the_new_modules():
    """Meta-device construction leaves nothing behind: two
    materializations from one seed are equal tensor for tensor; the
    ConvGRU gates are orthogonal with zero bias, the legacy pred's bias
    is 0.5 and the instance norms start at mean 0, var 1."""
    def build(case):
        return [materialize(lambda: instantiate_from_config(CASES[case]),
                            "cpu", torch.Generator().manual_seed(3))
                for _ in range(2)]

    for case in ("firenet-legacy", "e2vid-in", "flownet-concat-bn-transposed"):
        a, b = build(case)
        for (k, x), (_, y) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
            assert torch.isfinite(x.float()).all(), k
    fire = build("firenet-legacy")[0]
    gate = fire.net.head.recurrent_block.update_gate
    wm = gate.weight.flatten(1)
    torch.testing.assert_close(wm @ wm.T, torch.eye(wm.shape[0]),
                               atol=1e-5, rtol=0)
    assert bool((gate.bias == 0).all())
    assert bool((fire.net.pred.conv2d.bias == 0.5).all())
    norm = build("e2vid-in")[0].unetrecurrent.encoders[0].conv.norm_layer
    assert bool((norm.running_mean == 0).all()
                and (norm.running_var == 1).all())


def test_convgru_zero_state():
    s = ConvGRU.zero_state(2, 4, 6, 3)
    assert s.shape == (2, 3, 4, 6) and not s.any()


# -- configs --------------------------------------------------------------

def test_targets_resolve_to_the_port():
    for target, cls in (("model.model.FlowNet", model.FlowNet),
                        ("model.model.ColorE2VID", model.ColorE2VID),
                        ("model.model.WFlowNet", model.WFlowNet),
                        ("model.model.FlowNetNoRecur", model.FlowNetNoRecur),
                        ("model.model.FireNet", model.FireNet),
                        ("model.legacy.FireNet_legacy",
                         legacy.FireNetLegacy)):
        assert TARGET_ALIASES[target].rsplit(".", 1)[1] == cls.__name__
        assert isinstance(
            materialize(lambda: instantiate_from_config(
                {"target": target, "params": {"unet_kwargs": SMALL}}), "cpu"),
            cls)


def test_e2vidpp_config_builds_flownet_at_the_jax_parameter_count():
    with open(os.path.join(ROOT, "configs", "test_e2vid++_original.yaml")) as f:
        cfg = yaml.safe_load(f)
    with torch.device("meta"):
        tm = instantiate_from_config(cfg["module"]["model"])
    assert isinstance(tm, model.FlowNet)
    jm = jinstantiate(cfg["module"]["model"])
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 5)), jm.init_state(1, 32, 32))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in tm.parameters()) == want


# -- ops and losses -------------------------------------------------------

@pytest.mark.parametrize("shape,scale", [((2, 3, 8, 8, 5), 3.0),
                                         ((1, 2, 5, 7, 5), 0.3),
                                         ((3, 1, 4, 4, 2), 0.0)])
def test_normalize_batch_voxel_is_bit_equal_to_jax(shape, scale):
    """Per-sample percentiles by sort at int(0.99 n)-1 and int(0.01 n)-1,
    each clamped to >= 1: the same bits as JAX's (scale 0.3 takes the
    clamp, 0 all zeros; 32 elements a sample puts the 1st percentile at
    index -1)."""
    x = (np.random.RandomState(2).randn(*shape) * scale).astype(np.float32)
    got = normalize_batch_voxel(T(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_normalize(
        jnp.asarray(x))))


def test_l2_loss_matches_jax():
    rng = np.random.RandomState(3)
    a, b = (rng.rand(3, 8, 8, 1).astype(np.float32) for _ in range(2))
    for reduce in (True, False):
        np.testing.assert_allclose(
            TL.l2_loss(T(a), T(b), 0.5, reduce_batch=reduce).numpy(),
            np.asarray(JL.l2_loss(a, b, 0.5, reduce_batch=reduce)),
            rtol=1e-6)


_jax_squeeze = functools.lru_cache(maxsize=None)(
    lambda: jax_lpips("squeeze"))


@pytest.mark.filterwarnings("ignore:LPIPS")
@pytest.mark.parametrize("h,w", [(64, 80), (40, 50), (77, 91)])
def test_lpips_squeeze_matches_jax_on_bridged_trunk(h, w):
    """The JAX LPIPS("squeeze") params (random trunk + shipped lin heads)
    carried into the port: distances at 1e-4 relative (float32 conv sums
    in different orders). 40x50 takes the <64 px upsample; 77x91 leaves
    partial windows for the ceil-mode pools."""
    jl = _jax_squeeze()
    tl = LPIPS("squeeze", device="cpu")
    tl.module.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, jl.params)))
    lins = np.load(os.path.join(ROOT, "v2v_tpu", "losses", "weights",
                                "lpips_lin_squeeze.npz"))
    for k in lins.files:                    # the port's own copy's heads
        np.testing.assert_array_equal(
            LPIPS("squeeze", device="cpu").module.state_dict()[k].numpy(),
            lins[k])
    rng = np.random.RandomState(5)
    a, b = (rng.rand(3, h, w, 1).astype(np.float32) for _ in range(2))
    want = np.asarray(jl(a, b, True))
    got = tl(T(a), T(b), normalize=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


# -- color ----------------------------------------------------------------

@pytest.mark.parametrize("dx,dy", [(1, 1), (1, 0), (0, 1), (-2, -1)])
def test_shift_image_equals_jax_packages(dx, dy):
    x = np.random.RandomState(0).randint(0, 255, (6, 7), dtype=np.uint8)
    np.testing.assert_array_equal(color.shift_image(x.copy(), dx, dy),
                                  jcolor.shift_image(x.copy(), dx, dy))


@pytest.mark.parametrize("space", ["LAB", "HSV", "HLS"])
def test_color_merge_equals_jax_packages(space):
    rng = np.random.RandomState(0)
    channels = {k: rng.randint(0, 255, (8, 8), dtype=np.uint8)
                for k in ("R", "G", "B", "W")}
    channels["grayscale"] = rng.randint(0, 255, (16, 16), dtype=np.uint8)
    img = color.merge_channels_into_color_image(dict(channels))
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(
        img, jcolor.merge_channels_into_color_image(dict(channels)))
    low = rng.randint(0, 255, (16, 16, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        color.upsample_color_image(channels["grayscale"], low, space),
        jcolor.upsample_color_image(channels["grayscale"], low, space))
    with pytest.raises(KeyError):
        color.merge_channels_into_color_image({"R": channels["R"]})


def test_colornet_matches_jax():
    """ColorNet on E2VID at base 4 (tests/test_aux.py's), 32x48 events:
    the BGR images over two streaming calls within one grey level (the
    float32 reconstructions round to uint8 at different sides of a
    level), the second call different from the first (the states carry),
    and reset_states."""
    cfg = _cfg("model.model.E2VIDRecurrent", unet_kwargs=dict(
        SMALL, num_encoders=3, base_num_channels=4, kernel_size=5))
    jm = jinstantiate(cfg)
    h, w = 32, 48
    v = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 5)),
        jm.init_state(1, h, w)))
    tm = materialize(lambda: instantiate_from_config(cfg), "cpu")
    tm.load_state_dict(jax_params_to_state_dict(v))
    jitted = types.SimpleNamespace(init_state=jm.init_state,
                                   apply=jax.jit(jm.apply))
    jnet, tnet = JColorNet(jitted, v), ColorNet(tm)
    ev = np.random.RandomState(0).rand(1, h, w, 5).astype(np.float32)
    outs = []
    for _ in range(2):
        got, want = tnet(ev)["image"], jnet(ev)["image"]
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        outs.append(got)
    assert not np.array_equal(*outs)
    assert sorted(tnet.states) == ["B", "G", "R", "W", "grayscale"]
    tnet.reset_states()
    assert tnet.states == {}
