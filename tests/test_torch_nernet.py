"""NerNet in the port (v2v_tpu_torch models/nernet.py, the converter's
NerNet rules, ModelInterface.forward_sequence_nernet, TestH5EventDataset
and the harness's raw-event branch) against the JAX package, in float32
on the same weights: the JAX parameters are drawn from a seed into the
tree JAX's init gives (`jax.eval_shape`, so no JAX init is compiled) and
carried into the port by jax_params_to_state_dict. Small: base 8, 3
encoders, 1 residual block, 30x38 frames (padded to 32x40 inside), at
most 1,024 events a frame, so JAX compiles one event bucket."""
import copy
import functools
import glob
import os

import h5py
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

import v2v_tpu.training.interface as jiface_mod
from v2v_tpu.config import instantiate_from_config as jinstantiate
from v2v_tpu.data.h5 import TestH5EventDataset as JEventDataset
from v2v_tpu.eval import harness as jharness
from v2v_tpu.models import nernet as jn
from v2v_tpu.models.convert import torch_state_dict_to_flax

from v2v_tpu_torch import cli
from v2v_tpu_torch.config import instantiate_from_config, resolve_target
from v2v_tpu_torch.data import h5 as th5
from v2v_tpu_torch.losses.lpips import LPIPS
from v2v_tpu_torch.models import nernet as tn
from v2v_tpu_torch.models.convert import jax_params_to_state_dict
from v2v_tpu_torch.models.init import materialize
from v2v_tpu_torch.training import checkpoint
from v2v_tpu_torch.training.interface import ModelInterface

import chip_smoke
from test_data import make_hqf_h5
from test_torch_losses import jax_lpips

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "test_nernet_original.yaml")
T = torch.from_numpy
H, W, STEPS = 30, 38, 3
BUCKET = 1024        # JAX's smallest event bucket: every frame here fits
# float32 on both sides, the MLP's products and the convs in other orders
# (XLA against oneDNN): the voxel sums a few rows a pixel, the image
# comes after ~20 convs over 3 recurrent steps
VOXEL_ATOL = 1e-5
IMAGE_ATOL = 1e-4

BASE = dict(num_bins=5, num_encoders=3, base_num_channels=8,
            num_residual_blocks=1, crop_size=112, mlp_layers=[1, 30, 30, 1],
            combine_voxel=False, recurrent_network=tn.NIAM)
# each option of the converter's and the model's: the RepCNN at 1 and 3
# layers and off, normalize on and off, both recurrent_network branches
CASES = {
    "niam-cnn1": dict(BASE, use_cnn_representation=True, RepCNN_channel=16,
                      RepCNN_num_layers=1, normalize=False),
    "niam-cnn3-normalize": dict(BASE, use_cnn_representation=True,
                                RepCNN_channel=16, RepCNN_num_layers=3,
                                normalize=True),
    "niam-nocnn": dict(BASE, use_cnn_representation=False, normalize=False),
    "unet-convlstm": dict(BASE, use_cnn_representation=True,
                          RepCNN_channel=16, RepCNN_num_layers=1,
                          normalize=True, recurrent_network="UNetRecurrent",
                          recurrent_block_type="convlstm", skip_type="sum",
                          kernel_size=5, use_upsample_conv=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread at these small shapes: test workers that share
    the CPU then do not stall each other's parallel regions."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_cfg(kw):
    return {"target": "model.nernet_model.RepresentationRecurrent",
            "params": {"unet_kwargs": dict(kw)}}


def _fill(shapes, seed):
    """Random float32 leaves in the tree of `shapes`: a kernel uniform in
    +-1/sqrt(fan_in), a bias 0.1 N(0, 1), a norm scale near 1, PReLU's
    slope in [0.1, 0.4], running means 0.1 N(0, 1) and variances in
    [0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        keys = [p.key for p in path]
        if keys[0] == "batch_stats":
            x = (rng.rand(*s.shape) + 0.5 if keys[-1] == "var"
                 else 0.1 * rng.randn(*s.shape))
        elif keys[-1] == "kernel":
            b = 1 / np.sqrt(np.prod(s.shape[:-1]))
            x = rng.uniform(-b, b, s.shape)
        elif keys[-1] == "scale" and keys[-2].endswith("channel_add_conv_2"):
            x = rng.uniform(0.1, 0.4, s.shape)
        elif keys[-1] == "scale":
            x = 1 + 0.1 * rng.randn(*s.shape)
        else:
            x = 0.1 * rng.randn(*s.shape)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _events(n, seed, h=H, w=W, bucket=None, t0=0.0):
    """(n,5) float64 events [x, y, t, p, 0], t sorted from t0 over 0.05 s,
    both polarities; with `bucket`, float32 padded to it with a random
    tail (JAX's mask must drop it)."""
    rng = np.random.RandomState(seed)
    evs = np.zeros((n, 5))
    evs[:, 0] = rng.randint(0, w, n)
    evs[:, 1] = rng.randint(0, h, n)
    evs[:, 2] = t0 + np.sort(rng.rand(n)) * 0.05
    evs[:, 3] = rng.choice([-1.0, 1.0], n)
    if bucket is None:
        return evs
    padded = np.zeros((bucket, 5), np.float32)
    padded[:n] = evs
    padded[n:, :2] = rng.randint(0, min(h, w), (bucket - n, 2))
    padded[n:, 2] = rng.rand(bucket - n)
    padded[n:, 3] = 1.0
    return padded


@functools.lru_cache(maxsize=None)
def _jax_model(case):
    """The JAX model, its variables (random, in the tree of its init) and
    its apply jitted at (BUCKET, H, W), the state's resolution closed
    over as JAX's interface does."""
    jm = jinstantiate(_model_cfg(CASES[case]))
    unet_state, hw = jm.init_state(1, H, W)
    dummy = jnp.zeros((BUCKET, 5), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), dummy, jnp.int32(1),
                        (unet_state, hw)))
    variables = _fill(shapes, sorted(CASES).index(case))

    def apply(v, ev, n, us):
        out, (new_us, _) = jm.apply(v, ev, n, (us, hw))
        return out, new_us

    return jm, variables, jax.jit(apply)


def _port_model(case, variables=None):
    tm = materialize(lambda: instantiate_from_config(
        _model_cfg(CASES[case])), torch.device("cpu"))
    if variables is not None:
        tm.load_state_dict(jax_params_to_state_dict(variables), strict=True)
    return tm.eval()


def _nhwc(x):
    return x.detach().numpy().transpose(0, 2, 3, 1)


def _jax_module(module, args, seed):
    """A JAX submodule's random variables (in the tree of its init on
    `args`) and its jitted apply."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    return _fill(shapes, seed), jax.jit(module.apply)


# -- the voxelization ------------------------------------------------------

@pytest.mark.parametrize("normalize", [False, True])
def test_quantization_layer_matches_jax(normalize):
    """JAX's row scatter over a padded bucket with n events counted
    against the port on those first n events, both polarities; and the
    port's row scatter against its per-bin plain form (the reference's
    shape) on the same weights: the same sums, each pixel's in another
    order of the MLP's rows (1e-6)."""
    n, c = 700, 5
    jq = jn.QuantizationLayerTrail(c, H, W, normalize=normalize)
    v, apply = _jax_module(
        jq, [jnp.zeros((BUCKET, 5)), jnp.int32(1)], 3)
    padded = _events(n, 1, bucket=BUCKET)
    want = np.asarray(apply(v, jnp.asarray(padded), jnp.int32(n)))
    tq = tn.QuantizationLayerTrail(c, normalize=normalize)
    tq.load_state_dict(jax_params_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = tq(T(padded[:n]), H, W)
        plain = tn.quantize_per_bin(tq, T(padded[:n]), H, W)
    assert got.shape == (1, 2 * c, H, W)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=VOXEL_ATOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-6)
    pos, neg = got[0, :c], got[0, c:]
    assert pos.abs().sum() > 0 and neg.abs().sum() > 0


def test_scatter_rows_sums_each_pixel_in_event_order():
    """scatter_rows equals adding each pixel's rows one after another in
    event order, bit for bit, repeats, and agrees with a float64 sum."""
    rng = np.random.RandomState(0)
    e, n_pix, c = 3000, 97, 5
    pix = torch.from_numpy(rng.randint(0, n_pix, e))
    values = torch.from_numpy(rng.randn(e, c).astype(np.float32))
    got = tn.scatter_rows(pix, values, n_pix)
    want = torch.zeros(n_pix, c)
    for i in range(e):
        want[pix[i]] = want[pix[i]] + values[i]
    assert torch.equal(got, want)
    assert torch.equal(tn.scatter_rows(pix, values, n_pix), got)
    f64 = torch.zeros(n_pix, c, dtype=torch.float64).index_add_(
        0, pix, values.double())
    np.testing.assert_allclose(got.numpy(), f64.numpy(), rtol=0, atol=1e-5)


def test_a_window_without_time_span_gives_zero_values():
    """t - t0 is 0 for every event of a window whose events share one
    timestamp, and t * w(t) with it: the voxel is zero, as JAX's."""
    tq = materialize(lambda: tn.QuantizationLayerTrail(5),
                     torch.device("cpu"))
    evs = torch.tensor([[1.0, 1.0, 3.0, 1.0, 0.0], [2.0, 2.0, 3.0, -1.0, 0.0]])
    with torch.no_grad():
        assert torch.equal(tq(evs, 4, 4), torch.zeros(1, 10, 4, 4))


# -- the submodules ----------------------------------------------------------

def test_context_block_matches_jax():
    c = 16
    v, apply = _jax_module(jn.ContextBlock2d(c, c),
                           [jnp.zeros((1, 12, 10, c))], 5)
    x = np.random.RandomState(2).randn(1, 12, 10, c).astype(np.float32)
    want = np.asarray(apply(v, jnp.asarray(x)))
    tm = tn.ContextBlock2d(c, c)
    tm.load_state_dict(jax_params_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = tm(T(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-5)


def test_nam_cell_matches_jax():
    """The NAM cell's h, c and m on random x, h, c, m (the gate split
    7/4/3, the +1 forget biases, the Local Adaptation Gate)."""
    nh = 8
    shape = (1, 8, 10, nh)
    v, apply = _jax_module(jn.NAMCell(nh), [jnp.zeros(shape)] * 4, 6)
    rng = np.random.RandomState(3)
    xs = [rng.randn(*shape).astype(np.float32) for _ in range(4)]
    want = apply(v, *map(jnp.asarray, xs))
    tm = tn.NAMCell(nh)
    tm.load_state_dict(jax_params_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = tm(*(T(x.transpose(0, 3, 1, 2).copy()) for x in xs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("num_layers", [1, 3])
def test_representation_cnn_matches_jax(num_layers):
    """The refiner at 1 layer (the shipped config's: its tail conv at
    `cnn.2`) and 3 (a BatchNorm at `cnn.3` on its running statistics,
    the tail at `cnn.5`)."""
    jm = jn.RepresentationCNN(10, 16, 3, num_layers)
    v, apply = _jax_module(jm, [jnp.zeros((1, H, W, 10))], 7)
    x = np.random.RandomState(4).randn(1, H, W, 10).astype(np.float32)
    want = np.asarray(apply(v, jnp.asarray(x)))
    tm = tn.RepresentationCNN(10, 16, 3, num_layers).eval()
    sd = jax_params_to_state_dict(v)
    assert f"cnn.{2 + 3 * max(num_layers - 2, 0)}.weight" in sd
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(T(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-5)


# -- the model and the converter -------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_converter_round_trip(case):
    """JAX's variables -> jax_params_to_state_dict -> the port's
    load_state_dict(strict=True), every key consumed; and JAX's own
    converter takes the port's state_dict back to the same tree. Each
    NerNet rule shows in the keys: the Sequentials `mlp.{i}`, `cnn.{i}`,
    `conv_x.0`, `channel_add_conv.{i}`, the stack `m_t_UpsampleLayer.{i}`,
    the two levels `representation.quantization_layer` and the
    LayerNorm's (C, 1, 1)."""
    _, v, _ = _jax_model(case)
    sd = jax_params_to_state_dict(v)
    tm = _port_model(case)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    keys = "\n".join(sd)
    assert "representation.quantization_layer.value_layer.mlp.2.weight" in sd
    kw = CASES[case]
    if kw["use_cnn_representation"]:
        tail = 2 + 3 * max(kw["RepCNN_num_layers"] - 2, 0)
        assert f"representation.ConvLayer.cnn.{tail}.weight" in sd
    if kw["recurrent_network"] == tn.NIAM:
        gcb = "unetrecurrent.encoders.1.GCB.channel_add_conv"
        assert sd[f"{gcb}.1.weight"].shape == (4, 1, 1)
        assert sd[f"{gcb}.1.bias"].shape == (4, 1, 1)
        assert sd[f"{gcb}.2.weight"].shape == (1,)
        for conv in ("conv_x", "conv_h", "conv_m", "conv_o"):
            assert f"encoders.0.recurrent_block.{conv}.0.weight" in keys
        assert "unetrecurrent.m_t_UpsampleLayer.2.conv2d.weight" in sd
    back = torch_state_dict_to_flax(tm.state_dict())
    want = jax.tree_util.tree_flatten_with_path(v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


@pytest.mark.parametrize("case", sorted(CASES))
def test_representation_recurrent_matches_jax(case):
    """STEPS recurrent steps, state carried, on frames of 700, 1024 and
    300 events: JAX over a padded bucket with the count, the port on the
    counted events. The voxel, the image (the top-left crop of the
    symmetrically padded output) and the carried state agree."""
    jm, v, apply = _jax_model(case)
    tm = _port_model(case, v)
    js, _ = jm.init_state(1, H, W)
    ts = tm.init_state(1, H, W)
    assert ts[1] == (H, W)
    for step, n in enumerate((700, BUCKET, 300)):
        padded = _events(n, 10 + step, bucket=BUCKET)
        out, js = apply(v, jnp.asarray(padded), jnp.int32(n), js)
        with torch.no_grad():
            got, ts = tm(T(padded[:n]), ts)
        assert got["image"].shape == (1, 1, H, W)
        np.testing.assert_allclose(_nhwc(got["voxel"]),
                                   np.asarray(out["voxel"]), rtol=0,
                                   atol=VOXEL_ATOL)
        np.testing.assert_allclose(_nhwc(got["image"]),
                                   np.asarray(out["image"]), rtol=0,
                                   atol=IMAGE_ATOL, err_msg=f"step {step}")
    flat_j = jax.tree.leaves(js)
    flat_t = [x for x in jax.tree.leaves(ts[0], is_leaf=torch.is_tensor)]
    assert len(flat_j) == len(flat_t)
    for j, t in zip(flat_j, flat_t):
        np.testing.assert_allclose(_nhwc(t), np.asarray(j), rtol=0,
                                   atol=IMAGE_ATOL)


def test_init_state_takes_one_sample():
    tm = _port_model("niam-nocnn")
    with pytest.raises(ValueError):
        tm.init_state(2, H, W)
    (h, c, m), hw = tm.init_state(1, H, W)
    assert hw == (H, W) and m.shape == (1, 8, 32, 40)
    assert [x.shape[1:] for x in h] == [(16, 16, 20), (32, 8, 10),
                                        (64, 4, 5)]


# -- the interface, the reader and the harness ------------------------------

def test_forward_sequence_nernet_shifts_absolute_stamps_in_float64():
    """Three frames stamped in absolute seconds (1e9 + t): float32 holds
    1e9 to 64 s, so a cast before the shift would give every event one
    timestamp. Both interfaces shift in float64 first; their predictions
    (1, 3, H, W, 1) agree."""
    case = "niam-cnn1"
    jm, v, _ = _jax_model(case)
    streams = [_events(n, 20 + i, t0=1e9 + 0.05 * i)
               for i, n in enumerate((600, 900, 1000))]
    assert len(np.unique(streams[0][:, 2].astype(np.float32))) <= 2
    cfg = {"is_nernet": True, "model": _model_cfg(CASES[case])}
    ji = jiface_mod.ModelInterface(cfg)
    want, _ = ji.forward_sequence_nernet(v, streams,
                                         ji.model.init_state(1, H, W))
    ti = ModelInterface(cfg, "cpu")
    assert ti.is_nernet
    ti.model.load_state_dict(jax_params_to_state_dict(v), strict=True)
    got, state = ti.forward_sequence_nernet(streams, ti.init_state(1, H, W))
    assert got.shape == (1, 3, H, W, 1) and state[1] == (H, W)
    assert not ti.model.training
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=IMAGE_ATOL)


def _event_h5(path, n_frames=7, h=12, w=14, per_frame=50, seed=0,
              empty=3):
    """An HQF-format h5 with absolute-second stamps whose window `empty`
    (between images `empty` and `empty` + 1) holds no event."""
    rng = np.random.RandomState(seed)
    counts = np.full(n_frames, per_frame)
    counts[empty] = 0
    idx = np.concatenate([[0], np.cumsum(counts)])
    n = int(idx[-1])
    with h5py.File(path, "w") as f:
        f.create_dataset("events/ts", data=1.6e9 + np.sort(rng.rand(n)))
        f.create_dataset("events/xs", data=rng.randint(0, w, n).astype(
            np.uint16))
        f.create_dataset("events/ys", data=rng.randint(0, h, n).astype(
            np.uint16))
        f.create_dataset("events/ps", data=rng.randint(0, 2, n).astype(
            np.uint8))
        for i in range(n_frames):
            d = f.create_dataset(f"images/image{i:09d}", data=rng.randint(
                0, 255, (h, w), dtype=np.uint8))
            d.attrs["event_idx"] = idx[i]
    return path


@pytest.mark.parametrize("opts", [
    {}, {"output_additional_frame": True, "image_range": 1},
    {"warm_up_length": 2, "max_samples": 2}])
def test_event_dataset_equals_jax(tmp_path, opts):
    """TestH5EventDataset's items equal JAX's: float64 [x, y, t, 2p-1, 0]
    a frame (the stamps kept to float64), one zero row for the empty
    window, the frames, real_begin_idx and frame_idx."""
    path = _event_h5(str(tmp_path / "seq.h5"))
    cfg = dict({"dataset_name": "evaid", "sequence_length": 4}, **opts)
    ours, theirs = th5.TestH5EventDataset(path, cfg), JEventDataset(path, cfg)
    assert len(ours) == len(theirs) > 1
    saw_empty = False
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        assert len(a["events"]) == len(b["events"])
        for x, y in zip(a["events"], b["events"]):
            assert x.dtype == y.dtype == np.float64
            np.testing.assert_array_equal(x, y)
            saw_empty |= x.shape == (1, 5) and not x.any()
        for k in ("frame", "real_begin_idx", "frame_idx", "data_source_idx"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["sequence_name"] == b["sequence_name"]
    assert saw_empty


def _nernet_yaml_small():
    """test_nernet_original.yaml with its UNet cut to base 8 and 1
    residual block (the voxelizer, RepCNN and the rest as shipped)."""
    with open(YAML) as f:
        cfg = yaml.safe_load(f)
    cfg.pop("test_output_dir")
    kw = cfg["module"]["model"]["params"]["unet_kwargs"]
    kw.update(base_num_channels=8, num_residual_blocks=1)
    return cfg


def test_harness_matches_jax_through_the_cli(tmp_path, monkeypatch):
    """test_nernet_original.yaml's harness at base 8 on two EVAID-named
    synthetic h5 sequences of 9 images at 30x38 (300 events a frame) in
    windows of 4 (state carried within a sequence, reset between them):
    JAX's run_test against `python -m v2v_tpu_torch.cli test_e2vid
    <yaml> --device cpu` (TestH5EventDataset, the harness's is_nernet
    branch, a checkpoint through load_params_only), the same weights and
    LPIPS-Alex trunk. Per-sequence MSE/SSIM/LPIPS agree (the predictions
    to ~1e-6; LPIPS sums 5 float32 trunk layers, 1e-4)."""
    cfg = _nernet_yaml_small()
    names = [make_hqf_h5(str(tmp_path / f"{n}.h5"), n_frames=9, h=H, w=W,
                         events_per_frame=300, seed=i)
             for i, n in enumerate(("ball", "bear"))]
    h5_list = str(tmp_path / "evaid_test.txt")
    with open(h5_list, "w") as f:
        f.write("\n".join(names) + "\n")
    cfg["test_stage"]["test_num_workers"] = 2
    cfg["test_stage"]["test"] = [dict(cfg["test_stage"]["test"][0],
                                      data_file=h5_list, sequence_length=4)]
    exp = cfg["experiment_name"]

    ji = jiface_mod.ModelInterface(cfg["module"])
    us, hw = ji.model.init_state(1, H, W)
    shapes = jax.eval_shape(lambda: ji.model.init(
        jax.random.PRNGKey(0), jnp.zeros((BUCKET, 5)), jnp.int32(1),
        (us, hw)))
    params = _fill(shapes, 11)
    jl = jax_lpips("alex")
    tl = LPIPS("alex", device="cpu")
    tl.module.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, jl.params)))
    monkeypatch.setattr(jiface_mod.ModelInterface, "lpips_test",
                        property(lambda s: jl))
    monkeypatch.setattr(ModelInterface, "lpips_test", property(lambda s: tl))

    root_j, root_t = tmp_path / "jax", tmp_path / "port"
    jharness.run_test(ji, params, copy.deepcopy(cfg), root=str(root_j))
    os.makedirs(root_t / "ckpt")
    tpath = str(root_t / "ckpt" / "nernet.pth")
    torch.save({"state_dict": jax_params_to_state_dict(params)}, tpath)
    checkpoint.append_ckpt_path(exp, tpath, str(root_t))
    yaml_path = root_t / "nernet.yaml"
    yaml_path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(root_t)
    assert cli.main(["test_e2vid", str(yaml_path), "--device", "cpu"]) == 0

    read = lambda r: {k: float(v) for k, v in (
        ln.rsplit(": ", 1) for ln in open(os.path.join(
            r, "tensorboard_logs", exp, "test_metrics.txt")) if ln.strip())}
    want, got = read(str(root_j)), read(str(root_t))
    assert sorted(got) == sorted(want) and len(got) == 6
    assert all(k.startswith(("EVAID/ball/", "EVAID/bear/")) for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# -- the configs -------------------------------------------------------------

def _targets(node):
    if isinstance(node, dict):
        for k, v in node.items():
            if k in ("target", "class_name") and isinstance(v, str):
                yield v
            else:
                yield from _targets(v)
    elif isinstance(node, list):
        for v in node:
            yield from _targets(v)


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(ROOT, "configs", "*.yaml"))), ids=os.path.basename)
def test_every_config_target_resolves_in_the_port(path):
    """Every `target` and `class_name` of every shipped YAML resolves
    through the port's TARGET_ALIASES to a v2v_tpu_torch object."""
    with open(path) as f:
        targets = list(_targets(yaml.safe_load(f)))
    assert targets
    for t in targets:
        assert resolve_target(t).__module__.startswith("v2v_tpu_torch."), t


def test_chip_smoke_nernet_dicts_match_yaml():
    """chip_smoke.py carries the config as dicts (the card's machine has
    no PyYAML): its NerNet module and EVAID test set equal the YAML's."""
    with open(YAML) as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.NERNET_CONFIG["module"] == cfg["module"]
    assert chip_smoke.NERNET_CONFIG["test_stage"]["test"][0] == \
        cfg["test_stage"]["test"][0]
    assert chip_smoke.NERNET_CONFIG["experiment_name"] == \
        cfg["experiment_name"]


def test_full_width_parameter_count_equals_jax():
    """The YAML's NerNet has NERNET_PARAMS parameters in the port, as many
    as in JAX's init tree (traced, not compiled)."""
    model = chip_smoke.NERNET_CONFIG["module"]["model"]
    jm = jinstantiate(model)
    us, hw = jm.init_state(1, H, W)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((BUCKET, 5)), jnp.int32(1),
        (us, hw)))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        shapes["params"]))
    tm = materialize(lambda: instantiate_from_config(model),
                     torch.device("cpu"))
    n_port = sum(p.numel() for p in tm.parameters())
    assert n_port == n_jax == chip_smoke.NERNET_PARAMS
