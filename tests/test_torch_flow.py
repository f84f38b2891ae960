"""The port's flow family (v2v_tpu_torch models/unet.py::UNet,
models/model.py::EVFlowNet, training/flow_interface.py,
data/h5.py::TestH5FlowDataset, eval/flow_harness.py) against the JAX
package in float32 on the same weights: the concat-skip UNet and
EVFlowNet, the interface's forward (batched over B*T against the
per-step loop) and loss, flow_metrics and flow2rgb_np, the flow h5
reader, and the flow harness end to end."""
import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from v2v_tpu.data import h5 as jh5
from v2v_tpu.eval import flow_harness as jharness
from v2v_tpu.models.convert import torch_state_dict_to_flax
from v2v_tpu.models.model import EVFlowNet as JEVFlowNet
from v2v_tpu.models.unet import UNet as JUNet
from v2v_tpu.models.unet import UNetConfig as JUNetConfig
from v2v_tpu.training import raft as jraft
from v2v_tpu.training.flow_interface import FlowModelInterface as JFlowIface
from v2v_tpu.training.flow_interface import flow2rgb_np as j_flow2rgb
from v2v_tpu.training.flow_interface import flow_metrics as j_flow_metrics

from v2v_tpu_torch import cli
from v2v_tpu_torch.config import resolve_target
from v2v_tpu_torch.data import h5 as th5
from v2v_tpu_torch.eval import flow_harness
from v2v_tpu_torch.models.convert import jax_params_to_state_dict
from v2v_tpu_torch.models.model import EVFlowNet
from v2v_tpu_torch.models.unet import UNet, UNetConfig
from v2v_tpu_torch.training import checkpoint
from v2v_tpu_torch.training import raft as traft
from v2v_tpu_torch.training.flow_interface import (FlowModelInterface,
                                                   flow2rgb_np, flow_metrics)
from v2v_tpu_torch.training.preview import make_flow_preview

from test_data import make_hqf_h5
from test_torch_raft_large import jax_raft_large

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
EVFLOW = {"target": "model.model.EVFlowNet",
          "params": {"unet_kwargs": {"num_bins": 5}}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread at these small shapes: test workers that share
    the CPU then do not stall each other's parallel regions."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module(source="gt", iters=2):
    return {"loss": {"l1_weight": 1.0, "optical_flow_source": source,
                     "raft_num_flow_updates": iters},
            "model": copy.deepcopy(EVFLOW)}


@functools.lru_cache(maxsize=None)
def _state():
    """The port's EVFlowNet weights, drawn from a seed."""
    port = FlowModelInterface(_module(), device="cpu",
                              generator=torch.Generator().manual_seed(0))
    return port.model.state_dict()


def _port(module=None):
    port = FlowModelInterface(module or _module(), device="cpu")
    port.model.load_state_dict(_state())
    return port


def _nchw(x):
    return T(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("skip_type", ["concat", "sum"])
def test_unet_matches_jax(skip_type):
    """The head-less UNet at width 8, 3 encoders, kernel 5, 2 output
    channels, on JAX's random parameters; concat doubles each decoder's
    input width. float32 convs in other orders: atol 1e-5."""
    kw = {"num_bins": 5, "base_num_channels": 8, "num_encoders": 3,
          "num_residual_blocks": 1, "num_output_channels": 2,
          "skip_type": skip_type, "kernel_size": 5}
    x = np.random.RandomState(1).randn(2, 24, 40, 5).astype(np.float32)
    jnet = JUNet(JUNetConfig.from_kwargs(kw))
    params = jax.tree.map(np.asarray, jax.jit(jnet.init)(
        jax.random.PRNGKey(2), jnp.asarray(x)))
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    net = UNet(UNetConfig.from_kwargs(kw))
    net.load_state_dict(jax_params_to_state_dict(params))
    if skip_type == "concat":
        assert net.decoders[0].conv2d.in_channels == 2 * 64
    got = net(_nchw(x)).detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 24, 40, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_evflownet_matches_jax_and_keeps_its_kwargs():
    """EVFlowNet applies its hardcoded kwargs over the config's (here a
    width and skip that it overrides), returns the flow and a zero image
    with an empty state; the port's weights carried into JAX's tree give
    the same flow (atol 1e-5)."""
    kw = {"num_bins": 5, "base_num_channels": 4, "skip_type": "sum"}
    net = resolve_target("model.model.EVFlowNet")(kw)
    assert isinstance(net, EVFlowNet)
    assert (net.cfg.base_num_channels, net.cfg.num_encoders,
            net.cfg.skip_type, net.cfg.kernel_size) == (32, 4, "concat", 3)
    net.load_state_dict(_state())
    assert sum(p.numel() for p in net.parameters()) == 14_125_346
    x = np.random.RandomState(3).randn(2, 32, 48, 5).astype(np.float32)
    out, state = net(_nchw(x), ())
    assert state == () and net.init_state(2, 32, 48) == ()
    assert torch.equal(out["image"], torch.zeros(2, 1, 32, 48))
    jnet = JEVFlowNet(kw)
    jout, jstate = jax.jit(jnet.apply)(torch_state_dict_to_flax(_state()),
                                       jnp.asarray(x))
    assert jstate == ()
    np.testing.assert_allclose(
        out["flow"].detach().permute(0, 2, 3, 1).numpy(),
        np.asarray(jout["flow"]), atol=1e-5, rtol=1e-5)


def _events(b=2, t=3, h=20, w=36, seed=4):
    return np.random.RandomState(seed).randn(b, t, h, w, 5).astype(
        np.float32)


def test_interface_forward_and_loss_match_jax():
    """The eval forward of a 20x36 sequence (padded to 32x48 and cropped
    back) against JAX's per-step scan, and the flow L1 per (b, t) and
    its mean against JAX's calc_loss."""
    params = torch_state_dict_to_flax(_state())
    jiface = JFlowIface(_module())
    ev = _events()
    want, _ = jiface.forward_sequence(params, jnp.asarray(ev), ())
    port = _port()
    with torch.no_grad():
        got, state = port.forward_sequence(T(ev),
                                           port.init_state(2, 20, 36))
    assert got.shape == (2, 3, 20, 36, 2) and got.dtype == torch.float32
    assert state == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    gt = np.random.RandomState(5).randn(2, 3, 20, 36, 2).astype(np.float32)
    jloss, jaux = jiface.calc_loss(jnp.asarray(want), {"flow": gt})
    loss, aux = port.calc_loss(got, {"flow": T(gt)}, remove_flow_loss=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["l1_loss"].numpy(),
                               np.asarray(jaux["l1_loss"]), rtol=1e-5)
    assert aux["l1_loss"].shape == (2,)
    for k in ("pred_max_val", "pred_min_val"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5)


def test_batched_forward_equals_the_per_step_loop():
    """In training, EVFlowNet (no state, no BatchNorm) runs once over
    B*T; with scan_split off, one step a time step. The flows and the
    gradients of a loss on them agree to float32 rounding."""
    ev = T(_events())
    runs = []
    for split in (True, False):
        port = _port(dict(_module(), scan_split=split))
        assert port.scan_split == split
        calls = []
        fwd = type(port.model).forward

        def counting(self, *a, **k):
            calls.append(a[0].shape[0])
            return fwd(self, *a, **k)

        port.model.forward = counting.__get__(port.model)
        pred, _ = port.forward_sequence(ev, (), train=True)
        (pred ** 2).sum().backward()
        runs.append((pred.detach(), [p.grad.clone()
                                     for p in port.model.parameters()],
                     calls))
    (p1, g1, c1), (p2, g2, c2) = runs
    assert c1 == [6] and c2 == [2, 2, 2]
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), atol=1e-5, rtol=1e-5)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4,
                                   rtol=1e-3)


def test_bfloat16_forward_matches_jax():
    """compute_dtype bfloat16: the forward on bf16 copies of the weights
    and bf16 events, the flow returned in float32; within 2% of JAX's
    bf16 train forward (bf16 keeps ~3 significant digits and the two
    frameworks round at different places)."""
    params = torch_state_dict_to_flax(_state())
    mod = dict(_module(), compute_dtype="bfloat16")
    ev = _events(t=2)
    want, _ = jax.jit(lambda p, e: JFlowIface(mod).forward_sequence(
        p, e, (), train=True))(params, jnp.asarray(ev))
    with torch.no_grad():
        got, _ = _port(mod).forward_sequence(T(ev), (), train=True)
    assert got.dtype == torch.float32
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).mean() / np.abs(want).mean()
    assert err < 2e-2


def test_prepare_flow_sources(monkeypatch):
    """Stored flow at test time or for source 'gt'; zeros; RAFT-large
    pseudo-GT over the T+1 frames, replacing a stored flow, equal to
    JAX's on a bridged teacher (float32, 2 updates: atol 1e-3); 'gt'
    without flow raises; an unknown forward_type raises."""
    frames = np.random.RandomState(6).rand(1, 4, 32, 40, 1).astype(
        np.float32)
    stored = np.full((1, 3, 32, 40, 2), 7.0, np.float32)
    zeros = FlowModelInterface(_module("zeros"), device="cpu")
    out = zeros.prepare_flow({"frame": T(frames), "flow": T(stored)},
                             test=True)
    assert float(out["flow"].abs().max()) == 7.0
    out = zeros.prepare_flow({"frame": T(frames), "flow": T(stored)})
    assert out["flow"].shape == (1, 3, 32, 40, 2)
    assert float(out["flow"].abs().max()) == 0.0
    with pytest.raises(KeyError):
        _port().prepare_flow({"frame": T(frames)})

    model, variables = jax_raft_large(2)
    monkeypatch.setitem(jraft._cache, ("raft_large", 2), (model, variables))
    teacher = traft.random_teacher(2, "cpu", source="raft_large")
    teacher.load_state_dict(jax_params_to_state_dict(variables))
    port = FlowModelInterface(_module("raft_large"), device="cpu",
                              teacher=teacher)
    assert port.uses_teacher
    port.teacher_dtype = None
    got = port.prepare_flow({"frame": T(frames), "flow": T(stored)})["flow"]
    raft_flow = jraft.raft_flow
    monkeypatch.setattr(jraft, "raft_flow", lambda *a, **k: raft_flow(
        *a, **dict(k, compute_dtype=None)))
    want = JFlowIface(_module("raft_large")).prepare_flow(
        {"frame": jnp.asarray(frames)})["flow"]
    assert got.shape == want.shape == (1, 3, 32, 40, 2)
    assert float(got.abs().max()) > 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-3)
    with pytest.raises(ValueError, match="forward_type"):
        FlowModelInterface(dict(_module(), forward_type="raft"),
                           device="cpu")


def test_flow_metrics_match_jax():
    """Dense and sparse EPE/1PE/3PE with NaN and both-zero GT pixels and
    a frame without events: the same numbers as JAX's numpy."""
    rng = np.random.RandomState(7)
    pred = rng.randn(1, 3, 12, 16, 2) * 2
    gt = rng.randn(1, 3, 12, 16, 2) * 2
    gt[0, 0, :3, :4] = np.nan
    gt[0, 1, 5:, :] = 0.0
    events = rng.randn(1, 3, 12, 16, 5) * (rng.rand(1, 3, 12, 16, 1) > 0.5)
    events[0, 2] = 0.0
    got = flow_metrics(pred, gt, events, "MVSEC/seq")
    want = j_flow_metrics(pred, gt, events, "MVSEC/seq")
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        assert got[k] == want[k], k
    assert got["MVSEC/seq/sparse_EPE"][2] == 0.0


@pytest.mark.parametrize("max_mag", [None, 3.0])
def test_flow2rgb_matches_jax(max_mag):
    rng = np.random.RandomState(8)
    fx, fy = rng.randn(20, 24) * 4, rng.randn(20, 24) * 4
    np.testing.assert_array_equal(flow2rgb_np(fx, fy, max_mag),
                                  j_flow2rgb(fx, fy, max_mag))
    z = np.zeros((8, 8))
    np.testing.assert_array_equal(flow2rgb_np(z, z), j_flow2rgb(z, z))


def test_flow_preview_matches_jax():
    from v2v_tpu.training.preview import make_flow_preview as j_preview
    rng = np.random.RandomState(9)
    batch = {"events": rng.randn(1, 3, 8, 10, 5).astype(np.float32),
             "frame": rng.rand(1, 4, 8, 10, 1).astype(np.float32),
             "flow": rng.randn(1, 3, 8, 10, 2).astype(np.float32)}
    pred = rng.randn(1, 3, 8, 10, 2).astype(np.float32)
    got = make_flow_preview(batch, pred)
    assert got.shape == (1, 3, 3, 8, 50) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, j_preview(batch, pred))


@pytest.mark.parametrize("cfg", [
    {"sequence_length": 3, "num_bins": 5, "interpolate_bins": True},
    {"sequence_length": 4, "num_bins": 5, "output_additional_frame": True,
     "output_additional_evs": True, "image_range": 1, "max_samples": 1},
])
def test_flow_h5_dataset_equals_jax(tmp_path, cfg):
    """An MVSEC-style h5 of 8 flows: the flow keys drive the windows,
    events sliced between flow timestamps, flow (2,H,W) transposed to
    (H,W,2); every field equal to JAX's reader (its numpy voxelizer)."""
    path = make_hqf_h5(str(tmp_path / "indoor_flying1.h5"), n_frames=8,
                       with_flow=True)
    cfg = dict(cfg, dataset_name="mvsec", use_native_voxel_builder=False)
    ours = th5.TestH5FlowDataset(path, cfg)
    theirs = jh5.TestH5FlowDataset(path, cfg)
    assert len(ours) == len(theirs) >= 1
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        assert a["flow"].shape[-1] == 2
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    assert resolve_target("data.testh5.TestH5FlowDataset") is \
        th5.TestH5FlowDataset


def _read_metrics(path):
    with open(path) as f:
        return {k: float(v) for k, v in
                (ln.rsplit(": ", 1) for ln in f if ln.strip())}


def test_harness_matches_jax_end_to_end(tmp_path, monkeypatch):
    """The flow harness's run_single_test and main on the same EVFlowNet
    weights and a bridged RAFT-large teacher (2 updates, float32 in both
    packages): an MVSEC flow h5 scored against its stored GT in two
    windows (state reset per sequence), and a reconstruction h5 without
    flow scored against the teacher's pseudo-GT; test_metrics.txt, the
    CSV row, the NPY files and the PNGs agree."""
    model, variables = jax_raft_large(2)
    monkeypatch.setitem(jraft._cache, ("raft_large", 2), (model, variables))
    raft_flow = jraft.raft_flow
    monkeypatch.setattr(jraft, "raft_flow", lambda *a, **k: raft_flow(
        *a, **dict(k, compute_dtype=None)))
    teacher = traft.random_teacher(2, "cpu", source="raft_large")
    teacher.load_state_dict(jax_params_to_state_dict(variables))
    monkeypatch.setattr(traft, "load_teacher", lambda *a, **k: teacher)
    tflow = traft.raft_flow
    monkeypatch.setattr(traft, "raft_flow", lambda t, f, l0, dtype: tflow(
        t, f, l0, None))
    params = torch_state_dict_to_flax(_state())
    monkeypatch.setattr(JFlowIface, "init",
                        lambda s, key, b, h, w, nb=5: (params, ()))

    flow_h5 = make_hqf_h5(str(tmp_path / "indoor_flying1.h5"), n_frames=7,
                          h=20, w=36, with_flow=True)
    (tmp_path / "flow_test.txt").write_text(flow_h5 + "\n")
    recon = make_hqf_h5(str(tmp_path / "outdoor_day1.h5"), n_frames=6,
                        h=20, w=36, seed=1)
    (tmp_path / "recon_test.txt").write_text(recon + "\n")
    cfg = {
        "experiment_name": "flow_smoke", "task": "flow",
        "test_output_dir": "results", "save_npy": True,
        "module": _module("raft_large"),
        "test_stage": {"test_num_workers": 1, "test": [
            {"data_file": str(tmp_path / "flow_test.txt"),
             "class_name": "data.testh5.TestH5FlowDataset",
             "dataset_name": "mvsec", "num_bins": 5, "sequence_length": 3,
             "use_native_voxel_builder": False},
            {"data_file": str(tmp_path / "recon_test.txt"),
             "class_name": "data.testh5.TestH5Dataset",
             "dataset_name": "mvsec", "num_bins": 5, "sequence_length": 5,
             "output_additional_frame": True, "image_range": 1,
             "use_native_voxel_builder": False}]},
    }
    exp = cfg["experiment_name"]
    root_j, root_t = str(tmp_path / "jax"), str(tmp_path / "port")
    tpath = os.path.join(root_t, "ckpt", "evflow.pth")
    os.makedirs(os.path.dirname(tpath))
    torch.save({"state_dict": _state()}, tpath)
    checkpoint.append_ckpt_path(exp, tpath, root_t)

    want = jharness.run_single_test(None, copy.deepcopy(cfg), root=root_j)
    flow_harness.main(copy.deepcopy(cfg), root=root_t, device="cpu")
    got = _read_metrics(os.path.join(root_t, "tensorboard_logs", exp,
                                     "test_metrics.txt"))
    assert sorted(got) == sorted(want) and len(got) == 12
    for k in want:
        # flows agree to ~1e-5 px; the 1PE/3PE shares count pixels
        # against thresholds, where a pixel at the edge may flip
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-3,
                                   err_msg=k)
    assert got["MVSEC/outdoor_day1/dense_EPE"] > 0
    with open(os.path.join(root_t, "tensorboard_logs", exp,
                           "all_test_results_new.csv")) as f:
        head, row = [ln.rstrip("\n").split(",") for ln in f]
    assert head[1:-1] == flow_harness.ALL_FLOW_METRIC_NAMES
    assert row[0] == "evflow.pth"
    filled = {head[i]: float(v) for i, v in enumerate(row) if v and i}
    assert sorted(filled) == sorted(want)
    assert all(filled[k] == got[k] for k in filled)
    for seq in ("indoor_flying1", "outdoor_day1"):
        d = lambda r: os.path.join(r, "results", "MVSEC", seq)
        files = sorted(os.listdir(d(root_j)))
        assert sorted(os.listdir(d(root_t))) == files
        n = 6 if seq == "indoor_flying1" else 5
        assert len(files) == 2 * n
        for fn in files:
            if fn.endswith(".npy"):
                np.testing.assert_allclose(
                    np.load(os.path.join(d(root_t), fn)),
                    np.load(os.path.join(d(root_j), fn)), atol=1e-5)


def test_cli_test_flow_runs_on_the_card_only(tmp_path, monkeypatch):
    """`python -m v2v_tpu_torch.cli test_flow cfg` reads the YAML and the
    last checkpoint path, and without a card refuses to run; a config
    without task: flow is refused."""
    with open(os.path.join(ROOT, "configs", "test_evflow_original.yaml")) \
            as f:
        cfg = yaml.safe_load(f)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    checkpoint.append_ckpt_path(cfg["experiment_name"], "missing.pth")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.test_flow(["test_flow", str(path)])
    with pytest.raises(ValueError, match="task: flow"):
        flow_harness.main(dict(cfg, task="e2vid"))


def test_chip_smoke_sequences_follow_the_h5_items(tmp_path):
    """chip_smoke's synthetic sequences stand in for the h5 readers: with
    a stored flow they have TestH5FlowDataset's keys, dtypes and layout
    (T+1 frames with the extra frame), without it TestH5Dataset's."""
    import chip_smoke
    path = make_hqf_h5(str(tmp_path / "indoor_flying1.h5"), n_frames=5,
                       h=20, w=36, with_flow=True)
    flow_cfg = chip_smoke.EVFLOW_TEST_CONFIG["test_stage"]["test"][3]
    cfgs = {True: dict(flow_cfg, sequence_length=3),
            False: chip_smoke.EVFLOW_TEST_CONFIG["test_stage"]["test"][2]}
    for flow, cls in ((True, th5.TestH5FlowDataset),
                      (False, th5.TestH5Dataset)):
        want = cls(path, dict(cfgs[flow], sequence_length=3))[0]
        got = chip_smoke._SyntheticSequence("s", 0, 3, (20, 36), 100,
                                            cfgs[flow], flow=flow)[0]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert got["frame"].shape[0] == 4 and got["frame"].max() <= 1.0
    np.testing.assert_array_equal(got["frame"][1], got["frame"][1])
