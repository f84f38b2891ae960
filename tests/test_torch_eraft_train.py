"""ERAFT's training and flow eval in the port (FlowModelInterface with
`forward_type: eraft`, steps.py with the extra frame and the extra event
group, training/train.py and eval/flow_harness.py) against the JAX
package: the pair forward, one float32 train step from uint8 video (the
RAFT-large teacher bridged, 2 updates, float32 in both), a bf16 step, the
flow harness's T-1 alignment, and configs/train_v2v_eraft_10k.yaml and
configs/test_eraft_original.yaml through the CLI at tiny sizes. Full
width, 2 refinements (the configs' 12 cost the same a refinement)."""
import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import v2v_tpu.ops.voxel as jvoxel
from v2v_tpu.eval import flow_harness as jharness
from v2v_tpu.models.eraft import ERAFT as JERAFT
from v2v_tpu.ops.voxel import SimConfig as JSimConfig
from v2v_tpu.training import steps as jsteps
from v2v_tpu.training.flow_interface import FlowModelInterface as JFlowIface
from v2v_tpu.training.optim import Adam as JAdam

from v2v_tpu_torch import cli
from v2v_tpu_torch.config import load_yaml
from v2v_tpu_torch.data import h5 as th5
from v2v_tpu_torch.eval import flow_harness
from v2v_tpu_torch.models.convert import jax_params_to_state_dict
from v2v_tpu_torch.ops import voxel_cuda as vc
from v2v_tpu_torch.ops.voxel import SimConfig
from v2v_tpu_torch.training import checkpoint
from v2v_tpu_torch.training import train
from v2v_tpu_torch.training.flow_interface import FlowModelInterface
from v2v_tpu_torch.training.optim import Adam
from v2v_tpu_torch.training.steps import make_train_step, synthesize_batch

from test_data import make_hqf_h5
from test_torch_eraft import jax_eraft
from test_torch_flow_train import ITERS, teachers  # noqa: F401
from test_torch_train_driver import data  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YAML = os.path.join(ROOT, "configs", "train_v2v_eraft_10k.yaml")
TEST_YAML = os.path.join(ROOT, "configs", "test_eraft_original.yaml")
T = torch.from_numpy
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread at these small shapes: test workers that share
    the CPU then do not stall each other's parallel regions."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module(source="gt", compute_dtype=None, bins=5):
    mod = {"loss": {"l1_weight": 1.0, "optical_flow_source": source,
                    "raft_num_flow_updates": ITERS},
           "forward_type": "eraft",
           "model": {"target": "model.eraft.eraft.ERAFT", "params": {
               "config": {"subtype": "warm_start"},
               "n_first_channels": bins, "iters": 2}}}
    if compute_dtype:
        mod["compute_dtype"] = compute_dtype
    return mod


def _port(module=None):
    port = FlowModelInterface(module or _module(), device="cpu")
    port.model.load_state_dict(jax_params_to_state_dict(jax_eraft()))
    return port


def _running_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if "running" in k}


def _events(b=2, tp1=4, h=30, w=44, seed=1):
    return np.random.RandomState(seed).randn(b, tp1, h, w, 5).astype(
        np.float32)


@pytest.mark.parametrize("train", [False, True])
def test_forward_sequence_matches_jax(train):
    """T+1 = 4 voxels of 30x44 (ERAFT pads to 32x64 itself, no pad to 16)
    -> 3 flows of 30x44 and the carry at 4x8, against JAX's _forward_eraft;
    in training cnet's BatchNorms take each pair's live statistics and
    their running statistics move 3 times, as JAX's scan threads them.
    Flows at 1e-4, the carry at 1e-4, running statistics at 1e-5."""
    ev = _events()
    j = JFlowIface(_module())
    jstate = j.model.init_state(2, 32, 48)
    jflow, jcarry, upd = jax.jit(lambda p, e, s: j.forward_sequence(
        p, e, s, train=train, return_updates=True))(
            jax_eraft(), jnp.asarray(ev), jstate)
    port = _port()
    state = port.init_state(2, 30, 44)
    assert tuple(state.shape) == tuple(jstate.shape) == (2, 4, 8, 2)
    before = _running_stats(port.model)
    with torch.no_grad():
        flow, carry = port.forward_sequence(T(ev), state, train=train)
    assert flow.shape == (2, 3, 30, 44, 2) and flow.dtype == torch.float32
    assert np.abs(np.asarray(jflow)).max() > 1e-2
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(carry.numpy(), np.asarray(jcarry), atol=1e-4,
                               rtol=1e-4)
    after = _running_stats(port.model)
    if train:
        want = jax_params_to_state_dict(dict(
            jax_eraft(), batch_stats=jax.tree.map(np.asarray,
                                                  upd["batch_stats"])))
        for k, v in after.items():
            assert not torch.equal(v, before[k]), k
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
        assert int(port.model.cnet.norm1.num_batches_tracked) == 3
    else:
        assert not upd
        assert all(torch.equal(v, before[k]) for k, v in after.items())


@pytest.mark.parametrize("train", [False, True])
def test_hoisted_encoding_equals_pair_by_pair(train):
    """The interface encodes the T+1 voxels once, batched; the model's own
    pair call encodes both voxels of a pair: the flows, the carry and the
    running statistics agree (convs over batches of another size sum in
    other orders; the splat's division by small weight sums amplifies
    that: JAX's own test allows 1e-4 / 5e-4 and 5e-3 / 1e-3)."""
    ev = T(_events(seed=2))
    hoisted, pairwise = _port(), _port()
    s0 = hoisted.init_state(2, 30, 44)
    with torch.no_grad():
        flow, carry = hoisted.forward_sequence(ev, s0, train=train)
        pairwise.model.train(train)
        state, flows = s0, []
        for t in range(3):
            out, state = pairwise.model(ev[:, t].permute(0, 3, 1, 2),
                                        ev[:, t + 1].permute(0, 3, 1, 2),
                                        state)
            flows.append(out["flow"].permute(0, 2, 3, 1))
    np.testing.assert_allclose(flow.numpy(), torch.stack(flows, 1).numpy(),
                               rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(carry.numpy(), state.numpy(), rtol=5e-3,
                               atol=1e-3)
    a, b = _running_stats(hoisted.model), _running_stats(pairwise.model)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def _video(b=2, n=21, hw=32, seed=3):
    """A smooth texture drifting a pixel a frame, uint8 (B, N, H, W). Its
    counts are equal in both packages; on arbitrary uint8 levels the two
    log implementations flip counts within K1's flip budget, which
    tests/test_torch_k1.py and tests/test_torch_voxel.py hold."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:hw + n, 0:hw + n]
    clips = []
    for i in range(b):
        f = rng.rand(3) * 0.3 + 0.1
        tex = 128 + 60 * np.sin(xx * f[0] + yy * f[1] + i) * np.cos(yy * f[2])
        clips.append(np.stack([tex[t:t + hw, t:t + hw] for t in range(n)]))
    return np.round(np.stack(clips)).astype(np.uint8)


@pytest.fixture
def noise_free(monkeypatch):
    """Both simulators without noise, so that at thresholds whose
    multiples are exact their counts are equal."""
    jsim = jvoxel.esim_video_to_voxel
    monkeypatch.setattr(jvoxel, "esim_video_to_voxel",
                        lambda video, params, **k: jsim(video, params))
    tsim = vc.simulate_batch
    monkeypatch.setattr(vc, "simulate_batch", lambda video, seeds, params:
                        tsim(video, seeds, params, noise_free=True))


def test_train_step_with_the_extra_event_group_matches_jax(teachers,  # noqa: F811
                                                          noise_free):
    """The simulator with the extra leading event group and the extra
    frame (2 clips of 3 time steps at 32x32, 5 bins: 4 groups, 4 frames)
    gives JAX's events and frames bit for bit; then one float32 Adam
    (amsgrad) step on them: RAFT-large's 3 pseudo-GT flows, 3 ERAFT pairs
    with live BatchNorm, the flow L1, the backward and the update. Loss
    and per-sample terms at rtol 1e-4, the grad norm at 1e-3, the
    parameters within 2*lr + 1e-6 (Adam's first step moves each by about
    lr*sign(g)), the running statistics after the step at 1e-5. The
    events go in pre-voxelized: JAX's simulator compiled into its jitted
    step counts one more or one fewer event at a few pixels than its
    eager one (XLA's fused CPU code), which moves ERAFT's loss by ~1e-3."""
    video = _video()
    pos, neg = np.full(2, 0.25, np.float32), np.full(2, 0.5, np.float32)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(1), i))(
        jnp.arange(2))
    jev, jframe = jsteps.synthesize_batch(
        jnp.asarray(video), keys, JSimConfig(), 5, 1, extra_frame=True,
        extra_evs=True, fixed_pos=jnp.asarray(pos), fixed_neg=jnp.asarray(neg))
    ev, frame = synthesize_batch(
        T(video), torch.Generator().manual_seed(1), SimConfig(), 5, 1,
        extra_frame=True, extra_evs=True, fixed_pos=T(pos), fixed_neg=T(neg))
    assert ev.shape == (2, 4, 32, 32, 5) and frame.shape == (2, 4, 32, 32, 1)
    assert float(ev.abs().sum()) > 0
    np.testing.assert_array_equal(ev.numpy(), np.asarray(jev))
    np.testing.assert_array_equal(frame.numpy(), np.asarray(jframe))
    batch = {"events": ev.numpy(), "frame": frame.numpy()}

    mod = _module("raft_large")
    params = jax_eraft()
    j = JFlowIface(mod)
    opt = JAdam(lr=LR, amsgrad=True).make()
    jnew, _, jloss, jaux = jsteps.make_train_step(j, opt, donate=False)(
        params, opt.init(params), jax.tree.map(jnp.asarray, batch),
        jax.random.PRNGKey(1))
    port = _port(mod)
    step = make_train_step(port, Adam(lr=LR, amsgrad=True).make(
        port.model.parameters()))
    loss, aux = step({k: T(v) for k, v in batch.items()})
    assert float(jloss) > 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(aux["l1_loss"].numpy(),
                               np.asarray(jaux["l1_loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(aux["grad_norm"]),
                               float(jaux["grad_norm"]), rtol=1e-3)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jnew))
    got = port.model.state_dict()
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=2 * LR + 1e-6, err_msg=name)
    for name in [k for k in got if "running" in k]:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_bfloat16_step_is_finite_and_close_to_jax():
    """compute_dtype bfloat16 on pre-voxelized events (4 voxels, 4 frames,
    a zero flow target would be trivial, so the stored flow is random):
    finite loss and gradients; the loss within 2e-2 of JAX's bf16 step
    (each package rounds its bf16 convs and correlation on its own) and
    the carry float32."""
    rng = np.random.RandomState(4)
    batch = {"events": _events(seed=5, h=32, w=32),
             "frame": rng.rand(2, 4, 32, 32, 1).astype(np.float32),
             "flow": rng.randn(2, 3, 32, 32, 2).astype(np.float32)}
    mod = _module("gt", "bfloat16")
    j = JFlowIface(mod)
    opt = JAdam(lr=LR, amsgrad=True).make()
    params = jax_eraft()
    _, _, jloss, _ = jsteps.make_train_step(j, opt, donate=False)(
        params, opt.init(params), jax.tree.map(jnp.asarray, batch),
        jax.random.PRNGKey(1))
    port = _port(mod)
    with torch.no_grad():
        _, carry = port.forward_sequence(
            T(batch["events"]), port.init_state(2, 32, 32), train=True)
    assert carry.dtype == torch.float32
    step = make_train_step(port, Adam(lr=LR, amsgrad=True).make(
        port.model.parameters()))
    loss, aux = step({k: T(v) for k, v in batch.items()})
    assert np.isfinite(float(loss)) and np.isfinite(float(aux["grad_norm"]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)


def test_flow_harness_alignment_matches_jax(tmp_path, monkeypatch,
                                           teachers):  # noqa: F811
    """The flow harness on ERAFT with 15 bins (test_eraft_original.yaml's):
    an EVAID-style h5 without flow (T+1 frames and T+1 voxels, scored
    against the teacher's T pseudo-GT flows) and an MVSEC-style one with
    stored flow and the extra frame and events, in windows that carry the
    warm start; T_in - 1 flows aligned with the last T_out events and GT.
    test_metrics.txt equal to JAX's within the flow tolerance of the
    EVFlowNet harness test."""
    variables = _jax_eraft_15()
    monkeypatch.setattr(JFlowIface, "init",
                        lambda s, key, b, h, w, nb=5: (variables, None))
    recon = make_hqf_h5(str(tmp_path / "ball.h5"), n_frames=7, h=20, w=36)
    flow = make_hqf_h5(str(tmp_path / "indoor_flying1.h5"), n_frames=7,
                       h=20, w=36, seed=1, with_flow=True)
    (tmp_path / "evaid.txt").write_text(recon + "\n")
    (tmp_path / "mvsec.txt").write_text(flow + "\n")
    cfg = load_yaml(TEST_YAML)
    cfg.pop("test_output_dir")
    cfg["module"]["loss"]["raft_num_flow_updates"] = ITERS
    cfg["module"]["model"]["params"]["iters"] = 2
    evaid, mvsec = cfg["test_stage"]["test"][0], cfg["test_stage"]["test"][3]
    evaid.update(data_file=str(tmp_path / "evaid.txt"), sequence_length=3,
                 use_native_voxel_builder=False)
    mvsec.update(data_file=str(tmp_path / "mvsec.txt"), sequence_length=4,
                 use_native_voxel_builder=False)
    cfg["test_stage"].update(test=[evaid, mvsec], test_num_workers=1)
    port = FlowModelInterface(cfg["module"], "cpu")
    port.model.load_state_dict(jax_params_to_state_dict(variables))
    tpath = str(tmp_path / "eraft.pth")
    torch.save({"state_dict": port.model.state_dict()}, tpath)

    want = jharness.run_single_test(None, copy.deepcopy(cfg),
                                    root=str(tmp_path / "jax"))
    got = flow_harness.run_single_test(tpath, copy.deepcopy(cfg),
                                       root=str(tmp_path / "port"),
                                       device="cpu")
    assert sorted(got) == sorted(want) and len(got) == 12
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-3,
                                   err_msg=k)
    assert got["EVAID/ball/dense_EPE"] > 0


@functools.lru_cache(maxsize=None)
def _jax_eraft_15():
    """JAX's random ERAFT with 15 input bins (test_eraft_original.yaml)."""
    x = jnp.zeros((1, 32, 32, 15))
    model = JERAFT(config={"subtype": "warm_start"}, n_first_channels=15,
                   iters=1)
    return jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(7), x, x, model.init_state(1, 32, 32)))


def test_chip_smoke_eraft_dicts_match_the_yamls():
    """chip_smoke.py carries the ERAFT configs as dicts (the card's
    machine has no PyYAML): they equal the YAMLs."""
    import chip_smoke
    cfg = load_yaml(TRAIN_YAML)
    assert chip_smoke.ERAFT_TRAIN_MODULE == cfg["module"]
    assert chip_smoke.ERAFT_TRAIN_STAGE == cfg["train_stages"][0]
    assert chip_smoke.ERAFT_TEST_CONFIG == load_yaml(TEST_YAML)


def test_chip_smoke_stand_ins_carry_the_extra_event_group(tmp_path):
    """chip_smoke's stand-ins for ERAFT's data: a clip has the extra
    num_bins leading frames (WebvidDataset's count with
    output_additional_evs), and the synthetic sequences have the h5
    readers' keys, dtypes and layout with T+1 frames and T+1 event groups
    (and T stored flows)."""
    import chip_smoke
    train_cfg = chip_smoke.ERAFT_TRAIN_STAGE["dataset"]["train"][0]
    clip = chip_smoke._DriftingClips(dict(train_cfg, crop_size=16), 0, 1)[0]
    assert clip["video"].shape == ((40 + 1) * 5 + 1, 16, 16)
    path = make_hqf_h5(str(tmp_path / "indoor_flying1.h5"), n_frames=6,
                       h=20, w=36, with_flow=True)
    evaid, _, _, mvsec = chip_smoke.ERAFT_TEST_CONFIG["test_stage"]["test"]
    for cfg, cls, flow in ((mvsec, th5.TestH5FlowDataset, True),
                           (evaid, th5.TestH5Dataset, False)):
        cfg = dict(cfg, sequence_length=3, use_native_voxel_builder=False)
        want = cls(path, cfg)[0]
        got = chip_smoke._SyntheticSequence("s", 0, 3, (20, 36), 100, cfg,
                                            flow=flow)[0]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert got["events"].shape == (4, 20, 36, 15)
        assert got["frame"].shape == (4, 20, 36, 1)


def _tiny_train_yaml(d, v, tmp_path):
    """configs/train_v2v_eraft_10k.yaml cut to size: 2 refinements,
    sequence_length 3, crop 32, batch 2, 2 epochs, the teacher at 2
    updates, val on an HQF-style and an MVSEC-style h5 at
    sequence_length 4 (both with the extra frame and events)."""
    cfg = load_yaml(TRAIN_YAML)
    cfg["experiment_name"] = "eraft_tiny"
    mod = cfg["module"]
    mod["model"]["params"]["iters"] = 2
    mod["loss"]["raft_num_flow_updates"] = ITERS
    stage = cfg["train_stages"][0]
    stage["max_epochs"] = 2
    ds = stage["dataset"]
    ds.update(train_batch_size=2, num_workers=2)
    ds["train"][0].update(
        data_file=str(d / "webvid_root.txt"),
        video_list_file=str(d / "videos.txt"), sequence_length=3,
        crop_size=32, max_samples_per_shot=4)
    for val, name in zip(ds["val"], ("hqf", "mvsec")):
        val.update(data_file=str(v / f"{name}.txt"), sequence_length=4,
                   use_native_voxel_builder=False)
    path = tmp_path / "eraft.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path, cfg


def test_cli_trains_and_scores_the_eraft_yamls(data, tmp_path,  # noqa: F811
                                               monkeypatch, capsys):
    """`cli train --device cpu` on the ERAFT train YAML cut to size (bf16,
    Adam with amsgrad, StepLR, the random RAFT-large teacher): finite train
    and val losses, lr 1e-4 each epoch, cnet's running statistics moved,
    two checkpoints; then `cli test_flow --device cpu` on the eval YAML
    (cut to a 15-bin EVAID-style h5 of 7 frames, windows of 3) scores the
    last checkpoint against the teacher's pseudo-GT. Without a card and
    without --device both raise."""
    v = tmp_path / "val"
    v.mkdir()
    (v / "hqf.txt").write_text(make_hqf_h5(str(v / "hqfseq.h5"), n_frames=7)
                               + "\n")
    (v / "mvsec.txt").write_text(make_hqf_h5(
        str(v / "indoor_flying1.h5"), n_frames=7, seed=1, with_flow=True)
        + "\n")
    path, cfg = _tiny_train_yaml(data, v, tmp_path)
    monkeypatch.setenv("V2V_RANDOM_TEACHER", "1")
    monkeypatch.setenv("V2V_WEIGHTS_DIR", str(tmp_path / "no_weights"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train", str(path)])
    runs = []
    main = train.main
    monkeypatch.setattr(train, "main",
                        lambda *a, **k: runs.append(main(*a, **k)))
    capsys.readouterr()
    with pytest.warns(UserWarning, match="RANDOM"):
        assert cli.main(["train", str(path), "--device", "cpu"]) == 0
    log = capsys.readouterr().out
    (out,) = runs
    for e in (0, 1):
        assert f"epoch {e}: lr=1.000e-04" in log
        assert out["losses"][e] and all(np.isfinite(out["losses"][e]))
    model = out["model"]
    assert model.cnet.norm1.num_batches_tracked > 0
    assert not torch.equal(model.cnet.norm1.running_var,
                           torch.ones_like(model.cnet.norm1.running_var))
    exp = cfg["experiment_name"]
    paths = checkpoint.all_ckpt_paths(exp, str(tmp_path))
    assert len(paths) == 2
    with open(os.path.join(tmp_path, "tensorboard_logs", exp,
                           "val_loss.txt")) as f:
        vals = [float(ln.rsplit(": ", 1)[1]) for ln in f if ln.strip()]
    assert len(vals) == 2 and all(np.isfinite(vals)) and vals[0] > 0

    test_cfg = load_yaml(TEST_YAML)
    test_cfg.update(save_png=False, save_npy=True)
    test_cfg["module"]["model"]["params"]["iters"] = 2
    test_cfg["module"]["loss"]["raft_num_flow_updates"] = ITERS
    evaid = test_cfg["test_stage"]["test"][0]
    (tmp_path / "evaid.txt").write_text(make_hqf_h5(
        str(tmp_path / "ball.h5"), n_frames=7, h=20, w=36) + "\n")
    evaid.update(data_file=str(tmp_path / "evaid.txt"), sequence_length=3,
                 use_native_voxel_builder=False)
    test_cfg["test_stage"].update(test=[evaid], test_num_workers=1)
    test_path = tmp_path / "eraft_test.yaml"
    test_path.write_text(yaml.safe_dump(test_cfg))
    # the eval config's 15-bin model, its weights from JAX's
    scored = str(tmp_path / "eraft_15.pth")
    torch.save({"state_dict": jax_params_to_state_dict(_jax_eraft_15())},
               scored)
    exp = test_cfg["experiment_name"]
    checkpoint.append_ckpt_path(exp, scored, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["test_flow", str(test_path)])
    assert cli.main(["test_flow", str(test_path), "--device", "cpu"]) == 0
    with open(os.path.join(tmp_path, "tensorboard_logs", exp,
                           "test_metrics.txt")) as f:
        metrics = dict(ln.rsplit(": ", 1) for ln in f if ln.strip())
    assert len(metrics) == 6 and all(np.isfinite(float(x))
                                     for x in metrics.values())
    npys = os.listdir(os.path.join(tmp_path, test_cfg["test_output_dir"],
                                   "EVAID", "ball"))
    assert len(npys) == 6     # 2 windows of 3 voxel pairs
