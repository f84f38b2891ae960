"""The port's train driver (training/train.py::main, cli.py train)
against the JAX package's `main` on a tiny config: losses and params
after two resumed epochs, the ckpt_paths and val_loss.txt protocol, kill +
resume bit for bit, the stage skip on resume, HyperE2VID's per-stage
hyper_beta, the finite guard, and the card by default."""
import copy
import math
import os

import jax
import numpy as np
import pytest
import torch
import yaml

import v2v_tpu.ops.voxel as jvoxel
import v2v_tpu.training.train as jtrain
from v2v_tpu.training.checkpoint import append_ckpt_path as jappend
from v2v_tpu.training.checkpoint import save_checkpoint as jsave
from v2v_tpu.training.interface import ModelInterface as JIface
from v2v_tpu.training.optim import Adam as JAdam

from v2v_tpu_torch import cli
from v2v_tpu_torch.models.convert import jax_params_to_state_dict
from v2v_tpu_torch.ops import voxel_cuda as vc
from v2v_tpu_torch.training import train
from v2v_tpu_torch.training.checkpoint import (all_ckpt_paths,
                                               append_ckpt_path,
                                               load_params_only,
                                               save_checkpoint)
from v2v_tpu_torch.training.interface import ModelInterface
from v2v_tpu_torch.training.optim import Adam, StepLR
from v2v_tpu_torch.utils import timers

import chip_smoke
from test_data import _write_video, make_hqf_h5

EXP = "driver"
BATCHES = 2


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 64-frame 80x100 mp4 (4 samples of 16 frames, so 2 batches of 2)
    listed with fixed thresholds 0.25 / 0.5, whose multiples are exact in
    float32, and a 7-frame HQF-style h5 val set."""
    d = tmp_path_factory.mktemp("driver_data")
    (d / "webvid").mkdir()
    n = _write_video(str(d / "webvid" / "v0.mp4"))
    (d / "videos.txt").write_text(f"v0.mp4 {n} 0.25 0.5\n")
    (d / "webvid_root.txt").write_text(str(d / "webvid") + "\n")
    h5 = make_hqf_h5(str(d / "testseq.h5"), n_frames=7)
    (d / "val.txt").write_text(h5 + "\n")
    return d


TINY_MODEL = {"target": "model.model.E2VIDRecurrent",
              "params": {"unet_kwargs": {
                  "num_bins": 5, "skip_type": "sum",
                  "recurrent_block_type": "convlstm", "num_encoders": 3,
                  "base_num_channels": 4, "num_residual_blocks": 1,
                  "use_upsample_conv": True, "final_activation": "",
                  "norm": "none"}}}


def _config(d, epochs=3, noise=False):
    """tests/test_end_to_end.py::make_config's tiny E2VID (width 4, 1
    residual block, crop 32, sequence_length 3, batch 2) with L1 only,
    float32, Adam without amsgrad (torch and optax part after the first
    amsgrad step by design), fixed per-video thresholds and fixed_seed.
    Noise-free unless `noise`."""
    zero = [0, 0]
    return {
        "experiment_name": EXP, "seed": 3, "check_val_every_n_epoch": 1,
        "module": {
            "loss": {"l1_weight": 1.0}, "normalize_voxels": False,
            "model": copy.deepcopy(TINY_MODEL)},
        "train_stages": [{
            "stage_name": "stage1", "max_epochs": epochs,
            "optimizer": {"target": "torch.optim.Adam",
                          "params": {"lr": 0.001, "amsgrad": False}},
            "lr_scheduler": {"target": "torch.optim.lr_scheduler.StepLR",
                             "params": {"step_size": 2, "gamma": 0.5}},
            "dataset": {
                "train_batch_size": 2, "num_workers": 2, "val_batch_size": 1,
                "train": [{
                    "data_file": str(d / "webvid_root.txt"),
                    "class_name": "data.v2v_datasets.WebvidDatasetV2",
                    "video_list_file": str(d / "videos.txt"),
                    "data_source_name": "webvid", "sequence_length": 3,
                    "crop_size": 32, "num_bins": 5, "min_resize_scale": 1,
                    "max_resize_scale": 1, "max_samples_per_shot": 4,
                    "fixed_seed": 11, "use_fixed_thresholds": True,
                    "threshold_range": [0.05, 2],
                    "base_noise_std_range": [0, 0.1] if noise else zero,
                    "hot_pixel_fraction_range": [0, 0.01] if noise else zero,
                    "hot_pixel_std_range": [0, 10] if noise else zero}],
                "val": [{
                    "data_file": str(d / "val.txt"),
                    "class_name": "data.testh5.TestH5Dataset",
                    "dataset_name": "hqf", "num_bins": 5,
                    "sequence_length": 6, "image_range": 1}],
            },
        }],
    }


def _lines(path):
    with open(path) as f:
        return [ln for ln in f if ln.strip()]


def _val_losses(root):
    return [float(ln.rsplit(": ", 1)[1]) for ln in _lines(
        os.path.join(root, "tensorboard_logs", EXP, "val_loss.txt"))]


def test_driver_matches_jax_main(data, tmp_path, monkeypatch):
    """Both drivers resume from one epoch-0 checkpoint of the same
    weights (JAX's msgpack, the port's .pth through
    jax_params_to_state_dict) and run 2 epochs of 2 batches on the same
    items (fixed_seed) with noise-free simulators: every step's
    loss at rtol 1e-4, the final params at rtol 1e-3 / atol 1e-6 (float32,
    summation orders differ), the val losses at rtol 1e-4, and the same
    ckpt_paths and val_loss.txt lines."""
    cfg = _config(data)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    params, _ = JIface(cfg["module"]).init(jax.random.PRNGKey(0), 2, 32, 32)
    params = jax.tree.map(np.asarray, params)
    opt = JAdam(lr=0.001, amsgrad=False).make()
    jpath = os.path.join(jroot, "init", "epoch_0000.msgpack")
    jsave(jpath, params, opt.init(params), 0)
    jappend(EXP, jpath, jroot)
    port = ModelInterface(cfg["module"], device="cpu")
    port.model.load_state_dict(jax_params_to_state_dict(params))
    tpath = os.path.join(troot, "init", "epoch_0000.pth")
    save_checkpoint(tpath, port.model, Adam(lr=0.001).make(
        port.model.parameters()), 0, StepLR(2, 0.5))
    append_ckpt_path(EXP, tpath, troot)

    # noise-free simulators: the initial potential at zero, as the two
    # frameworks draw it from different streams
    jsim = jvoxel.esim_video_to_voxel
    monkeypatch.setattr(jvoxel, "esim_video_to_voxel",
                        lambda video, params, **k: jsim(video, params))
    tsim = vc.simulate_batch
    monkeypatch.setattr(vc, "simulate_batch", lambda video, seeds, params:
                        tsim(video, seeds, params, noise_free=True))

    jlosses = []
    make = jtrain.make_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(*args):
            res = step(*args)
            jlosses.append(float(res[2]))
            return res
        return run

    monkeypatch.setattr(jtrain, "make_train_step", recording)
    jout = jtrain.main(copy.deepcopy(cfg), max_batches_per_epoch=BATCHES,
                       root=jroot)
    tout = train.main(copy.deepcopy(cfg), BATCHES, troot, device="cpu")

    assert jout["epoch"] == tout["epoch"] == 3
    assert sorted(tout["losses"]) == [1, 2]
    got = [x for e in (1, 2) for x in tout["losses"][e]]
    assert len(got) == len(jlosses) == 2 * BATCHES
    np.testing.assert_allclose(got, jlosses, rtol=1e-4)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray,
                                                 jout["params"]))
    for name, p in tout["model"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(_val_losses(troot), _val_losses(jroot),
                               rtol=1e-4)
    jp, tp = all_ckpt_paths(EXP, jroot), all_ckpt_paths(EXP, troot)
    assert len(tp) == len(jp) == 3
    assert tp[-1].endswith("epoch_0002.pth")
    assert len(_val_losses(troot)) == len(_val_losses(jroot)) == 2


def _state(out):
    """(params, Adam state) of a run's result, on the host."""
    opt = out["optimizer"].state_dict()
    return ({k: v.clone() for k, v in out["model"].state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()}
             for i, s in opt["state"].items()})


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], dict):
                _assert_same((x[k],), (y[k],))
            else:
                assert torch.equal(x[k], y[k]), k


def test_kill_and_resume_equals_an_unbroken_run(data, tmp_path, capsys):
    """With noise on: 2 epochs, then a resumed third, equal an unbroken 3
    epochs bit for bit in the params and the Adam state; the resumed
    run starts at epoch 2 from epoch_0001.pth with the Adam state."""
    unbroken = train.main(_config(data, 3, noise=True), BATCHES,
                          str(tmp_path / "a"), device="cpu")
    root = str(tmp_path / "b")
    first = train.main(_config(data, 2, noise=True), BATCHES, root,
                       device="cpu")
    assert first["epoch"] == 2
    capsys.readouterr()
    resumed = train.main(_config(data, 3, noise=True), BATCHES, root,
                         device="cpu")
    log = capsys.readouterr().out
    assert "epoch_0001.pth at epoch 2" in log
    assert "Restored the optimizer state" in log
    assert "epoch 0:" not in log and "epoch 1:" not in log
    assert sorted(resumed["losses"]) == [2]
    assert resumed["losses"][2] == unbroken["losses"][2]
    _assert_same(_state(resumed), _state(unbroken))
    assert {int(s["step"]) for s in resumed["optimizer"].state.values()} \
        == {3 * BATCHES}
    # load_params_only reads the driver's checkpoints
    fresh = ModelInterface({"model": TINY_MODEL}, device="cpu",
                           generator=torch.Generator().manual_seed(99))
    load_params_only(all_ckpt_paths(EXP, root)[-1], fresh.model)
    _assert_same((fresh.model.state_dict(),),
                 (resumed["model"].state_dict(),))
    assert len(_val_losses(root)) == 3


def test_the_trace_key_times_the_driver_and_logs_the_snapshot(
        data, tmp_path, monkeypatch):
    """`trace: true`: the loader wait and the checkpoint are spans, the
    timings are filled as with the tracer off, and every 50 steps (here
    each epoch's first) the snapshot of the steps since the last one goes
    to TensorBoard under perf/; the tracer is off after."""
    scalars, snaps = [], []
    snapshot = timers.snapshot

    def spy():
        snaps.append(snapshot())
        return snaps[-1]

    class Writer:
        enabled = False

        def __init__(self, *a, **k):
            pass

        def add_scalar(self, tag, value, step):
            scalars.append((tag, value))

        def close(self):
            pass

    monkeypatch.setattr(train, "_Writer", Writer)
    monkeypatch.setattr(timers, "snapshot", spy)
    cfg = dict(_config(data, 3), trace=True)
    out = train.main(cfg, BATCHES, str(tmp_path), device="cpu")
    timings = out["timings"]
    assert len(timings["loader_wait_ms"]) == 3 * BATCHES
    assert len(timings["checkpoint_s"]) == 3
    assert all(x >= 0 for k in ("loader_wait_ms", "checkpoint_s")
               for x in timings[k])
    # a step closes at the next one's begin mark: the first snapshot has
    # none, each later one the epoch before's two, not every step so far
    assert [s["steps"] for s in snaps] == [0, BATCHES, BATCHES]
    assert snaps[-1]["spans"]["v2v.checkpoint"]["count"] == 1
    perf = {tag for tag, _ in scalars if tag.startswith("perf/")}
    assert {"perf/synthesize_stream_ms", "perf/forward_stream_ms",
            "perf/backward_stream_ms", "perf/step_stream_ms",
            "perf/launch_lead_ms", "perf/tracer_us", "perf/loader_wait_ms",
            "perf/checkpoint_stream_ms"} <= perf
    assert snapshot() is None


def _steps(monkeypatch):
    """Record each train step's epoch-relative hyper_beta through the
    driver's make_train_step."""
    calls = []
    make = train.make_train_step

    def recording(iface, optimizer, *a, **k):
        step = make(iface, optimizer, *a, **k)

        def run(batch, generator, hyper_beta):
            calls.append((hyper_beta, optimizer))
            return step(batch, generator, hyper_beta)
        return run

    monkeypatch.setattr(train, "make_train_step", recording)
    return calls


def _two_stages(d, epochs=(1, 1)):
    cfg = _config(d, epochs[0])
    second = copy.deepcopy(cfg["train_stages"][0])
    second.update(stage_name="stage2", max_epochs=epochs[1])
    second["optimizer"]["params"]["lr"] = 0.0005
    cfg["train_stages"].append(second)
    return cfg


def test_resume_in_stage_two_skips_stage_one(data, tmp_path, monkeypatch,
                                             capsys):
    root = str(tmp_path)
    cfg = _two_stages(data)
    out = train.main(cfg, 1, root, device="cpu")
    assert out["epoch"] == 2 and len(all_ckpt_paths(EXP, root)) == 2
    calls = _steps(monkeypatch)
    capsys.readouterr()
    out = train.main(_two_stages(data, (1, 2)), 1, root, device="cpu")
    log = capsys.readouterr().out
    assert out["epoch"] == 3 and sorted(out["losses"]) == [2]
    assert "Stage 0" not in log and "Stage 1, epoch 2: lr=5.000e-04" in log
    assert "Restored the optimizer state" in log
    assert len(calls) == 1
    assert all_ckpt_paths(EXP, root)[-1].endswith("epoch_0002.pth")


HYPER_UNET = dict(chip_smoke.HYPER_UNET, base_num_channels=4,
                  num_residual_blocks=1)


def test_hyper_beta_follows_the_stage_epoch(monkeypatch, tmp_path):
    """A tiny HyperE2VID with hyper_epochs 2 over two stages of 2 epochs:
    each step gets max(0, 1 - epoch / hyper_epochs) of its stage's own
    epoch, as the JAX driver passes it (train.py:321-323)."""
    cfg = _two_stages(tmp_path, (2, 2))
    cfg["module"] = {"loss": {"l1_weight": 1.0}, "hyper_epochs": 2,
                     "model": {"target": "model.hyper_model.HyperE2VID",
                               "params": {"unet_kwargs": HYPER_UNET}}}
    clips = chip_smoke._DriftingClips(
        dict(cfg["train_stages"][0]["dataset"]["train"][0],
             sequence_length=2), 0, 2)
    calls = _steps(monkeypatch)
    out = train.main(cfg, 1, str(tmp_path), device="cpu",
                     train_dataset=clips, val_dataset=[])
    assert [b for b, _ in calls] == [1.0, 0.5, 1.0, 0.5]
    assert all(math.isfinite(v[0]) for v in out["losses"].values())
    bn = [k for k in out["model"].state_dict() if "running_mean" in k]
    assert bn and all(k in torch.load(all_ckpt_paths(
        EXP, str(tmp_path))[-1])["state_dict"] for k in bn)


def test_non_finite_loss_raises(data, tmp_path, monkeypatch):
    make = train.make_train_step

    def nan_step(*a, **k):
        step = make(*a, **k)

        def run(*args):
            loss, aux = step(*args)
            return loss * float("nan"), aux
        return run

    monkeypatch.setattr(train, "make_train_step", nan_step)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        train.main(_config(data, 1), 1, str(tmp_path), device="cpu")


def test_the_card_by_default(data, tmp_path, monkeypatch):
    """main(cfg) and `cli train` raise without CUDA unless the CPU is
    asked for; `cli train --device cpu` runs the stage loop from YAML,
    and `profile_steps` writes a trace into the log dir."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(data, 1)
    cfg["profile_steps"] = [0, 1]
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(RuntimeError):
        train.main(cfg, 1, str(tmp_path))
    with pytest.raises(RuntimeError):
        cli.main(["train", str(path)])
    monkeypatch.chdir(tmp_path)
    before = vc.simulate_batch.launches
    assert cli.main(["train", str(path), "--device", "cpu"]) == 0
    assert vc.simulate_batch.launches == before      # CPU: plain versions
    paths = all_ckpt_paths(EXP, str(tmp_path))
    assert len(paths) == 1 and os.path.exists(paths[0])
    log_dir = tmp_path / "tensorboard_logs" / EXP
    assert any(p.name.startswith("trace_epoch0000") for p in log_dir.iterdir())
    assert cli.main(["nope"]) == 2


def test_remove_flow_loss_matches_jax():
    """Validation's calc_loss(..., remove_flow_loss=True) drops the
    temporal-consistency term, as JAX's does; without it the term is
    there."""
    cfg = {"loss": {"l1_weight": 1.0, "temporal_consistency_weight": 1.0,
                    "optical_flow_source": "gt",
                    "temporal_consistency_L0": 1}, "model": TINY_MODEL}
    rng = np.random.RandomState(0)
    pred = rng.rand(2, 3, 16, 16, 1).astype(np.float32)
    batch = {"frame": rng.rand(2, 3, 16, 16, 1).astype(np.float32),
             "flow": rng.randn(2, 3, 16, 16, 2).astype(np.float32)}
    j, t = JIface(cfg), ModelInterface(cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for remove in (True, False):
        jl, jaux = j.calc_loss(pred, batch, remove_flow_loss=remove)
        tl, taux = t.calc_loss(torch.from_numpy(pred), tb,
                               remove_flow_loss=remove)
        assert sorted(taux) == sorted(jaux)
        assert ("temporal_consistency_loss" in taux) is not remove
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_preview_matches_jax():
    from v2v_tpu.ops.normalize import normalize_nobias as jnorm
    from v2v_tpu.training.preview import make_preview as jpreview
    from v2v_tpu_torch.ops.normalize import normalize_nobias
    from v2v_tpu_torch.training.preview import make_preview
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 20, 24) * 3).astype(np.float32)
    np.testing.assert_allclose(normalize_nobias(x), np.asarray(jnorm(x)),
                               rtol=1e-6, atol=1e-7)
    batch = {"events": rng.randn(2, 4, 8, 10, 5).astype(np.float32),
             "frame": rng.rand(2, 4, 8, 10, 1).astype(np.float32)}
    pred = rng.rand(2, 4, 8, 10, 1).astype(np.float32)
    got = make_preview(batch, pred)
    assert got.shape == (2, 4, 3, 8, 30) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jpreview(batch, pred))


def test_optimizer_state_loads_only_where_it_fits(tmp_path):
    """A saved Adam state goes into an optimizer of the same layout and
    keeps that optimizer's options (the new stage's lr and betas); into
    another layout (amsgrad, or other parameters) it is not loaded."""
    from v2v_tpu_torch.training.checkpoint import (load_checkpoint,
                                                   load_optimizer_state)
    iface = ModelInterface({"model": TINY_MODEL}, device="cpu")
    params = list(iface.model.parameters())
    opt = Adam(lr=0.01).make(params)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    path = str(tmp_path / "c.pth")
    save_checkpoint(path, iface.model, opt, 4, StepLR(2))
    saved = load_checkpoint(path, iface.model)
    assert saved["epoch"] == 4 and saved["lr_scheduler"] == {}
    new = Adam(lr=0.5, betas=(0.8, 0.9)).make(params)
    assert load_optimizer_state(new, saved["optimizer"])
    assert new.param_groups[0]["lr"] == 0.5
    assert new.param_groups[0]["betas"] == (0.8, 0.9)
    assert torch.equal(new.state[params[0]]["exp_avg"],
                       opt.state[params[0]]["exp_avg"])
    for other in (Adam(lr=0.5, amsgrad=True).make(params),
                  Adam(lr=0.5).make(params[1:])):
        assert not load_optimizer_state(other, saved["optimizer"])
        assert not other.state
