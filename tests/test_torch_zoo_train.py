"""The zoo's train and eval paths in the port (training/interface.py's
split, per-step and batched forwards, l2_weight and normalize_voxels;
the E2VID++ harness through `cli test_e2vid`) against the JAX package,
in float32 on weights carried from JAX."""
import copy
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

import v2v_tpu.training.interface as jiface_mod
from v2v_tpu.eval import harness as jharness
from v2v_tpu.training import checkpoint as jckpt
from v2v_tpu.training import steps as jsteps
from v2v_tpu.training.optim import Adam as JAdam

from v2v_tpu_torch import cli
from v2v_tpu_torch.losses.lpips import LPIPS
from v2v_tpu_torch.models.convert import jax_params_to_state_dict
from v2v_tpu_torch.training import checkpoint
from v2v_tpu_torch.training.interface import ModelInterface
from v2v_tpu_torch.training.optim import Adam
from v2v_tpu_torch.training.steps import make_train_step

import chip_smoke
from test_data import make_hqf_h5
from test_torch_losses import jax_lpips
from test_torch_zoo import SMALL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
LR = 1e-4
B, TT, H, W = 2, 4, 32, 32

# one module a forward path: FlowNet takes the split forward (with
# normalize_voxels), FireNet the per-step loop (no split entry points),
# FlowNetNoRecur one call over B*T (no state)
MODULES = {
    "flownet-split": {
        "loss": {"l1_weight": 1.0, "l2_weight": 0.5},
        "normalize_voxels": True,
        "model": {"target": "model.model.FlowNet",
                  "params": {"unet_kwargs": SMALL}}},
    "firenet-per-step": {
        "loss": {"l1_weight": 1.0, "l2_weight": 1.0},
        "model": {"target": "model.model.FireNet",
                  "params": {"base_num_channels": 8}}},
    "flownet-norecur-batched": {
        "loss": {"l1_weight": 0.5, "l2_weight": 1.0},
        "model": {"target": "model.model.FlowNetNoRecur",
                  "params": {"unet_kwargs": SMALL}}},
}


@functools.lru_cache(maxsize=None)
def _jax_params(case):
    j = jiface_mod.ModelInterface(MODULES[case])
    params = jax.jit(j.model.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((B, H, W, 5)),
                                   j.init_state(B, H, W))
    return j, jax.tree.map(np.array, params)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    events = (rng.randn(B, TT, H, W, 5) * 2).astype(np.float32)
    frame = rng.rand(B, TT, H, W, 1).astype(np.float32)
    return events, frame


@pytest.mark.parametrize("case", sorted(MODULES))
def test_train_step_matches_jax_make_train_step(case, monkeypatch):
    """JAX's make_train_step against the port's on the same weights and
    pre-voxelized batch (the simulators' streams differ by design): the
    loss and the gradient norm at 1e-5 relative, the per-sample L1 and
    L2 terms, the parameters after one amsgrad step within 2*lr (a
    near-zero gradient may flip sign), and the forward path the
    interface took."""
    j, params = _jax_params(case)
    events, frame = _batch()
    jstep = jsteps.make_train_step(
        j, JAdam(lr=LR, weight_decay=0, amsgrad=True).make(), donate=False)
    opt = JAdam(lr=LR, weight_decay=0, amsgrad=True).make()
    jnew, _, jloss, jaux = jstep(params, opt.init(params),
                                 {"events": jnp.asarray(events),
                                  "frame": jnp.asarray(frame)},
                                 jax.random.PRNGKey(0))

    port = ModelInterface(MODULES[case], device="cpu")
    port.model.load_state_dict(jax_params_to_state_dict(params))
    calls = []
    forward = type(port.model).forward

    def counted(self, *args, method="step"):
        calls.append((method, args[0].shape[0]))
        return forward(self, *args, method=method)

    monkeypatch.setattr(type(port.model), "forward", counted)
    step = make_train_step(port, Adam(lr=LR, amsgrad=True).make(
        port.model.parameters()))
    loss, aux = step({"events": T(events), "frame": T(frame)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["grad_norm"]),
                               float(jaux["grad_norm"]), rtol=1e-5)
    for k in ("l1_loss", "l2_loss"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jnew))
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=2 * LR, err_msg=name)
    want_calls = {"flownet-split": [("pre", B * TT)]
                  + [("spine_step", B)] * TT + [("tail", B * TT)],
                  "firenet-per-step": [("step", B)] * TT,
                  "flownet-norecur-batched": [("step", B * TT)]}[case]
    assert calls == want_calls


@pytest.mark.parametrize("target,unet", [
    ("model.model.FlowNet", dict(SMALL, recurrent_block_type="convgru")),
    ("model.model.WFlowNet", dict(SMALL, use_upsample_conv=False)),
    ("model.model.ColorE2VID", dict(SMALL, skip_type="concat"))])
def test_split_forward_equals_step_loop(target, unet):
    """Each recurrent variant's split forward (pre over B*T, the spine a
    step at a time, tail over B*T) equals the per-step loop: values,
    final state and gradients (float32; the batched convs sum in other
    orders)."""
    mod = {"loss": {"l1_weight": 1.0},
           "model": {"target": target, "params": {"unet_kwargs": unet}}}
    events = T(_batch(3)[0])
    runs = []
    for split in (True, False):
        port = ModelInterface(dict(mod, scan_split=split), device="cpu",
                              generator=torch.Generator().manual_seed(1))
        pred, st = port.forward_sequence(events, port.init_state(B, H, W),
                                         train=True)
        (pred ** 2).sum().backward()
        runs.append((pred.detach(), [s.detach() for s in
                                     jax.tree.leaves(st)],
                     [p.grad for p in port.model.parameters()]))
    (p1, s1, g1), (p2, s2, g2) = runs
    torch.testing.assert_close(p1, p2, atol=1e-5, rtol=0)
    for a, b in zip(s1, s2):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-3)


def test_running_statistics_models_step_per_time_step():
    """A model with BN or IN runs one step a time step in training (a
    batched forward would change its live statistics); normalize_voxels
    changes the prediction."""
    for norm in ("BN", "IN"):
        port = ModelInterface(
            {"loss": {"l1_weight": 1.0},
             "model": {"target": "model.model.FlowNet",
                       "params": {"unet_kwargs": dict(SMALL, norm=norm)}}},
            device="cpu")
        assert not port.scan_split
    events = T(_batch(4)[0])
    preds = []
    for normalize in (False, True):
        port = ModelInterface(dict(MODULES["flownet-split"],
                                   normalize_voxels=normalize), device="cpu")
        with torch.no_grad():
            preds.append(port.forward_sequence(
                events, port.init_state(B, H, W))[0])
    assert not torch.allclose(*preds)


def _grad_norm(module, dtype, seed):
    """chip_smoke's [zoo-reference] step of `module` (its tiny cut, B=2,
    T=4, 64x64, the random LPIPS-VGG trunk and RAFT-small teacher) on the
    CPU in `dtype`: the loss's gradient norm, before the optimizer."""
    from v2v_tpu_torch.ops.voxel import SimConfig
    from v2v_tpu_torch.training.raft import random_teacher
    from v2v_tpu_torch.training.steps import synthesize_batch
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(seed)
    video = chip_smoke._drifting_video(2, 21, 64, 64, seed, cpu)
    events, frame = synthesize_batch(video, g, SimConfig(), 5, 1)
    lp = LPIPS("vgg", cpu)
    lp.module.to(dtype)
    iface = ModelInterface(chip_smoke._tiny_module(2, module), cpu,
                           generator=torch.Generator().manual_seed(seed),
                           lpips=lp, teacher=random_teacher(12, cpu))
    iface.teacher_dtype = None
    iface.model.to(dtype)
    batch = iface.prepare_flow({"events": events.to(dtype),
                                "frame": frame.to(dtype)})
    pred, _ = iface.forward_sequence(batch["events"], iface.init_state(
        2, 64, 64, dtype), train=True)
    iface.calc_loss(pred, batch)[0].backward()
    return float(torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(p.grad.double())
        for p in iface.model.parameters()])))


@pytest.mark.filterwarnings("ignore:LPIPS")
def test_in_pred_step_is_float32_stable_without_temporal_consistency(capsys):
    """Why [zoo-reference]'s e2vid-in case drops the temporal-consistency
    term: IN on E2VID's pred makes each predicted frame mean 0, where
    |p1 - p0w| / (|p1| + |p0w| + 1e-5) amplifies float32 rounding. At
    seed 4 the CPU's float32 and float64 grad norms are printed with and
    without the term; without it they agree within the phase's 1e-3."""
    model, loss, _ = chip_smoke.ZOO_REFERENCE["e2vid-in"]
    rel = {}
    for tc in (1.0, 0.0):
        module = dict(chip_smoke.FLAGSHIP_MODULE, model=model, loss=dict(
            chip_smoke.FLAGSHIP_MODULE["loss"],
            temporal_consistency_weight=tc))
        g32, g64 = (_grad_norm(module, dt, 4)
                    for dt in (torch.float32, torch.float64))
        rel[tc] = abs(g32 - g64) / g64
    with capsys.disabled():
        print(f"\n[e2vid-in, seed 4] float32 vs float64 grad norm: "
              f"{rel[1.0]:.2e} with the temporal-consistency term, "
              f"{rel[0.0]:.2e} without")
    assert loss == {"temporal_consistency_weight": 0.0}
    assert rel[0.0] < 1e-3


def test_loss_config_takes_l2_and_rejects_ssim():
    from v2v_tpu_torch.training.interface import LossConfig
    assert LossConfig.from_dict({"l2_weight": 0.5}).l2_weight == 0.5
    with pytest.raises(ValueError, match="ssim_weight"):
        LossConfig.from_dict({"ssim_weight": 1.0})


def test_chip_smoke_zoo_configs():
    """[e2vidpp-eval]'s config is test_e2vid++_original.yaml; [zoo-train]
    swaps its models into the flagship module, FireNet at its published
    defaults; each builds at the parameter count the script holds it
    to."""
    with open(os.path.join(ROOT, "configs",
                           "test_e2vid++_original.yaml")) as f:
        assert chip_smoke.E2VIDPP_CONFIG == yaml.safe_load(f)
    for name, (module, n_params) in chip_smoke.ZOO_TRAIN.items():
        assert {k: v for k, v in module.items() if k != "model"} == {
            k: v for k, v in chip_smoke.FLAGSHIP_MODULE.items()
            if k != "model"}, name
        with torch.device("meta"):
            from v2v_tpu_torch.config import instantiate_from_config
            m = instantiate_from_config(module["model"])
        assert sum(p.numel() for p in m.parameters()) == n_params, name
    assert chip_smoke.ZOO_TRAIN["firenet"][0]["model"]["params"] == {}


@pytest.mark.filterwarnings("ignore:LPIPS")
def test_e2vidpp_harness_matches_jax_through_the_cli(tmp_path, monkeypatch):
    """test_e2vid++_original.yaml's harness at SMALL widths on two
    EVAID-named synthetic h5 sequences of 8 frames at 40x56 in windows of
    4 (state carried within a sequence, reset between them), the same
    weights and LPIPS-Alex trunk: JAX's harness `main` against
    `python -m v2v_tpu_torch.cli test_e2vid <yaml> --device cpu`, which
    builds FlowNet through TARGET_ALIASES. Per-sequence MSE/SSIM/LPIPS
    and the CSV row agree (predictions to ~1e-6; LPIPS sums 5 float32
    trunk layers, 1e-4)."""
    with open(os.path.join(ROOT, "configs",
                           "test_e2vid++_original.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.pop("test_output_dir")
    cfg["module"]["model"]["params"]["unet_kwargs"] = dict(
        cfg["module"]["model"]["params"]["unet_kwargs"],
        base_num_channels=8, num_residual_blocks=1)
    names = [make_hqf_h5(str(tmp_path / f"{n}.h5"), n_frames=9, h=40, w=56,
                         events_per_frame=300, seed=i)
             for i, n in enumerate(("ball", "bear"))]
    h5_list = str(tmp_path / "evaid_test.txt")
    with open(h5_list, "w") as f:
        f.write("\n".join(names) + "\n")
    cfg["test_stage"]["test_num_workers"] = 2
    cfg["test_stage"]["test"] = [dict(
        cfg["test_stage"]["test"][0], data_file=h5_list, sequence_length=4,
        use_native_voxel_builder=False)]
    exp = cfg["experiment_name"]

    j = jiface_mod.ModelInterface({"model": cfg["module"]["model"]})
    params = jax.tree.map(np.array, jax.jit(j.model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 48, 64, 5)),
        j.init_state(1, 48, 64)))
    jl = jax_lpips("alex")
    tl = LPIPS("alex", device="cpu")
    tl.module.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, jl.params)))
    for name in ("lpips_test", "lpips_train"):
        monkeypatch.setattr(jiface_mod.ModelInterface, name,
                            property(lambda s: jl))
    monkeypatch.setattr(jiface_mod.ModelInterface, "init",
                        lambda s, key, b, h, w, nb=5: (params, None))
    monkeypatch.setattr(ModelInterface, "lpips_test", property(lambda s: tl))

    root_j, root_t = tmp_path / "jax", tmp_path / "port"
    jpath = str(root_j / "ckpt" / "e2vidpp.msgpack")
    jckpt.save_checkpoint(jpath, params, None, 0)
    jckpt.append_ckpt_path(exp, jpath, str(root_j))
    os.makedirs(root_t / "ckpt")
    tpath = str(root_t / "ckpt" / "e2vidpp.pth")
    torch.save({"state_dict": jax_params_to_state_dict(params)}, tpath)
    checkpoint.append_ckpt_path(exp, tpath, str(root_t))
    yaml_path = root_t / "e2vidpp.yaml"
    yaml_path.write_text(yaml.safe_dump(cfg))

    jharness.main(copy.deepcopy(cfg), root=str(root_j))
    monkeypatch.chdir(root_t)
    assert cli.main(["test_e2vid", str(yaml_path), "--device", "cpu"]) == 0

    logs = lambda r: os.path.join(r, "tensorboard_logs", exp)
    read = lambda r: {k: float(v) for k, v in (
        ln.rsplit(": ", 1) for ln in open(os.path.join(
            logs(r), "test_metrics.txt")) if ln.strip())}
    want, got = read(str(root_j)), read(str(root_t))
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    rows = [open(os.path.join(logs(str(r)), "all_test_results_new.csv"))
            .read().splitlines()[1].split(",") for r in (root_j, root_t)]
    assert rows[1][0] == "e2vidpp.pth"
    filled = [i for i, v in enumerate(rows[0][1:], 1) if v]
    assert len(filled) == 6
    np.testing.assert_allclose([float(rows[1][i]) for i in filled],
                               [float(rows[0][i]) for i in filled],
                               rtol=1e-4, atol=1e-6)
