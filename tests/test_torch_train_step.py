"""The whole slice — the flagship loss (L1 + LPIPS-VGG + temporal
consistency with the RAFT-small teacher) over the tiny E2VID, backward
and an amsgrad step — in the port against the JAX package, plus the
port's entry-point and import contracts."""
import functools
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import v2v_tpu.training.interface as jiface_mod
from v2v_tpu.training import raft as jraft
from v2v_tpu.training.optim import Adam as JAdam

from v2v_tpu_torch import resolve_device
from v2v_tpu_torch.losses.lpips import LPIPS
from v2v_tpu_torch.models.convert import jax_params_to_state_dict
from v2v_tpu_torch.ops import voxel_cuda as vc
from v2v_tpu_torch.ops.voxel import SimConfig
from v2v_tpu_torch.training.interface import ModelInterface
from v2v_tpu_torch.training.optim import Adam
from v2v_tpu_torch.training.raft import random_teacher
from v2v_tpu_torch.training.steps import make_train_step

import chip_smoke
from subproc_env import cpu_env
from test_torch_losses import jax_lpips, jax_raft_small

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
B, T, H, W = 2, 4, 32, 32
ITERS = 4      # teacher refinements, cut from 12 (held at 12 in
               # test_torch_losses.py)


def _module(compute_dtype=None):
    """The flagship module config with the tiny E2VID, L0 cut from 20 to
    2 to fit T=4 and ITERS teacher refinements."""
    loss = dict(chip_smoke.FLAGSHIP_MODULE["loss"],
                temporal_consistency_L0=2, raft_num_flow_updates=ITERS)
    unet = dict(chip_smoke.FLAGSHIP_MODULE["model"]["params"]["unet_kwargs"],
                base_num_channels=4, num_residual_blocks=1)
    cfg = {"loss": loss, "model": {"target": "model.model.E2VIDRecurrent",
                                   "params": {"unet_kwargs": unet}}}
    if compute_dtype:
        cfg["compute_dtype"] = compute_dtype
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_parts():
    """JAX LPIPS (random trunk), RAFT-small teacher params and E2VID
    params, built once (flax's eager inits are slow on the CPU)."""
    lp = jax_lpips()
    teacher = jax_raft_small(ITERS)
    j = jiface_mod.ModelInterface.__new__(jiface_mod.ModelInterface)
    jiface_mod.ModelInterface.__init__(j, {"model": _module()["model"]})
    params = jax.jit(j.model.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((B, H, W, 5)),
                                   j.init_state(B, H, W))
    params = jax.tree.map(np.array, params)
    # predictions away from 0: the TC loss's clamp at 0 and |p| have
    # kinks there, where float32 noise would pick different subgradients
    params["params"]["unetrecurrent"]["pred"]["conv2d"]["bias"] += 1.0
    return lp, teacher, params


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    events = rng.randn(B, T, H, W, 5).astype(np.float32)
    base = rng.rand(B, 1, H, W, 1)
    frame = np.clip(base + 0.05 * np.cumsum(rng.randn(B, T, H, W, 1), 1),
                    0, 1).astype(np.float32)
    return events, frame


def _setup(monkeypatch, compute_dtype=None):
    lp, teacher, params = _jax_parts()
    monkeypatch.setattr(jiface_mod, "LPIPS", lambda net: lp)
    monkeypatch.setitem(jraft._cache, ("raft_small", ITERS), teacher)
    # the JAX teacher runs in float32 here, like the port's below
    orig = jraft.raft_flow

    def f32_flow(source, frames, l0, num_flow_updates):
        return jax.jit(lambda f: orig(source, f, l0, num_flow_updates,
                                      compute_dtype=None))(frames)

    monkeypatch.setattr(jraft, "raft_flow", f32_flow)
    j = jiface_mod.ModelInterface(_module(compute_dtype))
    tl = LPIPS("vgg", device="cpu")
    tl.module.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, lp.params)))
    tt = random_teacher(ITERS, "cpu")
    tt.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, teacher[1])))
    port = ModelInterface(_module(compute_dtype), device="cpu", lpips=tl,
                          teacher=tt)
    port.teacher_dtype = None
    port.model.load_state_dict(jax_params_to_state_dict(params))
    return j, params, port


@pytest.mark.filterwarnings("ignore:LPIPS")
def test_slice_step_matches_jax_float32(monkeypatch):
    """Pre-voxelized batch contract (the simulators' RNG streams differ by
    design). First-step loss rtol 1e-4; gradients rtol 1e-3 / atol 1e-6
    (float32, summation orders differ); params after one amsgrad step
    within 2*lr (Adam's first step moves each weight by ~lr*sign(g), so
    a near-zero gradient may flip sign between the packages)."""
    j, params, port = _setup(monkeypatch)
    events, frame = _batch()
    jbatch = j.prepare_flow({"events": jnp.asarray(events),
                             "frame": jnp.asarray(frame)})

    def loss_fn(p):
        pred, _ = j.forward_sequence(p, jbatch["events"],
                                     j.init_state(B, H, W), train=True)
        return j.calc_loss(pred, jbatch)

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    opt = JAdam(lr=LR, weight_decay=0, amsgrad=True).make()
    updates, _ = opt.update(jgrads, opt.init(params), params)
    jnew = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)

    opt_t = Adam(lr=LR, weight_decay=0, amsgrad=True).make(
        port.model.parameters())
    step = make_train_step(port, opt_t)
    tbatch = {"events": torch.from_numpy(events),
              "frame": torch.from_numpy(frame)}
    flow = port.prepare_flow(tbatch)["flow"]
    np.testing.assert_allclose(flow.numpy(), np.asarray(jbatch["flow"]),
                               atol=1e-3, rtol=1e-3)
    loss, aux = step(tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for k in ("l1_loss", "perceptual_loss", "temporal_consistency_loss"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    want_g = jax_params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=name)
    want_p = jax_params_to_state_dict(jnew)
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   rtol=0, atol=2 * LR, err_msg=name)


@pytest.mark.filterwarnings("ignore:LPIPS")
def test_slice_loss_matches_jax_bfloat16(monkeypatch):
    """compute_dtype bfloat16 (bf16 E2VID and LPIPS, f32 master params and
    loss): the first-step loss within 2% — bf16 keeps ~3 significant
    digits and the two frameworks round at different places."""
    j, params, port = _setup(monkeypatch, "bfloat16")
    events, frame = _batch(1)
    jbatch = j.prepare_flow({"events": jnp.asarray(events),
                             "frame": jnp.asarray(frame)})

    @jax.jit
    def jloss(p):
        pred, _ = j.forward_sequence(p, jbatch["events"],
                                     j.init_state(B, H, W), train=True)
        return j.calc_loss(pred, jbatch)[0]

    opt_t = Adam(lr=LR, amsgrad=True).make(port.model.parameters())
    loss, aux = make_train_step(port, opt_t)(
        {"events": torch.from_numpy(events), "frame": torch.from_numpy(frame)})
    np.testing.assert_allclose(float(loss), float(jloss(params)), rtol=2e-2)
    assert all(p.dtype == torch.float32 for p in port.model.parameters())
    assert torch.isfinite(aux["grad_norm"])


@pytest.mark.filterwarnings("ignore:LPIPS")
def test_simulator_step_on_cpu_runs_plain_path():
    """The raw-video contract end to end on the CPU: finite loss over two
    steps, per-sample terms, and no kernel launch counted (CPU tensors
    take the plain versions)."""
    cfg = _module()
    cfg["loss"] = dict(cfg["loss"], temporal_consistency_L0=1)
    port = ModelInterface(cfg, device="cpu",
                          teacher=random_teacher(12, "cpu"))
    step = make_train_step(port, Adam(lr=LR, amsgrad=True).make(
        port.model.parameters()), SimConfig())
    before = vc.simulate_batch.launches
    g = torch.Generator().manual_seed(0)
    video = torch.randint(0, 256, (2, 2 * 5 + 1, 16, 16), dtype=torch.uint8,
                          generator=g)
    for _ in range(2):
        loss, aux = step({"video": video}, g)
        assert torch.isfinite(loss) and aux["l1_loss"].shape == (2,)
    assert vc.simulate_batch.launches == before


def test_chip_smoke_flagship_dict_matches_yaml():
    import yaml
    from v2v_tpu_torch.config import load_yaml
    path = os.path.join(ROOT, "configs", "train_v2v_e2vid_10k.yaml")
    with open(path) as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.FLAGSHIP_MODULE == cfg["module"]
    assert chip_smoke.FLAGSHIP_STAGE == cfg["train_stages"][0]
    assert load_yaml(path)["module"] == cfg["module"]


def test_entry_points_need_cuda_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _module()
    cfg["loss"] = {"l1_weight": 1.0}
    for call in (lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: ModelInterface(cfg),
                 lambda: LPIPS("vgg"),
                 lambda: random_teacher(),
                 lambda: vc.sample_gaussian(0, (4, 4))):
        with pytest.raises(RuntimeError):
            call()
    assert ModelInterface(cfg, device="cpu").device.type == "cpu"
    assert vc.sample_gaussian(0, (4, 4), device="cpu").shape == (4, 4)


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port, and chip_smoke.py, import without JAX or
    the JAX package, and without msgpack, cv2, PyYAML, h5py or
    tensorboardX at module level: the card's machine has none of them."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import v2v_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(v2v_tpu_torch.__path__, "
        "'v2v_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'v2v_tpu', 'cv2', "
        "'yaml', "
        "'h5py', 'tensorboardX')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=cpu_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
