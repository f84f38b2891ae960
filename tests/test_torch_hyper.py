"""The port's HyperE2VID slice (v2v_tpu_torch ops/dynconv.py,
models/hyper.py, TorchBatchNorm, the curriculum in the task interface
and the train step, the converter's BatchNorm and dynamic-conv rules)
against the JAX package, in float32 on weights carried from JAX. On the
CPU the shift-sum runs its plain version; the CUDA kernel K4 is held
against that on the card (the `cuda` test below, and chip_smoke.py)."""
import copy
import functools
import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

import v2v_tpu.models.hyper as jhyper
import v2v_tpu.training.interface as jiface_mod
from v2v_tpu.eval import harness as jharness
from v2v_tpu.models.convert import torch_state_dict_to_flax
from v2v_tpu.models.submodules import TorchBatchNorm as JBatchNorm
from v2v_tpu.ops.dynconv import dynamic_shift_sum as j_shift_sum
from v2v_tpu.training import checkpoint as jckpt
from v2v_tpu.training import raft as jraft
from v2v_tpu.training import steps as jsteps
from v2v_tpu.training.optim import Adam as JAdam

from v2v_tpu_torch.eval import harness
from v2v_tpu_torch.losses.lpips import LPIPS
from v2v_tpu_torch.models import hyper
from v2v_tpu_torch.models.convert import jax_params_to_state_dict
from v2v_tpu_torch.models.init import materialize
from v2v_tpu_torch.models.submodules import TorchBatchNorm
from v2v_tpu_torch.ops import dynconv as dc
from v2v_tpu_torch.training import checkpoint
from v2v_tpu_torch.training.interface import ModelInterface
from v2v_tpu_torch.training.optim import Adam
from v2v_tpu_torch.training.raft import random_teacher
from v2v_tpu_torch.training.steps import make_train_step

import chip_smoke
from test_data import make_hqf_h5
from test_dynconv import _reference as jax_slice_loop
from test_torch_losses import jax_lpips, jax_raft_small

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
# float32 on both sides; convs and sums in different orders (XLA vs
# oneDNN), so outputs agree to ~1e-6 after a few recurrent steps
ATOL = 1e-5
SMALL_UNET = dict(chip_smoke.HYPER_UNET, base_num_channels=8,
                  num_residual_blocks=1)


def _yaml(name):
    with open(os.path.join(ROOT, "configs", name)) as f:
        return yaml.safe_load(f)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# -- K4's plain version and autograd Function ---------------------------

SHIFT_CASES = [((2, 16, 16, 6, 128), 5, np.float32),   # tests/test_dynconv
               ((1, 8, 12, 3, 128), 3, np.float32),
               ((3, 9, 8, 2, 256), 5, np.float32),
               ((1, 8, 8, 6, 128), 5, jnp.bfloat16)]    # the train dtype


@pytest.mark.parametrize("shape,k,dtype", SHIFT_CASES)
def test_shift_sum_matches_jax(shape, k, dtype):
    """dynamic_shift_sum_plain and _ShiftSum (values, and gradients under a
    random cotangent) against JAX's Pallas kernel (interpret mode) with
    its jnp VJP and against the JAX slice loop. float32 sums of k*k*M
    products in other orders: 2e-5 (bfloat16 z is widened exactly on
    both sides, so the same bound holds; its dz, a float32 sum rounded
    to bfloat16 on each side, may differ by one bfloat16 ulp, 2^-7)."""
    b, h, w, m, co = shape
    rng = np.random.RandomState(0)
    z = rng.randn(*shape).astype(np.float32).astype(dtype)
    atoms = rng.randn(b, h, w, m, k * k).astype(np.float32)
    cot = rng.randn(b, h, w, co).astype(np.float32)
    zj, aj = jnp.asarray(z), jnp.asarray(atoms)
    want, vjp = jax.vjp(lambda z_, a_: j_shift_sum(z_, a_, k, interpret=True),
                        zj, aj)
    want = np.asarray(want)
    np.testing.assert_allclose(want, np.asarray(jax_slice_loop(zj, aj, k)),
                               rtol=2e-5, atol=2e-5)
    jdz, jda = vjp(jnp.asarray(cot))

    tdtype = torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32
    zt = T(z.astype(np.float32)).to(tdtype).requires_grad_()
    at = T(atoms).requires_grad_()
    before = dc.dynamic_shift_sum.launches
    np.testing.assert_allclose(dc.dynamic_shift_sum_plain(zt, at, k)
                               .detach().numpy(), want, rtol=2e-5, atol=2e-5)
    got = dc.dynamic_shift_sum(zt, at, k)
    assert got.dtype == torch.float32 and dc.dynamic_shift_sum.launches == \
        before                                  # the CPU runs no kernel
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5,
                               atol=2e-5)
    got.backward(T(cot))
    assert zt.grad.dtype == tdtype and at.grad.dtype == torch.float32
    np.testing.assert_allclose(zt.grad.float().numpy(),
                               np.asarray(jdz, np.float32),
                               rtol=2 ** -7 if tdtype == torch.bfloat16
                               else 3e-5, atol=3e-5)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(jda), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.cuda
def test_k4_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for shape, dtype in (((2, 19, 27, 6, 128), torch.float32),
                         ((3, 16, 8, 2, 97), torch.bfloat16)):
        z = torch.randn(shape, generator=g, device=dev).to(dtype)
        atoms = torch.randn(shape[:4] + (25,), generator=g, device=dev)
        before = dc.dynamic_shift_sum.launches
        got = dc.dynamic_shift_sum(z, atoms, 5)
        assert dc.dynamic_shift_sum.launches == before + 1
        torch.testing.assert_close(got, dc.dynamic_shift_sum_plain(
            z, atoms, 5), atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        dc.dynamic_shift_sum(z.transpose(1, 2), atoms, 5)   # not contiguous
    with pytest.raises(ValueError):
        dc.dynamic_shift_sum(z, atoms[..., :9].contiguous(), 3)  # k = 3


# -- TorchBatchNorm -------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_torch_batchnorm_matches_jax(train):
    """Stored statistics in eval; live f32 batch statistics and the
    momentum-0.1 update with the unbiased var in training."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 7, 5, 4).astype(np.float32) * 2 + 0.5     # NHWC
    jb = JBatchNorm(4)
    v = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    v["params"]["scale"] = rng.rand(4).astype(np.float32) + 0.5
    v["params"]["bias"] = rng.randn(4).astype(np.float32)
    v["batch_stats"]["mean"] = rng.randn(4).astype(np.float32)
    v["batch_stats"]["var"] = rng.rand(4).astype(np.float32) + 0.5
    tb = TorchBatchNorm(4)
    tb.load_state_dict(jax_params_to_state_dict(v))
    tb.train(train)
    if train:
        want, upd = jb.apply(v, jnp.asarray(x), use_running_average=False,
                             mutable=["batch_stats"])
    else:
        want, upd = jb.apply(v, jnp.asarray(x)), v
    got = tb(T(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_nhwc(got.detach()), np.asarray(want),
                               atol=ATOL)
    np.testing.assert_allclose(tb.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(tb.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6)
    assert int(tb.num_batches_tracked) == int(train)


def test_torch_batchnorm_on_bfloat16_parameter_copies():
    """The train step hands the module bf16 parameter copies through
    functional_call: the output is bf16, the running buffers stay f32 and
    update in place; one value per channel raises, as torch's does."""
    bn = TorchBatchNorm(3).train()
    params = {k: v.to(torch.bfloat16) for k, v in bn.named_parameters()}
    x = torch.randn(2, 3, 4, 4).to(torch.bfloat16)
    y = torch.func.functional_call(bn, params, (x,))
    assert y.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    xf = x.float()
    torch.testing.assert_close(bn.running_mean, 0.1 * xf.mean((0, 2, 3)))
    torch.testing.assert_close(bn.running_var,
                               0.9 + 0.1 * xf.var((0, 2, 3), unbiased=True))
    with pytest.raises(ValueError, match="value"):
        bn(torch.randn(1, 3, 1, 1))


# -- DynamicConv, DynamicAtomGeneration -----------------------------------

def test_dynamic_conv_matches_jax():
    """x (B,H,W,C) -> z = x K as one matmul, then the shift-sum; the
    (CO, C*M, 1, 1) coefficients carried from JAX's (1,1,C*M,CO), c-major
    over (c, m)."""
    b, h, w, c, co, m = 2, 12, 10, 16, 24, 6
    rng = np.random.RandomState(2)
    x = rng.randn(b, h, w, c).astype(np.float32)
    atoms = rng.randn(b, h, w, m, 25).astype(np.float32)
    jm = jhyper.DynamicConv(c, co, 5, m)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3),
                                              jnp.asarray(x),
                                              jnp.asarray(atoms)))
    params["params"]["bias"] = rng.randn(co).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(atoms)))
    tm = materialize(lambda: hyper.DynamicConv(c, co, 5, m), "cpu")
    tm.load_state_dict(jax_params_to_state_dict(params))
    assert tm.compositional_coefficients.shape == (co, c * m, 1, 1)
    got = tm(T(x).permute(0, 3, 1, 2), T(atoms))
    np.testing.assert_allclose(_nhwc(got.detach()), want, atol=ATOL)


@pytest.mark.parametrize("train", [False, True])
def test_dynamic_atom_generation_matches_jax(train):
    """conv-BN-tanh-conv-BN-tanh, 72 coefficients times the (12, 25)
    Fourier-Bessel bases; BN on stored statistics in eval and on live
    ones (updating the stored) in training."""
    rng = np.random.RandomState(4)
    ctx = rng.randn(2, 8, 9, 32).astype(np.float32)
    jm = jhyper.DynamicAtomGeneration(5, 6)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5),
                                         jnp.asarray(ctx)))
    for bn in v["batch_stats"].values():
        bn["mean"] = rng.randn(*bn["mean"].shape).astype(np.float32) * 0.1
        bn["var"] = rng.rand(*bn["var"].shape).astype(np.float32) + 0.5
    tm = materialize(lambda: hyper.DynamicAtomGeneration(32, 5, 6), "cpu")
    tm.load_state_dict(jax_params_to_state_dict(v))
    np.testing.assert_array_equal(tm.bases.numpy(),
                                  jhyper.fourier_bessel_bases(5))
    tm.train(train)
    if train:
        want, upd = jm.apply(v, jnp.asarray(ctx), train=True,
                             mutable=["batch_stats"])
    else:
        want, upd = jm.apply(v, jnp.asarray(ctx)), v
    got = tm(T(ctx).permute(0, 3, 1, 2))
    assert got.shape == (2, 8, 9, 6, 25) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    sd = jax_params_to_state_dict(jax.tree.map(np.asarray, dict(upd)))
    for k, val in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(val.numpy(), sd[k].numpy(),
                                       atol=1e-6, err_msg=k)


# -- HyperE2VID -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_hyper(b, h, w):
    """The JAX HyperE2VID at SMALL_UNET with perturbed BatchNorm
    statistics, and its variables as numpy."""
    jm = jhyper.HyperE2VID(SMALL_UNET)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((b, h, w, 5)),
                         jm.init_state(b, h, w))
    v = jax.tree.map(np.array, v)
    rng = np.random.RandomState(6)
    for bn in v["batch_stats"]["unetrecurrent"]["decoders"]["decoders_0"][
            "dynamic_atom_generation"].values():
        bn["mean"] += rng.randn(*bn["mean"].shape).astype(np.float32) * 0.1
        bn["var"] += rng.rand(*bn["var"].shape).astype(np.float32)
    return jm, v


def _port_hyper(variables):
    tm = materialize(lambda: hyper.HyperE2VID(SMALL_UNET), "cpu")
    tm.load_state_dict(jax_params_to_state_dict(variables))
    return tm


def _nchw_state(state):
    enc, prev = state
    return ([tuple(np.asarray(s).transpose(0, 3, 1, 2) for s in st)
             for st in enc], np.asarray(prev).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("curriculum", [False, True])
def test_hyper_steps_with_carried_state_match_jax(curriculum):
    """3 recurrent steps with the state carried: in eval mode without GT,
    and in training mode with the GT-mixing curriculum (beta 0.7), where
    the BatchNorms use live statistics and update the stored ones step
    after step. Outputs, final state and running statistics agree."""
    b, h, w = 2, 32, 48
    jm, v = _jax_hyper(b, h, w)
    tm = _port_hyper(v).train(curriculum)
    rng = np.random.RandomState(7)
    xs = rng.randn(3, b, h, w, 5).astype(np.float32)
    gts = rng.rand(3, b, h, w, 1).astype(np.float32)
    js = jm.init_state(b, h, w)
    ts = tm.init_state(b, h, w)
    jv = v
    for x, gt in zip(xs, gts):
        if curriculum:
            (out, js), upd = jm.apply(jv, jnp.asarray(x), js, train=True,
                                      gt_image=jnp.asarray(gt), beta=0.7,
                                      mutable=["batch_stats"])
            jv = {**jv, **upd}
            tout, ts = tm(T(x).permute(0, 3, 1, 2), ts,
                          T(gt).permute(0, 3, 1, 2), 0.7)
        else:
            out, js = jm.apply(jv, jnp.asarray(x), js)
            with torch.no_grad():
                tout, ts = tm(T(x).permute(0, 3, 1, 2), ts)
        np.testing.assert_allclose(_nhwc(tout["image"].detach()),
                                   np.asarray(out["image"]), atol=ATOL)
    enc, prev = _nchw_state(js)
    np.testing.assert_allclose(ts[1].numpy(), prev, atol=ATOL)
    assert not ts[1].requires_grad
    for (th, tc), (jh, jc) in zip(ts[0], enc):
        np.testing.assert_allclose(th.detach().numpy(), jh, atol=ATOL)
        np.testing.assert_allclose(tc.detach().numpy(), jc, atol=ATOL)
    want = jax_params_to_state_dict(jv)
    for k, val in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(val.numpy(), want[k].numpy(),
                                       atol=1e-6, err_msg=k)


def test_full_width_parameter_count_and_configs_build_quietly():
    """Both hyper configs build the full-width model (10,149,881
    parameters, the JAX init's count) without the unet_kwargs warning on
    `use_dynamic_decoder`."""
    for name in ("test_hypere2vid_original.yaml", "train_v2v_hyper_10k.yaml"):
        kwargs = _yaml(name)["module"]["model"]["params"]["unet_kwargs"]
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with torch.device("meta"):
                model = hyper.HyperE2VID(kwargs)
        assert sum(p.numel() for p in model.parameters()) == \
            chip_smoke.HYPER_PARAMS == 10_149_881


def test_full_width_weights_round_trip_through_reference_converter():
    """Port state_dict (BatchNorm running statistics included) ->
    v2v_tpu's torch_state_dict_to_flax -> the JAX HyperE2VID's tree,
    path and shape -> jax_params_to_state_dict -> the same state_dict."""
    tm = materialize(lambda: hyper.HyperE2VID(chip_smoke.HYPER_UNET), "cpu")
    with torch.no_grad():
        for k, buf in tm.named_buffers():
            if "running" in k:
                buf.uniform_(0.5, 1.5)
    sd = tm.state_dict()
    flax = torch_state_dict_to_flax(sd)
    jm = jhyper.HyperE2VID(chip_smoke.HYPER_UNET)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 5)),
                            jm.init_state(1, 32, 32))
    paths = lambda tree: {p: tuple(x.shape) for p, x in
                          jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert paths(flax) == paths(shapes)
    back = jax_params_to_state_dict(flax)
    assert sorted(back) == sorted(sd)
    for k, val in sd.items():
        torch.testing.assert_close(back[k], val, rtol=0, atol=0, msg=k)


def test_materialize_fills_every_tensor():
    """Meta-device construction leaves nothing behind: two
    materializations from one seed are equal tensor for tensor (memory
    left uninitialized would differ), the BatchNorms start at ones, zeros,
    mean 0 and var 1, and the bases are the npz's."""
    tms = [materialize(lambda: hyper.HyperE2VID(SMALL_UNET), "cpu",
                       torch.Generator().manual_seed(3)) for _ in range(2)]
    tensors = [dict(tm.named_parameters()) | dict(tm.named_buffers())
               for tm in tms]
    assert sorted(tensors[0]) == sorted(tensors[1])
    for k, val in tensors[0].items():
        torch.testing.assert_close(val, tensors[1][k], rtol=0, atol=0,
                                   msg=k)
        assert torch.isfinite(val.float()).all(), k
    dag = tms[0].unetrecurrent.decoders[0].dynamic_atom_generation
    bn = dag.bases_net[1]
    assert bool((bn.weight == 1).all() and (bn.bias == 0).all()
                and (bn.running_mean == 0).all()
                and (bn.running_var == 1).all())
    np.testing.assert_array_equal(dag.bases.numpy(),
                                  jhyper.fourier_bessel_bases(5))
    coeff = tms[0].unetrecurrent.decoders[0].dynamic_conv.state_dict()
    assert bool((coeff["bias"] == 0).all())
    w = coeff["compositional_coefficients"]
    assert 0.5 < float(w.std()) * np.sqrt(w.shape[1] / 2) < 1.5


# -- the train step -------------------------------------------------------

LR = 1e-3          # train_v2v_hyper_10k.yaml
B, TT, H, W = 2, 3, 32, 32
ITERS = 4          # teacher refinements, cut from 12


def _train_module():
    """train_v2v_hyper_10k.yaml's module at SMALL_UNET in float32, L0 cut
    from 20 to 2 to fit T=3, ITERS teacher refinements."""
    mod = copy.deepcopy(chip_smoke.HYPER_TRAIN_MODULE)
    mod.pop("compute_dtype")
    mod["loss"].update(temporal_consistency_L0=2,
                       raft_num_flow_updates=ITERS)
    mod["model"]["params"]["unet_kwargs"] = SMALL_UNET
    return mod


@pytest.mark.filterwarnings("ignore:LPIPS")
def test_hyper_train_step_matches_jax(monkeypatch):
    """Precomputed voxels (the simulators' RNG streams differ by design),
    hyper_beta 0.7: first-step loss rtol 1e-4, per-sample terms, every
    parameter's gradient rtol 1e-3 / atol 1e-6 (float32, summation orders
    differ; this holds BN's gradient through the live statistics, the
    c-major dynamic-conv coefficients and the curriculum), the BN running
    statistics after 3 live updates (atol 1e-5), and parameters after one
    amsgrad step within 2*lr (Adam's first step moves each weight by
    ~lr*sign(g), so a near-zero gradient may flip sign)."""
    lp, teacher = jax_lpips(), jax_raft_small(ITERS)
    monkeypatch.setattr(jiface_mod, "LPIPS", lambda net: lp)
    monkeypatch.setitem(jraft._cache, ("raft_small", ITERS), teacher)
    orig = jraft.raft_flow

    def f32_flow(source, frames, l0, num_flow_updates):
        return jax.jit(lambda f: orig(source, f, l0, num_flow_updates,
                                      compute_dtype=None))(frames)

    monkeypatch.setattr(jraft, "raft_flow", f32_flow)
    _, v = _jax_hyper(B, H, W)
    v = copy.deepcopy(v)
    # predictions away from 0, where the TC loss's clamp has a kink
    v["params"]["unetrecurrent"]["pred"]["conv2d"]["bias"] += 1.0
    rng = np.random.RandomState(8)
    events = rng.randn(B, TT, H, W, 5).astype(np.float32)
    frame = np.clip(rng.rand(B, 1, H, W, 1) + 0.05 * np.cumsum(
        rng.randn(B, TT, H, W, 1), 1), 0, 1).astype(np.float32)

    j = jiface_mod.ModelInterface(_train_module())
    opt = JAdam(lr=LR, weight_decay=0, amsgrad=True).make()
    jstep = jsteps.make_train_step(j, opt, donate=False)
    jbatch = {"events": jnp.asarray(events), "frame": jnp.asarray(frame)}
    jnew, _, jloss, jaux = jstep(v, opt.init(v), jbatch,
                                 jax.random.PRNGKey(0), 0.7)
    # the gradients, as the JAX step's loss_fn takes them
    jbatch = j.prepare_flow(jbatch)

    def loss_fn(p):
        p = {**p, "batch_stats": jax.tree.map(jax.lax.stop_gradient,
                                              p["batch_stats"])}
        pred, _ = j.forward_sequence(
            p, jbatch["events"], j.init_state(B, H, W), train=True,
            gt_frames=jbatch["frame"], hyper_beta=jnp.float32(0.7))
        return j.calc_loss(pred, jbatch)[0]

    jgrads = jax.jit(jax.grad(loss_fn))(v)

    tl = LPIPS("vgg", device="cpu")
    tl.module.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, lp.params)))
    tt = random_teacher(ITERS, "cpu")
    tt.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, teacher[1])))
    port = ModelInterface(_train_module(), device="cpu", lpips=tl,
                          teacher=tt)
    port.teacher_dtype = None
    port.model.load_state_dict(jax_params_to_state_dict(v))
    assert port.hyper_epochs == 16 and not port.scan_split
    step = make_train_step(port, Adam(lr=LR, amsgrad=True).make(
        port.model.parameters()))
    loss, aux = step({"events": T(events), "frame": T(frame)},
                     hyper_beta=0.7)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for k in ("l1_loss", "perceptual_loss", "temporal_consistency_loss"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    want_g = jax_params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=name)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jnew))
    for name, val in port.model.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(val.numpy(), want[name].numpy(),
                                       atol=1e-5, err_msg=name)
        elif "num_batches" in name:
            assert int(val) == TT
        else:
            np.testing.assert_allclose(val.numpy(), want[name].numpy(),
                                       rtol=0, atol=2 * LR, err_msg=name)


# -- the eval harness -----------------------------------------------------

def test_chip_smoke_hyper_dicts_match_yamls():
    train = _yaml("train_v2v_hyper_10k.yaml")
    assert chip_smoke.HYPER_TRAIN_MODULE == train["module"]
    assert chip_smoke.HYPER_TRAIN_STAGE == train["train_stages"][0]
    assert chip_smoke.HYPER_EVAL_CONFIG == _yaml(
        "test_hypere2vid_original.yaml")


@pytest.mark.filterwarnings("ignore:LPIPS")
def test_harness_matches_jax_output_to_output(tmp_path, monkeypatch):
    """test_hypere2vid_original.yaml's harness at SMALL_UNET on two
    EVAID-named synthetic h5 sequences of 8 frames at 40x56 in windows
    of 4 (state carried within a sequence, reset between them), the same
    weights (BN statistics included) and LPIPS-Alex trunk: the
    per-sequence MSE/SSIM/LPIPS and the CSV row agree (predictions to
    ~1e-6; LPIPS sums 5 float32 trunk layers)."""
    _, params = _jax_hyper(1, 48, 64)
    jl = jax_lpips("alex")
    tl = LPIPS("alex", device="cpu")
    tl.module.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, jl.params)))
    monkeypatch.setattr(jiface_mod.ModelInterface, "lpips_test",
                        property(lambda s: jl))
    monkeypatch.setattr(jiface_mod.ModelInterface, "init",
                        lambda s, key, b, h, w, nb=5: (params, None))
    monkeypatch.setattr(ModelInterface, "lpips_test", property(lambda s: tl))

    names = [make_hqf_h5(str(tmp_path / f"{n}.h5"), n_frames=9, h=40, w=56,
                         events_per_frame=300, seed=i)
             for i, n in enumerate(("ball", "bear"))]
    h5_list = str(tmp_path / "evaid_test.txt")
    with open(h5_list, "w") as f:
        f.write("\n".join(names) + "\n")
    cfg = _yaml("test_hypere2vid_original.yaml")
    cfg.pop("test_output_dir")
    cfg["module"]["model"]["params"]["unet_kwargs"] = SMALL_UNET
    cfg["test_stage"]["test_num_workers"] = 2
    cfg["test_stage"]["test"] = [dict(
        cfg["test_stage"]["test"][0], data_file=h5_list, sequence_length=4,
        use_native_voxel_builder=False)]
    exp = cfg["experiment_name"]

    root_j, root_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jpath = os.path.join(root_j, "ckpt", "hyper.msgpack")
    jckpt.save_checkpoint(jpath, params, None, 0)
    jckpt.append_ckpt_path(exp, jpath, root_j)
    tpath = os.path.join(root_t, "ckpt", "hyper.pth")
    os.makedirs(os.path.dirname(tpath))
    torch.save({"state_dict": jax_params_to_state_dict(params)}, tpath)
    checkpoint.append_ckpt_path(exp, tpath, root_t)

    jharness.main(copy.deepcopy(cfg), root=root_j)
    harness.main(copy.deepcopy(cfg), root=root_t, device="cpu")

    logs = lambda r: os.path.join(r, "tensorboard_logs", exp)
    read = lambda r: {k: float(v) for k, v in (
        ln.rsplit(": ", 1) for ln in open(os.path.join(
            logs(r), "test_metrics.txt")) if ln.strip())}
    want, got = read(root_j), read(root_t)
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    rows = [open(os.path.join(logs(r), "all_test_results_new.csv"))
            .read().splitlines()[1].split(",") for r in (root_j, root_t)]
    assert rows[1][0] == "hyper.pth"
    filled = [i for i, v in enumerate(rows[0][1:], 1) if v]
    assert len(filled) == 6
    np.testing.assert_allclose([float(rows[1][i]) for i in filled],
                               [float(rows[0][i]) for i in filled],
                               rtol=1e-4, atol=1e-6)
