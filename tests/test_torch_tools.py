"""The port's last helpers against the JAX package: ops/pad.py's crop
helpers, data/webvid.py::log_uniform, the five losses of
losses/losses.py that came last, utils/parse_config.py, utils/timers.py
and utils/flops.py (whose counts must equal the jaxpr counter's on the
same model)."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from v2v_tpu.data.webvid import log_uniform as j_log_uniform
from v2v_tpu.losses import losses as JL
from v2v_tpu.ops import pad as jpad
from v2v_tpu.training.interface import ModelInterface as JInterface
from v2v_tpu.utils.flops import count_flops as j_count_flops
from v2v_tpu.utils.parse_config import ConfigParser as JConfigParser

from v2v_tpu_torch.data.webvid import log_uniform
from v2v_tpu_torch.losses import losses as TL
from v2v_tpu_torch.ops import pad as tpad
from v2v_tpu_torch.training.interface import ModelInterface
from v2v_tpu_torch.utils import flops, timers
from v2v_tpu_torch.utils.parse_config import ConfigParser

T = torch.from_numpy
# float32 on both sides; the JAX warp is a matmul (warp_by_flow_mxu), the
# port's grid_sample, so the losses agree to float32 rounding
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
SIZES = [(1, 1), (5, 7), (16, 16), (33, 17), (240, 180), (346, 260)]


def _crop_attrs(obj):
    return {k: v for k, v in vars(obj).items() if isinstance(v, int)}


@pytest.mark.parametrize("helper", ["optimal_crop_size", "CropParameters",
                                    "CropSize", "CropSize3D"])
def test_crop_helpers_equal_jax(helper):
    """Every size, pad and crop index equal; pad then crop give the same
    values once a size (the JAX helpers pad NHWC, the port's NCHW)."""
    rng = np.random.RandomState(0)
    for (w, h) in SIZES:
        for margin in (0, 1):
            if helper == "optimal_crop_size":
                for f in range(4):
                    assert tpad.optimal_crop_size(h, f, margin) == \
                        jpad.optimal_crop_size(h, f, margin)
                continue
            if helper == "CropParameters":
                args = [(w, h, n, margin) for n in range(4)]
            elif helper == "CropSize":
                args = [(w, h, p, margin) for p in ({"h": 8, "w": 4},
                                                    {"h": 3, "w": 5})]
            else:
                args = [(w, h, t, p, margin) for t in (1, 6)
                        for p in ({"t": 4, "h": 8, "w": 4},
                                  {"t": 3, "h": 3, "w": 5})]
            for a in args:
                jc, tc = getattr(jpad, helper)(*a), getattr(tpad, helper)(*a)
                assert _crop_attrs(tc) == _crop_attrs(jc)
                if margin or a is not args[0]:
                    continue          # the arrays once a size: JAX compiles
                shape = ((2, a[2], h, w) if helper == "CropSize3D"
                         else (2, h, w))
                x = rng.randn(*shape, 3).astype(np.float32)
                jp = np.asarray(jc.pad(jnp.asarray(x)))
                tp = tc.pad(T(np.moveaxis(x, -1, 0).copy())).numpy()
                np.testing.assert_array_equal(np.moveaxis(tp, 0, -1), jp)
                np.testing.assert_array_equal(
                    np.moveaxis(tc.crop(T(tp)).numpy(), 0, -1),
                    np.asarray(jc.crop(jnp.asarray(jp))))


def test_log_uniform_equal_jax():
    """Both draw from the global numpy stream: the same seed gives the
    same values."""
    for seed in (0, 1, 7):
        for lo, hi in ((0.05, 2.0), (0.0, 0.1), (1.0, 1.0), (0.0, 10.0)):
            np.random.seed(seed)
            want = [j_log_uniform(lo, hi) for _ in range(5)]
            np.random.seed(seed)
            got = [log_uniform(lo, hi) for _ in range(5)]
            assert got == want


def _lpips_np(xp):
    """One plain LPIPS stand-in for both packages: (B,) of a nonlinear
    per-sample distance of NHWC inputs."""
    def lpips(a, b, normalize=True):
        d = (a - b) ** 2 + 0.1 * xp.abs(a * b)
        return d.mean(axis=(1, 2, 3)) if xp is jnp else d.mean(dim=(1, 2, 3))
    return lpips


@pytest.mark.parametrize("loss", ["warping_flow_loss",
                                  "voxel_warping_flow_loss", "mse_metric",
                                  "combined_perceptual_loss",
                                  "flow_perceptual_loss"])
def test_losses_equal_jax(loss):
    """B=2 at 24x32 (5 bins for the voxel loss), flows of a few pixels,
    NHWC in both packages."""
    rng = np.random.RandomState(3)
    b, h, w = 2, 24, 32
    img0, img1 = (rng.rand(b, h, w, 1).astype(np.float32) for _ in range(2))
    flow = (rng.randn(b, h, w, 2) * 2).astype(np.float32)
    flow2 = (rng.randn(b, h, w, 2) * 2).astype(np.float32)
    voxel = rng.randn(b, h, w, 5).astype(np.float32)
    args = {"warping_flow_loss": (img0, img1, flow),
            "voxel_warping_flow_loss": (voxel, flow),
            "mse_metric": (img0, img1),
            "combined_perceptual_loss": (img0, flow, img1, flow2),
            "flow_perceptual_loss": (flow, flow2)}[loss]
    jargs, targs = [jnp.asarray(a) for a in args], [T(a) for a in args]
    if "perceptual" in loss:
        jargs, targs = [_lpips_np(jnp)] + jargs, [_lpips_np(torch)] + targs
    want = float(getattr(JL, loss)(*jargs))
    got = float(getattr(TL, loss)(*targs))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert abs(want) > 1e-3          # the case measures something


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f)) as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = \
                    json.load(fh)
    return out


def test_config_parser_equal_jax(tmp_path):
    """The same config, modification and run id: equal configs, equal
    directories (relative to each save_dir) with equal config.json, and
    init_obj's instances; from_file likewise."""
    def config(root):
        return {"name": "exp", "trainer": {"save_dir": str(root)},
                "arch": {"type": "Pair", "args": {"a": 1, "b": 2}},
                "optimizer": {"args": {"lr": 0.1}}}
    mod = {"optimizer;args;lr": 0.01, "arch;args;b": 5, "trainer;x": None}
    registry = {"Pair": lambda a, b, c=0: (a, b, c)}
    parsers = {}
    for name, cls in (("jax", JConfigParser), ("port", ConfigParser)):
        root = tmp_path / name
        p = cls(config(root), resume="ck.pth", modification=mod,
                run_id="r1")
        parsers[name] = (p, root)
    (jp, jroot), (tp, troot) = parsers["jax"], parsers["port"]
    strip = lambda c: dict(c, trainer={})
    assert strip(tp.config) == strip(jp.config)
    assert tp.resume == jp.resume == "ck.pth"
    assert tp.save_dir.relative_to(troot) == jp.save_dir.relative_to(jroot)
    assert tp.log_dir.relative_to(troot) == jp.log_dir.relative_to(jroot)
    assert tp.log_dir.is_dir() and jp.log_dir.is_dir()
    jt, tt = _tree(jroot), _tree(troot)
    assert sorted(tt) == sorted(jt) == [os.path.join(
        "models", "exp", "r1", "config.json")]
    assert strip(next(iter(tt.values()))) == strip(next(iter(jt.values())))
    assert tp.init_obj("arch", registry, c=3) == \
        jp.init_obj("arch", registry, c=3) == (1, 5, 3)
    made = {}
    for name, cls in (("jax", JConfigParser), ("port", ConfigParser)):
        path = tmp_path / f"{name}.json"          # timestamped run ids
        path.write_text(json.dumps(config(tmp_path / f"file_{name}")))
        made[name] = cls.from_file(str(path), modification=mod)
    assert strip(made["port"].config) == strip(made["jax"].config)
    assert made["port"]["optimizer"]["args"]["lr"] == 0.01


def test_timers_accumulate_on_the_cpu(tmp_path, monkeypatch):
    """Timer and DeviceTimer (a CPU result: the host clock) append a time
    a use under their names; print_timing_info reports both; profile_trace
    writes a Chrome trace."""
    monkeypatch.setattr(timers, "_registered", True)    # no atexit here
    monkeypatch.setattr(timers, "timers", type(timers.timers)(list))
    monkeypatch.setattr(timers, "device_timers",
                        type(timers.device_timers)(list))
    for _ in range(3):
        with timers.Timer("host"):
            sum(range(1000))
        with timers.DeviceTimer("device") as t:
            t.result = (torch.ones(64, 64) @ torch.ones(64, 64),
                        {"x": torch.zeros(2)})
    with timers.DeviceTimer("none"):
        pass
    assert len(timers.timers["host"]) == 3
    assert len(timers.device_timers["device"]) == 3
    assert len(timers.device_timers["none"]) == 1
    assert all(v >= 0 for v in timers.device_timers["device"])
    timers.print_timing_info()
    with timers.profile_trace(str(tmp_path / "log")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert (tmp_path / "log" / "trace.json").stat().st_size > 0


def _jax_counts(case):
    """JAX's count of the same program as `_port_counts(case)`."""
    if case == "matmul":
        return j_count_flops(jax.make_jaxpr(lambda a, b: a @ b)(
            jnp.zeros((64, 128)), jnp.zeros((128, 32))))
    if case == "loop":
        def body(c, _):
            return c @ jnp.ones((32, 32)), ()
        return j_count_flops(jax.make_jaxpr(
            lambda c: jax.lax.scan(body, c, None, length=10))(
                jnp.zeros((4, 32))))
    return j_count_flops(jax.make_jaxpr(
        lambda x, k: jax.lax.conv_general_dilated(
            x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO",
                                                     "NHWC")))(
        jnp.zeros((1, 8, 8, 3)), jnp.zeros((3, 3, 3, 16))))


def _port_counts(case):
    if case == "matmul":
        return flops.count_flops(torch.matmul, torch.zeros(64, 128),
                                 torch.zeros(128, 32))

    def loop(c):
        for _ in range(10):
            c = c @ torch.ones(32, 32)
        return c
    if case == "loop":
        return flops.count_flops(loop, torch.zeros(4, 32))
    return flops.count_flops(torch.nn.functional.conv2d,
                             torch.zeros(1, 3, 8, 8),
                             torch.zeros(16, 3, 3, 3), padding=1)


@pytest.mark.parametrize("case,want", [
    ("matmul", 2 * 64 * 128 * 32), ("loop", 10 * 2 * 4 * 32 * 32),
    ("conv", 2 * 1 * 8 * 8 * 16 * 3 * 3 * 3)])
def test_flop_counter_known_shapes(case, want):
    """tests/test_aux.py's shapes: the port's count, the closed form and
    the jaxpr counter's agree (a Python loop of 10 steps against a scan
    of length 10)."""
    assert _port_counts(case) == want == _jax_counts(case)


def test_flop_counter_gradients_follow_the_jax_rule():
    """A stride-2 convolution's and a transposed convolution's gradients
    count as JAX's counter counts jax.grad's convolutions."""
    def strided(x, k):
        return jnp.sum(jax.lax.conv_general_dilated(
            x, k, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO",
                                                     "NHWC")))

    def transposed(x, k):
        return jnp.sum(jax.lax.conv_transpose(
            x, k, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO",
                                                     "NHWC")))
    grad = lambda f, *a: j_count_flops(jax.make_jaxpr(jax.grad(
        f, argnums=(0, 1)))(*a))
    want_s = grad(strided, jnp.zeros((2, 8, 8, 3)), jnp.zeros((3, 3, 3, 16)))
    want_t = grad(transposed, jnp.zeros((2, 4, 4, 8)),
                  jnp.zeros((4, 4, 8, 5)))
    x = torch.zeros(2, 3, 8, 8, requires_grad=True)
    k = torch.zeros(16, 3, 3, 3, requires_grad=True)
    got_s = flops.count_flops(lambda: torch.nn.functional.conv2d(
        x, k, stride=2, padding=1).sum().backward())
    x = torch.zeros(2, 8, 4, 4, requires_grad=True)
    k = torch.zeros(8, 5, 4, 4, requires_grad=True)
    got_t = flops.count_flops(lambda: torch.nn.functional.conv_transpose2d(
        x, k, stride=2, padding=1).sum().backward())
    assert (got_s, got_t) == (want_s, want_t)
    assert got_t > flops.count_flops(torch.nn.functional.conv_transpose2d,
                                     x.detach(), k.detach(), stride=2,
                                     padding=1) > 0


@pytest.mark.parametrize("upsample_conv", [True, False],
                         ids=["flagship", "transposed-convs"])
def test_flop_count_of_the_e2vid_forward_equals_jax(upsample_conv):
    """The flagship's E2VID (configs/train_v2v_e2vid_10k.yaml's model)
    over T=2 at 32x32 in eval, and the same UNet with transposed-conv
    decoders (use_upsample_conv: false): the port's count equals the
    jaxpr counter's of JAX's forward_sequence, bilinear upsamples and
    transposed convs included; its by-shape histogram sums to it."""
    module = {"model": {"target": "model.model.E2VIDRecurrent", "params": {
        "unet_kwargs": {"num_bins": 5, "skip_type": "sum",
                        "recurrent_block_type": "convlstm",
                        "num_encoders": 3, "base_num_channels": 32,
                        "num_residual_blocks": 2,
                        "use_upsample_conv": upsample_conv,
                        "final_activation": "", "norm": "none"}}}}
    ji = JInterface(module)
    params = jax.eval_shape(lambda key: ji.init(key, 1, 32, 32)[0],
                            jax.random.PRNGKey(0))
    want = j_count_flops(jax.make_jaxpr(
        lambda p, e, s: ji.forward_sequence(p, e, s, train=False))(
            params, jnp.zeros((1, 2, 32, 32, 5)), ji.init_state(1, 32, 32)))
    ti = ModelInterface(module, "cpu")
    args = (torch.zeros(1, 2, 32, 32, 5), ti.init_state(1, 32, 32))
    got = flops.count_flops(ti.forward_sequence, *args, train=False)
    hist = flops.count_flops_by_shape(ti.forward_sequence, *args,
                                      train=False)
    assert got == want > 1e9
    assert sum(hist.values()) == got
    kind = "upsample_bilinear2d" if upsample_conv else "convolution"
    assert any(k.startswith(kind) for k in hist)
