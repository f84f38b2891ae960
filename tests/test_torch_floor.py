"""A train step's measured floor and its closure, on the CPU at small
sizes: utils/flops.py's replayable recorder (its totals against the
counter and against the JAX counter on the E2VID forward; each entry's
replay books its FLOPs), scripts/roofline_floor.py (the floor's
arithmetic against the JAX script's formula; a run), scripts/
close_floor.py (its rows sum to the step) and bench_full_step's ETNet,
EVFlowNet and ERAFT configs against their YAMLs."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
import yaml

from v2v_tpu.training.interface import ModelInterface as JInterface
from v2v_tpu.utils.flops import count_flops as j_count_flops

from v2v_tpu_torch.config import load_yaml
from v2v_tpu_torch.scripts import bench_full_step, close_floor, roofline_floor
from v2v_tpu_torch.training.interface import ModelInterface
from v2v_tpu_torch.utils import flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,yaml_name", [
    ("etnet", "train_v2v_etnet_10k.yaml"),
    ("evflow", "train_v2v_evflow_10k.yaml"),
    ("eraft", "train_v2v_eraft_10k.yaml")])
def test_bench_config_equals_its_yaml(name, yaml_name):
    """bench_full_step's built-in copy of a YAML's module and first stage
    (the card's machine has no PyYAML) and its task."""
    full = load_yaml(os.path.join(CONFIGS, yaml_name))
    module, stage = bench_full_step.CONFIGS[name]
    assert module == full["module"]
    want = full["train_stages"][0]
    assert stage["optimizer"] == want["optimizer"]
    assert stage["lr_scheduler"] == want["lr_scheduler"]
    assert stage["dataset"]["train_batch_size"] == \
        want["dataset"]["train_batch_size"]
    assert stage["dataset"]["train"] == want["dataset"]["train"]
    assert bench_full_step.load_config(name)[3] == full.get("task", "e2vid")


def _toy():
    """A strided, a transposed (output padding), a dilated grouped
    convolution, a bilinear upsample and two matmuls, with the
    backward."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 9, 9, generator=g, requires_grad=True)
    w = torch.randn(8, 3, 3, 3, generator=g, requires_grad=True)
    wt = torch.randn(8, 4, 4, 4, generator=g, requires_grad=True)
    wg = torch.randn(8, 2, 3, 3, generator=g, requires_grad=True)
    y = F.conv2d(x, w, stride=2, padding=1)
    z = F.conv_transpose2d(y, wt, stride=2, padding=1, output_padding=1)
    u = F.conv2d(z, wg, padding=2, dilation=2, groups=2)
    v = F.interpolate(u, scale_factor=2, mode="bilinear",
                      align_corners=False)
    m = v.flatten(1) @ torch.randn(v[0].numel(), 5, generator=g)
    m.sum().backward()
    return m


def test_replay_books_the_recorded_flops():
    """Each recorded entry, replayed alone on fresh tensors of its
    shapes, dtypes and strides, books its FLOPs a call; the entries
    cover strides, padding, dilation, groups, a transposed convolution
    with output padding, their gradients, the resize and matmuls."""
    entries, _ = flops.record_ops(_toy)
    assert sum(e["flops"] for e in entries) == flops.count_flops(_toy)
    names = {e["name"] for e in entries}
    assert names == {"convolution", "convolution_backward", "mm",
                     "upsample_bilinear2d", "upsample_bilinear2d_backward"}
    convs = [e["args"] for e in entries if e["name"] == "convolution"]
    # (stride, padding, dilation, transposed, output padding, groups)
    assert sorted(a[3:9] for a in convs) == sorted([
        ((2, 2), (1, 1), (1, 1), False, (0, 0), 1),
        ((2, 2), (1, 1), (1, 1), True, (1, 1), 1),
        ((1, 1), (2, 2), (2, 2), False, (0, 0), 2)])
    for e in entries:
        args, kwargs = flops.replay_inputs(e, "cpu")
        assert [tuple(a.shape) for a in args if torch.is_tensor(a)] == [
            t.shape for t in e["tensors"]]
        got = flops.count_flops(flops.replay, e, args, kwargs)
        assert got * e["count"] == e["flops"], e["name"]


def test_replay_keeps_strides():
    """A non-contiguous operand (a transposed view) replays with its
    strides."""
    a = torch.randn(16, 8).t()
    entries, _ = flops.record_ops(lambda: a @ torch.randn(16, 4))
    (e,) = entries
    args, _ = flops.replay_inputs(e, "cpu")
    assert args[0].stride() == a.stride() and e["tensors"][0].stride == (1, 8)


def _tiny_train_yaml(path, model="e2vid"):
    """The flagship's YAML at width 4, or ETNet's, cut to B=1, T=2,
    32x32, temporal consistency over L0 1."""
    name = {"e2vid": "train_v2v_e2vid_10k.yaml",
            "etnet": "train_v2v_etnet_10k.yaml"}[model]
    full = load_yaml(os.path.join(CONFIGS, name))
    if model == "e2vid":
        full["module"]["model"]["params"]["unet_kwargs"].update(
            base_num_channels=4, num_residual_blocks=1)
    full["module"]["loss"]["temporal_consistency_L0"] = 1
    stage = full["train_stages"][0]
    stage["dataset"]["train_batch_size"] = 1
    stage["dataset"]["train"][0].update(sequence_length=2, crop_size=32)
    with open(path, "w") as f:
        yaml.safe_dump(full, f)
    return str(path)


def test_recorder_sums_to_the_step_count(tmp_path):
    """A train step's recorded entries (the tiny flagship) sum to
    step_flops' count of the same step, and their counts to its calls."""
    b = bench_full_step.build(_tiny_train_yaml(tmp_path / "t.yaml"),
                              torch.device("cpu"))
    n, _ = flops.step_flops(b.step, b.batch, b.generator)
    entries, _ = flops.record_ops(b.step, b.batch, b.generator)
    assert sum(e["flops"] for e in entries) == n > 0
    assert entries == sorted(entries, key=lambda e: -e["flops"])


def test_recorder_on_the_e2vid_forward_equals_jax():
    """The flagship's E2VID over T=2 at 32x32 in eval: the recorder's
    entries sum to the jaxpr counter's count of JAX's forward_sequence
    (tests/test_torch_tools.py holds the counter there)."""
    module = {"model": {"target": "model.model.E2VIDRecurrent", "params": {
        "unet_kwargs": {"num_bins": 5, "skip_type": "sum",
                        "recurrent_block_type": "convlstm",
                        "num_encoders": 3, "base_num_channels": 32,
                        "num_residual_blocks": 2, "use_upsample_conv": True,
                        "final_activation": "", "norm": "none"}}}}
    ji = JInterface(module)
    params = jax.eval_shape(lambda key: ji.init(key, 1, 32, 32)[0],
                            jax.random.PRNGKey(0))
    want = j_count_flops(jax.make_jaxpr(
        lambda p, e, s: ji.forward_sequence(p, e, s, train=False))(
            params, jnp.zeros((1, 2, 32, 32, 5)), ji.init_state(1, 32, 32)))
    ti = ModelInterface(module, "cpu")
    entries, _ = flops.record_ops(ti.forward_sequence,
                                  torch.zeros(1, 2, 32, 32, 5),
                                  ti.init_state(1, 32, 32), train=False)
    assert sum(e["flops"] for e in entries) == want > 1e9
    assert any(e["name"] == "upsample_bilinear2d" for e in entries)


def test_floor_arithmetic_equals_the_jax_formula():
    """The JAX script's floor (roofline_floor.py:204-239): the tail past
    the measured entries at the peak, each measured entry at its rate; a
    rate above 1.15 x the peak and an unresolved one count at the peak."""
    peak = 500e12
    ranked = [{"flops": f} for f in (8e12, 4e12, 2e12, 1e12, 5e11, 1e11)]
    rates = [400e12, None, 1.2 * peak, 1.1 * peak]
    floor, rows = roofline_floor.floor_seconds(ranked, rates, peak)
    want = ((5e11 + 1e11) / peak + 8e12 / 400e12 + 4e12 / peak
            + 2e12 / peak + 1e12 / (1.1 * peak))
    assert floor == pytest.approx(want, rel=1e-12)
    assert [r[0] for r in rows] == [400e12, peak, peak, 1.1 * peak]
    assert "unresolved" in rows[1][2] and "leak" in rows[2][2]
    assert rows[0][2] == rows[3][2] == ""


def test_roofline_floor_runs_on_the_cpu(tmp_path, capsys):
    """roofline_floor's main on the tiny flagship, the host's times: the
    table, the floor and the gap, the hidden kernels at 0 launches (their
    plain versions run on the CPU, and FlopCounterMode sees those)."""
    argv = ["--config", _tiny_train_yaml(tmp_path / "t.yaml"), "--device",
            "cpu", "--top", "3", "--no-calibrate", "--steps", "1",
            "--repeats", "1"]
    assert roofline_floor.main(argv) == 0
    text = capsys.readouterr().out
    out = json.loads(text.strip().splitlines()[-1])
    assert "FLOOR " in text and "gap = measured / floor" in text
    assert len(out["rows"]) == 3 and out["device"] == "cpu"
    assert out["floor_ms"] > 0 and np.isfinite(out["gap"])
    assert out["tail_rate"] == bench_full_step.BF16_PEAK_FLOPS
    assert out["hidden_launches"] == {"attention": 0, "dynamic_shift_sum": 0,
                                      "dynamic_shift_sum_backward": 0}
    assert sum(out["dtype_census"].values()) == pytest.approx(1.0)


@pytest.mark.parametrize("config", ["etnet", "eraft"])
def test_close_floor_rows_sum_to_the_step(config, tmp_path, capsys):
    """close_floor at B=1, T=2, 32x32 on the CPU: ETNet's split
    constituents (its YAML with temporal consistency over L0 1) and
    ERAFT's fnet and pair rows; teacher + sim + P + residual = S_all."""
    if config == "etnet":
        argv = ["--config", _tiny_train_yaml(tmp_path / "e.yaml", "etnet")]
    else:
        argv = ["--config", "eraft", "--batch", "1", "--sequence-length",
                "2", "--crop", "32"]
    assert close_floor.main(argv + ["--device", "cpu", "--steps", "1",
                                    "--iters", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    parts = (out["teacher_ms"] + out["sim_ms"] + out["constituents_ms"]
             + out["residual_ms"])
    assert parts == pytest.approx(out["s_all_ms"], rel=1e-9)
    assert out["constituents_ms"] > 0 and out["sim_ms"] > 0
    assert out["fill"] == pytest.approx(out["constituents_ms"]
                                        / out["scan_ms"])
    rows = " ".join(out["rows"])
    assert ("spine" in rows) == (config == "etnet")
    assert ("pair" in rows) == (config == "eraft")
