"""The port's eval path (v2v_tpu_torch data/*, ops/voxel.py host
voxelizer, eval/*, training/checkpoint.py, cli.py) against the JAX
package: voxels, metrics, LPIPS-Alex on a bridged trunk, and the whole
harness output to output on synthetic h5 files."""
import copy
import os

import numpy as np
import jax
import pytest
import torch
import yaml

import v2v_tpu.models.eitr as jeitr
from v2v_tpu.data.h5 import TestH5Dataset as JTestH5Dataset
from v2v_tpu.eval import harness as jharness
from v2v_tpu.eval import metrics as jmetrics
from v2v_tpu.ops.voxel import events_to_voxel_np as j_events_to_voxel_np
from v2v_tpu.training import checkpoint as jckpt
from v2v_tpu.training.interface import ModelInterface as JInterface

import v2v_tpu_torch.models.eitr as teitr
from v2v_tpu_torch import cli
from v2v_tpu_torch.data.h5 import TestH5Dataset as PortH5Dataset
from v2v_tpu_torch.eval import harness
from v2v_tpu_torch.eval import metrics
from v2v_tpu_torch.losses.lpips import LPIPS
from v2v_tpu_torch.models.convert import jax_params_to_state_dict
from v2v_tpu_torch.ops.voxel import events_to_voxel_np
from v2v_tpu_torch.training import checkpoint
from v2v_tpu_torch.training.interface import ModelInterface

import chip_smoke
from test_data import make_hqf_h5
from test_torch_eitr import _jax_eitr
from test_torch_losses import jax_lpips

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy


def _events(n, h=30, w=40, seed=0):
    rng = np.random.RandomState(seed)
    return (np.sort(rng.rand(n)) * 0.05 + 3.0,
            rng.randint(0, w, n).astype(np.uint16),
            rng.randint(0, h, n).astype(np.uint16),
            rng.randint(0, 2, n).astype(np.uint8))


@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("n", [0, 1, 5000])
def test_events_to_voxel_np_is_bit_exact_with_jax(interpolate, n):
    ev = _events(n)
    kw = dict(num_bins=5, height=30, width=40, interpolate_bins=interpolate)
    got = events_to_voxel_np(*ev, **kw)
    want = j_events_to_voxel_np(*ev, **kw)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_ssim_and_mse_equal_jax():
    rng = np.random.RandomState(4)
    a, b = rng.rand(2, 37, 53)
    b = 0.7 * a + 0.3 * b
    assert metrics.ssim(a, b, data_range=2) == jmetrics.ssim(a, b,
                                                            data_range=2)
    assert metrics.mse(a, b) == jmetrics.mse(a, b)


@pytest.mark.filterwarnings("ignore:LPIPS")
@pytest.mark.parametrize("h,w", [(64, 80), (40, 50)])
def test_lpips_alex_matches_jax_on_bridged_trunk(h, w):
    """The JAX LPIPS("alex") params (random trunk + shipped lin heads)
    carried into the port: distances agree to 1e-4 relative (float32
    conv sums in different orders). 40x50 takes the <64 px upsample."""
    jl = jax_lpips("alex")
    tl = LPIPS("alex", device="cpu")
    tl.module.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, jl.params)))
    rng = np.random.RandomState(5)
    a, b = (rng.rand(3, h, w, 1).astype(np.float32) for _ in range(2))
    want = np.asarray(jl(a, b, True))
    got = tl(T(a), T(b), normalize=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_test_h5_dataset_equals_jax(tmp_path):
    path = make_hqf_h5(str(tmp_path / "seq.h5"), n_frames=10)
    cfg = {"sequence_length": 4, "num_bins": 5, "dataset_name": "evaid",
           "interpolate_bins": True, "use_native_voxel_builder": False}
    ours, theirs = PortH5Dataset(path, cfg), JTestH5Dataset(path, cfg)
    assert len(ours) == len(theirs) == 3
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


def _etnet_config():
    with open(os.path.join(ROOT, "configs", "test_etnet_original.yaml")) as f:
        return yaml.safe_load(f)


def test_chip_smoke_etnet_config_matches_yaml():
    assert chip_smoke.ETNET_CONFIG == _etnet_config()


def _harness_config(h5_list, output_dir):
    cfg = _etnet_config()
    cfg["test_output_dir"] = output_dir
    cfg["test_stage"]["test_num_workers"] = 2
    cfg["test_stage"]["test"] = [dict(
        cfg["test_stage"]["test"][0], data_file=h5_list, sequence_length=4,
        use_native_voxel_builder=False)]
    return cfg


def _read_csv(path):
    with open(path) as f:
        lines = [ln.rstrip("\n").split(",") for ln in f]
    return lines[0], lines[1:]


def _read_metrics(path):
    with open(path) as f:
        return {k: float(v) for k, v in
                (ln.rsplit(": ", 1) for ln in f if ln.strip())}


@pytest.mark.filterwarnings("ignore:LPIPS")
def test_harness_matches_jax_output_to_output(tmp_path, monkeypatch):
    """Two EVAID-named sequences of 8 frames at 40x56 in windows of 4
    (state carried within a sequence, reset between them), the full-width
    ETNet on the same weights, chunk_threshold forced to 16 so every
    attention takes the long-sequence route, LPIPS-Alex on the same
    trunk. Per-sequence MSE/SSIM/LPIPS, the CSV row and the PNGs agree;
    then the ckpt_paths / CSV bookkeeping."""
    for mod in (jeitr, teitr):
        monkeypatch.setattr(mod.MultiheadAttention, "chunk_threshold", 16)
    _, params = _jax_eitr()
    jl = jax_lpips("alex")
    tl = LPIPS("alex", device="cpu")
    tl.module.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, jl.params)))
    monkeypatch.setattr(JInterface, "lpips_train", property(lambda s: jl))
    monkeypatch.setattr(JInterface, "lpips_test", property(lambda s: jl))
    monkeypatch.setattr(JInterface, "init",
                        lambda s, key, b, h, w, nb=5: (params, None))
    monkeypatch.setattr(ModelInterface, "lpips_test",
                        property(lambda s: tl))

    names = []
    for i, name in enumerate(("ball", "bear")):
        names.append(make_hqf_h5(str(tmp_path / f"{name}.h5"), n_frames=9,
                                 h=40, w=56, events_per_frame=300, seed=i))
    h5_list = str(tmp_path / "evaid_test.txt")
    with open(h5_list, "w") as f:
        f.write("\n".join(names) + "\n")
    cfg = _harness_config(h5_list, "pngs")
    exp = cfg["experiment_name"]

    root_j, root_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jpath = os.path.join(root_j, "ckpt", "etnet.msgpack")
    jckpt.save_checkpoint(jpath, params, None, 0)
    jckpt.append_ckpt_path(exp, jpath, root_j)
    # a DDP-style checkpoint: `module.` prefixes, as the reference saves
    tpath = os.path.join(root_t, "ckpt", "etnet.pth")
    os.makedirs(os.path.dirname(tpath))
    sd = {f"module.{k}": v for k, v in
          jax_params_to_state_dict(params).items()}
    torch.save({"state_dict": sd}, tpath)
    checkpoint.append_ckpt_path(exp, tpath, root_t)
    assert checkpoint.last_ckpt_path(exp, root_t) == tpath

    jharness.main(copy.deepcopy(cfg), root=root_j)
    harness.main(copy.deepcopy(cfg), root=root_t, device="cpu")

    logs = lambda r: os.path.join(r, "tensorboard_logs", exp)
    want = _read_metrics(os.path.join(logs(root_j), "test_metrics.txt"))
    got = _read_metrics(os.path.join(logs(root_t), "test_metrics.txt"))
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        # predictions agree to ~1e-6; LPIPS sums 5 float32 trunk layers
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    (jhead, jrows), (thead, trows) = (
        _read_csv(os.path.join(logs(r), "all_test_results_new.csv"))
        for r in (root_j, root_t))
    assert thead == jhead and len(jrows) == len(trows) == 1
    assert trows[0][0] == "etnet.pth"
    filled = [i for i, v in enumerate(jrows[0][1:], 1) if v]
    assert len(filled) == 6
    assert [i for i, v in enumerate(trows[0][1:], 1) if v] == filled
    np.testing.assert_allclose([float(trows[0][i]) for i in filled],
                               [float(jrows[0][i]) for i in filled],
                               rtol=1e-4, atol=1e-6)
    for name in ("ball", "bear"):
        seq_dir = lambda r: os.path.join(r, "pngs", "EVAID", name)
        files = sorted(os.listdir(seq_dir(root_j)))
        assert sorted(os.listdir(seq_dir(root_t))) == files
        assert len(files) == 8
        import cv2
        for fn in files:
            a, b = (cv2.imread(os.path.join(seq_dir(r), fn), 0).astype(int)
                    for r in (root_j, root_t))
            assert np.abs(a - b).max() <= 1      # uint8 truncation

    # skip-if-done: a rerun over all checkpoints adds no row; a new
    # checkpoint adds one, and the default mode tests only the last
    csv = os.path.join(logs(root_t), "all_test_results_new.csv")
    harness.main(copy.deepcopy(cfg), test_all_pths=True, root=root_t,
                 device="cpu", max_batches=1)
    assert len(_read_csv(csv)[1]) == 1
    tpath2 = os.path.join(root_t, "ckpt", "etnet_2.pth")
    torch.save(jax_params_to_state_dict(params), tpath2)   # bare state_dict
    checkpoint.append_ckpt_path(exp, tpath2, root_t)
    assert checkpoint.all_ckpt_paths(exp, root_t) == [tpath, tpath2]
    harness.main(copy.deepcopy(cfg), root=root_t, device="cpu",
                 max_batches=1)
    rows = _read_csv(csv)[1]
    assert [r[0] for r in rows] == ["etnet.pth", "etnet_2.pth"]


def test_cli_runs_on_the_card_only(tmp_path, monkeypatch):
    """`python -m v2v_tpu_torch.cli test_e2vid cfg` reads the YAML and the
    last checkpoint path, and without a card refuses to run."""
    cfg = _etnet_config()
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    checkpoint.append_ckpt_path(cfg["experiment_name"], "missing.pth")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.test_e2vid(["test_e2vid", str(path)])
