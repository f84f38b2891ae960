"""The port's last two h5 readers (v2v_tpu_torch/data/h5.py::FPSH5Dataset
and TestH5CacheDataset) against the JAX package's on synthetic h5 files,
each field equal; FPSH5Dataset against both of JAX's voxel builders (the
numpy one and the C++ one); configs/test_evbird.yaml through the port's
`run_single_test` against JAX's on the same E2VID weights."""
import copy
import importlib.util
import os

import cv2
import h5py
import jax
import numpy as np
import pytest
import torch
import yaml

from v2v_tpu.data import h5 as jh5
from v2v_tpu.eval import harness as jharness
from v2v_tpu.models.convert import torch_state_dict_to_flax
from v2v_tpu.training.interface import ModelInterface as JInterface

from v2v_tpu_torch.config import resolve_target
from v2v_tpu_torch.data import h5 as th5
from v2v_tpu_torch.data.interface import make_concat_multi_dataset
from v2v_tpu_torch.eval import harness
from v2v_tpu_torch.training.interface import ModelInterface

from test_data import make_hqf_h5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_items(ours, theirs, atol=0.0):
    assert len(ours) == len(theirs) >= 1
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol,
                                           err_msg=k)
            else:
                assert a[k] == b[k], k


def _events_h5(path, h=18, w=24, n=3000, seed=4, gap=(0.30, 0.52)):
    """An events-only h5 (EvBird's layout): timestamps over 0.8 s with no
    event inside `gap`, so frames there are empty."""
    rng = np.random.RandomState(seed)
    ts = np.sort(rng.rand(n)) * 0.8 + 3.0
    ts = ts[(ts < 3.0 + gap[0]) | (ts >= 3.0 + gap[1])]
    with h5py.File(path, "w") as f:
        f.create_dataset("events/ts", data=ts)
        f.create_dataset("events/xs",
                         data=rng.randint(0, w, len(ts)).astype(np.uint16))
        f.create_dataset("events/ys",
                         data=rng.randint(0, h, len(ts)).astype(np.uint16))
        f.create_dataset("events/ps",
                         data=rng.randint(0, 2, len(ts)).astype(np.uint8))
    return path


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("interpolate", [False, True])
def test_fps_dataset_equals_jax(tmp_path, native, interpolate):
    """Frame borders at 25 FPS over the events' span, windows of 4 over
    total_frame_cnt - 1 frames, events only; frames inside the gap hold
    no event (zero voxels). Equal to JAX's reader with its numpy
    voxelizer, and with its C++ builder within 1e-9, the tolerance
    tests/test_native.py holds that builder to (its interpolated weights
    sum in another order)."""
    path = _events_h5(str(tmp_path / "bird.h5"))
    cfg = {"FPS": 25, "sequence_length": 4, "num_bins": 5, "H": 18,
           "W": 24, "dataset_name": "evbird", "interpolate_bins": interpolate,
           "use_native_voxel_builder": native}
    ours = th5.FPSH5Dataset(path, dict(cfg))
    theirs = jh5.FPSH5Dataset(path, dict(cfg))
    assert ours.total_frame_cnt == theirs.total_frame_cnt == 19
    assert ours.samples == theirs.samples == [(0, 4), (4, 8), (8, 12),
                                              (12, 16), (16, 18)]
    np.testing.assert_array_equal(ours.event_idx, theirs.event_idx)
    _assert_same_items(ours, theirs, atol=1e-9 if native else 0.0)
    empty = [i for i in range(ours.total_frame_cnt)
             if ours.event_idx[i] == ours.event_idx[i + 1]]
    assert empty                      # the gap's frames
    item = ours[empty[0] // 4]
    assert sorted(item) == ["data_source_idx", "events", "sequence_name"]
    assert not item["events"][empty[0] % 4].any()
    assert item["events"].shape[1:] == (18, 24, 5)


def test_fps_dataset_ignores_max_samples_as_jax_does(tmp_path):
    path = _events_h5(str(tmp_path / "bird.h5"))
    cfg = {"FPS": 25, "sequence_length": 4, "H": 18, "W": 24,
           "max_samples": 1, "use_native_voxel_builder": False}
    assert len(th5.FPSH5Dataset(path, cfg)) == len(
        jh5.FPSH5Dataset(path, cfg)) == 5


def _cache_script():
    spec = importlib.util.spec_from_file_location(
        "testh5_to_voxel_cache",
        os.path.join(ROOT, "scripts", "testh5_to_voxel_cache.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("layout", ["script", "channels_last"])
def test_cache_dataset_equals_jax(tmp_path, layout):
    """Caches of 9 frames: the one scripts/testh5_to_voxel_cache.py writes
    (frames (N,H,W), events channels-first, transposed on read) and one
    stored channels-last with frames (N,H,W,1); windows of 4 over all N
    frames (the last one short), frame_idx, equal to JAX's reader. A
    cache built with other bins or interpolation is refused."""
    src = make_hqf_h5(str(tmp_path / "seq_a.h5"), n_frames=10)
    cache = str(tmp_path / "cache" / "seq_a.h5")
    os.makedirs(os.path.dirname(cache))
    _cache_script().convert(src, cache, num_bins=5, interpolate=False)
    if layout == "channels_last":
        with h5py.File(cache, "a") as f:
            frames, events = f["frames"][()], f["events"][()]
            del f["frames"], f["events"]
            f["frames"] = frames[..., None]
            f["events"] = events.transpose(0, 2, 3, 1)
    cfg = {"sequence_length": 4, "num_bins": 5, "dataset_name": "hqf"}
    ours = th5.TestH5CacheDataset(cache, dict(cfg))
    theirs = jh5.TestH5CacheDataset(cache, dict(cfg))
    assert ours.samples == theirs.samples == [(0, 4), (4, 8), (8, 9)]
    _assert_same_items(ours, theirs)
    first = th5.TestH5Dataset(src, dict(cfg))[0]
    np.testing.assert_array_equal(ours[0]["events"], first["events"])
    np.testing.assert_array_equal(ours[0]["frame"], first["frame"])
    np.testing.assert_array_equal(ours[2]["frame_idx"], [8])
    with pytest.raises(ValueError, match="num_bins"):
        th5.TestH5CacheDataset(cache, dict(cfg, num_bins=9))
    with pytest.raises(ValueError, match="interpolate_bins"):
        th5.TestH5CacheDataset(cache, dict(cfg, interpolate_bins=True))


def test_the_aliases_build_the_readers(tmp_path):
    """The configs' class names reach the port's readers through
    make_concat_multi_dataset."""
    bird = _events_h5(str(tmp_path / "bird.h5"))
    src = make_hqf_h5(str(tmp_path / "seq_a.h5"), n_frames=6)
    cache = str(tmp_path / "cache.h5")
    _cache_script().convert(src, cache, num_bins=5, interpolate=False)
    (tmp_path / "bird.txt").write_text(bird + "\n")
    (tmp_path / "cache.txt").write_text(cache + "\n")
    ds = make_concat_multi_dataset([
        {"data_file": str(tmp_path / "bird.txt"), "FPS": 25, "H": 18,
         "W": 24, "class_name": "data.testh5.FPS_H5Dataset",
         "sequence_length": 10},
        {"data_file": str(tmp_path / "cache.txt"), "sequence_length": 10,
         "class_name": "data.testh5.TestH5CacheDataset"}])
    assert [type(d.datasets[0]) for d in ds.datasets] == [
        th5.FPSH5Dataset, th5.TestH5CacheDataset]
    assert resolve_target("data.testh5.FPS_H5Dataset") is th5.FPSH5Dataset
    assert resolve_target("data.testh5.TestH5CacheDataset") is \
        th5.TestH5CacheDataset


def test_evbird_config_through_run_test_matches_jax(tmp_path, monkeypatch):
    """configs/test_evbird.yaml (E2VID at full width on FPS_H5Dataset)
    through the port's run_single_test and JAX's, on the same weights and
    two synthetic events-only sequences, its frame size, FPS and
    sequence_length cut to the files (24x32 at 20 FPS, windows of 4, the
    state carried within a sequence and reset between them). Without
    `frame` neither harness scores anything; both write a PNG a frame,
    which agree within one grey level (uint8 truncation of predictions
    ~1e-6 apart)."""
    with open(os.path.join(ROOT, "configs", "test_evbird.yaml")) as f:
        cfg = yaml.safe_load(f)
    (test,) = cfg["test_stage"]["test"]
    assert test["class_name"] == "data.testh5.FPS_H5Dataset"
    names = [_events_h5(str(tmp_path / f"bird{i}.h5"), h=24, w=32, n=4000,
                        seed=i, gap=(0.1, 0.2)) for i in range(2)]
    (tmp_path / "evbird_test.txt").write_text("\n".join(names) + "\n")
    test.update(data_file=str(tmp_path / "evbird_test.txt"), FPS=20, H=24,
                W=32, sequence_length=4, use_native_voxel_builder=False)
    cfg["test_stage"]["test_num_workers"] = 1

    port = ModelInterface(cfg["module"], "cpu",
                          generator=torch.Generator().manual_seed(3))
    state_dict = port.model.state_dict()
    params = torch_state_dict_to_flax(state_dict)
    monkeypatch.setattr(JInterface, "init",
                        lambda s, key, b, h, w, nb=5: (params, None))
    monkeypatch.setattr(JInterface, "lpips_test", property(lambda s: None))
    monkeypatch.setattr(ModelInterface, "lpips_test",
                        property(lambda s: None))
    tpath = str(tmp_path / "e2vid.pth")
    torch.save({"state_dict": state_dict}, tpath)

    root_j, root_t = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jharness.run_single_test(None, copy.deepcopy(cfg), root=root_j)
    got = harness.run_single_test(tpath, copy.deepcopy(cfg), root=root_t,
                                  device="cpu")
    assert got == want == {}
    for i in range(2):
        seq_dir = lambda r: os.path.join(r, cfg["test_output_dir"], "EVBIRD",
                                         f"bird{i}")
        files = sorted(os.listdir(seq_dir(root_j)))
        assert sorted(os.listdir(seq_dir(root_t))) == files
        frames = th5.FPSH5Dataset(names[i], test).total_frame_cnt - 1
        assert len(files) == frames >= 9
        for fn in files:
            a, b = (cv2.imread(os.path.join(seq_dir(r), fn), 0).astype(int)
                    for r in (root_j, root_t))
            assert a.shape == (24, 32) and np.abs(a - b).max() <= 1
    assert jax.devices()[0].platform == "cpu"
