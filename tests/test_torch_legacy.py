"""The port's legacy datasets and augmentations (v2v_tpu_torch/data/
legacy.py, data/augmentation.py) and its esim_to_voxel script against
the JAX package's: each transform after the same `random.seed`, and
DynamicH5Dataset, MemMapDataset and SequenceDataset items bit for bit at
the same global seeds, for the three voxel methods, split polarity and
filter_hot_events; the script's cache against JAX's
scripts/esim_to_voxel.py::convert on one synthetic ESIM h5."""
import importlib.util
import os
import random

import h5py
import numpy as np
import pytest

from v2v_tpu.data import augmentation as jaug
from v2v_tpu.data import legacy as jleg

from v2v_tpu_torch.data import augmentation as taug
from v2v_tpu_torch.data import legacy as tleg
from v2v_tpu_torch.scripts import esim_to_voxel

import chip_smoke
from test_legacy_scripts import make_monash_h5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRANSFORMS = {
    "CenterCrop": ({"size": 9}, {"size": (9, 7),
                                 "preserve_mosaicing_pattern": True}),
    "RandomCrop": ({"size": 9}, {"size": (12, 7),
                                 "preserve_mosaicing_pattern": True}),
    "RandomFlip": ({}, {"p_hflip": 0.9, "p_vflip": 0.2}),
    "RandomRotationFlip": ({"degrees": 20}, {"degrees": (-5, 30),
                                             "p_hflip": 0.8}),
    "RobustNorm": ({}, {"low_perc": 5, "top_perc": 90}),
    "LegacyNorm": ({}, {}),
}


def _same(got, want):
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_augmentations_equal_jax_after_the_same_seed(name):
    """Each transform with two option sets, on a voxel and on a flow
    (is_flow), from the same `random.seed`, as the datasets re-seed
    before each tensor; Compose of all of them. Equal arrays, and the
    same draws left in the stream after."""
    rng = np.random.RandomState(0)
    vox = rng.randn(12, 10, 3).astype(np.float32)
    vox[vox < -1] = 0
    flow = rng.randn(12, 10, 2).astype(np.float32)
    for kw in TRANSFORMS[name]:
        for x, is_flow in ((vox, False), (flow, True)):
            for seed in range(4):
                random.seed(seed)
                want = getattr(jaug, name)(**kw)(x, is_flow)
                after = random.random()
                random.seed(seed)
                got = getattr(taug, name)(**kw)(x, is_flow)
                _same(got, want)
                assert random.random() == after
    seq = [("RandomCrop", {"size": 8}), ("RandomRotationFlip",
                                         {"degrees": 10}),
           ("RandomFlip", {}), ("LegacyNorm", {})]
    random.seed(9)
    want = jaug.Compose([getattr(jaug, n)(**k) for n, k in seq])(flow, True)
    random.seed(9)
    _same(taug.Compose([getattr(taug, n)(**k) for n, k in seq])(flow, True),
          want)


def test_voxel_noise_and_hot_pixels_equal_jax():
    vox = np.random.RandomState(1).randn(6, 8, 5).astype(np.float32)
    for frac in (0.1, 1.0):
        np.random.seed(3)
        want = jaug.add_noise_to_voxel(vox, 0.5, frac)
        np.random.seed(3)
        _same(taug.add_noise_to_voxel(vox, 0.5, frac), want)
    seqs = []
    for mod in (jaug, taug):
        random.seed(4)
        np.random.seed(4)
        seq = [{"events": vox.copy()} for _ in range(3)]
        mod.add_hot_pixels_to_sequence_(seq, 2.0, 0.2)
        seqs.append(seq)
    for got, want in zip(*seqs[::-1]):
        _same(got["events"], want["events"])
    assert not np.array_equal(seqs[1][0]["events"], vox)


def _same_item(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        _same(got[k], v)


def _items(ds, jds, seed, n=None):
    """Each item of both datasets at the same seeds."""
    assert len(ds) == len(jds) >= 1
    for i in range(len(ds) if n is None else n):
        random.seed(seed + i)
        np.random.seed(seed + i)
        want = jds[i]
        random.seed(seed + i)
        np.random.seed(seed + i)
        yield ds[i], want


METHODS = {
    "between_frames": {"method": "between_frames"},
    "k_events": {"method": "k_events", "k": 300, "sliding_window_w": 100},
    "t_seconds": {"method": "t_seconds", "t": 0.2,
                  "sliding_window_t": 0.05},
}


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("split", [False, True])
def test_dynamic_h5_items_equal_jax(tmp_path, method, split):
    """DynamicH5Dataset on a Monash-format h5 with flow: each voxel
    method, combined or split polarity, temporal-bilinear bins, hot
    events filtered, random crop, flip and RobustNorm (then the frames
    and flow take the crop and flip only)."""
    path = make_monash_h5(str(tmp_path / "m.h5"), n_frames=6)
    kw = dict(voxel_method=METHODS[method], combined_voxel_channels=not split,
              filter_hot_events=True, temporal_bilinear=not split,
              transforms={"RandomCrop": {"size": 16}, "RandomFlip": {},
                          "RobustNorm": {}})
    ds, jds = tleg.DynamicH5Dataset(path, **kw), jleg.DynamicH5Dataset(
        path, **kw)
    np.testing.assert_array_equal(ds.hot_events_mask, jds.hot_events_mask)
    assert not ds.hot_events_mask.all()
    assert ds.event_indices == jds.event_indices
    for got, want in _items(ds, jds, 10):
        _same_item(got, want)
        assert got["events"].shape[-1] == (10 if split else 5)


@pytest.fixture(scope="module")
def memmap_root(tmp_path_factory):
    """chip_smoke's MVSEC-like memmap recording, at 24x32: 12 frames,
    6,000 events, optic flow."""
    root = str(tmp_path_factory.mktemp("memmap"))
    chip_smoke._write_memmap(root, seed=0, hw=(24, 32), frames=12,
                             n_events=6_000)
    return root


@pytest.mark.parametrize("method", sorted(METHODS))
def test_memmap_items_equal_jax(memmap_root, method):
    kw = dict(voxel_method=METHODS[method], filter_hot_events=True,
              transforms={"CenterCrop": {"size": 20},
                          "RandomRotationFlip": {"degrees": 15},
                          "LegacyNorm": {}})
    ds = tleg.MemMapDataset(memmap_root, **kw)
    jds = jleg.MemMapDataset(memmap_root, **kw)
    assert ds.has_flow and ds.sensor_resolution == (24, 32)
    for got, want in _items(ds, jds, 20):
        _same_item(got, want)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_sequence_items_equal_jax(memmap_root, method):
    """SequenceDataset over the memmap recording: a pause chain that
    pauses and resumes, voxel noise, hot pixels and the image
    normalization (between_frames, whose items hold frames), every item
    of every sequence equal."""
    kw = dict(sequence_length=4, step_size=2, proba_pause_when_running=0.3,
              proba_pause_when_paused=0.5,
              normalize_image=method == "between_frames",
              noise_kwargs={"noise_std": 0.1, "noise_fraction": 0.2},
              hot_pixel_kwargs={"hot_pixel_std": 1.0,
                                "max_hot_pixel_fraction": 0.05},
              dataset_kwargs={"voxel_method": METHODS[method],
                              "transforms": {"RandomCrop": {"size": 16},
                                             "RandomFlip": {}}})
    seq, jseq = (tleg.SequenceDataset(memmap_root, **kw),
                 jleg.SequenceDataset(memmap_root, **kw))
    for got, want in _items(seq, jseq, 30):
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            _same_item(g, w)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_esim_to_voxel", os.path.join(ROOT, "scripts", "esim_to_voxel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("bilinear", [True, False])
def test_esim_to_voxel_equals_jax(tmp_path, bilinear):
    src = make_monash_h5(str(tmp_path / "in.h5"), n_frames=5)
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    esim_to_voxel.convert(src, ours, bilinear)
    _jax_script().convert(src, theirs, bilinear)
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        assert sorted(a) == sorted(b) == ["dt", "events", "flow", "frames",
                                          "timestamps"]
        assert sorted(a.attrs) == sorted(b.attrs)
        for k in a.attrs:
            np.testing.assert_array_equal(a.attrs[k], b.attrs[k])
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k][()], b[k][()], err_msg=k)
        assert a["events"].shape == (4, 5, 20, 24)
    out = tmp_path / "out"
    esim_to_voxel.main([str(tmp_path / "in.h5"), str(out), "--discrete"])
    assert os.listdir(out) == ["in.h5"]
