"""The port's WebVid feed against the JAX package's: WebvidDataset items
bit for bit at fixed_seed (the same draws in the same order from the
same seed), the sample enumeration, the shuffled loader order, thread
and process workers, and chip_smoke.py's stand-in clips against the item
contract."""
import numpy as np
import pytest

from v2v_tpu.data.interface import DataLoader as JDataLoader
from v2v_tpu.data.webvid import WebvidDataset as JWebvid
from v2v_tpu.ops.voxel import esim_video_to_voxel_np as j_esim_video_to_voxel_np

from v2v_tpu_torch.config import resolve_target
from v2v_tpu_torch.data.interface import ConcatDataset, DataLoader
from v2v_tpu_torch.data.webvid import WebvidDataset
from v2v_tpu_torch.ops.voxel import esim_video_to_voxel_np

import chip_smoke
from test_data import _write_video


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two 64-frame 80x100 mp4 clips and their list, with per-video
    thresholds in the optional columns."""
    root = tmp_path_factory.mktemp("webvid")
    n0 = _write_video(str(root / "a.mp4"), seed=0)
    n1 = _write_video(str(root / "b.mp4"), seed=1)
    listing = root / "list.txt"
    listing.write_text(f"a.mp4 {n0} 0.25 0.5\nb.mp4 {n1} 0.3 0.6\n")
    return str(root), str(listing)


def _cfg(listing, **kw):
    """Pause probabilities raised so that the chain pauses and resumes
    within a 11-frame sample."""
    cfg = {"video_list_file": listing, "sequence_length": 2, "num_bins": 5,
           "crop_size": 32, "data_source_name": "webvid",
           "max_samples_per_shot": 3, "fixed_seed": 7,
           "proba_pause_when_running": 0.3, "proba_pause_when_paused": 0.5,
           "random_flip": False}
    cfg.update(kw)
    return cfg


CASES = {
    "plain": {},
    "shake": {"shake_frames": 6, "shake_std": 1.5},
    "random_flip": {"random_flip": True},
    "fixed_thresholds": {"use_fixed_thresholds": True},
    "subtitles": {"video_degrade": "subtitles", "degrade_ratio": 1},
    "dirtyshotcut": {"video_degrade": "dirtyshotcut", "degrade_ratio": 1},
    "hdr": {"video_degrade": "hdr", "degrade_ratio": 1},
    "ldr": {"video_degrade": "ldr", "degrade_ratio": 1},
    "gray_in_bgr_out": {"color_mode": "gray_in_bgr_out"},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_items_equal_jax_at_fixed_seed(clips, case):
    root, listing = clips
    cfg = _cfg(listing, **CASES[case])
    jds, tds = JWebvid(root, cfg), WebvidDataset(root, cfg)
    assert len(tds) == len(jds) == 6
    for i in range(len(tds)):
        want, got = jds[i], tds[i]
        assert sorted(got) == sorted(want), (case, i)
        for k, v in want.items():
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, (case, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"{case} {k}")
    if case == "fixed_thresholds":
        assert float(tds[3]["pos_thres"]) == np.float32(0.3)


def test_degrade_changes_the_clip(clips):
    """Each degradation at ratio 1 changes what the plain item holds, so
    the equalities above compare degraded clips."""
    root, listing = clips
    plain = WebvidDataset(root, _cfg(listing))[0]["video"]
    for mode in ("subtitles", "dirtyshotcut", "hdr", "ldr"):
        got = WebvidDataset(root, _cfg(listing, video_degrade=mode,
                                       degrade_ratio=1))[0]["video"]
        assert got.shape == plain.shape and not np.array_equal(got, plain), \
            mode


@pytest.mark.parametrize("kw", [
    {}, {"step_size": 7}, {"step_size": 3, "max_samples_per_shot": 20},
    {"max_samples_per_shot": 20, "subsample_ratio": 0.5},
    {"sequence_length": 4, "output_additional_evs": True,
     "max_samples_per_shot": 5}])
def test_sample_enumeration_matches_jax(clips, kw):
    root, listing = clips
    cfg = _cfg(listing, **kw)
    jds, tds = JWebvid(root, cfg), WebvidDataset(root, cfg)
    assert len(tds) == len(jds)
    assert [s[0] for s in tds.samples] == jds.sample_video_name
    assert [s[1] for s in tds.samples] == jds.sample_begin_idx
    assert [s[2] for s in tds.samples] == jds.sample_pos_thres
    assert [s[3] for s in tds.samples] == jds.sample_neg_thres


VOXEL_CASES = {
    "sampled": {},
    "fixed_thresholds": {"use_fixed_thresholds": True},
    "scaled_noise": {"scale_noise_strength": True,
                     "base_noise_std_range": [0.1, 0.3],
                     "hot_pixel_fraction_range": [0.05, 0.2]},
    "noise_external": {"put_noise_external": True,
                       "max_thres_pos_neg_gap": 3.0},
    "frames_per_bin": {"frames_per_bin": 2, "output_additional_frame": True},
    "additional_evs": {"output_additional_evs": True, "shake_frames": 4,
                       "shake_std": 1.0},
    "gray_in_bgr_out": {"color_mode": "gray_in_bgr_out",
                        "use_fixed_thresholds": True},
}


@pytest.mark.parametrize("case", sorted(VOXEL_CASES))
def test_voxel_items_equal_jax_at_fixed_seed(clips, case):
    """output="voxel": the thresholds (the video's pair, or drawn with
    the gap and the coin), the noise stds, the numpy emulator's draws,
    the frames_per_bin sums and the GT frames, bit for bit."""
    root, listing = clips
    cfg = _cfg(listing, output="voxel", **VOXEL_CASES[case])
    jds, tds = JWebvid(root, cfg), WebvidDataset(root, cfg)
    assert len(tds) == len(jds) >= 2
    for i in (0, len(tds) - 1):
        want, got = jds[i], tds[i]
        assert sorted(got) == sorted(want), (case, i)
        assert got["v2e_params"] == want["v2e_params"], (case, i)
        for k, v in want.items():
            if k == "v2e_params":
                continue
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, (case, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"{case} {k}")
        fpb = cfg.get("frames_per_bin", 1)
        extra = (cfg.get("output_additional_evs", False),
                 cfg.get("output_additional_frame", False))
        assert got["events"].shape == (2 + extra[0], 32, 32, 5)
        assert got["frame"].shape[:3] == (2 + extra[1], 32, 32)
        assert np.abs(got["events"]).sum() > 0
        assert fpb == 1 or np.abs(got["events"]).max() >= 1


@pytest.mark.parametrize("external", [False, True])
def test_esim_video_to_voxel_np_equals_jax(external):
    """The numpy emulator without an rng draws from the global np.random
    in JAX's order: equal counts after the same np.random.seed."""
    video = np.random.RandomState(5).randint(0, 256, (9, 12, 10)).astype(
        np.float32)
    args = (video, 0.3, 0.45, 0.1, 0.05, 0.2, external)
    np.random.seed(11)
    want = j_esim_video_to_voxel_np(*args)
    np.random.seed(11)
    got = esim_video_to_voxel_np(*args)
    assert got.shape == (8, 12, 10) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).sum() > 0


def test_voxel_output_not_ported(clips):
    """output="voxel" is ported now (above); an output of another name
    is refused."""
    root, listing = clips
    assert WebvidDataset(root, _cfg(listing, output="voxel")).voxel_output
    assert WebvidDataset(root, _cfg(listing)).voxel_output is None
    with pytest.raises(ValueError, match="output"):
        WebvidDataset(root, _cfg(listing, output="frames"))


def test_config_alias_resolves():
    assert resolve_target("data.v2v_datasets.WebvidDatasetV2") is \
        WebvidDataset


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i)}


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_shuffled_order_matches_jax(shard):
    """Epochs 0-2, drop_last: the same batches of indices, per process
    shard."""
    kw = dict(shuffle=True, drop_last=True, num_workers=1, seed=5,
              process_index=shard[0], process_count=shard[1])
    jl, tl = JDataLoader(_Indexed(23), 3, **kw), DataLoader(_Indexed(23), 3,
                                                            **kw)
    orders = []
    for epoch in range(3):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        want = [b["i"].tolist() for b in jl]
        got = [b["i"].tolist() for b in tl]
        assert got == want and len(tl) == len(jl) == len(got)
        orders.append(got)
    assert orders[0] != orders[1] != orders[2]


def test_unshuffled_loader_keeps_order_and_tail():
    """The eval harness's call (no shuffle, the last partial batch)."""
    batches = [b["i"].tolist()
               for b in DataLoader(_Indexed(7), 3, num_workers=2)]
    assert batches == [[0, 1, 2], [3, 4, 5], [6]]


def test_thread_and_process_workers_give_the_same_batches(clips):
    """Without fixed_seed the items draw from the loader's per-epoch seed:
    serial, thread and spawned process workers give equal batches, and
    another epoch gives other draws."""
    root, listing = clips
    cfg = _cfg(listing, random_flip=True, shake_frames=3, shake_std=1.0)
    del cfg["fixed_seed"]
    ds = ConcatDataset([WebvidDataset(root, cfg), WebvidDataset(root, cfg)])

    def run(epoch, **kw):
        loader = DataLoader(ds, 4, shuffle=True, drop_last=True, **kw)
        loader.set_epoch(epoch)
        return list(loader)

    serial = run(1, num_workers=1)
    assert len(serial) == 3
    for kw in ({"num_workers": 3}, {"num_workers": 2,
                                   "worker_type": "process"}):
        got = run(1, **kw)
        assert len(got) == len(serial)
        for g, s in zip(got, serial):
            assert sorted(g) == sorted(s)
            for k in s:
                np.testing.assert_array_equal(g[k], s[k], err_msg=str(kw))
    other = run(2, num_workers=1)
    assert not all(np.array_equal(a["video"], b["video"])
                   for a, b in zip(other, serial))
    # the two members of the concat draw from their own streams
    ds.set_epoch(0)
    a, b = ds[0], ds[6]
    assert not np.array_equal(a["video"], b["video"])


def test_chip_smoke_stand_in_keeps_the_item_contract(clips):
    """chip_smoke.py's _DriftingClips item has a port item's keys, dtypes
    and shapes at the same sequence_length and crop."""
    root, listing = clips
    cfg = _cfg(listing)
    want = WebvidDataset(root, cfg)[0]
    got = chip_smoke._DriftingClips(cfg, 0, 4)[3]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
    video = got["video"].astype(np.float32)
    assert video.std() > 10 and np.abs(np.diff(video, axis=0)).mean() > 1
