"""Seeded stand-in data in the port's dataset item contracts, for runs on
a machine that has neither the WebVid mp4 clips nor the h5 test sets (nor
cv2 and h5py to read them): `chip_smoke.py` and the training-at-scale
scripts (`scripts/soak_train.py`, `scripts/diag_rss.py`).

- `DriftingClips`: WebvidDataset's output="video" items, a drifting
  texture a clip, deterministic in (seed, index);
- `SyntheticSequence`: one in-memory sequence of TestH5Dataset (or
  TestH5FlowDataset) items, voxelized by the builder the data config
  selects: uniform random events, unrelated to its frames;
- `SimulatedSequence`: a held-out DriftingClips clip through the port's
  simulator, in TestH5Dataset's contract: events made from its frames;
- `MemoryH5` and `SyntheticH5Sequence`: an HQF-layout h5 file held in
  numpy arrays, read by the port's TestH5Dataset itself.
"""
from __future__ import annotations

import numpy as np

from ..ops.voxel import events_to_voxel_np
from .h5 import TestH5Dataset
from .native import events_to_voxel_native
from .sources import DATA_SOURCES

# the stored GT flow of a SyntheticSequence with `flow`, px a frame: its
# texture drifts 2 px left and 1 px up a frame (but where its shift wraps)
SYNTHETIC_FLOW = (-2.0, -1.0)
# DriftingClips' frames computed at once
FRAME_CHUNK = 16


class DriftingClips:
    """A seeded stand-in for the WebVid train set, in WebvidDataset's
    output="video" item contract: {"video": uint8 (N, H, W),
    "data_source_idx": int64}, N = sequence_length * num_bins *
    frames_per_bin + 1, plus num_bins * frames_per_bin leading frames
    where the config sets output_additional_evs, and H = W = crop_size of
    the data config. Each clip is a random texture drifting by a random
    sub-pixel velocity a frame, with slow brightness changes, made in
    numpy on the host from `seed` and the index, so an item is the same
    in every process and epoch: the host twin of chip_smoke.py's
    _drifting_video. It stands in for mp4 decode, which the card's
    machine cannot run (no cv2)."""

    def __init__(self, data_cfg, seed, n_items):
        self.data_cfg, self.seed, self.n_items = data_cfg, seed, n_items

    def __len__(self):
        return self.n_items

    def __getitem__(self, idx):
        c = self.data_cfg
        fpi = c["num_bins"] * c.get("frames_per_bin", 1)
        n = (c["sequence_length"] + bool(c.get("output_additional_evs"))) \
            * fpi + 1
        h = w = c["crop_size"]
        rng = np.random.default_rng((self.seed, idx))
        tex = np.pad(rng.random((2 * h, 2 * w)), 1, mode="edge")
        tex = sum(tex[i:i + 2 * h, j:j + 2 * w]
                  for i in range(3) for j in range(3)) / 9.0
        tex = np.clip((tex - 0.5) * 3.0 + 0.5, 0.0, 1.0) * 255.0
        vel = (rng.random(2) - 0.5) * 2.0
        pad = int(np.ceil(n * np.abs(vel).max())) + 2
        tex = np.pad(tex, pad, mode="reflect")
        frames = np.empty((n, h, w), np.float32)
        rows, cols = np.arange(h + 1), np.arange(w + 1)
        # FRAME_CHUNK frames at a time, each a bilinear sample of the
        # texture at its offset: large numpy operations, which release
        # the GIL, so the loader's threads run in parallel (a loop over
        # frames held it, and the flagship's 12 clips took ~0.8 s a batch
        # on any number of threads); the same float64 arithmetic as a
        # frame at a time, so the same bits
        for s in range(0, n, FRAME_CHUNK):
            t = np.arange(s, min(n, s + FRAME_CHUNK))
            oy = t * vel[0] + (h / 2 + pad)
            ox = t * vel[1] + (w / 2 + pad)
            iy, ix = np.floor(oy).astype(np.int64), np.floor(ox).astype(
                np.int64)
            fy, fx = (oy - iy)[:, None, None], (ox - ix)[:, None, None]
            a = tex[(iy[:, None] + rows)[:, :, None],
                    (ix[:, None] + cols)[:, None, :]]
            f = ((1 - fy) * ((1 - fx) * a[:, :-1, :-1] + fx * a[:, :-1, 1:])
                 + fy * ((1 - fx) * a[:, 1:, :-1] + fx * a[:, 1:, 1:]))
            gain = np.array([1.0 + 0.3 * np.sin(i / 17.0 + idx) for i in t])
            frames[s:s + len(t)] = f * gain[:, None, None]
        return {"data_source_idx": np.int64(DATA_SOURCES.index(
                    c["data_source_name"])),
                "video": np.clip(frames, 0, 255).round().astype(np.uint8)}


class SyntheticSequence:
    """One sequence of `frames` frames held in memory, in the sample
    contract of TestH5Dataset (frame (T,H,W,1) in [0,255], or [0,1] where
    the data config's image_range is 1, events
    (T,H,W,bins)): a drifting texture as GT and uniform random events at
    a fixed rate, both from numpy with `seed`, voxelized on the host with
    the data config's settings by the builder it selects, as the port's
    TestH5Dataset does: the C++ builder unless use_native_voxel_builder
    is false, then events_to_voxel_np. Where
    the config sets output_additional_frame, T+1 frames lead by the one
    before the first events; where it sets output_additional_evs, T+1
    event groups lead by the one before. With `flow`, the layout of
    TestH5FlowDataset: a stored GT flow (T,H,W,2) of SYNTHETIC_FLOW at
    every pixel. It stands in for an h5 file: the card's machine has no
    h5py."""

    def __init__(self, name, seed, frames, hw, events_per_frame, data_cfg,
                 flow=False):
        self.name, self.seed, self.frames, self.hw = name, seed, frames, hw
        self.events_per_frame = events_per_frame
        self.data_cfg = data_cfg
        self.flow = flow

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        voxelize = (events_to_voxel_native if self.data_cfg.get(
            "use_native_voxel_builder", True) else events_to_voxel_np)
        rng = np.random.default_rng(self.seed)
        h, w = self.hw
        cell = 16
        coarse = rng.random((h // cell + 2, w // cell + 2)) * 255.0
        texture = np.kron(coarse, np.ones((cell, cell)))
        extra = 1 if self.data_cfg.get("output_additional_frame") else 0
        extra_evs = 1 if self.data_cfg.get("output_additional_evs") else 0
        frames, voxels = [], []
        for t in range(self.frames + extra):
            dy, dx = t % cell, (2 * t) % cell
            frames.append(texture[dy:dy + h, dx:dx + w])
        for t in range(-extra_evs, self.frames):
            n = self.events_per_frame
            ts = np.sort(rng.uniform(t / 30.0, (t + 1) / 30.0, n))
            voxels.append(voxelize(
                ts, rng.integers(0, w, n), rng.integers(0, h, n),
                rng.integers(0, 2, n).astype(np.uint8),
                num_bins=self.data_cfg["num_bins"], height=h, width=w,
                interpolate_bins=self.data_cfg["interpolate_bins"]))
        scale = 255.0 if self.data_cfg.get("image_range", 255) == 1 else 1.0
        item = {
            "frame": (np.stack(frames)[..., None] / scale).astype(np.float32),
            "events": np.stack(voxels).transpose(0, 2, 3, 1).astype(
                np.float32),
            "data_source_idx": np.int64(DATA_SOURCES.index(
                self.data_cfg["dataset_name"])),
            "sequence_name": self.name,
            "frame_idx": np.arange(self.frames, dtype=np.int64),
        }
        if self.flow:
            item["flow"] = np.broadcast_to(np.asarray(
                SYNTHETIC_FLOW, np.float32), (self.frames, h, w, 2)).copy()
        else:
            item["real_begin_idx"] = np.zeros((self.frames,), np.int64)
        return item


class SimulatedSequence:
    """One held-out DriftingClips clip (index `idx` of `seed`) through
    the port's simulator (training/steps.py::synthesize_batch on the
    host, with the train set's simulator settings and a generator seeded
    with `seed`), in TestH5Dataset's sample contract: frame (T,H,W,1) in
    [0, 1] and events (T,H,W,bins), T = `frames`. Its events are its
    frames' own, so a model trained on DriftingClips can learn to
    reconstruct it: the soak's fixed probe clip. Made once, then kept."""

    def __init__(self, name, data_cfg, seed, idx, frames, dataset_name):
        self.name, self.seed, self.idx = name, seed, idx
        self.data_cfg = dict(data_cfg, sequence_length=frames)
        self.dataset_name = dataset_name
        self._item = None

    def __len__(self):
        return 1

    def __getitem__(self, i):
        if self._item is None:
            self._item = self._make()
        return self._item

    def _make(self):
        import torch
        from ..training.steps import synthesize_batch
        from ..training.train import sim_config_from_dataset
        c = self.data_cfg
        video = DriftingClips(c, self.seed, self.idx + 1)[self.idx]["video"]
        events, frames = synthesize_batch(
            torch.from_numpy(video)[None],
            torch.Generator().manual_seed(self.seed),
            sim_config_from_dataset(c), c["num_bins"],
            c.get("frames_per_bin", 1))
        t = c["sequence_length"]
        return {"frame": frames[0].numpy(), "events": events[0].numpy(),
                "data_source_idx": np.int64(DATA_SOURCES.index(
                    self.dataset_name)),
                "sequence_name": self.name,
                "frame_idx": np.arange(t, dtype=np.int64),
                "real_begin_idx": np.zeros((t,), np.int64)}


def synthetic_hqf(seed, frames, hw, events_per_frame):
    """The datasets of an HQF-layout h5, from numpy with `seed`: `frames`
    uint8 images of a drifting texture (`images`, (N, H, W)), their
    `event_idx`, and `events_per_frame` uniform random events between
    each two (`ts` float64 seconds, stamped from 1.6e9 at 30 frames a
    second as raw captures are; `xs`, `ys` uint16; `ps` uint8 in {0, 1})."""
    rng = np.random.default_rng(seed)
    h, w = hw
    cell = 16
    coarse = rng.integers(0, 256, (h // cell + 2, w // cell + 2))
    texture = np.kron(coarse, np.ones((cell, cell), np.int64))
    images = np.stack([texture[t % cell:t % cell + h,
                               2 * t % cell:2 * t % cell + w]
                       for t in range(frames)]).astype(np.uint8)
    n = events_per_frame * (frames - 1)
    window = np.repeat(np.arange(frames - 1), events_per_frame)
    return {
        "images": images,
        "event_idx": np.arange(frames, dtype=np.int64) * events_per_frame,
        "ts": 1.6e9 + (window + np.sort(rng.random(n).reshape(
            frames - 1, events_per_frame), axis=1).ravel()) / 30.0,
        "xs": rng.integers(0, w, n).astype(np.uint16),
        "ys": rng.integers(0, h, n).astype(np.uint16),
        "ps": rng.integers(0, 2, n).astype(np.uint8),
    }


class _Image:
    """An image dataset: `[()]`, `shape` and attrs["event_idx"]."""

    def __init__(self, data, event_idx):
        self.data, self.shape = data, data.shape
        self.attrs = {"event_idx": event_idx}

    def __getitem__(self, key):
        return self.data[key]


class MemoryH5:
    """The arrays of `synthetic_hqf` behind the part of h5py's File that
    TestH5Dataset reads: `f["images"]` (keys `imageNNNNNNNNN`, each an
    image with attrs["event_idx"]) and `f["events/<name>"]` slices. A
    context manager, as h5py.File is. It stands in for an h5 file where
    there is no h5py."""

    def __init__(self, arrays):
        self.arrays = arrays
        self.images = {f"image{i:09d}": _Image(img, int(e))
                       for i, (img, e) in enumerate(
                           zip(arrays["images"], arrays["event_idx"]))}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getitem__(self, key):
        if key == "images":
            return self.images
        group, name = key.split("/")
        if group != "events":
            raise KeyError(key)
        return self.arrays[name]


class SyntheticH5Sequence(TestH5Dataset):
    """The port's TestH5Dataset over a MemoryH5 of `synthetic_hqf(seed,
    frames, hw, events_per_frame)`, named `name`: its windows, its frames
    and its voxels (the C++ builder unless the config sets
    use_native_voxel_builder false), all from TestH5Dataset's own code."""

    def __init__(self, name, seed, frames, hw, events_per_frame, configs):
        self.file = MemoryH5(synthetic_hqf(seed, frames, hw,
                                           events_per_frame))
        super().__init__(f"{name}.h5", configs)

    def _open(self):
        return self.file
