"""The h5 test datasets (port of v2v_tpu/data/h5.py::TestH5Dataset,
TestH5FlowDataset, TestH5EventDataset, TestH5CacheDataset and
FPSH5Dataset; reference data/testh5.py:14-519).

HQF-format h5 files: `images/imageNNNNNNNNN` datasets whose
attrs["event_idx"] point into `events/{ts,xs,ys,ps}`, cut into
fixed-length streaming samples. Voxels come from the port's C++
builder (data/native.py), as the JAX package's readers take theirs by
default; `use_native_voxel_builder: false` selects the numpy voxelizer
`events_to_voxel_np`, the reference's operations (the same bits for
discrete bins, within 1e-9 for bilinear ones). `h5py` is imported where
a file is opened.

Samples are channels-last: frame (T,H,W,1), events (T,H,W,bins), flow
(T,H,W,2).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np

from ..ops.voxel import events_to_voxel_np
from .native import events_to_voxel_native
from .sources import DATA_SOURCES


def _plain_windows(total: int, length: int) -> List[Tuple[int, int]]:
    """(begin, end): windows of `length` steps over `total` - 1, without
    warm-up."""
    return [(i, min(total - 1, i + length))
            for i in range(0, total - 1, length)]


class TestH5Dataset:
    """Per-frame voxels + GT frames from an HQF-format h5."""

    default_name = "hqf"

    def __init__(self, h5_path: str, configs: Dict[str, Any]):
        self.h5_path = h5_path
        self.sequence_name = os.path.basename(h5_path).split(".")[0]
        self.dataset_name = configs.get("dataset_name", self.default_name)
        self.sequence_length = configs.get("sequence_length", 40)
        self.warm_up_length = configs.get("warm_up_length", 0)
        self.num_bins = configs.get("num_bins", 5)
        self.interpolate_bins = configs.get("interpolate_bins", False)
        self.image_range = configs.get("image_range", 255)
        assert self.image_range in (255, 1)
        self.output_additional_frame = configs.get("output_additional_frame",
                                                   False)
        self.output_additional_evs = configs.get("output_additional_evs",
                                                 False)
        self.use_native = configs.get("use_native_voxel_builder", True)
        with self._open() as f:
            self._read_index(f)
        self.samples = self._windows()
        max_samples = configs.get("max_samples")
        if max_samples is not None:
            self.samples = self.samples[:max_samples]

    def _read_index(self, f) -> None:
        self.img_keys = sorted(f["images"].keys())
        self.total_frame_cnt = len(self.img_keys)
        self.H, self.W = f["images"][self.img_keys[0]].shape[:2]

    def _windows(self) -> List[Tuple[int, int, int]]:
        """(begin, real_start_offset, end): windows of sequence_length
        inputs stepping by (L - warm_up) (data/testh5.py:41-49)."""
        samples = []
        step = self.sequence_length - self.warm_up_length
        for i in range(0, self.total_frame_cnt - 1, step):
            begin = max(0, i - self.warm_up_length)
            end = min(self.total_frame_cnt - 1, begin + self.sequence_length)
            samples.append((begin, i - begin, end))
        return samples

    def _open(self):
        import h5py
        return h5py.File(self.h5_path, "r")

    def __len__(self) -> int:
        return len(self.samples)

    def _voxel(self, f, i0: int, i1: int) -> np.ndarray:
        voxelize = (events_to_voxel_native if self.use_native
                    else events_to_voxel_np)
        return voxelize(
            f["events/ts"][i0:i1], f["events/xs"][i0:i1],
            f["events/ys"][i0:i1], f["events/ps"][i0:i1],
            num_bins=self.num_bins, height=self.H, width=self.W,
            interpolate_bins=self.interpolate_bins)

    def _event_idx(self, f, img_idx: int) -> int:
        return f["images"][self.img_keys[img_idx]].attrs["event_idx"]

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        begin, real_begin, end = self.samples[idx]
        frames, voxels = [], []
        with self._open() as f:
            for img_idx in range(begin, end):
                img = f["images"][self.img_keys[img_idx + 1]][()]
                frames.append(np.asarray(img, np.float32))
                voxels.append(self._voxel(f, self._event_idx(f, img_idx),
                                          self._event_idx(f, img_idx + 1)))
            if self.output_additional_frame:
                frames.insert(0, np.asarray(
                    f["images"][self.img_keys[begin]][()], np.float32))
            if self.output_additional_evs:
                voxels.insert(0, self._voxel(
                    f, self._event_idx(f, max(0, begin - 1)),
                    self._event_idx(f, begin)))

        all_frames = np.stack(frames)[..., None]          # (T,H,W,1)
        if self.image_range == 1:
            all_frames = all_frames / 255.0
        t = end - begin
        # no "flow" key, as the reference drops it (testh5.py:122,166-173)
        return {
            "frame": all_frames.astype(np.float32),
            "events": np.stack(voxels).transpose(0, 2, 3, 1).astype(
                np.float32),                               # (T,H,W,bins)
            "data_source_idx": np.int64(DATA_SOURCES.index(
                self.dataset_name.lower())),
            "sequence_name": self.sequence_name,
            "real_begin_idx": np.full((t,), real_begin, np.int64),
            "frame_idx": np.arange(begin, end, dtype=np.int64),
        }


class TestH5FlowDataset(TestH5Dataset):
    """MVSEC-style flow h5: `flow/*` datasets (each (2,H,W) or (H,W,2),
    with attrs["event_idx"] and attrs["image_idx"]) drive the samples,
    windows of sequence_length flows; a sample's events are sliced
    between consecutive flow timestamps and its frames are the images
    the flows point at."""

    default_name = "mvsec"

    def _read_index(self, f) -> None:
        super()._read_index(f)
        self.flow_keys = sorted(f["flow"].keys())
        self.total_frame_cnt = len(self.flow_keys)

    def _windows(self) -> List[Tuple[int, int]]:
        """(begin, end) flow indices: windows of sequence_length flows,
        without warm-up."""
        return _plain_windows(self.total_frame_cnt, self.sequence_length)

    def _image(self, f, img_idx: int) -> np.ndarray:
        return np.asarray(f["images"][self.img_keys[img_idx]][()],
                          np.float32)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        begin, end = self.samples[idx]
        frames, voxels, flows, frame_idxs = [], [], [], []
        with self._open() as f:
            flow = f["flow"]
            for flow_idx in range(begin, end):
                item = flow[self.flow_keys[flow_idx + 1]]
                prev = flow[self.flow_keys[flow_idx]]
                img_idx = min(int(item.attrs["image_idx"]),
                              len(self.img_keys) - 1)
                frames.append(self._image(f, img_idx))
                voxels.append(self._voxel(f, prev.attrs["event_idx"],
                                          item.attrs["event_idx"]))
                flows.append(np.asarray(item[()], np.float32))
                frame_idxs.append(img_idx)
            if self.output_additional_frame:
                frames.insert(0, self._image(
                    f, int(flow[self.flow_keys[begin]].attrs["image_idx"])))
            if self.output_additional_evs:
                voxels.insert(0, self._voxel(
                    f, flow[self.flow_keys[max(0, begin - 1)]].attrs[
                        "event_idx"],
                    flow[self.flow_keys[begin]].attrs["event_idx"]))

        all_frames = np.stack(frames)[..., None]
        if self.image_range == 1:
            all_frames = all_frames / 255.0
        all_flow = np.stack(flows)
        if all_flow.shape[1] == 2:             # the reference's (2,H,W)
            all_flow = all_flow.transpose(0, 2, 3, 1)
        return {
            "frame": all_frames.astype(np.float32),
            "events": np.stack(voxels).transpose(0, 2, 3, 1).astype(
                np.float32),
            "flow": all_flow.astype(np.float32),
            "data_source_idx": np.int64(DATA_SOURCES.index(
                self.dataset_name.lower())),
            "sequence_name": self.sequence_name,
            "frame_idx": np.asarray(frame_idxs, np.int64),
        }


class TestH5EventDataset(TestH5Dataset):
    """Raw event streams a frame window instead of voxels, for NerNet,
    which voxelizes inside the model (reference data/testh5.py:305-380):
    "events" is a list of T float64 (N,5) arrays [x, y, t, 2p-1, 0], an
    empty window one zero row. The timestamps stay float64: float32 would
    collapse their deltas."""

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        begin, real_begin, end = self.samples[idx]
        frames, events = [], []
        with self._open() as f:
            for img_idx in range(begin, end):
                img = f["images"][self.img_keys[img_idx + 1]][()]
                frames.append(np.asarray(img, np.float32))
                i0 = self._event_idx(f, img_idx)
                i1 = self._event_idx(f, img_idx + 1)
                evs = np.stack([
                    f["events/xs"][i0:i1].astype(np.float64),
                    f["events/ys"][i0:i1].astype(np.float64),
                    f["events/ts"][i0:i1].astype(np.float64),
                    f["events/ps"][i0:i1].astype(np.float64) * 2 - 1,
                    np.zeros(i1 - i0, np.float64)], axis=1)
                events.append(evs if len(evs) else np.zeros((1, 5)))
            if self.output_additional_frame:
                frames.insert(0, np.asarray(
                    f["images"][self.img_keys[begin]][()], np.float32))
        all_frames = np.stack(frames)[..., None]
        if self.image_range == 1:
            all_frames = all_frames / 255.0
        t = end - begin
        return {
            "frame": all_frames.astype(np.float32),
            "events": events,
            "data_source_idx": np.int64(DATA_SOURCES.index(
                self.dataset_name.lower())),
            "sequence_name": self.sequence_name,
            "real_begin_idx": np.full((t,), real_begin, np.int64),
            "frame_idx": np.arange(begin, end, dtype=np.int64),
        }


class TestH5CacheDataset:
    """Voxels stacked ahead of time (scripts/testh5_to_voxel_cache.py;
    reference data/testh5.py:383-446): `frames` (N,H,W[,1]) and `events`
    (N,bins,H,W) or (N,H,W,bins), whose attrs must carry this config's
    `num_bins` and `interpolate_bins`. Windows of sequence_length over all
    N frames; no warm-up, extra frame or extra events."""

    def __init__(self, h5_path: str, configs: Dict[str, Any]):
        import h5py
        self.h5_path = h5_path
        self.sequence_name = os.path.basename(h5_path).split(".")[0]
        self.dataset_name = configs.get("dataset_name", "hqf")
        self.sequence_length = configs.get("sequence_length", 40)
        self.num_bins = configs.get("num_bins", 5)
        self.interpolate_bins = configs.get("interpolate_bins", False)
        with h5py.File(h5_path, "r") as f:
            for key in ("num_bins", "interpolate_bins"):
                if getattr(self, key) != f.attrs[key]:
                    raise ValueError(
                        f"{h5_path} was cached with {key}={f.attrs[key]}, "
                        f"the config asks for {getattr(self, key)}")
            self.total_frame_cnt = f["frames"].shape[0]
        self.samples = [(i, min(self.total_frame_cnt,
                                i + self.sequence_length))
                        for i in range(0, self.total_frame_cnt,
                                       self.sequence_length)]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        import h5py
        begin, end = self.samples[idx]
        with h5py.File(self.h5_path, "r") as f:
            frames = np.asarray(f["frames"][begin:end], np.float32)
            events = np.asarray(f["events"][begin:end], np.float32)
        if frames.ndim == 3:
            frames = frames[..., None]
        if events.shape[1] == self.num_bins:       # stored channels-first
            events = events.transpose(0, 2, 3, 1)
        return {
            "frame": frames,
            "events": events,
            "data_source_idx": np.int64(DATA_SOURCES.index(
                self.dataset_name.lower())),
            "sequence_name": self.sequence_name,
            "frame_idx": np.arange(begin, end, dtype=np.int64),
        }


class FPSH5Dataset(TestH5Dataset):
    """An events-only h5 (real DAVIS captures, EvBird; reference
    data/testh5.py:448-519) cut into frames at a synthetic `FPS`: the
    frame borders are evenly spaced from the first timestamp to the last,
    `total_frame_cnt` = (t_last - t_first) * FPS of them, and a frame's
    events are found by `searchsorted`. Windows of sequence_length over
    the total_frame_cnt - 1 frames, no warm-up, events only (no `frame`,
    so the harness scores nothing and writes the predictions). H and W
    come from the config."""

    def __init__(self, h5_path: str, configs: Dict[str, Any]):
        self.fps = configs.get("FPS", 100)
        self.H = configs.get("H", 260)
        self.W = configs.get("W", 346)
        # the JAX reader and the reference take every window
        super().__init__(h5_path, {k: v for k, v in configs.items()
                                   if k != "max_samples"})

    def _read_index(self, f) -> None:
        ts = f["events/ts"][:]
        self.total_frame_cnt = int((ts[-1] - ts[0]) * self.fps)
        borders = np.linspace(ts[0], ts[-1], self.total_frame_cnt + 1)
        self.event_idx = np.searchsorted(ts, borders)

    def _windows(self) -> List[Tuple[int, int]]:
        return _plain_windows(self.total_frame_cnt, self.sequence_length)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        begin, end = self.samples[idx]
        with self._open() as f:
            voxels = [self._voxel(f, self.event_idx[i], self.event_idx[i + 1])
                      for i in range(begin, end)]
        return {
            "events": np.stack(voxels).transpose(0, 2, 3, 1).astype(
                np.float32),
            "data_source_idx": np.int64(DATA_SOURCES.index(
                self.dataset_name.lower())),
            "sequence_name": self.sequence_name,
        }
