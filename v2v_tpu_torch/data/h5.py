"""The h5 test dataset (port of v2v_tpu/data/h5.py::TestH5Dataset;
reference data/testh5.py:14-173).

HQF-format h5 files: `images/imageNNNNNNNNN` datasets whose
attrs["event_idx"] point into `events/{ts,xs,ys,ps}`, cut into
fixed-length streaming samples. Voxels come from the host voxelizer
`events_to_voxel_np`, the same bits as the reference's; the JAX
package's optional C++ builder gives the same voxels and is not ported.
`h5py` is imported where a file is opened.

Samples are channels-last: frame (T,H,W,1), events (T,H,W,bins).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np

from ..ops.voxel import events_to_voxel_np
from .sources import DATA_SOURCES


class TestH5Dataset:
    """Per-frame voxels + GT frames from an HQF-format h5."""

    def __init__(self, h5_path: str, configs: Dict[str, Any]):
        self.h5_path = h5_path
        self.sequence_name = os.path.basename(h5_path).split(".")[0]
        self.dataset_name = configs.get("dataset_name", "hqf")
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
        with self._open() as f:
            self.img_keys = sorted(f["images"].keys())
            self.total_frame_cnt = len(self.img_keys)
            self.H, self.W = f["images"][self.img_keys[0]].shape[:2]

        # samples = (begin, real_start_offset, end): windows of
        # sequence_length inputs stepping by (L - warm_up)
        # (data/testh5.py:41-49)
        self.samples: List[Tuple[int, int, int]] = []
        step = self.sequence_length - self.warm_up_length
        for i in range(0, self.total_frame_cnt - 1, step):
            begin = max(0, i - self.warm_up_length)
            end = min(self.total_frame_cnt - 1, begin + self.sequence_length)
            self.samples.append((begin, i - begin, end))
        max_samples = configs.get("max_samples")
        if max_samples is not None:
            self.samples = self.samples[:max_samples]

    def _open(self):
        import h5py
        return h5py.File(self.h5_path, "r")

    def __len__(self) -> int:
        return len(self.samples)

    def _voxel(self, f, i0: int, i1: int) -> np.ndarray:
        return events_to_voxel_np(
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
