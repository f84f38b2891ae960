"""Legacy event-file datasets (port of v2v_tpu/data/legacy.py;
reference data/dataset.py): the event-file abstraction
(`get_events/get_frame/get_flow/find_ts_index`), three voxel-forming
methods (`between_frames` / `k_events` / `t_seconds`), hot-event
masking, seed-synchronized augmentation, and the SequenceDataset
pause-chain wrapper. Numpy on the host, channels-last; every draw comes
from the global `random` and `np.random` streams in the JAX package's
order, so the same seeds give the same items bit for bit.

`h5py` is imported where DynamicH5Dataset opens its file, so
MemMapDataset runs on a machine without it.
"""
from __future__ import annotations

import os
import random
from typing import Any, Dict, Optional

import numpy as np

from ..ops.events import binary_search_h5_dset
from .augmentation import (CenterCrop, Compose, LegacyNorm, RandomCrop,
                           RandomFlip, RandomRotationFlip, RobustNorm,
                           add_hot_pixels_to_sequence_, add_noise_to_voxel)
from .sources import DATA_SOURCES

_TRANSFORMS = {"RandomCrop": RandomCrop, "RandomFlip": RandomFlip,
               "RobustNorm": RobustNorm, "LegacyNorm": LegacyNorm,
               "CenterCrop": CenterCrop,
               "RandomRotationFlip": RandomRotationFlip}


def voxel_np(xs, ys, ts, ps, num_bins: int, sensor_size,
             temporal_bilinear: bool = True) -> np.ndarray:
    """events_to_voxel_torch semantics (utils/event_utils.py:466-507):
    t normalized to [0, B-1], temporal bilinear weights; else discrete
    binning by (dt+0.001)/B. Returns (H, W, B)."""
    h, w = sensor_size
    vox = np.zeros((num_bins, h, w))
    if len(ts) == 0:
        return vox.transpose(1, 2, 0)
    t0 = ts[0]
    dt = ts[-1] - t0
    xi = xs.astype(np.int64)
    yi = ys.astype(np.int64)
    if temporal_bilinear:
        t_norm = (ts - t0) / max(dt, 1e-30) * (num_bins - 1)
        for bi in range(num_bins):
            weights = ps * np.maximum(0, 1.0 - np.abs(t_norm - bi))
            np.add.at(vox[bi], (yi, xi), weights)
    else:
        t_per_bin = (dt + 0.001) / num_bins
        bins = np.floor((ts - t0) / t_per_bin).astype(np.int64)
        bins = np.clip(bins, 0, num_bins - 1)
        np.add.at(vox, (bins, yi, xi), ps)
    return vox.transpose(1, 2, 0)


def get_hot_event_mask(xs, ys, ps, sensor_size, num_hot: int = 100):
    """Zero the top-num_hot event-count pixels
    (utils/event_utils.py:100-116). Returns (H, W) mask."""
    h, w = sensor_size
    img = np.zeros((h, w))
    np.add.at(img, (ys.astype(np.int64), xs.astype(np.int64)), ps)
    mask = np.ones_like(img)
    for _ in range(num_hot):
        idx = np.unravel_index(np.argmax(img), img.shape)
        mask[idx] = 0
        img[idx] = 0
    return mask


class BaseVoxelDataset:
    """(data/dataset.py:16-366). Subclasses implement get_frame /
    get_flow / get_events / load_data / find_ts_index."""

    def __init__(self, data_path, transforms: Optional[Dict] = None,
                 sensor_resolution=None, num_bins: int = 5,
                 voxel_method: Optional[Dict] = None, max_length=None,
                 combined_voxel_channels: bool = True,
                 filter_hot_events: bool = False,
                 temporal_bilinear: bool = False):
        self.num_bins = num_bins
        self.data_path = data_path
        self.combined_voxel_channels = combined_voxel_channels
        self.sensor_resolution = sensor_resolution
        self.data_source_idx = -1
        self.has_flow = False
        self.channels = num_bins if combined_voxel_channels else num_bins * 2
        self.temporal_bilinear = temporal_bilinear
        self.t0 = self.tk = self.num_events = None
        self.frame_ts = None
        self.num_frames = None

        self.load_data(data_path)
        assert None not in (self.sensor_resolution, self.t0, self.tk,
                            self.num_events, self.frame_ts, self.num_frames)
        self.num_pixels = int(np.prod(self.sensor_resolution))
        self.duration = self.tk - self.t0

        if filter_hot_events:
            hot_num = min(self.find_ts_index(0.2 + self.t0), self.num_events)
            xs, ys, ts, ps = self.get_events(0, hot_num)
            mask = get_hot_event_mask(
                xs.astype(np.int64), ys.astype(np.int64), ps,
                self.sensor_resolution,
                num_hot=int(self.num_pixels * 0.01))
            self.hot_events_mask = mask[..., None]        # (H,W,1)
        else:
            self.hot_events_mask = np.ones(
                (*self.sensor_resolution, 1), np.float32)

        self.set_voxel_method(voxel_method or {"method": "between_frames"})

        transforms = dict(transforms or {})
        self.normalize_voxels = False
        self.vox_transform = None
        norm_list = []
        for norm in ("RobustNorm", "LegacyNorm"):
            if norm in transforms:
                norm_list = [
                    _TRANSFORMS[t](**kw) for t, kw in transforms.items()]
                del transforms[norm]
                self.normalize_voxels = True
                self.vox_transform = Compose(norm_list)
                break
        t_list = [_TRANSFORMS[t](**kw) for t, kw in transforms.items()]
        self.transform = (None if not t_list else t_list[0]
                          if len(t_list) == 1 else Compose(t_list))
        if not self.normalize_voxels:
            self.vox_transform = self.transform

        self.length = getattr(self, "length", 0)
        if max_length is not None:
            self.length = min(self.length, max_length + 1)

    # -- abstract -------------------------------------------------------
    def get_frame(self, index):
        raise NotImplementedError

    def get_flow(self, index):
        raise NotImplementedError

    def get_events(self, idx0, idx1):
        raise NotImplementedError

    def load_data(self, data_path):
        raise NotImplementedError

    def find_ts_index(self, timestamp):
        raise NotImplementedError

    # -- voxel forming --------------------------------------------------
    def set_voxel_method(self, voxel_method):
        self.voxel_method = voxel_method
        m = voxel_method["method"]
        if m == "k_events":
            self.length = max(int(self.num_events / (
                voxel_method["k"] - voxel_method["sliding_window_w"])), 0)
            self.event_indices = [
                ((voxel_method["k"] - voxel_method["sliding_window_w"]) * i,
                 (voxel_method["k"] - voxel_method["sliding_window_w"]) * i
                 + voxel_method["k"]) for i in range(self.length)]
        elif m == "t_seconds":
            self.length = max(int(self.duration / (
                voxel_method["t"] - voxel_method["sliding_window_t"])), 0)
            idxs, start = [], 0
            for i in range(self.length):
                t_start = ((voxel_method["t"]
                            - voxel_method["sliding_window_t"]) * i) + self.t0
                end = self.find_ts_index(t_start + voxel_method["t"])
                idxs.append((start, end))
                start = end
            self.event_indices = idxs
        elif m == "between_frames":
            self.length = self.num_frames - 1
            self.event_indices = self.compute_frame_indices()
        else:
            raise ValueError(m)
        if self.length == 0:
            raise ValueError("zero-length voxel sequence")

    def compute_frame_indices(self):
        idxs, start = [], 0
        for ts in self.frame_ts:
            end = self.find_ts_index(ts)
            idxs.append((start, end))
            start = end
        return idxs

    def __len__(self):
        return self.length

    def get_voxel_grid(self, xs, ys, ts, ps):
        if self.combined_voxel_channels:
            vox = voxel_np(xs, ys, ts - ts[0], ps, self.num_bins,
                           self.sensor_resolution, self.temporal_bilinear)
        else:
            vp = voxel_np(xs, ys, ts - ts[0], np.where(ps > 0, 1.0, 0.0),
                          self.num_bins, self.sensor_resolution, True)
            vn = voxel_np(xs, ys, ts - ts[0], np.where(ps <= 0, 1.0, 0.0),
                          self.num_bins, self.sensor_resolution, True)
            vox = np.concatenate([vp, vn], axis=-1)
        return vox * self.hot_events_mask

    def __getitem__(self, index, seed=None):
        assert 0 <= index < len(self)
        seed = random.randint(0, 2 ** 32) if seed is None else seed
        idx0, idx1 = self.event_indices[index]
        xs, ys, ts, ps = self.get_events(idx0, idx1)
        ts_0, ts_k = (ts[0], ts[-1]) if len(ts) else (0, 0)
        if len(xs) < 3:
            vox = np.zeros((*self.sensor_resolution, self.channels),
                           np.float32)
        else:
            vox = self.get_voxel_grid(xs, ys, ts, ps)
        if self.vox_transform:
            random.seed(seed)
            vox = self.vox_transform(vox)
        dt = ts_k - ts_0

        if self.voxel_method["method"] == "between_frames":
            frame = self.get_frame(index).astype(np.float32)[..., None] / 255
            if self.transform:
                random.seed(seed)
                frame = self.transform(frame)
            if self.has_flow:
                flow = self.get_flow(index) * dt    # rate -> displacement
                flow = np.moveaxis(flow, 0, -1) if flow.shape[0] == 2 else flow
                if self.transform:
                    random.seed(seed)
                    flow = self.transform(flow, is_flow=True)
            else:
                flow = np.zeros((*frame.shape[:2], 2), np.float32)
            return {"frame": frame.astype(np.float32),
                    "flow": flow.astype(np.float32),
                    "events": vox.astype(np.float32),
                    "timestamp": np.float64(self.frame_ts[index]),
                    "data_source_idx": np.int64(self.data_source_idx),
                    "dt": np.float64(dt)}
        return {"events": vox.astype(np.float32),
                "timestamp": np.float64(ts_k),
                "data_source_idx": np.int64(self.data_source_idx),
                "dt": np.float64(dt)}


class DynamicH5Dataset(BaseVoxelDataset):
    """Monash-format event h5 (data/dataset.py:369-427)."""

    def get_frame(self, index):
        return self.h5_file["images"][f"image{index:09d}"][:]

    def get_flow(self, index):
        return self.h5_file["flow"][f"flow{index:09d}"][:]

    def get_events(self, idx0, idx1):
        xs = self.h5_file["events/xs"][idx0:idx1]
        ys = self.h5_file["events/ys"][idx0:idx1]
        ts = self.h5_file["events/ts"][idx0:idx1]
        ps = self.h5_file["events/ps"][idx0:idx1] * 2.0 - 1.0
        return xs, ys, ts, ps

    def load_data(self, data_path):
        import h5py
        self.h5_file = h5py.File(data_path, "r")
        if self.sensor_resolution is None:
            self.sensor_resolution = tuple(
                self.h5_file.attrs["sensor_resolution"][0:2])
        self.has_flow = ("flow" in self.h5_file
                         and len(self.h5_file["flow"]) > 0)
        self.t0 = self.h5_file["events/ts"][0]
        self.tk = self.h5_file["events/ts"][-1]
        self.num_events = self.h5_file.attrs["num_events"]
        self.num_frames = self.h5_file.attrs["num_imgs"]
        self.frame_ts = [self.h5_file[f"images/{n}"].attrs["timestamp"]
                         for n in self.h5_file["images"]]
        src = self.h5_file.attrs.get("source", "unknown")
        try:
            self.data_source_idx = DATA_SOURCES.index(src)
        except ValueError:
            self.data_source_idx = -1

    def find_ts_index(self, timestamp):
        return binary_search_h5_dset(self.h5_file["events/ts"], timestamp)

    def compute_frame_indices(self):
        idxs, start = [], 0
        for name in self.h5_file["images"]:
            end = self.h5_file[f"images/{name}"].attrs["event_idx"]
            idxs.append((start, end))
            start = end
        return idxs


class MemMapDataset(BaseVoxelDataset):
    """RPG MemMap events format (data/dataset.py:429-527)."""

    def get_frame(self, index):
        return self.filehandle["images"][index][:, :, 0]

    def get_flow(self, index):
        return self.filehandle["optic_flow"][index]

    def get_events(self, idx0, idx1):
        xy = self.filehandle["xy"][idx0:idx1]
        xs = xy[:, 0].astype(np.float32)
        ys = xy[:, 1].astype(np.float32)
        ts = self.filehandle["t"][idx0:idx1]
        ps = self.filehandle["p"][idx0:idx1] * 2.0 - 1.0
        return xs, ys, ts, ps

    def load_data(self, data_path):
        assert os.path.isdir(data_path), data_path
        data: Dict[str, Any] = {}
        self.has_flow = False
        for subroot, _, fnames in sorted(os.walk(data_path)):
            for fname in sorted(fnames):
                if not fname.endswith(".npy"):
                    continue
                path = os.path.join(subroot, fname)
                if fname.endswith("timestamps.npy"):
                    data["frame_stamps"] = np.load(path)
                elif fname.endswith("images.npy"):
                    data["images"] = np.load(path, mmap_mode="r")
                elif fname.endswith("optic_flow.npy"):
                    data["optic_flow"] = np.load(path, mmap_mode="r")
                    self.has_flow = True
                elif fname.endswith("optic_flow_stamps.npy"):
                    data["optic_flow_stamps"] = np.load(path)
                elif fname.endswith("t.npy"):
                    data["t"] = np.load(path, mmap_mode="r").squeeze()
                elif fname.endswith("xy.npy"):
                    data["xy"] = np.load(path, mmap_mode="r").squeeze()
                elif fname.endswith("p.npy"):
                    data["p"] = np.load(path, mmap_mode="r").squeeze()
        assert "t" in data, f"no events under {data_path}"
        self.t0, self.tk = data["t"][0], data["t"][-1]
        self.num_events = len(data["p"])
        self.num_frames = len(data["images"])
        self.frame_ts = list(data["frame_stamps"])
        self.filehandle = data
        if self.sensor_resolution is None:
            if self.num_frames > 0:
                self.sensor_resolution = data["images"][0].shape[:2]
            else:
                self.sensor_resolution = (
                    int(data["xy"][:, 1].max()) + 1,
                    int(data["xy"][:, 0].max()) + 1)

    def find_ts_index(self, timestamp):
        return int(np.searchsorted(self.filehandle["t"], timestamp))


class SequenceDataset:
    """Pause-chain sequence wrapper over a voxel dataset
    (data/dataset.py:529-618): one seed transforms all items of a
    sequence identically; paused steps zero events/flow and repeat the
    frame; optional voxel noise + persistent hot pixels."""

    _TYPES = {"MemMapDataset": MemMapDataset,
              "DynamicH5Dataset": DynamicH5Dataset}

    def __init__(self, data_root, sequence_length, dataset_type="MemMapDataset",
                 step_size=None, proba_pause_when_running=0.0,
                 proba_pause_when_paused=0.0, normalize_image=False,
                 noise_kwargs=None, hot_pixel_kwargs=None, dataset_kwargs=None):
        self.L = sequence_length
        self.step_size = step_size or self.L
        self.proba_pause_when_running = proba_pause_when_running
        self.proba_pause_when_paused = proba_pause_when_paused
        self.normalize_image = normalize_image
        self.noise_kwargs = noise_kwargs or {}
        self.hot_pixel_kwargs = hot_pixel_kwargs or {}
        assert self.L > 0 and self.step_size > 0
        self.dataset = self._TYPES[dataset_type](
            data_root, **(dataset_kwargs or {}))
        self.length = (0 if self.L >= self.dataset.length
                       else (self.dataset.length - self.L)
                       // self.step_size + 1)

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        assert 0 <= i < self.length
        seed = random.randint(0, 2 ** 32)
        sequence = []
        k = 0
        j = i * self.step_size
        sequence.append(self.dataset.__getitem__(j, seed))
        paused = False
        for _ in range(self.L - 1):
            u = np.random.rand()
            prob = (self.proba_pause_when_paused if paused
                    else self.proba_pause_when_running)
            paused = u < prob
            if paused:
                item = self.dataset.__getitem__(j + k, seed)
                item["events"] = np.zeros_like(item["events"])
                if "flow" in item:
                    item["flow"] = np.zeros_like(item["flow"])
            else:
                k += 1
                item = self.dataset.__getitem__(j + k, seed)
            if self.noise_kwargs:
                item["events"] = add_noise_to_voxel(item["events"],
                                                    **self.noise_kwargs)
            sequence.append(item)
        if self.hot_pixel_kwargs:
            add_hot_pixels_to_sequence_(sequence, **self.hot_pixel_kwargs)
        if self.normalize_image:
            # sequence-wide 1st/99th percentile rescale + clamp, one
            # constant mapping for the whole window (reference
            # normalize_image_sequence_, utils/data_augmentation.py:26-33)
            frames = np.stack([item["frame"] for item in sequence])
            mini = np.percentile(frames, 1)
            maxi = np.percentile(frames, 99)
            for item in sequence:
                item["frame"] = np.clip(
                    (item["frame"] - mini) / (maxi - mini + 1e-5), 0, 1)
        return sequence
