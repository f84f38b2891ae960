"""WebVid online training dataset (port of v2v_tpu/data/webvid.py;
reference data/v2v_datasets.py:24-486).

Host side of the train feed: the video list and its per-shot samples,
OpenCV decode, the watermark-avoiding crop (keep_top_percentile), random
resize, crop and flip, camera shake, the Markov pause chain and the
degradation ablations. Items are raw uint8 frame stacks
(`output="video"`), whose events the train step simulates on the card,
or voxels and GT frames simulated on the host by the numpy emulator
(`output="voxel"`, `VoxelOutput`; the reference's imgs_to_voxels).

Every random draw of an item comes from its own `np.random.RandomState`,
in the JAX package's order: seeded `fixed_seed + sample_idx` when the
config sets `fixed_seed` (the JAX package seeds the global stream with
the same number, so the same seed gives the same bits), otherwise from
the loader's per-epoch seed (`set_epoch`) and the index. Loader threads
share no random state.

cv2 is imported inside the methods that decode or draw, so the module
imports on a machine without it.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.voxel import esim_video_to_voxel_np
from .sources import DATA_SOURCES


def log_uniform(minval: float, maxval: float) -> float:
    """A draw uniform in log(x + 1e-3) on [minval, maxval], from the
    global numpy stream, as the JAX package's and the reference's
    (data/v2v_datasets.py:12-17)."""
    eps = 1e-3
    logval = np.random.uniform(np.log(minval + eps), np.log(maxval + eps))
    return float(np.exp(logval) - eps)


def bgr_to_gray(img_stack: np.ndarray) -> np.ndarray:
    """(N,H,W,3) BGR -> (N,H,W) gray, BT.601 with the reference's channel
    order (data/v2v_datasets.py:19-22)."""
    gray = np.dot(img_stack[..., :3], [0.5870, 0.1140, 0.2989])
    return gray.astype(np.uint8)


class VoxelOutput:
    """WebVid's `output="voxel"` (v2v_tpu/data/webvid.py:328-374;
    reference imgs_to_voxels, data/v2v_datasets.py:363-410) on an item's
    decoded frames: the thresholds (the video's fixed pair, or theta ~
    U(threshold_range) times a gap ~ U(1, max_thres_pos_neg_gap) on a
    coin's side), the noise stds and their `scale_noise_strength`, then
    the numpy emulator, the counts summed over `frames_per_bin`, and the
    GT frames, every draw from `rng` in that order. `configs` is the
    WebVid data config."""

    def __init__(self, configs: Dict[str, Any]):
        c = configs
        self.L = c.get("sequence_length", 40)
        self.num_bins = c.get("num_bins", 5)
        self.frames_per_bin = c.get("frames_per_bin", 1)
        self.frames_per_img = self.num_bins * self.frames_per_bin
        self.threshold_range = c.get("threshold_range", [0.05, 2])
        self.max_thres_pos_neg_gap = c.get("max_thres_pos_neg_gap", 1.5)
        self.base_noise_std_range = c.get("base_noise_std_range", [0, 0.2])
        self.hot_pixel_fraction_range = c.get("hot_pixel_fraction_range",
                                              [0, 0.001])
        self.hot_pixel_std_range = c.get("hot_pixel_std_range", [0, 0.2])
        self.put_noise_external = c.get("put_noise_external", False)
        self.scale_noise_strength = c.get("scale_noise_strength", False)
        self.output_additional_frame = c.get("output_additional_frame",
                                             False)
        self.output_additional_evs = c.get("output_additional_evs", False)

    def __call__(self, gray: np.ndarray, all_imgs: np.ndarray,
                 rng: np.random.RandomState,
                 thresholds: Optional[Tuple[float, float]] = None
                 ) -> Dict[str, Any]:
        """gray (N,H,W) uint8 and all_imgs (N,H,W,C) uint8, N = L *
        frames_per_img + 1 (+ frames_per_img with output_additional_evs)
        -> frame (T,H,W,C) float32 in [0, 1], events (G,H,W,num_bins)
        float32, v2e_params."""
        if thresholds is not None:
            pos_thres, neg_thres = thresholds
        else:
            thres_1 = rng.uniform(*self.threshold_range)
            thres_2 = thres_1 * rng.uniform(1, self.max_thres_pos_neg_gap)
            if rng.rand() > 0.5:
                pos_thres, neg_thres = thres_1, thres_2
            else:
                pos_thres, neg_thres = thres_2, thres_1
        base_noise_std = rng.uniform(*self.base_noise_std_range)
        hot_pixel_fraction = rng.uniform(*self.hot_pixel_fraction_range)
        hot_pixel_std = rng.uniform(*self.hot_pixel_std_range)
        if self.scale_noise_strength and not self.put_noise_external:
            base_noise_std *= pos_thres
            hot_pixel_std *= pos_thres
        counts = esim_video_to_voxel_np(
            gray.astype(np.float32), pos_thres, neg_thres, base_noise_std,
            hot_pixel_fraction, hot_pixel_std, self.put_noise_external, rng)
        h, w = gray.shape[1:]
        voxels = counts.reshape(counts.shape[0] // self.frames_per_img,
                                self.num_bins, self.frames_per_bin, h,
                                w).sum(axis=2)
        fpi = self.frames_per_img
        use_imgs = all_imgs[fpi:] if self.output_additional_evs else all_imgs
        if self.output_additional_frame:
            frames = np.stack([use_imgs[i * fpi] for i in range(self.L + 1)])
        else:
            frames = np.stack([use_imgs[(i + 1) * fpi]
                               for i in range(self.L)])
        n_vox = self.L + (1 if self.output_additional_evs else 0)
        return {
            "frame": frames.astype(np.float32) / 255.0,
            "events": voxels[:n_vox].transpose(0, 2, 3, 1).astype(
                np.float32),
            "v2e_params": {
                "pos_thres": pos_thres, "neg_thres": neg_thres,
                "base_noise_std": base_noise_std,
                "hot_pixel_fraction": hot_pixel_fraction,
                "hot_pixel_std": hot_pixel_std},
        }


class WebvidDataset:
    """Reference WebvidDatasetV2 (data/v2v_datasets.py:95-361)."""

    def __init__(self, dataset_path: str, configs: Dict[str, Any]):
        self.dataset_path = dataset_path
        c = configs
        self.L = c.get("sequence_length", 40)
        self.proba_pause_when_running = c.get("proba_pause_when_running", 0.01)
        self.proba_pause_when_paused = c.get("proba_pause_when_paused", 0.98)
        self.fixed_seed = c.get("fixed_seed", None)
        self.crop_size = c.get("crop_size", None)
        self.fixed_crop = c.get("fixed_crop", False)
        self.random_flip = c.get("random_flip", True)
        self.num_bins = c.get("num_bins", 5)
        self.frames_per_bin = c.get("frames_per_bin", 1)
        self.frames_per_img = self.num_bins * self.frames_per_bin
        self.frames_per_seq = self.frames_per_img * self.L
        step_size = c.get("step_size", None)
        self.step_size = (step_size if step_size is not None
                          else self.frames_per_seq)
        self.min_resize_scale = c.get("min_resize_scale", 0)
        self.max_resize_scale = c.get("max_resize_scale", 1.3)
        self.shake_frames = c.get("shake_frames", 0)
        self.shake_std = c.get("shake_std", 0)
        self.max_samples_per_shot = c.get("max_samples_per_shot", 1)
        self.subsample_ratio = c.get("subsample_ratio", 1)
        self.keep_top_percentile = c.get("keep_top_percentile", 0.54)
        self.use_fixed_thresholds = c.get("use_fixed_thresholds", False)
        self.data_source_idx = DATA_SOURCES.index(
            c.get("data_source_name", "reds"))
        self.color_mode = c.get("color_mode", "gray")
        if self.color_mode not in ("gray", "gray_in_bgr_out"):
            raise ValueError(f"color_mode {self.color_mode!r}")
        self.output_additional_evs = c.get("output_additional_evs", False)
        if self.output_additional_evs:
            self.frames_per_seq += self.frames_per_img
        self.video_degrade = c.get("video_degrade", None)
        if self.video_degrade not in (None, "subtitles", "dirtyshotcut",
                                      "hdr", "ldr"):
            raise ValueError(f"video_degrade {self.video_degrade!r}")
        self.degrade_ratio = c.get("degrade_ratio", 0)
        output = c.get("output", "video")
        if output not in ("video", "voxel"):
            raise ValueError(f"output {output!r}")
        self.voxel_output = VoxelOutput(c) if output == "voxel" else None
        self.epoch_seed: Tuple[int, ...] = (0,)

        # video list: `subpath framecount [pos_thres neg_thres]`
        # (data/v2v_datasets.py:99-109)
        names, counts, pos_t, neg_t = [], [], [], []
        with open(c["video_list_file"]) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                names.append(parts[0])
                counts.append(int(parts[1]))
                pos_t.append(float(parts[2]) if len(parts) > 2 else 0.0)
                neg_t.append(float(parts[3]) if len(parts) > 3 else 0.0)

        samples = []      # (video name, begin frame, pos_thres, neg_thres)
        for vi, (name, cnt) in enumerate(zip(names, counts)):
            shot_samples = 0
            for i in range(0, cnt - self.frames_per_seq - 1, self.step_size):
                samples.append((name, i, pos_t[vi], neg_t[vi]))
                shot_samples += 1
                if shot_samples >= self.max_samples_per_shot:
                    break
        self.samples = samples[:int(len(samples) * self.subsample_ratio)]

    def __len__(self) -> int:
        return len(self.samples)

    def set_epoch(self, seed: Sequence[int]) -> None:
        """The loader's per-epoch seed; items drawn without `fixed_seed`
        seed their stream from it and their index."""
        self.epoch_seed = tuple(int(s) for s in np.atleast_1d(seed))

    # -- decode ---------------------------------------------------------
    def read_video(self, video_path: str, start_frame: int, end_frame: int,
                   crop_size_before_resize: int, min_i: int, min_j: int,
                   flip: bool, rng: np.random.RandomState
                   ) -> List[np.ndarray]:
        """OpenCV decode + crop + resize + flip + shake
        (data/v2v_datasets.py:145-225); (H, W, C) uint8 frames."""
        import cv2
        all_di = [0] * (end_frame - start_frame)
        all_dj = [0] * (end_frame - start_frame)
        if self.shake_frames > 0:
            vi = vj = di = dj = 0
            for i in range(min(self.shake_frames,
                               end_frame - start_frame) - 1, -1, -1):
                vi += int(rng.normal(0, self.shake_std))
                vj += int(rng.normal(0, self.shake_std))
                di += vi
                dj += vj
                all_di[i] = di
                all_dj[i] = dj
        need_h = self.crop_size + max(all_di) - min(all_di)
        need_w = self.crop_size + max(all_dj) - min(all_dj)

        cap = cv2.VideoCapture(video_path)
        try:
            cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)
            imgs = []
            for _ in range(start_frame, end_frame):
                ret, frame = cap.read()
                if not ret:
                    break
                if self.color_mode == "gray":
                    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
                frame = frame[min_i:min_i + crop_size_before_resize,
                              min_j:min_j + crop_size_before_resize, ...]
                frame = cv2.resize(frame, (need_w, need_h),
                                   interpolation=cv2.INTER_LINEAR)
                if flip:
                    frame = cv2.flip(frame, 1)
                if frame.ndim == 2:
                    frame = frame[..., None]
                imgs.append(frame)
        finally:
            cap.release()

        di = np.array(all_di) - min(all_di)
        dj = np.array(all_dj) - min(all_dj)
        return [img[di[i]:di[i] + self.crop_size,
                    dj[i]:dj[i] + self.crop_size, :]
                for i, img in enumerate(imgs)]

    # -- augmentation ---------------------------------------------------
    def pause_chain(self, total_inputs: int, rng: np.random.RandomState
                    ) -> Tuple[List[int], int]:
        """Markov pause process over frame indices
        (data/v2v_datasets.py:285-301). Returns (img_idxes, read_count);
        read_count is the reference's `idx + 1` after the final state
        update, usually one more frame than img_idxes uses, which only
        `dirtyshotcut`'s reordering pulls in. Each step draws one number,
        on the branch it takes."""
        img_idxes, idx, is_pause = [], 0, False
        for _ in range(total_inputs):
            img_idxes.append(idx)
            if is_pause and rng.rand() > self.proba_pause_when_paused:
                is_pause = False
            elif not is_pause and rng.rand() < self.proba_pause_when_running:
                is_pause = True
            if not is_pause:
                idx += 1
        return img_idxes, idx + 1

    def degrade_video(self, imgs: List[np.ndarray],
                      rng: np.random.RandomState) -> List[np.ndarray]:
        """Quality-degradation ablations (data/v2v_datasets.py:413-486)."""
        import cv2
        t = len(imgs)
        if self.video_degrade == "subtitles":
            fonts = [cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_PLAIN,
                     cv2.FONT_HERSHEY_DUPLEX, cv2.FONT_HERSHEY_COMPLEX,
                     cv2.FONT_HERSHEY_TRIPLEX, cv2.FONT_HERSHEY_COMPLEX_SMALL,
                     cv2.FONT_HERSHEY_SCRIPT_SIMPLEX,
                     cv2.FONT_HERSHEY_SCRIPT_COMPLEX]
            font = int(rng.choice(fonts))
            scale = rng.uniform(0.5, 1.5)
            color = tuple(int(rng.randint(0, 256)) for _ in range(3))
            thickness = int(rng.randint(1, 3))
            chars = list("abcdefghijklmnopqrstuvwxyz"
                         "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 ")
            text = "".join(rng.choice(chars, rng.randint(5, 16)))
            h, w = imgs[0].shape[:2]
            (tw, th), baseline = cv2.getTextSize(text, font, scale, thickness)
            org = (int(rng.randint(0, max(1, w - tw))),
                   int(rng.randint(th, max(th + 1, h - baseline))))
            for i in range(t):
                img = imgs[i].copy()
                gray_in = img.shape[2] == 1
                if gray_in:
                    img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
                cv2.putText(img, text, org, font, scale, color, thickness,
                            cv2.LINE_AA)
                if gray_in:
                    img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)[..., None]
                imgs[i] = img
            return imgs
        if self.video_degrade == "dirtyshotcut":
            if t < 3:
                return imgs
            cut = int(rng.randint(1, t - 1))
            seg = slice(0, cut) if rng.rand() > 0.5 else slice(cut, t)
            flipped = [cv2.flip(img, 1) for img in imgs[seg]]
            imgs[seg] = [f[..., None] if f.ndim == 2 else f for f in flipped]
            return imgs[cut:] + imgs[:cut]
        # hdr / ldr
        scale = (rng.uniform(1, 3) if self.video_degrade == "hdr"
                 else rng.uniform(0.3, 1))
        return [np.clip((img.astype(np.float32) - 127.5) * scale + 127.5,
                        0, 255).astype(np.uint8) for img in imgs]

    # -- main -----------------------------------------------------------
    def __getitem__(self, sample_idx: int) -> Dict[str, Any]:
        if self.fixed_seed is not None:
            rng = np.random.RandomState(self.fixed_seed + sample_idx)
        else:
            rng = np.random.RandomState(self.epoch_seed + (sample_idx,))
        return self._getitem(sample_idx, rng)

    def _getitem(self, sample_idx: int, rng: np.random.RandomState
                 ) -> Dict[str, Any]:
        import cv2
        video_name, start_frame, pos_thres, neg_thres = \
            self.samples[sample_idx]
        video_path = os.path.join(self.dataset_path, video_name)

        cap = cv2.VideoCapture(video_path)
        try:
            vid_w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            vid_h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        finally:
            cap.release()

        if self.crop_size is None:
            raise NotImplementedError("crop_size must be provided")
        min_scale = max(self.min_resize_scale,
                        self.crop_size / int(vid_h * self.keep_top_percentile),
                        self.crop_size / vid_w)
        max_scale = max(self.max_resize_scale, min_scale)
        resize_scale = rng.uniform(min_scale, max_scale)
        crop_before = int(self.crop_size / resize_scale)

        if self.fixed_crop:
            min_i = min_j = 0
        else:
            min_i = rng.randint(
                0, int(vid_h * self.keep_top_percentile) - crop_before + 1)
            min_j = rng.randint(0, vid_w - crop_before + 1)
        flip = self.random_flip and rng.rand() > 0.5

        additional = self.frames_per_img if self.output_additional_evs else 0
        total_inputs = self.L * self.frames_per_img + 1 + additional
        img_idxes, true_img_cnt = self.pause_chain(total_inputs, rng)
        raw = self.read_video(video_path, start_frame,
                              start_frame + true_img_cnt, crop_before,
                              min_i, min_j, flip, rng)
        if self.video_degrade is not None and rng.rand() < self.degrade_ratio:
            raw = self.degrade_video(raw, rng)
        all_imgs = np.stack([raw[i] for i in img_idxes])     # (N,H,W,C)

        item: Dict[str, Any] = {
            "data_source_idx": np.int64(self.data_source_idx),
        }
        if self.use_fixed_thresholds:
            item["pos_thres"] = np.float32(pos_thres)
            item["neg_thres"] = np.float32(neg_thres)
        gray = (all_imgs[..., 0] if self.color_mode == "gray"
                else bgr_to_gray(all_imgs))
        if self.voxel_output is not None:
            item.update(self.voxel_output(
                gray, all_imgs, rng, (pos_thres, neg_thres)
                if self.use_fixed_thresholds else None))
            return item
        # frames include the leading anchor frame, which the simulator's
        # first difference consumes
        item["video"] = gray.astype(np.uint8)
        if self.color_mode != "gray":
            item["video_bgr"] = all_imgs.astype(np.uint8)
        return item
