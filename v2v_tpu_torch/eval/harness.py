"""E2VID-family test harness: per-sequence streaming eval (of voxels, or
of NerNet's raw events), image dump, metric CSV, baseline comparison
(port of v2v_tpu/eval/harness.py; reference test_e2vid.py).

Fixed sequence registry, reset-on-sequence-change streaming state,
ET-Net-compatible metrics (eval/metrics.py, LPIPS-Alex), the
`test_metrics.txt` + cumulative `all_test_results_new.csv` bookkeeping
with skip-if-done, and `beat_method` against the e2vid+ table.
"""
from __future__ import annotations

import os
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.interface import DataLoader, make_concat_multi_dataset
from ..data.sources import DATA_SOURCES
from ..training.checkpoint import all_ckpt_paths, load_params_only
from ..training.interface import ModelInterface
from ..training.steps import make_eval_step
from .metrics import mse as mse_fn
from .metrics import ssim as ssim_fn
from .references import beat_method

# The benchmark sequence registry (test_e2vid.py:26-37).
METRICS = ["MSE", "SSIM", "LPIPS"]
SEQUENCES = {
    "IJRR": ["boxes_6dof", "calibration", "dynamic_6dof", "office_zigzag",
             "poster_6dof", "shapes_6dof", "slider_depth"],
    "MVSEC": ["indoor_flying1", "indoor_flying2", "indoor_flying3",
              "indoor_flying4", "outdoor_day1", "outdoor_day2"],
    "HQF": ["bike_bay_hdr", "boxes", "desk", "desk_fast", "desk_hand_only",
            "desk_slow", "engineering_posters", "high_texture_plants",
            "poster_pillar_1", "poster_pillar_2", "reflective_materials",
            "slow_and_fast_desk", "slow_hand", "still_life"],
    "EVAID": ["ball", "bear", "box", "building", "outdoor", "playball",
              "room1", "sculpture", "toy", "traffic", "wall"],
}
ALL_METRIC_NAMES = [f"{ds}/{seq}/{m}" for ds, seqs in SEQUENCES.items()
                    for seq in seqs for m in METRICS]


def compute_metrics(iface: ModelInterface, pred_255: np.ndarray,
                    batch: Dict[str, Any]) -> Dict[str, list]:
    """Per-frame MSE/LPIPS/SSIM with the reference conventions
    (model/train_utils.py:212-248): computed in [0,1], SSIM with legacy
    data_range=2, LPIPS AlexNet. pred_255 (1,T,H,W,C) in [0,255]."""
    seq_name = batch["sequence_name"][0]
    src = DATA_SOURCES[int(batch["data_source_idx"][0])]
    prefix = f"{src.upper()}/{seq_name}"
    frames = np.asarray(batch["frame"])            # (1,T,H,W,C) in [0,255]
    t = frames.shape[1]
    out = defaultdict(list)
    pred01 = pred_255 / 255.0
    gt01 = frames / 255.0
    # LPIPS over chunks of 8 frames: a whole 80-frame 720p window at once
    # would hold tens of GB of trunk activations
    dev = iface.device
    lp_chunks = []
    with torch.no_grad():
        for i in range(0, t, 8):
            lp_chunks.append(iface.lpips_test(
                torch.as_tensor(pred01[0, i:i + 8], dtype=torch.float32,
                                device=dev),
                torch.as_tensor(gt01[0, i:i + 8], dtype=torch.float32,
                                device=dev), True).cpu().numpy())
    lp = np.concatenate(lp_chunks)                             # (T,)
    for ti in range(t):
        out[f"{prefix}/MSE"].append(mse_fn(pred01[0, ti], gt01[0, ti]))
        out[f"{prefix}/LPIPS"].append(float(lp[ti]))
        out[f"{prefix}/SSIM"].append(
            ssim_fn(pred01[0, ti, :, :, 0], gt01[0, ti, :, :, 0],
                    data_range=2))
    return out


def run_test(iface: ModelInterface, configs: Dict[str, Any],
             max_batches: Optional[int] = None, root: str = ".",
             dataset=None) -> Dict[str, float]:
    """Streaming evaluation over the test datasets (test_e2vid.py:39-110).
    `dataset` replaces the one the config's `test_stage.test` builds."""
    if dataset is None:
        dataset = make_concat_multi_dataset(configs["test_stage"]["test"])
    loader = DataLoader(dataset, batch_size=1, drop_last=False,
                        num_workers=configs["test_stage"].get(
                            "test_num_workers", 2))
    eval_step = make_eval_step(iface)
    output_dir = configs.get("test_output_dir")

    prev_seq = None
    state = None
    output_img_idx = 0
    all_metrics: Dict[str, list] = defaultdict(list)
    # host metrics (per-frame SSIM/MSE) overlap the next batch's device
    # forward; scipy's uniform_filter releases the GIL. Results merge at
    # the end, so their order does not matter (means over frames).
    metric_pool = ThreadPoolExecutor(max_workers=4)
    metric_futures = []
    _ = iface.lpips_test      # build it once, before the metric threads

    try:
        for batch_idx, batch in enumerate(loader):
            if max_batches is not None and batch_idx >= max_batches:
                break
            seq_name = batch["sequence_name"][0]
            if iface.is_nernet:
                # raw (N,5) event streams, B=1 (data/testh5.py:305-380)
                events = batch["events"][0]
                b, h, w = 1, *np.shape(batch["frame"])[2:4]
            else:
                events = torch.as_tensor(batch["events"], device=iface.device)
                b, t, h, w, _ = events.shape
            if prev_seq is None or prev_seq != seq_name:
                state = iface.init_state(b, h, w)     # reset_states()
                output_img_idx = 0
                if output_dir is not None:
                    src = DATA_SOURCES[int(batch["data_source_idx"][0])]
                    seq_dir = os.path.join(root, output_dir, src.upper(),
                                           seq_name)
                    os.makedirs(seq_dir, exist_ok=True)
            if iface.is_nernet:
                pred, state = iface.forward_sequence_nernet(events, state)
            else:
                pred, state = eval_step(events, state)
            pred = pred.cpu().numpy()
            if configs["test_stage"].get("need_multi_255", True):
                pred = pred * 255
            pred = np.clip(pred, 0, 255)

            if "frame" in batch:
                gt = np.asarray(batch["frame"])
                if pred.shape[-1] == 3 and gt.shape[-1] == 1:
                    # gray-in-BGR-out (test_e2vid.py:79-82)
                    pred = (0.5870 * pred[..., 0] + 0.1140 * pred[..., 1]
                            + 0.2989 * pred[..., 2])[..., None]
                metric_futures.append(metric_pool.submit(
                    compute_metrics, iface, pred, batch))

            if output_dir is not None:
                import cv2
                for ti in range(pred.shape[1]):
                    img = np.clip(pred[0, ti], 0, 255).astype(
                        np.uint8).squeeze()
                    cv2.imwrite(os.path.join(
                        seq_dir, f"{output_img_idx:06d}.png"), img)
                    output_img_idx += 1
            prev_seq = seq_name

        for fut in metric_futures:
            for k, v in fut.result().items():
                all_metrics[k] += v
    finally:
        metric_pool.shutdown()

    metric_txt = os.path.join(root, "tensorboard_logs",
                              configs["experiment_name"], "test_metrics.txt")
    os.makedirs(os.path.dirname(metric_txt), exist_ok=True)
    final: Dict[str, float] = {}
    with open(metric_txt, "w") as f:
        for k, v in all_metrics.items():
            final[k] = float(np.mean(v))
            print(f"{k}: {final[k]}")
            f.write(f"{k}: {final[k]}\n")
    beat_method(final, "e2vid+")
    return final


def run_single_test(checkpoint_path: Optional[str], config: Dict[str, Any],
                    max_batches: Optional[int] = None, root: str = ".",
                    device=None, dataset=None) -> Dict[str, float]:
    """(test_e2vid.py:177-194). The port builds a model without a shape,
    so no test item is probed first (NerNet's included). `dataset` goes
    to run_test."""
    iface = ModelInterface(config["module"], device)
    if checkpoint_path is not None:
        load_params_only(checkpoint_path, iface.model)
        print("Loaded checkpoint:", checkpoint_path)
    return run_test(iface, config, max_batches=max_batches, root=root,
                    dataset=dataset)


def main(config: Dict[str, Any], test_all_pths: bool = False,
         max_batches: Optional[int] = None, root: str = ".",
         device=None) -> None:
    """CSV bookkeeping + per-checkpoint testing (test_e2vid.py:113-175)."""
    assert config.get("task", "e2vid") == "e2vid"
    exp = config["experiment_name"]
    output_csv = os.path.join(root, "tensorboard_logs", exp,
                              "all_test_results_new.csv")
    os.makedirs(os.path.dirname(output_csv), exist_ok=True)
    done = []
    if os.path.exists(output_csv):
        with open(output_csv) as f:
            done = [ln.split(",")[0] for ln in f.readlines()[1:]]
    else:
        with open(output_csv, "w") as f:
            f.write("Checkpoint_path," + ",".join(ALL_METRIC_NAMES) + ",\n")

    paths = all_ckpt_paths(exp, root)
    if not paths:
        print("No checkpoint paths file found or it is empty.")
        return
    if not test_all_pths:
        paths = paths[-1:]
    for path in paths:
        subpath = path.split("/")[-1]
        if test_all_pths and subpath in done:
            continue
        result = run_single_test(path, config, max_batches=max_batches,
                                 root=root, device=device)
        with open(output_csv, "a") as f:
            f.write(subpath + ",")
            for key in ALL_METRIC_NAMES:
                f.write(f"{result.get(key, '')},")
            f.write("\n")
