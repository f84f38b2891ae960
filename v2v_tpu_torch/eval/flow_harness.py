"""Optical-flow test harness (port of v2v_tpu/eval/flow_harness.py;
reference test_flow.py): the MVSEC sequence registry, per-sequence
streaming with a state reset, dense/sparse EPE/1PE/3PE against stored
GT flow or, for datasets without flow, the RAFT teacher's pseudo-GT from
the T+1 frames, flow NPY/PNG output, `test_metrics.txt` and the
cumulative `all_test_results_new.csv` with skip-if-done.
"""
from __future__ import annotations

import os
import warnings
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.interface import DataLoader, make_concat_multi_dataset
from ..data.sources import DATA_SOURCES
from ..training.checkpoint import all_ckpt_paths, load_params_only
from ..training.flow_interface import (FLOW_METRICS, FlowModelInterface,
                                       flow2rgb_np, flow_metrics)
from ..training.steps import make_eval_step

FLOW_SEQUENCES = {
    "MVSEC": ["indoor_flying1", "indoor_flying2", "indoor_flying3",
              "outdoor_day1", "outdoor_day2"],
}
ALL_FLOW_METRIC_NAMES = [f"{ds}/{seq}/{m}"
                         for ds, seqs in FLOW_SEQUENCES.items()
                         for seq in seqs for m in FLOW_METRICS]


def _png_writer():
    """cv2.imwrite, or None (with a warning) where cv2 is absent."""
    try:
        import cv2
    except ImportError:
        warnings.warn("cv2 is not installed: the flow PNGs are not written")
        return None
    return cv2.imwrite


def run_test(iface: FlowModelInterface, configs: Dict[str, Any],
             max_batches: Optional[int] = None, root: str = ".",
             dataset=None) -> Dict[str, float]:
    """Streaming flow evaluation over the test datasets (test_flow.py).
    `dataset` replaces the one the config's `test_stage.test` builds.
    Returns the mean of each metric over the frames, by
    `<DATASET>/<sequence>/<metric>`."""
    if dataset is None:
        dataset = make_concat_multi_dataset(configs["test_stage"]["test"])
    loader = DataLoader(dataset, batch_size=1, drop_last=False,
                        num_workers=configs["test_stage"].get(
                            "test_num_workers", 2))
    eval_step = make_eval_step(iface)
    output_dir = configs.get("test_output_dir")
    save_npy = configs.get("save_npy", False)
    imwrite = (_png_writer() if output_dir is not None
               and configs.get("save_png", True) else None)

    prev_seq = None
    state = None
    output_img_idx = 0
    all_metrics: Dict[str, list] = defaultdict(list)
    for batch_idx, batch in enumerate(loader):
        if max_batches is not None and batch_idx >= max_batches:
            break
        seq_name = batch["sequence_name"][0]
        events = torch.as_tensor(batch["events"], device=iface.device)
        b, _, h, w, _ = events.shape
        if prev_seq is None or prev_seq != seq_name:
            state = iface.init_state(b, h, w)         # reset_states()
            output_img_idx = 0
            if output_dir is not None:
                src = DATA_SOURCES[int(batch["data_source_idx"][0])]
                seq_dir = os.path.join(root, output_dir, src.upper(),
                                       seq_name)
                os.makedirs(seq_dir, exist_ok=True)
        pred, state = eval_step(events, state)
        pred = pred.cpu().numpy()                     # (1,T,H,W,2)

        src = DATA_SOURCES[int(batch["data_source_idx"][0])]
        t_out = pred.shape[1]
        ev = np.asarray(batch["events"])[:, -t_out:]
        if "flow" in batch:
            gt = np.asarray(batch["flow"])
        else:
            # no stored flow: the teacher's pseudo-GT, as the reference
            # scores at test time (train_flow_utils.py:307-321)
            gt = iface.prepare_flow({"frame": torch.as_tensor(
                batch["frame"], device=iface.device)}, test=True)[
                    "flow"].cpu().numpy()
        for k, v in flow_metrics(pred, gt[:, -t_out:], ev,
                                 f"{src.upper()}/{seq_name}").items():
            all_metrics[k] += v

        if output_dir is not None:
            for ti in range(t_out):
                flow = pred[0, ti]                    # (H,W,2)
                if save_npy:
                    np.save(os.path.join(
                        seq_dir, f"{output_img_idx:06d}.npy"),
                        flow.transpose(2, 0, 1))
                if imwrite is not None:
                    imwrite(os.path.join(
                        seq_dir, f"{output_img_idx:06d}_flow.png"),
                        flow2rgb_np(flow[..., 0], flow[..., 1]))
                output_img_idx += 1
        prev_seq = seq_name

    metric_txt = os.path.join(root, "tensorboard_logs",
                              configs["experiment_name"], "test_metrics.txt")
    os.makedirs(os.path.dirname(metric_txt), exist_ok=True)
    final: Dict[str, float] = {}
    with open(metric_txt, "w") as f:
        for k, v in all_metrics.items():
            final[k] = float(np.mean(v))
            print(f"{k}: {final[k]}")
            f.write(f"{k}: {final[k]}\n")
    return final


def run_single_test(checkpoint_path: Optional[str], config: Dict[str, Any],
                    max_batches: Optional[int] = None, root: str = ".",
                    device=None, dataset=None) -> Dict[str, float]:
    """`dataset` goes to run_test."""
    iface = FlowModelInterface(config["module"], device)
    if checkpoint_path is not None:
        load_params_only(checkpoint_path, iface.model)
        print("Loaded checkpoint:", checkpoint_path)
    return run_test(iface, config, max_batches=max_batches, root=root,
                    dataset=dataset)


def main(config: Dict[str, Any], test_all_pths: bool = False,
         max_batches: Optional[int] = None, root: str = ".",
         device=None) -> None:
    """CSV bookkeeping and per-checkpoint testing (test_flow.py)."""
    if config.get("task") != "flow":
        raise ValueError("a config without task: flow goes to test_e2vid")
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
            f.write("Checkpoint_path," + ",".join(ALL_FLOW_METRIC_NAMES)
                    + ",\n")
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
            for key in ALL_FLOW_METRIC_NAMES:
                f.write(f"{result.get(key, '')},")
            f.write("\n")
