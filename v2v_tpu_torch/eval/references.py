"""Baseline regression tables + beat_method (the port's copy of
v2v_tpu/eval/references.py, with its own metric_references.json).

The per-sequence E2VID+ / ETNet reference metrics ship as data
(utils/metric_references.py:125-206 of the reference). `beat_method`
reproduces its console report (:208-236): beat count over all
(sequence, metric) pairs plus summed advantage, SSIM higher-is-better,
MSE/LPIPS lower-is-better.
"""
from __future__ import annotations

import json
import os
from typing import Dict

_TABLE_PATH = os.path.join(os.path.dirname(__file__), "metric_references.json")

with open(_TABLE_PATH) as f:
    METRIC_REFERENCES: Dict[str, Dict[str, Dict[str, float]]] = json.load(f)


def beat_method(results: Dict[str, float], method_name: str) -> int:
    """Compare a {"{DS}/{seq}/{metric}": value} result dict against the
    named baseline; prints the report and returns the beat count."""
    table = METRIC_REFERENCES[method_name]
    beat_cnt = 0
    total_cnt = 0
    advantage = {"MSE": 0.0, "SSIM": 0.0, "LPIPS": 0.0}
    for sequence, metrics in table.items():
        for metric in ("MSE", "SSIM", "LPIPS"):
            ref_val = metrics[metric]
            val = results.get(f"{sequence}/{metric}")
            if val is None:
                continue
            total_cnt += 1
            adv = (val - ref_val) if metric == "SSIM" else (ref_val - val)
            advantage[metric] += adv
            if adv > 0:
                beat_cnt += 1
    print(f"Comparing results with {method_name}: "
          f"Beated {beat_cnt} / {total_cnt}")
    print("Advantage (larger is better): ", advantage)
    print("Total advantage: ", sum(advantage.values()))
    return beat_cnt
