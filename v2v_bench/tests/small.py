"""Cells cut to a size the CPU runs in seconds, for the benchmark's
tests: B=2 clips of T=4 frames at 64x64 (the temporal-consistency loss
from frame 2), and 64x96 eval windows of 3 frames, two a sequence (the
eval cell's files are kept for a later benchmark: BENCHMARK.json does
not list it)."""
from __future__ import annotations

import copy
import json

import torch

from v2v_bench import cell as cellmod

CPU = torch.device("cpu")


def train_cell(name: str = "e2vid.train", float32: bool = False,
               config: str = None):
    """A train cell at the small size, or (`config`) that cell's traffic
    under another configuration file; `float32` runs the program's step
    and its teacher in float32, as the reference, so that the two agree
    to rounding."""
    c = cellmod.load(name)
    cfg = copy.deepcopy(c.config if config is None else json.loads(
        (cellmod.HERE / "configs" / f"{config}.json").read_text()))
    cfg["train"].update(batch=2, sequence_length=4, crop_size=64)
    cfg["module"]["loss"]["temporal_consistency_L0"] = 2
    cfg["reference_block"] = 1
    if float32:
        cfg["module"]["compute_dtype"] = "float32"
    return c._replace(config=cfg, traffic=dict(c.traffic, pool_batches=3))


def eval_cell(name: str = "etnet.eval720"):
    c = cellmod.from_files(name)
    cfg = copy.deepcopy(c.config)
    cfg["test"]["sequence_length"] = 3
    return c._replace(config=cfg, traffic=dict(
        c.traffic, height=64, width=96, events_per_frame=2000,
        windows_per_sequence=2, compare_past_boundary=2))
