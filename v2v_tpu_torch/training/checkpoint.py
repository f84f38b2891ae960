"""The `ckpt_paths` protocol and params-only loading (port of the part of
v2v_tpu/training/checkpoint.py that the eval harness uses).

Training appends each saved path to `ckpt_paths/{experiment}.txt`;
resume and tests load the LAST line (reference README.md:9-13,
train.py:176-222). The port reads torch checkpoints: a `{"state_dict":
...}` file or a bare state_dict, as the reference saves them. The JAX
package's msgpack checkpoints are not read here.
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch
from torch import nn

from ..models.convert import _strip_wrappers


def load_params_only(path: str, model: nn.Module) -> nn.Module:
    """Load a checkpoint's weights into `model` with strict=False
    semantics (test_e2vid.py:188): keys the model lacks are ignored,
    parameters the file lacks keep their values. `module.` (DDP) and
    `_orig_mod.` (torch.compile) prefixes are stripped."""
    saved = torch.load(path, map_location="cpu", weights_only=False)
    sd = saved.get("state_dict", saved)
    sd = {_strip_wrappers(k): v for k, v in sd.items()}
    model.load_state_dict(sd, strict=False)
    return model


def ckpt_paths_file(experiment_name: str, root: str = ".") -> str:
    return os.path.join(root, "ckpt_paths", f"{experiment_name}.txt")


def last_ckpt_path(experiment_name: str, root: str = ".") -> Optional[str]:
    """Last non-empty line, or None (train.py:176-188); creates an empty
    paths file when there is none."""
    pf = ckpt_paths_file(experiment_name, root)
    if not (os.path.exists(pf) and os.path.getsize(pf) > 0):
        os.makedirs(os.path.dirname(pf), exist_ok=True)
        open(pf, "a").close()
        return None
    lines = all_ckpt_paths(experiment_name, root)
    return lines[-1] if lines else None


def all_ckpt_paths(experiment_name: str, root: str = ".") -> List[str]:
    pf = ckpt_paths_file(experiment_name, root)
    if not os.path.exists(pf):
        return []
    with open(pf) as f:
        return [ln.strip() for ln in f if ln.strip()]


def append_ckpt_path(experiment_name: str, path: str, root: str = ".") -> None:
    pf = ckpt_paths_file(experiment_name, root)
    os.makedirs(os.path.dirname(pf), exist_ok=True)
    with open(pf, "a") as f:
        f.write(path + "\n")
