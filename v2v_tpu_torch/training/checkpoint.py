"""Checkpoints and the `ckpt_paths` protocol (port of
v2v_tpu/training/checkpoint.py).

Training appends each saved path to `ckpt_paths/{experiment}.txt`;
resume and tests load the LAST line (reference README.md:9-13,
train.py:176-222). A checkpoint is the reference's torch layout
`{"state_dict", "epoch", "optimizer", "lr_scheduler"}` (train.py:146-151),
with the optimizer's and the scheduler's `state_dict()` in place of the
pickled objects. BatchNorm running statistics travel in `state_dict`.
`load_params_only` also reads a bare state_dict, and the JAX package's
`.msgpack` checkpoints (`{"params": variables, "opt_state", "meta"}`,
v2v_tpu/training/checkpoint.py), whose variables it carries across with
models/convert.py::jax_params_to_state_dict; their optimizer state does
not map onto torch's, so training does not resume from one.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..models.convert import (_strip_wrappers, jax_params_to_state_dict,
                              load_torch_checkpoint)
from ..utils.msgpack import restore


def save_checkpoint(path: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer], epoch: int,
                    scheduler: Any = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({
        "state_dict": model.state_dict(),
        "epoch": epoch,
        "optimizer": None if optimizer is None else optimizer.state_dict(),
        "lr_scheduler": None if scheduler is None else scheduler.state_dict(),
    }, path)


def load_checkpoint(path: str, model: nn.Module) -> Dict[str, Any]:
    """Load a checkpoint's weights into `model` (every key must match, up
    to the `module.` / `_orig_mod.` prefixes) and return the rest of it:
    `epoch`, `optimizer` and `lr_scheduler` states, for
    `load_optimizer_state` and the scheduler's `load_state_dict`."""
    saved = torch.load(path, map_location="cpu", weights_only=False)
    model.load_state_dict({_strip_wrappers(k): v
                           for k, v in saved["state_dict"].items()})
    return {k: saved.get(k) for k in ("epoch", "optimizer", "lr_scheduler")}


def _group_layout(groups) -> List[tuple]:
    """What a saved optimizer state must share with an optimizer to fit
    it: per param group, its parameter count, its option names (they name
    the optimizer's kind) and amsgrad (it adds a moment)."""
    return [(len(g["params"]), sorted(k for k in g if k != "params"),
             g.get("amsgrad")) for g in groups]


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state: Optional[Dict[str, Any]]) -> bool:
    """Restore a saved optimizer state (its moments and step counts) when
    its param groups fit `optimizer`'s, keeping `optimizer`'s own options
    (the stage's config); otherwise leave it fresh, as the JAX driver
    drops an optimizer state of another structure (train.py:266-270).
    Returns whether the state was restored."""
    if not state or _group_layout(state["param_groups"]) != _group_layout(
            optimizer.param_groups):
        return False
    options = [{k: v for k, v in g.items() if k != "params"}
               for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, opts in zip(optimizer.param_groups, options):
        group.update(opts)
    return True


def _numpy_leaves(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _numpy_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):       # bfloat16, exact in float32
        return tree.float().numpy()
    return tree


def jax_checkpoint_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a JAX package `.msgpack` checkpoint's variables
    (params, and batch_stats where the model has them)."""
    with open(path, "rb") as f:
        state = restore(f.read())
    return jax_params_to_state_dict(_numpy_leaves(state["params"]))


def load_params_only(path: str, model: nn.Module) -> nn.Module:
    """Load a checkpoint's weights into `model` with strict=False
    semantics (test_e2vid.py:188): keys the model lacks are ignored,
    parameters the file lacks keep their values. `module.` (DDP) and
    `_orig_mod.` (torch.compile) prefixes are stripped. A `.msgpack` path
    is a JAX package checkpoint."""
    sd = (jax_checkpoint_state_dict(path) if path.endswith(".msgpack")
          else load_torch_checkpoint(path))
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
