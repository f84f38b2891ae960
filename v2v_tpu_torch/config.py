"""Config system: YAML + `{target, params}` reflection.

Same schema as v2v_tpu/config.py: the reference's torch target strings
(`model.model.E2VIDRecurrent`, `torch.optim.Adam`, ...) resolve to this
package's implementations through TARGET_ALIASES. PyYAML is imported
only by `load_yaml`, so a machine without it can still build models
from dict configs.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict

# Reference target string -> v2v_tpu_torch implementation path.
TARGET_ALIASES: Dict[str, str] = {
    "model.model.E2VIDRecurrent": "v2v_tpu_torch.models.model.E2VIDRecurrent",
    "model.model.FlowNet": "v2v_tpu_torch.models.model.FlowNet",
    "model.model.ColorE2VID": "v2v_tpu_torch.models.model.ColorE2VID",
    "model.model.WFlowNet": "v2v_tpu_torch.models.model.WFlowNet",
    "model.model.FlowNetNoRecur": "v2v_tpu_torch.models.model.FlowNetNoRecur",
    "model.model.EVFlowNet": "v2v_tpu_torch.models.model.EVFlowNet",
    "model.model.FireNet": "v2v_tpu_torch.models.model.FireNet",
    "model.legacy.FireNet_legacy": "v2v_tpu_torch.models.legacy.FireNetLegacy",
    "model.eitr.eitr.EITR": "v2v_tpu_torch.models.eitr.EITR",
    "model.hyper_model.HyperE2VID": "v2v_tpu_torch.models.hyper.HyperE2VID",
    "model.eraft.eraft.ERAFT": "v2v_tpu_torch.models.eraft.ERAFT",
    "model.nernet_model.RepresentationRecurrent":
        "v2v_tpu_torch.models.nernet.RepresentationRecurrent",
    "torch.optim.Adam": "v2v_tpu_torch.training.optim.Adam",
    "torch.optim.AdamW": "v2v_tpu_torch.training.optim.AdamW",
    "torch.optim.SGD": "v2v_tpu_torch.training.optim.SGD",
    "torch.optim.lr_scheduler.StepLR": "v2v_tpu_torch.training.optim.StepLR",
    "torch.optim.lr_scheduler.ExponentialLR":
        "v2v_tpu_torch.training.optim.ExponentialLR",
    "torch.optim.lr_scheduler.CosineAnnealingLR":
        "v2v_tpu_torch.training.optim.CosineAnnealingLR",
    "torch.optim.lr_scheduler.ReduceLROnPlateau":
        "v2v_tpu_torch.training.optim.ReduceLROnPlateau",
    "data.testh5.TestH5Dataset": "v2v_tpu_torch.data.h5.TestH5Dataset",
    "data.testh5.TestH5FlowDataset": "v2v_tpu_torch.data.h5.TestH5FlowDataset",
    "data.testh5.TestH5EventDataset":
        "v2v_tpu_torch.data.h5.TestH5EventDataset",
    "data.testh5.TestH5CacheDataset":
        "v2v_tpu_torch.data.h5.TestH5CacheDataset",
    "data.testh5.FPS_H5Dataset": "v2v_tpu_torch.data.h5.FPSH5Dataset",
    "data.v2v_datasets.WebvidDatasetV2":
        "v2v_tpu_torch.data.webvid.WebvidDataset",
    "data.esim_dataset.ESIMH5Dataset": "v2v_tpu_torch.data.esim.ESIMH5Dataset",
}


def resolve_target(target: str) -> Any:
    """Resolve a target string (reference-style or native) to an object."""
    target = TARGET_ALIASES.get(target, target)
    module, name = target.rsplit(".", 1)
    return getattr(importlib.import_module(module), name)


def instantiate_from_config(config: Dict[str, Any], **extra) -> Any:
    """`{"target": "pkg.Class", "params": {...}}` -> instance."""
    if "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    cls = resolve_target(config["target"])
    return cls(**{**config.get("params", {}), **extra})


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml
    with open(path) as f:
        return yaml.load(f, Loader=yaml.Loader)
