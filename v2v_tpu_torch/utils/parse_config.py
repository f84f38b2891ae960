"""Legacy JSON config system (a copy of v2v_tpu/utils/parse_config.py;
reference utils/parse_config.py, secondary and effectively dead there,
kept for config compatibility): a JSON config, dotted-keychain CLI
overrides and timestamped save dirs.
"""
from __future__ import annotations

import json
from datetime import datetime
from functools import reduce
from operator import getitem
from pathlib import Path
from typing import Any, Dict, Optional


def _set_by_path(tree: Dict, keys: str, value: Any) -> None:
    keys = keys.split(";")
    reduce(getitem, keys[:-1], tree)[keys[-1]] = value


def _get_by_path(tree: Dict, keys) -> Any:
    return reduce(getitem, keys, tree)


def _update_config(config: Dict, modification: Optional[Dict]) -> Dict:
    if not modification:
        return config
    for k, v in modification.items():
        if v is not None:
            _set_by_path(config, k, v)
    return config


class ConfigParser:
    """JSON experiment config with checkpoint-dir bookkeeping: the config
    goes to `<save_dir>/models/<name>/<run_id>/config.json`, logs to
    `<save_dir>/log/<name>/<run_id>`."""

    def __init__(self, config: Dict, resume: Optional[str] = None,
                 modification: Optional[Dict] = None,
                 run_id: Optional[str] = None):
        self._config = _update_config(dict(config), modification)
        self.resume = resume

        save_dir = Path(self.config["trainer"]["save_dir"])
        exper_name = self.config["name"]
        if run_id is None:
            run_id = datetime.now().strftime(r"%m%d_%H%M%S")
        self._save_dir = save_dir / "models" / exper_name / run_id
        self._log_dir = save_dir / "log" / exper_name / run_id
        self.save_dir.mkdir(parents=True, exist_ok=(run_id == ""))
        self.log_dir.mkdir(parents=True, exist_ok=True)
        with open(self.save_dir / "config.json", "w") as f:
            json.dump(self.config, f, indent=4)

    @classmethod
    def from_file(cls, path: str, resume: Optional[str] = None,
                  modification: Optional[Dict] = None) -> "ConfigParser":
        with open(path) as f:
            config = json.load(f)
        return cls(config, resume=resume, modification=modification)

    def init_obj(self, name: str, registry: Dict[str, Any], *args, **kwargs):
        """`config[name]` = {"type": ..., "args": {...}} -> instance."""
        module_name = self[name]["type"]
        module_args = dict(self[name].get("args", {}))
        module_args.update(kwargs)
        return registry[module_name](*args, **module_args)

    def __getitem__(self, name: str):
        return self.config[name]

    @property
    def config(self) -> Dict:
        return self._config

    @property
    def save_dir(self) -> Path:
        return self._save_dir

    @property
    def log_dir(self) -> Path:
        return self._log_dir
