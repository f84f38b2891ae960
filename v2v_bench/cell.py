"""What the harness finds by name. `BENCHMARK.json` at the checkout's
root lists the cells and the metrics; each cell, configuration, traffic
mix, traffic kind and per-layer metric lives in a file of its own:

    v2v_bench/workloads/<cell>.json    config, traffic, chips, the FLOP
                                       count, the limits of `correct`
    v2v_bench/configs/<config>.json    the configuration as it is run
    v2v_bench/traffic/<mix>.json       a traffic mix's parameters and
                                       its kind
    v2v_bench/traffic/<kind>.py        the code that drives a kind:
                                       `run(cell, seed, seconds, trace)`
    v2v_bench/metrics/<metric>.py      `read(readings)` -> a number or
                                       None

so a new cell, configuration, mix or metric is added with files alone.
A workload file that BENCHMARK.json does not list is a cell kept for a
later one: the harness does not run it; the tests still build it.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, NamedTuple, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    spec: Dict[str, Any]          # workloads/<cell>.json
    config: Dict[str, Any]        # configs/<config>.json
    traffic: Dict[str, Any]       # traffic/<mix>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], name: str) -> bool:
    return name in metric.get("workloads", [name])


def from_files(name: str, here: Optional[Path] = None) -> Cell:
    """Cell `name` from its own files alone, with no metrics: a cell of
    BENCHMARK.json, or one whose files are kept for a later one."""
    here = here or HERE
    spec = _json(here / "workloads" / f"{name}.json")
    return Cell(name, spec["chips"], spec,
                _json(here / "configs" / f"{spec['config']}.json"),
                _json(here / "traffic" / f"{spec['traffic']}.json"), [], [])


def load(name: str, here: Optional[Path] = None,
         benchmark: Optional[Path] = None) -> Cell:
    """Cell `name` as BENCHMARK.json and its files give it. `here` is
    the harness's folder, `benchmark` the BENCHMARK.json to read (both
    default to this checkout's)."""
    here = here or HERE
    bench = _json(benchmark or here.parent / "BENCHMARK.json")
    entry = [w for w in bench["workloads"] if w["name"] == name]
    if not entry:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entry[0]
    cell = from_files(name, here)
    for key in ("config", "traffic", "chips"):
        if cell.spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} "
                             f"{cell.spec[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    return cell._replace(
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def names(here: Optional[Path] = None,
          benchmark: Optional[Path] = None) -> List[str]:
    """The cells of BENCHMARK.json."""
    here = here or HERE
    bench = _json(benchmark or here.parent / "BENCHMARK.json")
    return [w["name"] for w in bench["workloads"]]


def kept(here: Optional[Path] = None) -> List[str]:
    """Every cell with a workload file, BENCHMARK.json's and those kept
    for a later one."""
    return sorted(p.name[:-len(".json")]
                  for p in (here or HERE).glob("workloads/*.json"))


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(cell: Cell) -> ModuleType:
    """The traffic kind's driver, `traffic/<kind>.py`, imported as a
    module of this package so that it can import its siblings."""
    return importlib.import_module(f"{__package__}.traffic."
                                   f"{cell.traffic['kind']}")


def reader(metric: str, here: Optional[Path] = None) -> ModuleType:
    """`metrics/<metric>.py` (a metric's name may hold dots)."""
    here = here or HERE
    return _module(here / "metrics" / f"{metric}.py",
                   f"v2v_bench_metric_{metric.replace('.', '_')}")
