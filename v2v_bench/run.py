"""One run of one cell of the benchmark of v2v_tpu_torch:

    python3 -m v2v_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout holding the port. Set-up (the weights and
inputs made on the card from the seed, the program built, every shape the
cell uses warmed), then a window of `--seconds`, then the plain reference
and the comparison that decides `correct`. The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer
metrics, read from a profiled stretch of the window), `device`, with
`--trace 1` a `breakdown`, and last `checks`, each number compared with
its limit; the same numbers end standard error. Exits 2 without a result
where the card or the cards the cell asks for are missing, and 3 where a
module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import cell as cellmod  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "v2v_tpu"})


def cache_dirs(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a checkout's first run builds."""
    build = root / "build"
    os.environ["V2V_TORCH_BUILD_DIR"] = str(build / "v2v_tpu_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "v2v_bench" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(build / "v2v_bench" / "triton")


def forbidden_loaded():
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def result(cell, out: dict, trace: bool, dev) -> dict:
    """The result line of a driver's run `out`."""
    import torch
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cellmod.reader(m["name"]).read(out["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=out["setup_s"])
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    limits = cell.spec.get("limits") or {k: None for k in out["checks"]}
    checks = {k: {"value": out["checks"][k], "limit": lim}
              for k, lim in limits.items()}
    correct = out["failed"] == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit": _power_limit() if dev.type == "cuda" else ""}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = out["readings"].busy_s
        device["window_s"] = out["readings"].window_s
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m v2v_bench.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cellmod.load(args.workload)
    cache_dirs(cellmod.ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"v2v_bench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    seed = args.seed % 2 ** 64
    out = cellmod.kind(cell).run(cell, seed, args.seconds, bool(args.trace),
                                 dev, lambda: time.perf_counter() - _T0)
    leaked = forbidden_loaded()
    if leaked:
        print(f"v2v_bench: modules of JAX or the JAX package were loaded: "
              f"{leaked}", file=sys.stderr)
        return 3
    line = result(cell, out, bool(args.trace), dev)
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
