"""The readings that the limits of `correct` are set from, for one cell,
in one process (its set-up is paid once a seed, and no window is run):

    python3 -m v2v_bench.calibrate --workload <cell> --seeds 1,2,3
        [--control 4,5,6] [--faults half_batch:7,8,9]

Each seed prints one JSON line of the numbers compared, for the program
(the lower readings: their largest over the seeds), for the control (the
reference in the precision below the configuration's, against the
reference: the upper readings, their smallest) and for each fault the
cell's kind can have, planted in the program. A summary line ends the
output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from . import cell as cellmod
    from .run import cache_dirs
    ap = argparse.ArgumentParser(prog="python3 -m v2v_bench.calibrate",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", action="append", default=[],
                    help="<fault>:<seed>,<seed>,...")
    args = ap.parse_args(argv)
    cell = cellmod.load(args.workload)
    cache_dirs(cellmod.ROOT)
    import torch
    dev = torch.device("cuda", 0)
    kind = cellmod.kind(cell)
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    plan = [("program", s) for s in seeds(args.seeds)]
    plan += [("control", s) for s in seeds(args.control)]
    for f in args.faults:
        name, _, ss = f.partition(":")
        plan += [(name, s) for s in seeds(ss)]
    seen = {}
    for side, seed in plan:
        t = time.perf_counter()
        nums = kind.calibrate(cell, seed, side, dev)
        seen.setdefault(side, []).append(nums)
        print(json.dumps({"side": side, "seed": seed, "checks": nums,
                          "seconds": time.perf_counter() - t}), flush=True)
    summary = {}
    for side, rows in seen.items():
        pick = max if side == "program" else min
        summary[side] = {k: pick(r[k] for r in rows) for k in rows[0]
                         if isinstance(rows[0][k], float)}
    print(json.dumps({"summary": summary,
                      "card": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
