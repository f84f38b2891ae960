"""Write the benchmark h5 lists of the test configs from the sequence
registry (port of scripts/generate_test_lists.py: the same arguments and
files).

The test configs read `configs/{hqf,ijrr,mvsec,evaid}_test.txt` and
`configs/mvsec_test_flow.txt`, one h5 path a line. The sequences are the
rows of the regression table the port ships
(v2v_tpu_torch/eval/metric_references.json) and the flow registry's
MVSEC sets, so the lists follow from a dataset root:

    python -m v2v_tpu_torch.scripts.generate_test_lists --root DIR [--out DIR] [--check]

expects `{root}/{HQF,IJRR,MVSEC,EVAID}/{sequence}.h5` and
`{root}/MVSEC_flow/{sequence}.h5`. With --check a missing file fails the
run before any list is written.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from .registry import FLOW_SEQUENCES

REFS = Path(__file__).resolve().parents[1] / "eval" / "metric_references.json"
# the repository's configs/, beside the package
CONFIGS = Path(__file__).resolve().parents[2] / "configs"


def sequences_by_dataset():
    with open(REFS) as f:
        table = json.load(f)
    out = {}
    for method in table.values():
        for key in method:
            ds, seq = key.split("/", 1)
            out.setdefault(ds, set()).add(seq)
    return {ds: sorted(seqs) for ds, seqs in out.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="dataset root: {root}/{DATASET}/{seq}.h5")
    ap.add_argument("--out", default=str(CONFIGS))
    ap.add_argument("--check", action="store_true",
                    help="fail if any listed h5 is missing")
    args = ap.parse_args(argv)

    lists = {}
    for ds, seqs in sequences_by_dataset().items():
        lists[f"{ds.lower()}_test.txt"] = [
            os.path.join(args.root, ds, f"{s}.h5") for s in seqs]
    lists["mvsec_test_flow.txt"] = [
        os.path.join(args.root, "MVSEC_flow", f"{s}.h5")
        for s in FLOW_SEQUENCES["MVSEC"]]

    # checked before any write: with --check a failure leaves the lists
    # as they were
    missing = [p for paths in lists.values() for p in paths
               if not os.path.exists(p)]
    if missing:
        print(f"{len(missing)} listed files do not exist under "
              f"{args.root} (first: {missing[0]})")
        if args.check:
            print("--check: no list files written")
            sys.exit(1)

    for fname, paths in lists.items():
        path = os.path.join(args.out, fname)
        with open(path, "w") as f:
            f.write("\n".join(paths) + "\n")
        print(f"wrote {path} ({len(paths)} sequences)")


if __name__ == "__main__":
    main()
