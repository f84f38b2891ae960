"""The benchmark sequence registry of the result-formatting scripts (port
of scripts/_registry.py): the e2vid sets and their metrics, the flow sets
and theirs, taken from the port's harnesses, and the column printer the
two scripts share."""
from __future__ import annotations

from typing import Dict, List, Sequence

from ..eval.flow_harness import FLOW_SEQUENCES
from ..eval.harness import METRICS, SEQUENCES
from ..training.flow_interface import FLOW_METRICS

__all__ = ["SEQUENCES", "METRICS", "FLOW_SEQUENCES", "FLOW_METRICS",
           "print_columns"]


def print_columns(csv_path: str, row: int, sequences: Dict[str, List[str]],
                  metrics: Sequence[str]) -> None:
    """Print row `row` of a results CSV (a header line of
    `<dataset>/<sequence>/<metric>` columns, the checkpoint first) as one
    value a line, a `# <dataset>/<metric>` heading before each group, in
    the registry's order; a column the CSV lacks prints empty."""
    with open(csv_path) as f:
        lines = [line.strip() for line in f if line.strip()]
    header = lines[0].split(",")
    values = lines[row].split(",")
    table = dict(zip(header, values))
    print("Checkpoint:", values[0])
    for ds, seqs in sequences.items():
        for metric in metrics:
            print(f"# {ds}/{metric}")
            for seq in seqs:
                print(table.get(f"{ds}/{seq}/{metric}", ""))
