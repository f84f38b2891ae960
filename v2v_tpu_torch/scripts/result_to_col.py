"""One row of all_test_results_new.csv as a column, one metric a line,
grouped by dataset, for pasting into a spreadsheet (port of
scripts/result_to_col.py: the same argv and output).

    python -m v2v_tpu_torch.scripts.result_to_col <csv_path> [row_index=-1]
"""
from __future__ import annotations

import sys

from .registry import METRICS, SEQUENCES, print_columns


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    print_columns(argv[0], int(argv[1]) if len(argv) > 1 else -1,
                  SEQUENCES, METRICS)


if __name__ == "__main__":
    main()
