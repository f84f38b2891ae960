"""The ground-truth frames of h5 test sequences as PNGs, in the layout of
the harnesses' output directories (port of scripts/save_gt_images.py:
the same files, pixels and lines), for side-by-side videos and figures.
Needs h5py.

    python -m v2v_tpu_torch.scripts.save_gt_images <h5_list.txt> <dataset_name> <out_dir>
"""
from __future__ import annotations

import os
import sys

from ..data.interface import read_path_list
from ..utils.png import write_png


def main(list_file: str, dataset_name: str, out_dir: str) -> None:
    import h5py
    for path in read_path_list(list_file):
        seq = os.path.basename(path).split(".")[0]
        seq_dir = os.path.join(out_dir, dataset_name.upper(), seq)
        os.makedirs(seq_dir, exist_ok=True)
        with h5py.File(path, "r") as f:
            keys = sorted(f["images"].keys())
            # frame i pairs with events[i-1, i], so the first is dropped,
            # as TestH5Dataset drops it
            for out_idx, key in enumerate(keys[1:]):
                write_png(os.path.join(seq_dir, f"{out_idx:06d}.png"),
                          f["images"][key][()])
        print(f"{seq}: {len(keys) - 1} frames")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3])
