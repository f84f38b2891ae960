"""Event-count maps of the test sequences (port of
scripts/testset_evcnt_maps.py: the same files, pixels and lines): the
events of each listed h5 summed a pixel and saved as a PNG normalized at
the 99th percentile, to eyeball hot pixels and sensor coverage. Needs
h5py.

    python -m v2v_tpu_torch.scripts.testset_evcnt_maps <h5_list.txt> [out_dir=debug/evcnt]
"""
from __future__ import annotations

import os
import sys

import numpy as np

from ..data.interface import read_path_list
from ..utils.png import write_png


def main(list_file: str, out_dir: str) -> None:
    import h5py
    os.makedirs(out_dir, exist_ok=True)
    for path in read_path_list(list_file):
        name = os.path.basename(path).split(".")[0]
        with h5py.File(path, "r") as f:
            xs = f["events/xs"][:]
            ys = f["events/ys"][:]
            if "images" in f:
                keys = sorted(f["images"].keys())
                h, w = f["images"][keys[0]].shape[:2]
            else:
                h, w = int(ys.max()) + 1, int(xs.max()) + 1
        counts = np.zeros((h, w))
        np.add.at(counts, (ys, xs), 1)
        norm = np.clip(counts / max(np.percentile(counts, 99), 1) * 255,
                       0, 255).astype(np.uint8)
        write_png(os.path.join(out_dir, f"{name}_evcnt.png"), norm)
        print(f"{name}: {int(counts.sum())} events, "
              f"max/pixel {int(counts.max())}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "debug/evcnt")
