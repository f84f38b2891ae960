"""Pre-build the voxel caches of HQF-format test h5 files, the input of
data/h5.py::TestH5CacheDataset (port of scripts/testh5_to_voxel_cache.py:
the same arguments, datasets and attrs).

    python -m v2v_tpu_torch.scripts.testh5_to_voxel_cache <h5_list.txt> <out_dir> [--num-bins 5] [--interpolate]

Each listed file is read whole through the port's TestH5Dataset, whose
voxels come from the C++ builder (data/native.py), and written to
`<out_dir>/<its name>` as `frames` (T, H, W) float32 in [0, 255] and
`events` (T, bins, H, W) float32, with the `num_bins` and
`interpolate_bins` attrs the reader checks. `cache_arrays` is the array
part and needs no h5py; `convert` reads and writes the files, which does.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Tuple

import numpy as np

from ..data.h5 import TestH5Dataset
from ..data.interface import read_path_list


def reader_config(num_bins: int, interpolate: bool) -> Dict[str, Any]:
    """TestH5Dataset's config for one window over the whole file."""
    return {"sequence_length": 10 ** 9, "num_bins": num_bins,
            "interpolate_bins": interpolate}


def cache_arrays(dataset: TestH5Dataset) -> Tuple[np.ndarray, np.ndarray]:
    """A TestH5Dataset built with `reader_config` -> (frames (T, H, W),
    events (T, bins, H, W)), both float32."""
    item = dataset[0]
    frames = np.ascontiguousarray(item["frame"][..., 0], np.float32)
    events = np.ascontiguousarray(item["events"].transpose(0, 3, 1, 2),
                                  np.float32)
    return frames, events


def convert(h5_path: str, out_path: str, num_bins: int,
            interpolate: bool) -> None:
    import h5py
    frames, events = cache_arrays(
        TestH5Dataset(h5_path, reader_config(num_bins, interpolate)))
    with h5py.File(out_path, "w") as f:
        f.attrs["num_bins"] = num_bins
        f.attrs["interpolate_bins"] = interpolate
        f.create_dataset("frames", data=frames)
        f.create_dataset("events", data=events)
    print(f"wrote {out_path}: {frames.shape[0]} frames")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("h5_list")
    p.add_argument("out_dir")
    p.add_argument("--num-bins", type=int, default=5)
    p.add_argument("--interpolate", action="store_true")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in read_path_list(args.h5_list):
        out = os.path.join(args.out_dir, os.path.basename(path))
        convert(path, out, args.num_bins, args.interpolate)


if __name__ == "__main__":
    main()
