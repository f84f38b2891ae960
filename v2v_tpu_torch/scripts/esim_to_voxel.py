"""Stack raw ESIM event h5 files into the voxel caches that
`data/esim.py::ESIMH5Dataset` reads (port of scripts/esim_to_voxel.py;
reference scripts/esim_to_voxel.py): runs DynamicH5Dataset over each
input and stores its frames, flow and voxels channels-first, with
temporal-bilinear or discrete bins. Needs h5py, so it runs on the CPU.

    python -m v2v_tpu_torch.scripts.esim_to_voxel <in_glob> <out_dir> [--discrete]
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from v2v_tpu_torch.data.legacy import DynamicH5Dataset


def convert(in_path: str, out_path: str, temporal_bilinear: bool) -> None:
    import h5py
    ds = DynamicH5Dataset(in_path, temporal_bilinear=temporal_bilinear)
    frames, flow, events, stamps, dts = [], [], [], [], []
    for i in range(len(ds)):
        item = ds[i]
        frames.append(np.moveaxis(item["frame"], -1, 0))
        flow.append(np.moveaxis(item["flow"], -1, 0))
        events.append(np.moveaxis(item["events"], -1, 0))
        stamps.append(item["timestamp"])
        dts.append(item["dt"])
    ds.h5_file.close()
    with h5py.File(out_path, "w") as f:
        f.attrs["sensor_resolution"] = ds.sensor_resolution
        f.attrs["source"] = "esim"
        f.create_dataset("frames", data=np.stack(frames), dtype=np.float32)
        f.create_dataset("flow", data=np.stack(flow), dtype=np.float32)
        f.create_dataset("events", data=np.stack(events), dtype=np.float32)
        f.create_dataset("timestamps", data=np.stack(stamps),
                         dtype=np.float32)
        f.create_dataset("dt", data=np.stack(dts), dtype=np.float32)
    print(f"wrote {out_path}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("in_glob")
    p.add_argument("out_dir")
    p.add_argument("--discrete", action="store_true",
                   help="discrete binning instead of temporal bilinear")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in sorted(glob.glob(args.in_glob)):
        convert(path, os.path.join(args.out_dir, os.path.basename(path)),
                temporal_bilinear=not args.discrete)


if __name__ == "__main__":
    main()
