"""K1 (csrc/esim.cu, the event simulator) against its roofline, in %:
the least time its bytes need at the HBM peak (the uint8 video read once,
the bfloat16 counts written once; v2v_bench/kernels.py) over its mean
device time a launch."""
from v2v_bench.kernels import k1_seconds

K1 = r"(^|[ :])esim_kernel[<(]"


def read(r):
    seconds, launches = r.kernel(K1)
    if not launches:
        return None
    tr = r.cell.config["train"]
    frames = tr["sequence_length"] * tr["num_bins"] * tr["frames_per_bin"] + 1
    bound = k1_seconds(tr["batch"], frames, tr["crop_size"], tr["crop_size"])
    return 100.0 * bound / (seconds / launches)
