"""The whole frame's share of the card's dense bfloat16 peak, in %:
the cell's fixed FLOP count a frame (stored in its file, counted on the
plain reference by v2v_bench/flops.py) over the seconds a frame of the
window's untraced eval windows (by the host's clock; the profiler's
start, traced window and end left out)."""
from v2v_bench.kernels import BF16_FLOPS


def read(r):
    return 100.0 * r.cell.spec["flops_per_unit"] / r.untraced_unit_s \
        / BF16_FLOPS
