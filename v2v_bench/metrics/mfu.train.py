"""The whole train step's share of the card's dense bfloat16 peak, in %:
the cell's fixed FLOP count a train step (stored in its file, counted on
the plain reference by v2v_bench/flops.py) over the window's seconds a
step (untraced, by the host's clock), so that the profiler's cost does
not read as a slower step."""
from v2v_bench.kernels import BF16_FLOPS


def read(r):
    return 100.0 * r.cell.spec["flops_per_unit"] / r.untraced_unit_s \
        / BF16_FLOPS
