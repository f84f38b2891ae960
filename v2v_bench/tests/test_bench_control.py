"""The control of each cell, at the cell's own size on the card: the
reference in the precision just below the configuration's (fp8 operands
for the bfloat16 train steps, TF32 for the float32 eval), put in the
program's place, fails at least one of the cell's limits; the program on
the same seed passes them all. Marked `card`: it skips without one.

    python -m pytest v2v_bench/tests/test_bench_control.py -q   # on a card
"""
import pytest

from v2v_bench import cell as cellmod
from v2v_bench.run import cache_dirs

SEED = 2 ** 31 + 4099


def _fails(nums, limits):
    return [k for k, lim in limits.items() if nums[k] > lim]


@pytest.mark.card
@pytest.mark.parametrize("name", cellmod.names())
def test_the_control_fails_and_the_program_passes(card, name):
    cache_dirs(cellmod.ROOT)
    c = cellmod.load(name)
    limits = c.spec["limits"]
    kind = cellmod.kind(c)
    assert _fails(kind.calibrate(c, SEED, "control", card), limits)
    assert not _fails(kind.calibrate(c, SEED, "program", card), limits)
