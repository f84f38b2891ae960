"""The FLOP count each cell's file stores is the frozen rules' count of
the plain reference at the cell's shapes, and it does not move with how
the program runs the step (LPIPS recomputed or not)."""
import copy

import pytest

from v2v_bench import cell as cellmod
from v2v_bench import flops


@pytest.mark.parametrize("name", cellmod.kept())
def test_stored_count_is_the_recount(name):
    c = cellmod.from_files(name)
    assert flops.cell_flops(c) == c.spec["flops_per_unit"]


@pytest.mark.parametrize("remat", ["full", "none"])
def test_count_does_not_depend_on_lpips_remat(remat):
    c = cellmod.load("e2vid.train")
    cfg = copy.deepcopy(c.config)
    cfg["module"]["loss"]["lpips_remat"] = remat
    assert flops.train_step_flops(cfg) == c.spec["flops_per_unit"]
