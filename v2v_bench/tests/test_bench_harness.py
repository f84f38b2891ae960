"""What the harness imports, and that it is driven by data.

- Everything a run of each cell imports (the harness, the cell's driver
  and the program's modules it builds; kept cells too) holds no module whose top-level
  name is jax, jaxlib, flax or v2v_tpu, compared as whole names; the
  reference imports nothing of v2v_tpu_torch.
- A throwaway cell, configuration, traffic mix and metric, written as
  files into a copy of the folder, are listed and read with no other
  file edited.
- Each fault a cell can have, planted under the timed path of a whole
  run (all but the look for a card), turns `correct` false; a sound run
  at the small size, in float32, reads true.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from v2v_bench import cell as cellmod
from v2v_bench.run import FORBIDDEN, result
from v2v_bench.tests.small import CPU, eval_cell, train_cell
from v2v_bench.traffic import eval_windows, train

ROOT = cellmod.ROOT

_BUILD_EACH_CELL = """
import sys, torch
from v2v_bench import cell, run
from v2v_bench.tests.small import CPU, eval_cell, train_cell
for name in cell.kept():
    c = cell.from_files(name)
    kind = cell.kind(c)
    if c.traffic["kind"] == "train":
        c = train_cell(name)
        kind.Program(c.config, kind.make_weights(c.config, 1, CPU), CPU)
    else:
        c = eval_cell(name)
        kind.Program(c.config, kind.make_weights(c.config, 1, CPU), CPU)
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level_after(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_a_run_of_each_cell_imports_nothing_of_jax():
    loaded = _top_level_after(_BUILD_EACH_CELL)
    assert "v2v_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    mods = sorted(p.stem for p in (ROOT / "v2v_bench" / "reference").glob(
        "*.py") if p.stem != "__init__")
    code = "".join(f"import v2v_bench.reference.{m}\n" for m in mods)
    code += "import sys\nprint(' '.join({m.split('.')[0] for m in sys.modules}))"
    loaded = _top_level_after(code)
    assert not loaded & (FORBIDDEN | {"v2v_tpu_torch"})


def test_a_new_cell_is_added_with_files_alone(tmp_path):
    here = tmp_path / "v2v_bench"
    shutil.copytree(ROOT / "v2v_bench", here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    (here / "configs" / "e2vid_w16.json").write_text(json.dumps(
        dict(json.loads((here / "configs" / "e2vid.json").read_text()),
             name="e2vid_w16")))
    (here / "traffic" / "fast_clips.json").write_text(json.dumps(
        {"kind": "train", "pool_batches": 2, "max_speed_px": 3.0,
         "trace_steps": 2}))
    (here / "workloads" / "e2vid_w16.fast.json").write_text(json.dumps(
        {"config": "e2vid_w16", "traffic": "fast_clips", "chips": 1,
         "unit": "step", "flops_per_unit": 1, "limits": {}}))
    (here / "metrics" / "steps_traced.train.py").write_text(
        "def read(r):\n    return float(r.units)\n")
    bench["configs"].append({"name": "e2vid_w16", "source": "x",
                             "file": "v2v_bench/configs/e2vid_w16.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "e2vid_w16.fast",
                               "config": "e2vid_w16",
                               "traffic": "fast_clips", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "steps_traced.train", "unit": "1",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "the whole step",
                               "moves": "train_clips_per_s",
                               "workloads": ["e2vid_w16.fast"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    names = cellmod.names(here)
    assert "e2vid_w16.fast" in names and "e2vid.train" in names
    c = cellmod.load("e2vid_w16.fast", here)
    assert c.traffic["max_speed_px"] == 3.0 and c.config["name"] == \
        "e2vid_w16"
    assert [m["name"] for m in c.per_layer] == ["steps_traced.train"]
    assert cellmod.reader("steps_traced.train", here).read(
        type("R", (), {"units": 2})()) == 2.0
    after = {p: p.read_bytes() for p in before}
    assert after == before          # no file that was there changed


def _run(c, kind, fault, trace=False):
    out = kind.run(c, 1234567890123, 0.0, trace, CPU, lambda: 0.0, fault)
    return result(c, out, trace, CPU)


def _with(*faults):
    def plant(prog):
        for f in faults:
            f(prog)
    return plant


def _limits(c, name):
    return c._replace(spec=cellmod.from_files(name).spec)


def _cells(kind):
    return [n for n in cellmod.names()
            if cellmod.load(n).traffic["kind"] == kind]


@pytest.mark.parametrize("name", _cells("train"))
def test_a_sound_train_run_reads_correct(name):
    c = _limits(train_cell(name, float32=True), name)
    line = _run(c, train, train.LOOKS["float32_teacher"])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", _cells("train"))
@pytest.mark.parametrize("fault", sorted(train.FAULTS))
def test_a_train_fault_reads_not_correct(name, fault):
    c = _limits(train_cell(name, float32=True), name)
    line = _run(c, train, _with(train.LOOKS["float32_teacher"], train.FAULTS[fault]))
    assert not line["correct"], line["checks"]


def test_a_sound_eval_run_reads_correct():
    c = _limits(eval_cell(), "etnet.eval720")
    line = _run(c, eval_windows, None)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", sorted(eval_windows.FAULTS))
def test_an_eval_fault_reads_not_correct(fault):
    c = _limits(eval_cell(), "etnet.eval720")
    line = _run(c, eval_windows, eval_windows.FAULTS[fault])
    assert not line["correct"], line["checks"]


def test_without_a_card_a_run_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "v2v_bench.run",
                          "--workload", "e2vid.train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
