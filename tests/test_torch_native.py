"""The port's C++ voxel builder (v2v_tpu_torch/csrc/voxel_builder.cpp,
data/native.py) against the JAX package's and the numpy voxelizer: the
same bits as JAX's builder, within 1e-9 of events_to_voxel_np for
bilinear bins; empty input and coordinates off the frame; where the
library lands; a failed build raises; two processes building at once;
the port's TestH5Dataset with its default builder against JAX's."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from v2v_tpu.data import h5 as jh5
from v2v_tpu.data.native import events_to_voxel_native as j_native

from v2v_tpu_torch.data import h5 as th5
from v2v_tpu_torch.data import native
from v2v_tpu_torch.ops._build import build_dir
from v2v_tpu_torch.ops.voxel import events_to_voxel_np

from subproc_env import cpu_env
from test_data import make_hqf_h5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the bilinear weights come from t_us * scale in C++ and from
# t_us / (dt + 1e-4) * (B - 1) in numpy (tests/test_native.py's bound)
BILINEAR_ATOL = 1e-9


def _events(n=60_000, h=45, w=61, seed=0):
    rng = np.random.RandomState(seed)
    ts = np.sort(rng.rand(n)) * 0.05 + 1000.0
    return (ts, rng.randint(0, w, n).astype(np.uint16),
            rng.randint(0, h, n).astype(np.uint16),
            rng.randint(0, 2, n).astype(np.uint8))


@pytest.mark.parametrize("interp", [False, True])
def test_builder_matches_jax_and_numpy(interp):
    """At 60,000 events the bilinear path runs its thread a bin."""
    kw = dict(num_bins=5, height=45, width=61, interpolate_bins=interp)
    ev = _events()
    got = native.events_to_voxel_native(*ev, **kw)
    assert got.dtype == np.float64 and got.shape == (5, 45, 61)
    np.testing.assert_array_equal(got, j_native(*ev, **kw))
    want = events_to_voxel_np(*ev, **kw)
    if interp:
        np.testing.assert_allclose(got, want, rtol=0, atol=BILINEAR_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


def test_empty_input_and_out_of_bounds():
    got = native.events_to_voxel_native(
        np.zeros(0), np.zeros(0, np.int32), np.zeros(0, np.int32),
        np.zeros(0, np.uint8), num_bins=5, height=8, width=8)
    assert got.shape == (5, 8, 8) and not got.any()
    ts, xs, ys, ps = _events(100, 8, 8)
    for bad_x, bad_y in ((8, 0), (0, 8)):
        x, y = xs.astype(np.int32), ys.astype(np.int32)
        x[50], y[50] = bad_x, bad_y
        with pytest.raises(IndexError, match="out of bounds"):
            native.events_to_voxel_native(ts, x, y, ps, num_bins=5,
                                          height=8, width=8)


def test_library_lands_in_the_port_build_dir(tmp_path, monkeypatch):
    """The default library sits under the port's build directory; one
    built into another build directory lands there, named by the hash
    of its compiler, flags and source, and is the only file written
    there. (The JAX package's own builder may write under v2v_tpu/ in
    another test at the same time, so that tree is not listed here.)"""
    path = native.LIB.build()["path"]
    assert path.parent == build_dir()
    assert not str(path).startswith(os.path.join(ROOT, "v2v_tpu") + os.sep)
    monkeypatch.setenv("V2V_TORCH_BUILD_DIR", str(tmp_path))
    lib = native.HostLibrary("voxel_builder.cpp")
    built = lib.build()
    assert not built["cached"] and built["path"].parent == tmp_path
    assert built["path"].name.startswith("libvoxel_builder_")
    assert lib.build()["cached"]
    assert sorted(os.listdir(tmp_path)) == [built["path"].name]


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_a_failed_build_raises(tmp_path, monkeypatch, cxx):
    """A compiler that is missing or fails: the build raises and names
    its command, and the voxelizer raises too, without a numpy
    fallback."""
    monkeypatch.setenv("V2V_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "LIB", native.HostLibrary(
        "voxel_builder.cpp", cxx=cxx))
    with pytest.raises(RuntimeError, match=re.escape(f"{cxx} -O3")):
        native.LIB.build()
    with pytest.raises(RuntimeError, match="did not build"):
        native.events_to_voxel_native(*_events(10), num_bins=5, height=45,
                                      width=61)
    assert not native.native_available()
    assert os.listdir(tmp_path) == []


_LOAD = """
import numpy as np
from v2v_tpu_torch.data.native import LIB, events_to_voxel_native
rng = np.random.RandomState(0)
ts = np.sort(rng.rand(1000))
v = events_to_voxel_native(ts, rng.randint(0, 9, 1000), rng.randint(0, 7, 1000),
                           rng.randint(0, 2, 1000), num_bins=3, height=7, width=9)
print(LIB.build()["path"], float(np.abs(v).sum()))
"""


def test_two_processes_build_and_load_at_once(tmp_path):
    """Two fresh processes, started together on an empty build
    directory, each build or find the library and load a whole file;
    one library and no partial file remain."""
    env = dict(cpu_env(), V2V_TORCH_BUILD_DIR=str(tmp_path),
               PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    lines = [o.split() for o, _ in outs]
    assert lines[0] == lines[1] and float(lines[0][1]) > 0
    assert os.listdir(tmp_path) == [os.path.basename(lines[0][0])]


@pytest.mark.parametrize("interp", [False, True])
def test_testh5_default_builder_equals_jax_default(tmp_path, interp):
    """Neither config names use_native_voxel_builder: both readers take
    their C++ builder, and the items are the same bits."""
    path = make_hqf_h5(str(tmp_path / "seq.h5"), n_frames=7)
    cfg = {"sequence_length": 3, "num_bins": 5, "interpolate_bins": interp,
           "dataset_name": "hqf", "output_additional_evs": True}
    ours, theirs = th5.TestH5Dataset(path, cfg), jh5.TestH5Dataset(path, cfg)
    assert ours.use_native and theirs.use_native
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert a["events"].shape == b["events"].shape == (4, 24, 32, 5)
        np.testing.assert_array_equal(a["events"], b["events"])
        np.testing.assert_array_equal(a["frame"], b["frame"])
