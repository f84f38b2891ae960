"""The port's last tools against the JAX package's repo-root scripts on
the same synthetic inputs: the sequence registry and its column scripts,
the test-list generator, the h5 voxel-cache writer, the event-count and
GT image dumps, the PNG writer, the ESIM sample renderer and the library
example (v2v_tpu_torch/scripts/, utils/png.py). The root scripts are
imported by path and never edited. Also F4: every csrc source ships in
the port's package data."""
import ast
import contextlib
import fnmatch
import importlib.util
import io
import os
import sys
import tomllib

import cv2
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2v_tpu_torch.data import h5 as th5
from v2v_tpu_torch.data.synthetic import SyntheticH5Sequence, synthetic_hqf
from v2v_tpu_torch.scripts import (flow_result_to_col, generate_test_lists,
                                   minimal_train, registry, result_to_col,
                                   save_gt_images, testh5_to_voxel_cache,
                                   testset_evcnt_maps, visualize_esim_sample)
from v2v_tpu_torch.utils.png import write_png

from test_data import make_hqf_h5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the train steps here share the host with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root_script(name):
    """scripts/<name>.py as a module, with scripts/ on sys.path for its
    `_registry` import."""
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, SCRIPTS)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(SCRIPTS)
    return mod


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def _pngs(directory):
    """{relative path: pixels as cv2 reads them} under `directory`."""
    out = {}
    for base, _, files in os.walk(directory):
        for name in files:
            path = os.path.join(base, name)
            out[os.path.relpath(path, directory)] = cv2.imread(
                path, cv2.IMREAD_UNCHANGED)
    return out


def _assert_same_pngs(ours, theirs):
    assert sorted(ours) == sorted(theirs) and ours
    for name in ours:
        assert ours[name] is not None, name
        assert ours[name].dtype == theirs[name].dtype
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)


def test_registry_equals_the_root_registry():
    theirs = _root_script("_registry")
    assert registry.SEQUENCES == theirs.SEQUENCES
    assert registry.FLOW_SEQUENCES == theirs.FLOW_SEQUENCES
    assert registry.FLOW_METRICS == theirs.FLOW_METRICS


@pytest.mark.parametrize("name", ["result_to_col", "flow_result_to_col"])
def test_column_scripts_print_the_root_scripts_lines(tmp_path, name):
    """Two result rows, one column left out (it prints empty): every row
    index prints what the root script prints."""
    ours = {"result_to_col": result_to_col,
            "flow_result_to_col": flow_result_to_col}[name]
    theirs = _root_script(name)
    if name == "result_to_col":
        seqs, metrics = registry.SEQUENCES, registry.METRICS
    else:
        seqs, metrics = registry.FLOW_SEQUENCES, registry.FLOW_METRICS
    cols = [f"{ds}/{s}/{m}" for ds, ss in seqs.items() for s in ss
            for m in metrics][1:]
    rows = [[f"ckpt_{r}.pth"] + [f"{r + 0.001 * i:.4f}"
                                 for i in range(len(cols))]
            for r in range(2)]
    csv = tmp_path / "results.csv"
    csv.write_text("\n".join(",".join(line) for line in
                             [["checkpoint"] + cols] + rows) + "\n\n")
    # line 0 is the header: rows 1 and 2 are ckpt_0 and ckpt_1
    for row, ckpt in ((-1, 1), (1, 0), (2, 1)):
        want = _stdout(theirs.main, str(csv), row)
        assert _stdout(ours.main, [str(csv), str(row)]) == want
        assert want.startswith(f"Checkpoint: ckpt_{ckpt}.pth\n")
    assert _stdout(ours.main, [str(csv)]) == _stdout(theirs.main, str(csv))


@pytest.mark.parametrize("check", [False, True])
def test_generate_test_lists_writes_the_root_scripts_files(
        tmp_path, monkeypatch, check):
    """The five lists under a dataset root that lacks the files: written
    the same (names, paths, lines), or with --check nothing written and
    exit 1 from both. Both write into tmp_path, never configs/."""
    theirs = _root_script("generate_test_lists")
    data = str(tmp_path / "data")
    outs = {}
    for who in ("ours", "theirs"):
        out = tmp_path / who
        out.mkdir()
        argv = ["--root", data, "--out", str(out)] + (["--check"] * check)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.ExitStack() as st:
            if check:
                st.enter_context(pytest.raises(SystemExit, match="1"))
            if who == "ours":
                generate_test_lists.main(argv)
            else:
                monkeypatch.setattr(sys, "argv", ["generate_test_lists.py"]
                                    + argv)
                theirs.main()
        files = {p.name: p.read_text() for p in out.iterdir()}
        outs[who] = (files, buf.getvalue().replace(str(out), "OUT"))
    assert outs["ours"] == outs["theirs"]
    files = outs["ours"][0]
    if check:
        assert files == {}
    else:
        assert sorted(files) == ["evaid_test.txt", "hqf_test.txt",
                                 "ijrr_test.txt", "mvsec_test.txt",
                                 "mvsec_test_flow.txt"]
        assert files["mvsec_test_flow.txt"].startswith(
            os.path.join(data, "MVSEC_flow", "indoor_flying1.h5"))


@pytest.mark.parametrize("interpolate", [False, True])
def test_cache_writer_equals_the_root_script(tmp_path, interpolate):
    """A 9-frame HQF-layout h5: the port's cache (through its main) and the
    root script's hold the same frames, events and attrs bit for bit,
    dtypes included; the port's TestH5CacheDataset reads back each
    window that its TestH5Dataset gives."""
    src = make_hqf_h5(str(tmp_path / "seq_a.h5"), n_frames=9)
    lst = tmp_path / "list.txt"
    lst.write_text(src + "\n")
    out = tmp_path / "ours"
    testh5_to_voxel_cache.main(
        [str(lst), str(out), "--num-bins", "5"]
        + (["--interpolate"] if interpolate else []))
    theirs = str(tmp_path / "theirs.h5")
    _root_script("testh5_to_voxel_cache").convert(src, theirs, 5,
                                                  interpolate)
    with h5py.File(out / "seq_a.h5", "r") as a, h5py.File(theirs, "r") as b:
        assert dict(a.attrs) == dict(b.attrs) == {
            "num_bins": 5, "interpolate_bins": interpolate}
        assert sorted(a) == sorted(b) == ["events", "frames"]
        for key in ("frames", "events"):
            assert a[key].dtype == b[key].dtype == np.float32
            np.testing.assert_array_equal(a[key][()], b[key][()])
        assert a["events"].shape == (8, 5, 24, 32)
        assert np.abs(a["events"][()]).sum() > 0
    cfg = {"sequence_length": 3, "num_bins": 5,
           "interpolate_bins": interpolate}
    cache = th5.TestH5CacheDataset(str(out / "seq_a.h5"), dict(cfg))
    direct = th5.TestH5Dataset(src, dict(cfg))
    assert len(cache) == len(direct) == 3
    for i in range(3):
        for key in ("frame", "events", "frame_idx"):
            np.testing.assert_array_equal(cache[i][key], direct[i][key])


def test_cache_core_reads_a_memory_file_as_its_h5(tmp_path):
    """chip_smoke's [tools] runs the cache core on SyntheticH5Sequence, an
    HQF-layout file held in memory (no h5py there): the same arrays
    written to an h5 file give the same cache through the port's
    writer."""
    arrays = synthetic_hqf(3, 5, (36, 52), 700)
    path = str(tmp_path / "mem.h5")
    with h5py.File(path, "w") as f:
        for k in ("ts", "xs", "ys", "ps"):
            f.create_dataset(f"events/{k}", data=arrays[k])
        for i, (img, e) in enumerate(zip(arrays["images"],
                                         arrays["event_idx"])):
            f.create_dataset(f"images/image{i:09d}", data=img)
            f[f"images/image{i:09d}"].attrs["event_idx"] = e
    out = str(tmp_path / "cache.h5")
    testh5_to_voxel_cache.convert(path, out, 5, False)
    frames, events = testh5_to_voxel_cache.cache_arrays(SyntheticH5Sequence(
        "mem", 3, 5, (36, 52), 700, testh5_to_voxel_cache.reader_config(
            5, False)))
    with h5py.File(out, "r") as f:
        np.testing.assert_array_equal(f["frames"][()], frames)
        np.testing.assert_array_equal(f["events"][()], events)
    assert events.shape == (4, 5, 36, 52) and np.abs(events).sum() > 0


def _events_only_h5(path, h=20, w=28, n=900, seed=5):
    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        f.create_dataset("events/ts", data=np.sort(rng.rand(n)))
        f.create_dataset("events/xs", data=rng.randint(0, w, n).astype(
            np.uint16))
        f.create_dataset("events/ys", data=rng.randint(0, h, n).astype(
            np.uint16))
        f.create_dataset("events/ps", data=rng.randint(0, 2, n).astype(
            np.uint8))
    return path


def _color_h5(path, n_frames=4, h=15, w=21, seed=6):
    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        for i in range(n_frames):
            f.create_dataset(f"images/image{i:09d}", data=rng.randint(
                0, 256, (h, w, 3), dtype=np.uint8))
    return path


@pytest.mark.parametrize("case", ["evcnt", "evcnt_events_only", "gt",
                                  "gt_color"])
def test_image_dumps_equal_the_root_scripts(tmp_path, case):
    """testset_evcnt_maps (frame size from the images, or from the events
    where the file has none) and save_gt_images (grey and 3-channel GT)
    write the root scripts' file names with equal pixels, through
    cv2.imread, and print the same lines."""
    paths = [make_hqf_h5(str(tmp_path / "seq_a.h5"), n_frames=6),
             make_hqf_h5(str(tmp_path / "seq_b.h5"), n_frames=5, h=17,
                         w=31, seed=2)]
    if case == "evcnt_events_only":
        paths = [_events_only_h5(str(tmp_path / "seq_c.h5"))]
    elif case == "gt_color":
        paths = [_color_h5(str(tmp_path / "seq_d.h5"))]
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    if case.startswith("evcnt"):
        ours, theirs = testset_evcnt_maps, _root_script("testset_evcnt_maps")
        args = (str(lst),)
    else:
        ours, theirs = save_gt_images, _root_script("save_gt_images")
        args = (str(lst), "hqf")
    out = {}
    for who, mod in (("ours", ours), ("theirs", theirs)):
        out[who] = _stdout(mod.main, *args, str(tmp_path / who))
    assert out["ours"] == out["theirs"]
    _assert_same_pngs(_pngs(tmp_path / "ours"), _pngs(tmp_path / "theirs"))


@pytest.mark.parametrize("shape", [(7, 13), (5, 9, 1), (6, 11, 3)])
def test_write_png_round_trips_through_cv2(tmp_path, shape):
    """An odd-width uint8 image (grey, grey with a channel axis, BGR)
    reads back through cv2.imread as the same array."""
    img = np.random.RandomState(1).randint(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back, img[..., 0] if shape[-1:] == (1,)
                                  else img)
    with pytest.raises(ValueError, match="uint8"):
        write_png(path, img.astype(np.float32))


def test_visualize_esim_sample_writes_its_pngs_the_same_each_run(tmp_path):
    """The synthetic source on the CPU: 8 voxel and 8 frame PNGs of
    128x128, counts finite and integral, and the same files from the same
    seed. The noise streams differ from JAX's by design, so no pixel is
    compared with the root script's."""
    files = []
    for run in ("a", "b"):
        out = str(tmp_path / run)
        text = _stdout(visualize_esim_sample.main,
                       ["synthetic", out, "--device", "cpu"])
        assert "thresholds pos=" in text and "wrote 16 images" in text
        files.append({name: open(os.path.join(out, name), "rb").read()
                      for name in os.listdir(out)})
        pngs = _pngs(out)
        assert sorted(n[:6] for n in pngs) == ["frame_"] * 8 + ["voxel_"] * 8
        assert all(p.shape == (128, 128) for p in pngs.values())
    assert files[0] == files[1]
    r = visualize_esim_sample.render("synthetic", str(tmp_path / "c"),
                                     "cpu", seed=1)
    v = r["voxels"]
    assert v.shape == (8, 5, 128, 128) and np.isfinite(v).all()
    assert np.array_equal(v, np.round(v)) and np.abs(v).sum() > 0
    np.testing.assert_array_equal(
        cv2.imread(os.path.join(tmp_path / "c", "frame_002.png"),
                   cv2.IMREAD_UNCHANGED),
        visualize_esim_sample.synthetic_frames()[15].astype(np.uint8))


def _example_constants():
    """B, T, BINS, H, W and module_cfg of examples/minimal_train.py, read
    from its source (importing it would train)."""
    tree = ast.parse(open(os.path.join(ROOT, "examples",
                                       "minimal_train.py")).read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Tuple) and isinstance(node.value,
                                                           ast.Tuple):
            names = [t.id for t in node.targets[0].elts]
            out.update(zip(names, ast.literal_eval(node.value)))
        elif isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "module_cfg":
            out["module_cfg"] = eval(compile(ast.Expression(node.value),
                                             "module_cfg", "eval"),
                                     {"BINS": out["BINS"]})
    return out


def test_minimal_train_on_the_cpu_follows_the_jax_example():
    """The example's sizes and module config; 5 steps on the CPU give
    finite, falling losses and no K1 launch; the streaming prediction has
    the shape of the JAX example's (traced, not compiled)."""
    from v2v_tpu.training.interface import ModelInterface as JInterface
    ex = _example_constants()
    m = minimal_train
    assert (ex["B"], ex["T"], ex["BINS"], ex["H"], ex["W"]) == (
        m.B, m.T, m.BINS, m.H, m.W)
    assert ex["module_cfg"] == m.MODULE_CFG
    with contextlib.redirect_stdout(io.StringIO()):
        out = m.main("cpu", 5)
    losses = out["losses"]
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert all(b < a for a, b in zip(losses, losses[1:]))
    assert out["k1_launches"] == 0

    ji = JInterface(ex["module_cfg"])
    params = jax.eval_shape(lambda: ji.init(jax.random.PRNGKey(0), m.B,
                                            m.H, m.W, m.BINS)[0])
    pred = jax.eval_shape(
        lambda p, e, s: ji.forward_sequence(p, e, s, train=False)[0],
        params, jax.ShapeDtypeStruct((1, m.T, m.H, m.W, m.BINS),
                                     jnp.float32), ji.init_state(1, m.H, m.W))
    assert out["pred_shape"] == pred.shape == (1, m.T, m.H, m.W, 1)
    assert np.isfinite(out["pred_range"]).all()


def test_package_data_ships_every_csrc_source():
    """F4: pyproject's package data for v2v_tpu_torch matches every file
    under v2v_tpu_torch/csrc/, the C++ voxel builder included, so an
    installed wheel can build what data/native.py and ops/_build.py
    build."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "v2v_tpu_torch"]
    sources = sorted(os.listdir(os.path.join(ROOT, "v2v_tpu_torch",
                                             "csrc")))
    assert "voxel_builder.cpp" in sources
    missing = [s for s in sources if not any(
        fnmatch.fnmatch(f"csrc/{s}", g) for g in globs)]
    assert missing == []
