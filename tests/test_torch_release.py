"""The port's release kit (v2v_tpu_torch/eval/release.py, `cli
validate_release`), its strict checkpoint conversion, the console scripts
and the bench scripts (v2v_tpu_torch/scripts/bench*.py), against the JAX
package's kit where both have the piece. Everything runs in process on
the CPU at small sizes; nothing is downloaded (`fetch_weights` gets a
fake downloader)."""
import copy
import hashlib
import inspect
import json
import os
import re
import sys
import tomllib

import numpy as np
import jax
import pytest
import torch
import yaml

from v2v_tpu.eval import release as jrelease
from v2v_tpu.training.interface import ModelInterface as JInterface

from v2v_tpu_torch import cli
from v2v_tpu_torch.config import instantiate_from_config, load_yaml
from v2v_tpu_torch.eval import release
from v2v_tpu_torch.eval.references import METRIC_REFERENCES
from v2v_tpu_torch.losses import lpips as tlpips
from v2v_tpu_torch.losses.lpips import LPIPS
from v2v_tpu_torch.models.convert import (convert_checkpoint,
                                          jax_params_to_state_dict,
                                          validate_against)
from v2v_tpu_torch.models.init import materialize
from v2v_tpu_torch.scripts import bench, bench_eval, bench_full_step
from v2v_tpu_torch.training import raft as traft
from v2v_tpu_torch.training.checkpoint import load_params_only
from v2v_tpu_torch.training.interface import ModelInterface

from test_data import make_hqf_h5
from test_torch_losses import jax_lpips

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
# tests/test_torch_eval.py::test_harness_matches_jax_output_to_output's
# tolerance: predictions agree to ~1e-6; LPIPS sums 5 float32 layers
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread: the kit's evals would otherwise take
    every core of each test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assets(root, hw=(24, 32), n_frames=9, datasets=("HQF",)):
    """Two registry-named sequences a dataset (HQF's boxes and desk, so the
    e2vid+ table has rows for them; other datasets take the same names)."""
    for ds in datasets:
        d = root / "h5" / ds
        d.mkdir(parents=True)
        for i, name in enumerate(("boxes", "desk")):
            make_hqf_h5(str(d / f"{name}.h5"), n_frames=n_frames, h=hw[0],
                        w=hw[1], events_per_frame=300, seed=i)
    return root


def _e2vidpp_pth(path, prefix="module."):
    """A .pth of the port's FlowNet at test_e2vid++_original.yaml's widths
    under the reference's key names, `module.`-prefixed, inside
    {"state_dict": ...}; returns the state_dict without the prefix."""
    model_cfg = load_yaml(os.path.join(
        CONFIGS, "test_e2vid++_original.yaml"))["module"]["model"]
    model = materialize(lambda: instantiate_from_config(model_cfg), "cpu",
                        torch.Generator().manual_seed(3))
    sd = model.state_dict()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"state_dict": {prefix + k: v for k, v in sd.items()}}, path)
    return sd


def test_write_lists_and_restrict_tests_equal_jax(tmp_path, capsys):
    """On one assets dir: the same lists (paths and order), the same
    report, and the same test entries kept for every family's YAML."""
    assets = _assets(tmp_path / "assets", datasets=("HQF", "MVSEC"))
    out = {}
    for name, mod in (("jax", jrelease), ("port", release)):
        lists = mod.write_lists(str(assets), str(tmp_path / name),
                                list(release.DATASETS))
        out[name] = (lists, capsys.readouterr().out)
    (jl, jtext), (tl, ttext) = out["jax"], out["port"]
    assert ttext == jtext and "[assets] hqf: 2 sequences" in ttext
    assert sorted(tl) == sorted(jl) == ["hqf", "mvsec"]
    for ds in tl:
        with open(tl[ds]) as f, open(jl[ds]) as g:
            assert f.read() == g.read()
    for family, (cfg_name, task, method) in release.FAMILIES.items():
        assert jrelease.FAMILIES[family] == (cfg_name, task, method)
        cfg = load_yaml(os.path.join(CONFIGS, cfg_name))
        jc, tc = copy.deepcopy(cfg), copy.deepcopy(cfg)
        assert release._restrict_tests(tc, tl) == \
            jrelease._restrict_tests(jc, jl) is True
        kept = [e["dataset_name"] for e in tc["test_stage"]["test"]]
        assert kept == [e["dataset_name"] for e in jc["test_stage"]["test"]]
        for te, je in zip(tc["test_stage"]["test"], jc["test_stage"]["test"]):
            assert te == dict(je, data_file=tl[te["dataset_name"]])


@pytest.mark.parametrize("method", ["e2vid+", "ETNet"])
def test_compare_to_reference_equal_jax(method, capsys):
    """Rows within and outside tol, and a metric the table lacks: equal
    counts and equal printed rows."""
    table = METRIC_REFERENCES
    rng = np.random.RandomState(0)
    final = {}
    for seq, metrics in list(table[method].items())[:5]:
        for metric, ref in metrics.items():
            final[f"{seq}/{metric}"] = ref * (1 + rng.choice(
                [0.0, 0.004, -0.02, 0.5]))
    final["HQF/not_a_sequence/MSE"] = 1.0
    got = release.compare_to_reference("f", final, method, 0.01)
    ttext = capsys.readouterr().out
    want = jrelease.compare_to_reference("f", final, method, 0.01)
    jtext = capsys.readouterr().out
    assert got == want and 0 < got[0] < got[1] == 15
    assert ttext == jtext and "FAIL" in ttext


def test_fetch_weights_checksum_and_placement(tmp_path):
    """The injected downloader runs for each missing file; a bad sha256 is
    discarded, a failed download reported, a present file kept; a second
    call finds everything present."""
    payload = b"fake-weights"
    digest = hashlib.sha256(payload).hexdigest()
    manifest = {"good.pth": ("https://example/good.pth", digest[:8]),
                "bad.pth": ("https://example/bad.pth", "00000000"),
                "down.pth": ("https://example/down.pth", digest[:8]),
                "have.pth": ("https://example/have.pth", "ffffffff")}
    wdir = tmp_path / "weights"
    wdir.mkdir()
    (wdir / "have.pth").write_bytes(b"already here")
    calls = []

    def fake_downloader(url, dest):
        calls.append(url)
        if "down" in url:
            raise OSError("no route to host")
        with open(dest, "wb") as f:
            f.write(payload)

    st = release.fetch_weights(str(wdir), downloader=fake_downloader,
                               manifest=manifest)
    assert st == {"good.pth": "fetched", "bad.pth": "checksum-mismatch",
                  "down.pth": "failed", "have.pth": "present"}
    assert (wdir / "good.pth").read_bytes() == payload
    assert not (wdir / "bad.pth").exists()
    assert not (wdir / "down.pth").exists()
    assert (wdir / "have.pth").read_bytes() == b"already here"
    assert "https://example/have.pth" not in calls
    calls.clear()
    st2 = release.fetch_weights(str(wdir), downloader=fake_downloader,
                                manifest={"good.pth": manifest["good.pth"]})
    assert st2 == {"good.pth": "present"} and calls == []


def test_fetch_manifest_names_what_the_port_looks_up(tmp_path, monkeypatch):
    """The manifest's files are exactly the LPIPS trunks and RAFT teachers
    the port's loaders look up in $V2V_WEIGHTS_DIR, and each is found
    there once fetched."""
    need = set(tlpips._BACKBONE_FILES.values()) | {
        f"{s}.pth" for s in traft._BACKBONES}
    assert set(release.WEIGHT_MANIFEST) == need
    assert release.WEIGHT_MANIFEST == jrelease.WEIGHT_MANIFEST
    for dest, (url, prefix) in release.WEIGHT_MANIFEST.items():
        assert url.startswith("https://download.pytorch.org/models/")
        assert len(prefix) == 8 and prefix in url
    monkeypatch.setenv("V2V_WEIGHTS_DIR", str(tmp_path))
    for dest in need:
        (tmp_path / dest).write_bytes(b"x")
    for net in tlpips._BACKBONE_FILES:
        assert LPIPS._find_backbone(net) == str(
            tmp_path / tlpips._BACKBONE_FILES[net])


def test_strict_conversion_raises_on_a_wrong_schema(tmp_path):
    """A missing, an unexpected and a wrong-shape key each raise; the
    right schema loads every tensor (through the `module.` prefix);
    strict=False loads, keeping the model's values for the missing and
    wrong-shape keys; load_params_only alone would have scored the
    renamed file."""
    path = str(tmp_path / "e2vid++.pth")
    sd = _e2vidpp_pth(path)
    model_cfg = load_yaml(os.path.join(
        CONFIGS, "test_e2vid++_original.yaml"))["module"]["model"]
    fresh = lambda: materialize(lambda: instantiate_from_config(model_cfg),
                                "cpu", torch.Generator().manual_seed(9))
    model = convert_checkpoint(path, fresh())
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    key = next(k for k in sd if k.endswith(".weight") and sd[k].dim() == 4)
    cases = {"missing": {k: v for k, v in sd.items() if k != key},
             "unexpected": dict(sd, extra_key=torch.zeros(3)),
             "wrong-shape": dict(sd, **{key: sd[key][:1]})}
    for why, bad in cases.items():
        bad_path = str(tmp_path / f"{why}.pth")
        torch.save({"state_dict": bad}, bad_path)
        with pytest.raises(ValueError, match=why.replace("wrong-", "")):
            convert_checkpoint(bad_path, fresh())
        m0 = fresh()
        before = m0.state_dict()[key].clone()
        m = convert_checkpoint(bad_path, m0, strict=False)
        want = before if why != "unexpected" else sd[key]
        assert torch.equal(m.state_dict()[key], want)
        if why != "wrong-shape":       # torch refuses a shape mismatch
            load_params_only(bad_path, fresh())
    with pytest.raises(ValueError):
        validate_against(fresh(), {})


@pytest.mark.filterwarnings("ignore:LPIPS")
def test_no_strict_convert_flag(tmp_path, capsys):
    """Through `cli validate_release`: a .pth missing a key fails the
    strict conversion (rc 1: nothing ran); with --no-strict-convert it
    loads, scores and fails the table (rc 2)."""
    assets = _assets(tmp_path / "assets")
    sd = _e2vidpp_pth(str(assets / "checkpoints" / "e2vid++.pth"))
    sd.pop(next(iter(sd)))
    torch.save({"state_dict": sd}, str(assets / "checkpoints" / "e2vid++.pth"))
    argv = ["validate_release", "--assets", str(assets), "--families",
            "e2vid++", "--datasets", "hqf", "--max-batches", "1",
            "--configs", CONFIGS, "--device", "cpu"]
    assert cli.main(argv + ["--out", str(tmp_path / "o1")]) == 1
    assert "CONVERSION FAILED" in capsys.readouterr().out
    assert cli.main(argv + ["--out", str(tmp_path / "o2"),
                            "--no-strict-convert"]) == 2
    text = capsys.readouterr().out
    assert "converted" in text and "0/3 rows within 1.0%" in text


def test_budget_math_on_the_cards_table(tmp_path, capsys):
    """--budget: frames x the card's ms/frame a family (exact at the
    table's resolutions), the kit's wall as the setup column or '?'; it
    runs no family, needs no card, and neither its table nor the module
    says "TPU" or reads a rehearsal file."""
    assets = _assets(tmp_path / "assets", hw=(180, 240), n_frames=4)
    _assets(tmp_path / "mv", hw=(260, 346), n_frames=3, datasets=("MVSEC",))
    os.rename(tmp_path / "mv" / "h5" / "MVSEC", assets / "h5" / "MVSEC")
    assert release.main(["--assets", str(assets), "--budget"]) == 0
    text = capsys.readouterr().out
    frames = {(180, 240): 8, (260, 346): 6}
    total = 0.0
    for family in release.FAMILIES:
        ms = {(h, w): v for f, h, w, v in release.SERVING_MS_PER_FRAME
              if f == family}
        eval_min = sum(n * ms[hw] / 60000.0 for hw, n in frames.items())
        wall = release.RELEASE_WALL_S.get(family)
        setup = "?" if wall is None else f"{wall / 60.0:.1f}"
        row = re.search(rf"^{re.escape(family)} +(\S+) +(\S+) +(\S+)  "
                        rf"ms/frame table$", text, re.M)
        assert row, (family, text)
        assert row.group(1) == setup
        assert row.group(2) == f"{eval_min:.1f}"
        total += (wall or 0.0) / 60.0 + eval_min
    assert re.search(rf"^TOTAL +{total:.1f}", text, re.M)
    assert release.BENCH_CARD in text
    # an unmeasured size scales the nearest point by the pixel count
    assert release._ms_per_frame("etnet", 90, 120) == (pytest.approx(
        release._ms_per_frame("etnet", 180, 240)[0] / 4), True)
    assert len(release.SERVING_MS_PER_FRAME) == 18
    src = inspect.getsource(release)
    assert "TPU" not in src and "rehearsal" not in src
    assert not os.path.exists(tmp_path / "assets" / "lists")


def _bridged_lpips(monkeypatch):
    """LPIPS-Alex on one random trunk in both packages (JAX's, carried
    into the port), as the e2vid harness tests run it."""
    jl = jax_lpips("alex")
    tl = LPIPS("alex", device="cpu")
    tl.module.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, jl.params)))
    monkeypatch.setattr(JInterface, "lpips_train", property(lambda s: jl))
    monkeypatch.setattr(JInterface, "lpips_test", property(lambda s: jl))
    monkeypatch.setattr(ModelInterface, "lpips_test", property(lambda s: tl))


@pytest.mark.filterwarnings("ignore:LPIPS")
def test_kit_end_to_end_matches_jax(tmp_path, monkeypatch, capsys):
    """e2vid++ on two registry-named 24x32 HQF sequences, max_batches=1,
    one .pth: both kits convert strictly, score the first sequence,
    print its FAIL rows against the e2vid+ table and return 2, with
    metrics equal within the harness test's tolerance."""
    assets = _assets(tmp_path / "assets")
    _e2vidpp_pth(str(assets / "checkpoints" / "e2vid++.pth"))
    _bridged_lpips(monkeypatch)
    kw = dict(families=["e2vid++"], datasets=["hqf"], configs_dir=CONFIGS,
              max_batches=1)
    rc_j = jrelease.validate_release(str(assets), str(tmp_path / "jax"),
                                     **kw)
    jtext = capsys.readouterr().out
    rc_t = release.validate_release(str(assets), str(tmp_path / "port"),
                                    device="cpu", **kw)
    ttext = capsys.readouterr().out
    assert rc_t == rc_j == 2, ttext[-3000:]
    assert (tmp_path / "port" / "checkpoints" / "release_e2vid++.pth"
            ).exists()
    rows = lambda text: {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^  (HQF/\S+) +(\S+) +\S+ +\S+ FAIL$", text, re.M)}
    want, got = rows(jtext), rows(ttext)
    assert sorted(got) == sorted(want) == [
        "HQF/boxes/LPIPS", "HQF/boxes/MSE", "HQF/boxes/SSIM"]
    metrics = lambda root: dict(
        line.strip().rsplit(": ", 1) for line in open(os.path.join(
            root, "tensorboard_logs", "release_e2vid++", "test_metrics.txt")))
    jm, tm = metrics(tmp_path / "jax"), metrics(tmp_path / "port")
    assert sorted(tm) == sorted(jm) and len(tm) == 3
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=k)
    assert "0/3 rows within 1.0%" in ttext


def test_evflow_random_init_dry_run(tmp_path, monkeypatch, capsys):
    """`cli validate_release --device cpu` for evflow without a .pth
    or a teacher: rc 0, NOT GATED, the random teacher's warning, and
    V2V_RANDOM_TEACHER restored."""
    assets = _assets(tmp_path / "assets")
    monkeypatch.delenv("V2V_RANDOM_TEACHER", raising=False)
    monkeypatch.setenv("V2V_WEIGHTS_DIR", str(tmp_path / "none"))
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED"):
        rc = cli.main(["validate_release", "--assets", str(assets),
                       "--out", str(tmp_path / "out"), "--families",
                       "evflow", "--datasets", "hqf", "--max-batches", "1",
                       "--allow-random-init", "--configs", CONFIGS,
                       "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0, text[-3000:]
    assert "RANDOM INIT dry run" in text
    assert "evflow: NOT GATED (random init)" in text
    assert "exit code certifies ONLY the 0 gated" in text
    assert "V2V_RANDOM_TEACHER" not in os.environ
    assert os.environ["V2V_WEIGHTS_DIR"] == str(tmp_path / "none")
    assert release.validate_release(str(tmp_path / "empty"),
                                    str(tmp_path / "o2"),
                                    device="cpu") == 1


def test_cli_and_console_scripts(tmp_path, monkeypatch):
    """validate_release is a command; each v2v-torch-* script of
    pyproject.toml resolves to a callable of the port's cli, beside the
    JAX ones; without --device the kit asks for the card."""
    assert set(cli.COMMANDS) == {"train", "test_e2vid", "test_flow",
                                 "validate_release"}
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {k: v for k, v in scripts.items() if k.startswith("v2v-torch-")}
    assert sorted(port) == ["v2v-torch-test-e2vid", "v2v-torch-test-flow",
                            "v2v-torch-train", "v2v-torch-validate-release"]
    for name, target in port.items():
        mod, fn = target.split(":")
        assert mod == "v2v_tpu_torch.cli"
        assert callable(getattr(cli, fn))
        assert fn == name[len("v2v-torch-"):].replace("-", "_")
    assert scripts["v2v-validate-release"] == "v2v_tpu.cli:validate_release"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assets = _assets(tmp_path / "assets")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["validate_release", "--assets", str(assets),
                  "--out", str(tmp_path / "out"), "--allow-random-init"])
    monkeypatch.setattr(sys, "argv", ["v2v-torch-validate-release",
                                      "--assets", str(assets)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.validate_release()
    assert not (tmp_path / "out").exists()


def _tiny_train_yaml(path):
    """The flagship's module at width 4, B=2, T=3, 32x32."""
    full = load_yaml(os.path.join(CONFIGS, "train_v2v_e2vid_10k.yaml"))
    full["module"]["model"]["params"]["unet_kwargs"].update(
        base_num_channels=4, num_residual_blocks=1)
    full["module"]["loss"]["temporal_consistency_L0"] = 1
    stage = full["train_stages"][0]
    stage["dataset"]["train_batch_size"] = 2
    stage["dataset"]["train"][0].update(sequence_length=3, crop_size=32)
    with open(path, "w") as f:
        yaml.safe_dump(full, f)
    return str(path)


@pytest.mark.filterwarnings("ignore:LPIPS")
@pytest.mark.parametrize("script", ["bench", "bench_full_step",
                                    "bench_eval"])
def test_bench_scripts_run_on_the_cpu(script, tmp_path, capsys):
    """Each bench script's main at a tiny size on the CPU prints its JSON
    line: a median and a spread over 3 repeats, and no device metric."""
    if script == "bench":
        argv = ["--shape", "2", "11", "16", "16", "--iters", "2",
                "--host-clips", "2"]
        main = bench.main
    elif script == "bench_full_step":
        argv = ["--config", _tiny_train_yaml(tmp_path / "t.yaml"),
                "--steps", "1", "--flops"]
        main = bench_full_step.main
    else:
        argv = ["e2vid++", "hyper", "--hw", "24x32", "--frames", "2"]
        main = bench_eval.main
    assert main(argv + ["--device", "cpu", "--repeats", "3"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and "no device metric" in out["card"]
    if script == "bench":
        assert out["value"] > 0 and out["host_numpy_clips_per_sec"] > 0
        assert out["spread"][0] <= out["value"] <= out["spread"][1]
    elif script == "bench_full_step":
        assert len(out["step_ms"]) == 3 and np.isfinite(out["last_loss"])
        assert out["flop_per_step"] > 0 and out["bf16_peak_share"] is None
        assert out["spread"][0] <= out["ms_per_step"] <= out["spread"][1]
    else:
        assert [(r["family"], r["hw"]) for r in out["rows"]] == [
            ("e2vid++", [24, 32]), ("hyper", [24, 32])]
        assert all(r["repeats"] == 3 and r["ms_per_frame"] > 0
                   for r in out["rows"])


def test_bench_configs_equal_the_yamls():
    """The bench scripts' built-in configs are the YAMLs' (the card's
    machine has no PyYAML): bench_full_step's flagship and hyper module
    and first stage, bench_eval's families' modules and voxel bins."""
    for name, cfg in (("flagship", "train_v2v_e2vid_10k.yaml"),
                      ("hyper", "train_v2v_hyper_10k.yaml")):
        full = load_yaml(os.path.join(CONFIGS, cfg))
        module, stage = bench_full_step.CONFIGS[name]
        assert module == full["module"]
        want = full["train_stages"][0]
        assert stage["optimizer"] == want["optimizer"]
        assert stage["lr_scheduler"] == want["lr_scheduler"]
        assert stage["dataset"]["train_batch_size"] == \
            want["dataset"]["train_batch_size"]
        assert stage["dataset"]["train"] == want["dataset"]["train"]
    for family, (module, bins, _) in bench_eval.FAMILIES.items():
        full = load_yaml(os.path.join(CONFIGS, release.FAMILIES[family][0]))
        want = dict(full["module"])
        want.pop("loss", None)
        assert module == want, family
        assert {e["num_bins"] for e in full["test_stage"]["test"]} == {bins}
