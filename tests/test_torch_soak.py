"""The port's training-at-scale tools on the CPU at smoke size:
v2v_tpu_torch/scripts/soak_train.py (its config and LR schedule against
the JAX soak's, a real SIGKILL and resume) and scripts/diag_rss.py (each
phase's report; an injected leak in the Python heap). Also the bf16
step's parameter swap on a module registered under two names (ERAFT's
cnet), which a soak would carry over thousands of steps."""
import copy
import glob
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import jax  # noqa: F401  (the JAX package's modules below import it)
import pytest
import torch

from v2v_tpu.training import train as jtrain

from v2v_tpu_torch.config import instantiate_from_config, load_yaml
from v2v_tpu_torch.scripts import diag_rss, soak_train
from v2v_tpu_torch.scripts.bench_full_step import build
from v2v_tpu_torch.training import train as ttrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the soak's config variants: (smoke, scale)
VARIANTS = {"smoke": (True, 1), "scale1": (False, 1), "scale5": (False, 5)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread here and in the soak's child processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


def _jax_config(tmp_path, smoke, scale):
    """The JAX script's make_config, its YAML read back."""
    import yaml
    saved = list(sys.path)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import soak_train as jsoak        # it adds paths of its own
    finally:
        sys.path[:] = saved
    path = jsoak.make_config(str(tmp_path), str(tmp_path / "corpus"),
                             str(tmp_path / "list.txt"),
                             str(tmp_path / "val.txt"), smoke, scale=scale)
    with open(path) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_soak_config_equals_the_jax_soaks(variant, tmp_path):
    """The module block, each stage's name, epochs, optimizer and StepLR,
    B, T, the crop and the rest of the train and val sets equal the JAX
    soak's; the data-file fields (mp4 lists and an h5 list there, the
    stand-in data here) and the smoke's samples a video differ by
    design."""
    smoke, scale = VARIANTS[variant]
    want = _jax_config(tmp_path, smoke, scale)
    got = soak_train.make_config(smoke, scale)
    assert got["module"] == want["module"]
    assert got["check_val_every_n_epoch"] == want["check_val_every_n_epoch"]
    assert len(got["train_stages"]) == len(want["train_stages"]) == 2
    drop = ("data_file", "video_list_file", "max_samples_per_shot")
    for g, w in zip(got["train_stages"], want["train_stages"]):
        for key in ("stage_name", "max_epochs", "optimizer",
                    "lr_scheduler"):
            assert g[key] == w[key], key
        gd, wd = g["dataset"], w["dataset"]
        assert gd["train_batch_size"] == wd["train_batch_size"]
        assert gd["num_workers"] == wd["num_workers"]
        strip = lambda d: {k: v for k, v in d.items() if k not in drop}
        assert strip(gd["train"][0]) == strip(wd["train"][0])
        assert strip(gd["val"][0]) == strip(wd["val"][0])
    t = got["train_stages"][0]["dataset"]["train"][0]
    assert (t["sequence_length"], t["crop_size"]) == (
        (8, 32) if smoke else (40, 128))
    if not smoke:
        # 30 stand-in videos x 84 samples: 210 steps an epoch at B=12
        assert got["soak"]["n_items"] // 12 == 210


def _jax_lrs(cfg):
    out = {}
    epoch = 0
    for stage in cfg["train_stages"]:
        opt = jtrain.make_optimizer(stage["optimizer"])
        sched = jtrain.make_scheduler(stage["lr_scheduler"])
        for e in range(stage["max_epochs"]):
            out[epoch] = opt.base_lr * sched(e)
            epoch += 1
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_soak_lr_schedule_equals_jax(variant):
    """Each global epoch's LR as the port's driver sets it (the stage's
    base lr times its scheduler at the stage's own epoch) equals the JAX
    package's, across the StepLR and the stage boundaries."""
    cfg = soak_train.make_config(*VARIANTS[variant])
    want = _jax_lrs(cfg)
    got, epoch = {}, 0
    for stage in cfg["train_stages"]:
        opt = ttrain.make_optimizer(stage["optimizer"])
        sched = ttrain.make_scheduler(stage["lr_scheduler"])
        for e in range(stage["max_epochs"]):
            got[epoch] = opt.base_lr * sched(e)
            epoch += 1
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[e] for e in got],
                               [want[e] for e in got], rtol=1e-12)
    assert len({f"{x:.3e}" for x in got.values()}) >= 3


@pytest.fixture(scope="module")
def soak_smoke(tmp_path_factory):
    """`soak_train --smoke --device cpu`: phase 1 until the SIGKILL mid
    epoch 1, phase 2 resumed in a fresh process; (workdir, stdout)."""
    import contextlib
    import io
    wd = tmp_path_factory.mktemp("soak")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = soak_train.main(["--workdir", str(wd), "--smoke",
                              "--device", "cpu"])
    assert rc == 0
    return wd, buf.getvalue()


def test_soak_smoke_kills_and_resumes(soak_smoke):
    """A real SIGKILL after epoch 1's checkpoint, a resume at epoch 1 in a
    fresh process, 4 epochs of 12 steps in all, finite losses that fall,
    the probe's MSE better at the end, and the summary written."""
    wd, out = soak_smoke
    assert out.rstrip().endswith("SOAK OK")
    with open(wd / "soak_summary.json") as f:
        s = json.load(f)
    assert s["resume_epoch"] == 1 and s["epochs"] == 4
    assert s["failed_checks"] == []
    assert s["total_steps"] == 4 * 12 and s["device"] == "cpu"
    assert s["loss_last3_mean"] < s["loss_first3_mean"]
    assert all(np.isfinite(x) for _, x in s["loss_by_epoch"])
    assert len(s["quality_by_epoch"]) == 4 and len(s["val_losses"]) == 4
    mse = [m for _, m, _ in s["quality_by_epoch"]]
    assert np.mean(mse[-2:]) < np.mean(mse[:2])
    assert s["rss_mb_peak"] >= s["rss_mb_first_quarter_peak"] > 0
    # a CPU run reports no device memory
    assert [x for _, x in s["reserved_mb_by_epoch"]] == [None] * 4
    with open(wd / soak_train.LOG_NAME) as f:
        log = f.read()
    # phase 1 saw epoch 1 start, never end; phase 2 began there
    assert log.count("Stage 0, epoch 1: lr=") == 2
    assert log.count("Stage 0, epoch 1: 12 steps") == 1


def test_soak_lrs_logged_equal_jax(soak_smoke):
    """The LRs the driver printed in the smoke run, one an epoch and the
    killed epoch's twice, are the JAX scheduler's."""
    wd, _ = soak_smoke
    with open(wd / soak_train.LOG_NAME) as f:
        lrs = soak_train.LR_RE.findall(f.read())
    want = _jax_lrs(soak_train.make_config(True))
    assert [int(e) for _, e, _ in lrs] == [0, 1, 1, 2, 3]
    assert all(lr == f"{want[int(e)]:.3e}" for _, e, lr in lrs)


def test_soak_check_catches_a_wrong_resume(soak_smoke):
    """The summary's check fails when the run resumed at another epoch
    than the planned kill, after writing the summary with the failure."""
    wd, _ = soak_smoke
    with pytest.raises(RuntimeError, match="resumed at epoch 1, expected 2"):
        soak_train.summarize(str(wd), 2, [(0.0, 1)], torch.device("cpu"),
                             {})
    with open(wd / "soak_summary.json") as f:
        s = json.load(f)
    assert s["failed_checks"] == ["resumed at epoch 1, expected 2"]
    assert s["epochs"] == 4 and s["resume_epoch"] == 1


def _args(**kw):
    return SimpleNamespace(**dict(
        dict(iters=4, sample_every=2, workers=1, smoke=True, device="cpu"),
        **kw))


@pytest.mark.parametrize("phase", diag_rss.PHASE_NAMES)
def test_rss_phase_reports(phase, monkeypatch, tmp_path):
    """Each diag_rss phase at smoke size on the CPU: its RSS series a
    sample every 2 iterations, the heap and the trimmed RSS; no reserved
    series off the card. The step's teacher is random, as `run` makes
    it for its children where no weights exist."""
    monkeypatch.setenv("V2V_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("V2V_RANDOM_TEACHER", "1")
    v2v_env = lambda: {k: v for k, v in os.environ.items()  # noqa: E731
                       if k.startswith("V2V_")}
    before = v2v_env()
    r = diag_rss.PHASES[phase](_args())
    assert v2v_env() == before            # the phase sets nothing there
    assert r["tag"] == phase
    assert [i for i, _ in r["series"]] == [0, 2, 4]
    assert r["peak_mb"] >= max(r["first_mb"], r["last_mb"]) > 0
    assert r["python_heap_mb"] >= 0 and r["trimmed_mb"] > 0
    assert r["reserved_series"] is None


class _Leaky:
    """A stand-in set that keeps a 1 MB array for each item it gives."""

    def __init__(self, base):
        self.base, self.kept = base, []

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        self.kept.append(np.ones(1 << 20, np.uint8))
        return self.base[idx]


def test_rss_heap_names_an_injected_leak():
    """The loader phase's tracemalloc heap shows a leak injected through
    the phase's dataset: 1 MB kept an item, 16 items over 8 batches."""
    cfg = diag_rss._soak_config(True)
    clean = diag_rss.phase_loader(_args(iters=8))
    leaky = _Leaky(diag_rss._stand_in(cfg))
    leak = diag_rss.phase_loader(_args(iters=8), dataset=leaky)
    kept_mb = len(leaky.kept) * (1 << 20) / 1e6
    assert len(leaky.kept) >= 16
    assert clean["python_heap_mb"] < 4
    assert leak["python_heap_mb"] >= clean["python_heap_mb"] + 0.9 * kept_mb


def test_rss_run_spawns_each_phase(tmp_path):
    """diag_rss's run: each phase in its own process, the summary file
    with their reports."""
    res = diag_rss.run(["loader", "transfer"], 4, 2, 1, str(tmp_path),
                       smoke=True, device="cpu")
    assert sorted(res) == ["loader", "transfer"]
    with open(tmp_path / "diag_rss_summary.json") as f:
        assert sorted(json.load(f)) == ["loader", "transfer"]
    assert res["transfer"]["shipped_gb"] > 0


def test_bf16_steps_keep_a_twice_registered_modules_parameters():
    """F3: ERAFT's cnet registers each downsampling block's norm3 also as
    downsample.1. The bf16 step's functional_call swapped it under both
    names and restored the second from the first's copy, so after a step
    the model held bf16 copies the optimizer never saw. After two steps
    every parameter is still the optimizer's float32 leaf."""
    built = build("eraft", torch.device("cpu"), batch=1, sequence_length=2,
                  crop=32)
    model = built.iface.model
    before = dict(model.named_parameters())
    names = dict(model.named_parameters(remove_duplicate=False))
    assert len(names) > len(before)              # the module named twice
    state = copy.deepcopy(model.state_dict())
    for _ in range(2):
        built.step(built.batch, built.generator)
    after = dict(model.named_parameters())
    assert after.keys() == before.keys()
    assert all(after[k] is before[k] and after[k].is_leaf
               and after[k].dtype == torch.float32 for k in after)
    moved = model.state_dict()
    key = "cnet.layer2.0.norm3.weight"
    assert moved[key].dtype == torch.float32
    assert not torch.equal(moved[key], state[key])   # the optimizer's steps


def _tied_across_modules(model):
    """The names of each parameter reached under two or more names that do
    not all lead to one module object by one attribute: a weight tied
    between distinct modules, which the bf16 step's
    functional_call(tie_weights=False) would untie."""
    names_by_param = {}
    for name, p in model.named_parameters(remove_duplicate=False):
        names_by_param.setdefault(id(p), []).append(name)
    tied = []
    for names in names_by_param.values():
        owners = set()
        for name in names:
            module, _, attr = name.rpartition(".")
            owners.add((id(model.get_submodule(module)), attr))
        if len(owners) > 1:
            tied.append(names)
    return tied


class _TwoLinears(torch.nn.Module):
    def __init__(self, tie):
        super().__init__()
        self.a = torch.nn.Linear(3, 3)
        self.b = torch.nn.Linear(3, 3)
        self.alias = self.a                      # one module, two names
        if tie:
            self.b.weight = self.a.weight        # two modules, one weight


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(ROOT, "configs", "*.yaml"))), ids=os.path.basename)
def test_no_config_model_ties_a_parameter_between_two_modules(path):
    """Every config's model, built by its constructor on the CPU at the
    config's widths (no forward): a parameter reached under two names is
    one module's, registered under both (ERAFT's norm3 / downsample.1),
    which is what makes `_caller`'s tie_weights=False safe. The model is
    built directly, since materialize's meta-to-CPU copy would itself
    untie a weight shared by two modules."""
    model = instantiate_from_config(load_yaml(path)["module"]["model"])
    assert _tied_across_modules(model) == []
    shared = len(list(model.named_parameters(remove_duplicate=False))) - \
        len(list(model.named_parameters()))
    assert (shared > 0) == ("eraft" in os.path.basename(path))


def test_the_tie_check_tells_a_tie_from_a_module_named_twice():
    assert _tied_across_modules(_TwoLinears(tie=False)) == []
    assert _tied_across_modules(_TwoLinears(tie=True)) == [
        ["a.weight", "b.weight", "alias.weight"]]


def _drifting_frames_loop(data_cfg, seed, idx):
    """DriftingClips' video a frame at a time (its first form)."""
    c = data_cfg
    fpi = c["num_bins"] * c.get("frames_per_bin", 1)
    n = (c["sequence_length"] + bool(c.get("output_additional_evs"))) \
        * fpi + 1
    h = w = c["crop_size"]
    rng = np.random.default_rng((seed, idx))
    tex = np.pad(rng.random((2 * h, 2 * w)), 1, mode="edge")
    tex = sum(tex[i:i + 2 * h, j:j + 2 * w]
              for i in range(3) for j in range(3)) / 9.0
    tex = np.clip((tex - 0.5) * 3.0 + 0.5, 0.0, 1.0) * 255.0
    vel = (rng.random(2) - 0.5) * 2.0
    pad = int(np.ceil(n * np.abs(vel).max())) + 2
    tex = np.pad(tex, pad, mode="reflect")
    frames = np.empty((n, h, w), np.float32)
    for t in range(n):
        oy, ox = t * vel + (h / 2 + pad, w / 2 + pad)
        iy, ix = int(np.floor(oy)), int(np.floor(ox))
        fy, fx = oy - iy, ox - ix
        a = tex[iy:iy + h + 1, ix:ix + w + 1]
        f = ((1 - fy) * ((1 - fx) * a[:-1, :-1] + fx * a[:-1, 1:])
             + fy * ((1 - fx) * a[1:, :-1] + fx * a[1:, 1:]))
        frames[t] = f * (1.0 + 0.3 * np.sin(t / 17.0 + idx))
    return np.clip(frames, 0, 255).round().astype(np.uint8)


@pytest.mark.parametrize("extra_evs", [False, True])
def test_drifting_clips_equal_the_frame_loop(extra_evs):
    """The stand-in clips, made FRAME_CHUNK frames at a time, equal the
    frame loop bit for bit (a ragged last chunk included)."""
    from v2v_tpu_torch.data.synthetic import FRAME_CHUNK, DriftingClips
    cfg = dict(soak_train.make_config(False)["train_stages"][0]["dataset"]
               ["train"][0], sequence_length=7, crop_size=48,
               output_additional_evs=extra_evs)
    clips = DriftingClips(cfg, 3, 4)
    for idx in range(4):
        got = clips[idx]["video"]
        assert got.shape[0] % FRAME_CHUNK                 # ragged
        np.testing.assert_array_equal(got, _drifting_frames_loop(cfg, 3,
                                                                 idx))
