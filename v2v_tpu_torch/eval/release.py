"""Release acceptance kit: one command from an assets directory to the
within-1% table (port of v2v_tpu/eval/release.py; BASELINE.md acceptance,
reference utils/metric_references.py:208-236, test_e2vid.py:100-108).

    python -m v2v_tpu_torch.cli validate_release --assets DIR [--out DIR]
        [--families f1,f2] [--datasets hqf,ijrr] [--max-batches N]
        [--tol 0.01] [--allow-random-init] [--no-strict-convert] [--fetch]
        [--budget] [--device DEV]

It runs on the card unless `--device cpu`. `--fetch` downloads every
public auxiliary weight (the LPIPS trunks and the RAFT teachers,
torchvision files, sha256-checked against the hash in their file names)
into DIR/weights/; it needs a network. Offline is the default.

Assets layout (any subset; missing pieces are reported and skipped):

    DIR/checkpoints/{e2vid++,etnet,hyper,eraft,evflow,nernet}.pth
        released torch checkpoints (the reference's ckpt_paths/*.txt
        targets)
    DIR/h5/{HQF,IJRR,MVSEC,EVAID}/{sequence}.h5
        the benchmarks in the unified HQF h5 format
    DIR/weights/{alexnet,vgg16,squeezenet}-*.pth, raft_{small,large}.pth
        LPIPS trunks and RAFT teachers; becomes $V2V_WEIGHTS_DIR

For each family the kit loads the .pth strictly into the port's model
(models/convert.py::convert_checkpoint: a missing, unexpected or
wrong-shape key fails the family), saves it as a port checkpoint, runs
the family's test harness (e2vid or flow) over every available dataset
and prints the per-sequence deltas against the reference table
(eval/metric_references.json) for the families that have published rows
(e2vid++ -> "e2vid+", etnet -> "ETNet"). Exit code: 0 = every compared
row within tol, 2 = acceptance failures, 1 = nothing could run.

The configs and the test sequences reach the family loop through one
seam, `inputs(family) -> (config, dataset) or None`. By default it reads
the family's YAML from configs/ and the lists written from DIR/h5 (PyYAML
and h5py are imported where they read); a caller without those files
(chip_smoke.py on the card) passes configs as dicts and datasets in
memory.

`--budget` projects a run before it starts: per family, the kit's own
wall on the card and frames x ms/frame from `SERVING_MS_PER_FRAME`, which
v2v_tpu_torch/scripts/bench_eval.py measured on `BENCH_CARD`.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

# family -> (config file, task, reference-table method name or None)
FAMILIES: Dict[str, Tuple[str, str, Optional[str]]] = {
    "e2vid++": ("test_e2vid++_original.yaml", "e2vid", "e2vid+"),
    "etnet": ("test_etnet_original.yaml", "e2vid", "ETNet"),
    "hyper": ("test_hypere2vid_original.yaml", "e2vid", None),
    "nernet": ("test_nernet_original.yaml", "e2vid", None),
    "eraft": ("test_eraft_original.yaml", "flow", None),
    "evflow": ("test_evflow_original.yaml", "flow", None),
}
DATASETS = ("hqf", "ijrr", "mvsec", "evaid")

# ---- public auxiliary weights (--fetch) --------------------------------
#
# The LPIPS trunks and RAFT teachers are public torchvision files; only
# the model families' checkpoints are the reference authors'. The 8-hex
# suffix of a torchvision file name is the first 8 characters of the
# file's sha256 (torch.hub's convention), so a fetched file is checked
# before it is kept. The downloader is injectable.
WEIGHT_MANIFEST: Dict[str, Tuple[str, str]] = {
    # the file name losses/lpips.py and training/raft.py look up
    #   -> (download URL, sha256 prefix)
    "alexnet-owt-7be5be79.pth": (
        "https://download.pytorch.org/models/alexnet-owt-7be5be79.pth",
        "7be5be79"),
    "vgg16-397923af.pth": (
        "https://download.pytorch.org/models/vgg16-397923af.pth",
        "397923af"),
    "squeezenet1_1-b8a52dc0.pth": (
        "https://download.pytorch.org/models/squeezenet1_1-b8a52dc0.pth",
        "b8a52dc0"),
    # torchvision's optical-flow defaults (Raft_Small_Weights.C_T_V2,
    # Raft_Large_Weights.C_T_SKHT_V2) under the teacher's names
    "raft_small.pth": (
        "https://download.pytorch.org/models/"
        "raft_small_C_T_V2-01064c6c.pth", "01064c6c"),
    "raft_large.pth": (
        "https://download.pytorch.org/models/"
        "raft_large_C_T_SKHT_V2-ff5fadd5.pth", "ff5fadd5"),
}


def _default_downloader(url: str, dest: str) -> None:
    import urllib.request
    tmp = dest + ".part"
    with urllib.request.urlopen(url, timeout=120) as r, \
            open(tmp, "wb") as f:
        while True:
            chunk = r.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
    os.replace(tmp, dest)


def fetch_weights(wdir: str, downloader=None,
                  manifest: Optional[Dict[str, Tuple[str, str]]] = None,
                  ) -> Dict[str, str]:
    """Download the missing manifest files into `wdir` and check each
    one's sha256 against its prefix. Returns {file name: status}, status
    one of 'present', 'fetched', 'failed', 'checksum-mismatch' (the file
    is deleted). A failed download is reported, not raised: the kit then
    runs as offline."""
    import hashlib

    downloader = downloader or _default_downloader
    manifest = WEIGHT_MANIFEST if manifest is None else manifest
    os.makedirs(wdir, exist_ok=True)
    status: Dict[str, str] = {}
    for dest, (url, prefix) in manifest.items():
        path = os.path.join(wdir, dest)
        if os.path.isfile(path):
            status[dest] = "present"
            continue
        try:
            downloader(url, path)
        except Exception as e:
            print(f"[fetch] {dest}: download failed ({e})")
            status[dest] = "failed"
            continue
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        digest = h.hexdigest()
        if not digest.startswith(prefix):
            os.remove(path)
            print(f"[fetch] {dest}: sha256 {digest[:8]} != expected "
                  f"{prefix} - discarded")
            status[dest] = "checksum-mismatch"
            continue
        print(f"[fetch] {dest}: ok (sha256 {digest[:8]}...)")
        status[dest] = "fetched"
    return status


# ---- the run's budget (--budget) ----------------------------------------
#
# B=1 streaming ms/frame at random weights, float32, the state carried
# from frame to frame: v2v_tpu_torch/scripts/bench_eval.py (the median of
# its repeats), run by chip_smoke.py's [bench-eval] on BENCH_CARD.
BENCH_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
SERVING_MS_PER_FRAME: List[Tuple[str, int, int, float]] = [
    ("e2vid++", 180, 240, 2.103), ("e2vid++", 260, 346, 2.160),
    ("e2vid++", 720, 1280, 8.799),
    ("etnet", 180, 240, 9.393), ("etnet", 260, 346, 8.845),
    ("etnet", 720, 1280, 59.595),
    ("hyper", 180, 240, 3.287), ("hyper", 260, 346, 3.143),
    ("hyper", 720, 1280, 8.636),
    ("eraft", 180, 240, 30.114), ("eraft", 260, 346, 29.738),
    ("eraft", 720, 1280, 56.395),
    ("evflow", 180, 240, 1.438), ("evflow", 260, 346, 1.088),
    ("evflow", 720, 1280, 4.814),
    ("nernet", 180, 240, 5.759), ("nernet", 260, 346, 5.150),
    ("nernet", 720, 1280, 29.150),
]
# the kit's wall (s) for a family on BENCH_CARD in chip_smoke.py's
# [release]: model build, strict conversion where there is a .pth, and a
# few frames of two sequences
RELEASE_WALL_S: Dict[str, float] = {"e2vid++": 2.1, "etnet": 1.5,
                                    "hyper": 1.0}


def _ms_per_frame(family: str, h: int, w: int) -> Tuple[float, bool]:
    """(ms/frame, is_estimate): the measured point, or the family's
    nearest one scaled by the pixel count."""
    pts = [p for p in SERVING_MS_PER_FRAME if p[0] == family]
    exact = [p for p in pts if p[1] == h and p[2] == w]
    if exact:
        return exact[0][3], False
    nearest = min(pts, key=lambda p: abs(p[1] * p[2] - h * w))
    return nearest[3] * (h * w) / (nearest[1] * nearest[2]), True


def _count_frames(assets: str, datasets: List[str]
                  ) -> Dict[str, Tuple[int, int, int, int]]:
    """dataset -> (n_files, n_frames, H, W) over DIR/h5/{DS}/*.h5."""
    import h5py
    out = {}
    for ds in datasets:
        files = sorted(glob.glob(os.path.join(assets, "h5", ds.upper(),
                                              "*.h5")))
        n_frames, h, w = 0, 0, 0
        for path in files:
            try:
                with h5py.File(path, "r") as f:
                    keys = list(f["images"].keys())
                    n_frames += len(keys)
                    if keys and not h:
                        h, w = f["images"][keys[0]].shape[:2]
            except (OSError, KeyError) as e:
                print(f"[budget] unreadable {path}: {e}")
        if files:
            out[ds] = (len(files), n_frames, h, w)
    return out


def print_budget(assets: str, families: Optional[List[str]] = None,
                 datasets: Optional[List[str]] = None) -> int:
    """State a run's minutes before running it: per family, the kit's
    wall on the card where chip_smoke.py measured it, and the assets'
    frames x the card's ms/frame (reference spirit: test_e2vid.py:
    133-172's skip-if-done bookkeeping)."""
    families = families or list(FAMILIES)
    datasets = datasets or list(DATASETS)
    counts = _count_frames(assets, datasets)
    if not counts:
        print(f"[budget] no h5 datasets under {assets}/h5/")
        return 1
    for ds, (nf, frames, h, w) in sorted(counts.items()):
        print(f"[budget] {ds}: {nf} sequences, {frames} frames "
              f"@ {h}x{w}")
    print(f"[budget] measured on {BENCH_CARD}")
    print(f"\n{'family':10s} {'setup(min)':>12s} {'eval(min)':>10s} "
          f"{'total(min)':>11s}  basis")
    grand = 0.0
    for family in families:
        wall = RELEASE_WALL_S.get(family)
        setup = None if wall is None else wall / 60.0
        setup_s = "?" if setup is None else f"{setup:.1f}"
        eval_min = 0.0
        any_est = False
        for ds, (nf, frames, h, w) in counts.items():
            ms, est = _ms_per_frame(family, h, w)
            any_est |= est
            eval_min += frames * ms / 60000.0
        total = (setup or 0.0) + eval_min
        grand += total
        basis = ("ms/frame table" if not any_est
                 else "ms/frame table + pixel-scaled estimates")
        print(f"{family:10s} {setup_s:>12s} {eval_min:>10.1f} "
              f"{total:>11.1f}  {basis}")
    print(f"{'TOTAL':10s} {'':>12s} {'':>10s} {grand:>11.1f}  "
          f"(setup '?' rows excluded from their totals)")
    print(f"\nnotes: setup = the kit's wall for the family in chip_smoke.py's "
          f"[release] on {BENCH_CARD}\n  (random weights, a few frames; "
          f"'?' where not measured); eval = frames x float32 ms/frame\n  "
          f"(B=1 streaming, v2v_tpu_torch/scripts/bench_eval.py on the "
          f"same card).")
    return 0


# ---- assets -> configs and sequences -------------------------------------

def _find_configs_dir(explicit: Optional[str]) -> str:
    if explicit:
        return explicit
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for cand in (os.path.join(os.getcwd(), "configs"),
                 os.path.join(here, "configs")):
        if os.path.isfile(os.path.join(cand, "test_e2vid++_original.yaml")):
            return cand
    raise SystemExit("cannot locate configs/; pass --configs DIR")


def write_lists(assets: str, out: str,
                datasets: List[str]) -> Dict[str, str]:
    """One list per available dataset dir, naming every .h5 in
    DIR/h5/{DS}/ (registry sequences score against the reference table;
    other files still run)."""
    lists = {}
    os.makedirs(os.path.join(out, "lists"), exist_ok=True)
    for ds in datasets:
        ds_dir = os.path.join(assets, "h5", ds.upper())
        files = sorted(glob.glob(os.path.join(ds_dir, "*.h5")))
        if not files:
            print(f"[assets] no h5 under {ds_dir} - skipping {ds}")
            continue
        path = os.path.join(out, "lists", f"{ds}_test.txt")
        with open(path, "w") as f:
            f.write("\n".join(files) + "\n")
        lists[ds] = path
        print(f"[assets] {ds}: {len(files)} sequences")
    return lists


def _restrict_tests(config: Dict[str, Any],
                    lists: Dict[str, str]) -> bool:
    """Point the config's test entries at the written lists and drop the
    datasets without assets. Returns False if nothing remains."""
    kept = []
    for entry in config["test_stage"]["test"]:
        ds = entry.get("dataset_name", "").lower()
        if ds in lists:
            kept.append(dict(entry, data_file=lists[ds]))
    config["test_stage"]["test"] = kept
    return bool(kept)


def file_inputs(configs_dir: str, lists: Dict[str, str]
                ) -> Callable[[str], Optional[Tuple[Dict[str, Any], Any]]]:
    """The default seam: a family's YAML, its PNGs under
    results/release_<family>, its test entries on the written lists; the
    harness builds the h5 datasets from them (dataset None)."""
    from ..config import load_yaml

    def inputs(family: str):
        config = load_yaml(os.path.join(configs_dir, FAMILIES[family][0]))
        config["test_output_dir"] = os.path.join("results",
                                                 f"release_{family}")
        return (config, None) if _restrict_tests(config, lists) else None

    return inputs


# ---- one family ------------------------------------------------------------

def convert_family(family: str, config: Dict[str, Any], pth: str,
                   out_pth: str, strict: bool = True) -> str:
    """Load `pth` into the family's model through the strict check and
    save it as a port checkpoint at `out_pth` (on the CPU; the harness
    moves it to its device)."""
    import torch

    from ..config import instantiate_from_config
    from ..models.convert import convert_checkpoint
    from ..models.init import materialize
    from ..training.checkpoint import save_checkpoint
    model = materialize(lambda: instantiate_from_config(
        config["module"]["model"]), torch.device("cpu"))
    convert_checkpoint(pth, model, strict=strict)
    save_checkpoint(out_pth, model, None, epoch=-1)
    print(f"[{family}] converted {pth} -> {out_pth}")
    return out_pth


def compare_to_reference(family: str, final: Dict[str, float],
                         method: str, tol: float) -> Tuple[int, int]:
    """Per-(sequence, metric) relative deltas against the published
    table; returns (n_within, n_compared)."""
    from .references import METRIC_REFERENCES
    table = METRIC_REFERENCES[method]
    n_ok = n_tot = 0
    print(f"\n[{family}] acceptance vs '{method}' reference rows "
          f"(tol {tol:.1%}):")
    print(f"  {'sequence/metric':<40} {'ours':>10} {'ref':>10} {'delta':>8}")
    for seq, metrics in table.items():
        for metric, ref_val in metrics.items():
            ours = final.get(f"{seq}/{metric}")
            if ours is None:
                continue
            n_tot += 1
            rel = abs(ours - ref_val) / max(abs(ref_val), 1e-12)
            ok = rel <= tol
            n_ok += ok
            flag = "ok" if ok else "FAIL"
            print(f"  {seq + '/' + metric:<40} {ours:>10.4f} "
                  f"{ref_val:>10.4f} {rel:>7.2%} {flag}")
    print(f"[{family}] {n_ok}/{n_tot} rows within {tol:.1%}")
    return n_ok, n_tot


def validate_release(assets: str, out: str = "release_validation",
                     families: Optional[List[str]] = None,
                     datasets: Optional[List[str]] = None,
                     configs_dir: Optional[str] = None,
                     max_batches: Optional[int] = None, tol: float = 0.01,
                     allow_random_init: bool = False,
                     strict_convert: bool = True,
                     fetch: bool = False, downloader=None, device=None,
                     inputs=None) -> int:
    """The kit on `device` (None: the card). `inputs` is the seam of the
    module docstring (None: `file_inputs` on DIR/h5 and configs/).
    V2V_RANDOM_TEACHER (set by `allow_random_init`, so the flow families'
    teacher may be random too) and V2V_WEIGHTS_DIR hold only for the
    call."""
    saved = {k: os.environ.get(k)
             for k in ("V2V_RANDOM_TEACHER", "V2V_WEIGHTS_DIR")}
    if allow_random_init:
        os.environ["V2V_RANDOM_TEACHER"] = "1"
    try:
        return _validate_release(
            assets, out, families, datasets, configs_dir, max_batches,
            tol, allow_random_init, strict_convert, fetch, downloader,
            device, inputs)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _validate_release(assets, out, families, datasets, configs_dir,
                      max_batches, tol, allow_random_init, strict_convert,
                      fetch, downloader, device, inputs) -> int:
    from .. import resolve_device
    device = resolve_device(device)      # before any work: no card raises
    os.makedirs(out, exist_ok=True)
    families = families or list(FAMILIES)
    datasets = datasets or list(DATASETS)

    wdir = os.path.join(assets, "weights")
    if fetch:
        st = fetch_weights(wdir, downloader=downloader)
        print("[fetch] " + ", ".join(f"{k}: {v}"
                                     for k, v in sorted(st.items())))
    if os.path.isdir(wdir):
        os.environ["V2V_WEIGHTS_DIR"] = wdir
        print(f"[assets] V2V_WEIGHTS_DIR={wdir} "
              f"({len(os.listdir(wdir))} files)")
    else:
        print("[assets] no weights/ dir: LPIPS/RAFT fall back to "
              "random features (metrics will NOT match the table)")

    if inputs is None:
        lists = write_lists(assets, out, datasets)
        if not lists:
            print("no datasets available; nothing to run")
            return 1
        inputs = file_inputs(_find_configs_dir(configs_dir), lists)

    failures = 0
    ran = 0
    summary: List[str] = []
    for family in families:
        _, task, method = FAMILIES[family]
        got = inputs(family)
        if got is None:
            summary.append(f"{family}: skipped (no datasets)")
            continue
        config, dataset = got
        config = dict(config, experiment_name=f"release_{family}")

        pth = os.path.join(assets, "checkpoints", f"{family}.pth")
        ckpt = None
        if os.path.isfile(pth):
            ckpt = os.path.join(out, "checkpoints", f"release_{family}.pth")
            try:
                convert_family(family, config, pth, ckpt,
                               strict=strict_convert)
            except Exception as e:
                print(f"[{family}] CONVERSION FAILED: {e}")
                summary.append(f"{family}: conversion failed")
                failures += 1
                continue
        elif not allow_random_init:
            print(f"[{family}] no checkpoint at {pth} - skipping "
                  f"(--allow-random-init to run anyway)")
            summary.append(f"{family}: skipped (no checkpoint)")
            continue
        else:
            print(f"[{family}] no checkpoint: RANDOM INIT dry run")

        if task == "flow":
            from .flow_harness import run_single_test
        else:
            from .harness import run_single_test
        print(f"\n[{family}] running the {task} test harness ...")
        final = run_single_test(ckpt, config, max_batches=max_batches,
                                root=out, device=device, dataset=dataset)
        ran += 1

        if method is not None and ckpt is not None:
            n_ok, n_tot = compare_to_reference(family, final, method, tol)
            summary.append(f"{family}: {n_ok}/{n_tot} rows within "
                           f"{tol:.1%}")
            if n_ok < n_tot:
                failures += 1
        else:
            # no published row for the family, or random init: the
            # metrics are reported, and said loudly to gate nothing, so
            # that exit code 0 is not read as acceptance
            means: Dict[str, List[float]] = {}
            for k, v in final.items():
                means.setdefault(k.rsplit("/", 1)[-1], []).append(v)
            line = " ".join(f"{m}={sum(v) / len(v):.4f}"
                            for m, v in sorted(means.items()))
            why = ("random init" if ckpt is None
                   else "no published reference rows")
            summary.append(f"{family}: NOT GATED ({why}) "
                           + (line if line else "no metrics"))

    print("\n=== release validation summary ===")
    gated = sum(": NOT GATED" not in line and "skipped" not in line
                and "failed" not in line for line in summary)
    for line in summary:
        print(" ", line)
    print(f"  [exit code certifies ONLY the {gated} gated "
          f"(reference-compared) families; NOT GATED rows are "
          f"informational]")
    if not ran:
        return 1
    return 2 if failures else 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m v2v_tpu_torch.cli validate_release",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--assets", required=True,
                    help="assets dir (checkpoints/ h5/ weights/)")
    ap.add_argument("--out", default="release_validation")
    ap.add_argument("--families",
                    help=f"comma list of {sorted(FAMILIES)}")
    ap.add_argument("--datasets", help=f"comma list of {DATASETS}")
    ap.add_argument("--configs", help="configs dir (default: autodetect)")
    ap.add_argument("--max-batches", type=int,
                    help="cap batches per family (smoke runs)")
    ap.add_argument("--tol", type=float, default=0.01)
    ap.add_argument("--allow-random-init", action="store_true",
                    help="run families without a .pth at random init")
    ap.add_argument("--no-strict-convert", action="store_true",
                    help="load a .pth as load_state_dict(strict=False): "
                         "missing and wrong-shape keys keep the model's "
                         "values, unexpected keys are dropped")
    ap.add_argument("--fetch", action="store_true",
                    help="download the missing public auxiliary weights "
                         "(LPIPS trunks, RAFT teachers; sha256-checked "
                         "torchvision files) into assets/weights/ first; "
                         "needs a network")
    ap.add_argument("--budget", action="store_true",
                    help="print the projected minutes per family (the "
                         "kit's wall and the assets' frames x ms/frame, "
                         "measured on the card) and exit without running")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    families = args.families.split(",") if args.families else None
    datasets = args.datasets.split(",") if args.datasets else None
    if args.budget:
        return print_budget(args.assets, families, datasets)
    return validate_release(
        assets=args.assets, out=args.out, families=families,
        datasets=datasets, configs_dir=args.configs,
        max_batches=args.max_batches, tol=args.tol,
        allow_random_init=args.allow_random_init,
        strict_convert=not args.no_strict_convert, fetch=args.fetch,
        device=args.device)


if __name__ == "__main__":
    sys.exit(main())
