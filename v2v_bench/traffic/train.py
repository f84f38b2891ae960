"""The train kind: the program's train step (v2v_tpu_torch's
training/steps.py::make_train_step) on clips of uint8 video made on the
card from the seed, dispatched back to back as training does.

Set-up builds the step once, loads the benchmark's weights into its
model, LPIPS trunk and teacher, and drives it through its first three
steps on three different batches, recording what the step's stages hand
on (the simulator's events and frames, the teacher's flow, the
predictions, the loss), the optimizer's first gradient and the
parameters after the third step. Those steps are also the warm-up. The
window then runs the same step object on; after it, the plain reference
(reference/train.py) repeats the first three steps from the same weights,
videos and generator seeds, and the two are compared.

Traffic parameters (traffic/<mix>.json): `pool_batches`, the batches of
clips made at set-up and cycled through; `max_speed_px`, the largest
drift of a clip's texture a frame; `trace_steps`, the steps of the
traced stretch that follows the window in a `--trace 1` run.
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List

import torch
import torch.nn.functional as F

from .. import weights
from ..device import free, peak_bytes, start_profile, stop_profile, sync
from ..reference import lpips_vgg, nets, raft_small, sim
from ..reference.lowp import fp8, strict_fp32
from ..reference.train import train_steps

FIRST_STEPS = 3


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

@torch.no_grad()
def make_videos(traffic: dict, batches: int, b: int, n: int, hw: int,
                seed: int, dev) -> List[torch.Tensor]:
    """`batches` (b, n, hw, hw) uint8 batches: a smoothed random texture a
    clip, drifting at a constant sub-pixel velocity, with a slow
    brightness swing; made on the card in a few calls a batch."""
    g = torch.Generator(device=dev).manual_seed(sim.step_seed(seed, 0x51d))
    clips = batches * b
    tex = F.avg_pool2d(torch.rand((clips, 1, 2 * hw + 2, 2 * hw + 2),
                                  generator=g, device=dev), 3, 1)
    prm = torch.rand((clips, 6), generator=g, device=dev)
    speed = traffic["max_speed_px"]
    f = torch.arange(n, device=dev, dtype=torch.float32)
    ox = prm[:, 0:1] * hw + (2 * prm[:, 2:3] - 1) * speed * f
    oy = prm[:, 1:2] * hw + (2 * prm[:, 3:4] - 1) * speed * f
    gain = 0.55 + 0.35 * torch.sin(2 * math.pi * (prm[:, 4:5] + f / (
        400 * (1 + prm[:, 5:6]))))
    px = torch.arange(hw, device=dev, dtype=torch.float32)
    size = tex.shape[-1]
    out = []
    for i in range(batches):
        sl = slice(i * b, (i + 1) * b)
        gx = (px[None, None, None, :] + ox[sl, :, None, None])
        gy = (px[None, None, :, None] + oy[sl, :, None, None])
        grid = torch.stack([(gx + 0.5).expand(-1, -1, hw, -1),
                            (gy + 0.5).expand(-1, -1, -1, hw)], -1)
        grid = grid * (2.0 / size) - 1.0
        frames = F.grid_sample(tex[sl], grid.reshape(b, n * hw, hw, 2),
                               mode="bilinear", padding_mode="reflection",
                               align_corners=False).reshape(b, n, hw, hw)
        frames = frames * gain[sl, :, None, None]
        out.append((frames.clamp(0, 1) * 255).round().to(torch.uint8))
    return out


def make_weights(cfg: dict, seed: int, dev) -> Dict[str, Dict]:
    """The model's, the LPIPS network's and the teacher's weights."""
    module = cfg["module"]
    return {
        "model": weights.make(nets.build(module["model"]["target"]),
                              sim.step_seed(seed, 1), dev),
        "lpips": weights.make(lpips_vgg.build(), sim.step_seed(seed, 2),
                              dev, gain=math.sqrt(6)),
        "teacher": weights.make(raft_small.build(), sim.step_seed(seed, 3),
                                dev)}


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

class Program:
    """The program's train step built from a configuration file, with
    the benchmark's weights loaded."""

    def __init__(self, cfg: dict, w: Dict[str, Dict], dev):
        from v2v_tpu_torch.losses.lpips import LPIPS
        from v2v_tpu_torch.training.interface import (LossConfig,
                                                      ModelInterface)
        from v2v_tpu_torch.training.raft import random_teacher
        from v2v_tpu_torch.training.steps import make_train_step
        from v2v_tpu_torch.training.train import (make_optimizer,
                                                  make_scheduler,
                                                  sim_config_from_dataset)
        module, train = cfg["module"], cfg["train"]
        g = torch.Generator(device=dev).manual_seed(0)
        loss_cfg = LossConfig.from_dict(module["loss"])
        lp = LPIPS(loss_cfg.lpips_type, dev, generator=g)
        lp.module.load_state_dict(w["lpips"])
        teacher = random_teacher(loss_cfg.raft_num_flow_updates, dev,
                                 generator=g,
                                 source=loss_cfg.optical_flow_source)
        teacher.load_state_dict(w["teacher"])
        self.iface = ModelInterface(module, dev, generator=g, lpips=lp,
                                    teacher=teacher)
        self.iface.model.load_state_dict(w["model"])
        opt_cfg = make_optimizer(train["optimizer"])
        self.opt = opt_cfg.make(self.iface.model.parameters())
        for group in self.opt.param_groups:
            group["lr"] = opt_cfg.base_lr * make_scheduler(
                train["lr_scheduler"])(0)
        self.step = make_train_step(
            self.iface, self.opt, sim_config_from_dataset(train["sim"]),
            num_bins=train["num_bins"],
            frames_per_bin=train["frames_per_bin"])
        self.names = [k for k, _ in self.iface.model.named_parameters()]
        self.params = [p for _, p in self.iface.model.named_parameters()]


def first_steps(prog: Program, videos, seeds, w0: Dict[str, torch.Tensor]
                ) -> Dict[str, object]:
    """Drive the program's step through its first steps on `videos` with
    generator seeds `seeds`, recording what its stages hand on."""
    iface = prog.iface
    rec: Dict[str, list] = {k: [] for k in ("events", "frames", "flow",
                                            "pred", "loss")}
    prepare, calc = iface.prepare_flow, iface.calc_loss

    def prepare_rec(batch, test=False):
        out = prepare(batch, test)
        for k, src in (("events", batch["events"]), ("frames", batch["frame"]),
                       ("flow", out["flow"])):
            rec[k].append(src.detach().to("cpu", copy=True))
        return out

    def calc_rec(pred, batch, remove_flow_loss=False):
        rec["pred"].append(pred.detach().to("cpu", copy=True))
        return calc(pred, batch, remove_flow_loss)

    iface.prepare_flow = prepare_rec
    iface.calc_loss = calc_rec
    dev = videos[0].device
    try:
        for i, (video, seed) in enumerate(zip(videos, seeds)):
            g = torch.Generator(device=dev).manual_seed(seed)
            loss, _ = prog.step(_batch(video), g)
            rec["loss"].append(float(loss))
            if i == 0:
                rec["grad"] = first_gradient(prog)
    finally:
        iface.prepare_flow, iface.calc_loss = prepare, calc
    rec["change"] = {k: float((p.detach() - w0[k]).norm())
                     for k, p in zip(prog.names, prog.params)}
    return rec


def first_gradient(prog: Program) -> Dict[str, float]:
    """The first step's gradient norm by leaf, as the optimizer got it:
    Adam's first moment after one step is (1 - beta1) x the gradient (0
    for a leaf the optimizer never saw)."""
    b1 = prog.opt.param_groups[0]["betas"][0]
    out = {}
    for k, p in zip(prog.names, prog.params):
        m = prog.opt.state.get(p, {}).get("exp_avg")
        out[k] = 0.0 if m is None else float(m.norm()) / (1 - b1)
    return out


def _batch(video: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"video": video, "data_source_idx": torch.full(
        (video.shape[0],), 11, dtype=torch.int64)}


def reference_record(cfg: dict, w: Dict[str, Dict], videos, seeds,
                     control: bool = False) -> Dict[str, object]:
    """The reference's record of the same steps, in float32 with TF32
    off, or (`control`) with fp8 operands."""
    with strict_fp32():
        if control:
            with fp8():
                out = train_steps(cfg, w, videos, seeds,
                                  cfg["reference_block"])
        else:
            out = train_steps(cfg, w, videos, seeds, cfg["reference_block"])
    w0 = w["model"]
    rec = {k: out[k] for k in ("events", "frames", "flow", "pred", "loss")}
    rec["grad"] = {k: float(g.norm()) for k, g in out["grad1"].items()}
    rec["change"] = {k: float((p - w0[k]).norm())
                     for k, p in out["params"].items()}
    return rec


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def leaf_gaps(p: Dict[str, float], r: Dict[str, float], keep
              ) -> Dict[str, float]:
    """Each leaf's gap of norms, against the larger of its own reference
    norm and the median leaf's."""
    med = statistics.median(r[k] for k in keep)
    return {k: abs(p[k] - r[k]) / max(r[k], med) for k in keep}


def compare(prog: Dict[str, object], ref: Dict[str, object]
            ) -> Dict[str, float]:
    """The numbers `correct` is decided on (see PERF.md for each)."""
    dev = ref["events"][0].device
    out = {"sim_mismatch": 0.0, "flow_gap": 0.0, "pred_gap": 0.0,
           "loss_gap": 0.0}
    for i in range(len(ref["loss"])):
        for k in ("events", "frames"):
            out["sim_mismatch"] += float(
                (prog[k][i].to(dev) != ref[k][i]).sum())
        for k in ("flow", "pred"):
            r = ref[k][i]
            gap = float((prog[k][i].to(dev) - r).norm() / r.norm())
            out[f"{k}_gap"] = max(out[f"{k}_gap"], gap)
        out["loss_gap"] = max(out["loss_gap"], abs(
            prog["loss"][i] - ref["loss"][i]) / abs(ref["loss"][i]))
        if i == 0:
            # the first step's, where both sides start from the same
            # weights: the forward's and the loss's precision alone
            out["pred_gap_first"] = out["pred_gap"]
            out["loss_gap_first"] = out["loss_gap"]
    grads = ref["grad"]
    med = statistics.median(grads.values())
    gaps = leaf_gaps(prog["grad"], grads, list(grads))
    out["grad_gap"] = max(gaps.values())
    out["grad_gap_median"] = statistics.median(gaps.values())
    # leaves whose reference gradient is nought to rounding move by
    # round-off alone under Adam: left out of the change
    moved = [k for k, v in grads.items() if v >= 1e-3 * med]
    gaps = leaf_gaps(prog["change"], ref["change"], moved)
    out["change_gap"] = max(gaps.values())
    out["change_gap_median"] = statistics.median(gaps.values())
    return out


def worst_leaves(prog: Dict[str, object], ref: Dict[str, object], n: int = 3
                 ) -> Dict[str, list]:
    """The leaves of the largest gradient and change gaps, with the
    program's and the reference's norms (for the calibration's look)."""
    out = {}
    for key in ("grad", "change"):
        gaps = leaf_gaps(prog[key], ref[key], list(ref[key]))
        top = sorted(gaps, key=gaps.get, reverse=True)[:n]
        out[key] = [[k, gaps[k], prog[key][k], ref[key][k]] for k in top]
    return out


# ---------------------------------------------------------------------------
# faults a train cell can have, planted under the step (tests, calibration)
# ---------------------------------------------------------------------------

def _half_batch(prog: Program) -> None:
    """The loss, and so the gradient, of the first half of the batch."""
    calc = prog.iface.calc_loss

    def half(pred, batch, remove_flow_loss=False):
        h = pred.shape[0] // 2
        return calc(pred[:h], {k: v[:h] if torch.is_tensor(v) and v.dim()
                               and v.shape[0] == pred.shape[0] else v
                               for k, v in batch.items()}, remove_flow_loss)

    prog.iface.calc_loss = half


def _frozen(prog: Program) -> None:
    """A step that leaves its state as it was: no update."""
    prog.opt.step = lambda *a, **k: None


FAULTS = {"half_batch": _half_batch, "state_unchanged": _frozen}


def _float32_teacher(prog: Program) -> None:
    """The program's teacher in float32 (its default is bfloat16): not a
    fault, a look at how far the teacher's precision moves the rest."""
    prog.iface.teacher_dtype = None


LOOKS = {"float32_teacher": _float32_teacher}


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

def setup(cell, seed: int, dev, fault=None):
    """Weights, videos, the program, its first steps: (program, record,
    weights, videos, seeds). `fault(program)` plants a fault under the
    step first (the tests' and the calibration's)."""
    cfg, tr = cell.config, cell.config["train"]
    b, t, hw = tr["batch"], tr["sequence_length"], tr["crop_size"]
    n = t * tr["num_bins"] * tr["frames_per_bin"] + 1
    w = make_weights(cfg, seed, dev)
    videos = make_videos(cell.traffic, cell.traffic["pool_batches"], b, n,
                         hw, seed, dev)
    seeds = [sim.step_seed(seed, 0x57e9, k)
             for k in range(FIRST_STEPS)]
    prog = Program(cfg, w, dev)
    if fault is not None:
        fault(prog)
    rec = first_steps(prog, videos[:FIRST_STEPS], seeds, w["model"])
    return prog, rec, w, videos, seeds


def calibrate(cell, seed: int, side: str, dev) -> Dict[str, object]:
    """The compared numbers of one seed without a window: `side` is
    "program", "control" (the reference in fp8 against the reference), a
    fault of FAULTS planted in the program or a look of LOOKS; with the
    worst leaves under "leaves"."""
    if side == "control":
        cfg, tr = cell.config, cell.config["train"]
        n = tr["sequence_length"] * tr["num_bins"] * tr["frames_per_bin"] + 1
        w = make_weights(cfg, seed, dev)
        videos = make_videos(cell.traffic, FIRST_STEPS, tr["batch"], n,
                             tr["crop_size"], seed, dev)
        seeds = [sim.step_seed(seed, 0x57e9, k) for k in range(FIRST_STEPS)]
        rec = reference_record(cfg, w, videos, seeds, control=True)
    else:
        prog, rec, w, videos, seeds = setup(
            cell, seed, dev, FAULTS.get(side, LOOKS.get(side)))
        videos = videos[:FIRST_STEPS]
        del prog
        free(dev)
    ref = reference_record(cell.config, w, videos, seeds)
    return dict(compare(rec, ref), leaves=worst_leaves(rec, ref))


def run(cell, seed: int, seconds: float, trace: bool, dev, clock,
        fault=None):
    """One run: set-up, the window, with `trace` a traced stretch after
    it, the reference and the comparison."""
    from ..trace import reduce
    prog, rec, w, videos, seeds = setup(cell, seed, dev, fault)
    sync(dev)
    setup_s = clock()
    b = cell.config["train"]["batch"]
    g = torch.Generator(device=dev).manual_seed(0)
    losses, k = [], FIRST_STEPS

    def step():
        nonlocal k
        g.manual_seed(sim.step_seed(seed, 0x57e9, k))
        loss, _ = prog.step(_batch(videos[k % len(videos)]), g)
        losses.append(loss)
        k += 1

    t0 = time.perf_counter()
    while True:
        step()
        if time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    steps = k - FIRST_STEPS
    readings = breakdown = prof = None
    if trace:
        # after the window: CUPTI's records cost the host time at every
        # launch, so the traced steps run slower than the window's
        tr_steps = cell.traffic["trace_steps"]
        prof, t_tr = start_profile(dev)
        for _ in range(tr_steps):
            step()
        traced = stop_profile(prof, t_tr, dev)
    bad = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = peak_bytes(dev)
    if trace:
        readings, breakdown = reduce(prof, cell, tr_steps, traced, peak,
                                     window_s / steps)
    done = k - FIRST_STEPS
    del prog, losses, prof
    free(dev)
    ref = reference_record(cell.config, w, videos[:FIRST_STEPS], seeds)
    return {"setup_s": setup_s, "window_s": window_s,
            "attempted": done * b, "failed": bad * b,
            "end_to_end": {"train_clips_per_s": steps * b / window_s},
            "readings": readings, "breakdown": breakdown,
            "memory_peak_bytes": peak, "checks": compare(rec, ref)}
