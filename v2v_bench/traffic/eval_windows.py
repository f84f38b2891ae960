"""The eval-windows kind: the program's streaming eval step
(v2v_tpu_torch's training/steps.py::make_eval_step) over windows of
voxel frames, as eval/harness.py::run_test forwards them: a window of
`sequence_length` frames at a time, copied from host memory to the card,
the recurrent state carried from window to window of a sequence and
reset at the start of the next, the predictions copied back to the host
every window.

Traffic parameters (traffic/<mix>.json): `height`, `width`,
`events_per_frame` (each event a pixel, a polarity and a time spread
over two neighbouring bins, as the harness's interpolated voxels),
`windows_per_sequence`, `compare_past_boundary` (the frames after the
first window boundary that the check compares too), `trace_skip` (the
windows before the traced one in a `--trace 1` run).

Set-up makes one sequence's windows on the card from the seed and keeps
them in host memory; every sequence of the window replays them. After
the window, the plain reference runs one sequence from its start, drawn
from the seed among those after the first (so that the program had to
reset its state), through the first window and `compare_past_boundary`
frames of the second, and the predictions are compared.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from .. import weights
from ..device import free, peak_bytes, start_profile, stop_profile, sync
from ..reference import nets, sim
from ..reference.lowp import allow_tf32, tf32


@torch.no_grad()
def make_windows(cfg: dict, traffic: dict, seed: int, dev
                 ) -> List[np.ndarray]:
    """One sequence: `windows_per_sequence` float32 arrays (1, L, H, W,
    bins) in host memory."""
    h, w = traffic["height"], traffic["width"]
    bins, frames = cfg["test"]["num_bins"], cfg["test"]["sequence_length"]
    n_ev = traffic["events_per_frame"]
    g = torch.Generator(device=dev).manual_seed(sim.step_seed(seed, 0xe7a1))
    out = []
    for _ in range(traffic["windows_per_sequence"]):
        vox = torch.zeros((frames, h * w * bins), device=dev)
        for f in range(frames):
            pix = torch.randint(0, h * w, (n_ev,), generator=g, device=dev)
            u = torch.rand((2, n_ev), generator=g, device=dev)
            t = u[0] * (bins - 1)
            b0 = t.floor().clamp(max=bins - 2)
            frac = t - b0
            pol = torch.where(u[1] < 0.5, -1.0, 1.0)
            idx = pix * bins + b0.long()
            vox[f].index_add_(0, idx, (1 - frac) * pol)
            vox[f].index_add_(0, idx + 1, frac * pol)
        out.append(vox.reshape(1, frames, h, w, bins).cpu().numpy())
    return out


class Program:
    """The program's eval step for a configuration file, with the
    benchmark's weights loaded."""

    def __init__(self, cfg: dict, w: Dict[str, torch.Tensor], dev):
        from v2v_tpu_torch.training.interface import ModelInterface
        from v2v_tpu_torch.training.steps import make_eval_step
        g = torch.Generator(device=dev).manual_seed(0)
        self.iface = ModelInterface(cfg["test"]["module"], dev, generator=g)
        self.iface.model.load_state_dict(w)
        self.step = make_eval_step(self.iface)


def make_weights(cfg: dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    return weights.make(nets.build(cfg["test"]["module"]["model"]["target"]),
                        sim.step_seed(seed, 1), dev)


def stream(prog: Program, windows: List[np.ndarray], seconds: float,
           dev, keep, trace_at=None, most=None):
    """Windows until `seconds` have passed and the second window of a
    second sequence is done (so that the check has a sequence the program
    had to reset for), at a window boundary; or `most` windows. Returns
    (windows run, seconds, {(sequence, window): predictions kept},
    finite flags, (profile, traced seconds, seconds with the profiler's
    start and end) or None). `keep(seq, k)` says which windows'
    predictions to keep."""
    h, w = windows[0].shape[2:4]
    kept, finite, traced = {}, [], None
    n, state = 0, None
    t0 = time.perf_counter()
    while True:
        seq, k = divmod(n, len(windows))
        if k == 0:
            state = prog.iface.init_state(1, h, w)
        if n == trace_at:
            t_in = time.perf_counter()
            prof, t_tr = start_profile(dev)
        events = torch.as_tensor(windows[k], device=dev)
        with record_function("bench.eval_step"):
            pred, state = prog.step(events, state)
        finite.append(torch.isfinite(pred).all())
        host = pred.cpu().numpy()
        if keep(seq, k):
            kept[(seq, k)] = host
        n += 1
        if n - 1 == trace_at:
            traced = (prof, stop_profile(prof, t_tr, dev))
            traced += (time.perf_counter() - t_in,)
        if most is not None:
            if n == most:
                break
        elif time.perf_counter() - t0 >= seconds and (
                trace_at is None or traced is not None) and \
                n >= len(windows) + 2:
            break
    return n, time.perf_counter() - t0, kept, finite, traced


def reference_frames(cfg: dict, w: Dict[str, torch.Tensor],
                     windows: List[np.ndarray], extra: int, dev,
                     control: bool = False) -> np.ndarray:
    """The reference's predictions (1, L + extra, H, W, 1) of a
    sequence's first window and `extra` frames of its second, from the
    zero state: in float32 as the configuration states it (TF32 only
    where its `test.allow_tf32` lets it in, as PyTorch's defaults let
    cuDNN's convolutions), or (`control`) with every matmul, the
    attention's products and every convolution in TF32."""
    tf = cfg["test"].get("allow_tf32", {})
    net = nets.build(cfg["test"]["module"]["model"]["target"])
    net = net.to_empty(device=dev)
    net.load_state_dict(w)
    net = net.requires_grad_(False)
    h, wd = windows[0].shape[2:4]
    with (tf32() if control else allow_tf32(tf.get("matmul", False),
                                            tf.get("cudnn", False))), \
            torch.no_grad():
        state = net.init_state(1, h, wd, torch.float32, dev)
        first, state = nets.stream(net, torch.as_tensor(windows[0],
                                                        device=dev), state)
        second, _ = nets.stream(net, torch.as_tensor(
            windows[1][:, :extra], device=dev), state)
    return torch.cat([first, second], 1).cpu().numpy()


def compare(pred: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    d = pred.astype(np.float64) - ref
    return {"pred_max_gap": float(np.abs(d).max()),
            "pred_rms_gap": float(np.sqrt((d * d).mean())
                                  / np.sqrt((ref.astype(np.float64) ** 2
                                             ).mean()))}


def sampled(cell, seed: int, kept, windows_run: int, extra: int
            ) -> np.ndarray:
    """The predictions the check compares: a sequence drawn from the
    seed among the completed ones after the first (the first, if the
    window held no other), its first window and `extra` frames of the
    second."""
    per = cell.traffic["windows_per_sequence"]
    done = [s for s in range(windows_run // per + 1)
            if (s, 0) in kept and (s, 1) in kept]
    later = [s for s in done if s > 0] or done
    seq = random.Random(sim.step_seed(seed, 0xc4ec)).choice(later)
    return np.concatenate([kept[(seq, 0)], kept[(seq, 1)][:, :extra]], 1)


# faults an eval cell can have, planted under the step (tests, calibration)

def _state_not_carried(prog: Program) -> None:
    """A step that hands back the state it was given."""
    step = prog.step
    prog.step = lambda events, state: (step(events, state)[0], state)


def _answer_altered(prog: Program) -> None:
    """One pixel of each window's first prediction off by 0.5."""
    step = prog.step

    def altered(events, state):
        pred, state = step(events, state)
        pred = pred.clone()
        pred[0, 0, 0, 0, 0] += 0.5
        return pred, state

    prog.step = altered


FAULTS = {"state_unchanged": _state_not_carried,
          "answer_altered": _answer_altered}


def calibrate(cell, seed: int, side: str, dev) -> Dict[str, float]:
    """The compared numbers of one seed: the program (or a fault of
    FAULTS planted in it) streams a sequence's first two windows; or
    `side` "control", the reference in TF32 against the reference."""
    cfg, traffic = cell.config, cell.traffic
    extra = traffic["compare_past_boundary"]
    w = make_weights(cfg, seed, dev)
    windows = make_windows(cfg, traffic, seed, dev)
    if side == "control":
        pred = reference_frames(cfg, w, windows, extra, dev, control=True)
    else:
        prog = Program(cfg, w, dev)
        if side in FAULTS:
            FAULTS[side](prog)
        _, _, kept, _, _ = stream(prog, windows, 0.0, dev,
                                  keep=lambda s, k: k < 2, most=2)
        pred = np.concatenate([kept[(0, 0)], kept[(0, 1)][:, :extra]], 1)
        del prog, kept
        free(dev)
    return compare(pred, reference_frames(cfg, w, windows, extra, dev))


def run(cell, seed: int, seconds: float, trace: bool, dev, clock,
        fault=None):
    """One run: set-up, the window, the reference and the comparison."""
    from ..trace import reduce
    cfg, traffic = cell.config, cell.traffic
    w = make_weights(cfg, seed, dev)
    windows = make_windows(cfg, traffic, seed, dev)
    prog = Program(cfg, w, dev)
    if fault is not None:
        fault(prog)
    # warm every shape: two frames of a window from the zero state
    h, wd = windows[0].shape[2:4]
    prog.step(torch.as_tensor(windows[0][:, :2], device=dev),
              prog.iface.init_state(1, h, wd))
    sync(dev)
    setup_s = clock()
    extra = traffic["compare_past_boundary"]
    n, window_s, kept, finite, traced = stream(
        prog, windows, seconds, dev, keep=lambda s, k: k < 2,
        trace_at=traffic["trace_skip"] if trace else None)
    frames = n * cfg["test"]["sequence_length"]
    bad = sum(1 for f in finite if not bool(f))
    peak = peak_bytes(dev)
    readings = breakdown = None
    if traced is not None:
        length = cfg["test"]["sequence_length"]
        readings, breakdown = reduce(traced[0], cell, length, traced[1],
                                     peak, (window_s - traced[2])
                                     / (frames - length))
    pred = sampled(cell, seed, kept, n, extra)
    del prog, kept
    free(dev)
    ref = reference_frames(cfg, w, windows, extra, dev)
    return {"setup_s": setup_s, "window_s": window_s,
            "attempted": frames,
            "failed": bad * cfg["test"]["sequence_length"],
            "end_to_end": {"eval_frames_per_s": frames / window_s},
            "readings": readings, "breakdown": breakdown,
            "memory_peak_bytes": peak, "checks": compare(pred, ref)}
