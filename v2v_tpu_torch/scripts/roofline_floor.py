"""A train step's measured floor: its matmuls and convolutions replayed
alone on the card (the port of the repo-root scripts/roofline_floor.py).

    python -m v2v_tpu_torch.scripts.roofline_floor [--config flagship|
        hyper|etnet|evflow|eraft|CONFIG.yaml] [--top 12] [--steps 3]
        [--repeats 3] [--no-calibrate] [--device cpu]

Method: one train step of the config (bench_full_step.build: the
shipped step, K1 included, random LPIPS trunk and teacher) runs under
utils/flops.py::record_ops, which keeps every matmul, convolution and
booked bilinear resize with its shapes, dtypes, strides, stride,
padding, dilation, groups, transposed flag, output padding and count.
The top `--top` entries by FLOPs are replayed alone on the card in the
step's dtypes and with the process's cuDNN and TF32 settings (the
step's: the same process), each as N calls captured in one CUDA graph
and timed between two CUDA events, so no host time a call enters a
lower bound. The floor is

    T_floor = sum_i flops_i / rate_i

with each top entry's measured rate and, for the tail, the rate of a
4096^3 bfloat16 matmul timed the same way; a rate above 1.15 x that
calibration counts at the calibration (the JAX script's leak guard), an
unresolved one (no time measured) at it too. The step cannot run
faster than its own matmuls and convolutions run alone, so
gap = measured ms/step / T_floor. A booked resize replays as the port
runs it, ATen's bilinear upsample, which is no matmul: its FLOPs are the
JAX counter's, its time ATen's, so the floor shows what the upsample
costs.

FlopCounterMode cannot see the port's ctypes kernels: K3 (attention),
K4 (dynamic_shift_sum) and its gradient. Their bound x launches in the
recorded step is printed on a line apart and not added, as the JAX floor
counts only the MXU's ops. Prints the JAX script's table, a dtype
census, `FLOOR <config>: <ms> ms/step`, the step's measured ms/step
(bench_full_step's timing, in this process) and the gap, then one JSON
line. On the CPU (`--device cpu`) every time is the host's.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import resolve_device
from .bench import describe_device
from .bench_full_step import BF16_PEAK_FLOPS, build, time_steps

# a rate above this share of the calibration is a method leak
LEAK_GUARD = 1.15
# H100 SXM data sheet: HBM bytes/s, float32 FLOP/s outside the tensor
# cores, dense TF32 FLOP/s; exponentials: 16 a clock on each of the 132
# SMs at the 1.98 GHz boost clock (the terms of chip_smoke.py's bounds)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
EXP_PER_S = 16 * 132 * 1.98e9
# a replay's CUDA graph holds about this much work
GRAPH_MS = 20.0


def calibration_entry() -> Dict[str, Any]:
    """A 4096^3 bfloat16 matmul as a recorded entry."""
    from ..utils.flops import TensorSpec
    t = TensorSpec((4096, 4096), torch.bfloat16, (4096, 1))
    return {"op": torch.ops.aten.mm, "name": "mm", "args": (t, t),
            "kwargs": {}, "count": 1, "flops": 2.0 * 4096 ** 3,
            "tensors": [t, t]}


def time_entry(entry: Dict[str, Any], dev: torch.device,
               generator: torch.Generator) -> Optional[float]:
    """Seconds a call of the entry's op, alone. On the card: N calls (N
    sized so the graph holds ~GRAPH_MS of work) captured in one CUDA
    graph, its replay timed between two CUDA events; on the CPU the host
    clock over N calls. None where no time was measured."""
    from ..utils.flops import replay, replay_inputs
    args, kwargs = replay_inputs(entry, dev, generator)

    def call():
        replay(entry, args, kwargs)

    if dev.type != "cuda":
        call()
        t0 = time.perf_counter()
        call()
        n = max(1, min(20, int(GRAPH_MS / 1e3 / max(
            time.perf_counter() - t0, 1e-9))))
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        sec = (time.perf_counter() - t0) / n
        return sec if sec > 0 else None
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):            # warm up off the capture
        for _ in range(3):
            call()
    torch.cuda.current_stream(dev).wait_stream(side)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    end.synchronize()
    n = max(3, min(200, int(GRAPH_MS / max(start.elapsed_time(end), 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            call()
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    del graph
    return ms / 1e3 / n if ms > 0 else None


def floor_seconds(ranked: List[Dict[str, Any]],
                  rates: List[Optional[float]], peak: float
                  ) -> Tuple[float, List[Tuple[float, float, str]]]:
    """The JAX script's floor: the entries past len(rates) at `peak`,
    each of the first len(rates) at its measured rate, where a missing
    rate and one above LEAK_GUARD x peak count at `peak`. Returns the
    floor and (rate used, seconds, note) for each measured entry."""
    total = sum(e["flops"] for e in ranked)
    top_fl = sum(e["flops"] for e in ranked[:len(rates)])
    floor = (total - top_fl) / peak
    rows = []
    for e, rate in zip(ranked, rates):
        if rate is None:
            rate, note = peak, " (unresolved: peak assumed)"
        elif rate > LEAK_GUARD * peak:
            note = (f" (!! {rate / 1e12:.0f} TF/s > the calibrated peak: "
                    f"method leak, peak assumed)")
            rate = peak
        else:
            note = ""
        contrib = e["flops"] / rate
        floor += contrib
        rows.append((rate, contrib, note))
    return floor, rows


def _bound_ms(bytes_: float, *terms: float) -> float:
    return max([bytes_ / HBM_BYTES_PER_S] + list(terms)) * 1e3


def _k4_bound(z, atoms) -> float:
    """K4: z and atoms read once, the float32 output written once; 2
    operations a multiply-add, 25 M of them an output (float32 rate)."""
    b, h, w, m, co = z.shape
    return _bound_ms(z.numel() * z.element_size() + atoms.numel() * 4
                     + b * h * w * co * 4,
                     2 * atoms.shape[-1] * m * b * h * w * co / F32_FLOPS)


def _k4_bwd_bound(z, atoms) -> float:
    """K4's gradient: z, atoms and g read once, dz and datoms written
    once; twice the forward's operations."""
    b, h, w, m, co = z.shape
    return _bound_ms(2 * (z.numel() * z.element_size() + atoms.numel() * 4)
                     + b * h * w * co * 4,
                     4 * atoms.shape[-1] * m * b * h * w * co / F32_FLOPS)


def _k3_bound(q, k) -> float:
    """K3: q, k, v read and o written once; three TF32 passes of its two
    matmuls, or its exponentials."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    return _bound_ms(4 * (2 * q.numel() + 2 * k.numel()),
                     3 * 4 * b * h * nq * nk * dh / TF32_FLOPS,
                     b * h * nq * nk / EXP_PER_S)


@contextlib.contextmanager
def hidden_kernels():
    """Log the bound of each launch of K3, K4 and K4's gradient, which
    FlopCounterMode cannot see: {name: [bound ms of each launch]}."""
    from ..models import eitr
    from ..ops import dynconv
    log: Dict[str, List[float]] = {"attention": [], "dynamic_shift_sum": [],
                                   "dynamic_shift_sum_backward": []}
    fwd, bwd, att = (dynconv._shift_sum_kernel,
                     dynconv._shift_sum_bwd_kernel, eitr.attention)

    def k4(z, atoms, *a, **kw):
        log["dynamic_shift_sum"].append(_k4_bound(z, atoms))
        return fwd(z, atoms, *a, **kw)

    def k4_bwd(z, atoms, *a, **kw):
        log["dynamic_shift_sum_backward"].append(_k4_bwd_bound(z, atoms))
        return bwd(z, atoms, *a, **kw)

    def k3(q, k, v):
        if q.device.type == "cuda":
            log["attention"].append(_k3_bound(q, k))
        return att(q, k, v)

    dynconv._shift_sum_kernel, dynconv._shift_sum_bwd_kernel = k4, k4_bwd
    eitr.attention = k3
    try:
        yield log
    finally:
        dynconv._shift_sum_kernel, dynconv._shift_sum_bwd_kernel = fwd, bwd
        eitr.attention = att


def _describe(e: Dict[str, Any]) -> str:
    shapes = "x".join(str(t.shape) for t in e["tensors"])
    return f"{e['name']:<28s} {shapes}"


def run(config: str = "flagship", device=None, top: int = 12,
        steps: int = 3, repeats: int = 3, calibrate: bool = True
        ) -> Dict[str, Any]:
    from ..utils.flops import record_ops
    dev = resolve_device(device)
    name, step, bt, g, kw, (b, t, h, w), _, _ = build(config, dev)
    with hidden_kernels() as hidden:
        entries, _ = record_ops(step, bt, g, **kw)          # the warm step
    timed = time_steps(step, bt, g, kw, dev, steps, repeats)
    total = sum(e["flops"] for e in entries)
    ranked = entries[:top]
    top_fl = sum(e["flops"] for e in ranked)
    print(f"{name} (B={b}, T={t}, {h}x{w}): {total / 1e12:.3f} TF over "
          f"{len(entries)} distinct calls; top {len(ranked)} cover "
          f"{top_fl / total * 100:.1f}%", flush=True)
    census: Dict[str, float] = {}
    for e in entries:
        dt = str(e["tensors"][0].dtype).replace("torch.", "")
        census[dt] = census.get(dt, 0.0) + e["flops"]
    print("  dtype census: " + ", ".join(
        f"{k} {v / total * 100:.1f}%" for k, v in
        sorted(census.items(), key=lambda kv: -kv[1])), flush=True)
    print(f"  settings: cudnn.benchmark={torch.backends.cudnn.benchmark} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)
    peak, cal = BF16_PEAK_FLOPS, None
    if calibrate:
        sec = time_entry(calibration_entry(), dev, g)
        if sec:
            cal = peak = 2.0 * 4096 ** 3 / sec
        print(f"calibration 4096^3 bf16 matmul: {(cal or 0) / 1e12:.1f} "
              f"TF/s (tail and leak-guard peak)", flush=True)
    card = describe_device(dev)
    print(f"measuring the top {len(ranked)} on {card} ...", flush=True)
    secs = [time_entry(e, dev, g) for e in ranked]
    rates = [None if s is None else e["flops"] / e["count"] / s
             for e, s in zip(ranked, secs)]
    floor, rows = floor_seconds(entries, rates, peak)
    out_rows = []
    for e, s, (rate, contrib, note) in zip(ranked, secs, rows):
        print(f"  {e['flops'] / 1e12:7.3f} TF x{e['count']:5d} "
              f"{_describe(e)} {str(e['tensors'][0].dtype)[6:]} -> "
              f"{rate / 1e12:6.1f} TF/s ({contrib * 1e3:7.2f} ms){note}",
              flush=True)
        out_rows.append({"op": e["name"], "count": e["count"],
                         "flop": e["flops"],
                         "shapes": [list(x.shape) for x in e["tensors"]],
                         "dtype": str(e["tensors"][0].dtype)[6:],
                         "call_ms": None if s is None else s * 1e3,
                         "rate": rate, "ms": contrib * 1e3,
                         "note": note.strip()})
    hidden_ms = {k: sum(v) for k, v in hidden.items()}
    print("  not in the floor (FlopCounterMode cannot see them), bound x "
          "launches in the recorded step: " + "; ".join(
              f"{k} {len(hidden[k])} launches, {hidden_ms[k]:.4f} ms"
              for k in hidden), flush=True)
    ms = timed["ms_per_step"]
    gap = ms / (floor * 1e3)
    print(f"FLOOR {name}: {floor * 1e3:.2f} ms/step (tail at "
          f"{peak / 1e12:.1f} TF/s)", flush=True)
    print(f"measured {name}: {ms:.1f} ms/step (median of {repeats} x "
          f"{steps} synchronized steps); gap = measured / floor = "
          f"{gap:.3f}", flush=True)
    return {"config": name, "batch": b, "T": t, "hw": [h, w],
            "flop_per_step": total, "distinct_calls": len(entries),
            "top": len(ranked), "top_share": top_fl / total,
            "dtype_census": {k: v / total for k, v in census.items()},
            "calibration_flop_per_s": cal, "tail_rate": peak,
            "rows": out_rows, "floor_ms": floor * 1e3,
            "hidden_bound_ms": hidden_ms,
            "hidden_launches": {k: len(v) for k, v in hidden.items()},
            "measured_ms_per_step": ms, "spread": timed["spread"],
            "gap": gap, "last_loss": timed["last_loss"],
            "device": str(dev), "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m v2v_tpu_torch.scripts.roofline_floor",
        description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="flagship",
                    help="flagship, hyper, etnet, evflow, eraft or a "
                         "train YAML")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--steps", type=int, default=3,
                    help="timed steps a repeat for the measured ms/step")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--no-calibrate", action="store_true",
                    help="the tail at the data sheet's dense bf16 peak")
    args = ap.parse_args(argv)
    out = run(args.config, args.device, args.top, args.steps, args.repeats,
              not args.no_calibrate)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
