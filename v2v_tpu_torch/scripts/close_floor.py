"""Close a train step's time by measured subtraction, in one process (the
port of the repo-root scripts/close_etnet_floor.py and
close_eraft_floor.py, which share this method).

    python -m v2v_tpu_torch.scripts.close_floor --config etnet|eraft|
        CONFIG.yaml [--steps 3] [--iters 5] [--batch B]
        [--sequence-length T] [--crop N] [--device cpu]

Rows, each timed here, a step or call between two CUDA events around a
synchronize (the host clock on the CPU), the median:

  S_all     the step as shipped (bench_full_step.build: the config's
            teacher, K1, the random LPIPS trunk and teacher)
  S_zeros   the same step with optical_flow_source: zeros, so
            teacher = S_all - S_zeros
  sim       the step's simulator stage alone at the config's B
            (synthesize_batch: K1, the bin sums, the GT frames)
  scan      = S_zeros - sim: the model, its loss, the backward and the
            optimizer as the step runs them
  P         the model's constituents, each forward + backward (autograd
            keeps a stage's activations, so the step runs each forward
            once; the JAX package's remat ran it twice):
              a split model (ETNet, E2VID): pre over B*T, the spine step
              x T, the tail over B*T (interface._forward_split);
              ERAFT: fnet over (T+1)*B, then the pair step x T
              (flow_interface._forward_eraft);
            their forwards alone are printed beside them
  residual  = scan - P (the loss, the optimizer and what chaining the
            constituents does not show), fill = P / scan

teacher + sim + P + residual = S_all by construction. Prints the table
and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import resolve_device
from .bench import describe_device
from .bench_full_step import build


def _ms(fn: Callable[[], Any], n: int, dev: torch.device) -> float:
    """The median ms of `fn()` over `n` calls after one warm call: CUDA
    events around each call between synchronizes, the host clock on the
    CPU."""
    fn()
    times = []
    for _ in range(n):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _step_ms(built, n: int, dev: torch.device) -> float:
    return _ms(lambda: built.step(built.batch, built.generator,
                                  **built.kwargs), n, dev)


def _fwd_bwd(iface, fn: Callable[[], Any]) -> Callable[[], None]:
    """fn()'s outputs summed by their means, backward into the model's
    parameters (and any input that wants a gradient), gradients cleared
    first as the step clears them."""
    def run():
        iface.model.zero_grad(set_to_none=True)
        out = fn()
        leaves = [x for x in _tensors(out) if x.requires_grad]
        sum(x.float().mean() for x in leaves).backward()
    return run


def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for x in out for t in _tensors(x)]
    return []


def _like(x: torch.Tensor, lead: int, g: torch.Generator,
          grad: bool = True) -> torch.Tensor:
    """Unit normals of x's dtype with leading dimension `lead` and x's
    other dimensions."""
    t = torch.randn((lead,) + tuple(x.shape[1:]), generator=g,
                    device=x.device).to(x.dtype)
    return t.requires_grad_(grad and t.is_floating_point())


def split_constituents(built, iters: int, dev: torch.device
                       ) -> Tuple[List[Tuple[str, float]], float]:
    """pre / spine step / tail of the split forward, forward and forward +
    backward, at the step's shapes and compute dtype; P = pre + T x
    spine + tail, forward + backward each."""
    from ..models.eitr import EITR
    from ..training.steps import dropout_generator
    iface, g = built.iface, built.generator
    b, t, h, w = built.shape
    events, _ = built.synthesize()
    iface.model.train(True)
    events, state = iface._cast_compute(
        events, iface.init_state(b, h, w), True)
    call = iface._caller(True)
    flat = events.reshape(b * t, *events.shape[2:]).permute(0, 3, 1, 2)
    tail_kw = ({"generator": dropout_generator(g)}
               if isinstance(iface.model, EITR) else {})
    with torch.no_grad():
        head1, pre1 = call(flat[:b], method="pre")
        blocks1, _ = call(pre1, state, method="spine_step")
    pre0 = _like(pre1, b, g)
    head = _like(head1, b * t, g)
    blocks = [_like(x, b * t, g) for x in blocks1]
    rows = []

    def row(name, fn, n=iters):
        ms = _ms(fn, n, dev)
        rows.append((name, ms))
        print(f"  [row] {name:<52s} {ms:9.3f} ms", flush=True)
        return ms

    with torch.no_grad():
        row(f"pre fwd (B*T={b * t})", lambda: call(flat, method="pre"))
        row("spine step fwd (x1)",
            lambda: call(pre0, state, method="spine_step"))
        row(f"tail fwd (B*T={b * t})",
            lambda: call(head, blocks, method="tail", **tail_kw))
    pre = row(f"pre fwd+bwd (B*T={b * t})",
              _fwd_bwd(iface, lambda: call(flat, method="pre")))
    spine = row("spine step fwd+bwd (x1)", _fwd_bwd(
        iface, lambda: call(pre0, state, method="spine_step")[0]))
    tail = row(f"tail fwd+bwd (B*T={b * t})", _fwd_bwd(
        iface, lambda: call(head, blocks, method="tail", **tail_kw)))
    p = pre + t * spine + tail
    rows.append((f"P = pre + {t} x spine + tail (fwd+bwd)", p))
    return rows, p


def eraft_constituents(built, iters: int, dev: torch.device
                       ) -> Tuple[List[Tuple[str, float]], float]:
    """fnet over (T+1)*B and one pair step, forward and forward + backward,
    at the step's shapes and compute dtype; P = fnet + T x pair."""
    iface, g = built.iface, built.generator
    b, t, h, w = built.shape
    events, _ = built.synthesize()
    iface.model.train(True)
    if iface.compute_dtype is not None:
        events = events.to(iface.compute_dtype)
    call = iface._caller(True)
    tp1 = events.shape[1]
    voxels = events.permute(1, 0, 4, 2, 3)              # (T+1,B,bins,H,W)
    flat = voxels.reshape(tp1 * b, *voxels.shape[2:])
    state = iface.init_state(b, h, w)
    with torch.no_grad():
        fmap1 = call(flat[:b], method="encode")
    f1, f2 = _like(fmap1, b, g), _like(fmap1, b, g)
    voxel2 = voxels[1]
    rows = []

    def row(name, fn, n=iters):
        ms = _ms(fn, n, dev)
        rows.append((name, ms))
        print(f"  [row] {name:<52s} {ms:9.3f} ms", flush=True)
        return ms

    pair = lambda: call(f1, f2, voxel2, state,  # noqa: E731
                        method="step_with_fmaps")[0]
    with torch.no_grad():
        row(f"fnet encode fwd ((T+1)*B={tp1 * b})",
            lambda: call(flat, method="encode"))
        row("pair step fwd (x1)", pair)
    fnet = row(f"fnet encode fwd+bwd ((T+1)*B={tp1 * b})",
               _fwd_bwd(iface, lambda: call(flat, method="encode")))
    one = row("pair step fwd+bwd (x1)", _fwd_bwd(iface, pair))
    p = fnet + (tp1 - 1) * one
    rows.append((f"P = fnet + {tp1 - 1} x pair (fwd+bwd)", p))
    return rows, p


def run(config: str, device=None, steps: int = 3, iters: int = 5,
        batch: Optional[int] = None, sequence_length: Optional[int] = None,
        crop: Optional[int] = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    cut = dict(batch=batch, sequence_length=sequence_length, crop=crop)

    def step_row(flow):
        built = build(config, dev, flow=flow, **cut)
        ms = _step_ms(built, steps, dev)
        print(f"[{flow or 'as shipped'}] {ms:.1f} ms/step", flush=True)
        return built, ms

    built, s_all = step_row(None)
    name, shape = built.name, built.shape
    del built
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    built, s_zeros = step_row("zeros")
    sim = _ms(lambda: built.synthesize(), max(iters, 3), dev)
    eraft = getattr(built.iface, "forward_type", None) == "eraft"
    if not eraft and not hasattr(built.iface.model, "spine_step"):
        raise ValueError(f"{name}: no split forward and no ERAFT pairs "
                         f"to close the step over")
    rows, p = (eraft_constituents if eraft else split_constituents)(
        built, iters, dev)
    teacher = s_all - s_zeros
    scan = s_zeros - sim
    residual = scan - p
    fill = p / scan if scan > 0 else float("nan")
    b, t, h, w = shape
    card = describe_device(dev)
    print(f"\n=== {name} step closure (B={b}, T={t}, {h}x{w}; {card}) ===",
          flush=True)
    table = [("full step S_all (as shipped)", s_all),
             ("step with zeros teacher S_zeros", s_zeros),
             ("teacher = S_all - S_zeros", teacher),
             ("sim (synthesize_batch: K1, bins, GT)", sim),
             ("scan = S_zeros - sim", scan),
             ("constituents P (fwd+bwd)", p),
             ("residual = scan - P", residual)]
    for label, ms in table:
        print(f"  {label:<44s} {ms:9.2f} ms  ({ms / s_all * 100:6.1f}% of "
              f"the step)", flush=True)
    print(f"  fill = P / scan = {fill:.3f}; teacher + sim + P + residual = "
          f"{teacher + sim + p + residual:.2f} ms = S_all by construction",
          flush=True)
    return {"config": name, "batch": b, "T": t, "hw": [h, w],
            "s_all_ms": s_all, "s_zeros_ms": s_zeros, "teacher_ms": teacher,
            "sim_ms": sim, "scan_ms": scan, "constituents_ms": p,
            "residual_ms": residual, "fill": fill,
            "rows": {k: v for k, v in rows}, "device": str(dev),
            "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m v2v_tpu_torch.scripts.close_floor",
        description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True,
                    help="etnet, eraft or a train YAML with a split model "
                         "or ERAFT")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--steps", type=int, default=3,
                    help="timed steps of S_all and S_zeros")
    ap.add_argument("--iters", type=int, default=5,
                    help="timed calls of each constituent")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--sequence-length", type=int, default=None)
    ap.add_argument("--crop", type=int, default=None)
    args = ap.parse_args(argv)
    out = run(args.config, args.device, args.steps, args.iters, args.batch,
              args.sequence_length, args.crop)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
