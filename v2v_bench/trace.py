"""The traced part of a `--trace 1` run: torch.profiler over a short
steady stretch of the window, reduced to what the per-layer metrics read.

The host records only the user-scope ranges (device.py::start_profile),
so the traced stretch runs at nearly the window's pace. A kernel belongs
to the span (a `record_function` range whose name starts with "v2v." or
"bench.") during which the host launched it: its launch is the CUDA
runtime or driver call with the kernel's correlation id (a kernel
launched through ctypes goes through the driver's), or else the range it
is linked to. Kernels that autograd's device thread launches land in
"v2v.backward", the range the main thread sits in meanwhile. The device
is busy while any kernel, copy or fill runs; busy_s is the union of
those intervals.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIXES = ("v2v.", "bench.")
# CUDA runtime and driver calls (cudaLaunchKernel, cudaLaunchKernelExC,
# cuLaunchKernel, cudaMemcpyAsync, ...): a kernel shares its correlation
# id with the call that launched it
_RUNTIME = re.compile(r"^cu[A-Z]|^cuda[A-Z]")
_GPU = (torch.autograd.DeviceType.CUDA,)


class Readings:
    """What a metric reader gets: per-unit device time by span and by
    kernel name, the busy and traced seconds, the units (train steps or
    eval frames) in the traced part, the seconds a unit in the untraced
    rest of the window, the cell, and the memory peak."""

    def __init__(self, cell, units: int, window_s: float, busy_s: float,
                 span_s: Dict[str, float],
                 kernels: Dict[str, Tuple[float, int]], peak_bytes: int,
                 untraced_unit_s: float):
        self.cell, self.units = cell, units
        self.window_s, self.busy_s = window_s, busy_s
        self.span_s, self.kernels = span_s, kernels
        self.peak_bytes = peak_bytes
        self.untraced_unit_s = untraced_unit_s

    @property
    def unit_s(self) -> float:
        """Traced seconds a unit."""
        return self.window_s / self.units

    def span_ms(self, name: str) -> Optional[float]:
        """Device ms a unit of the kernels launched inside span `name`."""
        s = self.span_s.get(name)
        return None if s is None else 1e3 * s / self.units

    def kernel(self, pattern: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name matches
        the regular expression `pattern`."""
        rx = re.compile(pattern)
        hits = [v for k, v in self.kernels.items() if rx.search(k)]
        return sum(h[0] for h in hits), sum(h[1] for h in hits)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(prof, cell, units: int, window_s: float, peak_bytes: int,
           untraced_unit_s: float) -> Tuple[Readings, Dict[str, list]]:
    """(Readings, breakdown) of a finished torch.profiler.profile of
    `units` units in `window_s` seconds."""
    events = prof.profiler.kineto_results.events()
    ops: Dict[int, int] = {}          # PyTorch op correlation -> start
    runtime: Dict[int, int] = {}      # CUDA runtime correlation -> start
    spans: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    gpu = []
    main_tid = None
    for e in events:
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() in _GPU:
            if not (e.is_user_annotation() or name.startswith(SPAN_PREFIXES)):
                gpu.append((start, end, name, e.correlation_id(),
                            e.linked_correlation_id()))
            continue
        if _RUNTIME.match(name):
            runtime[e.correlation_id()] = start
        else:
            ops[e.correlation_id()] = start
        if name.startswith(SPAN_PREFIXES):
            spans.append((start, end, name))
            main_tid = e.start_thread_id()
        host.append((start, end, name, e.start_thread_id()))
    spans.sort()
    starts = [s[0] for s in spans]

    def span_of(t: Optional[int]) -> Optional[str]:
        if t is None:
            return None
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and t <= spans[i][1] else None

    span_s: Dict[str, float] = defaultdict(float)
    kernels: Dict[str, List] = defaultdict(lambda: [0.0, 0])
    for start, end, name, corr, linked in gpu:
        launch = runtime.get(corr, ops.get(linked))
        sp = span_of(launch)
        if sp is not None:
            span_s[sp] += (end - start) * 1e-9
        kernels[name][0] += (end - start) * 1e-9
        kernels[name][1] += 1
    busy = _union([(s, e) for s, e, *_ in gpu])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    readings = Readings(cell, units, window_s, busy_s, dict(span_s),
                        {k: (v[0], v[1]) for k, v in kernels.items()},
                        peak_bytes, untraced_unit_s)
    return readings, _breakdown(kernels, busy, host, main_tid)


def _breakdown(kernels, busy, host, main_tid) -> Dict[str, list]:
    """The 10 device ops that took most time, and the idle time between
    busy stretches by what the main thread was doing when it began (its
    innermost span and op), the 10 largest."""
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    device_ops = [[k[:160], v[0]] for k, v in top]
    main = sorted(((s, -e, n) for s, e, n, tid in host if tid == main_tid))
    idle: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, str]] = []     # (end, name) of the open ops
    j = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        while j < len(main) and main[j][0] <= a:
            s, neg_e, n = main[j]
            while stack and stack[-1][0] <= s:
                stack.pop()
            stack.append((-neg_e, n))
            j += 1
        while stack and stack[-1][0] <= a:
            stack.pop()
        span = [n for _, n in stack if n.startswith(SPAN_PREFIXES)]
        op = [n for _, n in stack if not n.startswith(SPAN_PREFIXES)]
        label = "/".join(x[-1] for x in (span, op) if x) or "host outside any op"
        idle[label[:160]] += (b - a) * 1e-9
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": device_ops, "idle_gaps": [[k, v] for k, v in gaps]}
