"""Profiling timers (port of v2v_tpu/utils/timers.py; reference
utils/timers.py).

`Timer` measures host wall time. `DeviceTimer` measures device work: when
the result it is handed lies on the card it times between two CUDA events
on the current stream and waits for the second; on the CPU, where work
is done when the call returns, it reads the host clock. Both append
milliseconds to module-level dicts, and `print_timing_info` summarizes
them at exit (registered once a timer has been used). `profile_trace`
writes a torch.profiler Chrome trace into a log dir.

`span(name)` is the program's named stage: it always opens the
`record_function` range `name`, which torch.profiler sees. With the
tracer on (`trace_on(device)`) each span's enter and exit also record the
host's Unix ns (`time.time_ns()`, the clock torch.profiler's events
carry) and a CUDA event on the current stream, and `step_begin()` marks
the start of a train step (and the end of the one before) with an event
alone. Events come from a pool made at `trace_on` and are never waited
on in a step: the records are resolved at `snapshot`, or, where the pool
runs dry first, those of the steps whose events `cuEventQuery` finds
passed, which does not block. An anchor event, recorded on an idle card
beside a host time at `trace_on` (and again at each `snapshot`, for the
drift between the two clocks), puts every event on the host's clock.
`snapshot()`, called after a sync, gives over the steps closed since the
last snapshot per span the host ms and the stream ms (the time between
its two events on the card: busy plus idle), the step's stream ms, the
launch lead (how long the launched work waited in the queue) and the
caching allocator's device allocations. With the tracer off a span costs
one check of a module-level name: no CUDA call, no clock read.
"""
from __future__ import annotations

import atexit
import os
import statistics
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

timers = defaultdict(list)
device_timers = defaultdict(list)
_registered = False


def _register():
    global _registered
    if not _registered:
        _registered = True
        atexit.register(print_timing_info)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class Timer:
    def __init__(self, timer_name: str = ""):
        self.timer_name = timer_name

    def __enter__(self):
        _register()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *args):
        self.interval = (time.perf_counter() - self.start) * 1000.0
        timers[self.timer_name].append(self.interval)


class DeviceTimer:
    """Times device work up to `result`:

        with DeviceTimer('step') as t:
            out = step(...)
            t.result = out
    """

    def __init__(self, timer_name: str = ""):
        self.timer_name = timer_name
        self.result = None

    def __enter__(self):
        _register()
        self._start_event = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._start_event = torch.cuda.Event(enable_timing=True)
            self._start_event.record()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *args):
        on_card = any(t.is_cuda for t in _tensors(self.result))
        if on_card and self._start_event is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            ms = self._start_event.elapsed_time(end)
        else:
            if on_card:         # CUDA first initialized inside the block
                torch.cuda.synchronize()
            ms = (time.perf_counter() - self.start) * 1000.0
        device_timers[self.timer_name].append(ms)


@contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where there is a
    card); writes `<log_dir>/trace.json` (chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def print_timing_info():
    print("== Timing statistics ==")
    for name, vals in [*device_timers.items(), *timers.items()]:
        mean = float(np.mean(vals))
        if mean < 1000.0:
            print(f"{name}: {mean:.2f} ms ({len(vals)} samples)")
        else:
            print(f"{name}: {mean / 1000.0:.2f} s ({len(vals)} samples)")


# ---------------------------------------------------------------------------
# spans and the tracer
# ---------------------------------------------------------------------------

ENTER, EXIT, BEGIN = range(3)      # a record's kind
POOL_EVENTS = 2048  # events made at trace_on: 15 a train step
# the caching allocator's cudaMalloc calls and its retries after freeing
# its cache (each synchronizes the card)
ALLOC_COUNTERS = ("num_device_alloc", "num_alloc_retries")

_tracer: Optional["_Tracer"] = None


class span:
    """`with span("v2v.forward"):` the stage `name`: a `record_function`
    range, timed by the tracer when it is on."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = record_function(name)

    def __enter__(self):
        self._range.__enter__()
        if _tracer is not None:
            _tracer.mark(self.name, ENTER)
        return self

    def __exit__(self, *exc):
        # the range closes first: the exit's clock read and event then
        # lie as close to its end as the enter's to its start
        self._range.__exit__(*exc)
        if _tracer is not None:
            _tracer.mark(self.name, EXIT)
        return False


def step_begin() -> None:
    """A train step's begin mark (an event, not a range); it closes the
    step before it."""
    if _tracer is not None:
        _tracer.mark("step", BEGIN)


def trace_on(device) -> None:
    """Time the spans from here on, on `device` (a CUDA device, or the
    CPU, where the stream's time is the host's). Synchronizes once."""
    trace_off()
    global _tracer
    _tracer = _Tracer(torch.device(device))


def trace_off() -> None:
    """Stop recording; the records not yet snapshot are dropped."""
    global _tracer
    if _tracer is not None:
        _tracer, tracer = None, _tracer
        tracer.close()


def snapshot() -> Optional[Dict]:
    """The spans' numbers over the steps closed (by the next step's begin
    mark) since `trace_on` or the last snapshot; None with the tracer off.
    Call it after a sync. Keys: `steps`; `step_stream_ms` (the median
    step, begin mark to the next begin mark); `spans`, by name: `count`,
    and the median over the steps that hold it of the span's `host_ms`
    and `stream_ms` a step; `launch_lead_ms` (the median of each step's
    smallest lead); `device_allocs` (the caching allocator's cudaMalloc
    calls and retries a step since the last snapshot; None on the CPU);
    `tracer_us` (the median host us a step in the tracer's own calls)."""
    return None if _tracer is None else _tracer.snapshot()


def _allocs(device: torch.device) -> Optional[int]:
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return sum(stats.get(k, 0) for k in ALLOC_COUNTERS)


class _DriverEvents:
    """CUDA events through the driver API (libcuda, by ctypes), recorded
    on the stream PyTorch has current: a record is one foreign call, where
    torch.cuda.Event's wrapper also builds a Stream object."""

    def __init__(self, device: torch.device):
        import ctypes
        lib, vp = ctypes.CDLL("libcuda.so.1"), ctypes.c_void_p
        fns = []
        for name, args in (("cuEventCreate", [ctypes.POINTER(vp),
                                               ctypes.c_uint]),
                           ("cuEventRecord", [vp, vp]),
                           ("cuEventQuery", [vp]),
                           ("cuEventSynchronize", [vp]),
                           ("cuEventElapsedTime", [ctypes.POINTER(
                               ctypes.c_float), vp, vp]),
                           ("cuEventDestroy_v2", [vp])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
            fns.append(fn)
        (self._create, record, self._query, self._sync, self._elapsed,
         self._destroy) = fns
        self._vp, self._ms = vp, ctypes.c_float()
        self._ms_ref = ctypes.byref(self._ms)
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        stream = torch._C._cuda_getCurrentRawStream

        def record(ev, _record=record, _stream=stream, _i=index):
            err = _record(ev, _stream(_i))
            if err:
                raise RuntimeError(f"cuEventRecord: CUDA driver error {err}")
        self.record = record

    @staticmethod
    def _check(err: int, what: str) -> None:
        if err:
            raise RuntimeError(f"{what}: CUDA driver error {err}")

    def new(self) -> int:
        ev = self._vp()
        self._check(self._create(ev, 0), "cuEventCreate")
        return ev.value

    def done(self, ev: int) -> bool:
        err = self._query(ev)
        if err == 600:                  # CUDA_ERROR_NOT_READY
            return False
        self._check(err, "cuEventQuery")
        return True

    def wait(self, ev: int) -> None:
        self._check(self._sync(ev), "cuEventSynchronize")

    def ms(self, a: int, b: int) -> float:
        """Milliseconds from event a to event b, both passed."""
        self._check(self._elapsed(self._ms_ref, a, b), "cuEventElapsedTime")
        return self._ms.value

    def destroy(self, evs) -> None:
        for ev in evs:
            self._destroy(ev)


class _Tracer:
    def __init__(self, device: torch.device):
        self.device = device
        self.ev = _DriverEvents(device) if device.type == "cuda" else None
        self.pool: List[int] = []
        self.group: List[tuple] = []    # the open step's records
        self.closed: deque = deque()    # (records, next begin, cost ns)
        self.resolved: List[tuple] = []   # (records, close dev ns, cost)
        self.cost_ns = 0
        self.allocs = _allocs(device)
        # the anchor first: its sync makes the card's context current
        self.anchor, self.anchor_ns = self._anchor()
        if self.ev is not None:
            self.pool = [self.ev.new() for _ in range(POOL_EVENTS)]

    def _anchor(self):
        """(event, its host ns): recorded on an idle card, so that it
        runs as the host records it."""
        if self.ev is None:
            return None, time.time_ns()
        with torch.cuda.device(self.device):
            torch.cuda.synchronize()
            ev = self.ev.new()
            self.ev.record(ev)
            t = time.time_ns()
            torch.cuda.synchronize()
        return ev, t

    def mark(self, name: str, kind: int) -> None:
        t = time.time_ns()
        ev = None
        if self.ev is not None:
            ev = self.pool.pop() if self.pool else self._refill()
            self.ev.record(ev)
        rec = (name, kind, t, ev)
        if kind == BEGIN:
            if self.group and self.group[0][1] == BEGIN:
                self.closed.append((self.group, rec, self.cost_ns))
            else:               # records before the first step
                self._release(self.group)
            self.group, self.cost_ns = [rec], 0
        else:
            self.group.append(rec)
        self.cost_ns += time.time_ns() - t

    def _refill(self) -> int:
        """An event once the pool is empty: one of the steps the card has
        passed, else a new one."""
        self._drain(wait=False)
        return self.pool.pop() if self.pool else self.ev.new()

    def _release(self, recs) -> None:
        self.pool.extend(r[3] for r in recs if r[3] is not None)

    def _drain(self, wait: bool) -> None:
        """Resolve the closed steps whose events the card has passed, and
        take their events back; folding waits for the snapshot."""
        while self.closed:
            recs, nxt, cost = self.closed[0]
            if nxt[3] is not None and not self.ev.done(nxt[3]):
                if not wait:
                    return
                self.ev.wait(nxt[3])
            self.closed.popleft()
            resolved = self._resolve(recs + [nxt])
            self.resolved.append((resolved[:-1], resolved[-1][3], cost))
            self._release(recs)

    def _resolve(self, recs) -> List[tuple]:
        """(name, kind, host ns, device ns) of each record; device ns on
        the host's clock as the anchor sets it."""
        if self.ev is None:
            return [(n, k, t, t) for n, k, t, _ in recs]
        first, ms = recs[0][3], self.ev.ms
        base = self.anchor_ns + round(ms(self.anchor, first) * 1e6)
        return [(n, k, t, base + (round(ms(first, ev) * 1e6) if i else 0))
                for i, (n, k, t, ev) in enumerate(recs)]

    def snapshot(self) -> Dict:
        scale = 1.0
        if self.ev is not None:
            end, end_ns = self._anchor()
            dev_ns = self.ev.ms(self.anchor, end) * 1e6
            self.ev.destroy([end])
            if dev_ns > 0:
                scale = (end_ns - self.anchor_ns) / dev_ns
        self._drain(wait=True)
        steps = [fold_step(*r) for r in self.resolved]
        self.resolved.clear()
        allocs, self.allocs = self.allocs, _allocs(self.device)
        if allocs is not None:
            allocs = (self.allocs - allocs) / max(len(steps), 1)
        return summarize(steps, allocs, scale, self.anchor_ns)

    def close(self) -> None:
        """Give the events back to the driver."""
        if self.ev is not None:
            self.ev.destroy(self.pool + [self.anchor] + [
                r[3] for recs in [self.group] + [c[0] for c in self.closed]
                for r in recs])


def fold_step(recs, close_dev: float, cost_ns: int = 0) -> Dict:
    """One step's numbers from its records [(name, kind, host ns, device
    ns)], its begin mark first, and the device ns of the next step's begin
    mark, which closed it."""
    begin = recs[0][3]
    spans: Dict[str, List[float]] = {}
    open_: List[tuple] = []
    lead = (float("inf"), 0.0)      # (device less host ns, device ns)
    for name, kind, host, dev in recs:
        if dev - host < lead[0]:
            lead = (dev - host, dev)
        if kind == ENTER:
            open_.append((name, host, dev))
        elif kind == EXIT:
            i = next((i for i in range(len(open_) - 1, -1, -1)
                      if open_[i][0] == name), None)
            if i is None:
                continue
            _, h0, d0 = open_.pop(i)
            c = spans.setdefault(name, [0, 0.0, 0.0])
            c[0] += 1
            c[1] += (host - h0) / 1e6
            c[2] += (dev - d0) / 1e6
    return {"stream_ms": (close_dev - begin) / 1e6, "spans": spans,
            "lead": lead, "cost_ns": cost_ns}


def summarize(steps: List[Dict], device_allocs: Optional[float],
              scale: float, anchor_ns: int) -> Dict:
    """A snapshot from folded steps (see `snapshot`). `scale` is the
    host's ns a device ns, from the two anchors: a lead is corrected by
    the drift since the anchor at `anchor_ns`."""
    def med(xs):
        xs = list(xs)
        return statistics.median(xs) if xs else None

    names = sorted({k for s in steps for k in s["spans"]})
    spans = {k: {"count": sum(s["spans"][k][0] for s in steps
                              if k in s["spans"]),
                 "host_ms": med(s["spans"][k][1] for s in steps
                                if k in s["spans"]),
                 "stream_ms": med(s["spans"][k][2] for s in steps
                                  if k in s["spans"])} for k in names}
    leads = [(s["lead"][0] + (s["lead"][1] - anchor_ns) * (scale - 1)) / 1e6
             for s in steps]
    return {"steps": len(steps),
            "step_stream_ms": med(s["stream_ms"] for s in steps),
            "spans": spans, "launch_lead_ms": med(leads),
            "device_allocs": device_allocs,
            "tracer_us": med(s["cost_ns"] / 1e3 for s in steps)}
