"""Profiling timers (port of v2v_tpu/utils/timers.py; reference
utils/timers.py).

`Timer` measures host wall time. `DeviceTimer` measures device work: when
the result it is handed lies on the card it times between two CUDA events
on the current stream and waits for the second; on the CPU, where work
is done when the call returns, it reads the host clock. Both append
milliseconds to module-level dicts, and `print_timing_info` summarizes
them at exit (registered once a timer has been used). `profile_trace`
writes a torch.profiler Chrome trace into a log dir.
"""
from __future__ import annotations

import atexit
import os
import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch

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
