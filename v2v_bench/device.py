"""The card, as the traffic kinds use it: synchronize, the memory peak, and
the profiler around a traced stretch. On the CPU (the tests) the first
two do nothing and read 0."""
from __future__ import annotations

import time

import torch


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def free(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def start_profile(dev: torch.device):
    """(profiler, start) of a traced stretch, the device idle first.

    On the host the profiler records the user-scope ranges alone (the
    `record_function` spans of the program and of the benchmark), not
    every PyTorch op, whose records would slow the host that dispatches
    the steps further. CUPTI still records every runtime and driver
    call, kernel, copy and fill, which is what the spans' device times
    and the busy time are read from; those records cost the host time
    at every launch too, so a traced stretch runs slower than the
    window when the host paces it."""
    import torch.autograd.profiler as autograd_profiler
    from torch._C._profiler import RecordScope
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    enable = autograd_profiler._enable_profiler

    def user_scope_only(config, activities, scopes=None):
        return enable(config, activities, {RecordScope.USER_SCOPE})

    autograd_profiler._enable_profiler = user_scope_only
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    finally:
        autograd_profiler._enable_profiler = enable
    return prof, time.perf_counter()


def stop_profile(prof, start: float, dev: torch.device) -> float:
    """Ends the stretch once the device is idle; its seconds."""
    sync(dev)
    seconds = time.perf_counter() - start
    prof.__exit__(None, None, None)
    return seconds
