"""K4's gradient tilings, timed on the card: csrc/dynconv_bwd.cu at the
train shape, z (12,32,32,6,128) bfloat16, atoms float32 and the
cotangent as the model's NCHW view, under each tiling in TILINGS: each
kernel's atoms a block (the wrapper's `_bwd_tiling` picks one; the tile
rows are fixed, dz 8 and datoms 4). Each is held against the plain backward
(datoms and dz within 1e-4, dz plus 2^-8 of |ref| for its bfloat16
rounding), with equal bits over two calls, and timed back to back (20
calls between two CUDA events), in turns: each tiling once, then again in
reverse order; beside that, each kernel's device time from torch.profiler
over 20 calls. Then the picked tiling a call (CUDA events around each
call, median of 20), where the host's work shows, and the host's own
time a call over 100 calls enqueued without a wait.

    python -m v2v_tpu_torch.scripts.k4_backward_designs
"""
from __future__ import annotations

import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from v2v_tpu_torch.ops import dynconv as dc

SHAPE = (12, 32, 32, 6, 128)
# (dz atoms a block, datoms atoms a block): each kernel's options, the
# other kernel at all 6
TILINGS = ((1, 6), (3, 6), (6, 6), (6, 1), (6, 3))
ATOL = 1e-4                                     # chip_smoke.py's K4_ATOL


def back_to_back_ms(fn, reps: int = 20) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def a_call_ms(fn, reps: int = 20) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, reps: int = 20) -> dict:
    """Device milliseconds a call of each kernel that fn launches."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", 0) or 0
            name = "dz" if "dz_kernel" in e.key else "datoms" \
                if "datoms_kernel" in e.key else e.key[:40]
            out[name] = us / 1e3 / reps
    return out


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, w, m, co = SHAPE
    z = torch.randn(SHAPE, generator=gen, device=dev).to(torch.bfloat16)
    atoms = torch.randn(SHAPE[:4] + (25,), generator=gen, device=dev)
    g = torch.randn((b, co, h, w), generator=gen,
                    device=dev).permute(0, 2, 3, 1)
    want_dz, want_da = dc.dynamic_shift_sum_backward_plain(z.float(), atoms,
                                                           g, 5)
    sms = dc._sm_count(dev.index)
    print(f"dz {dc.DZ_ROWS}-row, datoms {dc.DATOMS_ROWS}-row tiles: blocks "
          f"an SM (dz, datoms) {dc._bwd_blocks_per_sm(True)}; shared bytes "
          f"{dc._bwd_smem_bytes(2)}; {sms} SMs", flush=True)
    times = {t: [] for t in TILINGS}
    split = {}
    for order in (TILINGS, TILINGS[::-1]):
        for tiling in order:
            fn = lambda: dc._shift_sum_bwd_kernel(z, atoms, g, 5, tiling)
            dz, da = fn()
            dz2, da2 = fn()
            dz_err = float(((dz.float() - want_dz).abs()
                            - 2 ** -8 * want_dz.abs()).max())
            da_err = float((da - want_da).abs().max())
            if max(dz_err, da_err) > ATOL or not (
                    torch.equal(dz, dz2) and torch.equal(da, da2)):
                raise RuntimeError(f"{tiling}: dz excess {dz_err:.3e}, "
                                   f"datoms {da_err:.3e} (tolerance {ATOL}) "
                                   f"or two calls differ")
            times[tiling].append(back_to_back_ms(fn))
            split.setdefault(tiling, kernel_ms(fn))
    picked = dc._bwd_tiling(b, h, w, m, co, sms)
    for tiling, ms in times.items():
        blocks = dc._bwd_blocks(b, h, w, m, co, tiling)
        print(f"atoms a block: dz {tiling[0]}, datoms {tiling[1]}; "
              f"blocks {blocks}{' (picked)' if tiling == picked else ''}: "
              f"{' '.join(f'{t:.4f}' for t in ms)} ms back to back; "
              + ", ".join(f"{k} {v:.4f}" for k, v in split[tiling].items())
              + " ms (profiler)", flush=True)
    call = lambda: dc.dynamic_shift_sum_backward(z, atoms, g, 5)
    ms = a_call_ms(call)
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        call()
    host_ms = (time.perf_counter() - t0) * 10
    torch.cuda.synchronize()
    print(f"picked, a call: {ms:.4f} ms (CUDA events around each call); "
          f"the host's time a call, 100 calls enqueued: {host_ms:.4f} ms",
          flush=True)


if __name__ == "__main__":
    main()
