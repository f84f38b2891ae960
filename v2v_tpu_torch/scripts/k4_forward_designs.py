"""K4's forward tiling, timed on the card: csrc/dynconv.cu at the 720p
eval shape (1,180,320,6,128) float32 and the train shape
(12,32,32,6,128) bfloat16, with tiles of 2 to 8 rows (the wrapper's
`_tile_rows` picks 8 or 4). Each is held against the plain version, with
equal bits over two calls, and timed back to back (20 calls between two
CUDA events), in turns: each tiling once, then again in reverse order.

    python -m v2v_tpu_torch.scripts.k4_forward_designs
"""
from __future__ import annotations

import subprocess

import torch

from v2v_tpu_torch.ops import dynconv as dc

SHAPES = (((1, 180, 320, 6, 128), torch.float32),
          ((12, 32, 32, 6, 128), torch.bfloat16))
ROWS = (8, 7, 6, 5, 4, 3, 2)                    # tile rows
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


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, dtype in SHAPES:
        z = torch.randn(shape, generator=gen, device=dev).to(dtype)
        atoms = torch.randn(shape[:4] + (25,), generator=gen, device=dev)
        want = dc.dynamic_shift_sum_plain(z, atoms, 5)
        times = {rows: [] for rows in ROWS}
        for order in (ROWS, ROWS[::-1]):
            for rows in order:
                fn = lambda: dc._shift_sum_kernel(z, atoms, 5, rows)
                got = fn()
                err = float((got - want).abs().max())
                if err > ATOL or not torch.equal(got, fn()):
                    raise RuntimeError(f"{shape} {rows}-row tiles: max|diff| "
                                       f"{err:.3e} (tolerance {ATOL}) or two "
                                       f"calls differ")
                times[rows].append(back_to_back_ms(fn))
        b, h, w, _, co = shape
        picked = dc._tile_rows(b, h, w, co, dc._sm_count(dev.index))
        for rows, ms in times.items():
            print(f"z {shape} {str(dtype)[6:]}: {rows}-row tiles"
                  f"{' (picked)' if rows == picked else ''}: "
                  f"{' '.join(f'{t:.4f}' for t in ms)} ms back to back",
                  flush=True)

if __name__ == "__main__":
    main()
