"""Build and load the port's CUDA sources (v2v_tpu_torch/csrc).

Each source is compiled by nvcc for sm_90a into its own plain-C shared
library under build/v2v_tpu_torch/ (override with $V2V_TORCH_BUILD_DIR),
named by the hash of its source, its headers and its flags, and loaded
with ctypes at first use. Two sources build and cache independently, so
they can be built side by side.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC")


def build_dir() -> Path:
    env = os.environ.get("V2V_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "v2v_tpu_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA toolkit needed to build the "
                       "v2v_tpu_torch kernels)")


class CudaLibrary:
    """One csrc source, its headers and its nvcc flags; `bind(lib)` sets
    the ctypes signatures of the loaded library."""

    def __init__(self, source: str, headers: Sequence[str] = (),
                 extra_flags: Sequence[str] = (),
                 bind: Callable[[ctypes.CDLL], None] = lambda lib: None):
        self.source = source
        self.headers = tuple(headers)
        self.flags = COMMON_FLAGS + tuple(extra_flags)
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> dict:
        """Compile into a library named by the hash of the sources and
        flags; an existing library of that name is reused. ptxas's report
        (registers, spills) is kept beside the library as its .log, so a
        reused library gives it too. Returns {'path', 'seconds', 'log',
        'cached'}."""
        h = hashlib.sha256(" ".join(self.flags).encode())
        for name in (self.source,) + self.headers:
            h.update((CSRC / name).read_bytes())
        stem = Path(self.source).stem
        out = build_dir() / f"lib{stem}_{h.hexdigest()[:16]}.so"
        report = out.with_suffix(".log")
        if out.exists():
            log = report.read_text() if report.exists() else ""
            return {"path": out, "seconds": 0.0, "log": log, "cached": True}
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *self.flags, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        log = (proc.stdout + proc.stderr).strip()
        # the report first: whoever finds the library finds its report
        report_tmp = tmp.with_suffix(".log.tmp")
        report_tmp.write_text(log)
        os.replace(report_tmp, report)
        os.replace(tmp, out)
        return {"path": out, "seconds": seconds, "log": log, "cached": False}

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()["path"]))
                self._bind(lib)
                self._lib = lib
        return self._lib


def stream() -> int:
    """The handle of PyTorch's current CUDA stream, where kernels launch."""
    import torch
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
