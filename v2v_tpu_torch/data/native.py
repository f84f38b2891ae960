"""The C++ voxel builder of the h5 eval path (port of
v2v_tpu/data/native.py; source v2v_tpu_torch/csrc/voxel_builder.cpp).

`events_to_voxel_native` gives the voxels of ops/voxel.py::
events_to_voxel_np (data/testh5.py:60-90): the same bits for discrete
bins, within 1e-9 for temporal-bilinear ones. g++ builds the source at
first use into the port's build directory (ops/_build.py::build_dir),
under a name hashed from the compiler, its flags and the source, and
ctypes loads it. A build that fails raises and names its command: there
is no fallback to numpy. Only `use_native_voxel_builder: false` in a
data config selects numpy (data/h5.py).

Processes that build at once each write a file of their own and move it
into place with os.replace, so a process loads only a whole library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..ops._build import CSRC, build_dir

FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def _bind(lib: ctypes.CDLL) -> None:
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    up = ctypes.POINTER(ctypes.c_uint8)
    for name in ("build_voxel_discrete", "build_voxel_bilinear"):
        fn = getattr(lib, name)
        fn.argtypes = [dp, ip, ip, up, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, dp]
        fn.restype = None


class HostLibrary:
    """One csrc source built by a host compiler (`cxx`) with FLAGS into a
    shared library."""

    def __init__(self, source: str, cxx: str = "g++"):
        self.source = CSRC / source
        self.cxx = cxx
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        h = hashlib.sha256(" ".join((self.cxx,) + FLAGS).encode())
        h.update(self.source.read_bytes())
        return build_dir() / f"lib{self.source.stem}_{h.hexdigest()[:16]}.so"

    def build(self) -> dict:
        """Compile unless the library exists. Returns {'path', 'seconds',
        'cached'}."""
        out = self.path()
        if out.exists():
            return {"path": out, "seconds": 0.0, "cached": True}
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [self.cxx, *FLAGS, str(self.source), "-o", str(tmp)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"the voxel builder did not build: "
                               f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"the voxel builder did not build "
                               f"({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
        return {"path": out, "seconds": time.perf_counter() - t0,
                "cached": False}

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()["path"]))
                _bind(lib)
                self._lib = lib
        return self._lib


LIB = HostLibrary("voxel_builder.cpp")


def native_available() -> bool:
    """Whether the builder builds and loads here."""
    try:
        LIB.get()
    except (RuntimeError, OSError):
        return False
    return True


def events_to_voxel_native(ts: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                           ps: np.ndarray, *, num_bins: int, height: int,
                           width: int,
                           interpolate_bins: bool = False) -> np.ndarray:
    """(num_bins, H, W) float64 voxels of one window: float64 second
    timestamps, pixel coordinates, polarities in {0, 1}. Raises
    IndexError on a coordinate outside the frame, as np.add.at does."""
    lib = LIB.get()
    n = len(ts)
    out = np.zeros((num_bins, height, width), np.float64)
    if n == 0:
        return out
    ts64 = np.ascontiguousarray(ts, np.float64)
    xs32 = np.ascontiguousarray(xs, np.int32)
    ys32 = np.ascontiguousarray(ys, np.int32)
    ps8 = np.ascontiguousarray(ps, np.uint8)
    # the C loop writes out[y*w+x] unchecked
    if (xs32.min() < 0 or xs32.max() >= width
            or ys32.min() < 0 or ys32.max() >= height):
        raise IndexError(
            f"event coordinates out of bounds for {height}x{width}: "
            f"x in [{xs32.min()}, {xs32.max()}], "
            f"y in [{ys32.min()}, {ys32.max()}]")
    fn = (lib.build_voxel_bilinear if interpolate_bins
          else lib.build_voxel_discrete)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    up = ctypes.POINTER(ctypes.c_uint8)
    fn(ts64.ctypes.data_as(dp), xs32.ctypes.data_as(ip),
       ys32.ctypes.data_as(ip), ps8.ctypes.data_as(up), ctypes.c_int64(n),
       num_bins, height, width, out.ctypes.data_as(dp))
    return out
