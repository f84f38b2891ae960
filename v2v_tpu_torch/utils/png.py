"""8-bit PNG files written with zlib and struct alone, for the tools that
write images on a machine without cv2 (the port's counterpart of the JAX
package's scripts' `cv2.imwrite`).

`write_png(path, array)` takes a uint8 (H, W) or (H, W, 1) grayscale
image, or an (H, W, 3) one in BGR order, the order `cv2.imwrite` takes,
so a file it writes reads back through `cv2.imread` as the same array.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, array: np.ndarray) -> None:
    a = np.asarray(array)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        color_type = 0                              # grayscale
    elif a.ndim == 3 and a.shape[2] == 3:
        a = a[..., ::-1]                            # BGR -> PNG's RGB
        color_type = 2
    else:
        raise ValueError(f"write_png takes (H, W), (H, W, 1) or (H, W, 3) "
                         f"images, got {a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a).reshape(h, -1)
    # filter type 0 (none) at the head of each scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))
