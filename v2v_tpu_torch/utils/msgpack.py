"""A pure-Python reader of the msgpack files flax writes (the JAX
package's `.msgpack` checkpoints, v2v_tpu/training/checkpoint.py), so
the port reads them without the msgpack package.

It decodes every msgpack type: maps, arrays, str, bin, nil, bool, ints,
floats and ext. flax's ext types: code 1, an ndarray, whose payload is
itself msgpack `(shape, dtype name, row-major bytes)`; code 2, a complex
`(real, imag)`; code 3, a numpy scalar, packed as a 0-d ndarray. An
ndarray comes back as a read-only numpy array over its bytes (as flax
gives it), a bfloat16 one (numpy has no such dtype) as a torch.bfloat16
tensor of the same bits. Arrays larger than flax's chunk limit come back whole
(flax.serialization._unchunk).
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"

# fixed-size types: byte -> (struct format, size)
_SCALARS = {
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
# types with a length prefix: byte -> (kind, length format, its size)
_SIZED = {
    0xc4: ("bin", ">B", 1), 0xc5: ("bin", ">H", 2), 0xc6: ("bin", ">I", 4),
    0xd9: ("str", ">B", 1), 0xda: ("str", ">H", 2), 0xdb: ("str", ">I", 4),
    0xdc: ("array", ">H", 2), 0xdd: ("array", ">I", 4),
    0xde: ("map", ">H", 2), 0xdf: ("map", ">I", 4),
    0xc7: ("ext", ">B", 1), 0xc8: ("ext", ">H", 2), 0xc9: ("ext", ">I", 4),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self.unpack(*_SCALARS[b])
        if b in _FIXEXT:
            code = self.unpack(">b", 1)
            return _ext(code, self.take(_FIXEXT[b]))
        if b in _SIZED:
            kind, fmt, size = _SIZED[b]
            n = self.unpack(fmt, size)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            code = self.unpack(">b", 1)
            return _ext(code, self.take(n))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes) -> Any:
    """One msgpack object, flax's ext types decoded."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the "
                         f"object")
    return out


def _ndarray(payload) -> Any:
    shape, dtype, buf = unpackb(bytes(payload))
    shape = tuple(shape)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        if not buf:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16
                                ).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _ext(code: int, payload) -> Any:
    if code == 1:
        return _ndarray(payload)
    if code == 2:
        real, imag = unpackb(bytes(payload))
        return complex(real, imag)
    if code == 3:
        arr = _ndarray(payload)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"msgpack: ext type {code} is not one flax writes")


def _indexed(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        flat = np.concatenate(_indexed(tree["chunks"]))
        return flat.reshape(_indexed(tree["shape"]))
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data: bytes) -> Any:
    """flax.serialization.msgpack_restore: the tree, arrays whole."""
    return _unchunk(unpackb(data))
