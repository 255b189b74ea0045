"""Decoder for the msgpack subset that ``flax.serialization.to_bytes``
writes, so that ``.gnet`` artifacts load without msgpack or flax.

Flax writes a nested map of str keys whose leaves are arrays, each as
msgpack ExtType 1 wrapping a packed ``(shape, dtype_name, bytes)`` tuple
(flax/serialization.py: _ndarray_to_bytes / _msgpack_ext_pack).  The
decoder covers every msgpack type except timestamps; extension types other
than the ndarray one raise.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode_ext(code: int, data: bytes):
    if code != _EXT_NDARRAY:
        raise ValueError(f"msgpack: unsupported ext type {code}")
    shape, dtype_name, raw = unpackb(data)
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(
        tuple(shape)).copy()


def _read(r: _Reader):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _read_array(r, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        return r.take(b & 0x1F).decode("utf-8")
    fixed = {
        0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
        0xC4: lambda: r.take(r.unpack(">B")),
        0xC5: lambda: r.take(r.unpack(">H")),
        0xC6: lambda: r.take(r.unpack(">I")),
        0xCA: lambda: r.unpack(">f"), 0xCB: lambda: r.unpack(">d"),
        0xCC: lambda: r.unpack(">B"), 0xCD: lambda: r.unpack(">H"),
        0xCE: lambda: r.unpack(">I"), 0xCF: lambda: r.unpack(">Q"),
        0xD0: lambda: r.unpack(">b"), 0xD1: lambda: r.unpack(">h"),
        0xD2: lambda: r.unpack(">i"), 0xD3: lambda: r.unpack(">q"),
        0xD9: lambda: r.take(r.unpack(">B")).decode("utf-8"),
        0xDA: lambda: r.take(r.unpack(">H")).decode("utf-8"),
        0xDB: lambda: r.take(r.unpack(">I")).decode("utf-8"),
        0xDC: lambda: _read_array(r, r.unpack(">H")),
        0xDD: lambda: _read_array(r, r.unpack(">I")),
        0xDE: lambda: _read_map(r, r.unpack(">H")),
        0xDF: lambda: _read_map(r, r.unpack(">I")),
    }
    if b in fixed:
        return fixed[b]()
    ext_len = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in ext_len:
        n = ext_len[b]
    elif b == 0xC7:
        n = r.unpack(">B")
    elif b == 0xC8:
        n = r.unpack(">H")
    elif b == 0xC9:
        n = r.unpack(">I")
    else:
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")
    code = r.unpack(">b")
    return _decode_ext(code, r.take(n))


def _read_array(r: _Reader, n: int) -> list:
    return [_read(r) for _ in range(n)]


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def unpackb(buf: bytes):
    """Decode one msgpack object; arrays come back as numpy ndarrays."""
    r = _Reader(buf)
    out = _read(r)
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes")
    return out
