"""Encoder and decoder for the msgpack subset that
``flax.serialization.to_bytes`` writes, so that ``.gnet`` artifacts load and
save without msgpack or flax.

Flax writes a nested map of str keys whose leaves are arrays, each as
msgpack ExtType 1 wrapping a packed ``(shape, dtype_name, bytes)`` tuple
(flax/serialization.py: _ndarray_to_bytes / _msgpack_ext_pack).  The
decoder covers every msgpack type except timestamps; extension types other
than the ndarray one raise.  The encoder takes maps, lists and tuples,
str, bytes, int, float, bool, None and ndarrays, and picks the smallest
encoding of each as msgpack-python does (floats as float64), so that
``packb(unpackb(blob)) == blob`` for what flax wrote.
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


def _pack_len(out: list, n: int, fix: tuple, wide: tuple) -> None:
    """A length header: the fix form (base byte, limit) below its limit,
    else the first of the (type byte, struct format, limit) forms that
    holds ``n``."""
    base, limit = fix
    if n < limit:
        out.append(bytes((base | n,)))
        return
    for byte, fmt, lim in wide:
        if n <= lim:
            out.append(bytes((byte,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


_STR = ((0xA0, 32), ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                     (0xDB, ">I", 0xFFFFFFFF)))
_BIN = ((0, 0), ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                 (0xC6, ">I", 0xFFFFFFFF)))
_ARRAY = ((0x90, 16), ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF)))
_MAP = ((0x80, 16), ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF)))


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF),
             (0xCE, ">I", 0, 0xFFFFFFFF), (0xCF, ">Q", 0, 2 ** 64 - 1)) \
        if v >= 0 else \
        ((0xD0, ">b", -0x80, 0), (0xD1, ">h", -0x8000, 0),
         (0xD2, ">i", -2 ** 31, 0), (0xD3, ">q", -2 ** 63, 0))
    for byte, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(bytes((byte,)) + struct.pack(fmt, v))
            return
    raise ValueError(f"msgpack: integer {v} out of range")


def _pack_ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(bytes((fixext[n],)))
    elif n <= 0xFF:
        out.append(b"\xc7" + struct.pack(">B", n))
    elif n <= 0xFFFF:
        out.append(b"\xc8" + struct.pack(">H", n))
    else:
        out.append(b"\xc9" + struct.pack(">I", n))
    out.append(struct.pack(">b", code) + data)


def _write(out: list, obj) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), *_STR)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(out, len(raw), *_BIN)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), *_ARRAY)
        for v in obj:
            _write(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), *_MAP)
        for k, v in obj.items():
            _write(out, k)
            _write(out, v)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.dtype.isalignedstruct:
            raise ValueError("msgpack: object and structured arrays are "
                             "not supported")
        _pack_ext(out, _EXT_NDARRAY, packb(
            ([int(d) for d in obj.shape], obj.dtype.name,
             obj.tobytes("C"))))
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode one object; ndarrays become flax's ExtType 1."""
    out: list = []
    _write(out, obj)
    return b"".join(out)


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
