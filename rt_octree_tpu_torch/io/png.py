"""8-bit PNG reading and writing on zlib and numpy.

Takes the place of imageio for the port: ``-o`` frame output and the GT
PNGs of the quality kits.  The writer emits RGB or RGBA rows with filter 0
at zlib level 1 (the reference writer disables compression for speed,
imwrite.cpp:14-86); the reader takes non-interlaced 8-bit grey, grey+alpha,
RGB and RGBA with any of the five row filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float [0, 1] -> uint8 by x255 truncation (main_headless.cpp:536-538;
    rt_octree_tpu/io/images.py:to_uint8)."""
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data +
            struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H, W, 3 or 4] float in [0, 1] or uint8."""
    if img.dtype != np.uint8:
        img = to_uint8(img)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"write_png: need [H, W, 3|4], got {img.shape}")
    h, w, c = img.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr) +
                _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) +
                _chunk(b"IEND", b""))


def _unfilter_row(ftype: int, row: bytearray, prior: bytearray,
                  bpp: int) -> None:
    n = len(row)
    if ftype == 0:
        return
    if ftype == 1:  # Sub: a running sum per channel along the row
        acc = np.frombuffer(bytes(row), np.uint8).reshape(-1, bpp).astype(
            np.int64).cumsum(axis=0) & 0xFF
        row[:] = acc.astype(np.uint8).tobytes()
    elif ftype == 2:  # Up
        up = (np.frombuffer(bytes(row), np.uint8).astype(np.int64) +
              np.frombuffer(bytes(prior), np.uint8)) & 0xFF
        row[:] = up.astype(np.uint8).tobytes()
    elif ftype == 3:
        for i in range(n):
            left = row[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + ((left + prior[i]) >> 1)) & 0xFF
    elif ftype == 4:
        for i in range(n):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            row[i] = (row[i] + pred) & 0xFF
    else:
        raise ValueError(f"PNG: bad row filter {ftype}")


def read_png(path: str) -> np.ndarray:
    """-> uint8 [H, W, C] (C = 1, 2, 3 or 4 as stored)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only non-interlaced 8-bit grey/RGB(A) "
                         f"PNGs are supported (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    stride = w * c
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: image data has the wrong size")
    out = bytearray(h * stride)
    prior = bytearray(stride)
    for y in range(h):
        start = y * (stride + 1)
        row = bytearray(raw[start + 1:start + 1 + stride])
        _unfilter_row(raw[start], row, prior, c)
        out[y * stride:(y + 1) * stride] = row
        prior = row
    return np.frombuffer(bytes(out), np.uint8).reshape(h, w, c)
