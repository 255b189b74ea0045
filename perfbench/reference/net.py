"""The compact GuidanceNet of a ``.gnet`` file, in float32.

A ``.gnet`` is ``GNET0001``, a little-endian u32 header length, a JSON
header, then flax's msgpack of {block_i: {kernel [3, 3, cin, cout],
bias [cout]}} (arrays as msgpack ext type 1 over (shape, dtype, bytes)).
Each block is a 3x3 convolution, zero padded, plus bias, then relu6
(denoiser/network.py).  The net reads the [H, W, 8] aux and returns its
last activation [1, 2L, H, W]: L level-weight logits, then L guidance
values.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch
import torch.nn.functional as F

MAGIC = b"GNET0001"


class _Reader:
    def __init__(self, buf: bytes):
        self.buf, self.pos = memoryview(buf), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated")
        out = self.buf[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _read(r: _Reader):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return {_read(r): _read(r) for _ in range(b & 0x0F)}
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return r.take(b & 0x1F).decode()
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in nums:
        return r.num(nums[b])
    lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
            0xDB: ">I"}
    if b in lens:
        raw = r.take(r.num(lens[b]))
        return raw if b <= 0xC6 else raw.decode()
    if b in (0xDC, 0xDD):
        return [_read(r) for _ in range(r.num(">H" if b == 0xDC else ">I"))]
    if b in (0xDE, 0xDF):
        n = r.num(">H" if b == 0xDE else ">I")
        return {_read(r): _read(r) for _ in range(n)}
    ext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in ext:
        n = ext[b]
    elif b in (0xC7, 0xC8, 0xC9):
        n = r.num({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
    else:
        raise ValueError(f"msgpack: type byte 0x{b:02x}")
    if r.num(">b") != 1:
        raise ValueError("msgpack: not an ndarray extension")
    inner = _Reader(r.take(n))
    shape, dtype, raw = _read(inner)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def read_gnet(path: str):
    """(header dict, [(kernel OIHW f32, bias f32)] per block)."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path}: not a .gnet file")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode())
        blob = f.read()
    r = _Reader(blob)
    params = _read(r)
    blocks = []
    for i in range(header["num_layers"]):
        p = params[f"block_{i}"]
        k = torch.from_numpy(np.ascontiguousarray(
            np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)))
        blocks.append((k, torch.from_numpy(np.asarray(p["bias"],
                                                      np.float32).copy())))
    return header, blocks


def supports(header: dict) -> tuple:
    """The filter's window half-widths of the net's L levels."""
    L = header["kernel_levels"]
    return tuple(range(L)) if header.get("identity_level") else \
        tuple(range(1, L + 1))


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float8_e4m3fn).to(torch.float32)


def forward(aux_nhwc: torch.Tensor, blocks, low: bool = False):
    """aux [H, W, 8] f32 -> the last activation [1, 2L, H, W] f32, TF32
    off.  ``low``: each block's input and kernel rounded to float8 e4m3
    (the products of an fp8 tensor core, summed in f32)."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = aux_nhwc.permute(2, 0, 1)[None].contiguous()
        for k, b in blocks:
            k, b = k.to(x.device), b.to(x.device)
            if low:
                x, k = _fp8(x), _fp8(k)
            x = F.relu6(F.conv2d(x, k, padding=1) + b[None, :, None, None])
        return x
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
