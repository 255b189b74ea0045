"""PCG32 in PyTorch, bit-exact with rt_octree_tpu.utils.rng.

``Pcg32`` is the host generator in exact Python ints (seeding, the per-frame
2^32 advance, oracles).  ``pcg32_uniforms_range`` is the tensor twin of the
JAX function of the same name: the uniforms at stream positions 0..n-1,
which the render kernel computes per pixel with ``advance(idx * spp)``.

The twin keeps every 64-bit quantity as two 32-bit halves, each held in an
int64 tensor and masked after every operation; no product ever exceeds
2^49, so nothing relies on int64 overflow.
"""

from __future__ import annotations

import struct

import torch

PCG32_DEFAULT_STATE = 0x853C49E6748FEA9B
PCG32_DEFAULT_STREAM = 0xDA3E39CB94B95BDB
PCG32_MULT = 0x5851F42D4C957F2D
RENDER_CONTEXT_SEED = 20230418

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1
_M16 = 0xFFFF


class Pcg32:
    """Host-side exact PCG32-XSH-RR (renderer/3rdparty/pcg32.h)."""

    def __init__(self, initstate: int | None = None, initseq: int = 1):
        if initstate is None:
            self.state = PCG32_DEFAULT_STATE
            self.inc = PCG32_DEFAULT_STREAM
        else:
            self.seed(initstate, initseq)

    def seed(self, initstate: int, initseq: int = 1) -> None:
        self.state = 0
        self.inc = ((initseq << 1) | 1) & _M64
        self.next_uint()
        self.state = (self.state + initstate) & _M64
        self.next_uint()

    def next_uint(self) -> int:
        oldstate = self.state
        self.state = (oldstate * PCG32_MULT + self.inc) & _M64
        xorshifted = (((oldstate >> 18) ^ oldstate) >> 27) & _M32
        rot = oldstate >> 59
        return ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & _M32

    def next_float(self) -> float:
        # [1, 2) bit trick then subtract 1 (pcg32.h:103-112)
        bits = (self.next_uint() >> 9) | 0x3F800000
        return struct.unpack("<f", struct.pack("<I", bits))[0] - 1.0

    def advance(self, delta: int = 1 << 32) -> None:
        cur_mult, cur_plus = PCG32_MULT, self.inc
        acc_mult, acc_plus = 1, 0
        delta &= _M64
        while delta > 0:
            if delta & 1:
                acc_mult = (acc_mult * cur_mult) & _M64
                acc_plus = (acc_plus * cur_mult + cur_plus) & _M64
            cur_plus = ((cur_mult + 1) * cur_plus) & _M64
            cur_mult = (cur_mult * cur_mult) & _M64
            delta >>= 1
        self.state = (acc_mult * self.state + acc_plus) & _M64

    def copy(self) -> "Pcg32":
        out = Pcg32.__new__(Pcg32)
        out.state = self.state
        out.inc = self.inc
        return out


# ---------------------------------------------------------------------------
# 32-bit-half arithmetic on int64 tensors (values in [0, 2^32))
# ---------------------------------------------------------------------------

def _mullo32(a, b):
    """(a * b) mod 2^32 from 16-bit pieces of a (each product < 2^48)."""
    return ((a & _M16) * b + ((((a >> 16) * b) & _M16) << 16)) & _M32


def _mul64(ah, al, bh, bl):
    """(ah, al) * (bh, bl) mod 2^64 (utils/rng.py:_mul64)."""
    a0, a1 = al & _M16, al >> 16
    b0, b1 = bl & _M16, bl >> 16
    a0b0, a0b1, a1b0 = a0 * b0, a0 * b1, a1 * b0
    mid = (a0b0 >> 16) + (a0b1 & _M16) + (a1b0 & _M16)
    lo = ((mid << 16) | (a0b0 & _M16)) & _M32
    hi = a1 * b1 + (a0b1 >> 16) + (a1b0 >> 16) + (mid >> 16)
    hi = (hi + _mullo32(al, bh) + _mullo32(ah, bl)) & _M32
    return hi, lo


def _add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & _M32, lo & _M32


def _pcg_output(hi, lo):
    """XSH-RR output of the 64-bit pre-step state (pcg32.h:62-68)."""
    s18_lo = ((lo >> 18) | (hi << 14)) & _M32
    s18_hi = hi >> 18
    x_lo = s18_lo ^ lo
    x_hi = s18_hi ^ hi
    xorshifted = ((x_lo >> 27) | (x_hi << 5)) & _M32
    rot = hi >> 27
    return ((xorshifted >> rot) |
            (xorshifted << ((32 - rot) & 31))) & _M32


def _uint_to_unit_float(u):
    """uint32 -> f32 in [0, 1) via the [1, 2) mantissa trick."""
    bits = ((u >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def _advance_tables(inc: int, nbits: int):
    """Per-bit (multiplier, increment) of the jump-ahead, Python ints."""
    mults, pluss = [], []
    cur_mult, cur_plus = PCG32_MULT, inc & _M64
    for _ in range(nbits):
        mults.append(cur_mult)
        pluss.append(cur_plus)
        cur_plus = ((cur_mult + 1) * cur_plus) & _M64
        cur_mult = (cur_mult * cur_mult) & _M64
    return mults, pluss


def pcg32_uniforms_range(state: int, *, n: int, inc: int,
                         device) -> torch.Tensor:
    """Uniforms at stream positions 0..n-1 of the stream whose base state is
    ``state`` (a 64-bit Python int), as f32 [n] on ``device``.  Same
    two-level jump as the JAX twin: positions i*block + j, with the
    i-strides by the O(log n) advance on n/block lanes and the j-strides by
    an unrolled affine expansion."""
    block = 32  # the JAX twin's default
    nb = -(-n // block)
    base = torch.arange(nb, dtype=torch.int64, device=device) * block
    nbits = max(int(nb * block - 1).bit_length(), 1)

    def split(v: int):
        return v >> 32, v & _M32

    mults, pluss = _advance_tables(inc, nbits)
    acc_mh = torch.zeros(nb, dtype=torch.int64, device=device)
    acc_ml = torch.ones(nb, dtype=torch.int64, device=device)
    acc_ph = torch.zeros(nb, dtype=torch.int64, device=device)
    acc_pl = torch.zeros(nb, dtype=torch.int64, device=device)
    for j in range(nbits):
        bit = ((base >> j) & 1).bool()
        mh, ml = split(mults[j])
        ph, pl = split(pluss[j])
        nmh, nml = _mul64(acc_mh, acc_ml, mh, ml)
        tph, tpl = _mul64(acc_ph, acc_pl, mh, ml)
        nph, npl = _add64(tph, tpl, ph, pl)
        acc_mh = torch.where(bit, nmh, acc_mh)
        acc_ml = torch.where(bit, nml, acc_ml)
        acc_ph = torch.where(bit, nph, acc_ph)
        acc_pl = torch.where(bit, npl, acc_pl)
    sh, sl = split(state & _M64)
    bh, bl = _mul64(acc_mh, acc_ml, sh, sl)
    bh, bl = _add64(bh, bl, acc_ph, acc_pl)  # states at positions i*block

    cols = []
    a, c = 1, 0
    for _ in range(block):
        ah, al = split(a)
        ch, cl = split(c)
        th, tl = _mul64(bh, bl, ah, al)
        th, tl = _add64(th, tl, ch, cl)
        cols.append(_uint_to_unit_float(_pcg_output(th, tl)))
        c = (c * PCG32_MULT + inc) & _M64
        a = (a * PCG32_MULT) & _M64
    return torch.stack(cols, dim=-1).reshape(nb * block)[:n]


def make_sorted_dst(uniforms: torch.Tensor) -> torch.Tensor:
    """[R, SPP] uniforms -> sorted exponential thresholds
    (render/renderer.py:make_sorted_dst; rt_core.cuh:67-193)."""
    return torch.sort(-torch.log1p(-uniforms), dim=-1).values
