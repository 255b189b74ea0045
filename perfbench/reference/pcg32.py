"""PCG32-XSH-RR (O'Neill; RT-Octree's renderer/3rdparty/pcg32.h).

``Pcg32`` is the exact host generator; ``uniforms`` gives the floats at
stream positions 0..n-1 as a tensor, each position by its own jump-ahead,
every 64-bit quantity held as two 32-bit halves in int64 tensors.
"""

from __future__ import annotations

import torch

MULT = 0x5851F42D4C957F2D
FRAME_SEED = 20230418  # render_context.hpp: the per-frame generator's seed
_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1
_M16 = 0xFFFF


class Pcg32:
    def __init__(self, initstate: int, initseq: int = 1):
        self.state = 0
        self.inc = ((initseq << 1) | 1) & _M64
        self.next_uint()
        self.state = (self.state + initstate) & _M64
        self.next_uint()

    def next_uint(self) -> int:
        old = self.state
        self.state = (old * MULT + self.inc) & _M64
        xs = (((old >> 18) ^ old) >> 27) & _M32
        rot = old >> 59
        return ((xs >> rot) | (xs << ((-rot) & 31))) & _M32

    def advance(self, delta: int) -> None:
        cur_mult, cur_plus = MULT, self.inc
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


def frame_state(frame: int) -> tuple:
    """(state, inc) of the per-frame generator after ``frame`` frames: the
    generator seeded with FRAME_SEED and advanced 2^32 a frame
    (main_headless.cpp:506)."""
    g = Pcg32(FRAME_SEED)
    g.advance(frame << 32)
    return g.state, g.inc


def _mullo32(a, b):
    return ((a & _M16) * b + ((((a >> 16) * b) & _M16) << 16)) & _M32


def _mul64(ah, al, bh, bl):
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


def uniforms(state: int, inc: int, n: int, device) -> torch.Tensor:
    """The floats in [0, 1) at stream positions 0..n-1 of the stream whose
    state is ``state``, f32 [n]: position p is the state advanced p steps,
    by the bits of p, then the XSH-RR output and the [1, 2) mantissa
    trick (pcg32.h:103-112)."""
    pos = torch.arange(n, dtype=torch.int64, device=device)
    nbits = max(int(n - 1).bit_length(), 1)
    mh = torch.zeros(n, dtype=torch.int64, device=device)
    ml = torch.ones(n, dtype=torch.int64, device=device)
    ph = torch.zeros(n, dtype=torch.int64, device=device)
    pl = torch.zeros(n, dtype=torch.int64, device=device)
    cur_mult, cur_plus = MULT, inc & _M64
    for j in range(nbits):
        bit = ((pos >> j) & 1).bool()
        cmh, cml = cur_mult >> 32, cur_mult & _M32
        cph, cpl = cur_plus >> 32, cur_plus & _M32
        nmh, nml = _mul64(mh, ml, cmh, cml)
        tph, tpl = _mul64(ph, pl, cmh, cml)
        nph, npl = _add64(tph, tpl, cph, cpl)
        mh, ml = torch.where(bit, nmh, mh), torch.where(bit, nml, ml)
        ph, pl = torch.where(bit, nph, ph), torch.where(bit, npl, pl)
        cur_plus = ((cur_mult + 1) * cur_plus) & _M64
        cur_mult = (cur_mult * cur_mult) & _M64
    sh, sl = (state & _M64) >> 32, state & _M32
    hi, lo = _mul64(mh, ml, sh, sl)
    hi, lo = _add64(hi, lo, ph, pl)
    # XSH-RR of the state before the step
    s18_lo = ((lo >> 18) | (hi << 14)) & _M32
    x_lo, x_hi = s18_lo ^ lo, (hi >> 18) ^ hi
    xs = ((x_lo >> 27) | (x_hi << 5)) & _M32
    rot = hi >> 27
    out = ((xs >> rot) | (xs << ((32 - rot) & 31))) & _M32
    bits = ((out >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def sorted_thresholds(u: torch.Tensor) -> torch.Tensor:
    """[R, SPP] uniforms -> sorted exponential optical-depth thresholds
    (rt_core.cuh:67-193)."""
    return torch.sort(-torch.log1p(-u), dim=-1).values
