"""The least time the card could take for a frame and for each of its
stages, counted from the work the frame's inputs need.

Each stage's work is bytes that must cross HBM (each input read once, each
output written once) and operations by type.  Its bound is the larger of
bytes / HBM rate and the operations' time at the peak of their type:
NVIDIA's published H100 SXM figures, dense, at the full 700 W
(``PEAKS``).  The march's counts come from the reference march of the same
frame (shaded samples, rays with one, distinct rows), never from the
program's acceleration structure: an implementation may skip jump-table
cells, skip distances and empty leaves, so none is counted.
"""

from __future__ import annotations

import dataclasses

# bytes/s of HBM3, f32 FLOP/s outside the tensor cores, dense bf16 tensor
# FLOP/s (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S, "f32_ops_per_s": F32_OPS_PER_S,
         "bf16_tc_ops_per_s": BF16_TC_OPS_PER_S}

# f32 operations of a shaded sample: the three dot products of the row's
# coefficients with the basis (6 a basis function), three sigmoids and the
# weighted sum (16)
SAMPLE_OPS_PER_BASIS, SAMPLE_OPS = 6, 16
# the basis of a ray's view direction, 2 a basis function; the background
# composite of a pixel (1 - alpha, three multiply-adds)
BASIS_OPS_PER_FN, COMPOSITE_OPS = 2, 7
# the joint upsample of an output pixel: 4 channels of 3 lerps of 3
# operations, 4 squares
UPSAMPLE_OPS = 40
RGBA_F32_BYTES = 16


@dataclasses.dataclass(frozen=True)
class Work:
    bytes: float = 0.0
    f32_ops: float = 0.0
    bf16_ops: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.f32_ops + other.f32_ops,
                    self.bf16_ops + other.bf16_ops)

    def bound_s(self) -> float:
        """max(bytes / HBM rate, the operations' time at their peaks)."""
        return max(self.bytes / HBM_BYTES_PER_S,
                   self.f32_ops / F32_OPS_PER_S
                   + self.bf16_ops / BF16_TC_OPS_PER_S)

    def bound_by(self) -> str:
        ops_s = (self.f32_ops / F32_OPS_PER_S
                 + self.bf16_ops / BF16_TC_OPS_PER_S)
        return "bytes" if self.bytes / HBM_BYTES_PER_S >= ops_s else \
            "operations"


def march(pixels: int, shaded: int, rays_shaded: int, rows: int,
          basis_dim: int, data_dim: int) -> Work:
    """K1 or the classic march of one frame: the premultiplied rgba of
    every pixel written once, each distinct f16 row a shaded sample reads
    read once; the basis of every ray with a shaded sample, every shaded
    sample's shade, every pixel's composite."""
    nbytes = RGBA_F32_BYTES * pixels + 2 * data_dim * rows
    ops = ((SAMPLE_OPS_PER_BASIS * basis_dim + SAMPLE_OPS) * shaded
           + BASIS_OPS_PER_FN * basis_dim * rays_shaded
           + COMPOSITE_OPS * pixels)
    return Work(bytes=nbytes, f32_ops=ops)


def net(channels, pixels: int) -> Work:
    """K7 on ``pixels``: the f32 aux read once, the bf16 last activation
    written once; 2 operations a multiply-add of every block's 3x3 taps,
    on the bf16 tensor cores.  ``channels``: (cin, cout) per block."""
    nbytes = pixels * (4 * channels[0][0] + 2 * channels[-1][1])
    ops = pixels * 2 * 9 * sum(cin * cout for cin, cout in channels)
    return Work(bytes=nbytes, bf16_ops=ops)


def net_weight_bytes(channels) -> int:
    """The folded blocks' bf16 kernels and biases."""
    return sum(2 * (9 * cin * cout + cout) for cin, cout in channels)


def guided_filter(levels: int, supports, pixels: int) -> Work:
    """K2 on ``pixels``: the activation (2L bf16), the rgb and the output
    once; 9 operations a window tap, 10 a level a pixel."""
    taps = sum((2 * s + 1) ** 2 for s in supports if s > 0)
    return Work(bytes=pixels * (4 * levels + 12 + 16),
                f32_ops=pixels * (9 * taps + 10 * levels))


def upsample(pixels_out: int) -> Work:
    """K4's operations (its bytes are intermediates of the frame)."""
    return Work(f32_ops=UPSAMPLE_OPS * pixels_out)


def frame(march_work: Work, rows_bytes: float, pixels_out: int,
          net_work: Work = None, weight_bytes: int = 0,
          filter_work: Work = None, upsample_work: Work = None) -> Work:
    """The whole frame: only its inputs (the rows shaded, the net's
    weights, the pose) and the final image cross HBM, so that fusing
    stages cannot make the count stale; the operations of every stage."""
    ops = Work(f32_ops=march_work.f32_ops)
    for w in (net_work, filter_work, upsample_work):
        if w is not None:
            ops = ops + Work(f32_ops=w.f32_ops, bf16_ops=w.bf16_ops)
    nbytes = rows_bytes + weight_bytes + 48 + RGBA_F32_BYTES * pixels_out
    return Work(bytes=nbytes, f32_ops=ops.f32_ops, bf16_ops=ops.bf16_ops)
