"""NumPy spherical-harmonic basis (host side).

The port's own copy of rt_octree_tpu/core/sh_np.py:eval_sh_basis_np
(reference: renderer/include/volrend/internal/lumisphere.hpp:8-91; SH
coefficients from github.com/google/spherical-harmonics), for the host
tools (tools/gen_sh_mesh.py).  The renderer's basis runs in torch
(ops/sh.py) and in the kernels.
"""

from __future__ import annotations

import numpy as np

SH_C0 = 0.28209479177387814


def eval_sh_basis_np(basis_dim: int, dirs: np.ndarray) -> np.ndarray:
    """dirs [..., 3] (unit) -> [..., basis_dim]."""
    shape = dirs.shape[:-1]
    out = np.zeros(shape + (basis_dim,), np.float32)
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    out[..., 0] = SH_C0
    if basis_dim >= 4:
        out[..., 1] = -0.4886025119029199 * y
        out[..., 2] = 0.4886025119029199 * z
        out[..., 3] = -0.4886025119029199 * x
    if basis_dim >= 9:
        out[..., 4] = 1.0925484305920792 * xy
        out[..., 5] = -1.0925484305920792 * yz
        out[..., 6] = 0.31539156525252005 * (2.0 * zz - xx - yy)
        out[..., 7] = -1.0925484305920792 * xz
        out[..., 8] = 0.5462742152960396 * (xx - yy)
    if basis_dim >= 16:
        out[..., 9] = -0.5900435899266435 * y * (3 * xx - yy)
        out[..., 10] = 2.890611442640554 * xy * z
        out[..., 11] = -0.4570457994644658 * y * (4 * zz - xx - yy)
        out[..., 12] = 0.3731763325901154 * z * (2 * zz - 3 * xx - 3 * yy)
        out[..., 13] = -0.4570457994644658 * x * (4 * zz - xx - yy)
        out[..., 14] = 1.445305721320277 * z * (xx - yy)
        out[..., 15] = -0.5900435899266435 * x * (xx - 3 * yy)
    if basis_dim >= 25:
        out[..., 16] = 2.5033429417967046 * xy * (xx - yy)
        out[..., 17] = -1.7701307697799304 * yz * (3 * xx - yy)
        out[..., 18] = 0.9461746957575601 * xy * (7 * zz - 1.0)
        out[..., 19] = -0.6690465435572892 * yz * (7 * zz - 3.0)
        out[..., 20] = 0.10578554691520431 * (zz * (35 * zz - 30) + 3)
        out[..., 21] = -0.6690465435572892 * xz * (7 * zz - 3)
        out[..., 22] = 0.47308734787878004 * (xx - yy) * (7 * zz - 1.0)
        out[..., 23] = -1.7701307697799304 * xz * (xx - 3 * yy)
        out[..., 24] = 0.6258357354491761 * (
            xx * (xx - 3 * yy) - yy * (3 * xx - yy))
    return out
