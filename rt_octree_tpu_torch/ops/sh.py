"""Spherical-basis evaluation in PyTorch (rt_octree_tpu/ops/sh.py twin).

Reference: renderer/include/volrend/internal/lumisphere.hpp:8-91.  The
expressions keep the JAX order term for term; the render kernel
(csrc/render.cu:eval_sh) repeats them.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814


def eval_sh_basis(basis_dim: int, dirs: torch.Tensor) -> torch.Tensor:
    """dirs [..., 3] unit vectors -> [..., basis_dim] float32."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    comps = [torch.full_like(x, SH_C0)]
    if basis_dim >= 4:
        comps += [
            -0.4886025119029199 * y,
            0.4886025119029199 * z,
            -0.4886025119029199 * x,
        ]
    if basis_dim >= 9:
        comps += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.31539156525252005 * (2.0 * zz - xx - yy),
            -1.0925484305920792 * xz,
            0.5462742152960396 * (xx - yy),
        ]
    if basis_dim >= 16:
        comps += [
            -0.5900435899266435 * y * (3 * xx - yy),
            2.890611442640554 * xy * z,
            -0.4570457994644658 * y * (4 * zz - xx - yy),
            0.3731763325901154 * z * (2 * zz - 3 * xx - 3 * yy),
            -0.4570457994644658 * x * (4 * zz - xx - yy),
            1.445305721320277 * z * (xx - yy),
            -0.5900435899266435 * x * (xx - 3 * yy),
        ]
    if basis_dim >= 25:
        comps += [
            2.5033429417967046 * xy * (xx - yy),
            -1.7701307697799304 * yz * (3 * xx - yy),
            0.9461746957575601 * xy * (7 * zz - 1.0),
            -0.6690465435572892 * yz * (7 * zz - 3.0),
            0.10578554691520431 * (zz * (35 * zz - 30) + 3),
            -0.6690465435572892 * xz * (7 * zz - 3),
            0.47308734787878004 * (xx - yy) * (7 * zz - 1.0),
            -1.7701307697799304 * xz * (xx - 3 * yy),
            0.6258357354491761 * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(comps[:basis_dim], dim=-1).to(torch.float32)


def _dot3(dirs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """dirs [R, 3] . q [B, 3] -> [R, B], summed left to right."""
    return (dirs[:, 0:1] * q[None, :, 0] + dirs[:, 1:2] * q[None, :, 1] +
            dirs[:, 2:3] * q[None, :, 2])


def eval_sg_basis(basis_dim: int, extra: torch.Tensor,
                  dirs: torch.Tensor) -> torch.Tensor:
    p = extra.reshape(basis_dim, 4)
    dots = _dot3(dirs, p[:, 1:4])
    return torch.exp(p[:, 0] * (dots - 1.0)) / basis_dim


def eval_asg_basis(basis_dim: int, extra: torch.Tensor,
                   dirs: torch.Tensor) -> torch.Tensor:
    p = extra.reshape(basis_dim, 11)
    S = _dot3(dirs, p[:, 8:11])
    dx = _dot3(dirs, p[:, 2:5])
    dy = _dot3(dirs, p[:, 5:8])
    return S * torch.exp(-p[:, 0] * dx * dx - p[:, 1] * dy * dy) / basis_dim
