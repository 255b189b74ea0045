"""Lumisphere probe: voxel inspection + screen-corner overlay, in PyTorch.

Counterpart of rt_octree_tpu/render/probe.py.  Reference:
retrieve_cursor_lumisphere_kernel (volrend.cu:215-231) fetches the
coefficients of the leaf containing the probe point; the render kernel then
draws a circular lumisphere preview in the top-right corner
(volrend.cu:100-134), replacing scene pixels there.

Plain tensor code, no kernel: one tree query and, once a frame, the
(d + 5)^2 corner pixels (about 11k at d = 100).  The JAX version evaluates
the basis over the whole frame and masks it; this one evaluates the corner
region only, with the same per-pixel arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.n3tree import BasisFormat
from ..ops.sh import eval_asg_basis, eval_sg_basis, eval_sh_basis
from ..ops.traversal import DeviceTree, tree_query_full

F32 = torch.float32


def retrieve_cursor_lumisphere(tree: DeviceTree, probe_xyz) -> torch.Tensor:
    """Coefficients (data_dim - 1, f32) of the leaf containing the
    world-space probe point."""
    xyz = torch.as_tensor(probe_xyz, dtype=F32, device=tree.device)
    if tuple(xyz.shape) != (3,):
        raise ValueError("probe point must be x, y, z, got "
                         f"{tuple(xyz.shape)}")
    pos = tree.offset + tree.scale * xyz
    sub_ptr = tree_query_full(tree, pos[None, :])[0]
    row = tree.data[sub_ptr.to(torch.int64)][0].to(F32)
    return row[:tree.data_dim - 1]


def apply_probe_overlay(img: torch.Tensor, tree: DeviceTree,
                        transform: torch.Tensor, probe_coeffs: torch.Tensor,
                        basis_minmax=(0, 24),
                        probe_disp_size: int = 100) -> torch.Tensor:
    """Draw the lumisphere preview disc over img [H, W, 4] (a new tensor,
    alpha 1).

    Geometry per volrend.cu:100-134: a disc of diameter probe_disp_size
    inset 5 px from the top-right corner; each disc pixel maps to a
    direction on the camera-facing hemisphere, coloured by
    sigmoid(basis . coeffs); the rest of the corner square is black."""
    H, W, _ = img.shape
    d = probe_disp_size
    dev = img.device
    y_end, x_start = min(d + 5, H), max(W - d - 5, 0)
    out = img.clone()
    out[..., 3] = 1.0
    if y_end <= 0 or x_start >= W:
        return out
    ys = torch.arange(y_end, device=dev)
    xs = torch.arange(x_start, W, device=dev)
    half = torch.tensor(0.5 * d, dtype=F32, device=dev)
    xx = (xs[None, :] - (W - d) + 5).to(F32)
    yy = (ys[:, None] - 5).to(F32)
    cx = -(xx / half - 1.0)
    cy = yy / half - 1.0
    c2 = cx * cx + cy * cy
    cx, cy = torch.broadcast_tensors(cx, cy)
    inside = c2 <= 1.0
    cz = -torch.sqrt(torch.clamp(1.0 - c2, min=0.0))
    R = transform.to(F32)[:, :3]
    dirs = (cx[..., None] * R[:, 0] + cy[..., None] * R[:, 1] +
            cz[..., None] * R[:, 2])
    bd = tree.basis_dim
    if bd >= 0:
        flat = dirs.reshape(-1, 3)
        if tree.fmt == BasisFormat.SH.value:
            basis = eval_sh_basis(bd, flat)
        elif tree.fmt == BasisFormat.SG.value:
            basis = eval_sg_basis(bd, tree.extra, flat)
        elif tree.fmt == BasisFormat.ASG.value:
            basis = eval_asg_basis(bd, tree.extra, flat)
        else:
            basis = torch.zeros((flat.shape[0], bd), dtype=F32, device=dev)
        lo, hi = basis_minmax
        b = np.arange(bd)
        mask = torch.as_tensor((b >= lo) & (b <= hi), dtype=F32).to(dev)
        coeffs = probe_coeffs[:3 * bd].reshape(3, bd)
        logits = (basis * mask[None, :]) @ coeffs.T
        rgb = (1.0 / (1.0 + torch.exp(-logits))).reshape(*inside.shape, 3)
    else:
        rgb = probe_coeffs[:3].expand(*inside.shape, 3)
    out[:y_end, x_start:, :3] = torch.where(inside[..., None], rgb, 0.0)
    return out
