"""The plain march of one frame over a PlenOctree.

Rays are the pinhole camera's (volrend.cu:24-34).  A ray is clipped to the
unit box, then steps from leaf to leaf: each step descends from the root
over the child pointers to the leaf that holds the sample, and moves to
that leaf's exit plus ``step_size`` (rt_core.cuh:195-270).  Two estimators:

- ``march_rt``, batched regular tracking: SPP sorted exponential
  thresholds; a step whose optical depth passes k thresholds records its
  leaf with count k; ``shade_rt`` shades the recorded leaves
  (rt_core.cuh:272-332).
- ``march_classic``, exponential transmittance: every occupied leaf step
  is shaded and weighted by light * (1 - att) until the light falls below
  ``stop_thresh`` (shaders/rt.frag:222-327).

Only live rays are carried from step to step.  ``low`` computes the
colour arithmetic (basis, shading, compositing, transmittance) in
bfloat16.  Positions, steps and optical depths take the dtype of the rays
(float32; float64 for a witness of the march's rounding).
Both marches also count what the frame needs: the shaded samples, the rays
with one, and the distinct rows they read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .npz import HostTree

F32 = torch.float32
BF16 = torch.bfloat16
SH_C0 = 0.28209479177387814


@dataclasses.dataclass
class Tree:
    """A HostTree on a device: rows, child pointers, and the f32 density of
    every row."""

    data: torch.Tensor  # [M, data_dim] f16
    child: torch.Tensor  # [M] i64
    sigma: torch.Tensor  # [M] f32
    offset: torch.Tensor
    scale: torch.Tensor
    N: int
    basis_dim: int
    max_depth: int


def to_device(host: HostTree, device) -> Tree:
    data = torch.from_numpy(np.require(host.data, np.float16, ["C", "W"]))
    data = data.to(device)
    return Tree(
        data=data,
        child=torch.from_numpy(host.child.astype(np.int64)).to(device),
        sigma=data[:, host.data_dim - 1].float(),
        offset=torch.from_numpy(host.offset.copy()).to(device),
        scale=torch.from_numpy(host.scale.copy()).to(device),
        N=host.N, basis_dim=host.basis_dim, max_depth=host.max_depth)


@dataclasses.dataclass
class Counts:
    """What one march shaded: samples, rays with at least one, and the
    distinct rows read by them."""

    shaded: int
    rays_shaded: int
    rows: int


def _t(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _norm3(v):
    return torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] +
                      v[:, 2] * v[:, 2])


def camera_rays(transform: torch.Tensor, width: int, height: int,
                fx: float, fy: float):
    """Unit world rays [R, 3] and origins of a [3, 4] camera-to-world
    matrix (columns right, up, back, centre), pixel (x, y) through
    ((x - W/2) / fx, -(y - H/2) / fy, -1), in the matrix's dtype."""
    ix = torch.arange(width, dtype=transform.dtype, device=transform.device)
    iy = torch.arange(height, dtype=transform.dtype, device=transform.device)
    x = (ix[None, :] - 0.5 * width) / _t(fx, ix)
    y = -((iy[:, None] - 0.5 * height) / _t(fy, iy))
    xyz = torch.stack([
        x.expand(height, width), y.expand(height, width),
        torch.full((height, width), -1.0, dtype=ix.dtype, device=ix.device),
    ], dim=-1).reshape(-1, 3)
    R = transform[:, :3]
    dirs = (xyz[:, 0:1] * R[:, 0][None, :] + xyz[:, 1:2] * R[:, 1][None, :]
            + xyz[:, 2:3] * R[:, 2][None, :])
    dirs = dirs / _norm3(dirs)[:, None]
    return dirs, transform[:, 3].expand(dirs.shape)


def sh_basis(basis_dim: int, d: torch.Tensor) -> torch.Tensor:
    """Real SH basis up to degree 2 (lumisphere.hpp:8-91) of unit dirs."""
    if basis_dim not in (1, 4, 9):
        raise ValueError(f"SH basis of {basis_dim}: the reference takes "
                         "1, 4 or 9")
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    comps = [torch.full_like(x, SH_C0)]
    if basis_dim >= 4:
        comps += [-0.4886025119029199 * y, 0.4886025119029199 * z,
                  -0.4886025119029199 * x]
    if basis_dim >= 9:
        xx, yy, zz = x * x, y * y, z * z
        comps += [1.0925484305920792 * (x * y),
                  -1.0925484305920792 * (y * z),
                  0.31539156525252005 * (2.0 * zz - xx - yy),
                  -1.0925484305920792 * (x * z),
                  0.5462742152960396 * (xx - yy)]
    return torch.stack(comps, dim=-1)


def leaf_query(tree: Tree, pos: torch.Tensor, invdir: torch.Tensor):
    """Root-to-leaf descent of tree-space points [R, 3]: (row of the
    leaf, its density, the distance to its exit along the ray)."""
    N, N3 = tree.N, tree.N ** 3
    fN = float(N)
    R = pos.shape[0]
    dev = pos.device
    pos = torch.clamp(pos, 0.0, 1.0 - 1e-6)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    leaf = torch.zeros(R, dtype=torch.int64, device=dev)
    cube = torch.zeros(R, dtype=pos.dtype, device=dev)
    node = torch.zeros(R, dtype=torch.int64, device=dev)
    xyz = pos
    cur = torch.full((R,), fN, dtype=pos.dtype, device=dev)
    for _ in range(tree.max_depth):
        xyzN = xyz * fN
        digit = torch.floor(xyzN)
        index = ((digit[:, 0] * fN + digit[:, 1]) * fN +
                 digit[:, 2]).to(torch.int64)
        sub = node * N3 + index
        skip = tree.child[torch.where(done, 0, sub)]
        is_leaf = (skip == 0) & ~done
        leaf = torch.where(is_leaf, sub, leaf)
        cube = torch.where(is_leaf, cur, cube)
        done = done | is_leaf
        node = torch.where(done, node, node + skip)
        xyz = xyzN - digit
        cur = cur * fN
    local = pos * cube[:, None]
    local = local - torch.floor(local)
    t1 = -local * invdir
    t_exit = torch.clamp(torch.maximum(t1, t1 + invdir).amin(-1), max=1e4)
    return leaf, tree.sigma[leaf], t_exit / cube


def _init(tree: Tree, dirs, cens):
    """Tree-space rays clipped to the unit box (rt_core.cuh:195-240):
    (origin, unit dir, 1 / dir, world length of a unit step, tmin, tmax,
    hits the box)."""
    R = dirs.shape[0]
    cen_t = tree.offset[None, :] + tree.scale[None, :] * cens
    d_scaled = dirs * tree.scale[None, :]
    dscale = torch.ones(R, dtype=dirs.dtype, device=dirs.device) / \
        _norm3(d_scaled)
    d_t = d_scaled * dscale[:, None]
    invdir = torch.ones_like(d_t) / (d_t + 1e-9)
    lo = torch.zeros(3, dtype=dirs.dtype, device=dirs.device) + 1e-6
    hi = torch.ones(3, dtype=dirs.dtype, device=dirs.device) - 1e-6
    t1 = (lo - cen_t) * invdir
    t2 = (hi - cen_t) * invdir
    tmin = torch.clamp(torch.minimum(t1, t2).amax(-1), min=0.0)
    tmax = torch.clamp(torch.maximum(t1, t2).amin(-1), max=1e4)
    tmax = torch.minimum(tmax, torch.full_like(tmax, 1e9) / dscale)
    hit = (tmax >= 0) & (tmin <= tmax)
    return cen_t, d_t, invdir, dscale, tmin, tmax, hit


def _count_rows(tree: Tree, rows: torch.Tensor) -> int:
    mask = torch.zeros(tree.data.shape[0], dtype=torch.bool,
                       device=rows.device)
    mask[rows] = True
    return int(mask.sum())


def march_rt(tree: Tree, dirs, cens, dst, step_size: float,
             sigma_thresh: float, max_steps: int):
    """Regular tracking of rays [R, 3] against sorted thresholds dst
    [R, SPP]: the recorded leaves (rows [R, SPP] i64, counts [R, SPP]
    i32, slots filled in order, count 0 when unused) and their Counts."""
    R, spp = dst.shape
    dev = dirs.device
    cen_t, d_t, invdir, dscale, tmin, tmax, hit = _init(tree, dirs, cens)
    rec_ptr = torch.zeros((R, spp), dtype=torch.int64, device=dev)
    rec_cnt = torch.zeros((R, spp), dtype=torch.int32, device=dev)
    idx = hit.nonzero()[:, 0]
    c, d, inv, ds, tm, th = (a[idx] for a in (cen_t, d_t, invdir, dscale,
                                              tmax, dst))
    t = tmin[idx]
    src = torch.zeros_like(t)
    sppc = torch.zeros(idx.shape[0], dtype=torch.int32, device=dev)
    shn = torch.zeros_like(sppc)
    st, sig = _t(step_size, t), _t(sigma_thresh, t)
    for _ in range(max_steps):
        if idx.numel() == 0:
            break
        leaf, sigma, t_sub = leaf_query(tree, c + t[:, None] * d, inv)
        delta_t = t_sub + st
        has = sigma > sig
        s_new = src + torch.where(has, delta_t * ds * sigma, 0.0)
        k = torch.clamp((th <= s_new[:, None]).sum(1, dtype=torch.int32)
                        - sppc, min=0)
        rec = has & (k > 0)
        r_i, slot = idx[rec], shn[rec].to(torch.int64)
        rec_ptr[r_i, slot] = leaf[rec]
        rec_cnt[r_i, slot] = k[rec]
        shn = shn + rec.to(torch.int32)
        sppc = sppc + torch.where(rec, k, 0)
        src = torch.where(has, s_new, src)
        t = t + delta_t
        live = (t < tm) & (sppc < spp)
        if not bool(live.all()):
            idx, c, d, inv, ds, tm, th, t, src, sppc, shn = (
                a[live] for a in (idx, c, d, inv, ds, tm, th, t, src, sppc,
                                  shn))
    used = rec_cnt > 0
    counts = Counts(shaded=int(used.sum()),
                    rays_shaded=int(used.any(1).sum()),
                    rows=_count_rows(tree, rec_ptr[used]))
    return rec_ptr, rec_cnt, counts


def _leaf_rgb(tree: Tree, rows, basis, dtype):
    bd = tree.basis_dim
    vals = tree.data[rows].to(dtype)
    coeffs = vals[..., :3 * bd].reshape(*rows.shape, 3, bd)
    return torch.sigmoid((coeffs * basis[..., None, :]).sum(-1))


def shade_rt(tree: Tree, vdirs, rec_ptr, rec_cnt, low: bool = False):
    """Premultiplied rgba [R, 4]: the count-weighted mean over SPP of the
    recorded leaves' sigmoid(coefficients . basis(view dir))."""
    dtype = BF16 if low else F32
    spp = rec_ptr.shape[1]
    w = rec_cnt.to(dtype)
    spp_t = torch.tensor(float(spp), dtype=dtype, device=w.device)
    basis = sh_basis(tree.basis_dim, vdirs).to(dtype)
    rgb_leaf = _leaf_rgb(tree, rec_ptr, basis[:, None, :], dtype)
    rgb = (rgb_leaf * w[..., None]).sum(1) / spp_t
    alpha = w.sum(1) / spp_t
    return torch.cat([rgb, alpha[:, None]], dim=1).float()


UNROLL = 2  # the classic frame tests its step limit every 2 steps


def march_classic(tree: Tree, dirs, vdirs, cens, step_size: float,
                  sigma_thresh: float, stop_thresh: float, max_steps: int,
                  low: bool = False):
    """The classic estimator: (rgba [R, 4] = [rgb, 1 - light], Counts).
    A ray takes at most ceil(max_steps / UNROLL) * UNROLL steps."""
    dtype = BF16 if low else F32
    R = dirs.shape[0]
    dev = dirs.device
    cen_t, d_t, invdir, dscale, tmin, tmax, hit = _init(tree, dirs, cens)
    basis_all = sh_basis(tree.basis_dim, vdirs).to(dtype)
    out_rgb = torch.zeros((R, 3), dtype=dtype, device=dev)
    out_light = torch.ones(R, dtype=dtype, device=dev)
    row_mask = torch.zeros(tree.data.shape[0], dtype=torch.bool, device=dev)
    ray_shaded = torch.zeros(R, dtype=torch.bool, device=dev)
    shaded = 0
    idx = hit.nonzero()[:, 0]
    c, d, inv, ds, tm, basis = (a[idx] for a in (cen_t, d_t, invdir, dscale,
                                                 tmax, basis_all))
    t = tmin[idx]
    light = torch.ones(idx.shape[0], dtype=dtype, device=dev)
    rgb = torch.zeros((idx.shape[0], 3), dtype=dtype, device=dev)
    st, sig = _t(step_size, t), _t(sigma_thresh, t)
    stop_t = torch.tensor(stop_thresh, dtype=dtype, device=dev)
    one = torch.tensor(1.0, dtype=dtype, device=dev)
    for _ in range(-(-max_steps // UNROLL) * UNROLL):
        if idx.numel() == 0:
            break
        leaf, sigma, t_sub = leaf_query(tree, c + t[:, None] * d, inv)
        delta_t = t_sub + st
        has = sigma > sig
        att = torch.clamp(torch.exp((-delta_t * ds * sigma).to(dtype)),
                          max=1.0)
        weight = torch.where(has, light * (one - att), 0.0)
        ptr = torch.where(has, leaf, 0)
        n_has = int(has.sum())
        if n_has:
            shaded += n_has
            row_mask[leaf[has]] = True
            ray_shaded[idx[has]] = True
        rgb = rgb + weight[:, None] * _leaf_rgb(tree, ptr, basis, dtype)
        light_new = torch.where(has, light * att, light)
        stop = has & (light_new < stop_t)
        rgb = torch.where(stop[:, None], rgb / (one - light_new[:, None]),
                          rgb)
        light = torch.where(stop, 0.0, light_new)
        t = t + delta_t
        live = (t < tm) & ~stop
        if not bool(live.all()):
            done = ~live
            out_rgb[idx[done]] = rgb[done]
            out_light[idx[done]] = light[done]
            idx, c, d, inv, ds, tm, basis, t, light, rgb = (
                a[live] for a in (idx, c, d, inv, ds, tm, basis, t, light,
                                  rgb))
    out_rgb[idx] = rgb
    out_light[idx] = light
    out = torch.cat([out_rgb, (one - out_light)[:, None]], dim=1).float()
    counts = Counts(shaded=shaded, rays_shaded=int(ray_shaded.sum()),
                    rows=int(row_mask.sum()))
    return out, counts


def composite(out, width: int, height: int, background: float,
              low: bool = False):
    """Premultiplied rgba [R, 4] over the background: (img [H, W, 4] with
    alpha 1, aux [H, W, 8] = [rgb, alpha, their squares])."""
    dtype = BF16 if low else F32
    o = out.to(dtype)
    rgb = o[:, :3] + background * (1.0 - o[:, 3:4])
    outc = torch.cat([rgb, o[:, 3:4]], dim=1)
    img = torch.cat([rgb, torch.ones_like(o[:, 3:4])], dim=1)
    aux = torch.cat([outc, outc * outc], dim=-1)
    return (img.float().reshape(height, width, 4),
            aux.float().reshape(height, width, 8))
