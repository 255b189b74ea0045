"""Frame renderer in PyTorch with the fused render kernel.

Counterpart of rt_octree_tpu/render/renderer.py.  ``render_noisy`` is the
wrapper of kernel K1 (csrc/render.cu): one CUDA thread per pixel, a warp
per 8x4 pixel tile, does the ray setup, the PCG32 thresholds, the
leaf-step march over the jump LUT with empty-space skips, the
distinct-leaf shade, compositing and the aux buffers (volrend.cu:84-213,
rt_core.cuh:195-332).  With ``estimator="classic"`` it launches K1's
classic variant (``render_classic``, trace_rays_classic): the
exponential-transmittance march that shades every leaf step and stops
early at ``stop_thresh``.  A rasterized mesh pass (``mesh_color`` [R, 3],
``mesh_depth`` [R]) clips the rays and replaces the background.
``render_stats`` runs K1's statistics variant: per-ray step counts and
the distinct LUT cells, chs rows and data rows the frame reads.

``render_noisy_plain`` is its plain PyTorch version, the JAX package's
"thin" march: a ``while active.any()`` loop of one leaf step over every ray
(_march_body, renderer.py:200-268), then one shade of the recorded leaves
(_shade_rows, :757-779), ``composite`` and ``aux_from_composite``
(:1207-1231); ``march_classic_plain`` is the classic march.  The
compaction schedule, shade-on-death buffers and brick rows of the JAX
package are how XLA on a TPU marches, not what the frame computes, and are
not ported.

The plain version divides by 0-d tensors, never by Python scalars: on CUDA
PyTorch turns a division by a host scalar into a multiplication by its
reciprocal, which rounds differently from the kernel and the JAX package.

``Renderer`` owns the per-frame RNG protocol and the denoiser:
GuidanceNetCompact, kernel K7 (ops/guidance.py, csrc/net.cu) from K1's
aux, hands its last bf16 activation to kernel K2 (ops/filtering.py), which
splits it into level weights and guidance.
In fast mode (``render_scale < 1``) K1 marches at the inner size and
kernel K4 (ops/resize.py) joint-upsamples its image and aux to the output
size before the net.  ``show_grid`` composites the octree's wireframe
(render/raster.py) as a mesh pass; ``render_with_probe`` draws the
lumisphere probe (render/probe.py) over the finished frame.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..core.camera import Camera
from ..core.options import RenderOptions
from ..io.mesh import Mesh
from ..io.n3tree import BasisFormat
from ..io.wireframe import gen_wireframe
from ..models.guidance_net import build_compact, load_model
from ..native import build as native
from ..ops.filtering import guided_filter
from ..ops.resize import downsample_nearest, fast_upsample
from ..ops.sh import eval_asg_basis, eval_sg_basis, eval_sh_basis
from ..ops.traversal import DeviceTree, tree_query_full
from ..utils.rng import Pcg32, make_sorted_dst, pcg32_uniforms_range
from ..utils.timer import T_FILTER, T_NET, T_RENDER
from .probe import apply_probe_overlay, retrieve_cursor_lumisphere
from .raster import rasterize_meshes

F32 = torch.float32


def _t(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on ``like``'s device (see the module doc)."""
    return torch.tensor(v, dtype=F32, device=like.device)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] +
                      v[:, 2] * v[:, 2])


# ---------------------------------------------------------------------------
# plain version of kernel K1
# ---------------------------------------------------------------------------

def device_camera_rays(transform: torch.Tensor, width: int, height: int,
                       fx: float, fy: float):
    """Per-pixel world rays (volrend.cu:24-34: integer pixel coords, no
    half-pixel offset).  transform: [3, 4] c2w.  Element-wise mat-vec."""
    ix = torch.arange(width, dtype=F32, device=transform.device)
    iy = torch.arange(height, dtype=F32, device=transform.device)
    x = (ix[None, :] - 0.5 * width) / _t(fx, ix)
    y = -((iy[:, None] - 0.5 * height) / _t(fy, iy))
    xyz = torch.stack([
        x.expand(height, width), y.expand(height, width),
        torch.full((height, width), -1.0, dtype=F32, device=ix.device),
    ], dim=-1).reshape(-1, 3)
    R = transform[:, :3]
    dirs = (xyz[:, 0:1] * R[:, 0][None, :] + xyz[:, 1:2] * R[:, 1][None, :]
            + xyz[:, 2:3] * R[:, 2][None, :])
    dirs = dirs / _norm3(dirs)[:, None]
    cen = transform[:, 3].expand(dirs.shape)
    return dirs, cen


def rodrigues(aa, dirs: torch.Tensor) -> torch.Tensor:
    """Axis-angle rotation of view dirs (volrend.cu:58-73)."""
    aa = torch.as_tensor(aa, dtype=F32).to(dirs.device)
    angle = torch.sqrt(aa[0] * aa[0] + aa[1] * aa[1] + aa[2] * aa[2])
    k = aa / torch.clamp(angle, min=1e-12)
    cos_a, sin_a = torch.cos(angle), torch.sin(angle)
    d0, d1, d2 = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    cross = torch.stack([k[1] * d2 - k[2] * d1, k[2] * d0 - k[0] * d2,
                         k[0] * d1 - k[1] * d0], dim=-1)
    dot = d0 * k[0] + d1 * k[1] + d2 * k[2]
    rotated = (dirs * cos_a + cross * sin_a +
               k[None, :] * dot[:, None] * (1.0 - cos_a))
    return torch.where(angle < 1e-6, dirs, rotated)


def maybe_world2ndc(tree: DeviceTree, dirs, cens):
    """LLFF NDC warp (volrend.cu:35-56); no-op unless the tree has NDC."""
    if tree.ndc is None:
        return dirs, cens
    w, h, focal = tree.ndc
    ax, ay = -((2 * focal) / w), -((2 * focal) / h)
    t = -(1.0 + cens[:, 2]) / dirs[:, 2]
    cens = cens + t[:, None] * dirs
    cz = cens[:, 2]
    d0 = ax * (dirs[:, 0] / dirs[:, 2] - cens[:, 0] / cz)
    d1 = ay * (dirs[:, 1] / dirs[:, 2] - cens[:, 1] / cz)
    d2 = torch.full_like(cz, -2.0) / cz
    c0 = ax * (cens[:, 0] / cz)
    c1 = ay * (cens[:, 1] / cz)
    c2 = 1.0 + torch.full_like(cz, 2.0) / cz
    ndirs = torch.stack([d0, d1, d2], -1)
    ndirs = ndirs / _norm3(ndirs)[:, None]
    return ndirs, torch.stack([c0, c1, c2], -1)


def _dda_world(cen, invdir, bbox):
    """[R] tmin/tmax against the render bbox (rt_core.cuh:20-36)."""
    lo = torch.tensor(bbox[:3], dtype=F32, device=cen.device) + 1e-6
    hi = torch.tensor(bbox[3:], dtype=F32, device=cen.device) - 1e-6
    t1 = (lo - cen) * invdir
    t2 = (hi - cen) * invdir
    tmin = torch.clamp(torch.minimum(t1, t2).amax(-1), min=0.0)
    tmax = torch.clamp(torch.maximum(t1, t2).amin(-1), max=1e4)
    return tmin, tmax


def _dda_unit(local, invdir):
    """Distance to the unit-cube exit from leaf-local pos
    (rt_core.cuh:38-51)."""
    t1 = -local * invdir
    t2 = t1 + invdir
    return torch.clamp(torch.maximum(t1, t2).amin(-1), max=1e4)


def _query_step(tree: DeviceTree, pos, invdir, active, touched=None):
    """Leaf query + step exit distance, with the Chebyshev empty-space skip
    when the LUT carries distances (renderer.py:_query_step)."""
    sub_ptr, cube, local, sigma, bits = tree_query_full(tree, pos, active,
                                                        touched)
    t_sub = _dda_unit(local, invdir) / cube
    if tree.skip_cap > 0:
        res = _t(float(tree.N ** tree.lut_levels), pos)
        posc = torch.clamp(pos, 0.0, 1.0 - 1e-6)
        cell = torch.floor(posc * res)
        # distances ride as integer bits 1..255 in empty cells
        dist = torch.where((bits > 0) & (bits <= 255), bits, 1).to(F32)
        lo = (cell - (dist[:, None] - 1.0)) / res
        hi = (cell + dist[:, None]) / res
        t_box = torch.maximum((lo - posc) * invdir,
                              (hi - posc) * invdir).amin(-1)
        t_sub = torch.where(dist > 1.0, torch.maximum(t_sub, t_box), t_sub)
    return sub_ptr, sigma, t_sub


def _init_march(tree: DeviceTree, dirs, cens, opt: RenderOptions,
                tmax_bg=None):
    """World rays -> tree-space march (rt_core.cuh:195-240): (cen_t, d_t,
    invdir, delta_scale, tmin, tmax, active).  ``tmax_bg`` [R]: the mesh
    pass's ray distance, already clamped to 1e9 (None: 1e9)."""
    R = dirs.shape[0]
    dev = dirs.device
    cen_t = tree.offset[None, :] + tree.scale[None, :] * cens
    d_scaled = dirs * tree.scale[None, :]
    delta_scale = torch.ones(R, dtype=F32, device=dev) / _norm3(d_scaled)
    d_t = d_scaled * delta_scale[:, None]
    if tmax_bg is None:
        tmax_bg = torch.full((R,), 1e9, dtype=F32, device=dev)
    # world depth -> tree-space ray parameter (rt_core.cuh:208 divides)
    tmax_bg = tmax_bg / delta_scale
    invdir = torch.ones_like(d_t) / (d_t + 1e-9)
    tmin, tmax = _dda_world(cen_t, invdir, tuple(opt.render_bbox))
    tmax = torch.minimum(tmax, tmax_bg)
    active = (tmax >= 0) & (tmin <= tmax)
    return cen_t, d_t, invdir, delta_scale, tmin, tmax, active


def march_plain(tree: DeviceTree, dirs, cens, dst, opt: RenderOptions,
                max_steps: int = 8192, touched: Optional[dict] = None,
                tmax_bg=None):
    """The leaf-step march over a ray batch (_init_march + _march_body).

    dirs/cens: [R, 3] world rays (already NDC-warped); dst: [R, SPP] sorted
    thresholds.  Returns the distinct-leaf records (ptr [R, SPP] i32,
    count [R, SPP] i32), slots filled in order, count 0 when unused, and
    the leaf steps per ray ([R] i32; 0 for a ray that misses the bbox).
    ``touched``: see ops/traversal.py:tree_query_full; ``tmax_bg``: see
    _init_march."""
    R, spp = dst.shape
    dev = dirs.device
    cen_t, d_t, invdir, delta_scale, t, tmax, active = _init_march(
        tree, dirs, cens, opt, tmax_bg)

    src = torch.zeros(R, dtype=F32, device=dev)
    sppc = torch.zeros(R, dtype=torch.int32, device=dev)
    shn = torch.zeros(R, dtype=torch.int32, device=dev)
    rec_ptr = torch.zeros((R, spp), dtype=torch.int32, device=dev)
    rec_cnt = torch.zeros((R, spp), dtype=torch.int32, device=dev)
    steps = torch.zeros(R, dtype=torch.int32, device=dev)
    iota = torch.arange(spp, dtype=torch.int32, device=dev)
    sigma_thresh = _t(opt.sigma_thresh, t)
    step_size = _t(opt.step_size, t)
    for _ in range(max_steps):
        if not bool(active.any()):
            break
        steps = steps + active.to(torch.int32)
        pos = cen_t + t[:, None] * d_t
        sub_ptr, sigma, t_sub = _query_step(tree, pos, invdir, active,
                                            touched)
        # _step_update (rt_core.cuh:241-270)
        delta_t = t_sub + step_size
        has_sigma = (sigma > sigma_thresh) & active
        delta = torch.where(has_sigma, delta_t * delta_scale * sigma, 0.0)
        s_new = src + delta
        n_leq = (dst <= s_new[:, None]).sum(1, dtype=torch.int32)
        c = torch.clamp(n_leq - sppc, min=0)
        rec = has_sigma & (c > 0)
        slot = (iota[None, :] == shn[:, None]) & rec[:, None]
        rec_ptr = torch.where(slot, sub_ptr[:, None], rec_ptr)
        rec_cnt = torch.where(slot, c[:, None], rec_cnt)
        shn = shn + rec.to(torch.int32)
        sppc = sppc + torch.where(rec, c, 0)
        src = torch.where(has_sigma, s_new, src)
        t = torch.where(active, t + delta_t, t)
        active = active & (t < tmax) & (sppc < spp)
    return rec_ptr, rec_cnt, steps


def _leaf_rgb(tree: DeviceTree, ptr, basis):
    """sigmoid(basis . coeffs) per leaf for SH/SG/ASG, the raw rgb for
    RGBA (_leaf_rgb); ptr [R], basis [R, bd] -> [R, 3]."""
    vals = tree.data[ptr.to(torch.int64)].to(F32)
    if tree.basis_dim < 0:
        return vals[:, :3]
    bd = tree.basis_dim
    coeffs = vals[:, :3 * bd].reshape(-1, 3, bd)
    return torch.sigmoid((coeffs * basis[:, None, :]).sum(-1))


def march_classic_plain(tree: DeviceTree, dirs, vdirs, cens,
                        opt: RenderOptions, max_steps: int = 8192,
                        touched: Optional[dict] = None, tmax_bg=None):
    """The classic exponential-transmittance march (trace_rays_classic):
    per leaf step with sigma > sigma_thresh the leaf's rgb is weighted by
    light * (1 - att), att = min(exp(-delta_t * delta_scale * sigma), 1);
    once light < stop_thresh the rgb is renormalized by 1 / (1 - light)
    and the ray stops.  Returns (out [R, 4] = [rgb, 1 - light], steps [R]
    i32).  Like the JAX loop (unroll=2) it tests ``max_steps`` every two
    steps.  ``touched`` also receives ``"data"`` [M], the rows shaded."""
    R = dirs.shape[0]
    dev = dirs.device
    cen_t, d_t, invdir, delta_scale, t, tmax, active = _init_march(
        tree, dirs, cens, opt, tmax_bg)
    basis = _masked_basis(tree, vdirs, opt) if tree.basis_dim >= 0 else None
    sigma_thresh = _t(opt.sigma_thresh, t)
    stop_thresh = _t(opt.stop_thresh, t)
    step_size = _t(opt.step_size, t)
    light = torch.ones(R, dtype=F32, device=dev)
    rgb = torch.zeros((R, 3), dtype=F32, device=dev)
    steps = torch.zeros(R, dtype=torch.int32, device=dev)
    for _ in range(0, max_steps, 2):
        if not bool(active.any()):
            break
        for _ in range(2):
            steps = steps + active.to(torch.int32)
            pos = cen_t + t[:, None] * d_t
            sub_ptr, sigma, t_sub = _query_step(tree, pos, invdir, active,
                                                touched)
            delta_t = t_sub + step_size
            has = (sigma > sigma_thresh) & active
            att = torch.clamp(torch.exp(-delta_t * delta_scale * sigma),
                              max=1.0)
            weight = torch.where(has, light * (1.0 - att), 0.0)
            ptr = torch.where(has, sub_ptr, 0)
            if touched is not None:
                touched["data"][ptr[has].to(torch.int64)] = True
            rgb = rgb + weight[:, None] * _leaf_rgb(tree, ptr, basis)
            light_new = torch.where(has, light * att, light)
            stop = has & (light_new < stop_thresh)
            rgb = torch.where(stop[:, None], rgb / (1.0 - light_new[:, None]),
                              rgb)
            light = torch.where(stop, 0.0, light_new)
            t = torch.where(active, t + delta_t, t)
            active = active & (t < tmax) & ~stop
    return torch.cat([rgb, (1.0 - light)[:, None]], dim=1), steps


def _masked_basis(tree: DeviceTree, vdirs, opt: RenderOptions):
    bd = tree.basis_dim
    if tree.fmt == BasisFormat.SH.value:
        basis = eval_sh_basis(bd, vdirs)
    elif tree.fmt == BasisFormat.SG.value:
        basis = eval_sg_basis(bd, tree.extra, vdirs)
    elif tree.fmt == BasisFormat.ASG.value:
        basis = eval_asg_basis(bd, tree.extra, vdirs)
    else:
        basis = torch.zeros((vdirs.shape[0], bd), dtype=F32,
                            device=vdirs.device)
    lo, hi = opt.basis_minmax
    b = np.arange(bd)
    mask = torch.as_tensor((b >= lo) & (b <= hi), dtype=F32).to(vdirs.device)
    return basis * mask[None, :]


def shade_plain(tree: DeviceTree, vdirs, rec_ptr, rec_cnt,
                opt: RenderOptions):
    """Shade the recorded leaves -> premultiplied rgba [R, 4]
    (_shade_rows; rt_core.cuh:272-332): f16 row, masked basis, sigmoid,
    count-weighted sum / spp."""
    R, spp = rec_ptr.shape
    w = rec_cnt.to(F32)
    spp_t = _t(float(spp), w)
    alpha = w.sum(1) / spp_t
    vals = tree.data[rec_ptr.to(torch.int64)].to(F32)  # [R, spp, dd]
    if tree.basis_dim >= 0:
        bd = tree.basis_dim
        basis = _masked_basis(tree, vdirs, opt)
        coeffs = vals[..., :3 * bd].reshape(R, spp, 3, bd)
        logits = (coeffs * basis[:, None, None, :]).sum(-1)
        rgb_per_leaf = torch.sigmoid(logits)
    else:
        rgb_per_leaf = vals[..., :3]
    rgb = (rgb_per_leaf * w[..., None]).sum(1) / spp_t
    return torch.cat([rgb, alpha[:, None]], dim=1)


def composite(out, width: int, height: int, background: float,
              mesh_color=None):
    """Background or mesh compositing (volrend.cu:173-184).  out: [R, 4]
    premultiplied rgb + alpha, mesh_color [R, 3] or None -> (img [H, W, 4],
    composited rows [R, 4])."""
    nalpha = 1.0 - out[:, 3]
    behind = mesh_color if mesh_color is not None else background
    rgb = out[:, :3] + behind * nalpha[:, None]
    outc = torch.cat([rgb, out[:, 3:4]], dim=1)
    img = torch.cat([rgb, torch.ones_like(out[:, 3:4])], dim=1).reshape(
        height, width, 4)
    return img, outc


def aux_from_composite(outc, width: int, height: int, layout: str = "chw"):
    """The 8-channel aux buffer [rgba, rgba^2] (volrend.cu:186-202): "chw"
    [8, H, W] (the write_buffer contract) or "nhwc" [H, W, 8] (the
    denoiser's input)."""
    aux = torch.cat([outc, outc * outc], dim=-1)
    if layout == "nhwc":
        return aux.reshape(height, width, 8)
    return aux.T.reshape(8, height, width).contiguous()


def render_noisy_plain(tree: DeviceTree, transform: torch.Tensor,
                       rng_state: int, rng_inc: int, *, width: int,
                       height: int, fx: float, fy: float,
                       opt: RenderOptions, max_steps: int = 8192,
                       want_aux: bool = True, stats: Optional[dict] = None,
                       mesh_color=None, mesh_depth=None):
    """Plain version of kernel K1 (either estimator).  Returns (img
    [H, W, 4], aux_nhwc [H, W, 8], aux_chw [8, H, W] or None).
    ``mesh_color`` [R, 3] and ``mesh_depth`` [R] (both or neither): a mesh
    pass.  ``stats`` (render_stats' plain path) receives the march's
    ``"steps"`` [R] and, in its masks, what the frame reads
    (tree_query_full's ``touched`` plus ``"data"`` [M], the rows
    shaded)."""
    R = width * height
    spp = int(opt.spp)
    dirs, cens = device_camera_rays(transform, width, height, fx, fy)
    vdirs = rodrigues(opt.rot_dirs, dirs)
    wdirs, wcens = maybe_world2ndc(tree, dirs, cens)
    tmax_bg = (None if mesh_depth is None
               else torch.clamp(mesh_depth, max=1e9))
    if opt.estimator == "classic":  # deterministic: no PCG32 draws
        out, steps = march_classic_plain(tree, wdirs, vdirs, wcens, opt,
                                         max_steps, stats, tmax_bg)
    else:
        uniforms = pcg32_uniforms_range(
            rng_state, n=R * spp, inc=rng_inc,
            device=transform.device).reshape(R, spp)
        dst = make_sorted_dst(uniforms)
        rec_ptr, rec_cnt, steps = march_plain(tree, wdirs, wcens, dst, opt,
                                              max_steps, stats, tmax_bg)
        if stats is not None:
            stats["data"][rec_ptr[rec_cnt > 0].to(torch.int64)] = True
        out = shade_plain(tree, vdirs, rec_ptr, rec_cnt, opt)
    if stats is not None:
        stats["steps"] = steps
    img, outc = composite(out, width, height,
                          float(opt.background_brightness), mesh_color)
    aux_chw = aux_from_composite(outc, width, height) if want_aux else None
    return img, aux_from_composite(outc, width, height, "nhwc"), aux_chw


# ---------------------------------------------------------------------------
# kernel K1
# ---------------------------------------------------------------------------

_V, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int


class _RenderParams(ctypes.Structure):
    """Mirror of RenderParams in csrc/render.cu."""
    _fields_ = [
        ("transform", _V), ("chs", _V), ("data", _V), ("lut", _V),
        ("offset", _V), ("scale", _V), ("extra", _V), ("img", _V),
        ("aux_nhwc", _V), ("aux_chw", _V), ("uniforms", _V),
        ("stat_steps", _V), ("stat_descents", _V),
        ("lut_bits", _V), ("chs_bits", _V), ("data_bits", _V),
        ("mesh_color", _V), ("mesh_depth", _V),
        ("rng_state", ctypes.c_uint64), ("rng_inc", ctypes.c_uint64),
        ("fx", _F), ("fy", _F), ("step_size", _F), ("sigma_thresh", _F),
        ("background", _F), ("stop_thresh", _F), ("bbox", _F * 6),
        ("rot", _F * 3), ("ndc_ax", _F), ("ndc_ay", _F),
        ("width", _I), ("height", _I), ("spp", _I), ("max_steps", _I),
        ("N", _I), ("lut_levels", _I), ("max_depth", _I), ("skip_cap", _I),
        ("basis_dim", _I), ("data_dim", _I), ("fmt", _I), ("basis_lo", _I),
        ("basis_hi", _I), ("use_ndc", _I), ("classic", _I),
    ]


SPP_KERNEL = (1, 2, 3, 4, 6, 8, 16, 32)  # csrc/render.cu:rt_render

_render_fn = None


def _render_entry():
    """The bound ``rt_render`` entry; the first call also checks that the
    loaded library's RenderParams has the ctypes mirror's size."""
    global _render_fn
    if _render_fn is None:
        if native.entry("rt_render_params_size")() != \
                ctypes.sizeof(_RenderParams):
            raise RuntimeError("RenderParams layout differs between "
                               "csrc/render.cu and its ctypes mirror")
        _render_fn = native.entry("rt_render")
    return _render_fn


def _check_mesh(mesh_color, mesh_depth, R: int, dev) -> None:
    for t, shape, name in ((mesh_color, (R, 3), "mesh_color"),
                           (mesh_depth, (R,), "mesh_depth")):
        if (t.device != dev or t.dtype != F32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"render_noisy: {name} must be a contiguous f32 "
                             f"{list(shape)} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _launch_k1(tree: DeviceTree, transform: torch.Tensor, rng_state: int,
               rng_inc: int, width: int, height: int, fx: float, fy: float,
               opt: RenderOptions, max_steps: int, want_aux: bool,
               uniforms_out: Optional[torch.Tensor],
               stats: Optional[tuple] = None, mesh_color=None,
               mesh_depth=None):
    """Check the inputs, launch K1 (``render_classic`` for the classic
    estimator) on the tree's CUDA device and return (img, aux_nhwc,
    aux_chw or None).  ``stats``: the statistics variant's buffers (steps,
    descents, lut_bits, chs_bits, data_bits)."""
    dev = tree.device
    spp = int(opt.spp)
    classic = opt.estimator == "classic"
    if dev.type != "cuda" or transform.device != dev:
        raise ValueError(f"render_noisy: tree on {dev}, transform on "
                         f"{transform.device}")
    if (transform.dtype != F32 or tuple(transform.shape) != (3, 4)
            or not transform.is_contiguous()):
        raise ValueError("render_noisy: transform must be a contiguous f32 "
                         "[3, 4] tensor")
    if (not classic and spp not in SPP_KERNEL) or tree.basis_dim > 25 \
            or tree.chs.dtype != torch.int32 or tree.data.dtype != torch.float16:
        raise ValueError(f"render_noisy: unsupported spp {spp} / basis_dim "
                         f"{tree.basis_dim} / tree dtypes")
    if width < 1 or height < 1:
        raise ValueError(f"render_noisy: image {width}x{height}")
    R = width * height
    if (mesh_color is None) != (mesh_depth is None):
        raise ValueError("render_noisy: mesh_color and mesh_depth go "
                         "together")
    if mesh_color is not None:
        _check_mesh(mesh_color, mesh_depth, R, dev)
    img = torch.empty((height, width, 4), dtype=F32, device=dev)
    aux_nhwc = torch.empty((height, width, 8), dtype=F32, device=dev)
    aux_chw = (torch.empty((8, height, width), dtype=F32, device=dev)
               if want_aux else None)
    if uniforms_out is not None and (
            uniforms_out.device != dev or uniforms_out.dtype != F32
            or tuple(uniforms_out.shape) != (R, spp)
            or not uniforms_out.is_contiguous()):
        raise ValueError("render_noisy: uniforms_out must be a contiguous "
                         f"f32 [{R}, {spp}] tensor on {dev}")
    p = _RenderParams()
    p.transform = transform.data_ptr()
    p.chs = tree.chs.data_ptr()
    p.data = tree.data.data_ptr()
    p.lut = tree.lut.data_ptr() if tree.lut.numel() else None
    p.offset = tree.offset.data_ptr()
    p.scale = tree.scale.data_ptr()
    p.extra = tree.extra.data_ptr() if tree.extra.numel() else None
    p.img = img.data_ptr()
    p.aux_nhwc = aux_nhwc.data_ptr()
    p.aux_chw = aux_chw.data_ptr() if aux_chw is not None else None
    p.uniforms = (uniforms_out.data_ptr() if uniforms_out is not None
                  else None)
    if mesh_color is not None:
        p.mesh_color = mesh_color.data_ptr()
        p.mesh_depth = mesh_depth.data_ptr()
    if stats is not None:
        (p.stat_steps, p.stat_descents, p.lut_bits, p.chs_bits,
         p.data_bits) = (t.data_ptr() for t in stats)
    p.rng_state = rng_state
    p.rng_inc = rng_inc
    p.fx, p.fy = fx, fy
    p.step_size = opt.step_size
    p.sigma_thresh = opt.sigma_thresh
    p.background = opt.background_brightness
    p.stop_thresh = opt.stop_thresh
    p.bbox[:] = [float(v) for v in opt.render_bbox]
    p.rot[:] = [float(v) for v in opt.rot_dirs]
    if tree.ndc is not None:
        w, h, focal = tree.ndc
        p.ndc_ax, p.ndc_ay = -((2 * focal) / w), -((2 * focal) / h)
        p.use_ndc = 1
    p.width, p.height, p.spp, p.max_steps = width, height, spp, max_steps
    p.N, p.lut_levels, p.max_depth = tree.N, tree.lut_levels, tree.max_depth
    p.skip_cap = tree.skip_cap
    p.basis_dim, p.data_dim, p.fmt = tree.basis_dim, tree.data_dim, tree.fmt
    p.basis_lo, p.basis_hi = (int(v) for v in opt.basis_minmax)
    p.classic = int(classic)
    fn = _render_entry()
    with torch.cuda.device(dev):
        rc = fn(ctypes.addressof(p), native.stream_ptr(dev))
        native.count_launch("render_classic" if classic else "render")
    native.check(rc, "render_classic_kernel" if classic else "render_kernel")
    return img, aux_nhwc, aux_chw


def render_noisy(tree: DeviceTree, transform: torch.Tensor, rng_state: int,
                 rng_inc: int, *, width: int, height: int, fx: float,
                 fy: float, opt: RenderOptions, max_steps: int = 8192,
                 want_aux: bool = True,
                 uniforms_out: Optional[torch.Tensor] = None,
                 mesh_color: Optional[torch.Tensor] = None,
                 mesh_depth: Optional[torch.Tensor] = None):
    """Kernel K1 wrapper: one frame's (img [H, W, 4], aux_nhwc [H, W, 8],
    aux_chw [8, H, W] or None), by the estimator ``opt.estimator``.  CPU
    tensors take render_noisy_plain; on a CUDA device the kernel runs.
    ``uniforms_out`` ([H*W, spp] f32) also receives the kernel's raw PCG32
    uniforms; ``mesh_color`` [H*W, 3] and ``mesh_depth`` [H*W] (f32, on
    the tree's device) composite a mesh pass."""
    if tree.device.type == "cpu":
        return render_noisy_plain(
            tree, transform, rng_state, rng_inc, width=width, height=height,
            fx=fx, fy=fy, opt=opt, max_steps=max_steps, want_aux=want_aux,
            mesh_color=mesh_color, mesh_depth=mesh_depth)
    return _launch_k1(tree, transform, rng_state, rng_inc, width, height, fx,
                      fy, opt, max_steps, want_aux, uniforms_out,
                      mesh_color=mesh_color, mesh_depth=mesh_depth)


@dataclasses.dataclass
class MarchStats:
    """What one frame's march did (``render_stats``)."""

    steps: torch.Tensor  # [H, W] i32 leaf steps per ray
    descents: torch.Tensor  # [H, W] i32 chs reads per ray
    lut_cells: int  # distinct LUT cells read
    chs_rows: int  # distinct chs rows read
    data_rows: int  # distinct data rows shaded

    def equals(self, other: "MarchStats") -> bool:
        return (torch.equal(self.steps, other.steps)
                and torch.equal(self.descents, other.descents)
                and (self.lut_cells, self.chs_rows, self.data_rows)
                == (other.lut_cells, other.chs_rows, other.data_rows))


def _popcount(bits: torch.Tensor) -> int:
    table = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int64, device=bits.device)
    return int(table[bits.view(torch.uint8).to(torch.int64)].sum())


def render_stats_plain(tree: DeviceTree, transform: torch.Tensor,
                       rng_state: int, rng_inc: int, *, width: int,
                       height: int, fx: float, fy: float, opt: RenderOptions,
                       max_steps: int = 8192) -> MarchStats:
    """Plain version of render_stats: the plain march on the tree's own
    device, counting the same steps, descents, cells and rows."""
    R, M = width * height, tree.chs.shape[0]
    dev = tree.device
    st = {"lut": torch.zeros(tree.lut.shape[0], dtype=torch.bool,
                             device=dev),
          "chs": torch.zeros(M, dtype=torch.bool, device=dev),
          "data": torch.zeros(M, dtype=torch.bool, device=dev),
          "descents": torch.zeros(R, dtype=torch.int32, device=dev)}
    render_noisy_plain(tree, transform, rng_state, rng_inc, width=width,
                       height=height, fx=fx, fy=fy, opt=opt,
                       max_steps=max_steps, want_aux=False, stats=st)
    return MarchStats(st["steps"].reshape(height, width),
                      st["descents"].reshape(height, width),
                      int(st["lut"].sum()), int(st["chs"].sum()),
                      int(st["data"].sum()))


def render_stats(tree: DeviceTree, transform: torch.Tensor, rng_state: int,
                 rng_inc: int, *, width: int, height: int, fx: float,
                 fy: float, opt: RenderOptions,
                 max_steps: int = 8192) -> MarchStats:
    """K1's statistics variant on one frame, for either estimator (the
    frame's pixels are the same as render_noisy's and are dropped).  CPU
    tensors take render_stats_plain."""
    R, M = width * height, tree.chs.shape[0]
    dev = tree.device
    if dev.type == "cpu":
        return render_stats_plain(tree, transform, rng_state, rng_inc,
                                  width=width, height=height, fx=fx, fy=fy,
                                  opt=opt, max_steps=max_steps)

    def bitmap(n):
        return torch.zeros((n + 31) // 32, dtype=torch.int32, device=dev)
    bufs = (torch.empty(R, dtype=torch.int32, device=dev),
            torch.empty(R, dtype=torch.int32, device=dev),
            bitmap(max(tree.lut.shape[0], 1)), bitmap(M), bitmap(M))
    _launch_k1(tree, transform, rng_state, rng_inc, width, height, fx, fy,
               opt, max_steps, False, None, bufs)
    return MarchStats(bufs[0].reshape(height, width),
                      bufs[1].reshape(height, width),
                      *(_popcount(b) for b in bufs[2:]))


def lane_efficiency(steps: torch.Tensor, tile_w: int, tile_h: int) -> float:
    """SIMT lane efficiency of a march that gives each warp one fixed
    tile_w x tile_h tile of pixels (32 lanes) and runs it until its longest
    ray ends: sum of steps / sum over warps of 32 x the warp's most steps.
    ``steps``: [H, W]; lanes past the image's edge count as idle.  Tiles of
    32x1 are rows of 32, one thread per pixel in row order when W % 32 ==
    0."""
    if tile_w * tile_h != 32:
        raise ValueError(f"a warp tile has 32 lanes, not {tile_w}x{tile_h}")
    H, W = steps.shape
    Hp, Wp = -(-H // tile_h) * tile_h, -(-W // tile_w) * tile_w
    s = torch.zeros((Hp, Wp), dtype=torch.int64, device=steps.device)
    s[:H, :W] = steps
    warps = s.reshape(Hp // tile_h, tile_h, Wp // tile_w, tile_w)
    busy = 32 * int(warps.amax(dim=(1, 3)).sum())
    return int(s.sum()) / busy if busy else 1.0


# ---------------------------------------------------------------------------
# the Renderer
# ---------------------------------------------------------------------------

class Renderer:
    """Frame renderer owning the per-frame RNG protocol (render_context.hpp
    :14-16): PCG32 seeded with 20230418, advanced by 2^32 per frame by the
    caller through ``advance_rng`` (main_headless.cpp:506).

    ``render_scale`` in (0, 1] turns on fast mode below 1: K1 marches at
    the inner size ``max(1, round(size * render_scale))`` (Python's round,
    half to even, as the JAX package) with fx, fy scaled by inner / output,
    and K4 joint-upsamples its image and aux to the output size before the
    net and K2 (_render_frame_impl, :1280-1305).

    ``n_chunks``, ``schedule`` and ``shade_cap_div`` tune the JAX
    package's compaction schedule; the port's march has none, so they are
    accepted and ignored.
    """

    def __init__(self, tree: DeviceTree, width: int, height: int, fx: float,
                 fy: float, options: Optional[RenderOptions] = None,
                 n_chunks: int = 0, max_steps: int = 8192,
                 seed: int = 20230418, schedule=None, shade_cap_div: int = 4,
                 render_scale: float = 1.0):
        if not 0.0 < render_scale <= 1.0:
            raise ValueError("render_scale must be in (0, 1]")
        self.tree = tree
        self.device = tree.device
        self.width = width
        self.height = height
        self.render_scale = float(render_scale)
        if render_scale < 1.0:
            self.inner_width = max(1, round(width * render_scale))
            self.inner_height = max(1, round(height * render_scale))
        else:
            self.inner_width, self.inner_height = width, height
        self.fx = float(fx)
        self.fy = float(fy)
        self.options = options or RenderOptions()
        self.options.validate()
        self.max_steps = max_steps
        self.rng = Pcg32(seed)
        self.net = None
        self.net_cfg = None
        self.denoise_recommended = True
        self._grid_mesh = None

    @property
    def fast(self) -> bool:
        """Fast mode: K1 marches at another size than the output's."""
        return (self.inner_width, self.inner_height) != (self.width,
                                                         self.height)

    def set_denoiser(self, cfg_or_path, params=None) -> None:
        """Attach a compact GuidanceNet: a ``.gnet`` path (its
        ``denoise_recommended`` advice is surfaced on the attribute, never
        applied implicitly), or (cfg, Flax-layout params)."""
        if isinstance(cfg_or_path, (str, bytes, os.PathLike)):
            self.net, meta = load_model(cfg_or_path, self.device)
            self.denoise_recommended = bool(
                meta.get("denoise_recommended", True))
        else:
            self.net = build_compact(cfg_or_path, params, self.device)
            self.denoise_recommended = True
        self.net_cfg = self.net.config

    def advance_rng(self):
        self.rng.advance()

    def _transform(self, transform) -> torch.Tensor:
        t = np.ascontiguousarray(np.asarray(transform, np.float32)[:3, :4])
        return torch.from_numpy(t).to(self.device)

    def _mesh_inputs(self, mesh_color, mesh_depth):
        """A mesh pass [H, W, 3] / [H, W] (used only when both are given)
        -> K1's inputs [r, 3] / [r] at the march's size on the device; fast
        mode samples the full-size pass at the inner size by JAX's nearest
        rule.  (None, None) without a pass."""
        if mesh_color is None or mesh_depth is None:
            return None, None
        H, W = self.height, self.width
        mc = torch.as_tensor(mesh_color, dtype=F32, device=self.device)
        md = torch.as_tensor(mesh_depth, dtype=F32, device=self.device)
        if mc.numel() != H * W * 3 or md.numel() != H * W:
            raise ValueError(f"mesh pass must be [{H}, {W}, 3] colour and "
                             f"[{H}, {W}] depth, got {tuple(mc.shape)} and "
                             f"{tuple(md.shape)}")
        mc, md = mc.reshape(H, W, 3), md.reshape(H, W)
        if self.fast:
            mc = downsample_nearest(mc, self.inner_height, self.inner_width)
            md = downsample_nearest(md, self.inner_height, self.inner_width)
        return mc.reshape(-1, 3).contiguous(), md.reshape(-1).contiguous()

    def render_noisy(self, transform, want_aux: bool = True,
                     mesh_color=None, mesh_depth=None):
        """K1 on this frame, then in fast mode K4 from the inner size:
        (img, aux_nhwc, aux_chw or None) at the output size."""
        mc, md = self._mesh_inputs(mesh_color, mesh_depth)
        iw, ih = self.inner_width, self.inner_height
        out = render_noisy(
            self.tree, self._transform(transform), self.rng.state,
            self.rng.inc, width=iw, height=ih,
            fx=self.fx * (iw / self.width), fy=self.fy * (ih / self.height),
            opt=self.options, max_steps=self.max_steps,
            want_aux=want_aux and not self.fast, mesh_color=mc,
            mesh_depth=md)
        if self.fast:
            return fast_upsample(out[1], self.height, self.width, want_aux)
        return out

    def net_forward(self, aux_nhwc):
        """GuidanceNet on the [H, W, 8] f32 aux as K1 (or K4) wrote it ->
        its last activation [1, 2L, H, W] in the net's dtype (on the card
        kernel K7's channels-last output), which kernel K2 splits into
        level weights and guidance itself."""
        with torch.inference_mode():
            return self.net.activation(aux_nhwc[None])

    def filter(self, act, img):
        return guided_filter(act, img, supports=self.net_cfg.supports())

    def render(self, transform, mesh_color=None, mesh_depth=None,
               want_aux: bool = True):
        """transform: [3, 4] c2w.  Returns (img [H, W, 4], aux [8, H, W] or
        None) on the tree's device, not synchronized.  With denoise on and
        a denoiser attached, img is the filtered output; aux always carries
        the noisy statistics.  mesh_color [H, W, 3] / mesh_depth [H, W]
        (render/raster.py) composite a mesh pass: its depth clips the rays
        and its colour is seen through the volume; ``show_grid`` adds the
        octree's wireframe to it."""
        if self.options.show_grid:
            mesh_color, mesh_depth = self._grid_mesh_pass(
                transform, mesh_color, mesh_depth)
        img, aux_nhwc, aux_chw = self.render_noisy(transform, want_aux,
                                                   mesh_color, mesh_depth)
        if self.options.denoise and self.net is not None:
            img = self.filter(self.net_forward(aux_nhwc), img)
        return img, aux_chw

    def probe_overlay(self, img, transform):
        """The lumisphere of the leaf at ``options.probe`` drawn over img
        (volrend.cu:100-134, 215-231)."""
        opt = self.options
        coeffs = retrieve_cursor_lumisphere(self.tree, opt.probe)
        return apply_probe_overlay(img, self.tree, self._transform(transform),
                                   coeffs, basis_minmax=opt.basis_minmax,
                                   probe_disp_size=opt.probe_disp_size)

    def render_with_probe(self, transform, **kw):
        """render() plus the lumisphere probe overlay when
        options.enable_probe is set."""
        img, aux = self.render(transform, **kw)
        if self.options.enable_probe:
            img = self.probe_overlay(img, transform)
        return img, aux

    def _grid_mesh_pass(self, transform, mesh_color, mesh_depth):
        """Rasterize the octree wireframe for show_grid
        (cuda_renderer.cpp:115-125), merged with any caller mesh pass: NumPy
        (color [H, W, 3], depth [H, W])."""
        if self._grid_mesh is None:
            raise RuntimeError(
                "options.show_grid requires set_grid_mesh(tree_host)")
        cam = Camera(width=self.width, height=self.height, fx=self.fx,
                     fy=self.fy)
        cam.set_pose(np.asarray(transform))
        bg = (np.asarray(mesh_color) if mesh_color is not None else np.full(
            3, self.options.background_brightness, np.float32))
        color, depth = rasterize_meshes([self._grid_mesh], cam,
                                        background=bg)
        if mesh_depth is not None:
            md = np.asarray(mesh_depth)
            closer = md < depth
            depth = np.where(closer, md, depth)
            color = np.where(closer[..., None], np.asarray(mesh_color),
                             color)
        return color, depth

    def set_grid_mesh(self, tree_host, max_depth: Optional[int] = None):
        """Build the wireframe mesh used by show_grid from the host tree."""
        verts = gen_wireframe(tree_host,
                              max_depth or self.options.grid_max_depth)
        n = verts.shape[0]
        self._grid_mesh = Mesh(verts, np.arange(n, dtype=np.int32), 2,
                               "grid", unlit=True)


def render_timed(renderer: Renderer, transform, timer, mesh_color=None,
                 mesh_depth=None, probe: bool = False) -> tuple:
    """Split-phase render for the phase report (utils/timer.py): T_RENDER
    around kernel K1 (with a mesh pass, and in fast mode K4 too), T_NET
    around the GuidanceNet forward, T_FILTER around kernel K2
    (render_context.hpp:122-213).  With ``probe`` and
    ``options.enable_probe`` the probe overlay is drawn on the final image.
    As in the JAX package, no grid pass runs here and a mesh pass under
    fast mode is refused (Renderer.render takes both)."""
    has_mesh = mesh_color is not None and mesh_depth is not None
    if renderer.fast and has_mesh:
        raise NotImplementedError(
            "render_timed: mesh compositing under fast mode is only "
            "wired through Renderer.render()")
    with timer.phase(T_RENDER):
        img, aux_nhwc, aux_chw = renderer.render_noisy(
            transform, mesh_color=mesh_color, mesh_depth=mesh_depth)
    if renderer.options.denoise and renderer.net is not None:
        with timer.phase(T_NET):
            act = renderer.net_forward(aux_nhwc)
        with timer.phase(T_FILTER):
            img = renderer.filter(act, img)
    if probe and renderer.options.enable_probe:
        img = renderer.probe_overlay(img, transform)
    timer.frame_done()
    return img, aux_chw
