"""Regular-tracking frame renderer in PyTorch with the fused render kernel.

Counterpart of rt_octree_tpu/render/renderer.py.  ``render_noisy`` is the
wrapper of kernel K1 (csrc/render.cu): one CUDA thread per pixel, a warp
per 8x4 pixel tile, does the ray setup, the PCG32 thresholds, the
leaf-step march over the jump LUT with empty-space skips, the
distinct-leaf shade, compositing and the aux buffers (volrend.cu:84-213,
rt_core.cuh:195-332).  ``render_stats`` runs K1's statistics
variant: per-ray step counts and the distinct LUT cells, chs rows and data
rows the frame reads.

``render_noisy_plain`` is its plain PyTorch version, the JAX package's
"thin" march: a ``while active.any()`` loop of one leaf step over every ray
(_march_body, renderer.py:200-268), then one shade of the recorded leaves
(_shade_rows, :757-779), ``composite`` and ``aux_from_composite``
(:1207-1231).  The compaction schedule, shade-on-death buffers and brick
rows of the JAX package are how XLA on a TPU marches, not what the frame
computes, and are not ported.

The plain version divides by 0-d tensors, never by Python scalars: on CUDA
PyTorch turns a division by a host scalar into a multiplication by its
reciprocal, which rounds differently from the kernel and the JAX package.

``Renderer`` owns the per-frame RNG protocol and the denoiser:
GuidanceNetCompact (cuDNN convs) hands its last bf16 activation to kernel
K2 (ops/filtering.py), which splits it into level weights and guidance.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..core.options import RenderOptions
from ..io.n3tree import BasisFormat
from ..models.guidance_net import build_compact, load_model
from ..native import build as native
from ..ops.filtering import guided_filter
from ..ops.sh import eval_asg_basis, eval_sg_basis, eval_sh_basis
from ..ops.traversal import DeviceTree, tree_query_full
from ..utils.rng import Pcg32, make_sorted_dst, pcg32_uniforms_range
from ..utils.timer import T_FILTER, T_NET, T_RENDER

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


def march_plain(tree: DeviceTree, dirs, cens, dst, opt: RenderOptions,
                max_steps: int = 8192, touched: Optional[dict] = None):
    """The leaf-step march over a ray batch (_init_march + _march_body).

    dirs/cens: [R, 3] world rays (already NDC-warped); dst: [R, SPP] sorted
    thresholds.  Returns the distinct-leaf records (ptr [R, SPP] i32,
    count [R, SPP] i32), slots filled in order, count 0 when unused, and
    the leaf steps per ray ([R] i32; 0 for a ray that misses the bbox).
    ``touched``: see ops/traversal.py:tree_query_full."""
    R, spp = dst.shape
    dev = dirs.device
    # _init_march (rt_core.cuh:195-240)
    cen_t = tree.offset[None, :] + tree.scale[None, :] * cens
    d_scaled = dirs * tree.scale[None, :]
    delta_scale = torch.ones(R, dtype=F32, device=dev) / _norm3(d_scaled)
    d_t = d_scaled * delta_scale[:, None]
    tmax_bg = torch.full((R,), 1e9, dtype=F32, device=dev) / delta_scale
    invdir = torch.ones_like(d_t) / (d_t + 1e-9)
    tmin, tmax = _dda_world(cen_t, invdir, tuple(opt.render_bbox))
    tmax = torch.minimum(tmax, tmax_bg)
    active = (tmax >= 0) & (tmin <= tmax)

    t = tmin
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


def composite(out, width: int, height: int, background: float):
    """Background compositing (volrend.cu:173-184).  out: [R, 4]
    premultiplied rgb + alpha -> (img [H, W, 4], composited rows [R, 4])."""
    nalpha = 1.0 - out[:, 3]
    rgb = out[:, :3] + background * nalpha[:, None]
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
                       want_aux: bool = True, stats: Optional[dict] = None):
    """Plain version of kernel K1.  Returns (img [H, W, 4], aux_nhwc
    [H, W, 8], aux_chw [8, H, W] or None).  ``stats`` (render_stats'
    plain path) receives the march's ``"steps"`` [R] and, in its masks,
    what the frame reads (tree_query_full's ``touched`` plus ``"data"``
    [M], the rows shaded)."""
    R = width * height
    spp = int(opt.spp)
    dirs, cens = device_camera_rays(transform, width, height, fx, fy)
    vdirs = rodrigues(opt.rot_dirs, dirs)
    wdirs, wcens = maybe_world2ndc(tree, dirs, cens)
    uniforms = pcg32_uniforms_range(rng_state, n=R * spp, inc=rng_inc,
                                    device=transform.device).reshape(R, spp)
    dst = make_sorted_dst(uniforms)
    rec_ptr, rec_cnt, steps = march_plain(tree, wdirs, wcens, dst, opt,
                                          max_steps, stats)
    if stats is not None:
        stats["steps"] = steps
        stats["data"][rec_ptr[rec_cnt > 0].to(torch.int64)] = True
    out = shade_plain(tree, vdirs, rec_ptr, rec_cnt, opt)
    img, outc = composite(out, width, height,
                          float(opt.background_brightness))
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
        ("rng_state", ctypes.c_uint64), ("rng_inc", ctypes.c_uint64),
        ("fx", _F), ("fy", _F), ("step_size", _F), ("sigma_thresh", _F),
        ("background", _F), ("bbox", _F * 6), ("rot", _F * 3),
        ("ndc_ax", _F), ("ndc_ay", _F),
        ("width", _I), ("height", _I), ("spp", _I), ("max_steps", _I),
        ("N", _I), ("lut_levels", _I), ("max_depth", _I), ("skip_cap", _I),
        ("basis_dim", _I), ("data_dim", _I), ("fmt", _I), ("basis_lo", _I),
        ("basis_hi", _I), ("use_ndc", _I),
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


def _launch_k1(tree: DeviceTree, transform: torch.Tensor, rng_state: int,
               rng_inc: int, width: int, height: int, fx: float, fy: float,
               opt: RenderOptions, max_steps: int, want_aux: bool,
               uniforms_out: Optional[torch.Tensor],
               stats: Optional[tuple] = None):
    """Check the inputs, launch K1 on the tree's CUDA device and return
    (img, aux_nhwc, aux_chw or None).  ``stats``: the statistics variant's
    buffers (steps, descents, lut_bits, chs_bits, data_bits)."""
    dev = tree.device
    spp = int(opt.spp)
    if dev.type != "cuda" or transform.device != dev:
        raise ValueError(f"render_noisy: tree on {dev}, transform on "
                         f"{transform.device}")
    if (transform.dtype != F32 or tuple(transform.shape) != (3, 4)
            or not transform.is_contiguous()):
        raise ValueError("render_noisy: transform must be a contiguous f32 "
                         "[3, 4] tensor")
    if spp not in SPP_KERNEL or tree.basis_dim > 25 \
            or tree.chs.dtype != torch.int32 or tree.data.dtype != torch.float16:
        raise ValueError(f"render_noisy: unsupported spp {spp} / basis_dim "
                         f"{tree.basis_dim} / tree dtypes")
    if width < 1 or height < 1:
        raise ValueError(f"render_noisy: image {width}x{height}")
    R = width * height
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
    if stats is not None:
        (p.stat_steps, p.stat_descents, p.lut_bits, p.chs_bits,
         p.data_bits) = (t.data_ptr() for t in stats)
    p.rng_state = rng_state
    p.rng_inc = rng_inc
    p.fx, p.fy = fx, fy
    p.step_size = opt.step_size
    p.sigma_thresh = opt.sigma_thresh
    p.background = opt.background_brightness
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
    fn = _render_entry()
    with torch.cuda.device(dev):
        rc = fn(ctypes.addressof(p), native.stream_ptr(dev))
        native.count_launch("render")
    native.check(rc, "render_kernel")
    return img, aux_nhwc, aux_chw


def render_noisy(tree: DeviceTree, transform: torch.Tensor, rng_state: int,
                 rng_inc: int, *, width: int, height: int, fx: float,
                 fy: float, opt: RenderOptions, max_steps: int = 8192,
                 want_aux: bool = True,
                 uniforms_out: Optional[torch.Tensor] = None):
    """Kernel K1 wrapper: one frame's (img [H, W, 4], aux_nhwc [H, W, 8],
    aux_chw [8, H, W] or None).  CPU tensors take render_noisy_plain; on a
    CUDA device the kernel runs.  ``uniforms_out`` ([H*W, spp] f32) also
    receives the kernel's raw PCG32 uniforms."""
    if tree.device.type == "cpu":
        return render_noisy_plain(
            tree, transform, rng_state, rng_inc, width=width, height=height,
            fx=fx, fy=fy, opt=opt, max_steps=max_steps, want_aux=want_aux)
    return _launch_k1(tree, transform, rng_state, rng_inc, width, height, fx,
                      fy, opt, max_steps, want_aux, uniforms_out)


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
    """K1's statistics variant on one frame (the frame's pixels are the
    same as render_noisy's and are dropped).  CPU tensors take
    render_stats_plain."""
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

    ``n_chunks``, ``schedule`` and ``shade_cap_div`` tune the JAX
    package's compaction schedule; the port's march has none, so they are
    accepted and ignored.
    """

    def __init__(self, tree: DeviceTree, width: int, height: int, fx: float,
                 fy: float, options: Optional[RenderOptions] = None,
                 n_chunks: int = 0, max_steps: int = 8192,
                 seed: int = 20230418, schedule=None, shade_cap_div: int = 4,
                 render_scale: float = 1.0):
        if render_scale != 1.0:
            raise NotImplementedError(
                "render_scale != 1 (fast mode, ROADMAP B11) is not ported "
                "yet; it comes with the fast-mode PR")
        self.tree = tree
        self.device = tree.device
        self.width = width
        self.height = height
        self.fx = float(fx)
        self.fy = float(fy)
        self.options = options or RenderOptions()
        self.options.validate()
        self.max_steps = max_steps
        self.rng = Pcg32(seed)
        self.net = None
        self.net_cfg = None
        self.denoise_recommended = True

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

    def _check_ported(self, mesh_color, mesh_depth) -> None:
        opt = self.options
        if opt.estimator != "rt":
            raise NotImplementedError(
                f"estimator {opt.estimator!r} (ROADMAP B12) is not ported "
                "yet; it comes with the classic-estimator PR")
        if mesh_color is not None or mesh_depth is not None \
                or opt.show_grid or opt.enable_probe:
            raise NotImplementedError(
                "mesh compositing, show_grid and enable_probe (ROADMAP B16) "
                "are not ported yet; they come with the mesh/grid/probe PR")

    def _transform(self, transform) -> torch.Tensor:
        t = np.ascontiguousarray(np.asarray(transform, np.float32)[:3, :4])
        return torch.from_numpy(t).to(self.device)

    def render_noisy(self, transform, want_aux: bool = True):
        """Kernel K1 on this frame: (img, aux_nhwc, aux_chw or None)."""
        return render_noisy(
            self.tree, self._transform(transform), self.rng.state,
            self.rng.inc, width=self.width, height=self.height, fx=self.fx,
            fy=self.fy, opt=self.options, max_steps=self.max_steps,
            want_aux=want_aux)

    def net_forward(self, aux_nhwc):
        """GuidanceNet on the [H, W, 8] aux -> its last activation
        [1, 2L, H, W] in the net's dtype, which kernel K2 splits into level
        weights and guidance itself."""
        with torch.inference_mode():
            return self.net.activation(aux_nhwc[None])

    def filter(self, act, img):
        return guided_filter(act, img, supports=self.net_cfg.supports())

    def render(self, transform, mesh_color=None, mesh_depth=None,
               want_aux: bool = True):
        """transform: [3, 4] c2w.  Returns (img [H, W, 4], aux [8, H, W] or
        None) on the tree's device, not synchronized.  With denoise on and
        a denoiser attached, img is the filtered output; aux always carries
        the noisy statistics."""
        self._check_ported(mesh_color, mesh_depth)
        img, aux_nhwc, aux_chw = self.render_noisy(transform, want_aux)
        if self.options.denoise and self.net is not None:
            img = self.filter(self.net_forward(aux_nhwc), img)
        return img, aux_chw


def render_timed(renderer: Renderer, transform, timer) -> tuple:
    """Split-phase render for the phase report (utils/timer.py): T_RENDER
    around kernel K1, T_NET around the GuidanceNet forward, T_FILTER around
    kernel K2 (render_context.hpp:122-213)."""
    renderer._check_ported(None, None)
    with timer.phase(T_RENDER):
        img, aux_nhwc, aux_chw = renderer.render_noisy(transform)
    if renderer.options.denoise and renderer.net is not None:
        with timer.phase(T_NET):
            act = renderer.net_forward(aux_nhwc)
        with timer.phase(T_FILTER):
            img = renderer.filter(act, img)
    timer.frame_done()
    return img, aux_chw
