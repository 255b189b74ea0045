"""The frame in row bands and the data- and row-parallel training step
(rt_octree_tpu/parallel/mesh.py twin), one process a rank.

``make_mesh`` lays the ranks out as the JAX package's 2-D ``("dp", "sp")``
mesh (``init_device_mesh``): dp = 2 when there is more than one rank and
their count is even, else 1; sp = n / dp.  Rank r, the flat index dp_index
* sp + sp_index as JAX flattens ``("dp", "sp")``, owns the frame rows
``[r H / n, (r + 1) H / n)`` (``band``).

The sharded frame (``make_sharded_frame_renderer``): each rank holds the
tree, uploaded on its own device (K3 there), and marches its band of rows
with kernel K1 (or ``render_classic``), whose band keeps every pixel's
frame row, so its ray and PCG32 stream are the whole frame's.  One
``all_gather`` of the bands' aux_nhwc gives every rank the noisy frame
(img is its rgb with alpha 1, as ``composite`` builds it); in fast mode K4
upsamples it there.  The denoiser runs on halo crops: kernel K7 is
``num_layers`` zero-padded 3x3 blocks and kernel K2 reads a 2s + 1 window
that leaves out what is past the image's edge, so a rank that runs K7 on
its rows plus ``halo(cfg) = num_layers + max(supports)`` rows each side
(clamped to the image) and K2 on that crop gets its own rows as the whole
frame's; a second ``all_gather`` assembles img.

The sharded ray tracer (``make_sharded_ray_tracer``,
``render_rays_sharded``): every rank holds the tree and gets the whole ray
batch; rank r traces the rays ``[r R / n, (r + 1) R / n)`` with
``trace_rays`` (K1's ray mode on the card), and one ``all_gather``
assembles the [R, 4] result on every rank.  A ray's result depends on that
ray alone, so it is the single process's bit for bit.  R must divide by n,
as the JAX package's sharding requires.

The training step (``make_sharded_train_step``) is the same function on
crops: the dp index picks B / dp images of the global batch, the sp index
H / sp image rows plus the halo; GuidanceNet and the batched filter (K5,
K6 in backward) run on the crop, the loss is the mean over the rank's own
rows, and DistributedDataParallel averages the gradients over the whole
group, the gradient of the global mean since every rank's share is equal.

Collectives are ``all_gather``, ``all_reduce`` and ``broadcast`` only,
which gloo also serves on CUDA tensors (several ranks on one card).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.nn.parallel import DistributedDataParallel

from ..core.options import RenderOptions
from ..models.guidance_net import (GuidanceNet, GuidanceNetCompact,
                                   GuidanceNetConfig, init_params,
                                   params_from_numpy)
from ..ops.filtering import guided_filter, guided_filter_batch
from ..ops.resize import fast_upsample
from ..ops.traversal import DeviceTree
from ..render.renderer import render_noisy, trace_rays
from ..utils.rng import make_sorted_dst
from ..train.metrics import smape_loss


# ---------------------------------------------------------------------------
# the mesh and the band geometry
# ---------------------------------------------------------------------------

def mesh_shape(n: int) -> tuple:
    """(dp, sp) of n ranks, the JAX package's rule."""
    dp = 2 if (n > 1 and n % 2 == 0) else 1
    return dp, n // dp


def make_mesh(n: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """The 2-D ``("dp", "sp")`` DeviceMesh over the process group's ranks
    (``n``, if given, must be the world size)."""
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"make_mesh: {n} ranks asked, the process group "
                         f"has {world}")
    return init_device_mesh(device_type, mesh_shape(world),
                            mesh_dim_names=("dp", "sp"))


def flat_rank(mesh: DeviceMesh) -> int:
    """The rank's place in ``("dp", "sp")`` flattened row-major."""
    return (mesh.get_local_rank("dp") * mesh.size(1)
            + mesh.get_local_rank("sp"))


def band(r: int, n: int, rows: int) -> tuple:
    """Rows [r0, r1) of part r of ``rows`` split in n equal parts."""
    return r * rows // n, (r + 1) * rows // n


def halo(cfg: GuidanceNetConfig) -> int:
    """Rows each side of a band that the net and the filter read: one a
    3x3 block, then the widest filter window's reach."""
    return cfg.num_layers + max(cfg.supports())


def crop(r0: int, r1: int, h: int, rows: int) -> tuple:
    """The band [r0, r1) widened by h rows each side, clamped to
    [0, rows)."""
    return max(0, r0 - h), min(rows, r1 + h)


def inner_size(n: int, width: int, height: int,
               render_scale: float) -> tuple:
    """(iw, ih) that K1 marches for an n-rank frame, with the JAX
    package's checks (mesh.py:131-140) as ValueError: ih and iw * ih must
    divide by n, and in fast mode H too."""
    if not 0.0 < render_scale <= 1.0:
        raise ValueError("render_scale must be in (0, 1]")
    iw = max(1, round(width * render_scale))
    ih = max(1, round(height * render_scale))
    if (iw * ih) % n or ih % n:
        raise ValueError(
            f"render_scale={render_scale} gives inner resolution "
            f"{iw}x{ih}; both ih and iw*ih must divide the device mesh "
            f"size {n} (H rows are sharded over ('dp', 'sp'))")
    if (iw, ih) != (width, height) and height % n:
        raise ValueError(
            f"fast mode upsamples to {width}x{height}, whose H={height} "
            f"rows must divide the device mesh size {n}")
    return iw, ih


def _all_gather_rows(part: torch.Tensor, n: int) -> torch.Tensor:
    """The n ranks' equal row parts, concatenated in rank order."""
    out = torch.empty((n * part.shape[0],) + tuple(part.shape[1:]),
                      dtype=part.dtype, device=part.device)
    dist.all_gather(list(out.chunk(n)), part.contiguous())
    return out


def _mark(marks, name: str) -> None:
    """Record a CUDA event named ``name`` on the current stream into
    ``marks`` (a list), when one is given."""
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))


# ---------------------------------------------------------------------------
# the sharded ray tracer
# ---------------------------------------------------------------------------

def make_sharded_ray_tracer(mesh: DeviceMesh, tree: DeviceTree,
                            opt: RenderOptions, max_steps: int = 512):
    """A tracer of a ray batch split over the mesh's ranks (the JAX
    package's make_sharded_ray_tracer).  ``tree`` is this rank's upload on
    its own device.  Returns ``trace(dirs, vdirs, cens, dst) -> [R, 4]``:
    the whole batch on every rank (tensors or arrays, f32 on any device),
    this rank's rays traced by ``trace_rays``, the result gathered on every
    rank's device.  Raises ValueError in every rank, before any traces,
    when the four inputs' rows differ or R does not divide by the ranks'
    count."""
    n = mesh.size()
    r = flat_rank(mesh)
    dev = tree.device

    def trace(dirs, vdirs, cens, dst):
        R = len(dirs)
        rows = [len(a) for a in (dirs, vdirs, cens, dst)]
        if rows != [R] * 4:
            raise ValueError("make_sharded_ray_tracer: dirs, vdirs, cens and "
                             f"dst have {rows} rays; they must all have R")
        if R % n:
            raise ValueError(f"make_sharded_ray_tracer: a batch of {R} rays "
                             f"should be divisible by {n}, the ranks of the "
                             "mesh")
        r0, r1 = band(r, n, R)
        part = trace_rays(tree, *(
            torch.as_tensor(a[r0:r1], dtype=torch.float32).to(dev)
            .contiguous() for a in (dirs, vdirs, cens, dst)), opt,
            max_steps=max_steps)
        return _all_gather_rows(part, n)

    return trace


def render_rays_sharded(mesh: DeviceMesh, tree: DeviceTree, dirs, vdirs,
                        cens, uniforms, opt: RenderOptions,
                        max_steps: int = 512):
    """The rays' [R, 4] from raw PCG32 uniforms [R, SPP] (the JAX
    package's render_rays_sharded): ``make_sorted_dst`` turns them into
    thresholds, then the sharded tracer."""
    dst = make_sorted_dst(torch.as_tensor(uniforms, dtype=torch.float32))
    return make_sharded_ray_tracer(mesh, tree, opt, max_steps)(
        dirs, vdirs, cens, dst)


# ---------------------------------------------------------------------------
# the sharded frame
# ---------------------------------------------------------------------------

def make_sharded_frame_renderer(mesh: DeviceMesh, tree: DeviceTree,
                                width: int, height: int, fx: float,
                                fy: float, opt: RenderOptions, inc: int = 3,
                                max_steps: int = 2048,
                                net: Optional[GuidanceNetCompact] = None,
                                render_scale: float = 1.0):
    """The whole frame with its rows marched in bands over the mesh's
    ranks.  ``tree`` is this rank's upload on its own device; ``net`` a
    GuidanceNetCompact there (``load_model`` or ``build_compact``), run
    when ``opt.denoise`` is set.  Returns ``render(transform, rng_state,
    marks=None) -> (img [H, W, 4], aux [8, H, W])`` on every rank's
    device, for the PCG32 state ``rng_state`` of the stream ``inc``;
    ``marks``, a list on a CUDA rank, receives CUDA events after the band
    march ("march"), the aux gather ("gather"), K4 ("upsample"), the
    denoise on the crop ("denoise") and the img gather ("gather_img")."""
    n = mesh.size()
    opt.validate()
    iw, ih = inner_size(n, width, height, render_scale)
    fast = (iw, ih) != (width, height)
    fx_in, fy_in = fx * (iw / width), fy * (ih / height)
    dev = tree.device
    if mesh.device_type != dev.type:
        raise ValueError(f"make_sharded_frame_renderer: a {mesh.device_type}"
                         f" mesh and a tree on {dev}")
    r = flat_rank(mesh)
    r0, r1 = band(r, n, ih)
    denoise = bool(opt.denoise) and net is not None
    if denoise:
        o0, o1 = band(r, n, height)
        c0, c1 = crop(o0, o1, halo(net.config), height)
        supports = net.config.supports()

    def render(transform, rng_state: int, marks=None):
        t = torch.as_tensor(np.ascontiguousarray(
            np.asarray(transform, np.float32)[:3, :4])).to(dev)
        _, part, _ = render_noisy(
            tree, t, rng_state, inc, width=iw, height=ih, fx=fx_in, fy=fy_in,
            opt=opt, max_steps=max_steps, want_aux=False, row0=r0,
            rows=r1 - r0)
        _mark(marks, "march")
        aux_nhwc = _all_gather_rows(part, n)
        _mark(marks, "gather")
        if fast:
            img, aux_nhwc, aux_chw = fast_upsample(aux_nhwc, height, width)
            _mark(marks, "upsample")
        else:
            img = torch.cat([aux_nhwc[..., :3],
                             torch.ones_like(aux_nhwc[..., 3:4])], dim=-1)
            aux_chw = aux_nhwc.permute(2, 0, 1).contiguous()
        if denoise:
            with torch.inference_mode():
                act = net.activation(aux_nhwc[None, c0:c1])
            own = guided_filter(act, img[c0:c1], supports)[o0 - c0:o1 - c0]
            _mark(marks, "denoise")
            img = _all_gather_rows(own, n)
            _mark(marks, "gather_img")
        return img, aux_chw

    return render


# ---------------------------------------------------------------------------
# the sharded training step
# ---------------------------------------------------------------------------

def make_sharded_train_step(mesh: DeviceMesh, cfg: GuidanceNetConfig,
                            lr: float = 1e-4, loss_fn=smape_loss,
                            params: Optional[dict] = None,
                            dtype: torch.dtype = torch.bfloat16):
    """Data-parallel (batch over dp) and row-parallel (image rows over sp)
    GuidanceNet training step on the mesh's ranks.  ``params``: Flax-layout
    NumPy params (default: Flax's init drawn with seed 0, as the Runner
    does); DistributedDataParallel broadcasts rank 0's.  ``dtype``: the
    net's compute type (bf16, as the JAX package and the Runner train).
    The optimizer is
    the JAX step's add_decayed_weights(5e-4) then adam(lr): torch Adam with
    weight_decay 5e-4, no schedule.  Returns (step, model, optimizer):
    ``step(aux [B, 8, H, W], img_in [B, H, W, 4], img_gt [B, H, W, >=3],
    marks=None) -> loss``, the global batch on every rank (any device),
    the mean loss over the whole batch, the same on every rank; ``marks``
    as the frame's, after the net's forward ("forward"), K5 and the loss
    ("filter_loss"), the backward with the gradients' all-reduce
    ("backward") and Adam ("adam")."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    dp, sp = mesh.size(0), mesh.size(1)
    dp_i, sp_i = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    world = dist.get_world_size()
    model = GuidanceNet(cfg, dtype=dtype)
    model.load_state_dict(params_from_numpy(cfg, params if params is not None
                                            else init_params(
                                                cfg, torch.Generator()
                                                .manual_seed(0))))
    model = model.to(dev)
    ddp = DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None)
    optimizer = torch.optim.Adam(ddp.parameters(), lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=5e-4)
    h, supports = halo(cfg), cfg.supports()

    def step(aux, img_in, img_gt, marks=None):
        B, _, H, _ = aux.shape
        if B % dp or H % sp:
            raise ValueError(f"sharded train step: batch {B} and height {H} "
                             f"must divide by the mesh's (dp, sp) = "
                             f"({dp}, {sp})")
        b0, b1 = band(dp_i, dp, B)
        r0, r1 = band(sp_i, sp, H)
        c0, c1 = crop(r0, r1, h, H)
        a = aux[b0:b1, :, c0:c1].to(dev)
        x = img_in[b0:b1, c0:c1].to(dev).contiguous()
        gt = img_gt[b0:b1, r0:r1].to(dev)
        optimizer.zero_grad(set_to_none=True)
        weight, guidance = ddp(a.permute(0, 2, 3, 1))
        _mark(marks, "forward")
        out = guided_filter_batch(weight, guidance, x, supports)
        loss = loss_fn(out[:, r0 - c0:r1 - c0, :, :3], gt[..., :3])
        _mark(marks, "filter_loss")
        loss.backward()
        _mark(marks, "backward")
        optimizer.step()
        _mark(marks, "adam")
        total = loss.detach().clone()
        dist.all_reduce(total)
        return total / world

    return step, model, optimizer
