"""Multi-level guided softmax filter (kernel K2) and its plain version.

Counterpart of rt_octree_tpu/ops/filtering.py; the reference kernel is
denoiser/extension/filtering.cu:108-228.  Per level l with support s
(window 2s+1) every pixel takes the softmax-weighted average of the noisy
rgb over its window, with logits from each neighbour's guidance value
stabilised by the window max; levels are blended by ``weight_map``.  A
support-0 level is an exact passthrough of the pixel, and alpha is 1.

Kernel K2 (csrc/filter.cu) takes the GuidanceNet's last activation
``x [1, 2L, H, W]`` (bf16, any strides) and splits it itself: the level
weights are ``softmax(x[:, :L])`` and the guidance is ``x[:, L:]``, both in
f32.  ``guided_filter`` dispatches on the device: ``guided_filter_act_plain``
(that split, then ``guided_filter_plain``, the exact path of the JAX
module) for CPU tensors, the kernel for CUDA tensors.

Training filters a batch and differentiates it (the JAX package's
``guided_filter_batch`` under ``jax.value_and_grad``, filtering.py:188-193,
with the window max under ``stop_gradient``).  ``guided_filter_batch`` is a
``torch.autograd.Function`` over f32 weight and guidance [B, L, H, W] and
the image [B, H, W, 4] (data: it gets no gradient).  On CUDA tensors its
forward is kernel K5 (``guided_filter_batch_fwd``), which also saves each
level's filtered rgb f, a stabiliser m and the denominator D taken against
it, and its backward is kernel K6 (``guided_filter_batch_bwd``); on CPU
tensors they are ``guided_filter_batch_plain`` and
``guided_filter_backward_plain``.  With the stabiliser a constant, per
level l of support s > 0,

    dL/dw_lp = G_p . f_lp,
    dL/dg_q  = sum_{p in N(q)} exp(g_q - m_p) (w_lp / D_p)
                               (G_p . x_q - G_p . f_lp),

where G_p = dL/dout_p (rgb); a support-0 level (f = x) gets no guidance
gradient.  The plain versions take m as the window max.  K5 and K6 work on
BATCH_TILE_W x BATCH_TILE_H tiles with one stabiliser a tile and level and
separable window sums, as the JAX package's fast path does with one a
frame; a tile whose staged values span GUARD_RANGE nats takes the
per-window form (csrc/filter.cu), and either way the function is the same.

Each kernel has a wide instance for what its unrolled ones do not take:
more than MAX_LEVELS levels or a support above MAX_SUPPORT (up to
WIDE_MAX_LEVELS and WIDE_MAX_SUPPORT: ``--kernel_levels`` up to 32 with
either ladder), and for K5 / K6 a B or B x L above MAX_GRID_Z.  The
wrappers choose on the host (``wide_plan``); the launch names gain
``_wide``.  A shape past the wide instances raises.  K2's wide instance
computes the form JAX's frame takes (the fast one) with K5's numerics: a
stabiliser a tile and level (``wide_tile``), separable
window sums, and the per-window form where a tile's staged guidance spans
GUARD_RANGE nats; its optional counter takes the guarded (tile, level)
pairs of ``wide_filter_tiles``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..native import build as native

MAX_LEVELS = 8  # csrc/filter.cu:kMaxLevels
MAX_SUPPORT = 8  # csrc/filter.cu:kMaxSupport (the ladder 1..L at L = 8)
# the wide instances (csrc/filter.cu:kWideMaxLevels, kWideMaxSupport): K2,
# K5 and K6 for more levels, larger supports and, for K5 / K6, batches
# whose B or B x L passes MAX_GRID_Z
WIDE_MAX_LEVELS, WIDE_MAX_SUPPORT = 64, 32
MAX_GRID_Z = 65535
# K5 / K6's output tile (csrc/filter.cu:kBatchTileW, kBatchTileH) and the
# guard: a tile and level whose staged values span GUARD_RANGE nats or more
# take the per-window form (the JAX package's FAST_SAFE_RANGE)
BATCH_TILE_W, BATCH_TILE_H = 40, 16
GUARD_RANGE = 60.0
# K2's wide instance's output tile (csrc/filter.cu), width x height: 32 x
# 32 up to a halo of WIDE_SMALL_R (the largest support), else 16 x 8
WIDE_TILE, WIDE_TILE_LARGE_R, WIDE_SMALL_R = (32, 32), (16, 8), 16
# the phases of K2 wide's statistics instance (csrc/filter.cu:w2_mark)
WIDE_STAT_PHASES = ("staging", "ranges", "prologue", "e_rgb", "row_sums",
                    "column_sums", "levels")
# the phases of K5 wide's statistics instance (csrc/filter.cu:K5Phase)
K5_WIDE_STAT_PHASES = ("rgb", "wait", "range", "e", "row_pass", "issue",
                       "column_pass", "guard")
# the phases of K6 wide's statistics instance (csrc/filter.cu:K6Phase)
K6_WIDE_STAT_PHASES = ("staging", "range", "e", "row_pass", "column_pass",
                       "guard")


def resolve_supports(L: int, supports) -> tuple:
    if supports is None:
        return tuple(range(1, L + 1))
    supports = tuple(int(s) for s in supports)
    if len(supports) != L or any(s < 0 for s in supports):
        raise ValueError(
            f"supports {supports} must list one non-negative support per "
            f"level (L={L})")
    return supports


def _level_sums(rgb: torch.Tensor, g: torch.Tensor, s: int):
    """One level of support s > 0 on a batch: [B, H, W, 3] rgb, [B, H, W]
    guidance -> (filtered rgb, window max m, denominator D)
    (filtering.py:_level_exact)."""
    H, W = g.shape[-2:]
    K = 2 * s + 1
    gp = F.pad(g, (s, s, s, s), value=float("-inf"))
    # a constant under autograd, as JAX's stop_gradient (filtering.py:64)
    gmax = F.max_pool2d(gp[:, None], K, stride=1)[:, 0].detach()
    ip = F.pad(rgb, (0, 0, s, s, s, s))
    num = torch.zeros_like(rgb)
    den = torch.zeros_like(g)
    for dy in range(K):
        for dx in range(K):
            k = torch.exp(gp[:, dy:dy + H, dx:dx + W] - gmax)
            den = den + k
            num = num + ip[:, dy:dy + H, dx:dx + W] * k[..., None]
    return num / den[..., None], gmax, den


def _level_exact(rgb: torch.Tensor, g: torch.Tensor, s: int) -> torch.Tensor:
    """One level: [H, W, 3] rgb, [H, W] guidance -> filtered [H, W, 3]."""
    return _level_sums(rgb[None], g[None], s)[0][0]


def guided_filter_plain(weight_map: torch.Tensor, guidance_map: torch.Tensor,
                        img_in: torch.Tensor, supports=None) -> torch.Tensor:
    """weight_map, guidance_map: [L, H, W]; img_in: [H, W, >=3].
    Returns [H, W, 4] with alpha == 1."""
    L = weight_map.shape[0]
    supports = resolve_supports(L, supports)
    rgb = img_in[..., :3]
    out = torch.zeros_like(rgb)
    for l, s in enumerate(supports):
        f = rgb if s == 0 else _level_exact(rgb, guidance_map[l], s)
        out = out + weight_map[l][..., None] * f
    alpha = torch.ones(out.shape[:-1] + (1,), dtype=out.dtype,
                       device=out.device)
    return torch.cat([out, alpha], dim=-1)


def split_activation(act: torch.Tensor):
    """The net's last activation [1, 2L, H, W] -> (weight, guidance)
    [L, H, W] f32: the softmax over the first L channels and the last L
    channels (GuidanceNetCompact.forward's split)."""
    L = act.shape[1] // 2
    x = act.float()
    return torch.softmax(x[:, :L], 1)[0], x[0, L:]


def guided_filter_act_plain(act: torch.Tensor, img_in: torch.Tensor,
                            supports=None) -> torch.Tensor:
    """Plain version of kernel K2: ``split_activation`` then
    ``guided_filter_plain``."""
    weight, guidance = split_activation(act)
    return guided_filter_plain(weight, guidance, img_in, supports)


def wide_plan(slices: int, L: int, supports) -> bool:
    """Whether K2, K5 or K6 take their wide instance: more than MAX_LEVELS
    levels, a support above MAX_SUPPORT, or more than MAX_GRID_Z
    ``slices`` (K5: the batch, K6: batch x levels; K2: 1)."""
    return L > MAX_LEVELS or max(supports) > MAX_SUPPORT or \
        slices > MAX_GRID_Z


def wide_tile(supports) -> tuple:
    """K2's wide instance's output tile (width, height)."""
    return WIDE_TILE if max(supports) <= WIDE_SMALL_R else WIDE_TILE_LARGE_R


def wide_filter_tiles(H: int, W: int, supports) -> int:
    """The (tile, level) pairs of a K2 wide call on an H x W image: the
    count its guard counter is a share of (support-0 levels have no
    guard)."""
    tw, th = wide_tile(supports)
    return -(-H // th) * -(-W // tw) * sum(1 for s in supports if s > 0)


def _check_levels(name: str, L: int, supports) -> None:
    if not 1 <= L <= WIDE_MAX_LEVELS or max(supports) > WIDE_MAX_SUPPORT:
        raise ValueError(f"{name}: the kernels take 1..{WIDE_MAX_LEVELS} "
                         f"levels of support <= {WIDE_MAX_SUPPORT}, got "
                         f"{supports}")


def guided_filter(act: torch.Tensor, img_in: torch.Tensor,
                  supports=None, guards=None) -> torch.Tensor:
    """Kernel K2 wrapper: the net's last activation ``act`` [1, 2L, H, W]
    and the noisy image ``img_in`` [H, W, 4] -> [H, W, 4] with alpha 1.
    CPU tensors take ``guided_filter_act_plain``; on a CUDA device ``act``
    is bf16 in any strides (read in place) and ``img_in`` contiguous f32.
    ``guards``: an int32 CUDA tensor to which the wide instance adds the
    (tile, level) pairs that took the guard (of ``wide_filter_tiles``);
    the unrolled instance computes the per-window form and adds none."""
    if img_in.device.type == "cpu":
        return guided_filter_act_plain(act, img_in, supports)
    if act.dim() != 4 or act.shape[0] != 1 or act.shape[1] % 2:
        raise ValueError(f"guided_filter: act must be [1, 2L, H, W], got "
                         f"{tuple(act.shape)}")
    L, H, W = act.shape[1] // 2, act.shape[2], act.shape[3]
    supports = resolve_supports(L, supports)
    if (act.device.type != "cuda" or act.device != img_in.device
            or act.dtype != torch.bfloat16):
        raise ValueError(f"guided_filter: act must be a bf16 CUDA tensor on "
                         f"{img_in.device}, got {act.dtype} on {act.device}")
    if (img_in.device.type != "cuda" or img_in.dtype != torch.float32
            or tuple(img_in.shape) != (H, W, 4)
            or not img_in.is_contiguous()):
        raise ValueError(f"guided_filter: img_in must be a contiguous f32 "
                         f"CUDA tensor of shape {(H, W, 4)}, got "
                         f"{img_in.dtype} {tuple(img_in.shape)} on "
                         f"{img_in.device}")
    _check_levels("guided_filter", L, supports)
    if wide_plan(1, L, supports):
        return _launch_wide(act, img_in, supports, _guard_ptr(guards))
    out = torch.empty((H, W, 4), dtype=torch.float32, device=img_in.device)
    sup = (ctypes.c_int * L)(*supports)
    _, sc, sh, sw = act.stride()
    with torch.cuda.device(img_in.device):
        rc = native.entry("rt_guided_filter")(
            act.data_ptr(), sc, sh, sw, img_in.data_ptr(), out.data_ptr(), L,
            ctypes.cast(sup, ctypes.c_void_p), H, W,
            native.stream_ptr(img_in.device))
        native.count_launch("guided_filter")
    native.check(rc, "guided_filter_kernel")
    return out


def _launch_wide(act, img_in, supports, guards: int, stats=None):
    """One launch of K2's wide instance (the checks are guided_filter's);
    ``stats`` (int64 [tiles, len(WIDE_STAT_PHASES)]) selects its
    statistics instance."""
    H, W = img_in.shape[:2]
    out = torch.empty((H, W, 4), dtype=torch.float32, device=img_in.device)
    sup = (ctypes.c_int * len(supports))(*supports)
    _, sc, sh, sw = act.stride()
    with torch.cuda.device(img_in.device):
        rc = native.entry("rt_guided_filter_wide")(
            act.data_ptr(), sc, sh, sw, img_in.data_ptr(), out.data_ptr(),
            guards, len(supports), ctypes.cast(sup, ctypes.c_void_p), H, W,
            0 if stats is None else stats.data_ptr(),
            native.stream_ptr(img_in.device))
        native.count_launch("guided_filter_wide")
    native.check(rc, "guided_filter_wide_kernel")
    return out


def guided_filter_wide_stats(act: torch.Tensor, img_in: torch.Tensor,
                             supports) -> tuple:
    """K2 wide's statistics instance (supports up to WIDE_SMALL_R, 32x32
    tiles) on guided_filter's CUDA inputs -> (out, {"tiles", per phase of
    WIDE_STAT_PHASES the clock64() cycles of a tile's thread 0, averaged
    over the tiles, and each phase's share of staging + ranges + prologue
    + levels})."""
    supports = tuple(supports)
    H, W = img_in.shape[:2]
    if img_in.device.type != "cuda" or max(supports) > WIDE_SMALL_R:
        raise ValueError("guided_filter_wide_stats: CUDA tensors and "
                         f"supports up to {WIDE_SMALL_R}")
    tw, th = WIDE_TILE
    tiles = -(-H // th) * -(-W // tw)
    st = torch.zeros((tiles, len(WIDE_STAT_PHASES)), dtype=torch.int64,
                     device=img_in.device)
    out = _launch_wide(act, img_in, supports, 0, st)
    cyc = st.double().mean(0).cpu()
    total = float(cyc[0] + cyc[1] + cyc[2] + cyc[6])
    return out, {"tiles": tiles,
                 "cycles_per_tile": dict(zip(WIDE_STAT_PHASES,
                                             map(float, cyc))),
                 "share": {k: float(c) / total
                           for k, c in zip(WIDE_STAT_PHASES, cyc)}}


# ---------------------------------------------------------------------------
# the batched filter for training: K5 (forward) and K6 (backward)
# ---------------------------------------------------------------------------

def guided_filter_batch_plain(weight: torch.Tensor, guidance: torch.Tensor,
                              img: torch.Tensor, supports=None) -> torch.Tensor:
    """Plain version of kernel K5: ``guided_filter_plain`` on each image,
    the batch in one pass (each image's operations are
    ``guided_filter_plain``'s, in its order).  weight, guidance
    [B, L, H, W]; img [B, H, W, >=3] -> [B, H, W, 4]."""
    L = weight.shape[1]
    supports = resolve_supports(L, supports)
    rgb = img[..., :3]
    out = torch.zeros_like(rgb)
    for l, s in enumerate(supports):
        f = rgb if s == 0 else _level_sums(rgb, guidance[:, l], s)[0]
        out = out + weight[:, l][..., None] * f
    alpha = torch.ones(out.shape[:-1] + (1,), dtype=out.dtype,
                       device=out.device)
    return torch.cat([out, alpha], dim=-1)


def guided_filter_backward_plain(grad_out: torch.Tensor,
                                 weight: torch.Tensor,
                                 guidance: torch.Tensor, img: torch.Tensor,
                                 supports=None):
    """Plain version of kernel K6: the closed-form gradients of
    ``guided_filter_batch`` (module doc) -> (dL/dweight, dL/dguidance),
    both [B, L, H, W].  grad_out [B, H, W, >=3] (only rgb is read)."""
    B, L, H, W = weight.shape
    supports = resolve_supports(L, supports)
    G, x = grad_out[..., :3], img[..., :3]
    gw = torch.empty_like(weight)
    gg = torch.zeros_like(guidance)
    for l, s in enumerate(supports):
        if s == 0:
            gw[:, l] = (G * x).sum(-1)
            continue
        K, g = 2 * s + 1, guidance[:, l]
        f, m, den = _level_sums(x, g, s)
        gf = (G * f).sum(-1)
        gw[:, l] = gf
        a = weight[:, l] / den
        u, v = G * a[..., None], a * gf
        # pixel q gathers from p = q + (dy - s, dx - s) in N(q); outside
        # the image m is +inf and u, v are 0, so the tap adds exp(-inf) * 0
        mp = F.pad(m, (s, s, s, s), value=float("inf"))
        up = F.pad(u, (0, 0, s, s, s, s))
        vp = F.pad(v, (s, s, s, s))
        acc = torch.zeros_like(g)
        for dy in range(K):
            for dx in range(K):
                k = torch.exp(g - mp[:, dy:dy + H, dx:dx + W])
                ux = (up[:, dy:dy + H, dx:dx + W] * x).sum(-1)
                acc = acc + k * (ux - vp[:, dy:dy + H, dx:dx + W])
        gg[:, l] = acc
    return gw, gg


def batch_tiles(B: int, H: int, W: int, supports) -> int:
    """The (tile, level) pairs of a K5 or K6 call: the count its guard
    counter is a share of (support-0 levels have no guard)."""
    tiles = -(-W // BATCH_TILE_W) * -(-H // BATCH_TILE_H) * B
    return tiles * sum(1 for s in supports if s > 0)


def _rows_strides(t: torch.Tensor):
    """(batch, level, row) element strides of a [B, L, H, W] tensor whose
    rows the kernels can read, else None: columns at stride 1 (or W = 1)."""
    if t.shape[-1] != 1 and t.stride(-1) != 1:
        return None
    return t.stride()[:3]


def _check_batch(name: str, weight, guidance, img, supports):
    """The kernels' contract: f32 CUDA tensors on one device, weight and
    guidance [B, L, H, W] at any batch, level and row strides with
    contiguous rows, img [B, H, W, 4] contiguous and 16-byte aligned,
    1..WIDE_MAX_LEVELS levels of support <= WIDE_MAX_SUPPORT."""
    B, L, H, W = weight.shape
    for t, shape in ((weight, (B, L, H, W)), (guidance, (B, L, H, W)),
                     (img, (B, H, W, 4))):
        if (t.device.type != "cuda" or t.device != weight.device
                or t.dtype != torch.float32 or tuple(t.shape) != shape
                or (_rows_strides(t) is None if t is not img else
                    not t.is_contiguous() or t.data_ptr() % 16)):
            raise ValueError(
                f"{name}: needs f32 CUDA tensors weight, guidance "
                f"{(B, L, H, W)} with contiguous rows and img {(B, H, W, 4)}"
                f" contiguous on one device, got {t.dtype} "
                f"{tuple(t.shape)} strides {t.stride()} on {t.device}")
    _check_levels(name, L, supports)


def _guard_ptr(guards) -> int:
    """The guard counter's address (0: none): an int32 CUDA tensor the
    kernel adds its guard tiles to."""
    if guards is None:
        return 0
    if guards.dtype != torch.int32 or guards.device.type != "cuda":
        raise ValueError("guards must be an int32 CUDA tensor")
    return guards.data_ptr()


def guided_filter_batch_fwd(weight: torch.Tensor, guidance: torch.Tensor,
                            img: torch.Tensor, supports=None, guards=None):
    """Kernel K5 wrapper -> (out [B, H, W, 4], saved): ``saved`` is
    (fm [B, L, H, W, 4] holding each level's filtered rgb f and the
    stabiliser m of its tile (the window max where the tile took the
    guard), den [B, L, H, W] the denominator D taken against m), what K6
    reads: exp(g_q - m_p) / D_p is the same for any m (support-0 levels
    leave theirs unwritten).  weight and guidance are read through their
    strides (rows contiguous).  ``guards``: an int32 CUDA tensor to which
    the kernel adds the (tile, level) pairs that took the guard (of
    ``batch_tiles``)."""
    if weight.dim() != 4:
        raise ValueError(f"guided_filter_batch: weight must be [B, L, H, W],"
                         f" got {tuple(weight.shape)}")
    B, L, H, W = weight.shape
    supports = resolve_supports(L, supports)
    _check_batch("guided_filter_batch", weight, guidance, img, supports)
    return _launch_batch_fwd(weight, guidance, img, supports,
                             _guard_ptr(guards))


def _launch_batch_fwd(weight, guidance, img, supports, guards: int,
                      stats=None):
    """One launch of K5, or of its wide instance where ``wide_plan`` says
    (the checks are guided_filter_batch_fwd's); ``stats`` (int64 [blocks,
    len(K5_WIDE_STAT_PHASES)]) selects the wide statistics instance."""
    B, L, H, W = weight.shape
    dev = img.device
    out = torch.empty((B, H, W, 4), dtype=torch.float32, device=dev)
    fm = torch.empty((B, L, H, W, 4), dtype=torch.float32, device=dev)
    den = torch.empty((B, L, H, W), dtype=torch.float32, device=dev)
    sup = (ctypes.c_int * L)(*supports)
    suffix = "_wide" if wide_plan(B, L, supports) else ""
    fn = native.entry("rt_guided_filter_batch" + suffix)
    extra = (0 if stats is None else stats.data_ptr(),) if suffix else ()
    with torch.cuda.device(dev):
        rc = fn(weight.data_ptr(), *_rows_strides(weight),
                guidance.data_ptr(), *_rows_strides(guidance),
                img.data_ptr(), out.data_ptr(), fm.data_ptr(),
                den.data_ptr(), guards, B, L,
                ctypes.cast(sup, ctypes.c_void_p), H, W, *extra,
                native.stream_ptr(dev))
        native.count_launch("guided_filter_batch" + suffix)
    native.check(rc, f"guided_filter_batch{suffix}_kernel")
    return out, (fm, den)


def guided_filter_batch_wide_stats(weight: torch.Tensor,
                                   guidance: torch.Tensor, img: torch.Tensor,
                                   supports) -> tuple:
    """K5 wide's statistics instance on guided_filter_batch_fwd's CUDA
    inputs where it takes the wide instance -> (out, (fm, den), {"blocks",
    per phase of K5_WIDE_STAT_PHASES the clock64() cycles of a block's
    thread 0 summed over its levels, averaged over the blocks, and each
    phase's share of their sum})."""
    B, L, H, W = weight.shape
    supports = resolve_supports(L, supports)
    _check_batch("guided_filter_batch", weight, guidance, img, supports)
    if not wide_plan(B, L, supports):
        raise ValueError("guided_filter_batch_wide_stats: the inputs take "
                         "K5's unrolled instance, not its wide one")
    blocks = B * -(-H // BATCH_TILE_H) * -(-W // BATCH_TILE_W)
    st = torch.zeros((blocks, len(K5_WIDE_STAT_PHASES)), dtype=torch.int64,
                     device=img.device)
    out, saved = _launch_batch_fwd(weight, guidance, img, supports, 0, st)
    cyc = st.double().mean(0).cpu()
    total = float(cyc.sum())
    return out, saved, {
        "blocks": blocks,
        "cycles_per_block": dict(zip(K5_WIDE_STAT_PHASES, map(float, cyc))),
        "share": {k: float(c) / total
                  for k, c in zip(K5_WIDE_STAT_PHASES, cyc)}}


def guided_filter_batch_bwd(grad_out: torch.Tensor, weight: torch.Tensor,
                            guidance: torch.Tensor, img: torch.Tensor,
                            saved, supports=None, guards=None):
    """Kernel K6 wrapper: grad_out [B, H, W, 4] and what K5 saved ->
    (dL/dweight, dL/dguidance), both [B, L, H, W]; weight and guidance as
    K5 takes them, ``guards`` as K5's."""
    supports = _check_bwd(grad_out, weight, guidance, img, saved, supports)
    return _launch_batch_bwd(grad_out, weight, guidance, img, *saved,
                             supports, _guard_ptr(guards))


def _check_bwd(grad_out, weight, guidance, img, saved, supports) -> tuple:
    """guided_filter_batch_bwd's checks of its inputs; returns the
    supports."""
    B, L, H, W = weight.shape
    supports = resolve_supports(L, supports)
    _check_batch("guided_filter_batch_bwd", weight, guidance, img, supports)
    fm, den = saved
    for t, shape in ((grad_out, (B, H, W, 4)), (fm, (B, L, H, W, 4)),
                     (den, (B, L, H, W))):
        if (t.device != weight.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"guided_filter_batch_bwd: needs a contiguous f32 tensor "
                f"{shape} on {weight.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    return supports


def _launch_batch_bwd(grad_out, weight, guidance, img, fm, den, supports,
                      guards: int, stats=None):
    """One launch of K6, or of its wide instance where ``wide_plan`` says
    (the checks are guided_filter_batch_bwd's); ``stats`` (int64 [blocks,
    len(K6_WIDE_STAT_PHASES)]) selects the wide statistics instance."""
    B, L, H, W = weight.shape
    dev = img.device
    gw = torch.empty((B, L, H, W), dtype=torch.float32, device=dev)
    gg = torch.empty((B, L, H, W), dtype=torch.float32, device=dev)
    sup = (ctypes.c_int * L)(*supports)
    suffix = "_wide" if wide_plan(B * L, L, supports) else ""
    fn = native.entry("rt_guided_filter_batch_bwd" + suffix)
    extra = (0 if stats is None else stats.data_ptr(),) if suffix else ()
    with torch.cuda.device(dev):
        rc = fn(grad_out.data_ptr(), weight.data_ptr(),
                *_rows_strides(weight), guidance.data_ptr(),
                *_rows_strides(guidance), img.data_ptr(), fm.data_ptr(),
                den.data_ptr(), gw.data_ptr(), gg.data_ptr(), guards, B, L,
                ctypes.cast(sup, ctypes.c_void_p), H, W, *extra,
                native.stream_ptr(dev))
        native.count_launch("guided_filter_batch_bwd" + suffix)
    native.check(rc, f"guided_filter_batch_bwd{suffix}_kernel")
    return gw, gg


def guided_filter_batch_bwd_wide_stats(grad_out: torch.Tensor,
                                       weight: torch.Tensor,
                                       guidance: torch.Tensor,
                                       img: torch.Tensor, saved,
                                       supports) -> tuple:
    """K6 wide's statistics instance on guided_filter_batch_bwd's CUDA
    inputs where it takes the wide instance -> (dL/dweight, dL/dguidance,
    {"blocks", per phase of K6_WIDE_STAT_PHASES the clock64() cycles of a
    block's thread 0, averaged over the blocks, and each phase's share of
    their sum})."""
    B, L, H, W = weight.shape
    supports = _check_bwd(grad_out, weight, guidance, img, saved, supports)
    if not wide_plan(B * L, L, supports):
        raise ValueError("guided_filter_batch_bwd_wide_stats: the inputs "
                         "take K6's unrolled instance, not its wide one")
    blocks = B * L * -(-H // BATCH_TILE_H) * -(-W // BATCH_TILE_W)
    st = torch.zeros((blocks, len(K6_WIDE_STAT_PHASES)), dtype=torch.int64,
                     device=img.device)
    gw, gg = _launch_batch_bwd(grad_out, weight, guidance, img, *saved,
                               supports, 0, st)
    cyc = st.double().mean(0).cpu()
    total = float(cyc.sum())
    return gw, gg, {
        "blocks": blocks,
        "cycles_per_block": dict(zip(K6_WIDE_STAT_PHASES, map(float, cyc))),
        "share": {k: float(c) / total
                  for k, c in zip(K6_WIDE_STAT_PHASES, cyc)}}


class _GuidedFilterBatch(torch.autograd.Function):
    """Forward K5, backward K6 on CUDA tensors; the plain versions on CPU
    tensors.  Gradients for weight and guidance only."""

    @staticmethod
    def forward(ctx, weight, guidance, img, supports):
        ctx.supports = supports
        if img.device.type == "cpu":
            ctx.save_for_backward(weight, guidance, img)
            return guided_filter_batch_plain(weight, guidance, img, supports)
        out, (fm, den) = guided_filter_batch_fwd(weight, guidance, img,
                                                 supports)
        ctx.save_for_backward(weight, guidance, img, fm, den)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        weight, guidance, img, *saved = ctx.saved_tensors
        if img.device.type == "cpu":
            gw, gg = guided_filter_backward_plain(grad_out, weight, guidance,
                                                  img, ctx.supports)
        else:
            gw, gg = guided_filter_batch_bwd(grad_out.contiguous(), weight,
                                             guidance, img, saved,
                                             ctx.supports)
        return gw, gg, None, None


def guided_filter_batch(weight: torch.Tensor, guidance: torch.Tensor,
                        img: torch.Tensor, supports=None) -> torch.Tensor:
    """The differentiable batched filter: weight, guidance [B, L, H, W]
    (f32 on CUDA), img [B, H, W, 4] -> [B, H, W, 4] with alpha 1.  CUDA
    tensors go through K5 / K6, which read weight and guidance in place
    (the net's channel slices; a tensor whose rows are not contiguous is
    copied first), img must be contiguous; CPU tensors go through the plain
    versions."""
    supports = resolve_supports(weight.shape[1], supports)
    if img.device.type != "cpu":
        weight, guidance = (t if _rows_strides(t) is not None
                            else t.contiguous() for t in (weight, guidance))
    return _GuidedFilterBatch.apply(weight, guidance, img, supports)
