"""The batched, differentiable guided filter of the training step (kernels
K5 and K6 and their plain versions) against the JAX package's
guided_filter_batch and its autodiff (jax.vjp), on the exact and the fast
path, and the autograd Function against torch.autograd.gradcheck; and a
NumPy statement of the kernels' tile algorithm held to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_octree_tpu.ops.filtering import guided_filter_batch as jax_batch
from rt_octree_tpu_torch.ops import filtering as tf

torch.set_num_threads(1)

B, L, H, W = 2, 3, 16, 20
LADDER, IDENTITY = (1, 2, 3), (0, 1, 2)
# f32 softmax sums of up to 49 taps in another order: the forward within
# 1e-5 (values in [0, 1]); the gradients within rtol 1e-4 plus atol 1e-5
FWD_TOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5


def _inputs(seed, gscale=3.0):
    rs = np.random.default_rng(seed)
    logits = rs.standard_normal((B, L, H, W)) * 2.0
    w = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    g = rs.standard_normal((B, L, H, W)) * gscale
    if gscale > 10:  # one window spans > 60 nats: JAX's exact fallback
        g[0, 1, 3, 4] = 70.0
        g[0, 1, 4, 4] = -5.0
    x = rs.random((B, H, W, 4))
    G = rs.standard_normal((B, H, W, 4))
    return tuple(a.astype(np.float32) for a in (w, g, x, G))


_VJPS = {}


def _jax_vjp(supports, exact):
    """A jitted (forward, vjp) of JAX's guided_filter_batch, one compile
    per support set and path, shared by the cases."""
    key = (supports, exact)
    if key not in _VJPS:
        def f(w, g, x, G):
            out, vjp = jax.vjp(lambda a, b: jax_batch(
                a, b, x, exact=exact, supports=supports), w, g)
            return (out,) + vjp(G)
        _VJPS[key] = jax.jit(f)
    return _VJPS[key]


CASES = [("ladder", LADDER, 3.0), ("identity", IDENTITY, 3.0),
         ("range > 60 nats", IDENTITY, 40.0)]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("label,supports,gscale", CASES,
                         ids=[c[0] for c in CASES])
def test_forward_and_backward_match_jax(label, supports, gscale, exact):
    """guided_filter_batch (the Function on CPU tensors: K5's plain
    version) against JAX's forward, and guided_filter_backward_plain
    (K6's) against jax.vjp of it; a window spanning > 60 nats takes JAX's
    exact fallback on the fast path."""
    w, g, x, G = _inputs(len(label), gscale)
    out_j, gw_j, gg_j = _jax_vjp(supports, exact)(w, g, x, G)
    t = torch.from_numpy
    out = tf.guided_filter_batch(t(w), t(g), t(x), supports)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=FWD_TOL)
    np.testing.assert_array_equal(out[..., 3].numpy(), 1.0)
    gw, gg = tf.guided_filter_backward_plain(t(G), t(w), t(g), t(x),
                                             supports)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(gg.numpy(), np.asarray(gg_j),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if 0 in supports:
        assert not gg[:, supports.index(0)].any()


@pytest.mark.parametrize("label,supports,gscale", CASES,
                         ids=[c[0] for c in CASES])
def test_backward_plain_matches_autograd(label, supports, gscale):
    """The closed form against torch autograd through the plain forward
    (the window max a constant there, as under JAX's stop_gradient)."""
    w, g, x, G = (torch.from_numpy(a) for a in _inputs(len(label), gscale))
    wr, gr = w.clone().requires_grad_(), g.clone().requires_grad_()
    out = tf.guided_filter_batch_plain(wr, gr, x, supports)
    out.backward(G)
    gw, gg = tf.guided_filter_backward_plain(G, w, g, x, supports)
    np.testing.assert_allclose(gw.numpy(), wr.grad.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(gg.numpy(), gr.grad.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_function_passes_gradcheck():
    """The autograd Function on CPU tensors (the plain versions) in f64 on
    an 8x8 case with a support-0 and a support-2 level: its gradients
    equal finite differences."""
    rs = np.random.default_rng(3)
    w = torch.from_numpy(rs.random((1, 2, 8, 8))).requires_grad_()
    g = torch.from_numpy(rs.standard_normal((1, 2, 8, 8)) * 2.0) \
        .requires_grad_()
    x = torch.from_numpy(rs.random((1, 8, 8, 4)))
    assert torch.autograd.gradcheck(
        lambda a, b: tf.guided_filter_batch(a, b, x, (0, 2)), (w, g))


def test_function_gives_no_image_gradient():
    """img is data: the Function returns gradients for weight and guidance
    only, and the CPU route launches no kernel."""
    from rt_octree_tpu_torch.native import build as native
    w, g, x, G = (torch.from_numpy(a) for a in _inputs(9))
    w.requires_grad_()
    g.requires_grad_()
    x.requires_grad_()
    native.reset_launches()
    tf.guided_filter_batch(w, g, x, LADDER).backward(G)
    assert x.grad is None and w.grad is not None and g.grad is not None
    assert native.LAUNCHES["guided_filter_batch"] == 0
    assert native.LAUNCHES["guided_filter_batch_bwd"] == 0


def test_kernel_wrappers_refuse_other_devices():
    """K5 / K6's wrappers take CUDA tensors only: a meta tensor is refused,
    never rerouted to the plain versions."""
    w = torch.zeros((1, 2, 4, 4), device="meta")
    x = torch.zeros((1, 4, 4, 4), device="meta")
    with pytest.raises(ValueError):
        tf.guided_filter_batch_fwd(w, w, x, (0, 1))
    with pytest.raises(ValueError):
        tf.guided_filter_batch_bwd(x, w, w, x, (w, w), (0, 1))


# ---------------------------------------------------------------------------
# A NumPy statement of K5's and K6's tile algorithm (csrc/filter.cu), with
# the tile size as a parameter, held to the JAX package and to the plain
# versions.  Per tile of TW x TH outputs and level of support s > 0, the
# staged region is the tile and a halo of s, clipped to the image.
#   K5: c = the largest guidance over the region, lo the smallest.  While
#       c - lo < GUARD_RANGE: e = exp(g - c) (0 outside the image), and the
#       window sums of (e rgb, e) are 2s+1 shifted adds along rows, then
#       along columns; the saved stabiliser m is c.  Else (the guard) the
#       per-window form: m = the window max, one exp a tap.
#   K6: c' = the smallest saved m over the region, hi the largest.  While
#       hi - c' < GUARD_RANGE: E = exp(c' - m_p), U, V = the same separable
#       sums of E (u, v), and dL/dg_q = exp(g_q - c') (x_q . U_q - V_q).
#       Else the per-tap gather sum_p exp(g_q - m_p) (u_p . x_q - v_p).
# ---------------------------------------------------------------------------

TILES = [(tf.BATCH_TILE_W, tf.BATCH_TILE_H), (8, 4), (7, 5)]
TILE_IDS = [f"{tw}x{th}" for tw, th in TILES]


def _staged(a, y0, x0, th, tw, s, fill):
    """Rows y0-s .. y0+th+s-1 and columns x0-s .. x0+tw+s-1 of a [H, W, ...]
    array, ``fill`` outside the image."""
    H, W = a.shape[:2]
    out = np.full((th + 2 * s, tw + 2 * s) + a.shape[2:], fill, a.dtype)
    ya, yb = max(y0 - s, 0), min(y0 + th + s, H)
    xa, xb = max(x0 - s, 0), min(x0 + tw + s, W)
    out[ya - y0 + s:yb - y0 + s, xa - x0 + s:xb - x0 + s] = a[ya:yb, xa:xb]
    return out


def _box_rows_cols(X, s, th, tw):
    """The kernels' separable window sums of a staged region: 2s+1 shifted
    adds along each row (left to right), then down each column."""
    h = X[:, 0:tw]
    for d in range(1, 2 * s + 1):
        h = h + X[:, d:d + tw]
    v = h[0:th]
    for d in range(1, 2 * s + 1):
        v = v + h[d:d + th]
    return v


def _window_max(g_r, s, th, tw):
    hm = g_r[:, 0:tw]
    for d in range(1, 2 * s + 1):
        hm = np.maximum(hm, g_r[:, d:d + tw])
    m = hm[0:th]
    for d in range(1, 2 * s + 1):
        m = np.maximum(m, hm[d:d + th])
    return m


def _tile_origins(H, W, tile):
    tw, th = tile
    return [(y0, x0) for y0 in range(0, H, th) for x0 in range(0, W, tw)]


def k5_statement(w, g, x, supports, tile):
    """-> out [B, H, W, 4], fm [B, L, H, W, 4] (f, m), den [B, L, H, W] and
    the set of (b, l, y0, x0) that took the guard."""
    B, L, H, W = w.shape
    tw, th = tile
    rgb = x[..., :3]
    out = np.zeros((B, H, W, 3), np.float32)
    fm = np.zeros((B, L, H, W, 4), np.float32)
    den = np.zeros((B, L, H, W), np.float32)
    guards = set()
    inf = np.float32(np.inf)
    for b in range(B):
        for l, s in enumerate(supports):
            if s == 0:
                f = rgb[b]
            else:
                f = np.zeros((H, W, 3), np.float32)
                for y0, x0 in _tile_origins(H, W, tile):
                    g_r = _staged(g[b, l], y0, x0, th, tw, s, -inf)
                    x_r = _staged(rgb[b], y0, x0, th, tw, s, np.float32(0))
                    inside = g_r > -inf
                    c, lo = g_r[inside].max(), g_r[inside].min()
                    if c - lo < tf.GUARD_RANGE:
                        e = np.exp(g_r - c)
                        X = np.concatenate([x_r * e[..., None],
                                            e[..., None]], -1)
                        V = _box_rows_cols(X, s, th, tw)
                        with np.errstate(invalid="ignore"):  # off-image
                            ft, dt = V[..., :3] / V[..., 3:], V[..., 3]
                        mt = np.full((th, tw), c, np.float32)
                    else:
                        guards.add((b, l, y0, x0))
                        with np.errstate(invalid="ignore"):
                            mt = _window_max(g_r, s, th, tw)
                            num = np.zeros((th, tw, 3), np.float32)
                            dt = np.zeros((th, tw), np.float32)
                            for dy in range(2 * s + 1):
                                for dx in range(2 * s + 1):
                                    k = np.exp(g_r[dy:dy + th, dx:dx + tw]
                                               - mt)
                                    dt = dt + k
                                    num = num + x_r[dy:dy + th,
                                                    dx:dx + tw] * k[..., None]
                            ft = num / dt[..., None]
                    ny, nx = min(th, H - y0), min(tw, W - x0)
                    f[y0:y0 + ny, x0:x0 + nx] = ft[:ny, :nx]
                    fm[b, l, y0:y0 + ny, x0:x0 + nx, 3] = mt[:ny, :nx]
                    den[b, l, y0:y0 + ny, x0:x0 + nx] = dt[:ny, :nx]
                fm[b, l, ..., :3] = f
            out[b] = out[b] + w[b, l][..., None] * f
    alpha = np.ones((B, H, W, 1), np.float32)
    return np.concatenate([out, alpha], -1), fm, den, guards


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def k6_statement(G, w, g, x, fm, den, supports, tile):
    """-> dL/dweight, dL/dguidance [B, L, H, W] and the set of
    (b, l, y0, x0) that took the guard."""
    B, L, H, W = w.shape
    tw, th = tile
    rgb, G = x[..., :3], G[..., :3]
    gw = np.zeros((B, L, H, W), np.float32)
    gg = np.zeros((B, L, H, W), np.float32)
    guards = set()
    inf = np.float32(np.inf)
    for b in range(B):
        for l, s in enumerate(supports):
            if s == 0:
                gw[b, l] = _dot3(G[b], rgb[b])
                continue
            gf = _dot3(G[b], fm[b, l])
            gw[b, l] = gf
            a = w[b, l] / den[b, l]
            uv = np.concatenate([G[b] * a[..., None], (a * gf)[..., None]],
                                -1)
            for y0, x0 in _tile_origins(H, W, tile):
                uv_r = _staged(uv, y0, x0, th, tw, s, np.float32(0))
                m_r = _staged(fm[b, l, ..., 3], y0, x0, th, tw, s, inf)
                inside = m_r < inf
                c, hi = m_r[inside].min(), m_r[inside].max()
                xq = _staged(rgb[b], y0, x0, th, tw, 0, np.float32(0))
                gq = _staged(g[b, l], y0, x0, th, tw, 0, np.float32(0))
                if hi - c < tf.GUARD_RANGE:
                    X = uv_r * np.exp(c - m_r)[..., None]
                    U = _box_rows_cols(X, s, th, tw)
                    acc = np.exp(gq - c) * (_dot3(xq, U) - U[..., 3])
                else:
                    guards.add((b, l, y0, x0))
                    acc = np.zeros((th, tw), np.float32)
                    for dy in range(2 * s + 1):
                        for dx in range(2 * s + 1):
                            p = uv_r[dy:dy + th, dx:dx + tw]
                            k = np.exp(gq - m_r[dy:dy + th, dx:dx + tw])
                            acc = acc + k * (_dot3(p, xq) - p[..., 3])
                ny, nx = min(th, H - y0), min(tw, W - x0)
                gg[b, l, y0:y0 + ny, x0:x0 + nx] = acc[:ny, :nx]
    return gw, gg, guards


def _spike_inputs(seed):
    """The ladder's inputs at gscale 3 with one guidance spike of 70 nats
    in image 0, level 1: the tiles whose staged region holds it need the
    guard, their neighbours do not."""
    w, g, x, G = _inputs(seed)
    g[0, 1, 3, 4] = 70.0
    return w, g, x, G


def _spike_tiles(H, W, tile, s, yx=(3, 4)):
    """The (y0, x0) of the tiles whose region (halo s) holds pixel yx."""
    tw, th = tile
    y, x = yx
    return {(y0, x0) for y0, x0 in _tile_origins(H, W, tile)
            if y0 - s <= y < y0 + th + s and x0 - s <= x < x0 + tw + s}


def _k6_guards(fm, supports, tile):
    """The (b, l, y0, x0) whose saved stabilisers span GUARD_RANGE nats
    over the tile and its halo."""
    B, L, H, W = fm.shape[:4]
    tw, th = tile
    out = set()
    for b in range(B):
        for l, s in enumerate(supports):
            for y0, x0 in _tile_origins(H, W, tile) if s else ():
                m_r = _staged(fm[b, l, ..., 3], y0, x0, th, tw, s,
                              np.float32(np.nan))
                if np.nanmax(m_r) - np.nanmin(m_r) >= tf.GUARD_RANGE:
                    out.add((b, l, y0, x0))
    return out


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
@pytest.mark.parametrize("label,supports,gscale", CASES,
                         ids=[c[0] for c in CASES])
def test_tile_statement_matches_jax(label, supports, gscale, tile, exact):
    """The kernels' tile algorithm (tile stabiliser, separable shifted
    adds, per-tile guard, K6's factorisation) against JAX's forward and
    jax.vjp on the exact and the fast path, at the kernels' tile and at
    tiles that cut the 16x20 images into many."""
    w, g, x, G = _inputs(len(label), gscale)
    out_j, gw_j, gg_j = _jax_vjp(supports, exact)(w, g, x, G)
    out, fm, den, _ = k5_statement(w, g, x, supports, tile)
    np.testing.assert_allclose(out, np.asarray(out_j), atol=FWD_TOL)
    gw, gg, _ = k6_statement(G, w, g, x, fm, den, supports, tile)
    np.testing.assert_allclose(gw, np.asarray(gw_j), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(gg, np.asarray(gg_j), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
@pytest.mark.parametrize("label,supports,gscale", CASES,
                         ids=[c[0] for c in CASES])
def test_tile_statement_matches_plain(label, supports, gscale, tile):
    """The tile algorithm against the plain versions (K5's and K6's
    yardsticks on the card); a support-0 level gets no guidance
    gradient."""
    w, g, x, G = _inputs(len(label), gscale)
    out, fm, den, _ = k5_statement(w, g, x, supports, tile)
    t = torch.from_numpy
    ref = tf.guided_filter_batch_plain(t(w), t(g), t(x), supports)
    np.testing.assert_allclose(out, ref.numpy(), atol=FWD_TOL)
    gw, gg, _ = k6_statement(G, w, g, x, fm, den, supports, tile)
    rw, rg = tf.guided_filter_backward_plain(t(G), t(w), t(g), t(x),
                                             supports)
    np.testing.assert_allclose(gw, rw.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(gg, rg.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    if 0 in supports:
        assert not gg[:, supports.index(0)].any()


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
def test_tile_guard_only_where_needed(tile):
    """A 70-nat spike in one image and level: K5 takes the guard exactly in
    the tiles whose staged region holds it, and nowhere else; K6 exactly
    where its saved stabilisers span 60 nats; the results meet the same
    bars against JAX's fast path (which falls back to the exact form for
    the whole image) and the plain versions.  In the gscale-40 case K5
    takes the guard in every tile of every level."""
    w, g, x, G = _spike_inputs(5)
    s = LADDER[1]
    out, fm, den, g5 = k5_statement(w, g, x, LADDER, tile)
    assert g5 == {(0, 1, y0, x0) for y0, x0 in _spike_tiles(H, W, tile, s)}
    assert len(g5) < len(_tile_origins(H, W, tile)) or tile == TILES[0]
    gw, gg, g6 = k6_statement(G, w, g, x, fm, den, LADDER, tile)
    assert g6 == _k6_guards(fm, LADDER, tile)
    assert g6 and all(k[:2] == (0, 1) for k in g6)
    out_j, gw_j, gg_j = _jax_vjp(LADDER, False)(w, g, x, G)
    np.testing.assert_allclose(out, np.asarray(out_j), atol=FWD_TOL)
    np.testing.assert_allclose(gw, np.asarray(gw_j), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(gg, np.asarray(gg_j), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    t = torch.from_numpy
    ref = tf.guided_filter_batch_plain(t(w), t(g), t(x), LADDER)
    np.testing.assert_allclose(out, ref.numpy(), atol=FWD_TOL)
    # the wide case: every (image, level, tile) spans more than 60 nats
    w, g, x, G = _inputs(len(CASES[2][0]), CASES[2][2])
    sup = CASES[2][1]
    _, fm, den, g5 = k5_statement(w, g, x, sup, tile)
    assert len(g5) == B * sum(1 for s in sup if s) * len(
        _tile_origins(H, W, tile))
    assert k6_statement(G, w, g, x, fm, den, sup, tile)[2] == _k6_guards(
        fm, sup, tile)


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
def test_tile_saved_stabiliser(tile):
    """What K5 saves for K6: m is the tile's stabiliser on a fast tile (the
    window max on a guard tile) and D the denominator against it, so
    exp(g_q - m_p) / D_p, all K6 needs, equals the per-window form's:
    D exp(m - m_win) = D_win within f32 rounding, and f is unchanged."""
    w, g, x, G = _spike_inputs(6)
    _, fm, den, guards = k5_statement(w, g, x, LADDER, tile)
    t = torch.from_numpy
    tw, th = tile
    for l, s in enumerate(LADDER):
        f_w, m_w, d_w = (a.numpy() for a in tf._level_sums(
            t(x[..., :3]), t(g[:, l]), s))
        np.testing.assert_allclose(fm[:, l, ..., :3], f_w, atol=FWD_TOL)
        np.testing.assert_allclose(den[:, l] * np.exp(fm[:, l, ..., 3] - m_w),
                                   d_w, rtol=1e-5)
        for b in range(B):
            for y0, x0 in _tile_origins(H, W, tile):
                mt = fm[b, l, y0:y0 + th, x0:x0 + tw, 3]
                if (b, l, y0, x0) in guards:
                    np.testing.assert_array_equal(
                        mt, m_w[b, y0:y0 + th, x0:x0 + tw])
                else:
                    g_r = _staged(g[b, l], y0, x0, th, tw, s,
                                  np.float32(-np.inf))
                    assert (mt == g_r.max()).all()
