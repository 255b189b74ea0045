"""Fast mode (render_scale < 1) in the port vs the JAX package: the resize
rules of ops/resize.py against jax.image.resize, the noisy and denoised
fast frames against the JAX Renderer, render_timed, the scale checks and
the RNG protocol.

Tolerances: the bilinear rule 1e-6 on [0, 1] values (f32 lerps in another
order than JAX's normalized weight matrix); nearest exact; the fast frame
img 1e-5 and aux 2e-5 (the noisy inner frames agree to ~1e-7, the squares
and the f32 net and filter add their own reassociation).

The JAX renderers run with ``schedule=((0, 1),)``: one march phase without
compaction, the same frame as the default schedule's, compiled in a
quarter of the time."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rt_octree_tpu.core.camera import Camera
from rt_octree_tpu.core.options import RenderOptions
from rt_octree_tpu.io import synthetic
from rt_octree_tpu.models import guidance_net as jg
from rt_octree_tpu.ops import traversal as jt
from rt_octree_tpu.ops.filtering import guided_filter as jax_filter
from rt_octree_tpu.render import renderer as jr
from rt_octree_tpu_torch.ops import resize as rz
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.render import renderer as tr
from rt_octree_tpu_torch.utils.timer import PhaseTimer

torch.set_num_threads(1)

BILINEAR_TOL, IMG_TOL, AUX_TOL = 1e-6, 1e-5, 2e-5
FAST_GNET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "quality", "fast.gnet")
W = H = 32
NO_COMPACTION = ((0, 1),)

# (output size, render_scale): odd sizes and 25 x 0.5 = 12.5 -> 12
RESIZE_CASES = [((37, 23), 0.3), ((37, 23), 0.4), ((45, 31), 0.5),
                ((29, 41), 0.7), ((25, 25), 0.5), ((800, 800), 0.4)]


def _inner(n, s):
    return max(1, round(n * s))


@pytest.mark.parametrize("size,scale", RESIZE_CASES)
def test_upsample_bilinear_matches_jax(size, scale):
    Hh, Ww = size
    h, w = _inner(Hh, scale), _inner(Ww, scale)
    x = np.random.default_rng(h * 100 + w).random((h, w, 4), np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (Hh, Ww, 4),
                                      "bilinear"))
    got = rz.upsample_bilinear_plain(torch.from_numpy(x), Hh, Ww)
    np.testing.assert_allclose(got.numpy(), ref, atol=BILINEAR_TOL, rtol=0)


@pytest.mark.parametrize("size,scale", RESIZE_CASES)
def test_nearest_indices_match_jax(size, scale):
    """The mesh pass sampled at the inner size, and the other way too."""
    Hh, Ww = size
    h, w = _inner(Hh, scale), _inner(Ww, scale)
    x = np.random.default_rng(7).random((Hh, Ww, 3), np.float32)
    down = np.asarray(jax.image.resize(jnp.asarray(x), (h, w, 3), "nearest"))
    np.testing.assert_array_equal(
        rz.downsample_nearest(torch.from_numpy(x), h, w).numpy(), down)
    up = np.asarray(jax.image.resize(jnp.asarray(x[:h, :w]), (Hh, Ww, 3),
                                     "nearest"))
    np.testing.assert_array_equal(
        x[:h, :w][rz.nearest_indices(h, Hh)][:, rz.nearest_indices(w, Ww)],
        up)


def test_library_resizes_against_the_rules():
    """Trap C.1 for the library yardstick: F.interpolate's bilinear
    (align_corners=False, antialias=False) is JAX's rule to 1e-6, while its
    "nearest" picks other pixels than JAX's."""
    x = torch.from_numpy(np.random.default_rng(3).random((4, 25, 25),
                                                         np.float32))
    lib = F.interpolate(x[None], size=(50, 50), mode="bilinear",
                        align_corners=False, antialias=False)[0]
    plain = rz.upsample_bilinear_plain(x.permute(1, 2, 0), 50, 50)
    torch.testing.assert_close(lib, plain.permute(2, 0, 1),
                               atol=BILINEAR_TOL, rtol=0)
    near = F.interpolate(x[None], size=(10, 10), mode="nearest")[0]
    assert not torch.equal(near.permute(1, 2, 0),
                           rz.downsample_nearest(x.permute(1, 2, 0), 10, 10))


def test_fast_upsample_takes_squares_after_the_upsample():
    rgba = torch.from_numpy(np.random.default_rng(4).random((5, 7, 4),
                                                            np.float32))
    aux = torch.cat([rgba, rgba * rgba], -1)
    img, aux_n, aux_c = rz.fast_upsample(aux, 11, 13)
    v = rz.upsample_bilinear_plain(rgba, 11, 13)
    assert torch.equal(aux_n[..., :4], v)
    assert torch.equal(aux_n[..., 4:], v * v)
    assert torch.equal(aux_c, aux_n.permute(2, 0, 1))
    assert torch.equal(img[..., :3], v[..., :3])
    assert bool((img[..., 3] == 1).all())
    assert rz.fast_upsample(aux, 11, 13, want_aux=False)[2] is None


@pytest.fixture(scope="module")
def tree():
    return synthetic.make_synthetic_tree("shell", depth=5, basis_dim=9)


def _opt(denoise=False):
    return RenderOptions(spp=6, denoise=denoise, step_size=1e-4,
                         sigma_thresh=1e-2, background_brightness=1.0)


def _cam(w=W, h=H):
    return Camera(width=w, height=h, fx=45.0 * w / 32, fy=45.0 * h / 32)


@pytest.mark.parametrize("size,scale", [((32, 32), 0.4), ((25, 19), 0.5)])
def test_fast_noisy_frame_matches_jax(tree, size, scale):
    """Two frames, the RNG advanced between them: K1 at the inner size
    draws advance(idx * spp) over the inner R, as JAX does."""
    w, h = size
    cam = _cam(w, h)
    rj = jr.Renderer(jt.upload_tree(tree, lut_levels=5), w, h, cam.fx,
                     cam.fy, options=_opt(), render_scale=scale,
                     schedule=NO_COMPACTION)
    rp = tr.Renderer(tt.upload_tree(tree, lut_levels=5, device="cpu"), w, h,
                     cam.fx, cam.fy, options=_opt(), render_scale=scale)
    assert (rp.inner_width, rp.inner_height) == (rj.inner_width,
                                                 rj.inner_height)
    frames = []
    for _ in range(2):
        img_j, aux_j = rj.render(cam.transform)
        img, aux = rp.render(cam.transform)
        assert img.shape == (h, w, 4) and aux.shape == (8, h, w)
        np.testing.assert_allclose(img.numpy(), np.asarray(img_j),
                                   atol=IMG_TOL, rtol=0)
        np.testing.assert_allclose(aux.numpy(), np.asarray(aux_j),
                                   atol=AUX_TOL, rtol=0)
        frames.append(img)
        rj.advance_rng()
        rp.advance_rng()
    assert not torch.equal(frames[0], frames[1])


def test_fast_frame_is_the_upsampled_inner_frame(tree):
    """The RNG protocol and focal scaling: a fast frame is K4 of the noisy
    frame at the inner size with fx, fy scaled by inner / output and the
    same PCG32 state."""
    cam = _cam()
    dt = tt.upload_tree(tree, lut_levels=5, device="cpu")
    r = tr.Renderer(dt, W, H, cam.fx, cam.fy, options=_opt(),
                    render_scale=0.4)
    r.advance_rng()
    img, aux = r.render(cam.transform)
    iw, ih = r.inner_width, r.inner_height
    assert (iw, ih) == (13, 13)
    _, aux_in, _ = tr.render_noisy(
        dt, torch.from_numpy(cam.transform), r.rng.state, r.rng.inc,
        width=iw, height=ih, fx=cam.fx * iw / W, fy=cam.fy * ih / H,
        opt=_opt())
    img2, _, aux2 = rz.fast_upsample(aux_in, H, W)
    assert torch.equal(img, img2) and torch.equal(aux, aux2)


def test_fast_denoised_frame_matches_jax(tree):
    """A fast-mode net (fast.gnet) carried across by build_compact from
    its Flax params, in f32 on both sides; the JAX reference is its
    Renderer's fast frame with denoise off (_render_frame_impl's march at
    the inner size, bilinear upsample, aux from the upsampled rows: the
    frame the noisy test compiles) through an f32 net and the exact
    filter."""
    cfg, params = jg.load_compact(FAST_GNET)
    cam = _cam()
    rj = jr.Renderer(jt.upload_tree(tree, lut_levels=5), W, H, cam.fx,
                     cam.fy, options=_opt(), render_scale=0.4,
                     schedule=NO_COMPACTION)
    img_j, aux_j = rj.render(cam.transform)
    wj, gj = jg.GuidanceNetCompact(cfg, dtype=jnp.float32).apply(
        {"params": params}, jnp.moveaxis(aux_j, 0, -1)[None])
    ref = np.asarray(jax_filter(wj[0], gj[0], img_j, exact=True,
                                supports=cfg.supports()))

    r = tr.Renderer(tt.upload_tree(tree, lut_levels=5, device="cpu"), W, H,
                    cam.fx, cam.fy, options=_opt(True), render_scale=0.4)
    r.set_denoiser(cfg, params)
    r.net = r.net.to(torch.float32)
    r.net.dtype = torch.float32
    img, aux = r.render(cam.transform)
    np.testing.assert_allclose(img.numpy(), ref, atol=IMG_TOL, rtol=0)
    np.testing.assert_allclose(aux.numpy(), np.asarray(aux_j), atol=AUX_TOL,
                               rtol=0)
    assert np.abs(img.numpy() - aux.numpy()[:4].transpose(1, 2, 0)).max() \
        > 1e-3  # the filter did something

    timer = PhaseTimer("cpu")
    r.rng.seed(20230418, 1)
    img_t, aux_t = tr.render_timed(r, cam.transform, timer)
    r.rng.seed(20230418, 1)
    img2, aux2 = r.render(cam.transform)
    assert torch.equal(img_t, img2) and torch.equal(aux_t, aux2)
    assert timer.cnt == 1 and all(s > 0 for s in timer.sum)


@pytest.mark.parametrize("scale", [0.0, -0.5, 1.5])
def test_bad_render_scales_are_refused(tree, scale):
    dt = tt.upload_tree(tree, lut_levels=2, device="cpu")
    with pytest.raises(ValueError, match="render_scale"):
        tr.Renderer(dt, W, H, 40.0, 40.0, render_scale=scale)


def test_inner_size_rounds_half_to_even(tree):
    dt = tt.upload_tree(tree, lut_levels=2, device="cpu")
    r = tr.Renderer(dt, 25, 27, 40.0, 40.0, render_scale=0.5)
    assert (r.inner_width, r.inner_height) == (12, 14) and r.fast
    r = tr.Renderer(dt, 100, 100, 40.0, 40.0, render_scale=0.999)
    assert (r.inner_width, r.inner_height) == (100, 100) and not r.fast
