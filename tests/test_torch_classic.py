"""The classic estimator (K1's ``render_classic`` variant, plain version
``march_classic_plain``) vs the JAX package's trace_rays_classic through its
Renderer and vs the NumPy oracle (core/oracle.py, test-only).

Tolerance 1e-5 on [0, 1] pixel values: every leaf step multiplies the
light by an ``exp`` that torch and XLA may round an ulp apart (6e-8
relative), and a ray of ~40 steps carries that error through light, the
weights and the 1 / (1 - light) renormalization; measured up to 3e-6.
The oracle marches in float64 and gets the same bar."""

import numpy as np
import pytest
import torch

from rt_octree_tpu.core.camera import Camera
from rt_octree_tpu.core.options import RenderOptions
from rt_octree_tpu.core.oracle import render_frame_classic_oracle
from rt_octree_tpu.io import synthetic
from rt_octree_tpu.io.n3tree import BasisFormat, DataFormat
from rt_octree_tpu.ops import traversal as jt
from rt_octree_tpu.render import renderer as jr
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.render import renderer as tr

torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture(scope="module")
def tree():
    return synthetic.make_synthetic_tree("shell", depth=5, basis_dim=9)


def _cam(w=24, h=24):
    return Camera(width=w, height=h, fx=40.0 * w / 24, fy=40.0 * h / 24)


def _opt(**kw):
    return RenderOptions(**{"spp": 6, "denoise": False,
                            "estimator": "classic", **kw})


def _frames(tree, cam, opt, lut_levels, max_steps=8192, scale=1.0):
    """(port img, port aux, JAX img, JAX aux) as NumPy."""
    rj = jr.Renderer(jt.upload_tree(tree, lut_levels=lut_levels), cam.width,
                     cam.height, cam.fx, cam.fy, options=opt,
                     max_steps=max_steps, render_scale=scale)
    rp = tr.Renderer(tt.upload_tree(tree, lut_levels=lut_levels,
                                    device="cpu"), cam.width, cam.height,
                     cam.fx, cam.fy, options=opt, max_steps=max_steps,
                     render_scale=scale)
    img_j, aux_j = rj.render(cam.transform)
    img, aux = rp.render(cam.transform)
    return img.numpy(), aux.numpy(), np.asarray(img_j), np.asarray(aux_j)


@pytest.mark.parametrize("lut_levels,spp", [(5, 6), (3, 1), (0, 32)])
def test_classic_frame_matches_jax_and_oracle(tree, lut_levels, spp):
    """Full-depth LUT with skip distances, a partial LUT with descents and
    no LUT; SPP is not used by the estimator."""
    cam = _cam()
    opt = _opt(spp=spp)
    img, aux, img_j, aux_j = _frames(tree, cam, opt, lut_levels)
    np.testing.assert_allclose(img, img_j, atol=TOL, rtol=0)
    np.testing.assert_allclose(aux, aux_j, atol=TOL, rtol=0)
    assert aux[3].max() > 0.5
    np.testing.assert_allclose(img, render_frame_classic_oracle(
        tree, cam, opt), atol=TOL, rtol=0)


def test_classic_ignores_the_rng_and_spp(tree):
    cam = _cam(16, 16)
    dt = tt.upload_tree(tree, lut_levels=5, device="cpu")
    r = tr.Renderer(dt, 16, 16, cam.fx, cam.fy, options=_opt(spp=1))
    img1, aux1 = r.render(cam.transform)
    r.advance_rng()
    r.options.spp = 32
    img2, aux2 = r.render(cam.transform)
    assert torch.equal(img1, img2) and torch.equal(aux1, aux2)


def test_stop_thresh_early_out(tree):
    """A high stop_thresh ends rays early (fewer steps, renormalized rgb,
    alpha 1 where it fired) and still matches JAX and the oracle."""
    cam = _cam()
    img_lo, _, _, _ = _frames(tree, cam, _opt(stop_thresh=1e-2), 5)
    opt = _opt(stop_thresh=0.4)
    img, aux, img_j, aux_j = _frames(tree, cam, opt, 5)
    np.testing.assert_allclose(img, img_j, atol=TOL, rtol=0)
    np.testing.assert_allclose(aux, aux_j, atol=TOL, rtol=0)
    np.testing.assert_allclose(img, render_frame_classic_oracle(
        tree, cam, opt), atol=TOL, rtol=0)
    assert np.abs(img - img_lo).max() > 1e-3
    dt = tt.upload_tree(tree, lut_levels=5, device="cpu")
    kw = dict(width=24, height=24, fx=cam.fx, fy=cam.fy)
    tf = torch.from_numpy(cam.transform)
    lo = tr.render_stats(dt, tf, 0, 0, opt=_opt(stop_thresh=1e-2), **kw)
    hi = tr.render_stats(dt, tf, 0, 0, opt=opt, **kw)
    assert int(hi.steps.sum()) < int(lo.steps.sum())
    assert (aux[3] == 1.0).sum() > 0


def test_classic_rgba_and_ndc_match_jax():
    """RGBA rows (raw rgb in [0, 1], no sigmoid) and an LLFF NDC tree."""
    rgba = synthetic.make_synthetic_tree("shell", depth=4, basis_dim=1)
    rgba.data_format = DataFormat(BasisFormat.RGBA, -1)
    rgb = rgba.data[:, :3].astype(np.float32)
    rgba.data[:, :3] = (1.0 / (1.0 + np.exp(-rgb))).astype(np.float16)
    img, aux, img_j, aux_j = _frames(rgba, _cam(12, 12), _opt(), 4)
    np.testing.assert_allclose(img, img_j, atol=TOL, rtol=0)
    np.testing.assert_allclose(aux, aux_j, atol=TOL, rtol=0)

    blobs = synthetic.make_synthetic_tree("blobs", depth=4, basis_dim=4)
    blobs.use_ndc = True
    blobs.ndc_width, blobs.ndc_height, blobs.ndc_focal = 1008.0, 756.0, 800.0
    cam = Camera(width=16, height=16, fx=60.0, fy=60.0)
    cam.center = np.array([0.02, 0.01, 0.3], np.float32)
    cam.v_back = np.array([0.0, 0.0, 1.0], np.float32)
    cam.v_world_up = np.array([0.0, 1.0, 0.0], np.float32)
    cam.update()
    img, aux, img_j, aux_j = _frames(blobs, cam, _opt(), 3)
    np.testing.assert_allclose(img, img_j, atol=TOL, rtol=0)
    np.testing.assert_allclose(aux, aux_j, atol=TOL, rtol=0)
    assert aux[3].max() > 0.1


def test_odd_max_steps_takes_one_step_more_like_jax(tree):
    """JAX tests max_steps every 2 steps (unroll=2): max_steps 3 marches
    4 steps, as the port does."""
    cam = _cam(12, 12)
    dt = tt.upload_tree(tree, lut_levels=5, device="cpu")
    kw = dict(width=12, height=12, fx=cam.fx, fy=cam.fy, opt=_opt())
    tf = torch.from_numpy(cam.transform)
    for max_steps in (3, 4):
        st = tr.render_stats(dt, tf, 0, 0, max_steps=max_steps, **kw)
        assert int(st.steps.max()) == 4
    img, aux, img_j, aux_j = _frames(tree, cam, _opt(), 5, max_steps=3)
    np.testing.assert_allclose(img, img_j, atol=TOL, rtol=0)
    img4 = _frames(tree, cam, _opt(), 5, max_steps=4)[0]
    np.testing.assert_array_equal(img, img4)


def test_classic_fast_mode_matches_jax(tree):
    cam = _cam(25, 25)
    img, aux, img_j, aux_j = _frames(tree, cam, _opt(), 5, scale=0.5)
    np.testing.assert_allclose(img, img_j, atol=TOL, rtol=0)
    np.testing.assert_allclose(aux, aux_j, atol=TOL, rtol=0)


def _lobes(tree, fmt, seed):
    """Random SG ([bd, 4]) or ASG ([bd, 11]) lobes on ``tree``'s rows."""
    bd = tree.data_format.basis_dim
    rs = np.random.default_rng(seed)
    width = 4 if fmt == BasisFormat.SG else 11
    extra = rs.standard_normal((bd, width))
    sharp = 1 if fmt == BasisFormat.SG else 2
    extra[:, :sharp] = rs.uniform(0.5, 4.0, (bd, sharp))
    tree.data_format = DataFormat(fmt, bd)
    tree.extra = extra.astype(np.float32)
    return tree


@pytest.mark.parametrize("layout", ["SH1", "SH16", "SH25", "SG4", "ASG9"])
def test_classic_row_layouts_match_jax(layout):
    """Each row layout the classic kernel has an instance for (besides the
    SH9 / SH4 / RGBA frames above): SH at basis_dim 1, 16 and 25, SG and
    ASG lobes, through the plain march vs JAX."""
    fmt = layout.rstrip("0123456789")
    bd = int(layout[len(fmt):])
    tree = synthetic.make_synthetic_tree("shell", depth=4, basis_dim=bd)
    if fmt != "SH":
        tree = _lobes(tree, BasisFormat[fmt], bd)
    img, aux, img_j, aux_j = _frames(tree, _cam(16, 16), _opt(), 4)
    np.testing.assert_allclose(img, img_j, atol=TOL, rtol=0)
    np.testing.assert_allclose(aux, aux_j, atol=TOL, rtol=0)
    assert aux[3].max() > 0.5
