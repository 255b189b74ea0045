"""The port's noisy frame (kernel K1's plain version) vs the JAX renderer and
the NumPy oracle.

Both packages and the oracle consume the identical PCG32 stream, so frames
agree to f32 reassociation: the tolerances are the JAX package's own
oracle bars (tests/test_render.py): img 2e-5, aux 4e-5, and 3e-5 for NDC
rays, where the oracle warps in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_octree_tpu.core.camera import Camera
from rt_octree_tpu.core.options import RenderOptions
from rt_octree_tpu.core.oracle import render_frame_oracle
from rt_octree_tpu.io import synthetic
from rt_octree_tpu.io.n3tree import BasisFormat, DataFormat
from rt_octree_tpu.ops import traversal as jt
from rt_octree_tpu.render import renderer as jr
from rt_octree_tpu.utils.rng import Pcg32 as JPcg32
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.render import renderer as tr

torch.set_num_threads(1)

IMG_TOL, AUX_TOL, NDC_TOL = 2e-5, 4e-5, 3e-5


@pytest.fixture(scope="module")
def tree():
    return synthetic.make_synthetic_tree("shell", depth=4, basis_dim=4)


def _cam(w=24, h=24):
    return Camera(width=w, height=h, fx=40.0, fy=40.0)


def _port(tree, cam, opt, lut_levels, rng_state=None):
    dt = tt.upload_tree(tree, lut_levels=lut_levels, device="cpu")
    r = tr.Renderer(dt, cam.width, cam.height, cam.fx, cam.fy, options=opt)
    if rng_state is not None:
        r.rng = rng_state
    img, aux = r.render(cam.transform)
    return img.numpy(), aux.numpy()


def _jax(tree, cam, opt, lut_levels):
    dt = jt.upload_tree(tree, lut_levels=lut_levels)
    r = jr.Renderer(dt, cam.width, cam.height, cam.fx, cam.fy, options=opt)
    img, aux = r.render(cam.transform)
    return np.asarray(img), np.asarray(aux)


@pytest.mark.parametrize("spp,lut_levels", [(1, 4), (2, 0), (6, 3),
                                            (32, 4)])
def test_frame_matches_jax_and_oracle(tree, spp, lut_levels):
    """lut_levels 0: descent from the root; 3: LUT + continued descent;
    4 (full depth): LUT with empty-space skip distances."""
    cam = _cam()
    opt = RenderOptions(spp=spp, denoise=False, background_brightness=1.0)
    img, aux = _port(tree, cam, opt, lut_levels)
    img_j, aux_j = _jax(tree, cam, opt, lut_levels)
    np.testing.assert_allclose(img, img_j, atol=IMG_TOL)
    np.testing.assert_allclose(aux, aux_j, atol=AUX_TOL)
    img_o, aux_o = render_frame_oracle(tree, cam, opt, JPcg32(20230418))
    np.testing.assert_allclose(img, img_o, atol=IMG_TOL)
    np.testing.assert_allclose(aux, aux_o, atol=AUX_TOL)
    assert aux[3].max() > 0.5  # the scene is visible


def test_ndc_frame_matches_jax_and_oracle():
    tree = synthetic.make_synthetic_tree("shell", depth=4, basis_dim=4)
    tree.use_ndc = True
    tree.ndc_width, tree.ndc_height, tree.ndc_focal = 1008.0, 756.0, 800.0
    cam = Camera(width=16, height=16, fx=60.0, fy=60.0)
    cam.center = np.array([0.02, 0.01, 0.3], np.float32)
    cam.v_back = np.array([0.0, 0.0, 1.0], np.float32)
    cam.v_world_up = np.array([0.0, 1.0, 0.0], np.float32)
    cam.update()
    opt = RenderOptions(spp=2, denoise=False)
    img, _ = _port(tree, cam, opt, 3)
    img_j, _ = _jax(tree, cam, opt, 3)
    np.testing.assert_allclose(img, img_j, atol=IMG_TOL)
    img_o, _ = render_frame_oracle(tree, cam, opt, JPcg32(20230418))
    np.testing.assert_allclose(img, img_o, atol=NDC_TOL)


def test_rgba_format_frame_matches_jax_and_oracle():
    tree = synthetic.make_synthetic_tree("shell", depth=4, basis_dim=1)
    tree.data_format = DataFormat(BasisFormat.RGBA, -1)
    cam = _cam(12, 12)
    opt = RenderOptions(spp=2, denoise=False)
    img, _ = _port(tree, cam, opt, 0)
    img_j, _ = _jax(tree, cam, opt, 0)
    np.testing.assert_allclose(img, img_j, atol=IMG_TOL)
    img_o, _ = render_frame_oracle(tree, cam, opt, JPcg32(20230418))
    np.testing.assert_allclose(img, img_o, atol=IMG_TOL)


def test_rng_advance_changes_noise_and_matches_oracle(tree):
    cam = _cam(16, 16)
    opt = RenderOptions(spp=1, denoise=False)
    dt = tt.upload_tree(tree, lut_levels=4, device="cpu")
    r = tr.Renderer(dt, 16, 16, cam.fx, cam.fy, options=opt)
    img1, _ = r.render(cam.transform)
    r.advance_rng()
    img2, _ = r.render(cam.transform)
    assert not torch.equal(img1, img2)
    rng = JPcg32(20230418)
    rng.advance()
    img2_o, _ = render_frame_oracle(tree, cam, opt, rng)
    np.testing.assert_allclose(img2.numpy(), img2_o, atol=IMG_TOL)


def test_empty_ray_is_background(tree):
    cam = _cam(8, 8)
    cam.v_back = np.array([0.7071068, 0.0, -0.7071068], np.float32)
    cam.update()  # looking away from the scene
    opt = RenderOptions(spp=2, denoise=False, background_brightness=0.25)
    img, aux = _port(tree, cam, opt, 4)
    np.testing.assert_array_equal(aux[3], 0.0)
    np.testing.assert_array_equal(img[..., :3], 0.25)
    np.testing.assert_array_equal(img[..., 3], 1.0)
    np.testing.assert_allclose(aux[4:], aux[:4] ** 2, atol=1e-7)


def test_aux_layouts_carry_the_same_rows(tree):
    cam = _cam(16, 12)
    dt = tt.upload_tree(tree, lut_levels=4, device="cpu")
    tf = torch.from_numpy(cam.transform)
    img, nhwc, chw = tr.render_noisy(
        dt, tf, 12345, 7, width=16, height=12, fx=cam.fx, fy=cam.fy,
        opt=RenderOptions(spp=4, denoise=False))
    assert nhwc.shape == (12, 16, 8) and chw.shape == (8, 12, 16)
    assert torch.equal(chw.permute(1, 2, 0), nhwc)
    assert torch.equal(img[..., :3], nhwc[..., :3])


@pytest.mark.parametrize("bd", [1, 4, 9, 16, 25])
def test_sh_basis_matches_jax(bd):
    from rt_octree_tpu.ops.sh import eval_sh_basis as jsh
    from rt_octree_tpu_torch.ops.sh import eval_sh_basis
    rs = np.random.default_rng(bd)
    dirs = rs.standard_normal((64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    got = eval_sh_basis(bd, torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsh(bd, jnp.asarray(dirs))),
                               atol=1e-6)


def test_sg_asg_basis_match_jax():
    from rt_octree_tpu.ops.sh import eval_asg_basis as jasg
    from rt_octree_tpu.ops.sh import eval_sg_basis as jsg
    from rt_octree_tpu_torch.ops.sh import eval_asg_basis, eval_sg_basis
    rs = np.random.default_rng(5)
    dirs = rs.standard_normal((32, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    e_sg = rs.standard_normal(4 * 4).astype(np.float32)
    e_asg = rs.standard_normal(11 * 2).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        eval_sg_basis(4, t(e_sg), t(dirs)).numpy(),
        np.asarray(jsg(4, jnp.asarray(e_sg), jnp.asarray(dirs))), atol=1e-5)
    np.testing.assert_allclose(
        eval_asg_basis(2, t(e_asg), t(dirs)).numpy(),
        np.asarray(jasg(2, jnp.asarray(e_asg), jnp.asarray(dirs))),
        atol=1e-5)
