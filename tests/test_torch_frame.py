"""The whole frame through the port's Renderer and headless CLI vs the JAX
package: render + GuidanceNet + guided filter, and the CLI's dumps."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_octree_tpu.core.camera import Camera
from rt_octree_tpu.core.options import RenderOptions
from rt_octree_tpu.io import synthetic
from rt_octree_tpu.models import guidance_net as jg
from rt_octree_tpu.ops import traversal as jt
from rt_octree_tpu.ops.filtering import guided_filter as jax_filter
from rt_octree_tpu.render import renderer as jr
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.render import renderer as tr
from rt_octree_tpu_torch.utils.timer import PhaseTimer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "benchmarks", "quality", "trained.gnet")
W = H = 32


@pytest.fixture(scope="module")
def tree():
    return synthetic.make_synthetic_tree("shell", depth=5, basis_dim=9)


@pytest.fixture(scope="module")
def cam():
    return Camera(width=W, height=H, fx=45.0, fy=45.0)


def _opt(denoise=True):
    return RenderOptions(spp=6, denoise=denoise, step_size=1e-4,
                         sigma_thresh=1e-2, background_brightness=1.0)


@pytest.fixture(scope="module")
def port_renderer(tree, cam):
    dt = tt.upload_tree(tree, lut_levels=5, device="cpu")
    r = tr.Renderer(dt, W, H, cam.fx, cam.fy, options=_opt())
    r.set_denoiser(TRAINED)
    return r


@pytest.fixture(scope="module")
def jax_frame(tree, cam):
    """The JAX package's denoised frame (bf16 net, as it ships)."""
    dt = jt.upload_tree(tree, lut_levels=5)
    r = jr.Renderer(dt, W, H, cam.fx, cam.fy, options=_opt())
    r.set_denoiser(TRAINED)
    img, aux = r.render(cam.transform)
    return np.asarray(img), np.asarray(aux)


def test_denoised_frame_matches_jax(port_renderer, jax_frame, cam):
    """bf16 net in both packages: the noisy inputs agree to ~1e-7, which
    can still move a bf16 rounding inside the net (2^-8 relative) and so a
    softmax weight; the bound is 1e-3 on [0, 1] pixel values (measured
    4.8e-7 on a CPU host)."""
    port_renderer.rng.seed(20230418, 1)
    img, aux = port_renderer.render(cam.transform)
    img_j, aux_j = jax_frame
    np.testing.assert_allclose(aux.numpy(), aux_j, atol=4e-5)
    np.testing.assert_allclose(img.numpy(), img_j, atol=1e-3)
    assert np.abs(img.numpy() - aux.numpy()[:4].transpose(1, 2, 0)).max() \
        > 1e-3  # the filter did something


def test_denoised_frame_f32_matches_jax_algorithm(tree, cam):
    """The same frame with the net in f32 on both sides: the algorithm
    itself, held at f32 reassociation (1e-5)."""
    cfg, params = jg.load_compact(TRAINED)
    dt_j = jt.upload_tree(tree, lut_levels=5)
    fopt = jr.FrozenOptions.from_options(_opt(False))
    r0 = jr.Renderer(dt_j, W, H, cam.fx, cam.fy, options=_opt(False))
    img_n, aux_n = jr._render_noisy(
        dt_j, jnp.asarray(cam.transform), jnp.uint32(r0.rng.state >> 32),
        jnp.uint32(r0.rng.state & 0xFFFFFFFF), width=W, height=H,
        fx=cam.fx, fy=cam.fy, opt=fopt, n_chunks=1, max_steps=8192,
        inc=r0.rng.inc, aux_layout="nhwc")
    wj, gj = jg.GuidanceNetCompact(cfg, dtype=jnp.float32).apply(
        {"params": params}, aux_n[None])
    ref = np.asarray(jax_filter(wj[0], gj[0], img_n, exact=True,
                                supports=cfg.supports()))

    dt = tt.upload_tree(tree, lut_levels=5, device="cpu")
    r = tr.Renderer(dt, W, H, cam.fx, cam.fy, options=_opt())
    r.set_denoiser(cfg, params)
    r.net = r.net.to(torch.float32)
    r.net.dtype = torch.float32
    img, _ = r.render(cam.transform)
    np.testing.assert_allclose(img.numpy(), ref, atol=1e-5)


def test_render_timed_matches_render(port_renderer, cam):
    timer = PhaseTimer("cpu")
    port_renderer.rng.seed(20230418, 1)
    img_t, aux_t = tr.render_timed(port_renderer, cam.transform, timer)
    port_renderer.rng.seed(20230418, 1)
    img, aux = port_renderer.render(cam.transform)
    assert torch.equal(img_t, img) and torch.equal(aux_t, aux)
    assert timer.cnt == 1 and all(s > 0 for s in timer.sum)
    report = timer.report()
    assert "render" in report and "filter" in report and "FPS" in report


def test_want_aux_false_keeps_the_image(port_renderer, cam):
    port_renderer.rng.seed(20230418, 1)
    img, aux = port_renderer.render(cam.transform)
    port_renderer.rng.seed(20230418, 1)
    img2, aux2 = port_renderer.render(cam.transform, want_aux=False)
    assert aux2 is None and torch.equal(img, img2)


@pytest.mark.parametrize("what", ["render_scale", "classic", "mesh",
                                  "show_grid", "enable_probe"])
def test_unported_features_raise(tree, cam, what):
    """Each feature that the first slices refused is ported now; what still
    raises is its misuse: a render_scale outside (0, 1], an unknown
    estimator, a mesh pass of the wrong size, show_grid without
    set_grid_mesh, a probe point that is not x, y, z."""
    dt = tt.upload_tree(tree, lut_levels=2, device="cpu")
    if what == "render_scale":
        for bad in (0.0, 1.5):
            with pytest.raises(ValueError, match="render_scale"):
                tr.Renderer(dt, W, H, cam.fx, cam.fy, render_scale=bad)
        return
    opt = _opt(False)
    kw = {}
    if what == "classic":
        opt.estimator = "unknown"
        with pytest.raises(ValueError, match="estimator"):
            tr.Renderer(dt, W, H, cam.fx, cam.fy, options=opt)
        return
    if what == "mesh":
        kw = dict(mesh_color=np.zeros((H, W, 3), np.float32),
                  mesh_depth=np.ones((H + 1, W), np.float32))
    elif what == "enable_probe":
        opt.enable_probe = True
        opt.probe = (0.0, 0.5)
    else:
        opt.show_grid = True
    r = tr.Renderer(dt, W, H, cam.fx, cam.fy, options=opt)
    err = RuntimeError if what == "show_grid" else ValueError
    with pytest.raises(err):
        r.render_with_probe(cam.transform, **kw)


def _cli_scene(tmp_path):
    tree = synthetic.make_synthetic_tree("shell", depth=3, basis_dim=4)
    tree_path = str(tmp_path / "tree.npz")
    synthetic.save_npz(tree, tree_path)
    poses = {"camera_angle_x": 0.8, "frames": [
        {"file_path": f"./test/r_{i}",
         "transform_matrix": Camera().transform.tolist() + [[0, 0, 0, 1]]}
        for i in range(2)]}
    poses_path = str(tmp_path / "transforms_test.json")
    with open(poses_path, "w") as f:
        json.dump(poses, f)
    return tree_path, poses_path


def test_headless_buffers_match_jax_cli(tmp_path):
    """buf_*.bin: f32 [8, H, W] in the same byte layout as the JAX CLI's,
    equal to the JAX frame's f32 reassociation (aux bar 4e-5); the second
    pose is rendered after the 2^32 RNG advance."""
    from rt_octree_tpu.apps.headless import run as jax_run
    from rt_octree_tpu_torch.apps.headless import run
    tree_path, poses_path = _cli_scene(tmp_path)
    common = [tree_path, poses_path, "--write_buffer", "-w", "16",
              "--height", "16", "--spp", "2", "--warmup", "1",
              "--lut_levels", "3"]
    assert run(common + ["-o", str(tmp_path / "port"), "--device",
                         "cpu"]) == 0
    assert jax_run(common + ["-o", str(tmp_path / "jax")]) == 0
    for name in ("buf_r_0.bin", "buf_r_1.bin"):
        a = tmp_path / "port" / name
        b = tmp_path / "jax" / name
        assert a.stat().st_size == b.stat().st_size == 8 * 16 * 16 * 4
        np.testing.assert_allclose(np.fromfile(a, np.float32),
                                   np.fromfile(b, np.float32), atol=4e-5)
    aux0 = np.fromfile(tmp_path / "port" / "buf_r_0.bin",
                       np.float32).reshape(8, 16, 16)
    assert aux0[3].max() > 0.5


def test_headless_writes_pngs_and_refuses_unported_flags(tmp_path, capsys):
    from rt_octree_tpu_torch.apps.headless import run
    from rt_octree_tpu_torch.io.png import read_png
    tree_path, poses_path = _cli_scene(tmp_path)
    out = tmp_path / "png"
    assert run([tree_path, poses_path, "-o", str(out), "-w", "16",
                "--height", "16", "--spp", "2", "--warmup", "0",
                "--device", "cpu", "--lut_levels", "3"]) == 0
    assert read_png(str(out / "r_1.png")).shape == (16, 16, 4)
    assert "[Timer] frames: 2" in capsys.readouterr().out
    # every flag of the JAX CLI is ported; an unknown flag still exits 2
    assert run([tree_path, poses_path, "--no_such_flag",
                "--device", "cpu"]) == 2
    assert "unrecognized arguments: --no_such_flag" in capsys.readouterr().err
