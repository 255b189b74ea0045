"""Mesh compositing, the octree grid and the lumisphere probe in the port vs
the JAX package: the port's copies of io/mesh.py, io/wireframe.py and
render/raster.py against the originals, the composited frames, and the
headless CLI's new flags against the JAX CLI's dumps.

Tolerances: frames 1e-5 (K1's plain version agrees with the JAX march to
~1e-7; the mesh colour and the probe's sigmoid add a few f32 roundings);
copies of NumPy code exact.  The JAX renderers run with
``schedule=((0, 1),)``, one march phase without compaction: the same frame,
compiled in a quarter of the time."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_octree_tpu.core.camera import Camera
from rt_octree_tpu.core.options import RenderOptions
from rt_octree_tpu.io import mesh as jmesh
from rt_octree_tpu.io import synthetic
from rt_octree_tpu.io import wireframe as jwire
from rt_octree_tpu.io.n3tree import BasisFormat, DataFormat
from rt_octree_tpu.ops import traversal as jt
from rt_octree_tpu.render import raster as jraster
from rt_octree_tpu.render import renderer as jr
from rt_octree_tpu_torch.core.camera import Camera as TCamera
from rt_octree_tpu_torch.io import mesh as tmesh
from rt_octree_tpu_torch.io import wireframe as twire
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.render import probe as tprobe
from rt_octree_tpu_torch.render import raster as traster
from rt_octree_tpu_torch.render import renderer as tr
from rt_octree_tpu_torch.utils.timer import PhaseTimer

torch.set_num_threads(1)

TOL = 1e-5
NO_COMPACTION = ((0, 1),)
W = H = 32
OBJ = """v 0 0 0 1 0 0
v 0.5 0 0 0 1 0
v 0 0.5 0 0 0 1
v 0.5 0.5 0.2
vn 0 0 1
f 1//1 2//1 3//1 4//1
"""


def _drawlist(path):
    """A drawlist with every entry type the loader reads."""
    np.savez_compressed(
        path, box="cube", box__color=np.array([0.9, 0.1, 0.1]),
        box__scale=0.4, box__translation=np.array([0.1, 0.0, 0.0]),
        ball="sphere", ball__rings=6, ball__sectors=8, ball__scale=0.2,
        ball__rotation=np.array([0.0, 0.3, 0.0]),
        seg="line", seg__a=np.array([-1.0, 0.0, 0.0]),
        seg__b=np.array([1.0, 0.2, 0.0]),
        cams="camerafrustum", cams__t=np.array([[0, 0, 1.0], [0, 1, 1.0]]),
        cams__r=np.array([[0, 0, 0.0], [0, 0.5, 0]]), cams__connect=1,
        poly="lines", poly__points=np.random.default_rng(0).random((5, 3)),
        dots="points", dots__points=np.random.default_rng(1).random((7, 3)),
        tri="mesh", tri__points=np.random.default_rng(2).random((4, 3)),
        tri__faces=np.array([0, 1, 2, 1, 2, 3]), tri__unlit=1,
        hidden="cube", hidden__visible=0)


def _mesh_fields(m):
    return (m.vert, m.faces, m.face_size, m.name, m.visible, m.unlit,
            m.scale, m.translation, m.rotation)


def _assert_meshes_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for a, b in zip(_mesh_fields(g), _mesh_fields(r)):
            np.testing.assert_array_equal(a, b)


def test_mesh_copy_equals_the_original(tmp_path):
    path = str(tmp_path / "d.draw.npz")
    _drawlist(path)
    _assert_meshes_equal(tmesh.load_drawlist(path), jmesh.load_drawlist(path))
    _assert_meshes_equal(
        [tmesh.load_obj(OBJ, from_string=True), tmesh.lattice(3),
         tmesh.camera_frustum(), tmesh.sphere(5, 7)],
        [jmesh.load_obj(OBJ, from_string=True), jmesh.lattice(3),
         jmesh.camera_frustum(), jmesh.sphere(5, 7)])


@pytest.mark.parametrize("max_depth", [0, 1, 3, 6])
def test_wireframe_copy_equals_the_original(max_depth):
    tree = synthetic.make_synthetic_tree("shell", depth=4, basis_dim=1)
    np.testing.assert_array_equal(twire.gen_wireframe(tree, max_depth),
                                  jwire.gen_wireframe(tree, max_depth))


def test_raster_copy_equals_the_original(tmp_path):
    path = str(tmp_path / "d.draw.npz")
    _drawlist(path)
    cam_j, cam_t = Camera(width=48, height=40), TCamera(width=48, height=40)
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    got = traster.rasterize_meshes(tmesh.load_drawlist(path), cam_t, bg)
    ref = jraster.rasterize_meshes(jmesh.load_drawlist(path), cam_j, bg)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert np.isfinite(ref[1]).sum() > 50  # the meshes are in view


@pytest.fixture(scope="module")
def tree():
    return synthetic.make_synthetic_tree("shell", depth=4, basis_dim=9)


@pytest.fixture(scope="module")
def cam():
    return Camera(width=W, height=H, fx=40.0, fy=40.0)


@pytest.fixture(scope="module")
def mesh_pass(cam):
    """A cube in front of the shell, a line across it, background 1."""
    meshes = [jmesh.cube(color=(0.9, 0.1, 0.1), side=0.5),
              jmesh.line((-2.0, 0.0, 0.2), (2.0, 0.5, 0.2), (0.1, 0.8, 0.1))]
    color, depth = jraster.rasterize_meshes(
        meshes, cam, background=np.ones(3, np.float32))
    assert np.isfinite(depth).sum() > 20
    return color, depth


def _pair(tree, opt_kw, scale=1.0, lut_levels=4):
    """The JAX and the port renderer on one tree and options."""
    rj = jr.Renderer(jt.upload_tree(tree, lut_levels=lut_levels), W, H, 40.0,
                     40.0, options=RenderOptions(**opt_kw),
                     render_scale=scale, schedule=NO_COMPACTION)
    rp = tr.Renderer(tt.upload_tree(tree, lut_levels=lut_levels,
                                    device="cpu"), W, H, 40.0, 40.0,
                     options=RenderOptions(**opt_kw), render_scale=scale)
    return rj, rp


def _assert_frames(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_mesh_frame_matches_jax(tree, cam, mesh_pass, scale):
    """Depth clips the rays, colour shows through; under fast mode the
    full-size pass is sampled at the inner size by JAX's nearest rule."""
    rj, rp = _pair(tree, dict(spp=2, denoise=False), scale)
    color, depth = mesh_pass
    ref = rj.render(cam.transform, mesh_color=color, mesh_depth=depth)
    got = rp.render(cam.transform, mesh_color=color, mesh_depth=depth)
    _assert_frames(got, ref)
    plain = rp.render(cam.transform)
    assert not torch.equal(got[0], plain[0])


@pytest.mark.parametrize("with_mesh", [False, True])
def test_grid_frame_matches_jax(tree, cam, mesh_pass, with_mesh):
    """show_grid rasterizes the wireframe and merges it with the caller's
    pass (the nearer wins)."""
    rj, rp = _pair(tree, dict(spp=2, denoise=False, show_grid=True,
                              grid_max_depth=2))
    with pytest.raises(RuntimeError, match="set_grid_mesh"):
        rp.render(cam.transform)
    rj.set_grid_mesh(tree)
    rp.set_grid_mesh(tree)
    kw = {}
    if with_mesh:
        kw = dict(mesh_color=mesh_pass[0], mesh_depth=mesh_pass[1])
    _assert_frames(rp.render(cam.transform, **kw),
                   rj.render(cam.transform, **kw))


@pytest.mark.parametrize("fmt,disp", [("sh", 10), ("sh", 45), ("rgba", 12)])
def test_probe_overlay_matches_jax(tree, cam, fmt, disp):
    """The lumisphere disc in the top-right corner, the rest of the corner
    square black; a display larger than the frame is clipped.  The port's
    probe frame is held to the JAX package's lookup and overlay drawn on
    the port's own frame (the frame without the probe is held to the JAX
    renderer by the mesh, grid and frame tests)."""
    from rt_octree_tpu.render import probe as jprobe
    t = tree
    if fmt == "rgba":
        t = synthetic.make_synthetic_tree("shell", depth=4, basis_dim=1)
        t.data_format = DataFormat(BasisFormat.RGBA, -1)
    opt = RenderOptions(spp=2, denoise=False, enable_probe=True,
                        probe=(0.0, 0.0, 0.3), probe_disp_size=disp,
                        basis_minmax=(0, 3))
    rp = tr.Renderer(tt.upload_tree(t, lut_levels=4, device="cpu"), W, H,
                     40.0, 40.0, options=opt)
    got = rp.render_with_probe(cam.transform)
    frame = rp.render(cam.transform)
    assert torch.equal(got[1], frame[1])
    tree_j = jt.upload_tree(t, lut_levels=4)
    coeffs_j = jprobe.retrieve_cursor_lumisphere(
        tree_j, jnp.asarray(opt.probe, jnp.float32))
    ref = jprobe.apply_probe_overlay(
        jnp.asarray(frame[0].numpy()), tree_j,
        jnp.asarray(cam.transform, jnp.float32), coeffs_j,
        basis_minmax=opt.basis_minmax, probe_disp_size=disp)
    _assert_frames(got[:1], (ref,))
    corner = got[0][:min(disp + 5, H), max(W - disp - 5, 0):, :3]
    assert float(corner.abs().max()) > 0 and float(corner.min()) == 0.0
    assert bool((got[0][..., 3] == 1).all())
    coeffs = tprobe.retrieve_cursor_lumisphere(rp.tree, (0.0, 0.0, 0.3))
    assert coeffs.shape == (t.data_dim - 1,)
    np.testing.assert_array_equal(coeffs.numpy(), np.asarray(coeffs_j))
    with pytest.raises(ValueError, match="probe point"):
        tprobe.retrieve_cursor_lumisphere(rp.tree, (0.0, 0.3))


def test_render_timed_with_mesh_and_probe(tree, cam, mesh_pass):
    """render_timed takes a mesh pass and draws the probe after the
    denoise; like the JAX package it runs no grid pass, and it refuses a
    mesh pass under fast mode."""
    opt = dict(spp=2, denoise=False, enable_probe=True, probe=(0, 0, 0.3),
               probe_disp_size=8)
    _, rp = _pair(tree, opt)
    color, depth = mesh_pass
    timer = PhaseTimer("cpu")
    got = tr.render_timed(rp, cam.transform, timer, mesh_color=color,
                          mesh_depth=depth, probe=True)
    ref = rp.render_with_probe(cam.transform, mesh_color=color,
                               mesh_depth=depth)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert timer.cnt == 1
    _, fast = _pair(tree, opt, scale=0.5)
    with pytest.raises(NotImplementedError, match="fast mode"):
        tr.render_timed(fast, cam.transform, timer, mesh_color=color,
                        mesh_depth=depth)
    with pytest.raises(ValueError, match="mesh pass"):
        rp.render(cam.transform, mesh_color=color[:4], mesh_depth=depth)
    # a scale that rounds to the output size is not fast mode
    near = tr.Renderer(rp.tree, W, H, 40.0, 40.0, options=rp.options,
                       render_scale=0.99)
    assert not near.fast
    again = tr.render_timed(near, cam.transform, timer, mesh_color=color,
                            mesh_depth=depth, probe=True)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


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
    draw = str(tmp_path / "d.draw.npz")
    np.savez_compressed(draw, marker="cube",
                        marker__color=np.array([0.9, 0.1, 0.1]),
                        marker__scale=0.4)
    return tree_path, poses_path, draw


@pytest.mark.parametrize("flags", [
    ["--render_scale", "0.5", "--grid", "1", "--probe", "0,0,0.6"],
    ["--estimator", "classic", "--draw", "DRAW", "--probe", "0,0,0.6",
     "--auto_schedule"],
])
def test_headless_new_flags_match_jax_cli(tmp_path, monkeypatch, flags):
    """--write_buffer dumps equal to the JAX CLI's within 1e-5, and the
    PNGs (with the probe drawn) within one 8-bit level.  The JAX CLI's
    renderer marches without compaction (its own --auto_schedule tuner
    included): the same frames, compiled in a quarter of the time."""
    from rt_octree_tpu.apps import headless as jax_headless
    from rt_octree_tpu.apps.headless import run as jax_run
    from rt_octree_tpu.io.images import read_png as jax_read_png
    from rt_octree_tpu_torch.apps.headless import run
    from rt_octree_tpu_torch.io.png import read_png
    from rt_octree_tpu.render import schedule as jschedule

    def no_compaction(*args, **kw):
        return jr.Renderer(*args, **{**kw, "schedule": NO_COMPACTION})
    monkeypatch.setattr(jax_headless, "Renderer", no_compaction)
    monkeypatch.setattr(jschedule, "auto_schedule",
                        lambda *a, **k: (NO_COMPACTION, 4))
    tree_path, poses_path, draw = _cli_scene(tmp_path)
    flags = [draw if f == "DRAW" else f for f in flags]
    common = [tree_path, poses_path, "-w", "16", "--height", "16", "--spp",
              "2", "--warmup", "1", "--lut_levels", "3"] + flags
    for kind in ("buf", "png"):
        extra = ["--write_buffer"] if kind == "buf" else []
        assert run(common + extra + ["-o", str(tmp_path / f"port_{kind}"),
                                     "--device", "cpu"]) == 0
        assert jax_run(common + extra + ["-o",
                                         str(tmp_path / f"jax_{kind}")]) == 0
    for i in range(2):
        a = np.fromfile(tmp_path / "port_buf" / f"buf_r_{i}.bin", np.float32)
        b = np.fromfile(tmp_path / "jax_buf" / f"buf_r_{i}.bin", np.float32)
        assert a.shape == b.shape == (8 * 16 * 16,)
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
        pa = read_png(str(tmp_path / "port_png" / f"r_{i}.png"))
        pb = jax_read_png(str(tmp_path / "jax_png" / f"r_{i}.png"))
        assert np.abs(pa.astype(int) - pb.astype(int)).max() <= 1
    assert a.reshape(8, 16, 16)[3].max() > 0.5


def test_headless_profile_writes_a_trace(tmp_path):
    from rt_octree_tpu_torch.apps.headless import run
    tree_path, poses_path, _ = _cli_scene(tmp_path)
    prof = tmp_path / "prof"
    assert run([tree_path, poses_path, "-w", "8", "--height", "8",
                "--warmup", "0", "--lut_levels", "3", "--device", "cpu",
                "--profile", str(prof)]) == 0
    with open(prof / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert os.path.getsize(prof / "trace.json") > 0
