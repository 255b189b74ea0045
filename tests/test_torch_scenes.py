"""The scene and tree paths beyond the headline shell, in the port vs the JAX
package: an NDC frame of the llff scene's kind (the blobs tree at 40x30,
NDC fields scaled as RT_BENCH_LLFF_SCALE scales them), a frame of an LOD
tree, the quantized-vs-float frame pair of tests/test_quant_e2e.py with the
tree compressed by the port's dispatcher, and the dispatcher itself
(``python -m rt_octree_tpu_torch.apps.cli``) against the JAX package's.

Tolerances are the frame bars of tests/test_torch_render.py (img 2e-5, aux
4e-5); files written by copies of NumPy code are equal key by key.  The JAX
renderers run with ``schedule=((0, 1),)``: the same frame, compiled in a
quarter of the time."""

import json
import os

import numpy as np
import pytest
import torch

from rt_octree_tpu.apps import cli as jcli
from rt_octree_tpu.apps.compress import main as jcompress
from rt_octree_tpu.core.camera import Camera
from rt_octree_tpu.core.options import RenderOptions
from rt_octree_tpu.io import lod as jlod
from rt_octree_tpu.io import n3tree as jn3
from rt_octree_tpu.io import synthetic
from rt_octree_tpu.ops import traversal as jt
from rt_octree_tpu.render import renderer as jr
from rt_octree_tpu_torch.apps import cli as tcli
from rt_octree_tpu_torch.apps import headless as theadless
from rt_octree_tpu_torch.io import lod as tlod
from rt_octree_tpu_torch.io import n3tree as tn3
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.render import renderer as tr

torch.set_num_threads(1)

IMG_TOL, AUX_TOL = 2e-5, 4e-5
NO_COMPACTION = ((0, 1),)
# bench.py's scene options (bench.py:363-364)
SCENE_OPT = dict(spp=6, denoise=False, step_size=1e-4, sigma_thresh=1e-2,
                 background_brightness=1.0)


def _pair(tree, ptree, cam, opt, lut_levels):
    """(port img, port aux, JAX img, JAX aux) as NumPy: ``tree`` through the
    JAX package, ``ptree`` (the port's copy, or the same tree) through the
    port, from one camera."""
    rj = jr.Renderer(jt.upload_tree(tree, lut_levels=lut_levels), cam.width,
                     cam.height, cam.fx, cam.fy, options=opt,
                     schedule=NO_COMPACTION)
    rp = tr.Renderer(tt.upload_tree(ptree, lut_levels=lut_levels,
                                    device="cpu"), cam.width, cam.height,
                     cam.fx, cam.fy, options=opt)
    img_j, aux_j = rj.render(cam.transform)
    img, aux = rp.render(cam.transform)
    return img.numpy(), aux.numpy(), np.asarray(img_j), np.asarray(aux_j)


def _assert_frames(img, aux, img_j, aux_j):
    np.testing.assert_allclose(img, img_j, atol=IMG_TOL)
    np.testing.assert_allclose(aux, aux_j, atol=AUX_TOL)


def test_llff_ndc_frame_matches_jax():
    """bench.py:llff_scene_fps at 40x30: the blobs tree in NDC, the
    forward-facing camera, the scene options."""
    s = 40 / 1008
    W, H, focal = 40, 30, 800.0 * s
    tree = synthetic.make_synthetic_tree("blobs", depth=5, basis_dim=4)
    tree.use_ndc = True
    tree.ndc_width, tree.ndc_height, tree.ndc_focal = float(W), float(H), \
        focal
    cam = Camera(width=W, height=H, fx=focal, fy=focal)
    cam.center = np.array([0.02, 0.01, 0.3], np.float32)
    cam.v_back = np.array([0.0, 0.0, 1.0], np.float32)
    cam.v_world_up = np.array([0.0, 1.0, 0.0], np.float32)
    cam.update()
    img, aux, img_j, aux_j = _pair(tree, tree, cam,
                                   RenderOptions(**SCENE_OPT), 5)
    _assert_frames(img, aux, img_j, aux_j)
    assert aux[3].max() > 0.5  # the blobs are in view


def test_lod_frame_matches_jax():
    """A depth-6 tree pooled to depth 4 by each package's build_lod."""
    tree = synthetic.make_synthetic_tree("shell", depth=6, basis_dim=4)
    ptree = tlod.build_lod(tn3.from_npz_dict(
        synthetic.tree_to_npz_dict(tree)), 4)
    jtree = jlod.build_lod(tree, 4)
    assert ptree.max_depth == jtree.max_depth == 4
    cam = Camera(width=24, height=24, fx=40.0, fy=40.0)
    _assert_frames(*_pair(jtree, ptree, cam, RenderOptions(**SCENE_OPT), 4))


def test_quantized_pair_matches_jax(tmp_path):
    """tests/test_quant_e2e.py:44: a depth-4 shell compressed with --retain
    1 --sigma_thresh 0.0, by the port's dispatcher and by the JAX CLI; each
    package renders its float and its quantized tree, and the two pairs
    agree."""
    tree = synthetic.make_synthetic_tree("shell", depth=4, basis_dim=4)
    src = str(tmp_path / "tree.npz")
    synthetic.save_npz(tree, src)
    flags = ["--retain", "1", "--sigma_thresh", "0.0"]
    assert tcli.main(["compress", src, "--out_dir",
                      str(tmp_path / "port")] + flags) == 0
    assert jcompress([src, "--out_dir", str(tmp_path / "jax")] + flags) == 0
    cam = Camera(width=24, height=24, fx=40.0, fy=40.0)
    opt = RenderOptions(spp=2, denoise=False)
    frames = {}
    for label, port_path, jax_path in (
            ("float", src, src),
            ("quant", str(tmp_path / "port" / "tree.npz"),
             str(tmp_path / "jax" / "tree.npz"))):
        jtree, ptree = jn3.load(jax_path), tn3.load(port_path)
        frames[label] = _pair(jtree, ptree, cam, opt, jtree.max_depth)
        _assert_frames(*frames[label])
    with np.load(str(tmp_path / "port" / "tree.npz")) as z:
        assert "quant_colors" in z.files and "data" not in z.files


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("command", ["lod", "compress"])
def test_dispatcher_writes_what_the_jax_dispatcher_writes(tmp_path,
                                                          command):
    tree = synthetic.make_synthetic_tree("blobs", depth=5, basis_dim=4)
    src = str(tmp_path / "tree.npz")
    synthetic.save_npz(tree, src)
    outs = {}
    for name, main in (("port", tcli.main), ("jax", jcli.main)):
        if command == "lod":
            outs[name] = str(tmp_path / f"{name}.npz")
            argv = ["lod", src, "-d", "3", "-o", outs[name]]
        else:
            outs[name] = str(tmp_path / name / "tree.npz")
            argv = ["compress", src, "--out_dir", str(tmp_path / name),
                    "--retain", "1", "--bits", "10"]
        assert main(argv) == 0
    got, ref = _npz(outs["port"]), _npz(outs["jax"])
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_dispatcher_render_is_the_headless_cli(tmp_path):
    """``render`` runs apps/headless.run: the same aux dumps, byte for
    byte, as the headless CLI called directly."""
    synthetic.save_npz(synthetic.make_synthetic_tree("shell", 3, 4),
                       str(tmp_path / "tree.npz"))
    pose = Camera().transform.tolist() + [[0, 0, 0, 1]]
    with open(tmp_path / "poses.json", "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": [
            {"file_path": "./test/r_0", "transform_matrix": pose}]}, f)
    dumps = {}
    for name, run in (("cli", lambda a: tcli.main(["render"] + a)),
                      ("headless", theadless.run)):
        out = tmp_path / name
        assert run([str(tmp_path / "tree.npz"), str(tmp_path / "poses.json"),
                    "-o", str(out), "-w", "8", "--height", "8", "--warmup",
                    "0", "--device", "cpu", "--lut_levels", "3",
                    "--write_buffer"]) == 0
        dumps[name] = sorted(os.listdir(out))
        assert dumps[name]
        for fname in dumps[name]:
            dumps[name, fname] = (out / fname).read_bytes()
    assert dumps["cli"] == dumps["headless"]
    for fname in dumps["cli"]:
        assert dumps["cli", fname] == dumps["headless", fname], fname


@pytest.mark.parametrize("command", ["view", "anim", "tools"])
def test_dispatcher_refuses_what_is_not_ported(command, capsys):
    """Nothing is left unported (the name is kept from when these three
    commands were refused): each answers ``--help`` with its own argparse
    help, exit 0, and no refusal."""
    with pytest.raises(SystemExit) as e:
        tcli.main([command, "--help"])
    assert e.value.code == 0
    out, err = capsys.readouterr()
    assert "not yet ported" not in err and f"rtoctree-{command}" in out


def test_dispatcher_train_help_exits_0(capsys):
    """``rtoctree train --help`` is the training CLI's argparse help."""
    with pytest.raises(SystemExit) as e:
        tcli.main(["train", "--help"])
    assert e.value.code == 0
    assert "--config" in capsys.readouterr().out


def test_dispatcher_help_prints_the_docstring(capsys):
    assert tcli.__doc__ == jcli.__doc__
    for argv in ([], ["-h"], ["--help"]):
        assert tcli.main(argv) == 0
        assert capsys.readouterr().out == jcli.__doc__ + "\n"
    assert tcli.main(["bogus"]) == 2
    assert "unknown command: bogus" in capsys.readouterr().err
