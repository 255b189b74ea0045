"""The port's own copies of the JAX package's NumPy host code (core.options,
core.camera, core.sh_np, io.n3tree, io.poses, io.synthetic with
refine_tree, io.lod, apps.compress) against the originals on the same
inputs: equal arrays, equal metadata, equal npz files key by key."""

import dataclasses
import json
import os

import numpy as np
import pytest

from rt_octree_tpu.apps import compress as jcomp
from rt_octree_tpu.core import sh_np as jsh
from rt_octree_tpu.apps.compress import main as compress_main
from rt_octree_tpu.core import camera as jcam
from rt_octree_tpu.core import options as jopt
from rt_octree_tpu.io import lod as jlod
from rt_octree_tpu.io import n3tree as jn3
from rt_octree_tpu.io import poses as jposes
from rt_octree_tpu.io import synthetic as jsyn
from rt_octree_tpu_torch.apps import compress as tcomp
from rt_octree_tpu_torch.core import camera as tcam
from rt_octree_tpu_torch.core import options as topt
from rt_octree_tpu_torch.core import sh_np as tsh
from rt_octree_tpu_torch.io import lod as tlod
from rt_octree_tpu_torch.io import n3tree as tn3
from rt_octree_tpu_torch.io import poses as tposes
from rt_octree_tpu_torch.io import synthetic as tsyn

TREE_ARRAYS = ("data", "child", "offset", "scale", "extra", "ndc_avg_up",
               "ndc_avg_back", "ndc_avg_cen")
TREE_META = ("N", "data_dim", "capacity", "max_depth", "use_ndc",
             "ndc_width", "ndc_height", "ndc_focal")


def assert_trees_equal(got, ref):
    for name in TREE_ARRAYS:
        g, r = getattr(got, name), getattr(ref, name)
        assert (g is None) == (r is None), name
        if g is not None:
            assert g.dtype == r.dtype, name
            np.testing.assert_array_equal(g, r, err_msg=name)
    for name in TREE_META:
        assert getattr(got, name) == getattr(ref, name), name
    assert got.data_format.to_string() == ref.data_format.to_string()
    assert got.data_format.format.value == ref.data_format.format.value


@pytest.mark.parametrize("kind,depth,bd", [
    ("shell", 4, 9), ("blobs", 4, 4), ("solid", 3, 1), ("chain", 7, 1)])
def test_synthetic_trees_equal_the_originals(kind, depth, bd):
    if kind == "chain":
        got, ref = (m.make_deep_chain_tree(depth, bd) for m in (tsyn, jsyn))
    else:
        got, ref = (m.make_synthetic_tree(kind, depth=depth, basis_dim=bd)
                    for m in (tsyn, jsyn))
    assert_trees_equal(got, ref)


@pytest.mark.parametrize("kind", ["shell", "blobs", "solid"])
def test_threaded_synthetic_build_equals_the_original(kind, monkeypatch):
    """The port builds the occupancy grid and the leaf data in chunks on a
    thread pool; with chunks of 100 rows (many a level) the tree is still
    the original's, bit for bit."""
    monkeypatch.setattr(tsyn, "_ROWS", 100)
    monkeypatch.setattr(tsyn, "_WORKERS", 3)
    got, ref = (m.make_synthetic_tree(kind, depth=5, basis_dim=4)
                for m in (tsyn, jsyn))
    assert_trees_equal(got, ref)


def _legacy_npz(tree, path):
    """An npz without data_format and with a scalar invradius."""
    d = jsyn.tree_to_npz_dict(tree)
    del d["data_format"]
    d["invradius"] = np.float64(d.pop("invradius3")[0])
    np.savez(path, **d)


@pytest.mark.parametrize("layout", ["plain", "compressed", "legacy",
                                    "quantized", "llff_sidecar"])
def test_npz_loads_equal_the_originals(tmp_path, layout):
    tree = jsyn.make_synthetic_tree("shell", depth=3, basis_dim=4)
    path = str(tmp_path / "tree.npz")
    if layout == "compressed":
        np.savez_compressed(path, **jsyn.tree_to_npz_dict(tree))
    elif layout == "legacy":
        _legacy_npz(tree, path)
    else:
        jsyn.save_npz(tree, path)
    if layout == "quantized":
        out = str(tmp_path / "q")
        # 16-bit codebooks: the on-disk contract, which the JAX package's
        # optional C++ decode assumes (2^16 entries per codebook)
        assert compress_main([path, "--out_dir", out, "--retain", "1",
                              "--sigma_thresh", "0.0"]) == 0
        path = os.path.join(out, "tree.npz")
        with np.load(path) as z:
            assert "quant_colors" in z.files
    if layout == "llff_sidecar":
        pb = np.random.default_rng(1).random((5, 17)) + 0.5
        np.save(str(tmp_path / "tree_poses_bounds.npy"), pb)
    got, ref = tn3.load(path), jn3.load(path)
    assert_trees_equal(got, ref)
    assert got.npz_path == ref.npz_path == path
    assert got.use_ndc == (layout == "llff_sidecar")


def _write_poses(tmp_path, dataset):
    rs = np.random.default_rng(4)
    mats = rs.standard_normal((3, 4, 4)).astype(np.float32)
    mats[:, 3] = (0, 0, 0, 1)
    if dataset == "blender":
        path = tmp_path / "transforms_test.json"
        path.write_text(json.dumps({"camera_angle_x": 0.69, "frames": [
            {"file_path": f"r_{i}", "transform_matrix": m.tolist()}
            for i, m in enumerate(mats)]}))
    elif dataset == "tt":
        path = tmp_path / "pose"
        path.mkdir()
        np.savetxt(tmp_path / "intrinsics.txt", np.eye(4) * 500.0)
        for i, m in enumerate(mats):
            np.savetxt(path / f"{i:03d}.txt", m)
    else:
        path = tmp_path / "poses_bounds.npy"
        pb = np.concatenate([rs.standard_normal((3, 15)),
                             rs.random((3, 2)) + 1.0], 1)
        pb[:, 4], pb[:, 9], pb[:, 14] = 756.0, 1008.0, 800.0
        np.save(path, pb)
    return str(path)


@pytest.mark.parametrize("dataset", ["blender", "tt", "llff"])
@pytest.mark.parametrize("reverse_yz", [False, True])
def test_poses_equal_the_originals(tmp_path, dataset, reverse_yz):
    path = _write_poses(tmp_path, dataset)
    got = tposes.load_poses(dataset, path, 800, 800, reverse_yz=reverse_yz)
    ref = jposes.load_poses(dataset, path, 800, 800, reverse_yz=reverse_yz)
    np.testing.assert_array_equal(got.poses, ref.poses)
    assert (got.basenames, got.width, got.height, got.fx, got.fy,
            got.dataset_type) == (ref.basenames, ref.width, ref.height,
                                  ref.fx, ref.fy, ref.dataset_type)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_options_round_trip_through_json(tmp_path, direction):
    src_mod, dst_mod = (topt, jopt) if direction == "port_to_jax" else \
        (jopt, topt)
    src = src_mod.RenderOptions(spp=6, step_size=2e-4, sigma_thresh=0.5,
                                background_brightness=0.25, denoise=False,
                                probe=(0.1, 0.2, 0.3), estimator="classic")
    path = str(tmp_path / "opt.json")
    src.save_json(path)
    dst = dst_mod.RenderOptions.from_json_file(path)
    back = src_mod.RenderOptions.from_json_file(path)
    for f in dataclasses.fields(src):
        assert getattr(dst, f.name) == getattr(src, f.name), f.name
        assert getattr(back, f.name) == getattr(src, f.name), f.name
    assert dst.to_json_dict() == src.to_json_dict()
    with pytest.raises(ValueError):
        dst_mod.RenderOptions(spp=5).validate()


@pytest.mark.parametrize("pose", ["default", "set_pose"])
def test_camera_equals_the_original(pose):
    got, ref = (m.Camera(width=37, height=23, fx=40.0)
                for m in (tcam, jcam))
    if pose == "set_pose":
        c2w = np.random.default_rng(5).standard_normal((4, 4))
        got.set_pose(c2w)
        ref.set_pose(c2w)
    np.testing.assert_array_equal(got.transform, ref.transform)
    np.testing.assert_array_equal(got.w2c, ref.w2c)
    assert (got.fx, got.fy) == (ref.fx, ref.fy) == (40.0, 40.0)


def _refine(mod, base):
    thickness = max(3.0 / 2 ** 4, 0.02)
    return mod.refine_tree(
        base, lambda p: mod.shell_sigma(p, thickness=thickness,
                                        amplitude=4.0 / thickness),
        mod.position_color, levels=2)


def test_refine_tree_equals_the_original():
    """A depth-4 shell refined 2 levels (tests/test_deep_tree.py:92-110)."""
    got = _refine(tsyn, tsyn.make_synthetic_tree("shell", 4, 4))
    ref = _refine(jsyn, jsyn.make_synthetic_tree("shell", 4, 4))
    assert got.max_depth == 6
    assert_trees_equal(got, ref)


@pytest.fixture(scope="module")
def lod_tree():
    return jsyn.make_synthetic_tree("blobs", depth=6, basis_dim=4)


@pytest.mark.parametrize("depth", range(1, 8))
def test_lod_equals_the_original(lod_tree, depth):
    np.testing.assert_array_equal(
        tlod.node_depths(lod_tree.child, lod_tree.N3),
        jlod.node_depths(lod_tree.child, lod_tree.N3))
    got, ref = tlod.build_lod(lod_tree, depth), jlod.build_lod(lod_tree, depth)
    assert_trees_equal(got, ref)
    assert got.npz_path == ref.npz_path == ""
    assert got.max_depth == min(depth, 6)


@pytest.mark.parametrize("bits,weighted", [(4, False), (7, True)])
def test_median_cut_equals_the_original(bits, weighted):
    rs = np.random.default_rng(bits)
    pts = rs.standard_normal((3000, 3)).astype(np.float32)
    w = rs.random(3000) if weighted else None
    for got, ref in zip(tcomp.median_cut(pts, bits, w),
                        jcomp.median_cut(pts, bits, w)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_dicts_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype and g.shape == r.shape, k
        np.testing.assert_array_equal(g, r, err_msg=k)


@pytest.mark.parametrize("retain,weighted", [(1, False), (0, True)])
def test_compress_tree_dict_equals_the_original(retain, weighted):
    z = jsyn.tree_to_npz_dict(jsyn.make_synthetic_tree("shell", 4, 4))
    _assert_dicts_equal(
        tcomp.compress_tree_dict(z, 8, 0.0, retain, weighted),
        jcomp.compress_tree_dict(z, 8, 0.0, retain, weighted))


def test_compress_cli_writes_the_originals_npz(tmp_path):
    """Both CLIs with --retain 1 --sigma_thresh 0.0 (16-bit codebooks):
    the same keys and arrays, and the port's loader reads the result."""
    src = str(tmp_path / "tree.npz")
    jsyn.save_npz(jsyn.make_synthetic_tree("shell", 4, 4), src)
    outs = {}
    for name, main in (("port", tcomp.main), ("jax", compress_main)):
        out_dir = str(tmp_path / name)
        assert main([src, "--out_dir", out_dir, "--retain", "1",
                     "--sigma_thresh", "0.0"]) == 0
        outs[name] = os.path.join(out_dir, "tree.npz")
    got, ref = _npz(outs["port"]), _npz(outs["jax"])
    assert "quant_colors" in ref and "quant_map" in ref
    _assert_dicts_equal(got, ref)
    assert_trees_equal(tn3.load(outs["port"]), jn3.load(outs["jax"]))


@pytest.mark.parametrize("bd", [1, 4, 9, 16, 25])
def test_sh_basis_equals_the_original(bd):
    """core.sh_np.eval_sh_basis_np (the SH-lobe mesh tool's basis) on
    random unit directions of any batch shape: bit-equal to the
    original's."""
    rs = np.random.default_rng(bd)
    dirs = rs.standard_normal((7, 11, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for d in (dirs, dirs.astype(np.float32), dirs[0, 0]):
        got = tsh.eval_sh_basis_np(bd, d)
        ref = jsh.eval_sh_basis_np(bd, d)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
