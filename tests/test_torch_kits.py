"""The port's kit tools against the JAX package's tools, on the CPU.

The JAX tools run in subprocesses (JAX_PLATFORMS=cpu, RT_BENCH_DEPTH=5,
f32 train buffers), as tests/test_apps.py runs them; the port's tools then
read the tree npz that the JAX run cached, so both render the same tree:

  * make_quality_dataset, blobs (NDC, forward poses) at QD_SCALE=0.04
    (40x30, focal 32), 2 + 2 poses: transforms equal, buffers within K1's
    bars, GT PNGs within one 8-bit level;
  * make_fast_kit on the shell at 32x32, 2 train poses, against a 2-pose
    GT kit made by the port and a random net written by the port's
    save_compact: transforms equal, test PNGs byte-equal to the GT kit's,
    buffers within K1's and K4's bars, teacher PNGs within one level;
  * eval_gnet_kit on that kit: the port's means against the JAX tool's
    printed ones.

The poses of solid and tt against the JAX tool's own orbit_pose (the
module loaded by path under its QD_* variables), the committed kits'
test poses, the layout of --gt_only and --splits, make_fast_kit's --lod
and its teacher under denoise_recommended=false, set_gnet_meta byte for
byte against the JAX tool, and the tools' refusal to run without a card
unless --device cpu is given need no JAX run.
"""

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rt_octree_tpu_torch.io import n3tree, synthetic
from rt_octree_tpu_torch.io.lod import build_lod
from rt_octree_tpu_torch.io.png import read_png, to_uint8
from rt_octree_tpu_torch.models.guidance_net import (GuidanceNetConfig,
                                                     compact_and_export,
                                                     init_params)
from rt_octree_tpu_torch.ops.traversal import upload_tree
from rt_octree_tpu_torch.render.renderer import Renderer
from rt_octree_tpu_torch.tools import eval_gnet_kit as ek
from rt_octree_tpu_torch.tools import make_fast_kit as fk
from rt_octree_tpu_torch.tools import make_quality_dataset as mq
from rt_octree_tpu_torch.tools import set_gnet_meta as sm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = 5
# K1 vs the JAX march (img, aux channels), and K4's upsample on top
K1_IMG_TOL, K1_AUX_TOL, K4_TOL = 2e-5, 4e-5, 1e-6
BLOBS_SCALE = 0.04  # 1008x756, focal 800 -> 40x30, focal 32
FAST_RES = 32
JAX_TIMEOUT = 600
MEAN_LINE = re.compile(r"^(\S+): psnr=(\S+) psnr_obj=(\S+) ssim=(\S+)$")


def jax_env(cache, **qd):
    return {**os.environ, "JAX_PLATFORMS": "cpu",
            "RT_BENCH_CACHE": str(cache), "RT_BENCH_DEPTH": str(DEPTH),
            "QD_F16_TRAIN_BUFS": "0", **qd}


def random_net(path, seed=0):
    cfg = GuidanceNetConfig()
    compact_and_export(cfg, init_params(cfg,
                                        torch.Generator().manual_seed(seed)),
                       str(path))


# the JAX fast kit, then the JAX evaluation on its test split, in one
# process (tools/make_fast_kit.py and tools/eval_gnet_kit.py as scripts)
FAST_AND_EVAL = """
import runpy, sys
sys.argv = ["make_fast_kit.py"]
runpy.run_path("tools/make_fast_kit.py", run_name="__main__")
sys.argv = ["eval_gnet_kit.py"] + {argv!r}
runpy.run_path("tools/eval_gnet_kit.py", run_name="__main__")
"""


@pytest.fixture(scope="module")
def kits(tmp_path_factory):
    """Both JAX runs, side by side: the blobs kit, and the shell fast kit
    with its evaluation.  The fast kit's GT kit (2 test poses, 32x32) and
    its random trained.gnet are the port's."""
    root = tmp_path_factory.mktemp("kits")
    cache = root / "cache"
    gt = root / "gt_kit"
    assert mq.main(["--out", str(gt), "--gt_only", "--n_test", "2",
                    "--res", str(FAST_RES), "--depth", "3",
                    "--device", "cpu"]) == 0
    random_net(gt / "trained.gnet")
    runs = {
        "blobs": subprocess.Popen(
            [sys.executable, os.path.join("tools",
                                          "make_quality_dataset.py")],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=jax_env(
                cache, QD_SCENE="blobs", QD_SCALE=str(BLOBS_SCALE),
                QD_TRAIN="2", QD_TEST="2", QD_OUT=str(root / "jax_blobs"))),
        "fast": subprocess.Popen(
            [sys.executable, "-c", FAST_AND_EVAL.format(argv=[
                str(root / "jax_fast"), str(gt / "trained.gnet")])],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=jax_env(
                cache, QD_RES=str(FAST_RES), QD_TRAIN="2",
                QD_FAST_SCALE="0.5", QD_GT_KIT=str(gt),
                QD_OUT=str(root / "jax_fast"))),
    }
    out = {}
    try:
        for name, p in runs.items():
            stdout, stderr = p.communicate(timeout=JAX_TIMEOUT)
            assert p.returncode == 0, (name, stdout[-2000:], stderr[-2000:])
            out[name] = stdout
    finally:
        for p in runs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    jax_means = {}
    for line in out["fast"].splitlines():
        m = MEAN_LINE.match(line)
        if m:
            jax_means[m[1]] = tuple(float(v) for v in m.groups()[1:])
    return {"root": root, "cache": cache, "gt": gt, "jax_means": jax_means}


def assert_same_transforms(a, b):
    for split in ("train", "test"):
        with open(a / f"transforms_{split}.json") as f:
            ja = json.load(f)
        with open(b / f"transforms_{split}.json") as f:
            jb = json.load(f)
        assert ja["camera_angle_x"] == jb["camera_angle_x"]
        assert [fr["file_path"] for fr in ja["frames"]] == \
            [fr["file_path"] for fr in jb["frames"]]
        for fa, fb in zip(ja["frames"], jb["frames"]):
            np.testing.assert_array_equal(
                np.asarray(fa["transform_matrix"], np.float32),
                np.asarray(fb["transform_matrix"], np.float32))


def assert_buffers_close(a, b, split, names, img_tol, aux_tol, size):
    for name in names:
        x = np.fromfile(a / "spp_6" / split / f"buf_{name}.bin", np.float32)
        y = np.fromfile(b / "spp_6" / split / f"buf_{name}.bin", np.float32)
        assert x.size == y.size == 8 * size
        x, y = x.reshape(8, -1), y.reshape(8, -1)
        assert np.isfinite(y).all()
        np.testing.assert_allclose(y[:4], x[:4], rtol=0, atol=img_tol)
        np.testing.assert_allclose(y[4:], x[4:], rtol=0, atol=aux_tol)


def assert_pngs_within_a_level(a, b, split, names):
    """At most one 8-bit level apart; prints the share of unequal
    pixels."""
    for name in names:
        p = read_png(str(a / split / f"{name}.png")).astype(np.int16)
        q = read_png(str(b / split / f"{name}.png")).astype(np.int16)
        assert p.shape == q.shape
        share = float((p != q).any(-1).mean())
        print(f"{split}/{name}.png: max |diff| {np.abs(p - q).max()}, "
              f"unequal pixels {share:.4f}")
        assert np.abs(p - q).max() <= 1


def test_quality_kit_blobs_matches_jax(kits, tmp_path):
    """The blobs kit (NDC warp on the host tree, forward poses, 40x30,
    focal 32) against the JAX tool's."""
    out = tmp_path / "kit"
    assert mq.main([
        "--out", str(out), "--scene", "blobs", "--scale", str(BLOBS_SCALE),
        "--n_train", "2", "--n_test", "2", "--device", "cpu",
        "--tree", str(kits["cache"] / f"blobs_d{DEPTH}_sh9.npz")]) == 0
    ref = kits["root"] / "jax_blobs"
    assert_same_transforms(ref, out)
    for split in ("train", "test"):
        names = ["r_0", "r_1"]
        assert_buffers_close(ref, out, split, names, K1_IMG_TOL,
                             K1_AUX_TOL, 40 * 30)
        assert_pngs_within_a_level(ref, out, split, names)


def test_fast_kit_matches_jax(kits, tmp_path):
    """The shell fast kit at s = 0.5 (K1 at 16x16, K4 to 32x32; the
    teacher denoised by the GT kit's net) against the JAX tool's."""
    out = tmp_path / "fast"
    assert fk.main([
        "--out", str(out), "--res", str(FAST_RES), "--n_train", "2",
        "--gt_kit", str(kits["gt"]), "--device", "cpu",
        "--tree", str(kits["cache"] / f"shell_d{DEPTH}_sh9.npz")]) == 0
    ref = kits["root"] / "jax_fast"
    assert_same_transforms(ref, out)
    for name in ("r_0", "r_1"):
        assert ((out / "test" / f"{name}.png").read_bytes()
                == (kits["gt"] / "test" / f"{name}.png").read_bytes())
    for split in ("train", "test"):
        assert_buffers_close(ref, out, split, ["r_0", "r_1"],
                             K1_IMG_TOL + K4_TOL, K1_AUX_TOL + K4_TOL,
                             FAST_RES * FAST_RES)
    assert_pngs_within_a_level(ref, out, "train", ["r_0", "r_1"])


def test_eval_gnet_kit_matches_jax(kits, capsys):
    """The port's evaluation of the JAX fast kit's test split against the
    JAX tool's printed means (3 and 5 decimals)."""
    net = str(kits["gt"] / "trained.gnet")
    means = ek.main([str(kits["root"] / "jax_fast"), net, "--device", "cpu"])
    printed = capsys.readouterr().out
    jm = kits["jax_means"]
    assert set(jm) == set(means) == {"noisy", net}
    for key, (psnr, psnr_obj, ssim) in jm.items():
        got = means[key]
        assert got["poses"] == 2
        assert abs(got["psnr"] - psnr) <= 1e-3
        assert abs(got["psnr_obj"] - psnr_obj) <= 1e-3
        assert abs(got["ssim"] - ssim) <= 1e-5
        assert (f"{key}: psnr={got['psnr']:.3f} psnr_obj="
                f"{got['psnr_obj']:.3f} ssim={got['ssim']:.5f}") in printed


@pytest.fixture
def jax_tool(monkeypatch):
    """Load tools/make_quality_dataset.py by path under QD_* variables; the
    JAX config values that its import sets are restored after."""
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}

    def load(**qd):
        for k, v in qd.items():
            monkeypatch.setenv(k, v)
        spec = importlib.util.spec_from_file_location(
            "jax_make_quality_dataset",
            os.path.join(REPO, "tools", "make_quality_dataset.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    yield load
    for k, v in keep.items():
        jax.config.update(k, v)


@pytest.mark.parametrize("scene,scale", [("solid", 1.0), ("tt", 1.0),
                                         ("tt", 0.04), ("solid", 0.04),
                                         ("blobs", 1.0)])
def test_quality_kit_poses_match_the_jax_tool(jax_tool, scene, scale):
    """Sizes, focal and every camera against the JAX tool's own pose
    functions, drawn in its order (default_rng(7), train then test)."""
    jt = jax_tool(QD_SCENE=scene, QD_SCALE=str(scale))
    W, H, focal = mq.scene_frame(scene, 800, scale)
    assert (W, H, focal) == (jt.W, jt.H, jt.FOCAL)
    assert mq.tree_kind(scene) == jt.TREE_KIND
    poses = mq.kit_poses(scene, 3, 2, W, H, focal)
    rng = np.random.default_rng(7)
    for split in ("train", "test"):
        for cam in poses[split]:
            if scene == "blobs":
                ref = jt.forward_pose(
                    rng.uniform(-0.2, 0.2), rng.uniform(-0.15, 0.15),
                    rng.uniform(0.15, 0.45), rng.uniform(-0.08, 0.08),
                    rng.uniform(-0.08, 0.08))
            else:
                azim = rng.uniform(0, 2 * np.pi)
                elev = rng.uniform(np.deg2rad(-25), np.deg2rad(65))
                ref = jt.orbit_pose(azim, elev)
            assert (cam.width, cam.height, cam.fx, cam.fy) == \
                (ref.width, ref.height, ref.fx, ref.fy)
            np.testing.assert_array_equal(cam.transform, ref.transform)


@pytest.mark.parametrize("kit,n_train", [("quality", 32),
                                         ("quality_solid", 16),
                                         ("quality_tt", 16),
                                         ("quality_blobs", 16)])
def test_committed_kits_are_the_tools_poses(kit, n_train):
    """The committed kits' test poses are this tool's at full size with
    n_train train poses drawn first (32 for the shell, 16 for the rest)."""
    scene = kit.partition("_")[2] or "shell"
    with open(os.path.join(REPO, "benchmarks", kit,
                           "transforms_test.json")) as f:
        committed = json.load(f)
    W, H, focal = mq.scene_frame(scene, 800)
    cams = mq.kit_poses(scene, n_train, len(committed["frames"]), W, H,
                        focal)["test"]
    assert abs(2 * np.arctan(W / (2 * cams[0].fx))
               - committed["camera_angle_x"]) <= 1e-12
    for cam, fr in zip(cams, committed["frames"]):
        np.testing.assert_array_equal(
            mq.frame_entry("test", "r", cam.transform)["transform_matrix"],
            fr["transform_matrix"])


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    path = tmp_path_factory.mktemp("tree") / "shell_d4.npz"
    synthetic.save_npz(synthetic.make_synthetic_tree("shell", 4, 9),
                       str(path))
    return path


@pytest.mark.parametrize("flags,splits,buffers,warns", [
    (["--gt_only"], ["test"], False, False),
    (["--gt_only", "--splits", "train,test"], ["train", "test"], False,
     True),
    (["--splits", "train"], ["train"], True, False),
])
def test_gt_only_and_splits_layout(tiny_tree, tmp_path, capsys, flags,
                                   splits, buffers, warns):
    """--gt_only renders no spp_6/ (the test split alone by default, a
    warning for a train split); --splits picks the splits."""
    out = tmp_path / "kit"
    assert mq.main(["--out", str(out), "--tree", str(tiny_tree),
                    "--n_train", "1", "--n_test", "1", "--res", "12",
                    "--device", "cpu"] + flags) == 0
    assert ("[warn]" in capsys.readouterr().err) == warns
    listed = sorted(os.listdir(out))
    want = sorted(splits + [f"transforms_{s}.json" for s in splits]
                  + (["spp_6"] if buffers else []))
    assert listed == want
    if buffers:
        assert sorted(os.listdir(out / "spp_6")) == splits
    for s in splits:
        assert os.listdir(out / s) == ["r_0.png"]


def test_fast_kit_lod_student(tiny_tree, tmp_path):
    """--lod D: the student marches build_lod(tree, D) at the fast scale
    (LUT min(9, D)), the teacher the full tree."""
    gt = tmp_path / "gt"
    assert mq.main(["--out", str(gt), "--tree", str(tiny_tree), "--gt_only",
                    "--n_test", "1", "--res", "16", "--device", "cpu"]) == 0
    random_net(gt / "trained.gnet")
    bufs = {}
    for lod in (0, 3):
        out = tmp_path / f"lod{lod}"
        assert fk.main(["--out", str(out), "--tree", str(tiny_tree),
                        "--res", "16", "--n_train", "2", "--lod", str(lod),
                        "--gt_kit", str(gt), "--device", "cpu"]) == 0
        bufs[lod] = [np.fromfile(out / "spp_6" / "train" / f"buf_r_{i}.bin",
                                 np.float32) for i in range(2)]
    tree = build_lod(n3tree.load(str(tiny_tree)), 3)
    cams = fk.train_poses("shell", 2, 16, 16)
    r = Renderer(upload_tree(tree, lut_levels=3, device="cpu"), 16, 16,
                 cams[0].fx, cams[0].fy, options=fk.kit_options(False),
                 render_scale=0.5)
    for i, cam in enumerate(cams):
        aux = r.render(cam.transform)[1].numpy().reshape(-1)
        r.advance_rng()
        np.testing.assert_array_equal(bufs[3][i], aux)
        assert not np.array_equal(bufs[0][i], aux)


def test_fast_kit_teacher_follows_denoise_advice(tiny_tree, tmp_path,
                                                 capsys):
    """A net stamped denoise_recommended=false: the teacher's frames are
    its noisy full-size frames, PCG32 advanced a frame."""
    gt = tmp_path / "gt"
    assert mq.main(["--out", str(gt), "--tree", str(tiny_tree), "--gt_only",
                    "--n_test", "1", "--res", "16", "--device", "cpu"]) == 0
    random_net(gt / "trained.gnet")
    sm.set_meta(str(gt / "trained.gnet"), {"denoise_recommended": False})
    out = tmp_path / "kit"
    assert fk.main(["--out", str(out), "--tree", str(tiny_tree), "--res",
                    "16", "--n_train", "2", "--splits", "train",
                    "--gt_kit", str(gt), "--device", "cpu"]) == 0
    assert "teacher denoise OFF" in capsys.readouterr().out
    assert not (out / "test").exists()
    cams = fk.train_poses("shell", 2, 16, 16)
    r = Renderer(upload_tree(n3tree.load(str(tiny_tree)), lut_levels=4,
                             device="cpu"), 16, 16, cams[0].fx, cams[0].fy,
                 options=fk.kit_options(False))
    for i, cam in enumerate(cams):
        img = r.render(cam.transform, want_aux=False)[0]
        r.advance_rng()
        np.testing.assert_array_equal(
            read_png(str(out / "train" / f"r_{i}.png")),
            to_uint8(img[..., :3].numpy()))


def test_fast_kit_blobs_train_poses_follow_the_jax_draw_order():
    """make_fast_kit's blobs poses draw the view direction before the
    centre (tools/make_fast_kit.py:185-192), unlike make_quality_dataset;
    its orbit poses are make_quality_dataset's under default_rng(20230418)."""
    from rt_octree_tpu.core.camera import Camera as JaxCamera
    W, H, focal = mq.scene_frame("blobs", 800, 0.04)
    rng = np.random.default_rng(20230418)
    for cam in fk.train_poses("blobs", 3, W, H, focal):
        back = np.array([rng.uniform(-0.08, 0.08),
                         rng.uniform(-0.08, 0.08), 1.0], np.float32)
        back /= np.linalg.norm(back)
        ref = JaxCamera(width=W, height=H, center=np.array(
            [rng.uniform(-0.2, 0.2), rng.uniform(-0.15, 0.15),
             rng.uniform(0.15, 0.45)], np.float32), v_back=back, fx=focal,
            fy=focal)
        np.testing.assert_array_equal(cam.transform, ref.transform)
    rng = np.random.default_rng(20230418)
    for cam in fk.train_poses("shell", 3, 24, 24):
        ref = mq.orbit_pose(rng.uniform(0, 2 * np.pi),
                            rng.uniform(np.deg2rad(-25), np.deg2rad(65)),
                            24, 24)
        np.testing.assert_array_equal(cam.transform, ref.transform)


def test_set_gnet_meta_is_byte_equal_to_the_jax_tool(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "jax_set_gnet_meta", os.path.join(REPO, "tools", "set_gnet_meta.py"))
    jt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jt)
    src = os.path.join(REPO, "benchmarks", "quality", "fast.gnet")
    a, b = tmp_path / "jax.gnet", tmp_path / "port.gnet"
    shutil.copy(src, a)
    shutil.copy(src, b)
    argv = ["fast_scale=0.5", "denoise_recommended=false", "note=a b"]
    jt.main([str(a)] + argv)
    jax_line = capsys.readouterr().out
    assert sm.main([str(b)] + argv) == 0
    assert capsys.readouterr().out == jax_line.replace("jax.gnet",
                                                       "port.gnet")
    assert a.read_bytes() == b.read_bytes() != open(src, "rb").read()
    assert jt.set_meta(str(a), {"x": 1}) == sm.set_meta(str(b), {"x": 1})
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("tool", ["make_quality_dataset", "make_fast_kit",
                                  "eval_gnet_kit"])
def test_kit_tools_default_to_the_card(tiny_tree, tmp_path, tool):
    """Without --device the tools run on the card: on a host without one
    they fail instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    gt = os.path.join(REPO, "benchmarks", "quality")
    calls = {"make_quality_dataset": (mq.main, ["--out", str(tmp_path / "k"),
                                                "--tree", str(tiny_tree)]),
             "make_fast_kit": (fk.main, ["--out", str(tmp_path / "k"),
                                         "--tree", str(tiny_tree),
                                         "--gt_kit", gt]),
             "eval_gnet_kit": (ek.main, [gt, os.path.join(gt, "fast.gnet")])}
    main, args = calls[tool]
    with pytest.raises((AssertionError, RuntimeError)):
        main(args)
    assert not (tmp_path / "k" / "test").exists()
