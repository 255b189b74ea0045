"""The PyTorch port imports without JAX, imports nothing of the JAX package
and builds nothing at import, and chip_smoke.py refuses to run without a
CUDA card."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "rt_octree_tpu_torch",
    "rt_octree_tpu_torch.core.options",
    "rt_octree_tpu_torch.core.camera",
    "rt_octree_tpu_torch.io.n3tree",
    "rt_octree_tpu_torch.io.poses",
    "rt_octree_tpu_torch.io.synthetic",
    "rt_octree_tpu_torch.native.build",
    "rt_octree_tpu_torch.utils.rng",
    "rt_octree_tpu_torch.utils.timer",
    "rt_octree_tpu_torch.ops.sh",
    "rt_octree_tpu_torch.ops.traversal",
    "rt_octree_tpu_torch.ops.filtering",
    "rt_octree_tpu_torch.ops.guidance",
    "rt_octree_tpu_torch.models.guidance_net",
    "rt_octree_tpu_torch.io.gnet_msgpack",
    "rt_octree_tpu_torch.io.png",
    "rt_octree_tpu_torch.render.renderer",
    "rt_octree_tpu_torch.apps.headless",
    "rt_octree_tpu_torch.ops.probes",
    "rt_octree_tpu_torch.ops.resize",
    "rt_octree_tpu_torch.io.mesh",
    "rt_octree_tpu_torch.io.wireframe",
    "rt_octree_tpu_torch.render.raster",
    "rt_octree_tpu_torch.render.probe",
    "rt_octree_tpu_torch.tools",
    "rt_octree_tpu_torch.tools.gpu_probe",
    "rt_octree_tpu_torch.tools.microbench_gather",
    "rt_octree_tpu_torch.io.lod",
    "rt_octree_tpu_torch.apps.compress",
    "rt_octree_tpu_torch.apps.cli",
    "rt_octree_tpu_torch.apps.tools",
    "rt_octree_tpu_torch.apps.anim",
    "rt_octree_tpu_torch.apps.viewer",
    "rt_octree_tpu_torch.train.config",
    "rt_octree_tpu_torch.train.dataset",
    "rt_octree_tpu_torch.train.logger",
    "rt_octree_tpu_torch.train.metrics",
    "rt_octree_tpu_torch.train.lpips",
    "rt_octree_tpu_torch.train.runner",
    "rt_octree_tpu_torch.train.main",
    "rt_octree_tpu_torch.tools.make_quality_dataset",
    "rt_octree_tpu_torch.tools.make_fast_kit",
    "rt_octree_tpu_torch.tools.eval_gnet_kit",
    "rt_octree_tpu_torch.tools.set_gnet_meta",
    "rt_octree_tpu_torch.core.sh_np",
    "rt_octree_tpu_torch.tools.gen_sh_mesh",
    "rt_octree_tpu_torch.parallel",
    "rt_octree_tpu_torch.parallel.launch",
    "rt_octree_tpu_torch.parallel.mesh",
]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "triton", "msgpack", "imageio")


def _rank_modules(dev):
    """A rank's own check: after importing the multi-device module, the
    modules of JAX, of the other libraries the port leaves out and of the
    JAX package in this rank's process."""
    from rt_octree_tpu_torch.parallel import mesh  # noqa: F401
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN + ("rt_octree_tpu",))


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def test_import_leaves_out_jax_flax_triton():
    """Every module of the port, and a call of ``trace_rays`` on one ray on
    the CPU: no JAX, Flax, Triton, msgpack or imageio is imported and no
    kernel library is built or loaded."""
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "import torch; from rt_octree_tpu_torch.io import synthetic; "
            "from rt_octree_tpu_torch.ops.traversal import upload_tree; "
            "from rt_octree_tpu_torch.render.renderer import trace_rays; "
            "from rt_octree_tpu_torch.core.options import RenderOptions; "
            "x = torch.tensor([[0.7071, 0.0, -0.7071]]); assert float("
            "trace_rays(upload_tree(synthetic.make_synthetic_tree('shell', "
            "depth=3, basis_dim=4), 3, device='cpu'), x, x, torch.tensor("
            "[[-2.0, 0.0, 2.0]]), torch.tensor([[0.5]]), RenderOptions("
            "spp=1))[0, 3]) > 0\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))\n"
            "from rt_octree_tpu_torch.native import build\n"
            "print(sorted(build._loaded))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    forbidden, loaded = out.stdout.strip().splitlines()
    assert forbidden == "[]"
    assert loaded == "[]"  # no kernel library is built or loaded at import


def test_port_runs_without_the_jax_package(tmp_path):
    """Every module of the port, then the headless CLI on the CPU over a
    tiny synthetic tree: no module of ``rt_octree_tpu`` gets imported."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "from rt_octree_tpu_torch.core.camera import Camera\n"
        "from rt_octree_tpu_torch.io import synthetic\n"
        "from rt_octree_tpu_torch.apps import headless\n"
        f"d = {str(tmp_path)!r}\n"
        "synthetic.save_npz(synthetic.make_synthetic_tree('shell', depth=3,"
        " basis_dim=4), d + '/tree.npz')\n"
        "pose = Camera().transform.tolist() + [[0, 0, 0, 1]]\n"
        "json.dump({'camera_angle_x': 0.8, 'frames': [{'transform_matrix':"
        " pose}]}, open(d + '/poses.json', 'w'))\n"
        "rc = headless.run([d + '/tree.npz', d + '/poses.json', '-o', d,"
        " '-w', '8', '--height', '8', '--warmup', '0', '--device', 'cpu',"
        " '--lut_levels', '3'])\n"
        "print(rc, sorted(m for m in sys.modules if m == 'rt_octree_tpu'"
        " or m.startswith('rt_octree_tpu.')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "0 []"
    assert (tmp_path / "r_0.png").exists()


def test_headless_new_flags_import_neither_jax_nor_the_jax_package(
        tmp_path):
    """The headless CLI on the CPU with fast mode, a drawlist, the grid, the
    probe, the classic estimator, the profiler and --auto_schedule: no
    module of ``rt_octree_tpu`` and no jax gets imported."""
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from rt_octree_tpu_torch.core.camera import Camera\n"
        "from rt_octree_tpu_torch.io import synthetic\n"
        "from rt_octree_tpu_torch.apps import headless\n"
        f"d = {str(tmp_path)!r}\n"
        "synthetic.save_npz(synthetic.make_synthetic_tree('shell', depth=3,"
        " basis_dim=4), d + '/tree.npz')\n"
        "np.savez(d + '/d.npz', box='cube', box__scale=0.3)\n"
        "pose = Camera().transform.tolist() + [[0, 0, 0, 1]]\n"
        "json.dump({'camera_angle_x': 0.8, 'frames': [{'transform_matrix':"
        " pose}]}, open(d + '/poses.json', 'w'))\n"
        "common = [d + '/tree.npz', d + '/poses.json', '-o', d, '-w', '8',"
        " '--height', '8', '--warmup', '0', '--device', 'cpu',"
        " '--lut_levels', '3', '--grid', '1', '--probe', '0,0,0.5']\n"
        "rcs = [headless.run(common + ['--render_scale', '0.5',"
        " '--profile', d + '/prof', '--auto_schedule']),"
        " headless.run(common + ['--draw', d + '/d.npz', '--estimator',"
        " 'classic'])]\n"
        f"print(rcs, sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('rt_octree_tpu',)!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[0, 0] []"
    assert (tmp_path / "prof" / "trace.json").exists()


def test_dispatcher_lod_and_compress_import_neither_jax_nor_the_jax_package(
        tmp_path):
    """``python -m rt_octree_tpu_torch.apps.cli lod`` and ``compress`` on a
    tiny tree: no module of ``rt_octree_tpu`` and no jax gets imported."""
    code = (
        "import sys\n"
        "from rt_octree_tpu_torch.io import synthetic\n"
        "from rt_octree_tpu_torch.apps import cli\n"
        f"d = {str(tmp_path)!r}\n"
        "synthetic.save_npz(synthetic.make_synthetic_tree('shell', depth=4,"
        " basis_dim=4), d + '/tree.npz')\n"
        "rcs = [cli.main(['lod', d + '/tree.npz', '-d', '2', '-o',"
        " d + '/lod.npz']), cli.main(['compress', d + '/tree.npz',"
        " '--out_dir', d + '/q', '--retain', '1', '--bits', '8'])]\n"
        f"print(rcs, sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('rt_octree_tpu',)!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[0, 0] []"
    assert (tmp_path / "lod.npz").exists()
    assert (tmp_path / "q" / "tree.npz").exists()
    out = subprocess.run([sys.executable, "-m", "rt_octree_tpu_torch.apps.cli",
                          "tools", "extract-test-poses", str(tmp_path)],
                         cwd=REPO, env=_clean_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "not yet ported" not in out.stderr


def test_dispatcher_apps_import_neither_jax_nor_the_jax_package(tmp_path):
    """``rtoctree tools`` (both subcommands) and ``rtoctree anim`` on the
    CPU over a tiny tree, and a ViewerState on the CPU serving one frame:
    no module of ``rt_octree_tpu`` and no jax gets imported.  The
    dispatcher's help names all seven commands and none is refused."""
    code = (
        "import json, os, shutil, sys\n"
        "from rt_octree_tpu_torch.io import synthetic\n"
        "from rt_octree_tpu_torch.apps import cli, viewer\n"
        f"d = {str(tmp_path)!r}\n"
        "synthetic.save_npz(synthetic.make_synthetic_tree('shell', depth=3,"
        " basis_dim=4), d + '/tree.npz')\n"
        "os.makedirs(d + '/scenes/lego')\n"
        "for split in ('test', 'train'):\n"
        "    shutil.copy('benchmarks/quality/transforms_test.json',"
        " d + f'/scenes/lego/transforms_{split}.json')\n"
        "kf = json.load(open('examples/orbit_keyframes.json'))\n"
        "kf['fps'] = 1\n"
        "json.dump(kf, open(d + '/kf.json', 'w'))\n"
        "rcs = [cli.main(['tools', 'extract-test-poses', d + '/scenes']),"
        " cli.main(['tools', 'extract-cams-drawlist', d + '/scenes']),"
        " cli.main(['anim', d + '/tree.npz', d + '/kf.json', '-o',"
        " d + '/anim', '-w', '8', '--height', '8', '--device', 'cpu'])]\n"
        "st = viewer.ViewerState(d + '/tree.npz', width=8, height=8,"
        " lut_levels=0, spp=1, device='cpu')\n"
        "png = st.render_png()\n"
        "print(rcs, png[:4] == b'\\x89PNG', sorted(m for m in sys.modules"
        f" if m.split('.')[0] in {FORBIDDEN + ('rt_octree_tpu',)!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[0, 0, 0] True []"
    assert len(os.listdir(tmp_path / "anim")) == 3
    assert (tmp_path / "scenes" / "lego" / "pose" / "r_0.txt").exists()
    assert (tmp_path / "scenes" / "lego" / "lego_cams.draw.npz").exists()
    out = subprocess.run([sys.executable, "-m", "rt_octree_tpu_torch.apps.cli",
                          "--help"], cwd=REPO, env=_clean_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    listed = [line.split()[0] for line in out.stdout.splitlines()
              if line.startswith("  ")]
    assert listed == ["render", "view", "anim", "train", "compress", "lod",
                      "tools"]
    code = (
        "import contextlib, io\n"
        "from rt_octree_tpu_torch.apps import cli\n"
        f"for cmd in {listed!r}:\n"
        "    out, err = io.StringIO(), io.StringIO()\n"
        "    with contextlib.redirect_stdout(out), "
        "contextlib.redirect_stderr(err):\n"
        "        try:\n"
        "            rc = cli.main([cmd, '--help'])\n"
        "        except SystemExit as e:\n"
        "            rc = e.code\n"
        "    print(cmd, rc, 'usage' in out.getvalue(),"
        " 'not yet ported' in err.getvalue())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines() == [
        f"{cmd} 0 True False" for cmd in listed]


def test_dispatcher_train_imports_neither_jax_nor_the_jax_package(
        tmp_path):
    """``rtoctree train`` (train, then test and compact) on the CPU over a
    micro-blender kit made by the port's make_quality_dataset from a tiny
    tree: no module of ``rt_octree_tpu`` and no jax gets imported, and the
    exported .gnet is there."""
    code = (
        "import sys\n"
        "from rt_octree_tpu_torch.io import synthetic\n"
        "from rt_octree_tpu_torch.apps import cli\n"
        "from rt_octree_tpu_torch.tools import make_quality_dataset as mq\n"
        f"d = {str(tmp_path)!r}\n"
        "synthetic.save_npz(synthetic.make_synthetic_tree('shell', depth=3,"
        " basis_dim=4), d + '/tree.npz')\n"
        "rcs = [mq.main(['--out', d + '/kit', '--tree', d + '/tree.npz',"
        " '--n_train', '2', '--n_test', '1', '--res', '16', '--device',"
        " 'cpu'])]\n"
        "common = ['--config', 'configs/blender.txt', '--data_dir',"
        " d + '/kit', '--logs_root', d + '/logs', '--device', 'cpu',"
        " '--nx', '2', '--ny', '2', '--batch_size', '4', '--mid_channels',"
        " '4', '--i_save', '1']\n"
        "for task in ('train', 'test', 'compact'):\n"
        "    rcs.append(cli.main(['train', '--task', task, '--epochs', '1']"
        " + common))\n"
        f"print(rcs, sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('rt_octree_tpu',)!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[0, 0, 0, 0] []"
    for name in ("ts_000001.gnet", "checkpoint_000001.pt", "ts_latest.gnet"):
        assert (tmp_path / "logs" / "lego" / name).exists()


def test_kit_tools_import_neither_jax_nor_the_jax_package(tmp_path):
    """make_quality_dataset (a GT-only kit), set_gnet_meta, make_fast_kit
    and eval_gnet_kit on the CPU over a tiny tree: no module of
    ``rt_octree_tpu`` and no jax gets imported."""
    code = (
        "import sys, torch\n"
        "from rt_octree_tpu_torch.io import synthetic\n"
        "from rt_octree_tpu_torch.models.guidance_net import ("
        "GuidanceNetConfig, compact_and_export, init_params)\n"
        "from rt_octree_tpu_torch.tools import eval_gnet_kit, make_fast_kit,"
        " make_quality_dataset, set_gnet_meta\n"
        f"d = {str(tmp_path)!r}\n"
        "synthetic.save_npz(synthetic.make_synthetic_tree('shell', depth=3,"
        " basis_dim=4), d + '/tree.npz')\n"
        "common = ['--tree', d + '/tree.npz', '--res', '12', '--device',"
        " 'cpu']\n"
        "rcs = [make_quality_dataset.main(['--out', d + '/gt', '--gt_only',"
        " '--n_test', '2'] + common)]\n"
        "cfg = GuidanceNetConfig(mid_channels=4)\n"
        "compact_and_export(cfg, init_params(cfg, torch.Generator()"
        ".manual_seed(0)), d + '/gt/trained.gnet')\n"
        "rcs.append(set_gnet_meta.main([d + '/gt/trained.gnet',"
        " 'fast_scale=0.5']))\n"
        "rcs.append(make_fast_kit.main(['--out', d + '/fast', '--gt_kit',"
        " d + '/gt', '--n_train', '1', '--lod', '2'] + common))\n"
        "means = eval_gnet_kit.main([d + '/fast', d + '/gt/trained.gnet',"
        " '--device', 'cpu'])\n"
        "print(rcs, sorted(means), means['noisy']['poses'], sorted(m for m"
        f" in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('rt_octree_tpu',)!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    net = str(tmp_path / "gt" / "trained.gnet")
    assert out.stdout.strip().splitlines()[-1] == \
        f"[0, 0, 0] {sorted(['noisy', net])!r} 2 []"
    assert sorted(os.listdir(tmp_path / "fast" / "spp_6")) == ["test",
                                                               "train"]


def test_gen_sh_mesh_imports_neither_jax_nor_the_jax_package(tmp_path):
    """The SH-lobe mesh tool (tools/gen_sh_mesh.py's port) writes its OBJ
    files with no module of ``rt_octree_tpu`` and no jax imported, and
    builds no kernel."""
    code = (
        "import sys\n"
        "from rt_octree_tpu_torch.tools import gen_sh_mesh\n"
        f"rc = gen_sh_mesh.main(['1', {str(tmp_path)!r}])\n"
        "from rt_octree_tpu_torch.native import build\n"
        "print(rc, sorted(build._loaded), sorted(m for m in sys.modules if "
        f"m.split('.')[0] in {FORBIDDEN + ('rt_octree_tpu',)!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "0 [] []"
    assert sorted(os.listdir(tmp_path)) == [f"sh_{i:02d}.obj"
                                            for i in range(4)]


def test_parallel_ranks_import_neither_jax_nor_the_jax_package():
    """A process that imports rt_octree_tpu_torch.parallel and launches two
    CPU ranks, and each rank: no jax and no module of rt_octree_tpu."""
    code = ("import sys\n"
            "from rt_octree_tpu_torch.parallel.launch import launch\n"
            "from tests.test_torch_import import _rank_modules\n"
            "print(launch(_rank_modules, 2, backend='gloo', device='cpu',"
            " timeout_s=100))\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('rt_octree_tpu',)!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=150)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines() == ["[[], []]", "[]"]


def test_tf32_disabled_on_import():
    import rt_octree_tpu_torch  # noqa: F401
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script exits non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("device", ["meta"])
def test_wrappers_refuse_other_devices(device):
    """A wrapper takes its plain version only for CPU tensors; anything
    that is neither CPU nor CUDA is refused, never rerouted."""
    from rt_octree_tpu_torch.ops.filtering import guided_filter
    from rt_octree_tpu_torch.ops.traversal import add_skip_distances, \
        build_lut
    w = torch.zeros((2, 4, 4), device=device)
    img = torch.zeros((4, 4, 4), device=device)
    with pytest.raises(ValueError):
        guided_filter(torch.zeros((1, 4, 4, 4), dtype=torch.bfloat16,
                                  device=device), img)
    with pytest.raises(ValueError):
        build_lut(torch.zeros((8, 2), dtype=torch.int32, device=device), 2, 1)
    with pytest.raises(ValueError):
        add_skip_distances(torch.zeros((8, 2), dtype=torch.int32,
                                       device=device), 2, 12)
    from rt_octree_tpu_torch.ops import probes
    tab = torch.zeros((8, 4), dtype=torch.int32, device=device)
    idx = torch.zeros((8,), dtype=torch.int32, device=device)
    for call in (lambda: probes.probe_affine(w),
                 lambda: probes.lane_gather(w[0], idx.reshape(2, 4)),
                 lambda: probes.lane_gather_chain(tab, idx.reshape(2, 4), 1),
                 lambda: probes.row_sum_ring(idx, w[0]),
                 lambda: probes.row_ring_rounds(idx, tab, 8, 1),
                 lambda: probes.flat_gather_chain(idx, idx, 1)):
        with pytest.raises(ValueError):
            call()
