"""The PyTorch port imports without JAX and builds nothing at import, and
chip_smoke.py refuses to run without a CUDA card."""

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
    "rt_octree_tpu_torch.native.build",
    "rt_octree_tpu_torch.utils.rng",
    "rt_octree_tpu_torch.utils.timer",
    "rt_octree_tpu_torch.ops.sh",
    "rt_octree_tpu_torch.ops.traversal",
    "rt_octree_tpu_torch.ops.filtering",
    "rt_octree_tpu_torch.models.guidance_net",
    "rt_octree_tpu_torch.io.gnet_msgpack",
    "rt_octree_tpu_torch.io.png",
    "rt_octree_tpu_torch.render.renderer",
    "rt_octree_tpu_torch.apps.headless",
]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "triton", "msgpack", "imageio")


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def test_import_leaves_out_jax_flax_triton():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
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
        guided_filter(w, w, img)
    with pytest.raises(ValueError):
        build_lut(torch.zeros((8, 2), dtype=torch.int32, device=device), 2, 1)
    with pytest.raises(ValueError):
        add_skip_distances(torch.zeros((8, 2), dtype=torch.int32,
                                       device=device), 2, 12)
