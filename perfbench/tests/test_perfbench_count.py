"""The roofline counts (perfbench/count) on the CPU: the K7 and K2 bounds
at the headline frame, the march counts against a hand count of the
reference march and against the port's plain statistics, and that no
count reads the program.

    python -m pytest perfbench/tests -q
"""

import ast
import os
import re
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import check, count, generator, traffic  # noqa: E402
from perfbench.reference import march, pcg32  # noqa: E402
from perfbench.reference import net as rnet  # noqa: E402
from perfbench.reference import npz as rnpz  # noqa: E402

from rt_octree_tpu_torch.core.options import RenderOptions  # noqa: E402
from rt_octree_tpu_torch.io import n3tree  # noqa: E402
from rt_octree_tpu_torch.ops.traversal import upload_tree  # noqa: E402
from rt_octree_tpu_torch.render import renderer as R  # noqa: E402

W, H = 40, 32
FX = 1111.11 * W / 800
MIX = {"orbit": {"az_step_deg": 0.25, "el_min_deg": -15.0,
                 "el_max_deg": 55.0, "el_period_turns": 4}}


def _net(name):
    header, blocks = rnet.read_gnet(
        os.path.join(ROOT, "perfbench", "nets", name + ".gnet"))
    return header, [(int(k.shape[1]), int(k.shape[0])) for k, _ in blocks]


def test_k7_and_k2_bounds_at_800x800():
    """The headline frame's K7 and K2 bounds as chip_smoke.py published
    them (0.0092 ms, 0.0084 ms, both bytes-bound)."""
    header, chans = _net("shell_trained")
    k7 = count.net(chans, 800 * 800)
    k2 = count.guided_filter(header["kernel_levels"], rnet.supports(header),
                             800 * 800)
    assert round(k7.bound_s() * 1e3, 4) == 0.0092 and \
        k7.bound_by() == "bytes"
    assert round(k2.bound_s() * 1e3, 4) == 0.0084 and \
        k2.bound_by() == "bytes"


@pytest.fixture(scope="module")
def shell(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trees") / "shell.npz")
    generator.save_npz(generator.make_synthetic_tree("shell", 5, 9), path)
    return path


def _rays(tree, n):
    orbit = traffic.orbit(MIX, 5.02, 17)
    tf = torch.from_numpy(orbit.pose(n))
    dirs, cens = march.camera_rays(tf, W, H, FX, FX)
    return orbit, tf, dirs, cens


@pytest.mark.parametrize("n", (0, 900))
def test_rt_counts_are_a_hand_count_of_the_records(shell, n):
    tree = march.to_device(rnpz.read_tree(shell), "cpu")
    orbit, tf, dirs, cens = _rays(tree, n)
    state, inc = pcg32.frame_state(orbit.pcg32_offset + n)
    dst = pcg32.sorted_thresholds(
        pcg32.uniforms(state, inc, W * H * 6, "cpu").reshape(W * H, 6))
    ptr, cnt, c = march.march_rt(tree, dirs, cens, dst, 1e-4, 1e-2, 8192)
    ptr, cnt = ptr.numpy(), cnt.numpy()
    records = [(r, s) for r in range(W * H) for s in range(6)
               if cnt[r, s] > 0]
    rows = {int(ptr[r, s]) for r, s in records}
    rays = {r for r, _ in records}
    assert (c.shaded, c.rows, c.rays_shaded) == (len(records), len(rows),
                                                 len(rays))
    w = count.march(W * H, c.shaded, c.rays_shaded, c.rows, 9, 28)
    assert w.bytes == 16 * W * H + 56 * len(rows)
    assert w.f32_ops == (70 * len(records) + 18 * len(rays) + 7 * W * H)
    # the port's plain statistics (its LUT march) shade the same rows
    dt = upload_tree(n3tree.load(shell), lut_levels=5, device="cpu")
    opt = RenderOptions(spp=6, step_size=1e-4, sigma_thresh=1e-2,
                        background_brightness=1.0)
    st = R.render_stats_plain(dt, tf, state, inc, width=W, height=H, fx=FX,
                              fy=FX, opt=opt)
    assert st.data_rows == len(rows)


@pytest.mark.parametrize("n", (0, 900))
def test_classic_counts_match_a_second_march(shell, n):
    """The classic march's shaded steps and rows against the port's plain
    statistics of the same frame (a march over the LUT and skip
    distances), and the work formula by hand."""
    tree = march.to_device(rnpz.read_tree(shell), "cpu")
    orbit, tf, dirs, cens = _rays(tree, n)
    _, c = march.march_classic(tree, dirs, dirs, cens, 1e-4, 1e-2, 1e-2,
                               8192)
    dt = upload_tree(n3tree.load(shell), lut_levels=5, device="cpu")
    opt = RenderOptions(spp=6, estimator="classic", step_size=1e-4,
                        sigma_thresh=1e-2, stop_thresh=1e-2,
                        background_brightness=1.0)
    st = R.render_stats_plain(dt, tf, 0, 1, width=W, height=H, fx=FX,
                              fy=FX, opt=opt)
    assert c.shaded == int(st.shaded.sum())
    assert c.rays_shaded == int((st.shaded > 0).sum())
    assert c.rows == st.data_rows
    w = count.march(W * H, c.shaded, c.rays_shaded, c.rows, 9, 28)
    assert w.bytes == 16 * W * H + 56 * c.rows
    assert w.f32_ops == 70 * c.shaded + 18 * c.rays_shaded + 7 * W * H


def test_frame_count_leaves_out_intermediates():
    m = count.march(100, 50, 20, 30, 9, 28)
    k7, k2 = count.net([(8, 32), (32, 8)], 400), count.guided_filter(
        4, (0, 1, 2, 3), 400)
    f = count.frame(m, 56 * 30, 400, k7, 1000, k2, count.upsample(400))
    assert f.bytes == 56 * 30 + 1000 + 48 + 16 * 400
    assert f.f32_ops == m.f32_ops + k2.f32_ops + 40 * 400
    assert f.bf16_ops == k7.bf16_ops


def test_no_count_reads_the_program():
    """The counting code and the readers import nothing of the port and
    name neither its jump table nor its statistics."""
    files = [os.path.join(ROOT, "perfbench", "count", "__init__.py"),
             os.path.join(ROOT, "perfbench", "check.py")]
    mdir = os.path.join(ROOT, "perfbench", "metrics")
    files += [os.path.join(mdir, f) for f in os.listdir(mdir)
              if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            src = f.read()
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [
                    getattr(node, "module", None) or ""]
                assert not any(n.startswith("rt_octree_tpu") for n in names)
        for word in ("lut", "render_stats", "MarchStats", "skip_cap"):
            assert not re.search(rf"\b{word}\b", src), (path, word)
    assert "Reference" in check.__dict__


def test_counted_poses_are_fixed_and_spread_over_the_period():
    """The rooflines count on the same poses whatever the seed: one a
    COUNT_POSES-th of the period apart, each at its own azimuth, the
    elevations across the swing."""
    poses = traffic.counted(MIX, 5.02)
    assert len(poses) == traffic.COUNT_POSES
    assert [f for _, f in poses] == list(range(traffic.COUNT_POSES))
    again = traffic.counted(MIX, 5.02)
    assert all(np.array_equal(a, b) for (a, _), (b, _) in zip(poses, again))
    centres = np.stack([p[:, 3] for p, _ in poses])
    az = np.degrees(np.arctan2(centres[:, 1], centres[:, 0])) % 360
    assert len(np.unique(np.round(az, 3))) == traffic.COUNT_POSES
    el = np.degrees(np.arcsin(centres[:, 2] / 5.02))
    assert el.min() < 0.0 and el.max() > 45.0
    # a seed's orbit passes the same path at its own start
    orbit = traffic.orbit(MIX, 5.02, 17)
    assert orbit.poses.shape[0] == traffic.period(MIX["orbit"])
