"""The benchmark's reference against the port's plain versions on the CPU
(depth-5 trees, small frames), and the imports of the reference and of
the harness in fresh processes.

    python -m pytest perfbench/tests -q
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import generator, traffic  # noqa: E402
from perfbench.reference import filter as rfilter  # noqa: E402
from perfbench.reference import frame as rframe  # noqa: E402
from perfbench.reference import march, pcg32  # noqa: E402
from perfbench.reference import net as rnet  # noqa: E402
from perfbench.reference import npz as rnpz  # noqa: E402

from rt_octree_tpu_torch.core.options import RenderOptions  # noqa: E402
from rt_octree_tpu_torch.io import n3tree, synthetic  # noqa: E402
from rt_octree_tpu_torch.models import guidance_net as G  # noqa: E402
from rt_octree_tpu_torch.ops import filtering, resize  # noqa: E402
from rt_octree_tpu_torch.ops.traversal import upload_tree  # noqa: E402
from rt_octree_tpu_torch.render import renderer as R  # noqa: E402
from rt_octree_tpu_torch.utils import rng as port_rng  # noqa: E402

NETS = ("shell_trained", "shell_fast", "tt_trained")
MIX = {"orbit": {"az_step_deg": 0.25, "el_min_deg": -15.0,
                 "el_max_deg": 55.0, "el_period_turns": 4}}
W, H = 48, 40
FX = 1111.11 * W / 800


@pytest.fixture(scope="module", params=("shell", "solid"))
def scene(request, tmp_path_factory):
    """(npz path, the port's device tree, the reference's tree)."""
    path = str(tmp_path_factory.mktemp("trees") / f"{request.param}.npz")
    generator.save_npz(generator.make_synthetic_tree(request.param, 5, 9),
                       path)
    dt = upload_tree(n3tree.load(path), lut_levels=5, device="cpu",
                     skip_cap=12)
    return path, dt, march.to_device(rnpz.read_tree(path), "cpu")


@pytest.mark.parametrize("kind", ("shell", "solid"))
def test_frozen_generator_is_the_ports(kind):
    a = generator.make_synthetic_tree(kind, depth=5, basis_dim=9)
    b = synthetic.make_synthetic_tree(kind, depth=5, basis_dim=9)
    assert np.array_equal(a["child"], b.child)
    assert np.array_equal(a["data"], b.data)
    assert a["capacity"] == b.capacity and a["max_depth"] == b.max_depth


def test_npz_reader_matches_the_ports(scene):
    path, _, _ = scene
    a, b = rnpz.read_tree(path), n3tree.load(path)
    assert np.array_equal(a.child, b.child)
    assert np.array_equal(a.data, b.data)
    assert a.max_depth == b.max_depth and a.basis_dim == 9


@pytest.mark.parametrize("frame", (0, 7, 1 << 20))
def test_pcg32_matches_the_ports(frame):
    state, inc = pcg32.frame_state(frame)
    g = port_rng.Pcg32(port_rng.RENDER_CONTEXT_SEED)
    g.advance(frame << 32)
    assert (state, inc) == (g.state, g.inc)
    n = 3 * 1000 + 17
    assert torch.equal(pcg32.uniforms(state, inc, n, "cpu"),
                       port_rng.pcg32_uniforms_range(state, n=n, inc=inc,
                                                     device="cpu"))


@pytest.mark.parametrize("estimator", ("rt", "classic"))
def test_march_matches_the_ports_plain_frame(scene, estimator):
    """Noisy frames of four orbit poses: the descent from the root without
    a jump table or skip distances against the port's plain K1 over its
    LUT with skips (the same samples but for the ray parameter's
    rounding)."""
    _, dt, tree = scene
    orbit = traffic.orbit(MIX, 5.02, 3)
    opt = RenderOptions(spp=6, estimator=estimator, step_size=1e-4,
                        sigma_thresh=1e-2, stop_thresh=1e-2,
                        background_brightness=1.0)
    spec = rframe.FrameSpec(W, H, FX, FX, estimator, 6, 1e-4, 1e-2, 1e-2,
                            1.0, 8192)
    for n in (0, 500, 1500, 3000):
        f = orbit.pcg32_offset + n
        state, inc = pcg32.frame_state(f)
        img = R.render_noisy_plain(
            dt, torch.from_numpy(orbit.pose(n)), state, inc, width=W,
            height=H, fx=FX, fy=FX, opt=opt, want_aux=False)[0]
        ref = rframe.render(tree, orbit.pose(n), f, spec, None, None).img
        d = (img - ref).abs()
        assert float(d.max()) <= 1e-3 and float(d.mean()) <= 1e-6


@pytest.mark.parametrize("estimator", ("rt", "classic"))
def test_march_in_float64_geometry_agrees(scene, estimator):
    """The witness's march, its rays, positions and optical depths in
    float64, against the check's float32 one: the same frame to the ray
    parameter's rounding."""
    _, _, tree = scene
    orbit = traffic.orbit(MIX, 5.02, 3)
    spec = rframe.FrameSpec(W, H, FX, FX, estimator, 6, 1e-4, 1e-2, 1e-2,
                            1.0, 8192)
    for n in (0, 1500):
        f = orbit.pcg32_offset + n
        a = rframe.render(tree, orbit.pose(n), f, spec, None, None).img
        b = rframe.render(tree, orbit.pose(n), f, spec, None, None,
                          geom=torch.float64).img
        assert a.dtype == b.dtype == torch.float32
        d = (a - b).abs()
        assert float(d.max()) <= 1e-3 and float(d.mean()) <= 1e-5


def test_upsample_matches_k4_plain():
    rs = np.random.default_rng(4)
    aux = torch.from_numpy(rs.random((20, 24, 8), np.float32))
    img, full = rfilter.upsample(aux, 40, 48)
    p_img, p_aux, _ = resize.fast_upsample_plain(aux, 40, 48, False)
    assert torch.equal(img, p_img) and torch.equal(full, p_aux)


@pytest.mark.parametrize("name", NETS)
def test_gnet_reader_and_f32_net_match_the_ports(name):
    path = os.path.join(ROOT, "perfbench", "nets", name + ".gnet")
    header, blocks = rnet.read_gnet(path)
    cfg, params = G.load_compact(path)
    sd = G.params_from_numpy(cfg, params)
    for i, (k, b) in enumerate(blocks):
        assert torch.equal(k, sd[f"convs.{i}.weight"])
        assert torch.equal(b, sd[f"convs.{i}.bias"])
    assert rnet.supports(header) == cfg.supports()
    aux = torch.from_numpy(np.random.default_rng(5).random(
        (H, W, 8), np.float32))
    got = rnet.forward(aux, blocks)
    want = G.compact_activation_plain(aux[None], [k for k, _ in blocks],
                                      [b for _, b in blocks], torch.float32)
    # two f32 convolutions of the same sums, in other orders
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("supports", ((0, 1, 2, 3), (1, 2, 3, 4)))
def test_filter_matches_k2_plain(supports):
    rs = np.random.default_rng(6)
    act = torch.from_numpy(rs.normal(size=(1, 8, H, W)).astype(np.float32))
    img = torch.from_numpy(rs.random((H, W, 4), np.float32))
    got = rfilter.guided_filter(act, img, supports)
    want = filtering.guided_filter_act_plain(act, img, supports)
    assert torch.allclose(got, want, atol=1e-6, rtol=0)


def test_denoised_fast_frame_matches_the_ports_renderer(scene):
    """The whole fast, denoised frame: the port's Renderer on the CPU (its
    plain versions, the net in bf16) against the reference (f32 net)."""
    path, dt, tree = scene
    orbit = traffic.orbit(MIX, 5.02, 9)
    net = os.path.join(ROOT, "perfbench", "nets", "shell_fast.gnet")
    r = R.Renderer(dt, W, H, FX, FX, options=RenderOptions(
        spp=6, denoise=True, step_size=1e-4, sigma_thresh=1e-2,
        background_brightness=1.0), render_scale=0.5)
    r.set_denoiser(net)
    r.rng.advance(orbit.pcg32_offset << 32)
    img = r.render(orbit.pose(0), want_aux=False)[0]
    header, blocks = rnet.read_gnet(net)
    spec = rframe.FrameSpec(W, H, FX, FX, "rt", 6, 1e-4, 1e-2, 1e-2, 1.0,
                            8192, render_scale=0.5)
    ref = rframe.render(tree, orbit.pose(0), orbit.pcg32_offset, spec,
                        blocks, rnet.supports(header)).img
    d = (img - ref).abs()
    assert float(d.mean()) < 5e-4 and float(d.max()) < 2e-2


FORBIDDEN = ("jax", "jaxlib", "flax", "rt_octree_tpu")

_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
for m in {mods!r}:
    __import__(m)
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def _top_level(mods) -> set:
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=ROOT, mods=list(mods))],
        capture_output=True, text=True, timeout=300, check=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_no_jax_and_nothing_of_the_port():
    mods = ["perfbench.reference." + m for m in
            ("npz", "pcg32", "march", "net", "filter", "frame")]
    names = _top_level(mods + ["perfbench.count"])
    assert not names & set(FORBIDDEN)
    assert "rt_octree_tpu_torch" not in names


def test_harness_imports_no_jax():
    mods = ["perfbench." + m for m in ("run", "spec", "system", "check",
                                       "trace", "traffic", "scene",
                                       "control", "generator")]
    names = _top_level(mods)
    assert not names & set(FORBIDDEN)
    assert "rt_octree_tpu_torch" in names
