"""The port's CUDA kernels (K1 render and its classic variant, K2 guided
filter, K3 LUT + skip distances, K4 fast mode's upsample, K5 / K6 the
training step's batched guided filter and its backward, G1-G4 the
measurement tools' probes) against their plain PyTorch versions, and the
launch counters (K7, the GuidanceNet, is held in tests/test_torch_net.py).

This file imports no JAX, so it also runs on a GPU host that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest`` because tests/conftest.py imports JAX.)  Tests that need
the card carry the ``cuda`` marker and skip without one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rt_octree_tpu_torch.core.camera import Camera
from rt_octree_tpu_torch.core.options import RenderOptions
from rt_octree_tpu_torch.io import synthetic
from rt_octree_tpu_torch.io.n3tree import BasisFormat, DataFormat
from rt_octree_tpu_torch.models.guidance_net import GuidanceNetConfig, \
    build_compact
from rt_octree_tpu_torch.native import build as native
from rt_octree_tpu_torch.ops import probes as pr
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.ops.filtering import guided_filter, \
    guided_filter_act_plain, guided_filter_backward_plain, \
    guided_filter_batch, guided_filter_batch_bwd, guided_filter_batch_fwd, \
    guided_filter_batch_plain, guided_filter_plain, split_activation
from rt_octree_tpu_torch.ops.resize import fast_upsample, \
    fast_upsample_plain
from rt_octree_tpu_torch.render import renderer as tr
from rt_octree_tpu_torch.utils.rng import pcg32_uniforms_range

torch.set_num_threads(1)

# Kernel vs plain on one card: the same libm (log1pf, expf) and IEEE
# division on both sides, so only summation order differs (the shade's
# count-weighted sum; the filter's softmax sums of up to 49 taps).
IMG_TOL, AUX_TOL, FILTER_TOL = 2e-5, 4e-5, 1e-5
# K4 vs plain: the same f32 operations in the same order (both sides built
# without FMA contraction), on values in [0, 1].
UPSAMPLE_TOL = 1e-6
# K6 vs plain: the gather of up to 81 taps of exp * (u.x - v) in the plain
# version's order, with FMA contraction: within 1e-4 of the plain
# gradient's largest magnitude.
GRAD_REL_TOL = 1e-4


@pytest.fixture(scope="module")
def shell():
    return synthetic.make_synthetic_tree("shell", depth=5, basis_dim=4)


@pytest.fixture(scope="module")
def chain():
    return synthetic.make_deep_chain_tree(8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _render_args(spp, width=32, height=32):
    cam = Camera(width=width, height=height, fx=40.0, fy=40.0)
    kw = dict(width=width, height=height, fx=cam.fx, fy=cam.fy,
              opt=RenderOptions(spp=spp, denoise=False))
    return cam.transform, kw


def _filter_inputs(seed, L=4, H=64, W=48, gscale=3.0):
    """The net's last activation [1, 2L, H, W] (level logits, then
    guidance), to be cast to bf16, and the noisy image [H, W, 4]."""
    rs = np.random.default_rng(seed)
    act = np.concatenate([rs.standard_normal((L, H, W)) * 2.0,
                          rs.standard_normal((L, H, W)) * gscale])
    img = rs.random((H, W, 4), np.float32)
    return act[None].astype(np.float32), img


def _batch_inputs(seed, B=2, L=4, H=37, W=53, gscale=3.0):
    """f32 level weights (softmaxed), guidance, image and dL/dout for the
    batched filter."""
    rs = np.random.default_rng(seed)
    logits = rs.standard_normal((B, L, H, W)) * 2.0
    w = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    g = rs.standard_normal((B, L, H, W)) * gscale
    if gscale > 10:  # one window spans > 60 nats
        g[0, 1, 3, 4], g[0, 1, 4, 5] = 70.0, -5.0
    return tuple(a.astype(np.float32) for a in (
        w, g, rs.random((B, H, W, 4)), rs.standard_normal((B, H, W, 4))))


def _lane_inputs(seed, dtype, T=64, R=40, W=12):
    rs = np.random.default_rng(seed)
    tab = (rs.random((T, W)) if dtype == np.float32
           else rs.integers(0, 3, (T, W))).astype(dtype)
    return tab, rs.integers(0, T, (R, W), dtype=np.int32)


def _ring_inputs(seed, width, dtype, rows=300, n=70):
    rs = np.random.default_rng(seed)
    table = (rs.random((rows, width)) if dtype == np.float32
             else rs.integers(-2 ** 31, 2 ** 31, (rows, width))).astype(dtype)
    return rs.integers(0, rows, (n,), dtype=np.int32), table


def _flat_inputs(seed, size, n=500):
    rs = np.random.default_rng(seed)
    return (rs.integers(0, size, (n,), dtype=np.int32),
            rs.integers(1, 1000, (size,), dtype=np.int32))


def _launch_each_wrapper(shell, device):
    """One call of every kernel wrapper on ``device``."""
    dt = tt.upload_tree(shell, lut_levels=0, device=device)
    lut = tt.build_lut(dt.chs, 2, 3)
    tt.add_skip_distances(lut, 8, 2)
    transform, kw = _render_args(1, 8, 8)
    tf = torch.from_numpy(transform).to(device)
    _, aux, _ = tr.render_noisy(dt, tf, 1, 1, **kw)
    kw["opt"] = RenderOptions(estimator="classic", denoise=False)
    tr.render_noisy(dt, tf, 1, 1, **kw)
    fast_upsample(aux, 16, 13)
    t = lambda a: torch.from_numpy(a).to(device)
    act, img = _filter_inputs(0, L=2, H=8, W=8)
    guided_filter(t(act).to(torch.bfloat16), t(img), (0, 1))
    cfg = GuidanceNetConfig(mid_channels=4, kernel_levels=2)
    rs = np.random.default_rng(6)
    net = build_compact(cfg, {f"block_{i}": {
        "kernel": rs.standard_normal((3, 3, cin, cout)).astype(np.float32),
        "bias": rs.standard_normal(cout).astype(np.float32)}
        for i, (cin, cout) in enumerate(cfg.layer_channels())}, device)
    net.activation(aux[None])
    w, g, x, G = (t(a) for a in _batch_inputs(0, B=1, L=2, H=8, W=8))
    w.requires_grad_()
    guided_filter_batch(w, g, x, (0, 1)).backward(G)
    tab, idx = _lane_inputs(1, np.float32)
    pr.probe_affine(t(tab))
    pr.lane_gather(t(tab), t(idx))
    tab, idx = _lane_inputs(2, np.int32)
    pr.lane_gather_chain(t(tab), t(idx), 3)
    idx, table = _ring_inputs(3, 4, np.float32)
    pr.row_sum_ring(t(idx), t(table))
    idx, table = _ring_inputs(4, 2, np.int32)
    pr.row_ring_rounds(t(idx), t(table), 8, 2)
    idx, table = _flat_inputs(5, 1 << 10)
    pr.flat_gather_chain(t(idx), t(table), 3)


def test_cpu_tensors_take_the_plain_versions(shell):
    """On CPU tensors no wrapper launches, so no count moves."""
    native.reset_launches()
    _launch_each_wrapper(shell, "cpu")
    assert native.LAUNCHES == {k: 0 for k in native.LAUNCHES}


@pytest.mark.cuda
def test_each_wrapper_counts_its_launch(shell, cuda_device):
    """One count per kernel launched: the level-3 LUT build is one launch,
    the skip distances three (a row pass and two axis passes)."""
    native.reset_launches()
    _launch_each_wrapper(shell, cuda_device)
    torch.cuda.synchronize()
    assert native.LAUNCHES == {k: 3 if k == "skip_distances" else 1
                               for k in native.LAUNCHES}


@pytest.mark.cuda
@pytest.mark.parametrize("spp", tr.SPP_KERNEL)
def test_k1_kernel_matches_plain(shell, spp, cuda_device):
    """A 37x23 image, not a multiple of the 8x4 warp tile, at every SPP
    the kernel has, with the full-depth LUT (skip distances) and a level-3
    LUT (chs descents): the pixels within IMG_TOL / AUX_TOL of the plain
    version, and the statistics variant's counts equal to the plain
    march's."""
    transform, kw = _render_args(spp, 37, 23)
    tf = torch.from_numpy(transform).to(cuda_device)
    for levels in (5, 3):
        dt = tt.upload_tree(shell, lut_levels=levels, device=cuda_device)
        got = tr.render_noisy(dt, tf, 12345, 7, **kw)
        ref = tr.render_noisy_plain(dt, tf, 12345, 7, **kw)
        torch.testing.assert_close(got[0], ref[0], atol=IMG_TOL, rtol=0)
        torch.testing.assert_close(got[1], ref[1], atol=AUX_TOL, rtol=0)
        torch.testing.assert_close(got[2], ref[2], atol=AUX_TOL, rtol=0)
        st = tr.render_stats(dt, tf, 12345, 7, **kw)
        assert st.equals(tr.render_stats_plain(dt, tf, 12345, 7, **kw))
        assert int(st.steps.max()) > 0 and (levels == 5) == (
            int(st.descents.sum()) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("estimator", ["rt", "classic"])
def test_k1_with_a_mesh_pass_matches_plain(shell, estimator, cuda_device):
    """Mesh depth clips the rays and mesh colour replaces the background,
    in both variants, on a 37x23 image."""
    transform, kw = _render_args(6, 37, 23)
    kw["opt"].estimator = estimator
    tf = torch.from_numpy(transform).to(cuda_device)
    dt = tt.upload_tree(shell, lut_levels=5, device=cuda_device)
    mc, md = (torch.from_numpy(a).to(cuda_device)
              for a in synthetic.random_mesh_pass(3, 37 * 23))
    got = tr.render_noisy(dt, tf, 99, 5, mesh_color=mc, mesh_depth=md, **kw)
    ref = tr.render_noisy_plain(dt, tf, 99, 5, mesh_color=mc, mesh_depth=md,
                                **kw)
    for g, r, tol in zip(got, ref, (IMG_TOL, AUX_TOL, AUX_TOL)):
        torch.testing.assert_close(g, r, atol=tol, rtol=0)
    plain = tr.render_noisy(dt, tf, 99, 5, **kw)
    assert not torch.equal(got[0], plain[0])  # the mesh showed


@pytest.mark.cuda
@pytest.mark.parametrize("estimator", ["rt", "classic"])
def test_k1_null_mesh_is_bit_equal_to_a_neutral_pass(shell, estimator,
                                                     cuda_device):
    """Null mesh pointers give the frame of a pass with no mesh anywhere
    (depth +inf, colour = background) bit for bit: the mesh inputs change
    no operation of a frame without a mesh."""
    transform, kw = _render_args(6, 37, 23)
    kw["opt"].estimator = estimator
    tf = torch.from_numpy(transform).to(cuda_device)
    dt = tt.upload_tree(shell, lut_levels=5, device=cuda_device)
    mc, md = (torch.from_numpy(a).to(cuda_device)
              for a in synthetic.random_mesh_pass(
                  0, 37 * 23, kw["opt"].background_brightness))
    got = tr.render_noisy(dt, tf, 99, 5, **kw)
    ref = tr.render_noisy(dt, tf, 99, 5, mesh_color=mc, mesh_depth=md, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 6, 32])
@pytest.mark.parametrize("fmt", ["sh", "rgba"])
def test_render_classic_matches_plain(shell, spp, fmt, cuda_device):
    """The classic variant ignores SPP; SH and RGBA rows; full-depth LUT
    (skips) and a level-3 LUT (descents); stop_thresh 1e-2 and 0.3 (an
    early stop on most hit rays); the statistics equal to the plain
    march's; odd max_steps rounds up to even as in the JAX loop."""
    tree = shell
    if fmt == "rgba":
        tree = synthetic.make_synthetic_tree("shell", depth=5, basis_dim=1)
        tree.data_format = DataFormat(BasisFormat.RGBA, -1)
    transform, kw = _render_args(spp, 37, 23)
    tf = torch.from_numpy(transform).to(cuda_device)
    frames = []
    for levels, stop in ((5, 1e-2), (3, 0.3)):
        kw["opt"] = RenderOptions(spp=spp, denoise=False,
                                  estimator="classic", stop_thresh=stop)
        dt = tt.upload_tree(tree, lut_levels=levels, device=cuda_device)
        got = tr.render_noisy(dt, tf, 12345, 7, **kw)
        ref = tr.render_noisy_plain(dt, tf, 12345, 7, **kw)
        for g, r, tol in zip(got, ref, (IMG_TOL, AUX_TOL, AUX_TOL)):
            torch.testing.assert_close(g, r, atol=tol, rtol=0)
        st = tr.render_stats(dt, tf, 12345, 7, **kw)
        assert st.equals(tr.render_stats_plain(dt, tf, 12345, 7, **kw))
        assert st.data_rows > 0
        frames.append(got[0])
        for max_steps in (3, 4):
            st = tr.render_stats(dt, tf, 1, 1, max_steps=max_steps, **kw)
            assert int(st.steps.max()) == 4
            assert st.equals(tr.render_stats_plain(
                dt, tf, 1, 1, max_steps=max_steps, **kw))
    assert not torch.equal(frames[0], frames[1])


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [((400, 400), (800, 800)),
                                     ((320, 320), (800, 800)),
                                     ((37, 23), (75, 47)),
                                     ((19, 30), (47, 75)),
                                     ((33, 53), (47, 75)),
                                     ((1, 1), (5, 3)),
                                     ((378, 504), (756, 1008)),
                                     ((540, 960), (1080, 1920))])
@pytest.mark.parametrize("want_aux", [True, False])
def test_k4_kernel_matches_plain(src, dst, want_aux, cuda_device):
    """The joint upsample at s = 0.5, 0.4 and 0.7-ish on odd sizes, a 1x1
    source and the llff and tt fast frames (504x378 -> 1008x756, 960x540
    -> 1920x1080), with and without aux_chw; the squares are of the
    upsampled values."""
    rs = np.random.default_rng(sum(src) + sum(dst))
    rgba = rs.random(src + (4,), np.float32)
    aux = torch.from_numpy(np.concatenate([rgba, rgba * rgba], -1)).to(
        cuda_device)
    got = fast_upsample(aux, *dst, want_aux=want_aux)
    ref = fast_upsample_plain(aux, *dst, want_aux=want_aux)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        torch.testing.assert_close(g, r, atol=UPSAMPLE_TOL, rtol=0)
    assert bool((got[0][..., 3] == 1).all())
    assert torch.equal(got[1][..., 4:], got[1][..., :4] * got[1][..., :4])


@pytest.mark.cuda
def test_k4_refuses_what_the_kernel_does_not_take(cuda_device):
    aux = torch.zeros((8, 8, 8), device=cuda_device)
    for bad in (lambda: fast_upsample(aux[..., :4], 16, 16),
                lambda: fast_upsample(aux.double(), 16, 16),
                lambda: fast_upsample(aux.transpose(0, 1), 16, 16),
                lambda: fast_upsample(aux, 0, 16)):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.cuda
def test_k1_uniforms_equal_the_twin(shell, cuda_device):
    """The kernel's per-pixel advance(idx * spp) draws are bit-exact with
    the tensor twin of the stream."""
    spp = 6
    transform, kw = _render_args(spp)
    dt = tt.upload_tree(shell, lut_levels=5, device=cuda_device)
    n = kw["width"] * kw["height"]
    state, inc = (1 << 63) + 987654321, 0xDA3E39CB94B95BDB
    got = torch.empty((n, spp), dtype=torch.float32, device=cuda_device)
    tr.render_noisy(dt, torch.from_numpy(transform).to(cuda_device), state,
                    inc, uniforms_out=got, **kw)
    ref = pcg32_uniforms_range(state, n=n * spp, inc=inc,
                               device=cuda_device).reshape(n, spp)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("supports,gscale,hw", [
    ((1, 2, 3, 4), 3.0, (64, 48)),
    ((0, 1, 2, 3), 3.0, (37, 23)),
    ((0, 1, 2, 3), 60.0, (64, 48)),
    ((0, 1, 2, 3, 4, 5, 6, 7), 3.0, (45, 70)),
    ((0, 7), 3.0, (5, 3)),
    ((1, 2, 3, 4, 5, 6, 7, 8), 3.0, (40, 50)),
])
def test_k2_kernel_matches_plain(supports, gscale, hw, layout, cuda_device):
    """The bf16 activation read in place, contiguous or in channels-last
    strides, at supports up to 7 and sizes that are no multiple of the
    32x8 tile."""
    act, img = _filter_inputs(6, L=len(supports), H=hw[0], W=hw[1],
                              gscale=gscale)
    act = torch.from_numpy(act).to(cuda_device, torch.bfloat16)
    if layout == "channels_last":
        act = act.contiguous(memory_format=torch.channels_last)
        assert act.stride()[1] == 1
    img = torch.from_numpy(img).to(cuda_device)
    got = guided_filter(act, img, supports)
    ref = guided_filter_act_plain(act, img, supports)
    torch.testing.assert_close(got, ref, atol=FILTER_TOL, rtol=0)
    ref2 = guided_filter_plain(*split_activation(act), img, supports)
    assert torch.equal(ref, ref2)


@pytest.mark.cuda
def test_k2_refuses_what_the_kernel_does_not_take(cuda_device):
    act, img = _filter_inputs(7, L=2, H=16, W=16)
    act = torch.from_numpy(act).to(cuda_device, torch.bfloat16)
    img = torch.from_numpy(img).to(cuda_device)
    for bad in (lambda: guided_filter(act, img, (0, 9)),
                lambda: guided_filter(act.float(), img, (0, 1)),
                lambda: guided_filter(act, img[..., :3].contiguous(), (0, 1)),
                lambda: guided_filter(act[:, :3], img, (0, 1))):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53), (32, 80, 80)],
                         ids=["2x37x53", "32x80x80"])
@pytest.mark.parametrize("supports,gscale", [
    ((1, 2, 3, 4), 3.0), ((0, 1, 2, 3), 3.0), ((0, 1, 2, 3), 40.0)],
    ids=["ladder", "identity", "range > 60 nats"])
def test_k5_k6_match_plain(shape, supports, gscale, cuda_device):
    """K5's output within FILTER_TOL of the plain batched filter; K6's
    weight and guidance gradients within GRAD_REL_TOL of the largest
    plain gradient, at a size that is no multiple of the 32x8 tile and at
    the training batch (32 slices of 80x80), on the reference ladder, the
    identity supports, and a window whose guidance spans > 60 nats."""
    B, H, W = shape
    w, g, x, G = (torch.from_numpy(a).to(cuda_device) for a in
                  _batch_inputs(11, B, 4, H, W, gscale))
    out, saved = guided_filter_batch_fwd(w, g, x, supports)
    ref = guided_filter_batch_plain(w, g, x, supports)
    torch.testing.assert_close(out, ref, atol=FILTER_TOL, rtol=0)
    gw, gg = guided_filter_batch_bwd(G, w, g, x, saved, supports)
    rw, rg = guided_filter_backward_plain(G, w, g, x, supports)
    for got, want in ((gw, rw), (gg, rg)):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= \
            GRAD_REL_TOL * float(want.abs().max())
    if supports[0] == 0:
        assert not gg[:, 0].any()


@pytest.mark.cuda
def test_k5_k6_autograd_function_launches_each_once(cuda_device):
    """guided_filter_batch on CUDA tensors: one K5 launch forward, one K6
    launch backward, and gradients only for weight and guidance, equal to
    the kernels' called directly."""
    w, g, x, G = (torch.from_numpy(a).to(cuda_device) for a in
                  _batch_inputs(12, 3, 4, 24, 40))
    wr, gr = w.clone().requires_grad_(), g.clone().requires_grad_()
    native.reset_launches()
    guided_filter_batch(wr, gr, x, (1, 2, 3, 4)).backward(G)
    torch.cuda.synchronize()
    assert native.LAUNCHES["guided_filter_batch"] == 1
    assert native.LAUNCHES["guided_filter_batch_bwd"] == 1
    _, saved = guided_filter_batch_fwd(w, g, x, (1, 2, 3, 4))
    gw, gg = guided_filter_batch_bwd(G, w, g, x, saved, (1, 2, 3, 4))
    assert torch.equal(wr.grad, gw) and torch.equal(gr.grad, gg)


@pytest.mark.cuda
def test_k5_k6_refuse_what_the_kernels_do_not_take(cuda_device):
    w, g, x, G = (torch.from_numpy(a).to(cuda_device) for a in
                  _batch_inputs(13, 1, 2, 16, 16))
    _, saved = guided_filter_batch_fwd(w, g, x, (0, 1))
    for bad in (lambda: guided_filter_batch_fwd(w, g, x, (0, 9)),
                lambda: guided_filter_batch_fwd(w.double(), g, x, (0, 1)),
                lambda: guided_filter_batch_fwd(w, g[..., :8], x, (0, 1)),
                lambda: guided_filter_batch_fwd(w, g, x[..., :3], (0, 1)),
                lambda: guided_filter_batch_fwd(w.transpose(2, 3), g, x,
                                                (0, 1)),
                lambda: guided_filter_batch_bwd(G[..., :3], w, g, x, saved,
                                                (0, 1))):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.cuda
def test_k3_kernel_matches_plain(shell, chain, cuda_device):
    """Integer-equal LUT and skip lanes, full-depth and partial LUT."""
    for tree, levels in ((shell, 5), (chain, 5)):
        chs = tt.upload_tree(tree, 0, device=cuda_device).chs
        lut_k = tt.build_lut(chs, 2, levels)
        lut_p = tt.lut_build_plain(chs, 2, levels)
        assert torch.equal(lut_k, lut_p)
        res = 2 ** levels
        assert torch.equal(tt.add_skip_distances(lut_k.clone(), res, 12),
                           tt.add_skip_distances_plain(lut_p, res, 12))


@pytest.fixture(scope="module")
def refined():
    """A depth-6 shell: the depth-4 shell refined 2 levels."""
    base = synthetic.make_synthetic_tree("shell", depth=4, basis_dim=4)
    thickness = max(3.0 / 2 ** 4, 0.02)
    return synthetic.refine_tree(
        base, lambda p: synthetic.shell_sigma(p, thickness=thickness,
                                              amplitude=4.0 / thickness),
        synthetic.position_color, levels=2)


@pytest.mark.cuda
def test_k3_marked_partial_lut_matches_plain(refined, cuda_device):
    """A deep tree's partial LUT: the internal cells' marker and the skip
    distances around them integer-equal to the plain version, and equal
    to what upload_tree builds."""
    dt = tt.upload_tree(refined, lut_levels=4, device=cuda_device,
                        force_sparse_brick=True)
    assert dt.lut_levels == 4 and dt.skip_cap == 12
    mark = tt.LUT_INTERNAL_MARK
    lut_k = tt.build_lut(dt.chs, 2, 4, mark)
    lut_p = tt.lut_build_plain(dt.chs, 2, 4, mark)
    assert torch.equal(lut_k, lut_p)
    assert int((lut_p[:, 1] == mark).sum()) > 0
    skip_k = tt.add_skip_distances(lut_k.clone(), 16, 12)
    assert torch.equal(skip_k, tt.add_skip_distances_plain(lut_p, 16, 12))
    assert torch.equal(skip_k, dt.lut)


@pytest.mark.cuda
@pytest.mark.parametrize("skip_cap", [12, 0])
def test_k1_on_a_partial_lut_matches_plain(refined, skip_cap, cuda_device):
    """K1 on the refined shell's marked level-4 LUT, with and without its
    skip distances, at an odd size: within IMG_TOL / AUX_TOL of the plain
    version, the statistics' counts equal."""
    transform, kw = _render_args(6, 37, 23)
    tf = torch.from_numpy(transform).to(cuda_device)
    dt = tt.upload_tree(refined, lut_levels=4, device=cuda_device,
                        skip_cap=skip_cap, force_sparse_brick=True)
    assert dt.skip_cap == skip_cap
    got = tr.render_noisy(dt, tf, 12345, 7, **kw)
    ref = tr.render_noisy_plain(dt, tf, 12345, 7, **kw)
    for g, r, tol in zip(got, ref, (IMG_TOL, AUX_TOL, AUX_TOL)):
        torch.testing.assert_close(g, r, atol=tol, rtol=0)
    st = tr.render_stats(dt, tf, 12345, 7, **kw)
    assert st.equals(tr.render_stats_plain(dt, tf, 12345, 7, **kw))
    assert int(st.descents.sum()) > 0


@pytest.mark.cuda
def test_k1_ignores_the_internal_marker(refined, cuda_device):
    """K1 on the marked partial LUT without skip distances equals, bit for
    bit, K1 on the same LUT without the marker: the kernel descends from an
    internal cell and reads the leaf's own sigma, never the cell's lane."""
    transform, kw = _render_args(6, 37, 23)
    tf = torch.from_numpy(transform).to(cuda_device)
    marked = tt.upload_tree(refined, lut_levels=4, device=cuda_device,
                            skip_cap=0, force_sparse_brick=True)
    unmarked = dataclasses.replace(marked,
                                   lut=tt.build_lut(marked.chs, 2, 4))
    assert not torch.equal(marked.lut, unmarked.lut)
    for got, ref in zip(tr.render_noisy(marked, tf, 12345, 7, **kw),
                        tr.render_noisy(unmarked, tf, 12345, 7, **kw)):
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_k1_ndc_at_an_odd_size_matches_plain(cuda_device):
    """K1's NDC rays on a blobs tree at 41x29 (the llff camera, focal
    scaled to the width): within IMG_TOL / AUX_TOL of the plain version."""
    tree = synthetic.make_synthetic_tree("blobs", depth=5, basis_dim=4)
    tree.use_ndc = True
    tree.ndc_width, tree.ndc_height, tree.ndc_focal = 1008.0, 756.0, 800.0
    cam = Camera(width=41, height=29, fx=800.0 * 41 / 1008,
                 fy=800.0 * 41 / 1008)
    cam.center = np.array([0.02, 0.01, 0.3], np.float32)
    cam.v_back = np.array([0.0, 0.0, 1.0], np.float32)
    cam.v_world_up = np.array([0.0, 1.0, 0.0], np.float32)
    cam.update()
    dt = tt.upload_tree(tree, lut_levels=5, device=cuda_device)
    tf = torch.from_numpy(cam.transform.astype(np.float32)).to(cuda_device)
    kw = dict(width=41, height=29, fx=cam.fx, fy=cam.fy,
              opt=RenderOptions(spp=6, denoise=False))
    got = tr.render_noisy(dt, tf, 12345, 7, **kw)
    ref = tr.render_noisy_plain(dt, tf, 12345, 7, **kw)
    for g, r, tol in zip(got, ref, (IMG_TOL, AUX_TOL, AUX_TOL)):
        torch.testing.assert_close(g, r, atol=tol, rtol=0)
    assert float(got[2][3].max()) > 0.5  # the blobs are in view


@pytest.mark.cuda
@pytest.mark.parametrize("levels", range(1, 8))
def test_k3_build_at_each_level_matches_plain(shell, chain, levels,
                                              cuda_device):
    """One to three launches, leaves found in a coarse table or below it,
    and (chain) cells still internal at the LUT level."""
    for tree in (shell, chain):
        chs = tt.upload_tree(tree, 0, device=cuda_device).chs
        assert torch.equal(tt.build_lut(chs, 2, levels),
                           tt.lut_build_plain(chs, 2, levels))


@pytest.mark.cuda
def test_k3_generic_n_matches_plain(cuda_device):
    """N = 3 takes the kernels' division paths: a 27^3 grid, whose rows
    are not a multiple of 16 cells."""
    tree = synthetic.build_tree(synthetic.shell_sigma,
                                synthetic.position_color, depth=3, N=3,
                                basis_dim=1)
    chs = tt.upload_tree(tree, 0, device=cuda_device).chs
    for levels in (1, 2, 3):
        lut_k = tt.build_lut(chs, 3, levels)
        lut_p = tt.lut_build_plain(chs, 3, levels)
        assert torch.equal(lut_k, lut_p)
    for cap in (1, 12, 253):
        assert torch.equal(tt.add_skip_distances(lut_k.clone(), 27, cap),
                           tt.add_skip_distances_plain(lut_p, 27, cap))


@pytest.mark.cuda
@pytest.mark.parametrize("res", [8, 64, 128])
def test_k3_skip_on_random_luts_matches_plain(res, cuda_device):
    """Any LUT handed straight to the skip entry, from empty to full."""
    for i, occupancy in enumerate((0.0, 1e-4, 1e-2, 0.5, 1.0)):
        lut = torch.from_numpy(synthetic.random_lut(res, occupancy, i)).to(
            cuda_device)
        for cap in (1, 5, 12, 253):
            got = tt.add_skip_distances(lut.clone(), res, cap)
            assert torch.equal(got, tt.add_skip_distances_plain(lut, res,
                                                                cap)), (
                occupancy, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("res", [16, 27, 64])
def test_k3_skip_with_occupied_faces_matches_plain(res, cuda_device):
    """Occupied cells only on the grid's faces, edges and corners, where
    the passes' halos are cut by the grid."""
    rs = np.random.default_rng(res)
    occ = np.zeros((res, res, res), bool)
    for axis in range(3):
        for side in (0, res - 1):
            face = [slice(None)] * 3
            face[axis] = side
            occ[tuple(face)] |= rs.random((res, res)) < 0.02
    for c in np.ndindex(2, 2, 2):
        occ[tuple(np.array(c) * (res - 1))] = True
    lut = synthetic.random_lut(res, 0.0, 7)
    lut[occ.reshape(-1), 1] = 0x3f800000
    lut = torch.from_numpy(lut).to(cuda_device)
    for cap in (1, 12, 253):
        assert torch.equal(tt.add_skip_distances(lut.clone(), res, cap),
                           tt.add_skip_distances_plain(lut, res, cap)), cap


@pytest.mark.cuda
def test_g1_affine_matches_plain(cuda_device):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 1000)).astype(np.float32)).to(cuda_device)
    assert torch.equal(pr.probe_affine(x), pr.probe_affine_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [None, 0, 1, 7])
def test_g2_lane_gather_matches_plain(rounds, cuda_device):
    """P2 (a single f32 gather) and P3 (int32 chains from shared memory),
    bit for bit; a width of 12 takes 4 columns per block, 6 takes 2."""
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    for W in (12, 6):
        if rounds is None:
            tab, idx = map(t, _lane_inputs(W, np.float32, W=W))
            got, ref = pr.lane_gather(tab, idx), pr.lane_gather_plain(tab, idx)
        else:
            tab, idx = map(t, _lane_inputs(W, np.int32, W=W))
            got = pr.lane_gather_chain(tab, idx, rounds)
            ref = pr.lane_gather_chain_plain(tab, idx, rounds)
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 3, 128])
def test_g3_row_ring_matches_plain(width, cuda_device):
    """Rows of 4, 8, 12 and 512 B (copy chunks of 4, 8, 4 and 16 B).  The
    int32 element-0 sum wraps like JAX's at every ring depth; the f32 row
    sum keeps the order of i, so it equals a float32 loop in that order."""
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    idx, table = _ring_inputs(width, width, np.int32)
    ref = pr.row_ring_rounds_plain(t(idx), t(table), 2, 3)
    for nbuf in pr.RING_DEPTHS:
        assert torch.equal(pr.row_ring_rounds(t(idx), t(table), nbuf, 3), ref)
    idx, table = _ring_inputs(width, width, np.float32)
    acc = np.zeros(width, np.float32)
    for i in idx:
        acc = acc + table[i]
    got = pr.row_sum_ring(t(idx), t(table))
    assert np.array_equal(got.cpu().numpy()[0], acc)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1 << 10, 1 << 16])
def test_g4_flat_gather_chain_matches_plain(size, cuda_device):
    """A 4 KB table staged in shared memory and a 256 KB one read from
    L2."""
    idx, table = (torch.from_numpy(a).to(cuda_device)
                  for a in _flat_inputs(size, size))
    for rounds in (0, 1, 16):
        assert torch.equal(pr.flat_gather_chain(idx, table, rounds),
                           pr.flat_gather_chain_plain(idx, table, rounds))
