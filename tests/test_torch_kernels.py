"""The port's CUDA kernels (K1 render and its classic variant, each also
in ray mode (trace_rays, trace_rays_classic), K2 guided
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
import os
import subprocess
import sys

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
from rt_octree_tpu_torch.ops.filtering import BATCH_TILE_H, BATCH_TILE_W, \
    GUARD_RANGE, batch_tiles, guided_filter, guided_filter_act_plain, \
    guided_filter_backward_plain, guided_filter_batch, \
    guided_filter_batch_bwd, guided_filter_batch_bwd_wide_stats, \
    guided_filter_batch_fwd, \
    guided_filter_batch_plain, guided_filter_plain, split_activation, \
    guided_filter_wide_stats, wide_filter_tiles
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
# K6 vs plain: the factorised window sums (or, on a guard tile, the gather)
# of up to 81 taps of exp * (u.x - v) in another order than the plain
# version's, with FMA contraction: within 1e-4 of the plain gradient's
# largest magnitude.
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
        g[0, 1, min(3, H - 1), min(4, W - 1)] = 70.0
        g[0, 1, min(4, H - 1), min(5, W - 1)] = -5.0
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


def _aimed_rays(dt, n, spp, seed=0, unit=True):
    """``synthetic.aimed_rays`` on the tree's device and sorted thresholds
    [n, spp] from the same generator."""
    rs = np.random.default_rng(seed)
    rays = synthetic.aimed_rays(rs, n, unit=unit)
    u = rs.random((n, spp))
    t = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.float32)).to(dt.device)
    dst = torch.sort(-torch.log1p(-t(u)), dim=-1).values
    return (*(t(a) for a in rays), dst)


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
    d, v, c, dst = _aimed_rays(dt, 8, 1)
    tr.trace_rays(dt, d, v, c, dst, RenderOptions(spp=1))
    tr.trace_rays_classic(dt, d, v, c, RenderOptions())
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
    # the wide instances: SG rows past basis_dim 25 (render_classic's
    # chunked instance past 40), nine levels, a 96-channel net
    classic = RenderOptions(estimator="classic", denoise=False)
    for bd in (32, 96):
        wt = tt.upload_tree(_wide_tree("SG", bd, depth=3), lut_levels=0,
                            device=device)
        d, v, c, dst = _aimed_rays(wt, 8, 1)
        if bd <= tr.CLASSIC_WIDE_MAX_BASIS:
            tr.render_noisy(wt, tf, 1, 1, **dict(kw, opt=RenderOptions(
                spp=1, denoise=False)))
            tr.trace_rays(wt, d, v, c, dst, RenderOptions(spp=1))
        tr.render_noisy(wt, tf, 1, 1, **dict(kw, opt=classic))
        tr.trace_rays_classic(wt, d, v, c, RenderOptions())
    act, img = _filter_inputs(1, L=9, H=8, W=8)
    guided_filter(t(act).to(torch.bfloat16), t(img), tuple(range(9)))
    cfg = GuidanceNetConfig(mid_channels=96, kernel_levels=2)
    build_compact(cfg, {f"block_{i}": {
        "kernel": (rs.standard_normal((3, 3, cin, cout)) * 0.05).astype(
            np.float32),
        "bias": rs.standard_normal(cout).astype(np.float32)}
        for i, (cin, cout) in enumerate(cfg.layer_channels())},
        device).activation(aux[None])
    w, g, x, G = (t(a) for a in _batch_inputs(1, B=1, L=9, H=8, W=8))
    w.requires_grad_()
    guided_filter_batch(w, g, x, tuple(range(9))).backward(G)


def test_cpu_tensors_take_the_plain_versions(shell):
    """On CPU tensors no wrapper launches, so no count moves."""
    native.reset_launches()
    _launch_each_wrapper(shell, "cpu")
    assert native.LAUNCHES == {k: 0 for k in native.LAUNCHES}


@pytest.mark.cuda
def test_each_wrapper_counts_its_launch(shell, cuda_device):
    """One count per kernel launched, the wide instances' too: the level-3
    LUT build is one launch, the skip distances three (a row pass and two
    axis passes)."""
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


def _classic_tree(layout, depth=5):
    """A shell in one of render_classic's row layouts: "SH<bd>", "RGBA"
    (raw rgb rows), "SG<bd>" / "ASG<bd>" (random lobes)."""
    fmt = layout.rstrip("0123456789")
    bd = int(layout[len(fmt):] or 1)
    tree = synthetic.make_synthetic_tree("shell", depth=depth, basis_dim=bd)
    if fmt == "RGBA":
        tree.data_format = DataFormat(BasisFormat.RGBA, -1)
        rgb = tree.data[:, :3].astype(np.float32)
        tree.data[:, :3] = (1.0 / (1.0 + np.exp(-rgb))).astype(np.float16)
    elif fmt in ("SG", "ASG"):
        rs = np.random.default_rng(bd)
        width, sharp = (4, 1) if fmt == "SG" else (11, 2)
        extra = rs.standard_normal((bd, width))
        extra[:, :sharp] = rs.uniform(0.5, 4.0, (bd, sharp))
        tree.data_format = DataFormat(BasisFormat[fmt], bd)
        tree.extra = extra.astype(np.float32)
    return tree


def _classic_opt(**kw):
    return RenderOptions(**{"spp": 1, "denoise": False,
                            "estimator": "classic", **kw})


def _hold_classic(dt, tf, kw, rng=(12345, 7)):
    """render_classic within IMG_TOL / AUX_TOL of its plain version and its
    statistics (shaded steps too) equal to the plain march's; returns the
    kernel's frame and statistics."""
    got = tr.render_noisy(dt, tf, *rng, **kw)
    ref = tr.render_noisy_plain(dt, tf, *rng, **kw)
    for g, r, tol in zip(got, ref, (IMG_TOL, AUX_TOL, AUX_TOL)):
        torch.testing.assert_close(g, r, atol=tol, rtol=0)
    st = tr.render_stats(dt, tf, *rng, **kw)
    assert st.equals(tr.render_stats_plain(dt, tf, *rng, **kw))
    return got, st


CLASSIC_LAYOUTS = ["SH1", "SH4", "SH9", "SH16", "SH25", "RGBA", "SG4",
                   "ASG25"]


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 6, 32])
@pytest.mark.parametrize("layout", CLASSIC_LAYOUTS)
def test_render_classic_matches_plain(layout, spp, cuda_device):
    """Every instance of render_classic (SH at basis_dim 1, 4, 9, 16, 25,
    raw rgb, SG and ASG through the unrolled one), which ignores SPP, at
    37x23: full-depth LUT (skips) and a level-3 LUT (descents); stop_thresh
    1e-2, 0.3 (an early stop on most hit rays) and 1e-6 (long rays through
    many lookahead steps); the statistics equal to the plain march's; odd
    max_steps rounds up to even as in the JAX loop."""
    transform, kw = _render_args(spp, 37, 23)
    tf = torch.from_numpy(transform).to(cuda_device)
    tree = _classic_tree(layout)
    frames = []
    for levels in (5, 3):
        dt = tt.upload_tree(tree, lut_levels=levels, device=cuda_device)
        for stop in (1e-2, 0.3, 1e-6):
            kw["opt"] = _classic_opt(spp=spp, stop_thresh=stop)
            got, st = _hold_classic(dt, tf, kw)
            assert st.data_rows > 0 and (levels == 5) == (
                int(st.descents.sum()) == 0)
            frames.append(got[0])
        for max_steps in (3, 4):
            st = tr.render_stats(dt, tf, 1, 1, max_steps=max_steps, **kw)
            assert int(st.steps.max()) == 4
            assert st.equals(tr.render_stats_plain(
                dt, tf, 1, 1, max_steps=max_steps, **kw))
    assert not torch.equal(frames[0], frames[1])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["SH4", "SH9", "SH25", "RGBA"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_render_classic_rows_off_8_bytes(layout, offset, cuda_device):
    """The same rows seen through a view ``offset`` halfs into a larger
    buffer, so that no row starts on 8 bytes where it did (the words are
    realigned in registers): within the tolerances of the plain version."""
    transform, kw = _render_args(1, 37, 23)
    kw["opt"] = _classic_opt()
    tf = torch.from_numpy(transform).to(cuda_device)
    dt = tt.upload_tree(_classic_tree(layout), lut_levels=5,
                        device=cuda_device)
    flat = torch.zeros(dt.data.numel() + 4, dtype=dt.data.dtype,
                       device=cuda_device)
    view = flat[offset:offset + dt.data.numel()].view(dt.data.shape)
    view.copy_(dt.data)
    assert view.data_ptr() % 8 != 0
    _hold_classic(dataclasses.replace(dt, data=view), tf, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(1, 1), (37, 23), (33, 9)])
@pytest.mark.parametrize("max_steps", [1, 2, 3, 4, 5, 8192])
def test_render_classic_ragged_sizes_and_step_limits(size, max_steps,
                                                     cuda_device):
    """Ragged images (the 8x4 warp tiles' edge) and step limits around the
    one-step lookahead, odd limits rounded up to even as in the JAX loop."""
    transform, kw = _render_args(1, *size)
    kw.update(opt=_classic_opt(), max_steps=max_steps)
    tf = torch.from_numpy(transform).to(cuda_device)
    dt = tt.upload_tree(_classic_tree("SH9"), lut_levels=5,
                        device=cuda_device)
    _, st = _hold_classic(dt, tf, kw)
    assert int(st.steps.max()) <= max_steps + (max_steps & 1)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [
    dict(basis_minmax=(2, 5)), dict(basis_minmax=(0, 0)),
    dict(rot_dirs=(0.3, -0.2, 0.5)), dict(rot_dirs=(1e5, 2e5, 0.0))],
    ids=["minmax 2-5", "minmax 0-0", "rot", "rot huge"])
@pytest.mark.parametrize("layout", ["SH9", "SG4"])
def test_render_classic_masks_and_rotations(layout, opts, cuda_device):
    """A basis_minmax mask and rotated view directions (the kernel takes
    the rotation's cosine and sine from the wrapper) on an SH and an SG
    instance."""
    transform, kw = _render_args(1, 37, 23)
    kw["opt"] = _classic_opt(**opts)
    tf = torch.from_numpy(transform).to(cuda_device)
    dt = tt.upload_tree(_classic_tree(layout), lut_levels=5,
                        device=cuda_device)
    _hold_classic(dt, tf, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["SH9", "SH16", "RGBA", "ASG25"])
def test_render_classic_mesh_pass_on_each_row_shape(layout, cuda_device):
    """A random mesh pass matches the plain version, and null mesh
    pointers equal a neutral pass bit for bit, on the instances whose
    rows the other classic tests do not mesh."""
    transform, kw = _render_args(1, 37, 23)
    kw["opt"] = _classic_opt()
    tf = torch.from_numpy(transform).to(cuda_device)
    dt = tt.upload_tree(_classic_tree(layout), lut_levels=5,
                        device=cuda_device)
    mc, md = (torch.from_numpy(a).to(cuda_device)
              for a in synthetic.random_mesh_pass(3, 37 * 23))
    got = tr.render_noisy(dt, tf, 99, 5, mesh_color=mc, mesh_depth=md, **kw)
    ref = tr.render_noisy_plain(dt, tf, 99, 5, mesh_color=mc, mesh_depth=md,
                                **kw)
    for g, r, tol in zip(got, ref, (IMG_TOL, AUX_TOL, AUX_TOL)):
        torch.testing.assert_close(g, r, atol=tol, rtol=0)
    mc0, md0 = (torch.from_numpy(a).to(cuda_device)
                for a in synthetic.random_mesh_pass(
                    0, 37 * 23, kw["opt"].background_brightness))
    for g, r in zip(tr.render_noisy(dt, tf, 99, 5, **kw),
                    tr.render_noisy(dt, tf, 99, 5, mesh_color=mc0,
                                    mesh_depth=md0, **kw)):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_render_classic_ndc_matches_plain(cuda_device):
    """NDC rays on a blobs tree at 41x29 (the llff camera)."""
    tree = synthetic.make_synthetic_tree("blobs", depth=5, basis_dim=9)
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
    kw = dict(width=41, height=29, fx=cam.fx, fy=cam.fy, opt=_classic_opt())
    got, _ = _hold_classic(dt, tf, kw)
    assert float(got[2][3].max()) > 0.5


@pytest.mark.cuda
def test_render_classic_refuses_layouts_it_has_no_instance_for(shell,
                                                              cuda_device):
    """An SH tree of basis_dim 2 has no instance: ValueError, no launch."""
    transform, kw = _render_args(1, 8, 8)
    kw["opt"] = _classic_opt()
    dt = tt.upload_tree(shell, lut_levels=5, device=cuda_device)
    odd = dataclasses.replace(dt, basis_dim=2)
    native.reset_launches()
    with pytest.raises(ValueError):
        tr.render_noisy(odd, torch.from_numpy(transform).to(cuda_device),
                        1, 1, **kw)
    assert native.LAUNCHES["render_classic"] == 0


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


# K1's row bands of a 37x23 frame: three bands that tile it, one row inside,
# the last row, the whole frame
BANDS = ((0, 8), (8, 8), (16, 7), (11, 1), (22, 1), (0, 23))


def _band_frames(dt, tf, estimator, fn):
    """fn's whole 37x23 frame (the default band) and each band of BANDS."""
    transform, kw = _render_args(3, 37, 23)
    kw["opt"] = RenderOptions(spp=3, denoise=False, estimator=estimator)
    full = fn(dt, tf, 12345, 7, **kw)
    return full, [fn(dt, tf, 12345, 7, row0=r0, rows=n, **kw)
                  for r0, n in BANDS]


def _assert_band_rows(full, bands):
    for (r0, n), (img, aux, chw) in zip(BANDS, bands):
        assert img.shape == (n, 37, 4) and chw.shape == (8, n, 37)
        assert torch.equal(img, full[0][r0:r0 + n])
        assert torch.equal(aux, full[1][r0:r0 + n])
        assert torch.equal(chw, full[2][:, r0:r0 + n])


@pytest.mark.parametrize("estimator", ["rt", "classic"])
def test_plain_band_is_the_frames_rows(shell, estimator):
    """The plain band (the frame's camera rays of its rows, the PCG32
    stream advanced by row0 * W * spp) equals those rows of the whole
    plain frame bit for bit, and row0 = 0, rows = H is the frame."""
    dt = tt.upload_tree(shell, lut_levels=5, device="cpu")
    tf = torch.from_numpy(_render_args(3)[0])
    full, bands = _band_frames(dt, tf, estimator, tr.render_noisy_plain)
    assert float(full[0][..., :3].std()) > 0.05  # the shell is in view
    _assert_band_rows(full, bands)


def test_band_refusals(shell):
    """A band outside the frame, and a band with a mesh pass or
    statistics, raise ValueError."""
    dt = tt.upload_tree(shell, lut_levels=3, device="cpu")
    transform, kw = _render_args(2, 16, 8)
    tf = torch.from_numpy(transform)
    for r0, n in ((-1, 2), (0, 0), (6, 3), (8, 1)):
        with pytest.raises(ValueError, match="band"):
            tr.render_noisy(dt, tf, 1, 3, row0=r0, rows=n, **kw)
    mc, md = torch.zeros(128, 3), torch.full((128,), 1e9)
    with pytest.raises(ValueError, match="mesh pass"):
        tr.render_noisy(dt, tf, 1, 3, mesh_color=mc, mesh_depth=md, row0=2,
                        rows=2, **kw)
    with pytest.raises(ValueError, match="statistics"):
        tr.render_noisy_plain(dt, tf, 1, 3, stats={}, row0=2, rows=2, **kw)
    tr.render_noisy(dt, tf, 1, 3, mesh_color=mc, mesh_depth=md, row0=0,
                    rows=8, **kw)  # the whole frame takes both


@pytest.mark.cuda
@pytest.mark.parametrize("estimator", ["rt", "classic"])
def test_k1_band_is_the_frames_rows(shell, estimator, cuda_device):
    """K1's (render_classic's) band equals those rows of its whole frame
    bit for bit, row0 = 0, rows = H is the frame, and each band is within
    IMG_TOL / AUX_TOL of the plain band; a band's PCG32 uniforms are the
    frame's rows'."""
    dt = tt.upload_tree(shell, lut_levels=5, device=cuda_device)
    tf = torch.from_numpy(_render_args(3)[0]).to(cuda_device)
    full, bands = _band_frames(dt, tf, estimator, tr.render_noisy)
    _assert_band_rows(full, bands)
    dt_cpu = tt.upload_tree(shell, lut_levels=5, device="cpu")
    _, plain = _band_frames(dt_cpu, tf.cpu(), estimator,
                            tr.render_noisy_plain)
    for got, ref in zip(bands, plain):
        torch.testing.assert_close(got[0].cpu(), ref[0], atol=IMG_TOL, rtol=0)
        torch.testing.assert_close(got[1].cpu(), ref[1], atol=AUX_TOL, rtol=0)
    if estimator == "rt":
        _, kw = _render_args(3, 37, 23)
        u_full = torch.empty((37 * 23, 3), device=cuda_device)
        tr.render_noisy(dt, tf, 12345, 7, uniforms_out=u_full, **kw)
        u_band = torch.empty((37 * 7, 3), device=cuda_device)
        tr.render_noisy(dt, tf, 12345, 7, uniforms_out=u_band, row0=16,
                        rows=7, **kw)
        assert torch.equal(u_band, u_full[37 * 16:])


def _tmax(dt, n, seed):
    """``synthetic.ray_world_depths`` on the tree's device."""
    return torch.from_numpy(synthetic.ray_world_depths(
        np.random.default_rng(seed), n)).to(dt.device)


@pytest.mark.cuda
@pytest.mark.parametrize("tmax", [False, True])
@pytest.mark.parametrize("spp", tr.SPP_KERNEL)
def test_k1_ray_mode_matches_plain(shell, spp, tmax, cuda_device):
    """K1's ray mode (render_rays) on 1000 aimed rays, not unit length,
    with rotated view dirs, at every SPP of the kernel, with and without
    world depths, on the full-depth LUT and a level-3 LUT: within IMG_TOL
    of trace_rays_plain on the same card; most rays hit."""
    for levels in (5, 3):
        dt = tt.upload_tree(shell, lut_levels=levels, device=cuda_device)
        d, v, c, dst = _aimed_rays(dt, 1000, spp, spp, unit=False)
        tm = _tmax(dt, 1000, spp) if tmax else None
        native.reset_launches()
        got = tr.trace_rays(dt, d, v, c, dst, RenderOptions(spp=spp),
                            tmax_bg=tm)
        assert native.LAUNCHES["render_rays"] == 1
        ref = tr.trace_rays_plain(dt, d, v, c, dst, RenderOptions(spp=spp),
                                  tmax_bg=tm)
        torch.testing.assert_close(got, ref, atol=IMG_TOL, rtol=0)
        assert float((got[:, 3] > 0).float().mean()) > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("unroll,max_steps", [(1, 7), (2, 7), (3, 7),
                                              (3, 8192)])
@pytest.mark.parametrize("layout", CLASSIC_LAYOUTS)
def test_render_classic_ray_mode_matches_plain(layout, unroll, max_steps,
                                               cuda_device):
    """render_classic's ray mode on every instance, aimed rays with world
    depths, the step limit rounded up to ``unroll`` by the wrapper: within
    IMG_TOL of trace_rays_classic_plain."""
    dt = tt.upload_tree(_classic_tree(layout), lut_levels=5,
                        device=cuda_device)
    d, v, c, _ = _aimed_rays(dt, 1000, 1, 3, unit=False)
    kw = dict(tmax_bg=_tmax(dt, 1000, 4), max_steps=max_steps, unroll=unroll)
    native.reset_launches()
    got = tr.trace_rays_classic(dt, d, v, c, _classic_opt(), **kw)
    assert native.LAUNCHES["render_classic_rays"] == 1
    ref = tr.trace_rays_classic_plain(dt, d, v, c, _classic_opt(), **kw)
    torch.testing.assert_close(got, ref, atol=IMG_TOL, rtol=0)
    assert float((got[:, 3] > 0).float().mean()) > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("estimator", ["rt", "classic"])
def test_ray_mode_on_a_frames_rays_is_the_frame(shell, estimator,
                                                cuda_device):
    """The rays, view dirs and thresholds of a 37x23 frame (the plain
    camera rays, rodrigues, K1's own uniforms sorted), through the ray mode
    and composited over the background: the kernel's frame within
    IMG_TOL."""
    transform, kw = _render_args(6, 37, 23)
    kw["opt"] = RenderOptions(spp=6, denoise=False, estimator=estimator,
                              rot_dirs=(0.1, 0.2, -0.3))
    dt = tt.upload_tree(shell, lut_levels=5, device=cuda_device)
    tf = torch.from_numpy(transform).to(cuda_device)
    u = torch.empty((37 * 23, 6), device=cuda_device)
    img = tr.render_noisy(dt, tf, 12345, 7, uniforms_out=u, **kw)[0]
    dirs, cens = tr.device_camera_rays(tf, 37, 23, kw["fx"], kw["fy"])
    vdirs = tr.rodrigues(kw["opt"].rot_dirs, dirs)
    cens = cens.contiguous()
    if estimator == "rt":
        out = tr.trace_rays(dt, dirs, vdirs, cens,
                            torch.sort(-torch.log1p(-u), dim=-1).values,
                            kw["opt"])
    else:
        out = tr.trace_rays_classic(dt, dirs, vdirs, cens, kw["opt"])
    comp = tr.composite(out, 37, 23, kw["opt"].background_brightness)[0]
    torch.testing.assert_close(comp, img, atol=IMG_TOL, rtol=0)


@pytest.mark.cuda
def test_ray_mode_refuses_what_the_kernel_does_not_take(shell, cuda_device):
    """On the card: an SPP the kernel has no instance for, inputs on
    another device, a layout no instance takes (SH rows past basis_dim
    25: no such SH basis)."""
    dt = tt.upload_tree(shell, lut_levels=5, device=cuda_device)
    d, v, c, dst = _aimed_rays(dt, 16, 5)
    with pytest.raises(ValueError, match="SPP"):
        tr.trace_rays(dt, d, v, c, dst, RenderOptions(spp=5))
    with pytest.raises(ValueError):
        tr.trace_rays(dt, d.cpu(), v, c, dst[:, :4].contiguous(),
                      RenderOptions(spp=4))
    with pytest.raises(ValueError, match="basis_dim"):
        tr.trace_rays_classic(dataclasses.replace(dt, basis_dim=26), d, v, c,
                              RenderOptions())


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
    for bad in (lambda: guided_filter(act, img, (0, 33)),
                lambda: guided_filter(act.float(), img, (0, 1)),
                lambda: guided_filter(act, img[..., :3].contiguous(), (0, 1)),
                lambda: guided_filter(act[:, :3], img, (0, 1))):
        with pytest.raises(ValueError):
            bad()


# (B, H, W) for K5 / K6: a size that is no multiple of the 40x16 tile, the
# training batch, and the tile's edges (one pixel, a one-pixel row and
# column, one tile plus one, one 80x80 slice)
K56_SHAPES = [(2, 37, 53), (32, 80, 80), (1, 1, 1), (1, 1, 83), (1, 35, 1),
              (2, 17, 41), (1, 80, 80)]
# (supports, guidance scale, a 70-nat spike in image 0, level 1): the
# ladder, the identity supports, every window over 60 nats, eight levels
# at supports 1..8, and a batch where the spike's tiles take the guard
# and the others do not
K56_CASES = [((1, 2, 3, 4), 3.0, False), ((0, 1, 2, 3), 3.0, False),
             ((0, 1, 2, 3), 40.0, False), (tuple(range(1, 9)), 3.0, False),
             ((1, 2, 3, 4), 3.0, True)]
K56_IDS = ["ladder", "identity", "range > 60 nats", "L8 ladder", "spike"]


def _k56_inputs(shape, supports, gscale, spike, seed=11):
    B, H, W = shape
    w, g, x, G = _batch_inputs(seed, B, len(supports), H, W, gscale)
    if spike:
        g[0, 1, min(3, H - 1), min(4, W - 1)] = 70.0
    return w, g, x, G


def _expected_guards(vals, supports):
    """(tile, level) pairs of a K5 call (vals: the guidance) or a K6 call
    (vals: the saved stabilisers) whose region, the 40x16 tile and a halo
    of its level's support clipped to the image, spans GUARD_RANGE nats."""
    B, L, H, W = vals.shape
    tw, th = BATCH_TILE_W, BATCH_TILE_H
    n = 0
    for b in range(B):
        for l, s in enumerate(supports):
            for y0 in range(0, H, th) if s else ():
                for x0 in range(0, W, tw):
                    r = vals[b, l, max(y0 - s, 0):y0 + th + s,
                             max(x0 - s, 0):x0 + tw + s]
                    n += int(r.max() - r.min() >= GUARD_RANGE)
    return n


def _hold_k56(w, g, x, G, supports):
    """K5 and K6 against the plain versions (FILTER_TOL; GRAD_REL_TOL of
    the largest plain gradient) and their guard counts against the
    regions' ranges; returns (out, fm, den, dL/dw, dL/dg, K5's guard
    count, K6's)."""
    d5 = torch.zeros(1, dtype=torch.int32, device=x.device)
    d6 = torch.zeros_like(d5)
    out, saved = guided_filter_batch_fwd(w, g, x, supports, guards=d5)
    ref = guided_filter_batch_plain(w, g, x, supports)
    torch.testing.assert_close(out, ref, atol=FILTER_TOL, rtol=0)
    gw, gg = guided_filter_batch_bwd(G, w, g, x, saved, supports, guards=d6)
    rw, rg = guided_filter_backward_plain(G, w, g, x, supports)
    # a one-pixel image's guidance gradient is exactly 0: both versions
    # return the rounding of terms that cancel (a G.x - a G.f with f = x),
    # so it is held to the scale of those terms, the weight gradient's
    one_pixel = w.shape[2] * w.shape[3] == 1
    for got, want, scale in ((gw, rw, rw), (gg, rg, rw if one_pixel else rg)):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= \
            GRAD_REL_TOL * float(scale.abs().max())
    if supports[0] == 0:
        assert not gg[:, 0].any()
    assert int(d5) == _expected_guards(g.cpu().numpy(), supports)
    assert int(d6) == _expected_guards(saved[0][..., 3].cpu().numpy(),
                                       supports)
    return out, *saved, gw, gg, int(d5), int(d6)


def _written(held, supports):
    """_hold_k56's result with fm and den cut to the levels K5 writes
    (support > 0)."""
    lv = [i for i, s in enumerate(supports) if s > 0]
    return (held[0], held[1][:, lv], held[2][:, lv]) + held[3:]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K56_SHAPES,
                         ids=["x".join(map(str, s)) for s in K56_SHAPES])
@pytest.mark.parametrize("supports,gscale,spike", K56_CASES, ids=K56_IDS)
def test_k5_k6_match_plain(shape, supports, gscale, spike, cuda_device):
    """K5's output within FILTER_TOL of the plain batched filter; K6's
    weight and guidance gradients within GRAD_REL_TOL of the largest
    plain gradient, at sizes that are no multiple of the 40x16 tile and at
    its edges, at the training batch (32 slices of 80x80), on the
    reference ladder, the identity supports, windows whose guidance spans
    > 60 nats, eight levels and a spike; each kernel's guard taken in
    exactly the tiles whose staged values span 60 nats (the spike's
    tiles, not their neighbours)."""
    w, g, x, G = (torch.from_numpy(a).to(cuda_device) for a in
                  _k56_inputs(shape, supports, gscale, spike))
    n5, n6 = _hold_k56(w, g, x, G, supports)[5:]
    tiles = batch_tiles(shape[0], shape[1], shape[2], supports)
    if spike and shape[1] * shape[2] > 1:
        assert 0 < n5 < tiles and n6 < tiles
    if gscale > 10 and shape[1] * shape[2] > 1:
        assert n5 > 0


@pytest.mark.cuda
@pytest.mark.parametrize("supports", [(1, 2, 3, 4), (0, 1, 2, 3)],
                         ids=["ladder", "identity"])
def test_k5_k6_read_the_nets_strided_views(supports, cuda_device):
    """Weight and guidance as the net hands them over, the channel slices
    [:, :L] and [:, L:] of one [B, 2L, H, W] tensor (not contiguous): the
    same bits as from contiguous copies, and within the bars of the plain
    versions."""
    L = len(supports)
    w, g, x, G = (torch.from_numpy(a).to(cuda_device) for a in
                  _batch_inputs(14, 4, L, 80, 80))
    net = torch.cat([w, g], 1)
    wv, gv = net[:, :L], net[:, L:]
    assert not wv.is_contiguous() and not gv.is_contiguous()
    got = _written(_hold_k56(wv, gv, x, G, supports), supports)
    want = _written(_hold_k56(w, g, x, G, supports), supports)
    for a, b in zip(got[:5], want[:5]):
        assert torch.equal(a, b)
    net.requires_grad_()
    guided_filter_batch(net[:, :L], net[:, L:], x, supports).backward(G)
    assert torch.equal(net.grad[:, :L], want[3])
    assert torch.equal(net.grad[:, L:], want[4])


@pytest.mark.cuda
@pytest.mark.parametrize("supports,gscale,spike",
                         [K56_CASES[0], K56_CASES[4]], ids=["ladder", "spike"])
def test_k5_k6_are_deterministic(supports, gscale, spike, cuda_device):
    """Two calls give bit-equal outputs, saved state and gradients (the
    gather has no atomics; only the guard counter is added to)."""
    w, g, x, G = (torch.from_numpy(a).to(cuda_device) for a in
                  _k56_inputs((32, 80, 80), supports, gscale, spike))
    a = _written(_hold_k56(w, g, x, G, supports), supports)
    b = _written(_hold_k56(w, g, x, G, supports), supports)
    for t, u in zip(a[:5], b[:5]):
        assert torch.equal(t, u)
    assert a[5:] == b[5:]


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
    for bad in (lambda: guided_filter_batch_fwd(w, g, x, (0, 33)),
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
@pytest.mark.parametrize("skip_cap", [12, 0])
def test_render_classic_on_a_partial_lut_matches_plain(refined, skip_cap,
                                                       cuda_device):
    """render_classic on the refined shell's marked level-4 LUT (internal
    cells descend), with and without its skip distances."""
    transform, kw = _render_args(1, 37, 23)
    kw["opt"] = _classic_opt()
    tf = torch.from_numpy(transform).to(cuda_device)
    dt = tt.upload_tree(refined, lut_levels=4, device=cuda_device,
                        skip_cap=skip_cap, force_sparse_brick=True)
    _, st = _hold_classic(dt, tf, kw)
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
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(1,), (3,), (8, 128), (1025,), (3, 1000),
                                   ((1 << 20) + 3,)])
def test_g1_affine_matches_plain(shape, offset, cuda_device):
    """G1 bit for bit: a float4 a thread and the n % 4 tail where x is
    16-byte aligned, a float a thread from a view 4 B off; one CTA up to
    1024 elements, 2^20 + 3 on the grid-stride loop."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32)).to(cuda_device)
    x = _view_off(x, shape, offset)
    assert torch.equal(pr.probe_affine(x), pr.probe_affine_plain(x))


# G2 chain's table rows: a power of two and not; the last table that takes
# 4 columns a block, one past it (2 where the width is even), the last
# that takes 2, one past it (1), and the largest column shared memory holds
G2_ROWS = (64, 61, 768, 14528, 14529, 29056, 29057, 58112)


def _view_off(t, shape, offset):
    """A contiguous [shape] view of a copy of t that starts ``offset``
    elements into its storage (offset 1: 4 B off the 16-byte alignment)."""
    flat = torch.zeros(t.numel() + offset, dtype=t.dtype, device=t.device)
    flat[offset:] = t.reshape(-1)
    return flat[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("width,rounds", [
    (w, None) for w in (1, 3, 4, 6, 12, 128, 129)] + [
    (w, r) for r in (0, 1, 7, 33) for w in (4, 6, 12, 128)])
def test_g2_lane_gather_matches_plain(width, rounds, cuda_device):
    """P2 (a single f32 gather) and P3 (int32 chains), bit for bit.  The
    single gather for 1, 41, 1024 and 2049 rows, the last table row
    indexed, from tab and idx as allocated (4 columns a thread where the
    width is a multiple of 4), from a tab view 4 B off (the same path) and
    from an idx view 4 B off (a column a thread).  The chains at every
    table of G2_ROWS, of values 0..2 and of any int32 (sums that wrap and
    go negative), from the table as allocated and from a view 4 B into it
    (16-byte pieces, 4-byte ones), for 41 and 2049 rows (not a multiple of
    a CTA's share; 2049 leaves a CTA of its cluster with no rows).  A width
    of 4, 12 or 128 takes 4 columns a block, 6 takes 2."""
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    if rounds is None:
        for R in (1, 41, 1024, 2049):
            tab, idx = map(t, _lane_inputs(R, np.float32, T=301, R=R,
                                           W=width))
            idx[R // 2, width - 1] = 300
            ref = pr.lane_gather_plain(tab, idx)
            for tab_off, idx_off in ((0, 0), (1, 0), (0, 1)):
                got = pr.lane_gather(_view_off(tab, tab.shape, tab_off),
                                     _view_off(idx, idx.shape, idx_off))
                assert torch.equal(got, ref), (R, tab_off, idx_off,
                                               pr.gather_plan(width, R))
        return
    i32 = np.iinfo(np.int32)
    for T in G2_ROWS:
        wide = t(np.random.default_rng(T).integers(
            i32.min, i32.max, (T, width), dtype=np.int32, endpoint=True))
        for R in (41, 2049):
            small, idx = map(t, _lane_inputs(T, np.int32, T=T, R=R, W=width))
            idx[0] = T - 1
            # values 0..2, and any int32: sums that wrap and go negative
            for tab, off in ((small, 0), (small, 1), (wide, 0), (wide, 1)):
                ref = pr.lane_gather_chain_plain(tab, idx, rounds)
                got = pr.lane_gather_chain(_view_off(tab, tab.shape, off),
                                           idx, rounds)
                assert torch.equal(got, ref), (T, R, off,
                                               pr.chain_plan(T, width, R))


def _chunk_order_row_sum(idx, table):
    """G3's f32 row sum in its chunk order (a NumPy statement): each chunk
    of RING_CHUNK indices summed in the order of i from 0, then the chunks'
    sums in chunk order from 0."""
    total = np.zeros(table.shape[1], np.float32)
    for start in range(0, len(idx), pr.RING_CHUNK):
        part = np.zeros(table.shape[1], np.float32)
        for i in idx[start:start + pr.RING_CHUNK]:
            part = part + table[i]
        total = total + part
    return total


# G3's row counts: below one chunk, not a multiple of it, and several
# waves of CTAs over the card's 132 SMs
G3_COUNTS = (5, 70, 3 * 132 * 32 * 32 + 7)


@pytest.mark.cuda
@pytest.mark.parametrize("n", G3_COUNTS)
@pytest.mark.parametrize("width", [1, 2, 3, 4, 128])
def test_g3_row_ring_matches_plain(width, n, cuda_device):
    """Rows of 4, 8, 12, 16 and 512 B from an odd number of rows, the last
    one indexed, from the table as allocated and from a view 4 B into it
    (not aligned to 16 B: no bulk copy).  The int32 element-0 sum wraps
    like JAX's at every ring depth and for 0, 1 and 3 rounds; the f32 row
    sum equals a float32 loop in G3's chunk order."""
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    rows = 301
    for dtype in (np.int32, np.float32):
        idx, table = _ring_inputs(width, width, dtype, rows=rows, n=n)
        idx[n // 2] = rows - 1
        flat = t(np.concatenate([table.reshape(-1), table.reshape(-1)[:1]]))
        for tab in (flat[:rows * width].view(rows, width),
                    flat[1:].view(rows, width)):
            table = tab.cpu().numpy()
            if dtype == np.int32:
                for rounds in (0, 1, 3):
                    ref = pr.row_ring_rounds_plain(t(idx), tab, 2, rounds)
                    for nbuf in pr.RING_DEPTHS:
                        got = pr.row_ring_rounds(t(idx), tab, nbuf, rounds)
                        assert torch.equal(got, ref), (nbuf, rounds)
            else:
                got = pr.row_sum_ring(t(idx), tab)
                assert np.array_equal(got.cpu().numpy()[0],
                                      _chunk_order_row_sum(idx, table))


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper,bad", [("row_sum_ring", 301),
                                         ("row_ring_rounds", -1)])
def test_g3_index_outside_the_table_fails_the_launch(wrapper, bad,
                                                     cuda_device):
    """An index outside the table traps: the process's next synchronize
    raises.  In a process of its own, as a trap ends the CUDA context."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dtype = "float32" if wrapper == "row_sum_ring" else "int32"
    args = "" if wrapper == "row_sum_ring" else ", 8, 1"
    code = (
        "import torch\n"
        "from rt_octree_tpu_torch.ops import probes as pr\n"
        "idx = torch.arange(70, dtype=torch.int32, device='cuda')\n"
        f"idx[40] = {bad}\n"
        f"tab = torch.ones((301, 128), dtype=torch.{dtype}, device='cuda')\n"
        f"pr.{wrapper}(idx, tab{args})\n"
        "torch.cuda.synchronize()\n"
        "print('no fault')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no fault" not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1 << 10, 1 << 14, 1 << 16, 1 << 18,
                                  1 << 20])
def test_g4_flat_gather_chain_matches_plain(size, cuda_device):
    """Tables of 4 KB to 4 MiB, staged in each CTA's shared memory up to
    2^15 entries and read where they lie past it, for 500, 8193 and 131073
    chains (not a multiple of a CTA's; the last grows the local path's
    CTAs to 1024 threads), and from a view 4 B off (staged by 4-byte
    loads); 0, 1, 16 and 33 rounds."""
    for n in (500, 8193, 131073):
        idx, table = (torch.from_numpy(a).to(cuda_device)
                      for a in _flat_inputs(size, size, n=n))
        idx[0] = size - 1
        for rounds in (0, 1, 16, 33):
            ref = pr.flat_gather_chain_plain(idx, table, rounds)
            for tab in (table, _view_off(table, table.shape, 1)):
                got = pr.flat_gather_chain(idx, tab, rounds)
                assert torch.equal(got, ref), (n, rounds,
                                               pr.flat_plan(size, n))


# an index outside the table on each path of G2 and G4: the call after the
# imports of a fresh process
G2_G4_TRAPS = {
    "single, 4 columns a thread": "_single(128, 4096)",
    "single, a column a thread": "_single(6, -1)",
    "chain, 16-byte stores": "_chain(128, 8192)",
    "chain, 4-byte stores": "_chain(6, -1)",
    "flat local": "_flat(1 << 10, 1 << 10)",
    "flat global": "_flat(1 << 20, 1 << 20)"}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(G2_G4_TRAPS))
def test_g2_g4_index_outside_the_table_fails_the_launch(case, cuda_device):
    """An index outside the table traps on every path of G2 (the single
    gather and the chain) and G4: the process's next synchronize raises.
    In a process of its own, as a trap ends the CUDA context."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import torch\n"
        "from rt_octree_tpu_torch.ops import probes as pr\n"
        "def _chain(width, bad):\n"
        "    tab = torch.ones((8192, width), dtype=torch.int32, "
        "device='cuda')\n"
        "    idx = torch.zeros((2048, width), dtype=torch.int32, "
        "device='cuda')\n"
        "    idx[1000, width - 1] = bad\n"
        "    pr.lane_gather_chain(tab, idx, 4)\n"
        "def _single(width, bad):\n"
        "    tab = torch.ones((4096, width), dtype=torch.float32, "
        "device='cuda')\n"
        "    idx = torch.zeros((1024, width), dtype=torch.int32, "
        "device='cuda')\n"
        "    idx[1000, width - 1] = bad\n"
        "    pr.lane_gather(tab, idx)\n"
        "def _flat(size, bad):\n"
        "    idx = torch.zeros(8193, dtype=torch.int32, device='cuda')\n"
        "    idx[8000] = bad\n"
        "    tab = torch.ones(size, dtype=torch.int32, device='cuda')\n"
        "    pr.flat_gather_chain(idx, tab, 4)\n"
        f"{G2_G4_TRAPS[case]}\n"
        "torch.cuda.synchronize()\n"
        "print('no fault')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no fault" not in out.stdout


# ---------------------------------------------------------------------------
# the wide instances: K2, K5 / K6 past 8 levels or a support of 8 (or a B x L
# past 65,535), K1 and render_classic on SG / ASG rows past basis_dim 25
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("supports,hw,spike", [
    (tuple(range(1, 13)), (64, 48), None),
    (tuple(range(1, 13)), (37, 23), None),
    (tuple(range(16)), (45, 70), None), (tuple(range(1, 33)), (40, 50), None),
    ((0, 9), (5, 3), None), (tuple(range(1, 13)), (100, 90), (50, 40)),
    (tuple(range(1, 13)), (96, 80), None)],
    ids=["ladder 1..12", "ladder 1..12 37x23", "identity 0..15",
         "ladder 1..32", "(0, 9) 5x3", "ladder 1..12 80-nat spike",
         "ladder 1..12 no guard 80x96"])
def test_k2_wide_instance_matches_plain(supports, hw, spike, cuda_device):
    """K2's wide instance (guided_filter_wide) within FILTER_TOL of its
    plain version, one launch, on the activation as given and channels
    last (as K7 hands it over).  Its guard counter: no (tile, level) pair
    of the seeded inputs spans 60 nats, and an 80-nat spike in every
    guidance level sends at least one (and not all) to the per-window
    form."""
    L = len(supports)
    act, img = _filter_inputs(9, L=L, H=hw[0], W=hw[1])
    if spike is not None:
        act[0, L:, spike[0], spike[1]] = 80.0
    act = torch.from_numpy(act).to(cuda_device, torch.bfloat16)
    img = torch.from_numpy(img).to(cuda_device)
    ref = guided_filter_act_plain(act, img, supports)
    tiles = wide_filter_tiles(hw[0], hw[1], supports)
    for a in (act, act.contiguous(memory_format=torch.channels_last)):
        guards = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        native.reset_launches()
        got = guided_filter(a, img, supports, guards=guards)
        assert native.LAUNCHES["guided_filter_wide"] == 1
        assert native.LAUNCHES["guided_filter"] == 0
        torch.testing.assert_close(got, ref, atol=FILTER_TOL, rtol=0)
        if spike is None:
            assert int(guards) == 0
        else:
            assert 1 <= int(guards) < tiles


@pytest.mark.cuda
def test_k2_wide_statistics_instance(cuda_device):
    """K2 wide's statistics instance gives the frame instance's image bit
    for bit, with every phase's cycles counted on every tile."""
    supports = tuple(range(1, 13))
    act, img = _filter_inputs(9, L=12, H=70, W=90)
    act = torch.from_numpy(act).to(cuda_device, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    img = torch.from_numpy(img).to(cuda_device)
    got, st = guided_filter_wide_stats(act, img, supports)
    assert torch.equal(got, guided_filter(act, img, supports))
    assert st["tiles"] == 9
    assert all(c > 0 for c in st["cycles_per_tile"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,supports,gscale,spike", [
    ((2, 37, 53), tuple(range(1, 13)), 3.0, False),
    ((2, 37, 53), tuple(range(12)), 3.0, True),
    ((3, 80, 80), tuple(range(1, 13)), 40.0, False),
    ((1, 16, 40), (0, 9, 32), 3.0, False),
    ((16400, 1, 1), (1, 2, 3, 4), 3.0, False),
    ((66000, 1, 2), (0, 1), 3.0, False)],
    ids=["ladder 1..12", "identity 0..11 spike", "range > 60 nats",
         "supports 0, 9, 32", "B x L 65,600", "B 66,000"])
def test_k5_k6_wide_instances_match_plain(shape, supports, gscale, spike,
                                          cuda_device):
    """K5's and K6's wide instances (chosen on the host: more than 8
    levels, a support above 8, B or B x L past 65,535) against the plain
    versions, with their guard counts, one launch each; K5's outputs equal
    bit for bit on a second call."""
    w, g, x, G = (torch.from_numpy(a).to(cuda_device) for a in
                  _k56_inputs(shape, supports, gscale, spike))
    native.reset_launches()
    held = _hold_k56(w, g, x, G, supports)
    B, L = shape[0], len(supports)
    fwd = "guided_filter_batch" + ("_wide" if B > 65535 or L > 8 or
                                   max(supports) > 8 else "")
    assert native.LAUNCHES[fwd] == 1
    assert native.LAUNCHES["guided_filter_batch_bwd_wide"] == 1
    again = guided_filter_batch_fwd(w, g, x, supports)
    assert torch.equal(again[0], held[0])
    for a, b in zip(_written(held, supports)[1:3],
                    _written((again[0], *again[1]), supports)[1:3]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k6_wide_statistics_instance(cuda_device):
    """K6 wide's statistics instance gives the timed instance's gradients
    bit for bit, with the staging, range, e and both passes counted on
    every block."""
    supports = tuple(range(1, 13))
    w, g, x, G = (torch.from_numpy(a).to(cuda_device) for a in
                  _k56_inputs((2, 37, 53), supports, 3.0, False))
    _, saved = guided_filter_batch_fwd(w, g, x, supports)
    gw, gg, st = guided_filter_batch_bwd_wide_stats(G, w, g, x, saved,
                                                    supports)
    want = guided_filter_batch_bwd(G, w, g, x, saved, supports)
    assert torch.equal(gw, want[0]) and torch.equal(gg, want[1])
    assert st["blocks"] == 2 * 12 * 3 * 2
    assert all(st["cycles_per_block"][k] > 0 for k in (
        "staging", "range", "e", "row_pass", "column_pass"))
    assert st["cycles_per_block"]["guard"] == 0


def _wide_tree(fmt, bd, depth=5):
    return synthetic.with_lobes(synthetic.make_synthetic_tree(
        "shell", depth=depth, basis_dim=bd), BasisFormat[fmt], bd)


# K1 wide's rotations of the view dirs: none, a small one and one whose
# angle (2.2e5 rad) needs the host's cos / sin of the f32 angle
K1_WIDE_ROTATIONS = ((0.0, 0.0, 0.0), (0.3, -0.2, 0.5), (1e5, 2e5, 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("spp", tr.SPP_KERNEL)
@pytest.mark.parametrize("layout", ["SG32", "ASG48", "SG96", "SG232"])
def test_k1_wide_basis_matches_plain(layout, spp, cuda_device):
    """K1's wide instance (render_wide) on SG / ASG rows past basis_dim 25
    at every SPP, with a basis_minmax mask and with each of
    K1_WIDE_ROTATIONS: within IMG_TOL / AUX_TOL of its plain version; its
    ray mode (render_rays_wide) too, the view dirs rotated likewise.
    SG96 keeps its whole basis in shared memory, SG232 a prefix of 32
    (csrc/render.cu:kWideFullBasis)."""
    fmt = layout.rstrip("0123456789")
    dt = tt.upload_tree(_wide_tree(fmt, int(layout[len(fmt):])),
                        lut_levels=5, device=cuda_device)
    transform, kw = _render_args(spp, 37, 23)
    tf = torch.from_numpy(transform).to(cuda_device)
    cases = [((0, 100), K1_WIDE_ROTATIONS[0]), ((3, 20), K1_WIDE_ROTATIONS[0])]
    cases += [((0, 100), rot) for rot in K1_WIDE_ROTATIONS[1:]]
    for mask, rot in cases:
        kw["opt"] = RenderOptions(spp=spp, denoise=False, basis_minmax=mask,
                                  rot_dirs=rot)
        native.reset_launches()
        got = tr.render_noisy(dt, tf, 12345, 7, **kw)
        assert native.LAUNCHES["render_wide"] == 1
        ref = tr.render_noisy_plain(dt, tf, 12345, 7, **kw)
        for a, b, tol in zip(got, ref, (IMG_TOL, AUX_TOL, AUX_TOL)):
            torch.testing.assert_close(a, b, atol=tol, rtol=0)
        assert float(got[2][3].max()) > 0.5
    d, v, c, dst = _aimed_rays(dt, 1000, spp, spp, unit=False)
    for mask, rot in cases:
        opt = RenderOptions(spp=spp, basis_minmax=mask)
        vr = tr.rodrigues(rot, v).contiguous()
        native.reset_launches()
        got = tr.trace_rays(dt, d, vr, c, dst, opt)
        assert native.LAUNCHES["render_rays_wide"] == 1
        ref = tr.trace_rays_plain(dt, d, vr, c, dst, opt)
        torch.testing.assert_close(got, ref, atol=IMG_TOL, rtol=0)
    with pytest.raises(ValueError, match="statistics"):
        tr.render_stats(dt, tf, 1, 1, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["SG32", "ASG32", "SG48", "ASG48",
                                    "SG80", "SG88", "SG96", "ASG96",
                                    "SG192", "ASG232"])
def test_render_classic_wide_basis_matches_plain(layout, cuda_device):
    """render_classic's wide instances, frame and ray mode, within IMG_TOL /
    AUX_TOL of its plain version at full-depth and level-3 LUTs, with and
    without a basis_minmax mask: the shared-memory instance up to
    basis_dim 40, the chunked one past it, its whole basis in shared
    memory up to 216 and a tail past that prefix at 232."""
    fmt = layout.rstrip("0123456789")
    bd = int(layout[len(fmt):])
    tree = _wide_tree(fmt, bd)
    name = "_wide" if bd <= tr.CLASSIC_WIDE_MAX_BASIS else "_wide_chunked"
    transform, kw = _render_args(1, 37, 23)
    tf = torch.from_numpy(transform).to(cuda_device)
    for levels, mask in ((5, (0, 100)), (3, (0, 100)), (5, (3, 20))):
        kw["opt"] = _classic_opt(basis_minmax=mask)
        dt = tt.upload_tree(tree, lut_levels=levels, device=cuda_device)
        native.reset_launches()
        got = tr.render_noisy(dt, tf, 1, 1, **kw)
        assert native.LAUNCHES["render_classic" + name] == 1
        ref = tr.render_noisy_plain(dt, tf, 1, 1, **kw)
        for a, b, tol in zip(got, ref, (IMG_TOL, AUX_TOL, AUX_TOL)):
            torch.testing.assert_close(a, b, atol=tol, rtol=0)
        d, v, c, _ = _aimed_rays(dt, 1000, 1, 3, unit=False)
        got = tr.trace_rays_classic(dt, d, v, c, kw["opt"])
        assert native.LAUNCHES["render_classic_rays" + name] == 1
        ref = tr.trace_rays_classic_plain(dt, d, v, c, kw["opt"])
        torch.testing.assert_close(got, ref, atol=IMG_TOL, rtol=0)
