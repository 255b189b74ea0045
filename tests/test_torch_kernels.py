"""The port's CUDA kernels (K1 render, K2 guided filter, K3 LUT + skip
distances, G1-G4 the measurement tools' probes) against their plain
PyTorch versions, and the launch counters.

This file imports no JAX, so it also runs on a GPU host that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest`` because tests/conftest.py imports JAX.)  Tests that need
the card carry the ``cuda`` marker and skip without one.
"""

import numpy as np
import pytest
import torch

from rt_octree_tpu.core.camera import Camera
from rt_octree_tpu.core.options import RenderOptions
from rt_octree_tpu.io import synthetic
from rt_octree_tpu_torch.native import build as native
from rt_octree_tpu_torch.ops import probes as pr
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.ops.filtering import guided_filter, \
    guided_filter_plain
from rt_octree_tpu_torch.render import renderer as tr
from rt_octree_tpu_torch.utils.rng import pcg32_uniforms_range

torch.set_num_threads(1)

# Kernel vs plain on one card: the same libm (log1pf, expf) and IEEE
# division on both sides, so only summation order differs (the shade's
# count-weighted sum; the filter's softmax sums of up to 49 taps).
IMG_TOL, AUX_TOL, FILTER_TOL = 2e-5, 4e-5, 1e-5


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


def _render_args(spp, size=32):
    cam = Camera(width=size, height=size, fx=40.0, fy=40.0)
    kw = dict(width=size, height=size, fx=cam.fx, fy=cam.fy,
              opt=RenderOptions(spp=spp, denoise=False))
    return cam.transform, kw


def _filter_inputs(seed, L=4, H=64, W=48, gscale=3.0):
    rs = np.random.default_rng(seed)
    logits = rs.standard_normal((L, H, W)).astype(np.float32)
    weight = np.exp(logits) / np.exp(logits).sum(0, keepdims=True)
    guid = (rs.standard_normal((L, H, W)) * gscale).astype(np.float32)
    img = rs.random((H, W, 4), np.float32)
    return weight.astype(np.float32), guid, img


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
    transform, kw = _render_args(1, size=8)
    tr.render_noisy(dt, torch.from_numpy(transform).to(device), 1, 1, **kw)
    t = lambda a: torch.from_numpy(a).to(device)
    w, g, img = _filter_inputs(0, L=2, H=8, W=8)
    guided_filter(t(w), t(g), t(img), (0, 1))
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
    native.reset_launches()
    _launch_each_wrapper(shell, cuda_device)
    torch.cuda.synchronize()
    assert native.LAUNCHES == {k: 1 for k in native.LAUNCHES}


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 6, 32])
def test_k1_kernel_matches_plain(shell, spp, cuda_device):
    transform, kw = _render_args(spp)
    dt = tt.upload_tree(shell, lut_levels=5, device=cuda_device)
    tf = torch.from_numpy(transform).to(cuda_device)
    got = tr.render_noisy(dt, tf, 12345, 7, **kw)
    ref = tr.render_noisy_plain(dt, tf, 12345, 7, **kw)
    torch.testing.assert_close(got[0], ref[0], atol=IMG_TOL, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=AUX_TOL, rtol=0)
    torch.testing.assert_close(got[2], ref[2], atol=AUX_TOL, rtol=0)


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
@pytest.mark.parametrize("supports,gscale", [((1, 2, 3, 4), 3.0),
                                             ((0, 1, 2, 3), 3.0),
                                             ((0, 1, 2, 3), 60.0)])
def test_k2_kernel_matches_plain(supports, gscale, cuda_device):
    w, g, img = _filter_inputs(6, gscale=gscale)
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    got = guided_filter(t(w), t(g), t(img), supports)
    ref = guided_filter_plain(t(w), t(g), t(img), supports)
    torch.testing.assert_close(got, ref, atol=FILTER_TOL, rtol=0)


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
