"""The ray mode in any order of a caller's batch, and K1 wide's row pieces.

On the CPU: the ray mode on a permuted batch against the JAX package's
trace_rays and trace_rays_classic of the batch in its own order, permuted
(tests/test_torch_rays.py's configurations and bars); and a Python
statement of how ``ChunkedRow::channels`` (K1 wide's shade and
render_classic's chunked wide instance, csrc/render.cu) covers a row with
16-byte pieces.  On the card (marked ``cuda``): the ray modes' outputs the
same bit for bit in any order of the batch.  JAX is imported inside the
tests that compare with it, so that the card's machine, which has no JAX,
runs the ``cuda`` tests of this file."""

import os
import re

import numpy as np
import pytest
import torch

from rt_octree_tpu_torch.core.options import RenderOptions
from rt_octree_tpu_torch.io import synthetic as psynthetic
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.render import renderer as tr
from rt_octree_tpu_torch.utils.rng import make_sorted_dst

torch.set_num_threads(1)

RENDER_CU = os.path.join(os.path.dirname(tr.__file__), os.pardir, "csrc",
                         "render.cu")


def _source_const(name):
    """A constexpr int of csrc/render.cu: a number, or another's name."""
    src = open(RENDER_CU).read()
    value = re.search(rf"constexpr int {name} = (\w+);", src).group(1)
    return int(value) if value.isdigit() else _source_const(value)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _permuted_batch(seed, n=256, spp=2):
    d, v, c = psynthetic.aimed_rays(np.random.default_rng(seed), n)
    dst = make_sorted_dst(torch.from_numpy(np.random.default_rng(
        seed + 1).random((n, spp), dtype=np.float32))).numpy()
    perm = np.random.default_rng(seed + 2).permutation(n)
    return (d, v, c, dst), perm


@pytest.mark.parametrize("spp", [2, 6])
def test_permuted_batch_matches_jax_permuted(spp):
    """trace_rays on a permuted batch against the JAX package's trace_rays
    of the batch in its own order, permuted: within trace_rays' 2e-5."""
    import jax.numpy as jnp

    from .test_torch_rays import MAX_STEPS, TOL, _jax_trace, _jopt, _trees
    _, dt, dj = _trees("shell4", 4)
    (d, v, c, dst), perm = _permuted_batch(20 + spp, spp=spp)
    got = tr.trace_rays(dt, _t(d[perm]), _t(v[perm]), _t(c[perm]),
                        _t(dst[perm]), RenderOptions(spp=spp),
                        max_steps=MAX_STEPS).numpy()
    ref = np.asarray(_jax_trace(MAX_STEPS)(
        dj, jnp.asarray(d), jnp.asarray(v), jnp.asarray(c),
        jnp.asarray(dst), opt=_jopt(spp)))[perm]
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    assert (got[:, 3] > 0).mean() > 0.5


def test_permuted_classic_batch_matches_jax_permuted():
    """trace_rays_classic likewise, within its 1e-5."""
    import jax.numpy as jnp

    from .test_torch_rays import CLASSIC_TOL, _jax_classic, _jopt, _trees
    _, dt, dj = _trees("shell5", 5)
    (d, v, c, _), perm = _permuted_batch(30)
    got = tr.trace_rays_classic(dt, _t(d[perm]), _t(v[perm]), _t(c[perm]),
                                RenderOptions(), max_steps=7,
                                unroll=2).numpy()
    ref = np.asarray(_jax_classic(7, 2)(
        dj, jnp.asarray(d), jnp.asarray(v), jnp.asarray(c),
        opt=_jopt()))[perm]
    np.testing.assert_allclose(got, ref, atol=CLASSIC_TOL, rtol=0)
    assert (got[:, 3] > 0).mean() > 0.5


def piece_cover(skew, bd, prefix):
    """ChunkedRow::channels' reads of a row that starts ``skew`` halfs into
    its first 16-byte piece, with a prefix of ``prefix`` basis values, as
    (channel, half, basis index) in the order summed: each channel's prefix
    halfs [h0, h1) from its first piece (in part), the pieces between
    (whole) and its last (in part), piece_dot's halfs e in [lo, hi) against
    basis 8 k - h0 + e; then the tail past the prefix, one half at a
    time."""
    nb = min(bd, prefix)
    out = []
    for ch in range(3):
        h0 = skew + ch * bd
        h1 = h0 + nb
        k0, k1 = h0 >> 3, (h1 - 1) >> 3
        pieces = [(k0, h0 - 8 * k0, min(h1 - 8 * k0, 8))]
        pieces += [(k, 0, 8) for k in range(k0 + 1, k1)]
        if k1 > k0:
            pieces.append((k1, 0, h1 - 8 * k1))
        for k, lo, hi in pieces:
            out += [(ch, 8 * k + e, 8 * k - h0 + e) for e in range(lo, hi)]
    for ch in range(3):
        out += [(ch, skew + ch * bd + b, b) for b in range(nb, bd)]
    return out


def chunked_prefix(bd, full, cap):
    """csrc/render.cu:chunked_prefix: the whole basis up to ``full``
    values (and up to ``cap``), else ``cap`` values."""
    return bd if bd <= full or bd <= cap else cap


@pytest.mark.parametrize("shade", [("kWideFullBasis", "kWideCapPrefix"),
                                   ("kChunkedMaxPrefix", "kChunkedMaxPrefix")],
                         ids=["K1 wide", "chunked classic"])
@pytest.mark.parametrize("bd", [26, 32, 40, 41, 96, 216, 217, 232])
def test_wide_row_pieces_cover_each_channel_once_in_basis_order(bd, shade):
    """K1 wide's shade (ChunkedRow<kWideFullBasis, kWideCapPrefix>) and the
    chunked classic instance's (ChunkedRow<kChunkedMaxPrefix, ...>) read
    each channel's halfs once, in the order of b."""
    prefix = chunked_prefix(bd, *map(_source_const, shade))
    for skew in range(8):
        cover = piece_cover(skew, bd, prefix)
        for ch in range(3):
            got = [(h, b) for c, h, b in cover if c == ch]
            assert got == [(skew + ch * bd + b, b) for b in range(bd)]
        assert len(cover) == 3 * bd


# ---- on the card ----


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_ray_modes_are_bit_equal_in_any_order(cuda_device):
    """K1's and render_classic's ray modes on a batch and on a permutation
    of it: the permuted batch's outputs are the batch's, permuted, bit for
    bit."""
    shell = psynthetic.make_synthetic_tree("shell", depth=5, basis_dim=9)
    dt = tt.upload_tree(shell, lut_levels=5, device=cuda_device)
    d, v, c = (_t(a).to(cuda_device) for a in psynthetic.aimed_rays(
        np.random.default_rng(10), 20_000, unit=False))
    dst = make_sorted_dst(torch.from_numpy(np.random.default_rng(11).random(
        (20_000, 6), dtype=np.float32)).to(cuda_device))
    perm = torch.from_numpy(np.random.default_rng(12).permutation(
        20_000)).to(cuda_device)
    a = tr.trace_rays(dt, d, v, c, dst, RenderOptions(spp=6))
    b = tr.trace_rays(dt, *(t[perm].contiguous() for t in (d, v, c, dst)),
                      RenderOptions(spp=6))
    assert torch.equal(b, a[perm])
    a = tr.trace_rays_classic(dt, d, v, c, RenderOptions())
    b = tr.trace_rays_classic(dt, *(t[perm].contiguous() for t in (d, v, c)),
                              RenderOptions())
    assert torch.equal(b, a[perm])
