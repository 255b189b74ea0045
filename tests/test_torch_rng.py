"""PCG32 in the port vs the JAX package: bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_octree_tpu.render.renderer import make_sorted_dst as jax_sorted_dst
from rt_octree_tpu.utils import rng as jrng
from rt_octree_tpu_torch.utils import rng as trng

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,seq", [(None, 1), (20230418, 1), (7, 12345)])
def test_host_pcg32_matches_jax(seed, seq):
    a = trng.Pcg32() if seed is None else trng.Pcg32(seed, seq)
    b = jrng.Pcg32() if seed is None else jrng.Pcg32(seed, seq)
    assert (a.state, a.inc) == (b.state, b.inc)
    assert [a.next_uint() for _ in range(20)] == \
        [b.next_uint() for _ in range(20)]
    assert [a.next_float() for _ in range(20)] == \
        [b.next_float() for _ in range(20)]
    for delta in (1, 1 << 32, 123456789, (1 << 64) - 1):
        a.advance(delta)
        b.advance(delta)
        assert a.state == b.state


def _jax_range(r, n):
    return np.asarray(jrng.pcg32_uniforms_range(
        jnp.uint32(r.state >> 32), jnp.uint32(r.state & 0xFFFFFFFF), n=n,
        inc=r.inc))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 6 * 24 * 24])
def test_uniforms_range_bit_exact_vs_jax(n):
    r = jrng.Pcg32(20230418)
    r.advance()  # frame 1: exercises the high state bits
    got = trng.pcg32_uniforms_range(r.state, n=n, inc=r.inc,
                                    device="cpu").numpy()
    ref = _jax_range(r, n)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_uniforms_range_is_the_host_stream():
    """Position p is the value next_float() returns after advance(p)."""
    r = trng.Pcg32(99, 3)
    got = trng.pcg32_uniforms_range(r.state, n=200, inc=r.inc,
                                    device="cpu").numpy()
    for p in (0, 1, 31, 32, 99, 199):
        h = r.copy()
        h.advance(p)
        assert got[p] == np.float32(h.next_float())


def test_mul64_matches_python_ints():
    """The 32-bit-half product (16-bit pieces in int64) is exact mod 2^64,
    including operands with every high bit set."""
    rs = np.random.default_rng(0)
    vals = [int(x) for x in rs.integers(0, 1 << 63, 64, dtype=np.uint64)]
    vals += [(1 << 64) - 1, (1 << 63) + 12345, 0xFFFFFFFF, 1 << 32]
    a = vals
    b = vals[::-1]
    M32 = (1 << 32) - 1
    t = lambda xs, sh: torch.tensor([(x >> sh) & M32 for x in xs],
                                    dtype=torch.int64)
    hi, lo = trng._mul64(t(a, 32), t(a, 0), t(b, 32), t(b, 0))
    for i, (x, y) in enumerate(zip(a, b)):
        prod = (x * y) & ((1 << 64) - 1)
        assert (int(hi[i]) << 32 | int(lo[i])) == prod


def test_sorted_dst_matches_jax():
    """Sorted -log1p(-u) thresholds; log1p may differ by an ulp between
    libms, so the bound is a few f32 ulps of values <= ~17."""
    rs = np.random.default_rng(1)
    u = rs.random((256, 6), np.float32)
    u[0, 0] = 0.0
    got = trng.make_sorted_dst(torch.from_numpy(u)).numpy()
    ref = np.asarray(jax_sorted_dst(jnp.asarray(u)))
    np.testing.assert_allclose(got, ref, rtol=4e-7, atol=0)
    assert (np.diff(got, axis=1) >= 0).all()
