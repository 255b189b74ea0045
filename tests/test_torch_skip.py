"""Kernel K3's algorithm on the CPU.

The skip-distance kernels of csrc/lut.cu compute the capped Chebyshev
distance as three passes of a 1-D transform, one per axis.  A NumPy
statement of those passes, written here, is held integer-equal to the JAX
package's ``add_skip_distances_np`` (``cap`` rounds of the 3x3x3
min-window) and to the port's plain version.  The plain LUT build is held
to the JAX upload on an N = 3 tree, the path the kernel takes with
divisions instead of shifts.
"""

import numpy as np
import pytest
import torch

from rt_octree_tpu.io import synthetic as jsyn
from rt_octree_tpu.ops import traversal as jt
from rt_octree_tpu_torch.io.synthetic import random_lut
from rt_octree_tpu_torch.ops import traversal as tt

torch.set_num_threads(1)


def nearest_along_z(occ: np.ndarray, cap: int) -> np.ndarray:
    """Pass 1: distance along z to the nearest occupied cell of the row,
    capped at cap + 1, by one sweep each way."""
    res = occ.shape[2]
    z = np.arange(res)
    big = 4 * res + 4 * cap
    last = np.maximum.accumulate(np.where(occ, z, -big), axis=2)
    first = np.minimum.accumulate(np.where(occ, z, big)[..., ::-1],
                                  axis=2)[..., ::-1]
    return np.minimum(np.minimum(z - last, first - z), cap + 1)


def window_pass(g: np.ndarray, axis: int, cap: int) -> np.ndarray:
    """Passes 2 and 3: min over |j| <= cap of max(|j|, g(p + j e_axis)),
    taps outside the grid skipped."""
    res = g.shape[axis]
    out = g.copy()
    for j in range(1, min(cap, res - 1) + 1):
        lo, hi = [slice(None)] * 3, [slice(None)] * 3
        lo[axis], hi[axis] = slice(0, res - j), slice(j, res)
        lo, hi = tuple(lo), tuple(hi)
        out[lo] = np.minimum(out[lo], np.maximum(j, g[hi]))  # tap p + j
        out[hi] = np.minimum(out[hi], np.maximum(j, g[lo]))  # tap p - j
    return out


def separable_skip_np(lut: np.ndarray, res: int, cap: int) -> np.ndarray:
    """The three passes of csrc/lut.cu (z, then y, then x), then
    min(g, cap) into the sigma lane of the empty cells."""
    occ = (lut[:, 1] != 0).reshape(res, res, res)
    g = nearest_along_z(occ, cap)
    g = window_pass(g, 1, cap)
    g = window_pass(g, 0, cap)
    out = lut.copy()
    out[:, 1] = np.where(occ.reshape(-1), lut[:, 1],
                         np.minimum(g, cap).reshape(-1))
    return out


def lut_with(res: int, cells) -> np.ndarray:
    """A LUT whose occupied cells are exactly ``cells`` (x, y, z)."""
    lut = np.zeros((res ** 3, 2), np.int32)
    lut[:, 0] = np.arange(res ** 3)
    for x, y, z in cells:
        lut[(x * res + y) * res + z, 1] = 0x3f800000  # 1.0f
    return lut


def assert_three_agree(lut: np.ndarray, res: int, cap: int) -> None:
    got = separable_skip_np(lut, res, cap)
    np.testing.assert_array_equal(got, jt.add_skip_distances_np(lut, res, cap))
    np.testing.assert_array_equal(
        got, tt.add_skip_distances_plain(torch.from_numpy(lut), res,
                                         cap).numpy())


def test_separable_passes_equal_the_min_window():
    """Random grids of 1^3 to 40^3 cells at any occupancy and caps 1-20
    (hypothesis, a test-only dependency, draws them)."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=60, deadline=None)
    @hyp.given(res=st.integers(1, 40), occupancy=st.floats(0.0, 1.0),
               cap=st.integers(1, 20), seed=st.integers(0, 2 ** 31 - 1))
    def check(res, occupancy, cap, seed):
        # most random grids are dense or empty; square the share so that
        # sparse ones, where the distances are long, come up as often
        assert_three_agree(random_lut(res, occupancy ** 2, seed), res, cap)

    check()


C = 8  # centre of the 17^3 grid


@pytest.mark.parametrize("res,cap,cells", [
    (12, 5, []),
    (12, 5, "all"),
    (17, 12, [(0, 0, 0)]),
    (17, 12, [(16, 16, 16)]),
    (17, 12, [(0, C, C)]),
    (17, 12, [(C, 16, C)]),
    (17, 12, [(C, C, 0)]),
    (17, 12, [(C, C, C)]),
    (6, 9, [(1, 4, 2)]),
    (5, 20, []),
    (17, 4, [(2, 3, 4), (14, 12, 9)]),
    (17, 3, [(C, C, z) for z in range(17)]),
    (17, 3, [(x, C, z) for x in range(17) for z in range(17)]),
], ids=["empty", "full", "corner", "far-corner", "face-x", "face-y",
        "face-z", "centre", "cap-above-res", "empty-cap-above-res",
        "two-cells-apart", "line-along-z", "plane-across-y"])
def test_separable_passes_on_fixed_grids(res, cap, cells):
    if cells == "all":
        lut = random_lut(res, 1.0, 0)
    else:
        lut = lut_with(res, cells)
    assert_three_agree(lut, res, cap)


def test_cap_253_on_a_16_grid():
    """The largest cap the uint8 scratch takes: the halo of the y and x
    passes spans the whole grid."""
    assert_three_agree(random_lut(16, 2e-3, 5), 16, 253)


def test_first_pass_is_the_window_along_z():
    """The kernel's pass 1 scans for the nearest occupied cell; on the
    0 / cap+1 grid that is the same as the windowed pass along z."""
    lut = random_lut(23, 0.01, 9)
    occ = (lut[:, 1] != 0).reshape(23, 23, 23)
    for cap in (1, 4, 12, 30):
        g0 = np.where(occ, 0, cap + 1)
        np.testing.assert_array_equal(nearest_along_z(occ, cap),
                                      window_pass(g0, 2, cap))


@pytest.fixture(scope="module")
def tree3():
    """An N = 3 shell, depth 3: a 27^3 LUT at full depth."""
    return jsyn.build_tree(jsyn.shell_sigma, jsyn.position_color, depth=3,
                           N=3, basis_dim=1)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_lut_build_n3_matches_jax_upload(tree3, levels):
    ref = jt.upload_tree(tree3, lut_levels=levels, brick=False, skip_cap=0)
    chs = tt.upload_tree(tree3, 0, device="cpu").chs
    np.testing.assert_array_equal(
        tt.lut_build_plain(chs, 3, levels).numpy(), np.asarray(ref.lut))


def test_n3_upload_with_skip_matches_jax(tree3):
    """Full depth: the skip lanes too, and the separable statement on the
    same LUT."""
    ref = np.asarray(jt.upload_tree(tree3, lut_levels=3, brick=False).lut)
    got = tt.upload_tree(tree3, lut_levels=3, device="cpu")
    np.testing.assert_array_equal(got.lut.numpy(), ref)
    assert got.skip_cap == 12
    lut = tt.lut_build_plain(got.chs, 3, 3).numpy()
    np.testing.assert_array_equal(separable_skip_np(lut, 27, 12), ref)
