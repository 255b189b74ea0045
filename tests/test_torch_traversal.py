"""Tree upload, the jump LUT + skip distances (kernel K3's plain version)
and the vectorized query, held against the JAX package: integer-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_octree_tpu.io import synthetic
from rt_octree_tpu.ops import traversal as jt
from rt_octree_tpu_torch.ops import traversal as tt

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shell():
    return synthetic.make_synthetic_tree("shell", depth=5, basis_dim=4)


@pytest.fixture(scope="module")
def chain():
    return synthetic.make_deep_chain_tree(8)


@pytest.mark.parametrize("levels", [1, 3, 5])
def test_lut_matches_jax_upload(shell, levels):
    """LUT (and, at full depth, the skip lanes) integer-equal to the JAX
    upload_tree(...).lut."""
    ref = jt.upload_tree(shell, lut_levels=levels, brick=False)
    got = tt.upload_tree(shell, lut_levels=levels, device="cpu")
    np.testing.assert_array_equal(got.lut.numpy(), np.asarray(ref.lut))
    assert (got.lut_levels, got.skip_cap, got.max_depth) == \
        (ref.lut_levels, ref.skip_cap, ref.max_depth)
    assert (got.basis_dim, got.fmt, got.data_dim) == \
        (ref.basis_dim, ref.fmt, ref.data_dim)


def test_deep_chain_partial_lut_matches_jax(chain):
    """lut_levels < max_depth: cells still internal carry the node pointer
    under the depth-31 sentinel, and no skip distances are baked."""
    ref = jt.upload_tree(chain, lut_levels=5, brick=False)
    got = tt.upload_tree(chain, lut_levels=5, device="cpu")
    np.testing.assert_array_equal(got.lut.numpy(), np.asarray(ref.lut))
    depth = (got.lut[:, 0] >> tt.LUT_PTR_BITS) & tt.LUT_DEPTH_SENTINEL
    assert (depth == tt.LUT_DEPTH_SENTINEL).any()
    assert got.skip_cap == 0


@pytest.mark.parametrize("cap", [1, 3, 12])
def test_skip_distances_match_numpy_twin(shell, cap):
    lut = tt.lut_build_plain(tt.upload_tree(shell, 0, device="cpu").chs,
                             2, 5)
    got = tt.add_skip_distances_plain(lut, 32, cap).numpy()
    ref = jt.add_skip_distances_np(lut.numpy(), 32, cap)
    np.testing.assert_array_equal(got, ref)
    empty = lut[:, 1].numpy() == 0
    assert got[empty, 1].min() >= 1 and got[empty, 1].max() <= cap


def _jax_query(dt_j, pos):
    out = jt.tree_query_full(dt_j, jnp.asarray(pos), with_bits=True)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("which,levels", [("shell", 0), ("shell", 3),
                                          ("shell", 5), ("chain", 5)])
def test_tree_query_matches_jax(shell, chain, which, levels):
    tree = shell if which == "shell" else chain
    rs = np.random.default_rng(3)
    pos = rs.random((4096, 3), np.float32) * 1.1 - 0.05  # includes clips
    if which == "chain":  # concentrate on the deep corner at the origin
        pos[::2] *= 0.01
    dt_j = jt.upload_tree(tree, lut_levels=levels, brick=False)
    dt_t = tt.upload_tree(tree, lut_levels=levels, device="cpu")
    ref = _jax_query(dt_j, pos)
    got = tt.tree_query_full(dt_t, torch.from_numpy(pos))
    for name, g, r in zip(("sub_ptr", "cube", "local", "sigma", "bits"),
                          got, ref):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


def test_deep_tree_warns_on_stderr(capsys):
    synthetic_chain = synthetic.make_deep_chain_tree(12)
    dt = tt.upload_tree(synthetic_chain, lut_levels=4, device="cpu")
    assert dt.lut_levels == 4
    assert "max_depth 12 > 11" in capsys.readouterr().err
