"""The guided filter's plain version (kernel K2's twin) vs the JAX filter,
and K2's prologue (the split of the net's activation) vs the Flax net."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_octree_tpu.models import guidance_net as jg
from rt_octree_tpu.ops.filtering import guided_filter as jax_filter
from rt_octree_tpu_torch.models import guidance_net as tg
from rt_octree_tpu_torch.ops.filtering import (guided_filter,
                                               guided_filter_act_plain,
                                               guided_filter_plain)

torch.set_num_threads(1)

# f32 softmax sums of up to 49 taps taken in another order: a few ulps of
# values in [0, 1]
TOL = 1e-5


def _inputs(seed, L=4, H=24, W=20, gscale=3.0):
    rs = np.random.default_rng(seed)
    logits = rs.standard_normal((L, H, W)).astype(np.float32)
    weight = np.exp(logits) / np.exp(logits).sum(0, keepdims=True)
    guid = (rs.standard_normal((L, H, W)) * gscale).astype(np.float32)
    img = rs.random((H, W, 4), np.float32)
    return weight.astype(np.float32), guid, img


@pytest.mark.parametrize("supports", [(1, 2, 3, 4), (0, 1, 2, 3), (0, 2)])
@pytest.mark.parametrize("exact", [True, False])
def test_plain_matches_jax(supports, exact):
    """Both JAX paths: exact (per-window max) and fast (global stabiliser
    with box sums, taken while the guidance range is < 60 nats)."""
    w, g, img = _inputs(len(supports), L=len(supports))
    got = guided_filter_plain(torch.from_numpy(w), torch.from_numpy(g),
                              torch.from_numpy(img), supports).numpy()
    ref = np.asarray(jax_filter(jnp.asarray(w), jnp.asarray(g),
                                jnp.asarray(img), exact=exact,
                                supports=supports))
    np.testing.assert_allclose(got, ref, atol=TOL)
    np.testing.assert_array_equal(got[..., 3], 1.0)


def test_wide_guidance_range_matches_jax_exact():
    """A guidance range far above 60 nats (the JAX fast path falls back
    to the exact path there); the per-window max keeps it exact."""
    w, g, img = _inputs(9, gscale=60.0)
    assert g.max() - g.min() > 120
    got = guided_filter_plain(torch.from_numpy(w), torch.from_numpy(g),
                              torch.from_numpy(img), (0, 1, 2, 3)).numpy()
    for exact in (True, False):
        ref = np.asarray(jax_filter(jnp.asarray(w), jnp.asarray(g),
                                    jnp.asarray(img), exact=exact,
                                    supports=(0, 1, 2, 3)))
        np.testing.assert_allclose(got, ref, atol=TOL)


def test_support_zero_is_bit_exact_passthrough():
    """Weight logits (0, -200, -200, -200): the softmax is exactly one-hot
    on the support-0 level in f32, so the output is the input."""
    _, g, img = _inputs(4)
    act = np.full((1, 8) + g.shape[1:], -200.0, np.float32)
    act[0, 0] = 0.0
    act[0, 4:] = g
    out = guided_filter(torch.from_numpy(act), torch.from_numpy(img),
                        (0, 1, 2, 3))
    np.testing.assert_array_equal(out[..., :3].numpy(), img[..., :3])


def test_default_supports_are_the_reference_ladder():
    w, g, img = _inputs(5, L=2)
    a = guided_filter_plain(torch.from_numpy(w), torch.from_numpy(g),
                            torch.from_numpy(img))
    b = guided_filter_plain(torch.from_numpy(w), torch.from_numpy(g),
                            torch.from_numpy(img), (1, 2))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        guided_filter_plain(torch.from_numpy(w), torch.from_numpy(g),
                            torch.from_numpy(img), (1, -1))


TRAINED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "quality", "trained.gnet")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_activation_prologue_matches_flax_then_jax_filter(dtype, tol):
    """K2's plain version takes the net's last activation (the bf16 one as
    the renderer hands it over) and equals the Flax net's (weight,
    guidance) through the JAX guided_filter at 64x64.  f32 nets: the convs'
    and the softmax sums' order only (1e-5); bf16 nets: a bf16 rounding
    may land elsewhere in the convs, the frame test's bar (1e-3)."""
    H = W = 64
    cfg, params = jg.load_compact(TRAINED)
    rs = np.random.default_rng(11)
    aux = rs.random((1, H, W, 8), np.float32)
    aux[..., 4:] = aux[..., :4] ** 2
    img = rs.random((H, W, 4), np.float32)
    wj, gj = jg.GuidanceNetCompact(cfg, dtype=getattr(jnp, dtype)).apply(
        {"params": params}, jnp.asarray(aux))
    ref = np.asarray(jax_filter(wj[0], gj[0], jnp.asarray(img), exact=True,
                                supports=cfg.supports()))
    net = tg.build_compact(*tg.load_compact(TRAINED), "cpu",
                           getattr(torch, dtype))
    with torch.no_grad():
        act = net.activation(torch.from_numpy(aux))
    assert act.dtype == getattr(torch, dtype) and act.shape == (1, 8, H, W)
    got = guided_filter_act_plain(act, torch.from_numpy(img),
                                  cfg.supports()).numpy()
    np.testing.assert_allclose(got, ref, atol=tol)
