"""The batched, differentiable guided filter of the training step (kernels
K5 and K6 and their plain versions) against the JAX package's
guided_filter_batch and its autodiff (jax.vjp), on the exact and the fast
path, and the autograd Function against torch.autograd.gradcheck."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_octree_tpu.ops.filtering import guided_filter_batch as jax_batch
from rt_octree_tpu_torch.ops import filtering as tf

torch.set_num_threads(1)

B, L, H, W = 2, 3, 16, 20
LADDER, IDENTITY = (1, 2, 3), (0, 1, 2)
# f32 softmax sums of up to 49 taps in another order: the forward within
# 1e-5 (values in [0, 1]); the gradients within rtol 1e-4 plus atol 1e-5
FWD_TOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5


def _inputs(seed, gscale=3.0):
    rs = np.random.default_rng(seed)
    logits = rs.standard_normal((B, L, H, W)) * 2.0
    w = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    g = rs.standard_normal((B, L, H, W)) * gscale
    if gscale > 10:  # one window spans > 60 nats: JAX's exact fallback
        g[0, 1, 3, 4] = 70.0
        g[0, 1, 4, 4] = -5.0
    x = rs.random((B, H, W, 4))
    G = rs.standard_normal((B, H, W, 4))
    return tuple(a.astype(np.float32) for a in (w, g, x, G))


_VJPS = {}


def _jax_vjp(supports, exact):
    """A jitted (forward, vjp) of JAX's guided_filter_batch, one compile
    per support set and path, shared by the cases."""
    key = (supports, exact)
    if key not in _VJPS:
        def f(w, g, x, G):
            out, vjp = jax.vjp(lambda a, b: jax_batch(
                a, b, x, exact=exact, supports=supports), w, g)
            return (out,) + vjp(G)
        _VJPS[key] = jax.jit(f)
    return _VJPS[key]


CASES = [("ladder", LADDER, 3.0), ("identity", IDENTITY, 3.0),
         ("range > 60 nats", IDENTITY, 40.0)]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("label,supports,gscale", CASES,
                         ids=[c[0] for c in CASES])
def test_forward_and_backward_match_jax(label, supports, gscale, exact):
    """guided_filter_batch (the Function on CPU tensors: K5's plain
    version) against JAX's forward, and guided_filter_backward_plain
    (K6's) against jax.vjp of it; a window spanning > 60 nats takes JAX's
    exact fallback on the fast path."""
    w, g, x, G = _inputs(len(label), gscale)
    out_j, gw_j, gg_j = _jax_vjp(supports, exact)(w, g, x, G)
    t = torch.from_numpy
    out = tf.guided_filter_batch(t(w), t(g), t(x), supports)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=FWD_TOL)
    np.testing.assert_array_equal(out[..., 3].numpy(), 1.0)
    gw, gg = tf.guided_filter_backward_plain(t(G), t(w), t(g), t(x),
                                             supports)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(gg.numpy(), np.asarray(gg_j),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if 0 in supports:
        assert not gg[:, supports.index(0)].any()


@pytest.mark.parametrize("label,supports,gscale", CASES,
                         ids=[c[0] for c in CASES])
def test_backward_plain_matches_autograd(label, supports, gscale):
    """The closed form against torch autograd through the plain forward
    (the window max a constant there, as under JAX's stop_gradient)."""
    w, g, x, G = (torch.from_numpy(a) for a in _inputs(len(label), gscale))
    wr, gr = w.clone().requires_grad_(), g.clone().requires_grad_()
    out = tf.guided_filter_batch_plain(wr, gr, x, supports)
    out.backward(G)
    gw, gg = tf.guided_filter_backward_plain(G, w, g, x, supports)
    np.testing.assert_allclose(gw.numpy(), wr.grad.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(gg.numpy(), gr.grad.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_function_passes_gradcheck():
    """The autograd Function on CPU tensors (the plain versions) in f64 on
    an 8x8 case with a support-0 and a support-2 level: its gradients
    equal finite differences."""
    rs = np.random.default_rng(3)
    w = torch.from_numpy(rs.random((1, 2, 8, 8))).requires_grad_()
    g = torch.from_numpy(rs.standard_normal((1, 2, 8, 8)) * 2.0) \
        .requires_grad_()
    x = torch.from_numpy(rs.random((1, 8, 8, 4)))
    assert torch.autograd.gradcheck(
        lambda a, b: tf.guided_filter_batch(a, b, x, (0, 2)), (w, g))


def test_function_gives_no_image_gradient():
    """img is data: the Function returns gradients for weight and guidance
    only, and the CPU route launches no kernel."""
    from rt_octree_tpu_torch.native import build as native
    w, g, x, G = (torch.from_numpy(a) for a in _inputs(9))
    w.requires_grad_()
    g.requires_grad_()
    x.requires_grad_()
    native.reset_launches()
    tf.guided_filter_batch(w, g, x, LADDER).backward(G)
    assert x.grad is None and w.grad is not None and g.grad is not None
    assert native.LAUNCHES["guided_filter_batch"] == 0
    assert native.LAUNCHES["guided_filter_batch_bwd"] == 0


def test_kernel_wrappers_refuse_other_devices():
    """K5 / K6's wrappers take CUDA tensors only: a meta tensor is refused,
    never rerouted to the plain versions."""
    w = torch.zeros((1, 2, 4, 4), device="meta")
    x = torch.zeros((1, 4, 4, 4), device="meta")
    with pytest.raises(ValueError):
        tf.guided_filter_batch_fwd(w, w, x, (0, 1))
    with pytest.raises(ValueError):
        tf.guided_filter_batch_bwd(x, w, w, x, (w, w), (0, 1))
