"""The nets and trees past the card's unrolled instances (the wide
instances of K7, K2, K5 / K6, K1 and render_classic) through the port's
plain versions against the JAX package, which takes them all: compact
nets of 96 and 128 channels against Flax, the guided filter at 12 and 16
levels, the batched filter and its gradient at 12 levels, a training step
of the Runner at --mid_channels 96 --kernel_levels 12, SG and ASG frames
of basis_dim 32, the classic estimator's frames and rays at basis_dim 32
and 48; NumPy statements of K2 wide's and K5 wide's tile algorithms; and
the SH-lobe mesh tool against the JAX tool.

The JAX filter's exact path runs eagerly (``jax.disable_jit``): at 12
levels it unrolls ~3,000 window taps, which take XLA longer to compile
than to run once.  The batched filter and the step are held to its fast
path (jitted, without the guard's cond, which would compile the exact
path too) on inputs where the guard takes it, as the JAX training step
does.  Tolerances are those of each function's existing tests."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_octree_tpu.core.camera import Camera as JCamera
from rt_octree_tpu.core.options import RenderOptions as JOptions
from rt_octree_tpu.io import synthetic as jsyn
from rt_octree_tpu.io.n3tree import BasisFormat as JBasis
from rt_octree_tpu.io.n3tree import DataFormat as JFormat
from rt_octree_tpu.models import guidance_net as jg
from rt_octree_tpu.ops import traversal as jt
from rt_octree_tpu.ops.filtering import guided_filter as jax_filter
from rt_octree_tpu.ops.filtering import guided_filter_batch as jax_batch
from rt_octree_tpu.render import renderer as jr
from rt_octree_tpu.train.metrics import smape_loss as jsmape
from rt_octree_tpu_torch.core.options import RenderOptions
from rt_octree_tpu_torch.io import synthetic as tsyn
from rt_octree_tpu_torch.io.n3tree import BasisFormat
from rt_octree_tpu_torch.models import guidance_net as tg
from rt_octree_tpu_torch.ops import filtering as tf
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.render import renderer as tr
from rt_octree_tpu_torch.train.config import parse_args
from rt_octree_tpu_torch.train.runner import Runner

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the filters: f32 softmax sums taken in another order (values in [0, 1]);
# the gradients within rtol 1e-4 plus atol 1e-5 (test_torch_filtering.py,
# test_torch_train_filter.py)
FILTER_TOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
# frames: test_torch_render.py's bars
IMG_TOL, AUX_TOL = 2e-5, 4e-5
# the step: gradient entries that cancel to near zero, in f32, against
# their leaf's largest.  test_torch_train_model.py holds an 8-channel,
# 3-level net at 1e-6, which the biases meet here (at most 9.1e-7 on the
# CPU, both packages in f32); the kernels of this 96-channel, 12-level net
# sum ~10x more terms an entry and measured 1.2e-6 (block 0's conv1),
# 2.2e-6 (block 0's conv3), 5.1e-6 (block 1's conv1) and 4.9e-6 (block
# 1's conv3), so they are held at 1e-5
STEP_CANCEL_ATOL = {"bias": 1e-6, "kernel": 1e-5}

WIDE_NETS = {"8-96-24": dict(mid_channels=96, kernel_levels=12),
             "8-128-128-8": dict(mid_channels=128, num_layers=3,
                                 kernel_levels=4)}


def _net_params(cfg, seed=5):
    """Folded params at std 1.5 / sqrt(9 cin), so that a wide block's sums
    stay inside relu6's range."""
    rs = np.random.default_rng(seed)
    return {f"block_{i}": {
        "kernel": (rs.standard_normal((3, 3, cin, cout))
                   * (1.5 / np.sqrt(9 * cin))).astype(np.float32),
        "bias": (rs.standard_normal(cout) * 0.1).astype(np.float32)}
        for i, (cin, cout) in enumerate(cfg.layer_channels())}


def _aux(B, H, W, seed=0):
    aux = np.random.default_rng(seed).random((B, H, W, 8), np.float32)
    aux[..., 4:] = aux[..., :4] ** 2
    return aux


@pytest.mark.parametrize("name", list(WIDE_NETS))
def test_wide_compact_net_matches_flax(name):
    """The compact net past 64 channels (K7's wide plan on the card) in
    bf16 against Flax's GuidanceNetCompact: one bf16 ulp of the largest
    value, as test_torch_guidance_net.py holds the committed nets."""
    kw = WIDE_NETS[name]
    cfg_j, cfg_t = jg.GuidanceNetConfig(**kw), tg.GuidanceNetConfig(**kw)
    params = _net_params(cfg_t)
    aux = _aux(1, 20, 24)
    wj, gj = jg.GuidanceNetCompact(cfg_j, dtype=jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(aux))
    net = tg.build_compact(cfg_t, params, "cpu")
    with torch.no_grad():
        wt, gt = net(torch.from_numpy(aux))
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                               atol=2.0 ** (np.floor(np.log2(
                                   np.abs(gj).max())) - 7))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1.0 / 128)


def _filter_inputs(seed, L, H, W, B=None):
    rs = np.random.default_rng(seed)
    shape = (L, H, W) if B is None else (B, L, H, W)
    logits = rs.standard_normal(shape) * 2.0
    w = np.exp(logits) / np.exp(logits).sum(-3, keepdims=True)
    g = rs.standard_normal(shape) * 3.0
    x = rs.random(((H, W, 4) if B is None else (B, H, W, 4)))
    G = rs.standard_normal(x.shape)
    return tuple(a.astype(np.float32) for a in (w, g, x, G))


@pytest.mark.parametrize("supports", [tuple(range(1, 13)),
                                      tuple(range(16))],
                         ids=["ladder 1..12", "identity 0..15"])
def test_guided_filter_at_many_levels_matches_jax(supports):
    """K2's plain version at 12 and 16 levels (K2's wide instance on the
    card) against the JAX filter's exact path."""
    w, g, x, _ = _filter_inputs(len(supports), len(supports), 30, 28)
    got = tf.guided_filter_plain(torch.from_numpy(w), torch.from_numpy(g),
                                 torch.from_numpy(x), supports).numpy()
    with jax.disable_jit():
        ref = np.asarray(jax_filter(jnp.asarray(w), jnp.asarray(g),
                                    jnp.asarray(x), exact=True,
                                    supports=supports))
    np.testing.assert_allclose(got, ref, atol=FILTER_TOL)
    np.testing.assert_array_equal(got[..., 3], 1.0)


_FAST = {}


def _jax_fast_vjp(supports):
    """A jitted (out, dL/dw, dL/dg) = vjp of the JAX package's batched
    filter on its fast path (ops/filtering.py:_filter_all_fast under
    vmap: what guided_filter_batch computes while its guard holds), one
    compile per support set, shared by the tests."""
    if supports not in _FAST:
        from rt_octree_tpu.ops.filtering import _filter_all_fast

        def f(w, g, x, G):
            def fwd(a, b):
                out = jax.vmap(lambda wi, gi, xi: _filter_all_fast(
                    wi, gi, xi[..., :3], supports))(a, b, x)
                return jnp.concatenate(
                    [out, jnp.ones(out.shape[:-1] + (1,), out.dtype)], -1)
            out, vjp = jax.vjp(fwd, w, g)
            return (out,) + vjp(G)
        _FAST[supports] = jax.jit(f)
    return _FAST[supports]


def _guard_holds(g):
    """JAX's guard takes the fast path: every level spans < 60 nats."""
    return float((g.max(axis=(-2, -1)) - g.min(axis=(-2, -1))).max()) < 60


LADDER12 = tuple(range(1, 13))
B, H, W = 2, 16, 16


def test_guided_filter_batch_at_twelve_levels_matches_jax():
    """The batched filter (K5's plain version) and its closed-form
    backward (K6's) at the ladder 1..12 on a batch of two, against JAX's
    guided_filter_batch (its fast path, which its guard takes here) and
    jax.vjp of it."""
    w, g, x, G = _filter_inputs(12, 12, H, W, B=B)
    assert _guard_holds(g)
    out_j, gw_j, gg_j = _jax_fast_vjp(LADDER12)(w, g, x, G)
    t = torch.from_numpy
    out = tf.guided_filter_batch(t(w), t(g), t(x), LADDER12)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j),
                               atol=FILTER_TOL)
    gw, gg = tf.guided_filter_backward_plain(t(G), t(w), t(g), t(x),
                                             LADDER12)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(gg.numpy(), np.asarray(gg_j), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("name", list(WIDE_NETS))
def test_runner_step_of_a_wide_net_matches_jax(name):
    """One Runner.train_step of ``rtoctree train --config
    configs/blender.txt`` with the wide net's flags (``--mid_channels 96
    --kernel_levels 12``: the ladder 1..12; ``--mid_channels 128
    --num_layers 3``: three 128-wide blocks, the ladder 1..4) on the CPU
    (its net in f32, the plain filters) against the JAX package's f32 step
    on the same params and batch (runner.py:_build_train_step's loss: the
    net, guided_filter_batch at the net's supports, SMAPE), its gradient
    taken by the chain rule through jax.vjp of each part (the net, the
    filter's fast path, which its guard takes here, and SMAPE).  The loss
    within 1e-6 relative and the gradients within rtol 1e-4
    (test_torch_train_model.py's bars); entries that cancel to near zero
    within STEP_CANCEL_ATOL of their leaf's largest, by the leaf's kind."""
    kw = WIDE_NETS[name]
    flags = [a for k, v in kw.items() for a in (f"--{k}", str(v))]
    args = parse_args(["--config", os.path.join(REPO, "configs",
                                                "blender.txt"),
                       *flags, "--device", "cpu"])
    runner = Runner(args)
    supports = tuple(range(1, kw["kernel_levels"] + 1))
    assert runner.supports == supports
    params = runner.params()  # Flax's init, drawn from a seeded generator
    runner.model = tg.GuidanceNet(runner.net_cfg, dtype=torch.float32)
    runner.set_params(params)
    rs = np.random.default_rng(2)
    aux = _aux(B, H, W, seed=3)
    img_in = rs.random((B, H, W, 4), np.float32)
    img_gt = rs.random((B, H, W, 3), np.float32)
    runner.optimizer = runner.make_optimizer()
    loss = runner.train_step(torch.from_numpy(aux).permute(0, 3, 1, 2),
                             torch.from_numpy(img_in),
                             torch.from_numpy(img_gt))
    grads_t = tg.params_to_numpy(runner.net_cfg, {
        n: p.grad for n, p in runner.model.named_parameters()})
    cfg_j = jg.GuidanceNetConfig(in_channels=8, num_branches=5,
                                 **{"num_layers": 2, **kw})
    model_j = jax.jit(jg.GuidanceNet(cfg_j, dtype=jnp.float32).apply)
    (w, g), net_vjp = jax.vjp(
        lambda p: model_j({"params": p}, jnp.asarray(aux)), params)
    assert _guard_holds(np.asarray(g))
    filt = _jax_fast_vjp(supports)
    out = filt(w, g, img_in, jnp.zeros((B, H, W, 4), jnp.float32))[0]
    loss_j, G = jax.value_and_grad(
        lambda o: jsmape(o[..., :3], jnp.asarray(img_gt)))(out)
    _, dw, dg = filt(w, g, img_in, G)
    grads_j = net_vjp((dw, dg))[0]
    assert abs(loss.item() - float(loss_j)) <= 1e-6 * abs(float(loss_j))
    leaves = jax.tree_util.tree_leaves_with_path(grads_j)
    assert len(leaves) == len(jax.tree.leaves(grads_t)) == \
        20 * cfg_j.num_layers
    for got, (path, ref) in zip(jax.tree.leaves(grads_t), leaves):
        ref, kind = np.asarray(ref), path[-1].key
        np.testing.assert_allclose(
            got, ref, rtol=1e-4,
            atol=STEP_CANCEL_ATOL[kind] * np.abs(ref).max(),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("fmt", ["SG", "ASG"])
def test_wide_basis_frame_matches_jax(fmt):
    """A 32x32 frame (SPP 6) of a depth-5 shell with SG / ASG rows of
    basis_dim 32 (K1's wide instance on the card): the port's tree from
    synthetic.with_lobes, the same arrays in the JAX package's tree."""
    tree = tsyn.with_lobes(tsyn.make_synthetic_tree("shell", depth=5,
                                                    basis_dim=32),
                           BasisFormat[fmt], 32)
    jtree = jsyn.make_synthetic_tree("shell", depth=5, basis_dim=32)
    jtree.data = tree.data.copy()
    jtree.extra = tree.extra.copy()
    jtree.data_format = JFormat(JBasis[fmt], 32)
    cam = JCamera(width=32, height=32, fx=53.0, fy=53.0)
    r = jr.Renderer(jt.upload_tree(jtree, lut_levels=5), 32, 32, cam.fx,
                    cam.fy, options=JOptions(spp=6, denoise=False),
                    schedule=((0, 1),))
    img_j, aux_j = (np.asarray(a) for a in r.render(cam.transform))
    dt = tt.upload_tree(tree, lut_levels=5, device="cpu")
    assert tr.is_wide(dt) and tr.classic_layout(
        dt.fmt, dt.basis_dim, dt.data_dim) == "wide"
    rp = tr.Renderer(dt, 32, 32, cam.fx, cam.fy,
                     options=RenderOptions(spp=6, denoise=False))
    img, aux = (a.numpy() for a in rp.render(cam.transform))
    np.testing.assert_allclose(img, img_j, atol=IMG_TOL)
    np.testing.assert_allclose(aux, aux_j, atol=AUX_TOL)
    assert aux[3].max() > 0.5


def _wide_trees(fmt, bd, depth=5):
    """(port tree, JAX tree): a shell of ``depth`` with with_lobes' SG /
    ASG rows of basis_dim ``bd``, the same arrays in the JAX package's
    tree."""
    tree = tsyn.with_lobes(tsyn.make_synthetic_tree("shell", depth=depth,
                                                    basis_dim=bd),
                           BasisFormat[fmt], bd)
    jtree = jsyn.make_synthetic_tree("shell", depth=depth, basis_dim=bd)
    jtree.data = tree.data.copy()
    jtree.extra = tree.extra.copy()
    jtree.data_format = JFormat(JBasis[fmt], bd)
    return tree, jtree


# the classic estimator: tests/test_torch_classic.py's bar
CLASSIC_TOL = 1e-5


@pytest.mark.parametrize("fmt,bd", [("SG", 32), ("ASG", 32), ("SG", 48),
                                    ("SG", 96), ("ASG", 96)],
                         ids=["SG32", "ASG32", "SG48", "SG96", "ASG96"])
def test_wide_classic_estimator_matches_jax(fmt, bd):
    """The classic estimator on SG / ASG rows past basis_dim 25
    (render_classic's wide instances on the card, the chunked one past
    CLASSIC_WIDE_MAX_BASIS): a 32x32 classic frame of a depth-5 shell
    through the port's Renderer against the JAX Renderer, and 256 aimed
    rays through trace_rays_classic against the JAX package's
    (renderer.py:1060), both at the classic bar."""
    tree, jtree = _wide_trees(fmt, bd)
    cam = JCamera(width=32, height=32, fx=53.0, fy=53.0)
    jopt = JOptions(spp=1, denoise=False, estimator="classic")
    r = jr.Renderer(jt.upload_tree(jtree, lut_levels=5), 32, 32, cam.fx,
                    cam.fy, options=jopt)
    img_j, aux_j = (np.asarray(a) for a in r.render(cam.transform))
    dt = tt.upload_tree(tree, lut_levels=5, device="cpu")
    assert tr.classic_layout(dt.fmt, dt.basis_dim, dt.data_dim) == (
        "wide" if bd <= tr.CLASSIC_WIDE_MAX_BASIS else "wide_chunked")
    opt = RenderOptions(spp=1, denoise=False, estimator="classic")
    rp = tr.Renderer(dt, 32, 32, cam.fx, cam.fy, options=opt)
    img, aux = (a.numpy() for a in rp.render(cam.transform))
    np.testing.assert_allclose(img, img_j, atol=CLASSIC_TOL, rtol=0)
    np.testing.assert_allclose(aux, aux_j, atol=CLASSIC_TOL, rtol=0)
    assert aux[3].max() > 0.5
    d, v, c = tsyn.aimed_rays(np.random.default_rng(bd), 256)
    t = torch.from_numpy
    got = tr.trace_rays_classic(dt, t(d), t(v), t(c), opt).numpy()
    ref = np.asarray(jr.trace_rays_classic(
        jt.upload_tree(jtree, lut_levels=5), jnp.asarray(d), jnp.asarray(v),
        jnp.asarray(c), jr.FrozenOptions.from_options(jopt)))
    np.testing.assert_allclose(got, ref, atol=CLASSIC_TOL, rtol=0)
    assert (got[:, 3] > 0).mean() > 0.5


@pytest.mark.parametrize("max_degree", [0, 1, 2, 3, 4])
def test_gen_sh_mesh_writes_the_jax_tools_files(max_degree, tmp_path):
    """rt_octree_tpu_torch/tools/gen_sh_mesh.py against tools/gen_sh_mesh.py
    (run as scripts, with the same arguments): the same OBJ files, byte
    for byte."""
    env = dict(os.environ, PYTHONPATH=REPO)
    runs = {"jax": [sys.executable, os.path.join(REPO, "tools",
                                                 "gen_sh_mesh.py")],
            "port": [sys.executable, "-m",
                     "rt_octree_tpu_torch.tools.gen_sh_mesh"]}
    for side, cmd in runs.items():
        out = subprocess.run(cmd + [str(max_degree), str(tmp_path / side)],
                             cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == [f"sh_{i:02d}.obj" for i in range((max_degree + 1) ** 2)]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_wide_instances_are_chosen_on_the_host():
    """Which instance each wrapper takes, decided in Python before any
    launch: the unrolled instances for the committed shapes, the wide
    ones past them, a ValueError past those; CPU tensors at wide shapes
    take the plain versions and launch nothing."""
    from rt_octree_tpu_torch.native import build as native
    from rt_octree_tpu_torch.ops import guidance as og
    assert not tf.wide_plan(32, 4, (1, 2, 3, 4))
    assert not tf.wide_plan(65535, 8, tuple(range(8)))
    assert tf.wide_plan(32, 12, LADDER12)
    assert tf.wide_plan(1, 2, (0, 9))
    assert tf.wide_plan(65536, 1, (1,))
    with pytest.raises(ValueError):
        tf._check_levels("k", 2, (0, 33))
    with pytest.raises(ValueError):
        tf._check_levels("k", 65, (1,) * 65)
    with pytest.raises(ValueError, match="CUDA"):  # the card's instance
        tf.guided_filter_wide_stats(torch.zeros(1, 24, 4, 4),
                                    torch.zeros(4, 4, 4), LADDER12)
    with pytest.raises(ValueError, match="CUDA"):
        tf.guided_filter_batch_wide_stats(
            torch.zeros(1, 12, 4, 4), torch.zeros(1, 12, 4, 4),
            torch.zeros(1, 4, 4, 4), LADDER12)
    for kw, wide in ((WIDE_NETS["8-96-24"], [True, True]),
                     (WIDE_NETS["8-128-128-8"], [True] * 3),
                     ({}, [False, False])):
        cfg = tg.GuidanceNetConfig(**kw)
        net = tg.build_compact(cfg, _net_params(cfg), "cpu")
        net.pack()
        assert [og.is_wide(p) for p in net.packed] == wide
    native.reset_launches()
    w, g, x, G = (torch.from_numpy(a) for a in _filter_inputs(1, 12, 8, 8,
                                                              B=1))
    tf.guided_filter_batch(w, g, x, LADDER12)
    assert not any(native.LAUNCHES.values())


# K7's choice of wide instance (ops/guidance.net_plan): the net's
# GuidanceNetConfig keywords -> the plan and the fused wide instance's
# shared-memory bytes (None: not a two-block wide net from 8 channels).
# The bytes: 128 (barrier) + 26,112 (the f32 staging of 68 x 12 pixels x 8
# channels) + 10,768 a plane of 8 intermediate channels (672 pixels x 16
# bytes + 16), block 0's n-tiles in groups of 4, + 4,608 a group of block
# 0's B fragments (9 taps x 4 n-tiles x 128 bytes: 8 channels) + 256 a
# fragment of block 1's (k-steps x 9 taps x its n-tiles in groups of 2, 3
# or 4).
K7_PLANS = {
    # the wide path's net: 3 groups, 3 n-tiles a group of 6 k-steps
    "8-96-24": (dict(mid_channels=96, kernel_levels=12), "fused_wide",
                128 + 26112 + 12 * 10768 + 3 * 4608 + 6 * 9 * 3 * 256),
    # 65 channels pad to 80 (10 n-tiles in 3 groups); 8 outputs a group of 2
    "8-65-8": (dict(mid_channels=65), "fused_wide",
               128 + 26112 + 12 * 10768 + 3 * 4608 + 5 * 9 * 2 * 256),
    # a narrow block 0 before a wide block 1: 1 group; 12 n-tiles in 3
    "8-32-96": (dict(mid_channels=32, kernel_levels=48), "fused_wide",
                128 + 26112 + 4 * 10768 + 4608 + 3 * 2 * 9 * 4 * 256),
    # 16 levels: 4 n-tiles of block 1, 7,872 bytes to spare
    "8-96-32": (dict(mid_channels=96, kernel_levels=16), "fused_wide",
                128 + 26112 + 12 * 10768 + 3 * 4608 + 6 * 9 * 4 * 256),
    # 20 levels: two groups of block 1 pass 227 KB
    "8-96-40": (dict(mid_channels=96, kernel_levels=20), "chain",
                128 + 26112 + 12 * 10768 + 3 * 4608 + 2 * 6 * 9 * 4 * 256),
    "8-128-8": (dict(mid_channels=128), "chain",
                128 + 26112 + 16 * 10768 + 4 * 4608 + 8 * 9 * 2 * 256),
    "8-256-64": (dict(mid_channels=256, kernel_levels=32), "chain",
                 128 + 26112 + 32 * 10768 + 8 * 4608 + 2 * 16 * 9 * 4 * 256),
    "8-128-128-8": (WIDE_NETS["8-128-128-8"], "chain", None),
    "16-96-24": (dict(in_channels=16, mid_channels=96, kernel_levels=12),
                 "chain", None),
    "8-32-8": ({}, "fused", None),
}


@pytest.mark.parametrize("name", list(K7_PLANS))
def test_host_chooses_k7s_fused_wide_instance(name):
    """K7's plan, chosen on the host from the packed blocks: the fused
    wide instance for a two-block wide net from 8 channels whose weights
    and intermediate fit 227 KB (one launch), the chain otherwise (one
    launch a block), the fused instances for the committed nets; and the
    shared-memory bytes of the fused wide instance (K7_PLANS)."""
    from rt_octree_tpu_torch.ops import guidance as og
    kw, plan, smem = K7_PLANS[name]
    cfg = tg.GuidanceNetConfig(**kw)
    net = tg.build_compact(cfg, _net_params(cfg), "cpu")
    net.pack()
    assert og.fused_wide_smem(net.packed) == smem
    assert og.net_plan(net.packed) == plan
    assert (smem is not None and smem <= og.SMEM_MAX) == (plan ==
                                                           "fused_wide")


def _k2_wide_statement(act, img, supports):
    """K2 wide's algorithm in NumPy: K2's prologue (the softmax over the
    first L channels of the bf16 activation [1, 2L, H, W]) and K5's tile
    algorithm (test_torch_train_filter.k5_statement) at K2 wide's square
    tile -> (out [H, W, 4], the guarded (level, y0, x0))."""
    from tests.test_torch_train_filter import k5_statement
    L = act.shape[1] // 2
    lg = act[0, :L]
    e = np.exp(lg - lg.max(0))
    out, _, _, guards = k5_statement((e / e.sum(0))[None], act[0, L:][None],
                                     img[None], supports,
                                     tf.wide_tile(supports))
    return out[0], {(l, y0, x0) for _, l, y0, x0 in guards}


@pytest.mark.parametrize("spike", [False, True],
                         ids=["seeded", "80-nat spike"])
def test_k2_wide_tile_statement_matches_plain_and_jax(spike):
    """K2 wide's tile algorithm (a stabiliser a 32x32 tile and level,
    separable shifted adds, the per-tile 60-nat guard) at the ladder
    1..12 against K2's plain version and, on the seeded activation, the
    JAX filter's fast path (what JAX's frame takes); the guard exactly in
    the (level, tile) pairs whose region holds an 80-nat spike, and in
    none on the seeded one, as the counter reads on the card."""
    L, H, W, yx = 12, 70, 75, (40, 50)
    rs = np.random.default_rng(17)
    act = np.concatenate([rs.standard_normal((L, H, W)) * 2.0,
                          rs.standard_normal((L, H, W)) * 3.0])[None]
    if spike:
        act[0, L:, yx[0], yx[1]] = 80.0
    act = torch.from_numpy(act.astype(np.float32)).to(torch.bfloat16)
    img = rs.random((H, W, 4)).astype(np.float32)
    out, guards = _k2_wide_statement(act.float().numpy(), img, LADDER12)
    ref = tf.guided_filter_act_plain(act, torch.from_numpy(img), LADDER12)
    np.testing.assert_allclose(out, ref.numpy(), atol=FILTER_TOL, rtol=0)
    tw, th = tf.wide_tile(LADDER12)
    want = {(l, y0, x0) for l, s in enumerate(LADDER12)
            for y0 in range(0, H, th) for x0 in range(0, W, tw)
            if spike and y0 - s <= yx[0] < y0 + th + s
            and x0 - s <= yx[1] < x0 + tw + s}
    assert guards == want
    assert len(want) < tf.wide_filter_tiles(H, W, LADDER12)
    if not spike:
        w, g = (a.numpy() for a in tf.split_activation(act))
        with jax.disable_jit():
            jref = np.asarray(jax_filter(jnp.asarray(w), jnp.asarray(g),
                                         jnp.asarray(img), exact=False,
                                         supports=LADDER12))
        np.testing.assert_allclose(out, jref, atol=FILTER_TOL, rtol=0)


def _run_sums_schedule(x, N, S):
    """The window sums of csrc/filter.cu:run_sums_any over inputs x
    (f32, N + 2S of them) in the order the kernel adds them: where
    2S >= N - 1 run_sums_wide's head (inputs 0..N-1 start and extend the
    sums), middle (inputs N..2S add to all) and tail (inputs 2S + t add to
    the sums o >= t); else run_sums' predicated loop.  -> acc [N]."""
    acc = [None] * N
    if 2 * S >= N - 1:
        for i in range(N):
            for o in range(i):
                acc[o] = np.float32(acc[o] + x[i])
            acc[i] = x[i]
        for i in range(N, 2 * S + 1):
            for o in range(N):
                acc[o] = np.float32(acc[o] + x[i])
        for t in range(1, N):
            for o in range(t, N):
                acc[o] = np.float32(acc[o] + x[2 * S + t])
    else:
        for i in range(N + 2 * S):
            for o in range(N):
                if o == i:
                    acc[o] = x[i]
                elif o < i <= o + 2 * S:
                    acc[o] = np.float32(acc[o] + x[i])
    return np.array(acc, np.float32)


FILTER_CU = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "rt_octree_tpu_torch", "csrc", "filter.cu")


def _filter_cu_int(name):
    """The value of csrc/filter.cu's ``constexpr int`` ``name``."""
    src = open(FILTER_CU).read()
    return int(re.search(rf"\b{name}\s*=\s*(\d+)\s*[;,]", src).group(1))


@pytest.mark.parametrize("run", ["kWideRowRun", "kColRun"],
                         ids=["row pass", "column pass"])
def test_k5_wide_run_sums_keep_the_tap_order(run):
    """K5 wide's and K6 wide's window sums (both take these run lengths)
    at every runtime support 1..32 add each output's 2S + 1 inputs left
    to right, as K5's tile statement and the first wide instances do:
    bit-equal in f32 to x[o] + x[o + 1] + ... + x[o + 2S], on inputs
    whose sums round differently in another order.  N, the outputs a task
    sums, is read from csrc/filter.cu (the row pass's 10 switches from the
    unrolled run_sums to run_sums_wide between S = 4 and 5, the column
    pass's 4 between S = 1 and 2)."""
    N = _filter_cu_int(run)
    rs = np.random.default_rng(N)
    for S in range(1, 33):
        x = (rs.standard_normal(N + 2 * S) * 10.0 ** rs.integers(
            -4, 5, N + 2 * S)).astype(np.float32)
        want = []
        for o in range(N):
            a = x[o]
            for k in range(1, 2 * S + 1):
                a = np.float32(a + x[o + k])
            want.append(a)
        np.testing.assert_array_equal(_run_sums_schedule(x, N, S),
                                      np.array(want, np.float32))


def _k5_wide_statement(w, g, x, supports):
    """K5 wide's algorithm in NumPy: K5's tile algorithm
    (test_torch_train_filter.k5_statement: per 40x16 tile and level one
    range reduction over the staged region, e = exp(g - c) once a staged
    pixel, (e rgb, e) summed as separable shifted adds at the level's
    runtime support, the 60-nat guard's per-window form) with a tile's
    levels in order into out (no level split) -> (out, fm, den, the
    guarded (b, l, y0, x0))."""
    from tests.test_torch_train_filter import k5_statement
    return k5_statement(w, g, x, supports,
                        (tf.BATCH_TILE_W, tf.BATCH_TILE_H))


def _backward_from_saved(G, w, g, x, fm, den, supports):
    """The batched filter's closed-form backward (the module doc of
    ops/filtering.py) from K5's saved tensors, per tap in NumPy: dL/dw =
    G . f and dL/dg_q = sum_{p in N(q)} exp(g_q - m_p) / D_p w_p (G_p . x_q
    - G_p . f_p)."""
    B, L, H, W = w.shape
    G, rgb = G[..., :3], x[..., :3]
    gw = np.zeros((B, L, H, W), np.float64)
    gg = np.zeros((B, L, H, W), np.float64)
    for l, s in enumerate(supports):
        f, m = fm[:, l, ..., :3], fm[:, l, ..., 3]
        gw[:, l] = (G * (rgb if s == 0 else f)).sum(-1)
        if s == 0:
            continue
        a = w[:, l] / den[:, l]
        u, v = G * a[..., None], a * (G * f).sum(-1)
        pad = ((0, 0), (s, s), (s, s))
        mp = np.pad(m, pad, constant_values=np.inf)
        up = np.pad(u, pad + ((0, 0),))
        vp = np.pad(v, pad)
        for dy in range(2 * s + 1):
            for dx in range(2 * s + 1):
                k = np.exp(g[:, l] - mp[:, dy:dy + H, dx:dx + W])
                ux = (up[:, dy:dy + H, dx:dx + W] * rgb).sum(-1)
                gg[:, l] += k * (ux - vp[:, dy:dy + H, dx:dx + W])
    return gw, gg


@pytest.mark.parametrize("spike", [False, True],
                         ids=["seeded", "80-nat spike"])
def test_k5_wide_tile_statement_matches_plain_and_jax(spike):
    """K5 wide's tile algorithm at the ladder 1..12 on a batch of two
    70x75 images: out against K5's plain version and, on the seeded
    inputs, JAX's fast path (what the JAX training step takes); the saved
    f against the plain level sums and D against the plain window
    denominator (D exp(m - m_window)); the guard exactly in the (image,
    level, tile) triples whose region holds an 80-nat spike, and in none
    on the seeded inputs, as the counter reads on the card; and the
    closed-form backward from the saved tensors against K6's plain
    version."""
    L, H, W, yx = 12, 70, 75, (40, 50)
    w, g, x, G = _filter_inputs(23, L, H, W, B=2)
    if spike:
        g[1, :, yx[0], yx[1]] = 80.0
    out, fm, den, guards = _k5_wide_statement(w, g, x, LADDER12)
    t = torch.from_numpy
    ref = tf.guided_filter_batch_plain(t(w), t(g), t(x), LADDER12)
    np.testing.assert_allclose(out, ref.numpy(), atol=FILTER_TOL, rtol=0)
    for l, s in enumerate(LADDER12):
        f_p, m_p, d_p = (a.numpy() for a in tf._level_sums(
            t(x[..., :3]), t(g[:, l]), s))
        np.testing.assert_allclose(fm[:, l, ..., :3], f_p, atol=FILTER_TOL)
        np.testing.assert_allclose(
            den[:, l] * np.exp(fm[:, l, ..., 3] - m_p), d_p, rtol=1e-5)
    tw, th = tf.BATCH_TILE_W, tf.BATCH_TILE_H
    want = {(1, l, y0, x0) for l, s in enumerate(LADDER12)
            for y0 in range(0, H, th) for x0 in range(0, W, tw)
            if spike and y0 - s <= yx[0] < y0 + th + s
            and x0 - s <= yx[1] < x0 + tw + s}
    assert guards == want
    assert len(want) < tf.batch_tiles(2, H, W, LADDER12)
    gw, gg = _backward_from_saved(G, w, g, x, fm, den, LADDER12)
    rw, rg = tf.guided_filter_backward_plain(t(G), t(w), t(g), t(x),
                                             LADDER12)
    np.testing.assert_allclose(gw, rw.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(gg, rg.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    if not spike:
        assert _guard_holds(g)
        out_j = _jax_fast_vjp(LADDER12)(w, g, x, G)[0]
        np.testing.assert_allclose(out, np.asarray(out_j), atol=FILTER_TOL,
                                   rtol=0)


def _k6_wide_statement(G, w, g, x, fm, den, supports):
    """K6 wide's algorithm in NumPy, in f32: per image, level of support
    s > 0 and 40x16 tile, (u_p, v_p) = (G_p a_p, a_p G_p . f_p) with a_p =
    w_p / D_p and m_p staged over the tile and its halo s (0 and +inf
    outside the image); one range reduction of m; while it spans less
    than 60 nats, e_p = exp(mn - m_p) once a staged pixel into (u_p, v_p),
    the row pass in tasks of kWideRowRun outputs and the column pass in
    runs of kColRun, each output's sum in csrc/filter.cu:run_sums_any's
    order (_run_sums_schedule), and dL/dg_q = exp(g_q - mn) (x_q . U - V);
    else the per-window form.  -> (dL/dw, dL/dg, the guarded (b, l, y0,
    x0))."""
    from tests.test_torch_train_filter import _staged
    B, L, H, W = w.shape
    tw, th = tf.BATCH_TILE_W, tf.BATCH_TILE_H
    row_run, col_run = _filter_cu_int("kWideRowRun"), _filter_cu_int(
        "kColRun")
    rgb, G = x[..., :3], G[..., :3]
    f32 = np.float32

    def dot3(a, b):
        return f32(f32(a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1])
                   + a[..., 2] * b[..., 2])
    gw = np.zeros((B, L, H, W), f32)
    gg = np.zeros((B, L, H, W), f32)
    guards = set()
    for b in range(B):
        for l, s in enumerate(supports):
            if s == 0:
                gw[b, l] = dot3(G[b], rgb[b])
                continue
            gf = dot3(G[b], fm[b, l])
            gw[b, l] = gf
            a = w[b, l] / den[b, l]
            uv = np.concatenate([G[b] * a[..., None], (a * gf)[..., None]],
                                -1)
            for y0 in range(0, H, th):
                for x0 in range(0, W, tw):
                    uv_r = _staged(uv, y0, x0, th, tw, s, f32(0))
                    m_r = _staged(fm[b, l, ..., 3], y0, x0, th, tw, s,
                                  f32(np.inf))
                    inside = m_r < np.inf
                    mn, mx = m_r[inside].min(), m_r[inside].max()
                    xq = _staged(rgb[b], y0, x0, th, tw, 0, f32(0))
                    gq = _staged(g[b, l], y0, x0, th, tw, 0, f32(0))
                    if mx - mn < tf.GUARD_RANGE:
                        X = uv_r * np.exp(mn - m_r)[..., None]
                        hs = np.zeros((th + 2 * s, tw, 4), f32)
                        for c0 in range(0, tw, row_run):
                            run = np.moveaxis(
                                X[:, c0:c0 + row_run + 2 * s], 1, 0)
                            hs[:, c0:c0 + row_run] = np.moveaxis(
                                _run_sums_schedule(run, row_run, s), 0, 1)
                        U = np.concatenate([_run_sums_schedule(
                            hs[r0:r0 + col_run + 2 * s], col_run, s)
                            for r0 in range(0, th, col_run)])
                        acc = np.exp(gq - mn) * f32(dot3(xq, U) - U[..., 3])
                    else:
                        guards.add((b, l, y0, x0))
                        acc = np.zeros((th, tw), f32)
                        for dy in range(2 * s + 1):
                            for dx in range(2 * s + 1):
                                p = uv_r[dy:dy + th, dx:dx + tw]
                                k = np.exp(gq - m_r[dy:dy + th, dx:dx + tw])
                                acc = acc + k * (dot3(p, xq) - p[..., 3])
                    ny, nx = min(th, H - y0), min(tw, W - x0)
                    gg[b, l, y0:y0 + ny, x0:x0 + nx] = acc[:ny, :nx]
    return gw, gg, guards


@pytest.mark.parametrize("spike", [False, True],
                         ids=["seeded", "80-nat spike"])
def test_k6_wide_tile_statement_matches_plain_and_jax(spike):
    """K6 wide's tile algorithm (one e a staged pixel, row tasks of 10,
    the 60-nat guard) at the ladder 1..12 on a batch of two 70x75 images,
    from the tensors K5 wide's statement saves: both gradients against
    the closed-form backward from those tensors, K6's plain version and,
    on the seeded inputs, JAX's autodiff backward of guided_filter_batch
    (its fast path, which the JAX training step takes); the guard in no
    tile on the seeded inputs, and with an 80-nat spike exactly in the
    (image, level, tile) triples whose region holds a saved stabiliser of
    a window that holds the spike (the spike within 2s of the tile)."""
    L, H, W, yx = 12, 70, 75, (40, 50)
    w, g, x, G = _filter_inputs(23, L, H, W, B=2)
    if spike:
        g[1, :, yx[0], yx[1]] = 80.0
    _, fm, den, _ = _k5_wide_statement(w, g, x, LADDER12)
    gw, gg, guards = _k6_wide_statement(G, w, g, x, fm, den, LADDER12)
    sw, sg = _backward_from_saved(G, w, g, x, fm, den, LADDER12)
    t = torch.from_numpy
    rw, rg = tf.guided_filter_backward_plain(t(G), t(w), t(g), t(x),
                                             LADDER12)
    for got in (gw, gg):
        assert np.isfinite(got).all()
    for got, want in ((gw, sw), (gg, sg), (gw, rw.numpy()), (gg, rg.numpy())):
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    tw, th = tf.BATCH_TILE_W, tf.BATCH_TILE_H
    want = {(1, l, y0, x0) for l, s in enumerate(LADDER12)
            for y0 in range(0, H, th) for x0 in range(0, W, tw)
            if spike and y0 - 2 * s <= yx[0] < y0 + th + 2 * s
            and x0 - 2 * s <= yx[1] < x0 + tw + 2 * s}
    assert guards == want
    assert len(want) < tf.batch_tiles(2, H, W, LADDER12)
    if not spike:
        assert _guard_holds(g)
        _, gw_j, gg_j = _jax_fast_vjp(LADDER12)(w, g, x, G)
        np.testing.assert_allclose(gw, np.asarray(gw_j), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        np.testing.assert_allclose(gg, np.asarray(gg_j), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
