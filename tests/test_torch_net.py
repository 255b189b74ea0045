"""Kernel K7 (the compact GuidanceNet's forward, csrc/net.cu) and its plain
version against the Flax package: compact_activation_plain vs Flax's
GuidanceNetCompact in bf16 on every committed .gnet and on the JAX tests'
configurations, the zero padding at the border, K7's packed weight layout
and a NumPy statement of K7's tap and channel order over it, the
Renderer's net_forward and a denoised frame vs the JAX Renderer's; on a
card, K7 against its plain version, its launches and its limits.

The JAX package is imported only by the tests that compare with it (the
``jx`` fixture), so that the card's machine, which has no JAX, runs the
rest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_net.py

Tolerances.  Flax (XLA) and PyTorch on the CPU sum a conv in f32 in their
own orders, so a bf16 rounding may land one ulp apart; a block's rounding
that moves then moves the next block's sums, and a bias that cancels its
conv output makes one ulp of the conv many ulps of the result.  So an
element's difference is held in ulps of the tensor's largest magnitude:
one ulp for the plain version against Flax (the bound of
test_torch_guidance_net.py), two for K7 (tensor cores) against the plain
version, with at most 1e-3 of the elements not bit-equal (a kernel that
rounds the conv and the bias in one step fails that:
test_share_bar_rejects_the_bias_folded_into_the_sum).
The NumPy statement of K7 is held block by block on the same inputs, so
that no rounding is carried over: a carried one spreads over a block's
3x3 footprint, and through a 3-block chain at 29x31 another PyTorch
version's CPU convs left 1.8e-3 of the elements unequal.
"""

import glob
import os
import types

import numpy as np
import pytest
import torch

from rt_octree_tpu_torch.core.camera import Camera
from rt_octree_tpu_torch.core.options import RenderOptions
from rt_octree_tpu_torch.io import synthetic
from rt_octree_tpu_torch.models import guidance_net as tg
from rt_octree_tpu_torch.native import build as native
from rt_octree_tpu_torch.ops import guidance as og
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.ops.filtering import split_activation
from rt_octree_tpu_torch.render import renderer as tr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GNETS = sorted(glob.glob(os.path.join(REPO, "benchmarks", "*", "*.gnet")) +
               glob.glob(os.path.join(REPO, "tests", "data", "*.gnet")))
FAST = os.path.join(REPO, "benchmarks", "quality", "fast.gnet")
TRAINED = os.path.join(REPO, "benchmarks", "quality", "trained.gnet")
# the JAX tests' configurations (tests/test_guidance_net.py,
# tests/test_fast_mode.py) and a 3-block chain
CONFIGS = {
    "l1 8-4": dict(in_channels=8, mid_channels=4, num_layers=1,
                   kernel_levels=2),
    "mid4 8-4-4": dict(in_channels=8, mid_channels=4, num_layers=2,
                       kernel_levels=2),
    "mid16 8-16-8": dict(in_channels=8, mid_channels=16, num_layers=2,
                         kernel_levels=4),
    "in6 6-6-6": dict(in_channels=6, mid_channels=6, num_layers=2,
                      kernel_levels=3),
    "identity 8-32-8": dict(identity_level=True),
    "chain 8-8-8-8": dict(in_channels=8, mid_channels=8, num_layers=3,
                          kernel_levels=4),
    # wider than the committed nets: K7's other instances (csrc/net.cu) --
    # a one-block launch of two n-tiles, block 0's weights read through the
    # cache (36, 40 and 288 fragments), a last block of 2 and 8 n-tiles,
    # tiles of 8 and 4 rows
    "l1 8-16": dict(in_channels=8, mid_channels=16, num_layers=1,
                    kernel_levels=8),
    "in16 16-32-8": dict(in_channels=16, mid_channels=32, kernel_levels=4),
    "mid64 8-64-16": dict(in_channels=8, mid_channels=64, kernel_levels=8),
    "in32 32-64-8": dict(in_channels=32, mid_channels=64, kernel_levels=4),
    "wide 64-64-64": dict(in_channels=64, mid_channels=64,
                          kernel_levels=32),
    # past 64 channels: K7's wide plan, one launch a block (the path's
    # --mid_channels 96 --kernel_levels 12, and a 3-block 128-wide chain)
    "mid96 8-96-24": dict(in_channels=8, mid_channels=96, num_layers=2,
                          kernel_levels=12),
    "mid128 8-128-128-8": dict(in_channels=8, mid_channels=128,
                               num_layers=3, kernel_levels=4),
    # the per-block plan's other shapes: a 256-wide block split over two
    # blocks of the grid (4 n-tiles each), and an f32 input of 16 channels
    # (rounded to bf16 for the ring instance)
    "mid256 8-256-64": dict(in_channels=8, mid_channels=256,
                            kernel_levels=32),
    "in16 16-96-24": dict(in_channels=16, mid_channels=96,
                          kernel_levels=12),
    # 10 output channels: the last block's 4-byte stores (store_rows)
    "mid128 8-128-10": dict(in_channels=8, mid_channels=128,
                            kernel_levels=5),
}
WIDE = ["l1 8-16", "in16 16-32-8", "mid64 8-64-16", "in32 32-64-8",
        "wide 64-64-64", "mid96 8-96-24", "mid128 8-128-128-8",
        "mid256 8-256-64", "in16 16-96-24", "mid128 8-128-10"]
PLAIN_FLAX_ULPS, K7_ULPS, K7_UNEQUAL_SHARE = 1.0, 2.0, 1e-3


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (tests/conftest.py keeps JAX on the CPU)."""
    pytest.importorskip("jax")
    pytest.importorskip("flax")
    import jax.numpy as jnp
    from rt_octree_tpu.core.options import RenderOptions as JaxOptions
    from rt_octree_tpu.io import synthetic as jsynthetic
    from rt_octree_tpu.models import guidance_net as jg
    from rt_octree_tpu.ops import traversal as jt
    from rt_octree_tpu.render import renderer as jr
    return types.SimpleNamespace(jnp=jnp, jg=jg, jr=jr, jt=jt,
                                 synthetic=jsynthetic, options=JaxOptions)


def _config(name):
    return tg.GuidanceNetConfig(**CONFIGS[name])


def _params(cfg, seed=3):
    """Folded Flax-layout params from a numpy seed: kernels ~ N(0, 0.4)
    (past 64 channels N(0, 1.5 / sqrt(9 cin)), so that the sums stay
    inside relu6's range), biases ~ N(0, 0.1), f32."""
    rs = np.random.default_rng(seed)
    chans = cfg.layer_channels()
    wide = max(max(c) for c in chans) > og.MAX_CHANNELS
    return {f"block_{i}": {
        "kernel": (rs.standard_normal((3, 3, cin, cout)) * (
            1.5 / np.sqrt(9 * cin) if wide else 0.4)).astype(np.float32),
        "bias": (rs.standard_normal(cout) * 0.1).astype(np.float32)}
        for i, (cin, cout) in enumerate(chans)}


def _aux(H, W, C=8, seed=0):
    """An aux like K1's: rgba means in [0, 1], then their squares."""
    rs = np.random.default_rng(seed)
    aux = rs.random((1, H, W, C), np.float32)
    h = C // 2
    aux[..., h:2 * h] = aux[..., :h] ** 2
    return aux


def ulp_stats(got, ref):
    """(largest difference in bf16 ulps of the tensor's largest magnitude,
    largest in ulps of each element's larger magnitude, share of elements
    not equal)."""
    g = torch.as_tensor(got).float()
    r = torch.as_tensor(ref).float()
    d = (g - r).abs()
    big = torch.maximum(g.abs(), r.abs())

    def ulp(m):
        return torch.exp2(torch.floor(torch.log2(
            torch.as_tensor(m).clamp_min(2.0 ** -126))) - 7)
    return (float(d.max() / ulp(big.max())), float((d / ulp(big)).max()),
            float((g != r).float().mean()))


def _flax(jx, cfg, params, aux):
    return [np.array(a) for a in jx.jg.GuidanceNetCompact(
        cfg, dtype=jx.jnp.bfloat16).apply({"params": params},
                                          jx.jnp.asarray(aux))]


def _plain(cfg, params, aux):
    net = tg.build_compact(cfg, params, "cpu")
    with torch.no_grad():
        return net.activation(torch.from_numpy(aux))


def _hold_plain_to_flax(jx, cfg, params, aux):
    """The plain activation's split (weight, guidance) vs Flax's: the raw
    guidance within PLAIN_FLAX_ULPS, the softmaxed weights within 1/128
    (test_torch_guidance_net.py's bound)."""
    wj, gj = _flax(jx, cfg, params, aux)
    act = _plain(cfg, params, aux)
    L = cfg.kernel_levels
    assert act.shape == (1, 2 * L) + aux.shape[1:3] and \
        act.dtype == torch.bfloat16
    x = act.float()
    wt, gt = torch.softmax(x[:, :L], 1).numpy(), x[:, L:].numpy()
    assert ulp_stats(gt, gj)[0] <= PLAIN_FLAX_ULPS
    np.testing.assert_allclose(wt, wj, atol=1.0 / 128)
    return act


def test_every_committed_gnet_is_found():
    assert len(GNETS) >= 9


@pytest.mark.parametrize("path", GNETS,
                         ids=[os.path.relpath(p, REPO) for p in GNETS])
def test_plain_matches_flax_bf16_on_committed_gnets(jx, path):
    cfg, params = tg.load_compact(path)
    _hold_plain_to_flax(jx, cfg, params, _aux(24, 20))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_matches_flax_bf16_on_configs(jx, name):
    cfg = _config(name)
    _hold_plain_to_flax(jx, cfg, _params(cfg),
                        _aux(17, 23, cfg.in_channels, seed=1))


@pytest.mark.parametrize("shape", [(1, 19), (3, 3), (2, 1)],
                         ids=["1x19", "3x3", "2x1"])
def test_border_zero_padding_matches_flax(jx, shape):
    """Images whose every pixel sits at the border: the second block's
    halo outside the image is 0 in Flax's SAME padding, not the first
    block evaluated there (relu6(bias) > 0 with these biases)."""
    cfg, params = tg.load_compact(FAST)
    aux = _aux(*shape, seed=2)
    act = _hold_plain_to_flax(jx, cfg, params, aux)
    # the first block outside the image would not be 0: its relu6(bias)
    assert (np.maximum(params["block_0"]["bias"], 0) > 0).any()
    assert torch.equal(_hold_numpy_statement(cfg, params, aux), act)


def _bits(t):
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _packs(cfg, params):
    return [og.pack_layer(torch.from_numpy(params[f"block_{i}"]["kernel"]),
                          torch.from_numpy(params[f"block_{i}"]["bias"]))
            for i in range(cfg.num_layers)]


def _unpack(p):
    """The K-major pack (block 0 of a two-block launch) read back by the
    fragment order of ops/guidance.py: (Wk [K, N] bf16 bits with K = ks *
    16, N = nt * 8, b [N] bits)."""
    w = _bits(p.w)
    ks, nt = w.shape[:2]
    wk = np.zeros((ks * 16, nt * 8), np.uint16)
    for lane in range(32):
        for j in range(4):
            k = np.arange(ks)[:, None] * 16 + lane % 4 * 2 + j % 2 + \
                j // 2 * 8
            n = np.arange(nt)[None, :] * 8 + lane // 4
            wk[k, n] = w[:, :, lane, j]
    return wk, _bits(p.b)


def _unpack_taps(p):
    """The tap-major pack (the last block of a launch) read back: W_tap [9,
    K, N] bf16 bits, K = the input channels padded to max(CP, 16)."""
    w = _bits(p.wt)
    nt, ks = w.shape[:2]
    wt = np.zeros((9, ks * 16, nt * 8), np.uint16)
    for lane in range(32):
        for j in range(4):
            k = np.arange(ks)[None, :] * 16 + lane % 4 * 2 + j % 2 + \
                j // 2 * 8
            n = np.arange(nt)[:, None] * 8 + lane // 4
            for tap in range(9):
                wt[tap, k, n] = w[:, :, tap, lane, j]
    return wt


@pytest.mark.parametrize("name", list(CONFIGS) + ["trained 8-32-8"])
def test_packed_layout_unpacks_bit_for_bit(name):
    if name == "trained 8-32-8":
        cfg, params = tg.load_compact(TRAINED)
    else:
        cfg = _config(name)
        params = _params(cfg)
    for i, p in enumerate(_packs(cfg, params)):
        k = params[f"block_{i}"]["kernel"]
        b = params[f"block_{i}"]["bias"]
        cin, cout = k.shape[2:]
        assert (p.cin, p.cout) == (cin, cout)
        assert p.cp == og.padded_channels(cin) and p.cp >= cin
        wk, bb = _unpack(p)
        assert wk.shape == ((9 * p.cp + 15) // 16 * 16,
                            og.padded_channels(cout))
        taps = wk[:9 * p.cp].reshape(9, p.cp, -1)
        ref = _bits(torch.from_numpy(k).to(torch.bfloat16)).reshape(
            9, cin, cout)
        np.testing.assert_array_equal(taps[:, :cin, :cout], ref)
        assert not taps[:, cin:].any() and not taps[:, :, cout:].any()
        assert not wk[9 * p.cp:].any()
        wt = _unpack_taps(p)
        assert wt.shape == (9, max(p.cp, 16), og.padded_channels(cout))
        np.testing.assert_array_equal(wt[:, :cin, :cout], ref)
        assert not wt[:, cin:].any() and not wt[:, :, cout:].any()
        np.testing.assert_array_equal(
            bb[:cout], _bits(torch.from_numpy(b).to(torch.bfloat16)))
        assert not bb[cout:].any()


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _k7_numpy(aux, packs, fold_bias=False):
    """K7's arithmetic over the packs, in its order: the input rounded to
    bf16 and zero-padded to CP channels, zero outside the image; each
    block's sums in one f32 accumulator, a k-step of 16 products at a time
    (the mma's shape), then rounded to bf16, the bias added and rounded,
    relu6; the padded output channels (0) feed the next block.  Block 0 of
    a fused instance's two-block launch (og.net_plan) sums K = tap * CP +
    ci in order (tap = 3 ky + kx); the last block of a fused instance's
    launch (the only one of a one-block launch, every narrow block of a
    chain) sums kx outer, then ky, then 16 channels at a time; the wide
    instances (both blocks of the fused wide instance, every block of the
    per-block plan) sum 16 channels at a time outer, then the nine taps in
    order.
    aux [1, H, W, cin] -> each block's output [H, W, padded cout] (f32
    holding bf16 values).  ``fold_bias``: the bias added to the f32 sum,
    one rounding (not Flax's order)."""
    x = _bf16(aux[0])
    H, W = x.shape[:2]
    outs = []
    plan = og.net_plan(packs)
    for i, p in enumerate(packs):
        first = plan == "fused" and len(packs) == 2 and i == 0
        wk, bb = _unpack(p)
        if first:
            wk = wk.astype(np.uint32) << 16
            wk = wk.view(np.float32).astype(np.float64)
        else:
            wk = (_unpack_taps(p).astype(np.uint32) << 16).view(
                np.float32).astype(np.float64)
        bias = (bb.astype(np.uint32) << 16).view(np.float32)
        cps = p.cp if first else max(p.cp, 16)
        xc = np.zeros((H + 2, W + 2, cps), np.float32)
        xc[1:-1, 1:-1, :x.shape[2]] = x
        acc = np.zeros((H, W, wk.shape[-1]), np.float32)
        if first:
            cols = np.zeros((H, W, wk.shape[0]), np.float64)
            cols[..., :9 * p.cp] = np.stack(
                [xc[ky:ky + H, kx:kx + W] for ky in range(3)
                 for kx in range(3)], 2).reshape(H, W, 9 * p.cp)
            for s in range(0, wk.shape[0], 16):
                acc = (acc + cols[..., s:s + 16] @ wk[s:s + 16]).astype(
                    np.float32)
        elif og.is_wide(p) or plan == "fused_wide":
            for s in range(0, cps, 16):
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    acc = (acc + xc[ky:ky + H, kx:kx + W, s:s + 16]
                           .astype(np.float64)
                           @ wk[tap, s:s + 16]).astype(np.float32)
        else:
            for kx in range(3):
                for ky in range(3):
                    for s in range(0, cps, 16):
                        acc = (acc + xc[ky:ky + H, kx:kx + W, s:s + 16]
                               .astype(np.float64)
                               @ wk[3 * ky + kx, s:s + 16]).astype(np.float32)
        y = _bf16(acc + bias) if fold_bias else _bf16(_bf16(acc) + bias)
        x = np.clip(y, 0.0, 6.0)
        outs.append(x)
    return outs


def _hold_numpy_statement(cfg, params, aux):
    """The NumPy statement of K7 vs the plain version: each block on the
    same input (the statement's previous block; no rounding carried over)
    within K7_ULPS with at most K7_UNEQUAL_SHARE unequal, and the whole
    net within K7_ULPS.  Returns the plain activation."""
    outs = _k7_numpy(aux, _packs(cfg, params))
    x = aux
    for i, (cin, cout) in enumerate(cfg.layer_channels()):
        ref = _plain_block(params, i, x[..., :cin])
        got = outs[i][..., :cout].transpose(2, 0, 1)[None]
        st = ulp_stats(got, ref)
        assert st[0] <= K7_ULPS and st[2] <= K7_UNEQUAL_SHARE, (i, st)
        x = outs[i][None]
    act = _plain(cfg, params, aux)
    got = outs[-1][..., :cfg.layer_channels()[-1][1]].transpose(2, 0, 1)
    assert ulp_stats(got[None], act)[0] <= K7_ULPS
    return act


@pytest.mark.parametrize("name", list(CONFIGS) + ["trained 8-32-8"])
def test_numpy_statement_of_k7_matches_plain(name):
    if name == "trained 8-32-8":
        cfg, params = tg.load_compact(TRAINED)
    else:
        cfg = _config(name)
        params = _params(cfg)
    _hold_numpy_statement(cfg, params, _aux(29, 31, cfg.in_channels, seed=4))


def _plain_block(params, i, x):
    """The plain version of block i alone on x [1, H, W, cin]."""
    k = torch.from_numpy(params[f"block_{i}"]["kernel"])
    return tg.compact_activation_plain(
        torch.from_numpy(np.ascontiguousarray(x)), [k.permute(3, 2, 0, 1)],
        [torch.from_numpy(params[f"block_{i}"]["bias"])])


def test_share_bar_rejects_the_bias_folded_into_the_sum():
    """The bar tells Flax's two roundings from one: with the bias added to
    the f32 sum and rounded once, block 0 of trained.gnet leaves more
    than K7_UNEQUAL_SHARE of its elements unequal to the plain version."""
    cfg, params = tg.load_compact(TRAINED)
    aux = _aux(29, 31, seed=4)
    cout = cfg.layer_channels()[0][1]
    got = _k7_numpy(aux, _packs(cfg, params)[:1], fold_bias=True)[0]
    st = ulp_stats(got[..., :cout].transpose(2, 0, 1)[None],
                   _plain_block(params, 0, aux))
    assert st[2] > 10 * K7_UNEQUAL_SHARE, st


def test_limits_raise_value_error():
    """K7's limits: a block of no channels, and the wrapper on a CPU tensor
    (CPU tensors take the plain version in activation); past 64 channels a
    block packs for the wide plan, its channels padded to 16."""
    for cin, cout, pads in ((8, 65, (8, 80)), (65, 8, (80, 8)),
                            (96, 24, (96, 32)), (256, 256, (256, 256))):
        p = og.pack_layer(torch.zeros(3, 3, cin, cout), torch.zeros(cout))
        assert og.is_wide(p) and (p.cp, p.nt * 8) == pads
        assert p.wt.shape == (pads[1] // 8, max(pads[0], 16) // 16, 9, 32,
                              4)
    assert not og.is_wide(og.pack_layer(torch.zeros(3, 3, 64, 64),
                                        torch.zeros(64)))
    with pytest.raises(ValueError, match="0 channels"):
        og.pack_layer(torch.zeros(3, 3, 0, 8), torch.zeros(8))
    cfg = _config("mid4 8-4-4")
    with pytest.raises(ValueError, match="CUDA"):
        og.guidance_net(torch.zeros(1, 4, 4, 8), _packs(cfg, _params(cfg)))
    with pytest.raises(ValueError, match="CUDA"):
        og.chain_block(torch.zeros(1, 4, 4, 8), _packs(cfg, _params(cfg))[0],
                       8)
    wide = tg.GuidanceNetConfig(mid_channels=65)
    net = tg.build_compact(wide, _params(wide), "cpu")  # plain: any width
    assert net.activation(torch.zeros(1, 3, 3, 8)).shape == (1, 8, 3, 3)


# ---------------------------------------------------------------------------
# the Renderer on the CPU vs the JAX package
# ---------------------------------------------------------------------------

W = H = 24


@pytest.fixture(scope="module")
def tree(jx):
    return jx.synthetic.make_synthetic_tree("shell", depth=5, basis_dim=9)


def _opt(options=RenderOptions):
    return options(spp=6, denoise=True, step_size=1e-4, sigma_thresh=1e-2,
                   background_brightness=1.0)


@pytest.fixture(scope="module")
def cam():
    return Camera(width=W, height=H, fx=34.0, fy=34.0)


@pytest.fixture(scope="module")
def port_renderer(tree, cam):
    dt = tt.upload_tree(tree, lut_levels=5, device="cpu")
    r = tr.Renderer(dt, W, H, cam.fx, cam.fy, options=_opt())
    r.set_denoiser(FAST)
    return r


def test_net_forward_matches_jax(jx, port_renderer, cam):
    """Renderer.net_forward on K1's aux vs the JAX Renderer's split-phase
    net (_net_forward_jit) on the same aux."""
    port_renderer.rng.seed(20230418, 1)
    _, aux_nhwc, aux_chw = port_renderer.render_noisy(cam.transform)
    act = port_renderer.net_forward(aux_nhwc)
    cfg, params = jx.jg.load_compact(FAST)
    wj, gj = jx.jr._net_forward_jit(jx.jnp.asarray(aux_chw.numpy()), params,
                                    net_cfg=cfg)
    wt, gt = split_activation(act)
    assert ulp_stats(gt, np.array(gj))[0] <= PLAIN_FLAX_ULPS
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1.0 / 128)


@pytest.fixture(scope="module")
def wide128_gnet(tmp_path_factory):
    """A seeded 3-block 128-wide net of 4 levels (the wide path's
    --mid_channels 128 --num_layers 3) as the port exports it."""
    cfg = tg.GuidanceNetConfig(mid_channels=128, num_layers=3,
                               kernel_levels=4)
    path = str(tmp_path_factory.mktemp("gnet") / "wide128.gnet")
    tg.save_compact(path, cfg, _params(cfg))
    return path


@pytest.mark.parametrize("gnet", ["fast", "wide128"])
def test_denoised_render_matches_jax(jx, port_renderer, tree, cam, gnet,
                                     request):
    """A denoised frame with fast.gnet (supports 1..4), and with the port's
    export of a 3-block 128-wide net (K7's per-block plan on the card), vs
    the JAX Renderer's, as test_torch_frame.py holds trained.gnet's: 1e-3
    on [0, 1] pixels (one bf16 rounding inside the net may move a
    weight)."""
    path = FAST if gnet == "fast" else request.getfixturevalue(
        "wide128_gnet")
    dt = jx.jt.upload_tree(tree, lut_levels=5)
    r = jx.jr.Renderer(dt, W, H, cam.fx, cam.fy, options=_opt(jx.options),
                       schedule=((0, 1),))
    r.set_denoiser(path)
    img_j, aux_j = (np.asarray(a) for a in r.render(cam.transform))
    if gnet != "fast":
        port_renderer = tr.Renderer(
            tt.upload_tree(tree, lut_levels=5, device="cpu"), W, H, cam.fx,
            cam.fy, options=_opt())
        port_renderer.set_denoiser(path)
    port_renderer.rng.seed(20230418, 1)
    img, aux = port_renderer.render(cam.transform)
    np.testing.assert_allclose(aux.numpy(), aux_j, atol=4e-5)
    np.testing.assert_allclose(img.numpy(), img_j, atol=1e-3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hold_k7(net, aux):
    """K7 vs the plain version on aux at K7's bars.  For a net with a wide
    block, each block alone as a chain launch (og.chain_block) is held on
    the input the chain gives it, the plain chain's bf16 output
    padded with 0 to the block before's padded channels (no rounding
    carried over, as the NumPy statement is held), its padded output
    channels 0; the whole chain at both bars; the fused wide instance's
    one launch equal to the per-block plan's chain bit for bit."""
    ws = [c.weight for c in net.convs]
    bs = [c.bias for c in net.convs]
    with torch.no_grad():
        act = net.activation(aux)
        ref = tg.compact_activation_plain(aux, ws, bs)
        st = ulp_stats(act.cpu(), ref.cpu())
        assert act.shape == ref.shape and bool(
            torch.isfinite(act.float()).all())
        assert st[0] <= K7_ULPS and st[2] <= K7_UNEQUAL_SHARE, st
        if not any(map(og.is_wide, net.packed)):
            return
        if og.net_plan(net.packed) == "fused_wide":
            # the fused wide instance sums as the per-block plan does
            x = aux
            for i, layer in enumerate(net.packed):
                x = og.chain_block(x, layer, layer.cout if i == len(
                    net.packed) - 1 else layer.nt * 8)
            assert torch.equal(act.permute(0, 2, 3, 1), x)
        xk = xp = aux
        for i, layer in enumerate(net.packed):
            last = i == len(net.packed) - 1
            out = og.chain_block(xk, layer, layer.cout if last
                                 else layer.nt * 8)
            ref = tg.compact_activation_plain(xp, ws[i:i + 1], bs[i:i + 1])
            st = ulp_stats(out[..., :layer.cout].permute(0, 3, 1, 2).cpu(),
                           ref.cpu())
            assert st[0] <= K7_ULPS and st[2] <= K7_UNEQUAL_SHARE, (i, st)
            assert not out[..., layer.cout:].any()
            xp = ref.permute(0, 2, 3, 1)
            xk = torch.nn.functional.pad(
                xp, (0, layer.nt * 8 - layer.cout)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [
    ("mid96 8-96-24", (1, 37, 53)), ("mid96 8-96-24", (1, 800, 800)),
    ("mid96 8-96-24", (1, 801, 799)), ("mid96 8-96-24", (3, 17, 57)),
    ("mid128 8-128-128-8", (1, 37, 53)),
    ("mid128 8-128-128-8", (1, 800, 800)),
    ("mid256 8-256-64", (1, 800, 800)), ("in16 16-96-24", (1, 37, 53))],
    ids=["mid96 37x53", "mid96 800x800", "mid96 799x801", "mid96 3x57x17",
         "mid128 37x53", "mid128 800x800", "mid256 800x800", "in16 37x53"])
def test_k7_wide_plan_matches_plain(name, shape, cuda_device):
    """Nets past 64 channels: the 8 -> 96 -> 24 net in one launch of the
    fused wide instance (also at the edges of its 64x8 tiles and on a
    batch), the 3-block 128-wide chain, the 256-wide net and a net from 16
    f32 channels in one launch of the per-block plan a block; each block
    of the chain held on its own input, the whole net within K7's bars."""
    cfg = _config(name)
    net = tg.build_compact(cfg, _params(cfg), cuda_device)
    B, H, W = shape
    aux = np.concatenate([_aux(H, W, cfg.in_channels, seed=8 + b)
                          for b in range(B)])
    aux = torch.from_numpy(aux).to(cuda_device)
    native.reset_launches()
    with torch.no_grad():
        net.activation(aux)
    torch.cuda.synchronize()
    fused = name.startswith("mid96")
    assert og.net_plan(net.packed) == ("fused_wide" if fused else "chain")
    assert native.LAUNCHES["guidance_net_wide"] == (1 if fused else
                                                    cfg.num_layers)
    assert native.LAUNCHES["guidance_net"] == 0
    _hold_k7(net, aux)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mid96 8-96-24", "mid128 8-128-128-8"])
def test_fused_wide_smem_is_the_kernels(name, cuda_device):
    """ops/guidance.fused_wide_smem, with which the host chooses the fused
    wide instance, counts the shared memory that csrc/net.cu's entry
    computes for the net's first and last blocks (232,448 bytes at most
    fit: the 96-wide net does, the 128-wide blocks do not)."""
    cfg = _config(name)
    packs = _packs(cfg, _params(cfg))
    first, last = packs[0], packs[-1]
    got = native.entry("rt_guidance_wide_fused_smem")(
        first.nt, last.wt.shape[1], last.cout)
    assert got == og.fused_wide_smem([first, last])
    assert (got <= og.SMEM_MAX) == name.startswith("mid96")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(37, 53), (800, 800), (1080, 1920)],
                         ids=["37x53", "800x800", "1920x1080"])
@pytest.mark.parametrize("name", ["trained 8-32-8", "l1 8-4", "mid4 8-4-4",
                                  "in6 6-6-6", "chain 8-8-8-8"])
def test_k7_matches_plain(name, size, cuda_device):
    if name == "trained 8-32-8":
        cfg, params = tg.load_compact(TRAINED)
    else:
        cfg = _config(name)
        params = _params(cfg)
    aux = torch.from_numpy(_aux(*size, cfg.in_channels, seed=5)).to(
        cuda_device)
    net = tg.build_compact(cfg, params, cuda_device)
    native.reset_launches()
    act = net.activation(aux)
    torch.cuda.synchronize()
    # one launch for 1 or 2 blocks, a chain of one a block beyond
    assert native.LAUNCHES["guidance_net"] == (
        1 if cfg.num_layers <= 2 else cfg.num_layers)
    with torch.no_grad():
        ref = tg.compact_activation_plain(aux, [c.weight for c in net.convs],
                                          [c.bias for c in net.convs])
    st = ulp_stats(act.cpu(), ref.cpu())
    assert act.shape == ref.shape and bool(torch.isfinite(act.float()).all())
    assert st[0] <= K7_ULPS and st[2] <= K7_UNEQUAL_SHARE, st


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 19), (1, 2, 1), (1, 16, 56),
                                   (1, 17, 57), (1, 33, 113), (3, 17, 57),
                                   (1, 801, 799)],
                         ids=["1x19", "2x1", "56x16", "57x17", "113x33",
                              "3x57x17", "799x801"])
@pytest.mark.parametrize("name", ["trained 8-32-8", "l1 8-4", "mid16 8-16-8",
                                  "chain 8-8-8-8"] + WIDE)
def test_k7_matches_plain_at_tile_edges(name, shape, cuda_device):
    """K7's 56x16 output tiles at their ragged edges (one pixel past a
    multiple, exact multiples), frames with fewer tiles than the persistent
    grid has blocks, and a batch of three images walked by one grid; the
    wide nets' tiles of 8 and 4 rows at the same sizes."""
    if name == "trained 8-32-8":
        cfg, params = tg.load_compact(TRAINED)
    else:
        cfg = _config(name)
        params = _params(cfg)
    B, H, W = shape
    aux = np.concatenate([_aux(H, W, cfg.in_channels, seed=7 + b)
                          for b in range(B)])
    aux = torch.from_numpy(aux).to(cuda_device)
    _hold_k7(tg.build_compact(cfg, params, cuda_device), aux)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 102, 103, 104, 105, 106])
def test_k7_chain_on_more_seeds(seed, cuda_device):
    """The 3-block chain, whose largest difference reads nearest the ulps
    bar, on more random nets and aux at 799x801."""
    cfg = _config("chain 8-8-8-8")
    params = _params(cfg, seed)
    aux = torch.from_numpy(_aux(801, 799, seed=seed)).to(cuda_device)
    net = tg.build_compact(cfg, params, cuda_device)
    act = net.activation(aux)
    with torch.no_grad():
        ref = tg.compact_activation_plain(aux, [c.weight for c in net.convs],
                                          [c.bias for c in net.convs])
    st = ulp_stats(act.cpu(), ref.cpu())
    assert act.shape == ref.shape and bool(torch.isfinite(act.float()).all())
    assert st[0] <= K7_ULPS and st[2] <= K7_UNEQUAL_SHARE, st


@pytest.mark.cuda
def test_k7_reads_strided_aux(cuda_device):
    """The runner's test split hands a permuted NCHW tensor in."""
    cfg, params = tg.load_compact(TRAINED)
    net = tg.build_compact(cfg, params, cuda_device)
    aux = torch.from_numpy(_aux(40, 72, seed=6)).to(cuda_device)
    chw = aux.permute(0, 3, 1, 2).contiguous()
    act = net.activation(chw.permute(0, 2, 3, 1))
    assert torch.equal(act, net.activation(aux))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mid96 8-96-24", "mid128 8-128-128-8"])
def test_k7_wide_reads_strided_aux(name, cuda_device):
    """The wide instances on a permuted NCHW aux (the fused wide
    instance's cp.async staging instead of its tensor copy) give the
    contiguous aux's activation bit for bit."""
    cfg = _config(name)
    net = tg.build_compact(cfg, _params(cfg), cuda_device)
    aux = torch.from_numpy(_aux(40, 72, seed=6)).to(cuda_device)
    chw = aux.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        assert torch.equal(net.activation(chw.permute(0, 2, 3, 1)),
                           net.activation(aux))


@pytest.mark.cuda
def test_one_k7_launch_per_denoised_frame(cuda_device):
    tree = synthetic.make_synthetic_tree("shell", depth=5, basis_dim=9)
    dt = tt.upload_tree(tree, lut_levels=5, device=cuda_device)
    r = tr.Renderer(dt, 64, 48, 80.0, 80.0, options=_opt())
    r.set_denoiser(TRAINED)
    cam = Camera(width=64, height=48, fx=80.0, fy=80.0)
    native.reset_launches()
    for _ in range(3):
        r.render(cam.transform)
        r.advance_rng()
    torch.cuda.synchronize()
    assert native.LAUNCHES["guidance_net"] == 3
    assert native.LAUNCHES["render"] == 3


@pytest.mark.cuda
def test_k7_limits_raise_on_the_card(cuda_device):
    """What K7 refuses on the card; a 65-channel net, refused before the
    wide instances, now runs the fused wide instance (one launch) and
    holds to the plain version."""
    wide = tg.GuidanceNetConfig(mid_channels=65)
    net = tg.build_compact(wide, _params(wide), cuda_device)
    aux = torch.from_numpy(_aux(23, 41, seed=6)).to(cuda_device)
    native.reset_launches()
    with torch.no_grad():
        act = net.activation(aux)
    torch.cuda.synchronize()
    assert native.LAUNCHES["guidance_net_wide"] == 1
    assert native.LAUNCHES["guidance_net"] == 0
    assert act.shape == (1, 8, 23, 41)
    _hold_k7(net, aux)
    cfg, params = tg.load_compact(TRAINED)
    net = tg.build_compact(cfg, params, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        net.activation(torch.zeros(1, 8, 8, 8, device=cuda_device))
    net = tg.build_compact(cfg, params, cuda_device)
    with pytest.raises(ValueError, match="f32"):
        net.activation(torch.zeros(1, 8, 8, 8, device=cuda_device,
                                   dtype=torch.float16))
    with pytest.raises(ValueError, match="chain"):
        net.activation(torch.zeros(1, 8, 8, 6, device=cuda_device))
