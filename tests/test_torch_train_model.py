"""The port's trainable GuidanceNet, its fold and its .gnet writer against
the Flax package: forward with JAX's init carried across, compact_params
bit for bit, save_compact byte for byte, and the msgpack encoder on every
committed artifact."""

import glob
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_octree_tpu.models import guidance_net as jg
from rt_octree_tpu_torch.io.gnet_msgpack import packb, unpackb
from rt_octree_tpu_torch.models import guidance_net as tg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GNETS = sorted(glob.glob(os.path.join(REPO, "benchmarks", "**", "*.gnet"),
                         recursive=True) +
               glob.glob(os.path.join(REPO, "tests", "data", "*.gnet")))
# a tiny net: num_layers 3 gives a 8 -> 8 block (cin == cout, the identity
# branch and the o % cin fold), 2 branches, 3 levels
CFG = dict(mid_channels=8, num_layers=3, num_branches=2, kernel_levels=3)
# the wide path's 3-block net (--mid_channels 128 --num_layers 3): K7's
# per-block plan on the card
WIDE128 = dict(mid_channels=128, num_layers=3, kernel_levels=4)
H, W = 16, 16


@pytest.fixture(scope="module")
def net():
    """(JAX config, port config, JAX's init as NumPy, an aux batch)."""
    cfg_j, cfg_t = jg.GuidanceNetConfig(**CFG), tg.GuidanceNetConfig(**CFG)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jg.init_params(cfg_j, key, H, W))(
            jax.random.PRNGKey(0)))
    aux = np.random.default_rng(0).random((2, H, W, 8), np.float32)
    aux[..., 4:] = aux[..., :4] ** 2
    return cfg_j, cfg_t, params, aux


def _port_forward(cfg_t, params, aux, dtype):
    model = tg.GuidanceNet(cfg_t, dtype=dtype)
    model.load_state_dict(tg.params_from_numpy(cfg_t, params))
    with torch.no_grad():
        w, g = model(torch.from_numpy(aux))
    return w.numpy(), g.numpy()


def test_forward_f32_matches_flax(net):
    """f32 compute: only the convs' summation order differs."""
    cfg_j, cfg_t, params, aux = net
    wj, gj = jg.GuidanceNet(cfg_j, dtype=jnp.float32).apply(
        {"params": params}, jnp.asarray(aux))
    wt, gt = _port_forward(cfg_t, params, aux, torch.float32)
    np.testing.assert_allclose(wt, np.asarray(wj), atol=1e-5)
    np.testing.assert_allclose(gt, np.asarray(gj), atol=1e-5)


def test_forward_bf16_matches_flax(net):
    """bf16 compute with every branch, bias add, shortcut and relu6
    rounded where Flax rounds: the compact net's one-ulp bounds
    (test_torch_guidance_net.py) hold, guidance |g| <= 6 after relu6."""
    cfg_j, cfg_t, params, aux = net
    wj, gj = jg.GuidanceNet(cfg_j).apply({"params": params},
                                          jnp.asarray(aux))
    wt, gt = _port_forward(cfg_t, params, aux, torch.bfloat16)
    np.testing.assert_allclose(gt, np.asarray(gj), atol=8.0 / 256)
    np.testing.assert_allclose(wt, np.asarray(wj), atol=1.0 / 128)


def test_compact_params_bit_equal_and_folded_forward(net):
    """The fold equals JAX's bit for bit, and the folded model's f32
    forward equals the full model's (the fold is exact up to the convs'
    summation order)."""
    cfg_j, cfg_t, params, aux = net
    ref = jg.compact_params(cfg_j, params)
    got = tg.compact_params(cfg_t, params)
    assert list(got) == list(ref)
    for block in ref:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[block][leaf],
                                          np.asarray(ref[block][leaf]))
    full = _port_forward(cfg_t, params, aux, torch.float32)
    compact = tg.build_compact(cfg_t, got, "cpu", torch.float32)
    with torch.no_grad():
        folded = compact(torch.from_numpy(aux))
    for a, b in zip(folded, full):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)


def test_params_round_trip_through_the_state_dict(net):
    """params_to_numpy inverts params_from_numpy on the full and the
    compact tree; init_params draws Flax's init shapes, zero biases and
    kernels inside two of lecun_normal's sigmas."""
    _, cfg_t, params, _ = net
    back = tg.params_to_numpy(cfg_t, tg.params_from_numpy(cfg_t, params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    folded = tg.compact_params(cfg_t, params)
    back = tg.params_to_numpy(cfg_t, tg.params_from_numpy(cfg_t, folded))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(folded)):
        np.testing.assert_array_equal(a, b)
    init = tg.init_params(cfg_t, torch.Generator().manual_seed(0))
    assert jax.tree.structure(init) == jax.tree.structure(params)
    for (cin, _), i in zip(cfg_t.layer_channels(), range(3)):
        for name, leaf in init[f"block_{i}"].items():
            kh = leaf["kernel"].shape[0]
            sigma = np.sqrt(1.0 / (kh * kh * cin)) / .87962566103423978
            assert np.abs(leaf["kernel"]).max() <= 2 * sigma * (1 + 1e-6)
            assert not leaf["bias"].any()


@pytest.mark.parametrize("kw", [CFG, WIDE128], ids=["tiny", "wide128"])
def test_save_compact_is_byte_equal_to_jax(kw, tmp_path):
    """The port's .gnet equals JAX's save_compact of the same folded params
    (JAX's init of the tiny net and of the wide path's 3-block 128-wide
    net) and meta byte for byte, and both packages' load_compact read it
    back."""
    cfg_j, cfg_t = jg.GuidanceNetConfig(**kw), tg.GuidanceNetConfig(**kw)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jg.init_params(cfg_j, key, H, W))(
            jax.random.PRNGKey(0)))
    meta = {"denoise_recommended": False, "note": "test"}
    jg.save_compact(str(tmp_path / "j.gnet"), cfg_j,
                    jg.compact_params(cfg_j, params), meta=meta)
    folded = tg.compact_params(cfg_t, params)
    tg.save_compact(str(tmp_path / "t.gnet"), cfg_t, folded, meta=meta)
    assert (tmp_path / "t.gnet").read_bytes() == \
        (tmp_path / "j.gnet").read_bytes()
    cfg_r, params_r, meta_r = jg.load_compact(str(tmp_path / "t.gnet"),
                                              with_meta=True)
    assert cfg_r == cfg_j and meta_r == meta
    cfg_p, params_p, meta_p = tg.load_compact(str(tmp_path / "t.gnet"),
                                              with_meta=True)
    assert cfg_p == cfg_t and meta_p == meta
    for block in folded:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(np.asarray(params_r[block][leaf]),
                                          folded[block][leaf])
            np.testing.assert_array_equal(params_p[block][leaf],
                                          folded[block][leaf])


@pytest.mark.parametrize("path", GNETS,
                         ids=[os.path.relpath(p, REPO) for p in GNETS])
def test_packb_round_trips_committed_gnet(path):
    """packb(unpackb(blob)) is byte-equal to every committed artifact."""
    with open(path, "rb") as f:
        data = f.read()
    (hlen,) = struct.unpack("<I", data[8:12])
    json.loads(data[12:12 + hlen])
    blob = data[12 + hlen:]
    assert packb(unpackb(blob)) == blob


@pytest.mark.parametrize("obj", [
    {"a": 1, "b": [0, 127, 128, 255, 256, 65535, 65536, 1 << 33, -1, -32,
                   -33, -128, -129, -32768, -32769, -(1 << 33)],
     "c": {"d": None, "e": True, "f": False, "g": 0.1}},
    {"s" * 31: "x" * 32, "t" * 300: "y" * 70000, "l": list(range(16))},
    [b"", b"\x01" * 300, b"\x02" * 70000, tuple(range(70000))],
    {"arr": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
     "one": np.ones((1,), np.float32), "i": np.arange(3, dtype=np.int32)},
], ids=["ints", "strs", "bins", "ndarrays"])
def test_packb_matches_msgpack_and_flax(obj):
    """The smallest encodings, as msgpack-python picks them; ndarrays as
    flax.serialization.to_bytes writes them (keys in insertion order)."""
    import flax.serialization
    import msgpack
    if isinstance(obj, dict) and "arr" in obj:
        assert packb(obj) == flax.serialization.to_bytes(obj)
        back = unpackb(packb(obj))
        for k in obj:
            np.testing.assert_array_equal(back[k], obj[k])
    else:
        assert packb(obj) == msgpack.packb(obj, use_bin_type=True)


def test_train_step_f32_matches_jax(net):
    """One training step in f32 in both packages, same params and batch:
    the JAX package's loss (runner.py:_build_train_step, the fast filter
    path with its guard) and its gradients against the port's (K5 / K6's
    plain versions here).  The loss within 1e-6 relative; the gradients
    within rtol 1e-4, plus an atol of 1e-6 of each leaf's largest
    gradient for entries that cancel to near zero."""
    from rt_octree_tpu.ops.filtering import guided_filter_batch as jfilter
    from rt_octree_tpu.train.metrics import smape_loss as jsmape
    from rt_octree_tpu_torch.ops.filtering import guided_filter_batch
    from rt_octree_tpu_torch.train.metrics import smape_loss
    cfg_j, cfg_t, params, aux = net
    rs = np.random.default_rng(1)
    img_in = rs.random((2, H, W, 4), np.float32)
    img_gt = rs.random((2, H, W, 3), np.float32)
    model_j = jg.GuidanceNet(cfg_j, dtype=jnp.float32)

    def loss_of(p):
        w, g = model_j.apply({"params": p}, jnp.asarray(aux))
        out = jfilter(w, g, jnp.asarray(img_in), supports=cfg_j.supports())
        return jsmape(out[..., :3], jnp.asarray(img_gt))

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_of))(params)
    model = tg.GuidanceNet(cfg_t, dtype=torch.float32)
    model.load_state_dict(tg.params_from_numpy(cfg_t, params))
    w, g = model(torch.from_numpy(aux))
    out = guided_filter_batch(w, g, torch.from_numpy(img_in),
                              cfg_t.supports())
    loss = smape_loss(out[..., :3], torch.from_numpy(img_gt))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-6 * abs(float(loss_j))
    grads_t = tg.params_to_numpy(
        cfg_t, {n: p.grad for n, p in model.named_parameters()})
    for got, ref in zip(jax.tree.leaves(grads_t), jax.tree.leaves(grads_j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-6 * np.abs(ref).max())


def test_adam_and_lr_schedule_match_optax(net, tmp_path):
    """One fixed sequence of gradients, 2 epochs x 3 steps, through the
    port's Adam (weight decay 5e-4 before the moments, the lr from the
    update count) and the JAX package's Runner.make_optimizer chain: the
    parameters agree within 1e-6."""
    import optax
    from rt_octree_tpu.train.config import parse_args as jax_parse_args
    from rt_octree_tpu.train.runner import Runner as JaxRunner
    from rt_octree_tpu_torch.train.config import parse_args
    from rt_octree_tpu_torch.train.runner import Runner
    _, cfg_t, params, _ = net
    argv = ["--task", "compact", "--logs_root", str(tmp_path),
            "--mid_channels", "8", "--num_layers", "3", "--num_branches",
            "2", "--kernel_levels", "3", "--lr", "0.01", "--epochs", "2"]
    jr = JaxRunner(jax_parse_args(argv))
    jr._steps_per_epoch = 3
    opt = jr.make_optimizer()
    p_j = jax.tree.map(jnp.asarray, params)
    state = opt.init(p_j)
    update = jax.jit(opt.update)
    tr = Runner(parse_args(argv + ["--device", "cpu"]))
    tr.set_params(params)
    tr.optimizer = tr.make_optimizer()
    tr._steps_per_epoch = 3
    rs = np.random.default_rng(2)
    for _ in range(6):
        grads = jax.tree.map(lambda a: (rs.standard_normal(a.shape) * 0.1)
                             .astype(np.float32), params)
        upd, state = update(jax.tree.map(jnp.asarray, grads), state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        sd = tg.params_from_numpy(cfg_t, grads)
        for name, p in tr.model.named_parameters():
            p.grad = sd[name].clone()
        tr.optimizer_step()
    assert tr.update_count() == 6
    for got, ref in zip(jax.tree.leaves(tr.params()), jax.tree.leaves(p_j)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6)
