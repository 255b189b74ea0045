"""The port's .gnet reader and compact GuidanceNet vs the Flax package."""

import glob
import os

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from rt_octree_tpu.models import guidance_net as jg
from rt_octree_tpu_torch.io.gnet_msgpack import unpackb
from rt_octree_tpu_torch.models import guidance_net as tg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GNETS = sorted(glob.glob(os.path.join(REPO, "benchmarks", "*", "*.gnet")) +
               glob.glob(os.path.join(REPO, "tests", "data", "*.gnet")))


def test_every_committed_gnet_is_found():
    assert len(GNETS) >= 9


@pytest.mark.parametrize("path", GNETS,
                         ids=[os.path.relpath(p, REPO) for p in GNETS])
def test_gnet_decodes_like_flax(path):
    cfg_j, params_j, meta_j = jg.load_compact(path, with_meta=True)
    cfg_t, params_t, meta_t = tg.load_compact(path, with_meta=True)
    assert dataclasses_equal(cfg_j, cfg_t)
    assert meta_t == meta_j
    assert set(params_t) == set(params_j)
    for block in params_j:
        for leaf in ("kernel", "bias"):
            ref = np.asarray(params_j[block][leaf])
            got = params_t[block][leaf]
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


def dataclasses_equal(a, b) -> bool:
    fields = ("in_channels", "mid_channels", "num_layers", "num_branches",
              "kernel_levels", "identity_level")
    return all(getattr(a, f) == getattr(b, f) for f in fields) and \
        a.supports() == b.supports() and \
        a.layer_channels() == b.layer_channels()


@pytest.mark.parametrize("obj", [
    {"a": 1, "b": [1, -1, -33, 300, -300, 70000, -70000, 1 << 40],
     "c": {"d": None, "e": True, "f": False}},
    {"s" * 40: "x" * 300, "f": 1.5, "g": [0.25] * 20},
    [b"\x00\x01" * 200, "é", list(range(20))],
], ids=["ints", "strs", "bins"])
def test_msgpack_subset_matches_msgpack(obj):
    assert unpackb(msgpack.packb(obj, use_bin_type=True)) == obj


def test_msgpack_single_float_and_trailing_bytes():
    assert unpackb(msgpack.packb(2.5, use_single_float=True)) == 2.5
    with pytest.raises(ValueError):
        unpackb(msgpack.packb(1) + b"\x00")


def _forward_pair(path, dtype_j, dtype_t, H=24, W=20):
    cfg, params = jg.load_compact(path)
    rs = np.random.default_rng(0)
    aux = rs.random((1, H, W, 8), np.float32)
    aux[..., 4:] = aux[..., :4] ** 2
    wj, gj = jg.GuidanceNetCompact(cfg, dtype=dtype_j).apply(
        {"params": params}, jnp.asarray(aux))
    cfg_t, params_t = tg.load_compact(path)
    model = tg.build_compact(cfg_t, params_t, "cpu", dtype_t)
    with torch.no_grad():
        wt, gt = model(torch.from_numpy(aux))
    return (np.asarray(wj), np.asarray(gj)), (wt.numpy(), gt.numpy())


TRAINED = os.path.join(REPO, "benchmarks", "quality", "trained.gnet")


def test_forward_f32_matches_flax():
    """f32 compute: the convs' summation order is the only difference."""
    (wj, gj), (wt, gt) = _forward_pair(TRAINED, jnp.float32, torch.float32)
    np.testing.assert_allclose(wt, wj, atol=1e-5)
    np.testing.assert_allclose(gt, gj, atol=1e-5)
    np.testing.assert_allclose(wt.sum(1), 1.0, atol=1e-6)


def test_forward_bf16_matches_flax():
    """bf16 compute, as both packages ship it: the bias is added after the
    conv in bf16 where Flax adds it, but a rounding may still land
    elsewhere, so the bound is one bf16 ulp (2^-8 relative) of the
    largest guidance value (|g| < 8)."""
    (wj, gj), (wt, gt) = _forward_pair(TRAINED, jnp.bfloat16,
                                       torch.bfloat16)
    np.testing.assert_allclose(gt, gj, atol=8.0 / 256)
    np.testing.assert_allclose(wt, wj, atol=1.0 / 128)


def test_params_from_numpy_is_hwio_to_oihw():
    cfg = tg.GuidanceNetConfig(mid_channels=4, kernel_levels=2)
    rs = np.random.default_rng(2)
    params = {f"block_{i}": {
        "kernel": rs.standard_normal((3, 3, cin, cout)).astype(np.float32),
        "bias": rs.standard_normal(cout).astype(np.float32)}
        for i, (cin, cout) in enumerate(cfg.layer_channels())}
    sd = tg.params_from_numpy(cfg, params)
    k = params["block_0"]["kernel"]
    np.testing.assert_array_equal(sd["convs.0.weight"].numpy()[2, 5, 0, 1],
                                  k[0, 1, 5, 2])
    params["block_1"]["bias"] = params["block_1"]["bias"][:1]
    with pytest.raises(ValueError):
        tg.params_from_numpy(cfg, params)


def test_identity_level_supports():
    assert tg.GuidanceNetConfig(identity_level=True).supports() == \
        (0, 1, 2, 3)
    assert tg.GuidanceNetConfig().supports() == (1, 2, 3, 4)


def test_bad_magic_is_refused(tmp_path):
    p = tmp_path / "x.gnet"
    p.write_bytes(b"NOTAGNET" + b"\x00" * 16)
    with pytest.raises(ValueError):
        tg.load_compact(str(p))
