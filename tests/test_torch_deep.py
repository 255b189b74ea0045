"""Deep trees in the port: upload_tree's partial LUT with empty-space skip
against the JAX package's upload, and its frames against the NumPy oracle.

Where the JAX package anchors a deep tree's LUT at its sparse-brick level
(N = 2, depth > 9 or ``force_sparse_brick``; level min(lut_levels, depth -
2, 9)), the port anchors it at the same level and writes LUT_INTERNAL_MARK
into the sigma lane of the cells still internal there (JAX: brick index +
1), so that both bake the same skip distances.  Frames: the JAX package's
oracle bar, 2e-5 (tests/test_deep_tree.py), apart from the f32 threshold
tie named in TIES."""

import dataclasses

import numpy as np
import pytest
import torch

from rt_octree_tpu.core.camera import Camera
from rt_octree_tpu.core.options import RenderOptions
from rt_octree_tpu.core.oracle import render_frame_oracle
from rt_octree_tpu.io import synthetic
from rt_octree_tpu.ops import traversal as jt
from rt_octree_tpu.utils.rng import Pcg32 as JPcg32
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.render import renderer as tr

torch.set_num_threads(1)

TOL = 2e-5


@pytest.fixture(scope="module")
def chain10():
    return synthetic.make_deep_chain_tree(depth=10, basis_dim=1)


@pytest.fixture(scope="module")
def tree6():
    return synthetic.make_synthetic_tree("shell", depth=6, basis_dim=4)


@pytest.fixture(scope="module")
def refined6():
    """tests/test_deep_tree.py:92-110: the depth-4 shell refined 2 levels."""
    base = synthetic.make_synthetic_tree("shell", depth=4, basis_dim=4)
    thickness = max(3.0 / 2 ** 4, 0.02)
    return synthetic.refine_tree(
        base, lambda p: synthetic.shell_sigma(p, thickness=thickness,
                                              amplitude=4.0 / thickness),
        synthetic.position_color, levels=2)


# (tree fixture, upload keywords, the JAX LUT level, skip distances baked)
UPLOADS = {
    "chain d10, lut 9": ("chain10", dict(lut_levels=9), 8, True),
    "tree6 forced, lut 4": ("tree6", dict(lut_levels=4,
                                          force_sparse_brick=True), 4, True),
    "chain d10, CLI default lut 7": ("chain10", dict(lut_levels=7), 7,
                                     False),
}


@pytest.fixture(scope="module")
def upload(request):
    """The port's upload_tree on the CPU, once per (tree, keywords)."""
    cache = {}

    def get(name, **kw):
        key = (name, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = tt.upload_tree(request.getfixturevalue(name),
                                        device="cpu", **kw)
        return cache[key]
    return get


@pytest.mark.parametrize("case", list(UPLOADS))
def test_upload_agrees_with_jax(case, request, upload):
    name, kw, levels, skip = UPLOADS[case]
    dj = jt.upload_tree(request.getfixturevalue(name), **kw)
    dp = upload(name, **kw)
    assert dp.lut_levels == dj.lut_levels == levels
    assert dp.skip_cap == dj.skip_cap == (12 if skip else 0)
    lut_j = np.asarray(dj.lut)
    lut_p = dp.lut.numpy()
    np.testing.assert_array_equal(lut_p[:, 0], lut_j[:, 0])
    depth = (lut_j[:, 0].view(np.uint32) >> tt.LUT_PTR_BITS) & 31
    internal = depth == tt.LUT_DEPTH_SENTINEL
    assert internal.any()
    # shallow cells: the leaf's sigma bits or JAX's skip distance
    np.testing.assert_array_equal(lut_p[~internal, 1], lut_j[~internal, 1])
    if skip:
        assert (lut_j[~internal, 1] > 0).any()  # some cell carries a distance
        lanes = lut_p[internal, 1]
        assert (lanes == tt.LUT_INTERNAL_MARK).all()
        assert ((lanes != 0) & ((lanes < 1) | (lanes > 255))).all()
    else:
        np.testing.assert_array_equal(lut_p[internal, 1], 0)


def _frame(dt, size=24, spp=2):
    """The port's plain frame (K1's plain version) from the oracle's camera
    and PCG32 seed."""
    cam = Camera(width=size, height=size, fx=40.0, fy=40.0)
    opt = RenderOptions(spp=spp, denoise=False)
    r = tr.Renderer(dt, size, size, 40.0, 40.0, options=opt, max_steps=1024)
    return r.render(cam.transform)[0].numpy(), cam, opt


# Pixels where the oracle and an f32 march part at a threshold tie.  The
# oracle runs t and the optical depth in float64, the port in f32 as the
# reference's CUDA does.  On the refined shell, ray (11, 12)'s second
# sample threshold is 2.6996608: the oracle's depth reaches 2.6996638 at
# leaf step 16, the port's 2.6996563 (19 f32 ulps short), so the port
# records the next leaf and the pixel moves 0.0063 in red and blue.  The
# JAX package's jitted frame lands on the oracle's side; its own step
# compiled alone lands on the port's (2.6996594).  The march without any
# LUT, which the partial-LUT skip does not touch, gives the same pixel.
TIES = {"chain10": [], "refined6": [[11, 12]]}


@pytest.mark.parametrize("name,kw", [
    ("chain10", dict(lut_levels=9)),
    ("refined6", dict(lut_levels=4, force_sparse_brick=True))])
def test_partial_lut_skip_frames_match_the_oracle(name, kw, request,
                                                  upload):
    """The partial-LUT skip frame within 2e-5 of the same upload with
    skip_cap=0 and of the march without a LUT, and of the oracle (which
    marches without skip) on every pixel but the f32 ties of TIES."""
    tree = request.getfixturevalue(name)
    dt = upload(name, **kw)
    assert dt.skip_cap == 12 and dt.lut_levels == tree.max_depth - 2
    img, cam, opt = _frame(dt)
    no_skip = _frame(upload(name, skip_cap=0, **kw))[0]
    descent = _frame(upload(name, lut_levels=0))[0]
    np.testing.assert_allclose(img, no_skip, atol=TOL)
    np.testing.assert_allclose(img, descent, atol=TOL)
    ref, _ = render_frame_oracle(tree, cam, opt, JPcg32(20230418))
    off = np.abs(img - ref).max(-1) > TOL
    assert np.argwhere(off).tolist() == TIES[name]
    np.testing.assert_allclose(img[~off], ref[~off], atol=TOL)
    np.testing.assert_array_equal(img[off], descent[off])
    np.testing.assert_array_equal(img[off][:, 3], ref[off][:, 3])
    assert img[..., 3].max() > 0.1  # the tree is in view


def test_k1_ignores_the_marker(upload):
    """With skip_cap=0 the plain frame on the marked LUT equals, bit for
    bit, the frame on the same LUT without the marker: the march descends
    from an internal cell and never reads its lane as a leaf's sigma."""
    marked = upload("refined6", lut_levels=4, skip_cap=0,
                    force_sparse_brick=True)
    plain_lut = tt.build_lut(marked.chs, 2, 4)
    assert (marked.lut[:, 1] == tt.LUT_INTERNAL_MARK).any()
    assert not torch.equal(marked.lut, plain_lut)
    assert torch.equal(marked.lut[:, 0], plain_lut[:, 0])
    unmarked = dataclasses.replace(marked, lut=plain_lut)
    for spp in (2, 6):
        a = _frame(marked, spp=spp)[0]
        b = _frame(unmarked, spp=spp)[0]
        np.testing.assert_array_equal(a, b)
