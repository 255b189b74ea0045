"""K1's statistics on the CPU: the plain march's per-ray step counts on
scenes whose counts are known, the statistics path (render_stats) against
the plain march, and the lane-efficiency arithmetic."""

import numpy as np
import pytest
import torch

from rt_octree_tpu_torch.core.camera import Camera
from rt_octree_tpu_torch.core.options import RenderOptions
from rt_octree_tpu_torch.io import synthetic
from rt_octree_tpu_torch.io.n3tree import BasisFormat, DataFormat, N3Tree
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.render import renderer as tr

torch.set_num_threads(1)


def _empty_root_tree():
    """A root with 8 empty leaves (sigma 0) filling the unit cube: tree
    space equals world space."""
    return N3Tree(data=np.zeros((8, 4), np.float16),
                  child=np.zeros(8, np.int32),
                  offset=np.zeros(3, np.float32),
                  scale=np.ones(3, np.float32), N=2, data_dim=4,
                  data_format=DataFormat(BasisFormat.RGBA, -1), capacity=1,
                  max_depth=1)


# (origin, direction): two rays along +x through the two halves of the cube,
# one pointing away from it, one passing beside it
RAYS = [((-1.0, 0.25, 0.25), (1.0, 0.0, 0.0)),
        ((-1.0, 0.75, 0.25), (1.0, 0.0, 0.0)),
        ((-1.0, 0.25, 0.25), (-1.0, 0.0, 0.0)),
        ((-1.0, 2.0, 0.25), (1.0, 0.0, 0.0))]


@pytest.mark.parametrize("lut_levels,steps,descents", [
    (0, [2, 2, 0, 0], [2, 2, 0, 0]),  # one step per half-cube leaf
    (1, [1, 1, 0, 0], [0, 0, 0, 0]),  # the skip distance leaves the cube
])
def test_plain_march_steps_on_a_known_scene(lut_levels, steps, descents):
    """Without the LUT each ray crosses the two empty leaves on its line,
    one chs read per step; the full-depth LUT carries the capped skip
    distance of an empty tree, which leaves the cube in one step.  Rays
    that miss the bbox take 0 steps."""
    dt = tt.upload_tree(_empty_root_tree(), lut_levels=lut_levels,
                        device="cpu")
    assert dt.skip_cap == (12 if lut_levels else 0)
    cens = torch.tensor([r[0] for r in RAYS], dtype=torch.float32)
    dirs = torch.tensor([r[1] for r in RAYS], dtype=torch.float32)
    dst = torch.full((len(RAYS), 2), 1e9)
    touched = {"lut": torch.zeros(dt.lut.shape[0], dtype=torch.bool),
               "chs": torch.zeros(8, dtype=torch.bool),
               "descents": torch.zeros(len(RAYS), dtype=torch.int32)}
    rec_ptr, rec_cnt, got = tr.march_plain(
        dt, dirs, cens, dst, RenderOptions(spp=2), touched=touched)
    assert got.tolist() == steps
    assert touched["descents"].tolist() == descents
    assert int(rec_cnt.sum()) == 0  # nothing to record in an empty tree
    if lut_levels:  # one read each, where the rays enter: (0, 0, 0), (0, 1, 0)
        assert torch.nonzero(touched["lut"]).flatten().tolist() == [0, 2]
    else:  # both halves of each line: child index (x * 2 + y) * 2 + z
        assert torch.nonzero(touched["chs"]).flatten().tolist() == \
            [0, 2, 4, 6]


def test_render_stats_plain_path_counts_what_the_frame_reads():
    tree = synthetic.make_synthetic_tree("shell", depth=4, basis_dim=4)
    cam = Camera(width=20, height=12, fx=30.0, fy=30.0)
    opt = RenderOptions(spp=4, denoise=False)
    kw = dict(width=20, height=12, fx=cam.fx, fy=cam.fy, opt=opt)
    tf = torch.from_numpy(cam.transform)
    for levels in (4, 2):
        dt = tt.upload_tree(tree, lut_levels=levels, device="cpu")
        st = tr.render_stats(dt, tf, 12345, 7, **kw)
        assert st.steps.shape == st.descents.shape == (12, 20)
        assert int(st.steps.min()) == 0 and int(st.steps.max()) > 4
        assert 0 < st.data_rows <= int((st.steps > 0).sum()) * opt.spp
        if levels == 4:  # full depth: every leaf is one LUT read away
            assert int(st.descents.sum()) == 0 and st.chs_rows == 0
            assert st.lut_cells > 0
        else:
            assert int(st.descents.sum()) > 0 and st.chs_rows > 0
        # the same frame's pixels as render_noisy
        st2 = {"lut": torch.zeros(dt.lut.shape[0], dtype=torch.bool),
               "chs": torch.zeros(dt.chs.shape[0], dtype=torch.bool),
               "data": torch.zeros(dt.chs.shape[0], dtype=torch.bool),
               "descents": torch.zeros(240, dtype=torch.int32)}
        img, _, _ = tr.render_noisy_plain(dt, tf, 12345, 7, stats=st2, **kw)
        assert torch.equal(img, tr.render_noisy(dt, tf, 12345, 7, **kw)[0])
        assert torch.equal(st2["steps"].reshape(12, 20), st.steps)


@pytest.mark.parametrize("tile,ref,ragged", [((32, 1), 0.25, 15 / 96),
                                             ((8, 4), 1.0, 15 / 32),
                                             ((4, 8), 1.0, 15 / 64)])
def test_lane_efficiency(tile, ref, ragged):
    """8 rows x 32 columns, 2 steps in columns 0..7, none elsewhere: a row
    of 32 is a warp that pays 32 x 2 for 8 x 2 steps, while 8x4 and 4x8
    tiles separate the busy columns from the idle ones.  On a 3x5 image
    of 1s the lanes past the edge idle: 3, 1 and 2 warps for 15 steps."""
    steps = torch.zeros((8, 32), dtype=torch.int32)
    steps[:, :8] = 2
    assert tr.lane_efficiency(steps, *tile) == pytest.approx(ref)
    ones = torch.ones((3, 5), dtype=torch.int32)
    assert tr.lane_efficiency(ones, *tile) == pytest.approx(ragged)
    assert tr.lane_efficiency(0 * ones, *tile) == 1.0
    with pytest.raises(ValueError):
        tr.lane_efficiency(steps, 4, 4)
