"""The classic kernel's host side on the CPU: the choice of its instance
(``classic_layout``, one instance a row layout of csrc/render.cu), the
instance codes and the RenderParams mirror against the CUDA source, and
the shaded-step count of the plain march that the kernel's statistics
instance is held to on the card (tests/test_torch_kernels.py)."""

import ctypes
import os
import re
import types

import numpy as np
import pytest
import torch

from rt_octree_tpu_torch.core.camera import Camera
from rt_octree_tpu_torch.core.options import RenderOptions
from rt_octree_tpu_torch.io import synthetic
from rt_octree_tpu_torch.io.n3tree import BasisFormat, DataFormat
from rt_octree_tpu_torch.native import build as native
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.render import renderer as tr

torch.set_num_threads(1)

RENDER_CU = os.path.join(os.path.dirname(tr.__file__), os.pardir, "csrc",
                         "render.cu")
SH_DIMS = (1, 4, 9, 16, 25)


def _render_cu_int(name):
    """The value of csrc/render.cu's ``constexpr int`` ``name``."""
    return int(re.search(rf"\b{name}\s*=\s*(\d+)\s*;",
                         open(RENDER_CU).read()).group(1))


def _expected(fmt, bd):
    """The instance each layout takes, or None where the kernel has none."""
    if bd < 0:
        return "rgba"
    if fmt == BasisFormat.SH.value:
        return f"sh{bd}" if bd in SH_DIMS else None
    if bd <= 25:
        return "any"
    return ("wide" if bd <= _render_cu_int("kWideSmemMaxBasis")
            else "wide_chunked")


@pytest.mark.parametrize("bd", [-3, -1, 0, 1, 2, 4, 5, 9, 16, 24, 25, 26,
                                32, 40, 41, 48, 80, 88, 89, 100, 216, 217,
                                400])
@pytest.mark.parametrize("fmt", [f.value for f in BasisFormat])
def test_classic_layout_for_every_format_and_basis_dim(fmt, bd):
    """SH rows take the instance of their basis_dim (1, 4, 9, 16, 25),
    raw rgb rows (basis_dim < 0) "rgba" whatever the format, SG, ASG and
    RGBA-format rows with a basis_dim the unrolled "any" instance up to 25,
    the shared-memory "wide" instance above it up to csrc/render.cu's
    kWideSmemMaxBasis (40, where --wide-sweep puts the switch) and the
    "wide_chunked" instance past it, at any basis_dim (its basis past the
    shared prefix evaluated row by row); other SH basis_dims are
    refused."""
    data_dim = 3 * max(bd, 1) + 1
    want = _expected(fmt, bd)
    if want is None:
        with pytest.raises(ValueError):
            tr.classic_layout(fmt, bd, data_dim)
    else:
        assert tr.classic_layout(fmt, bd, data_dim) == want


@pytest.mark.parametrize("fmt,bd,data_dim", [
    (4, 9, 28),  # no such basis format
    (-1, -1, 4),
    (BasisFormat.SH.value, 9, 26),  # rows shorter than 27 coefficients
    (BasisFormat.SG.value, 25, 74),
    (BasisFormat.RGBA.value, -1, 2),  # fewer than 3 channels
])
def test_classic_layout_refuses_what_no_instance_reads(fmt, bd, data_dim):
    with pytest.raises(ValueError):
        tr.classic_layout(fmt, bd, data_dim)


def _layout_trees():
    """A depth-4 shell in each row layout, as (tree, instance)."""
    out = [(synthetic.make_synthetic_tree("shell", depth=4, basis_dim=bd),
            f"sh{bd}") for bd in SH_DIMS]
    rgba = synthetic.make_synthetic_tree("shell", depth=4, basis_dim=1)
    rgba.data_format = DataFormat(BasisFormat.RGBA, -1)
    out.append((rgba, "rgba"))
    for fmt in (BasisFormat.SG, BasisFormat.ASG):
        t = synthetic.make_synthetic_tree("shell", depth=4, basis_dim=4)
        t.data_format = DataFormat(fmt, 4)
        out.append((t, "any"))
        out.append((synthetic.with_lobes(synthetic.make_synthetic_tree(
            "shell", depth=3, basis_dim=32), fmt, 1), "wide"))
    out.append((synthetic.with_lobes(synthetic.make_synthetic_tree(
        "shell", depth=3, basis_dim=96), BasisFormat.SG, 1), "wide_chunked"))
    out.append((synthetic.with_lobes(synthetic.make_synthetic_tree(
        "shell", depth=3, basis_dim=48), BasisFormat.ASG, 1), "wide_chunked"))
    return out


def test_uploaded_trees_take_their_layouts_instance():
    """Each layout's uploaded tree names its instance, and every instance
    is some layout's."""
    seen = set()
    for tree, want in _layout_trees():
        dt = tt.upload_tree(tree, lut_levels=2, device="cpu")
        assert tr.classic_layout(dt.fmt, dt.basis_dim, dt.data_dim) == want
        seen.add(want)
    assert seen == set(tr.CLASSIC_LAYOUTS)


def test_instance_codes_follow_the_cuda_enum():
    """CLASSIC_LAYOUTS[i] is csrc/render.cu's ClassicLayout value i + 1
    (the code the wrapper passes in RenderParams.classic); the unrolled
    "any" instance holds basis_dim <= kMaxBasis = CLASSIC_MAX_BASIS in
    registers, the wide one up to kWideSmemMaxBasis =
    CLASSIC_WIDE_MAX_BASIS in shared memory and the chunked one takes the
    rest: classic_layout and is_wide at the boundaries, and the "_wide"
    launch names of K1, render_classic and their ray modes (and
    render_classic's "_wide_chunked")."""
    src = open(RENDER_CU).read()
    body = re.search(r"enum ClassicLayout : int \{(.*?)\};", src, re.S)
    names = re.findall(r"kClassic(\w+)", body.group(1))
    assert re.search(r"kClassicSh1 = 1\b", body.group(1))
    # CamelCase to the layout's name: WideChunked -> wide_chunked
    assert [re.sub(r"(?<=.)([A-Z])", r"_\1", n).lower()
            for n in names] == list(tr.CLASSIC_LAYOUTS)
    assert re.search(r"kMaxBasis\s*=\s*(\d+)\s*;", src).group(1) == str(
        tr.CLASSIC_MAX_BASIS)
    assert re.search(r"kWideSmemMaxBasis\s*=\s*(\d+)\s*;", src).group(
        1) == str(tr.CLASSIC_WIDE_MAX_BASIS)
    # the host's choice at the boundary, for both lobe formats
    bd = tr.CLASSIC_MAX_BASIS
    for fmt in (BasisFormat.SG, BasisFormat.ASG):
        assert tr.classic_layout(fmt.value, bd, 4 * bd) == "any"
        assert tr.classic_layout(fmt.value, bd + 1, 4 * bd + 4) == "wide"
    assert not tr.is_wide(types.SimpleNamespace(basis_dim=bd))
    assert tr.is_wide(types.SimpleNamespace(basis_dim=bd + 1))
    bd = tr.CLASSIC_WIDE_MAX_BASIS
    for fmt in (BasisFormat.SG, BasisFormat.ASG):
        assert tr.classic_layout(fmt.value, bd, 4 * bd) == "wide"
        assert tr.classic_layout(fmt.value, bd + 1,
                                 4 * bd + 4) == "wide_chunked"
    for name in ("render", "render_classic", "render_rays",
                 "render_classic_rays"):
        assert {name, name + "_wide"} <= set(native.LAUNCHES)
    for name in ("render_classic", "render_classic_rays"):
        assert name + "_wide_chunked" in native.LAUNCHES


def test_render_params_mirror_follows_the_cuda_struct():
    """The ctypes mirror names RenderParams' members in the source's order
    (arrays by their element name), with the C types' sizes."""
    src = open(RENDER_CU).read()
    body = re.search(r"struct RenderParams \{(.*?)\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        # "type name", "type a, b" or "type name[n]": the last word of
        # each comma-separated piece
        for piece in line.split(","):
            name = piece.split()[-1].lstrip("*")
            fields.append(re.sub(r"\[\d+\]", "", name))
    assert fields == [f[0] for f in tr._RenderParams._fields_]
    assert ctypes.sizeof(tr._RenderParams) % 8 == 0


def _frame(w=24, h=24):
    cam = Camera(width=w, height=h, fx=40.0 * w / 24, fy=40.0 * w / 24)
    return torch.from_numpy(cam.transform), dict(width=w, height=h,
                                                 fx=cam.fx, fy=cam.fy)


@pytest.mark.parametrize("stop", [1e-2, 0.3, 1e-6])
def test_plain_march_counts_shaded_steps(stop):
    """The classic statistics carry per-ray shaded steps: at most the
    steps, none on a ray that takes none, more with a lower stop_thresh;
    one data row per shaded step at most (distinct rows)."""
    dt = tt.upload_tree(synthetic.make_synthetic_tree("shell", depth=4,
                                                      basis_dim=4),
                        lut_levels=4, device="cpu")
    tf, kw = _frame()
    opt = RenderOptions(spp=1, denoise=False, estimator="classic",
                        stop_thresh=stop)
    st = tr.render_stats(dt, tf, 0, 0, opt=opt, **kw)
    assert st.shaded is not None and st.shaded.shape == st.steps.shape
    assert bool((st.shaded <= st.steps).all())
    assert int(st.shaded[st.steps == 0].sum()) == 0
    assert 0 < st.data_rows <= int(st.shaded.sum())
    lo = tr.render_stats(dt, tf, 0, 0, opt=RenderOptions(
        spp=1, denoise=False, estimator="classic", stop_thresh=stop / 10),
        **kw)
    assert int(lo.shaded.sum()) >= int(st.shaded.sum())


def test_shaded_steps_are_the_steps_that_meet_density():
    """On a tree whose every leaf has sigma 5, every step shades until the
    stop; with sigma_thresh 10, no step shades and the frame is the
    background's."""
    tree = synthetic.make_synthetic_tree("shell", depth=3, basis_dim=1)
    tree.data[:, tree.data_dim - 1] = np.float16(5.0)
    dt = tt.upload_tree(tree, lut_levels=3, device="cpu", skip_cap=0)
    tf, kw = _frame(12, 12)
    opt = RenderOptions(spp=1, denoise=False, estimator="classic")
    st = tr.render_stats(dt, tf, 0, 0, opt=opt, **kw)
    assert torch.equal(st.shaded, st.steps) and int(st.steps.sum()) > 0
    opt.sigma_thresh = 10.0
    st = tr.render_stats(dt, tf, 0, 0, opt=opt, **kw)
    assert int(st.shaded.sum()) == 0 and st.data_rows == 0
    img = tr.render_noisy(dt, tf, 0, 0, opt=opt, **kw)[0]
    assert bool((img == opt.background_brightness).all())


def test_regular_tracker_statistics_carry_no_shaded_steps():
    dt = tt.upload_tree(synthetic.make_synthetic_tree("shell", depth=3,
                                                      basis_dim=1),
                        lut_levels=3, device="cpu")
    tf, kw = _frame(12, 12)
    st = tr.render_stats(dt, tf, 1, 1, opt=RenderOptions(spp=2), **kw)
    assert st.shaded is None
    assert st.equals(tr.render_stats_plain(dt, tf, 1, 1,
                                           opt=RenderOptions(spp=2), **kw))
