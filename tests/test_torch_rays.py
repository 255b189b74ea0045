"""The ray-batch API of the port (render/renderer.py: ``trace_rays`` and
``trace_rays_classic``, on the CPU their plain versions) against the JAX
package's trace_rays (``schedule=((0, 1),)``, no compaction: the same
rays, compiled faster) and trace_rays_classic, and against the NumPy
oracle (core/oracle.py, test-only).

Bars: trace_rays 2e-5, the JAX package's own (tests/test_render.py:353);
trace_rays_classic 1e-5, tests/test_torch_classic.py's bar of the classic
frame against JAX.  Every case aims most of its rays at the tree and
asserts that they hit (alpha > 0 on more than half of them).  Inputs are
made from a seed with NumPy; the JAX functions are jitted once a
configuration and reused."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_octree_tpu.core.options import RenderOptions as JRenderOptions
from rt_octree_tpu.io import synthetic
from rt_octree_tpu.ops import traversal as jt
from rt_octree_tpu.render import renderer as jr
from rt_octree_tpu_torch.core.options import RenderOptions
from rt_octree_tpu_torch.io import synthetic as psynthetic
from rt_octree_tpu_torch.ops import traversal as tt
from rt_octree_tpu_torch.render import renderer as tr
from rt_octree_tpu_torch.utils.rng import make_sorted_dst

torch.set_num_threads(1)

TOL, CLASSIC_TOL = 2e-5, 1e-5
R = 256
NO_COMPACTION = ((0, 1),)
MAX_STEPS = 512


@functools.lru_cache(maxsize=None)
def _jax_trace(max_steps):
    return jax.jit(functools.partial(jr.trace_rays, max_steps=max_steps,
                                     schedule=NO_COMPACTION),
                   static_argnames=("opt",))


@functools.lru_cache(maxsize=None)
def _jax_classic(max_steps, unroll):
    return jax.jit(functools.partial(jr.trace_rays_classic,
                                     max_steps=max_steps, unroll=unroll),
                   static_argnames=("opt",))


@functools.lru_cache(maxsize=None)
def _trees(name, lut_levels, force=False):
    """(host tree, port upload on the CPU, JAX upload) of a named tree."""
    if name == "shell4":
        tree = synthetic.make_synthetic_tree("shell", depth=4, basis_dim=4)
    elif name == "shell5":
        tree = synthetic.make_synthetic_tree("shell", depth=5, basis_dim=9)
    else:  # blobs in NDC
        tree = synthetic.make_synthetic_tree("blobs", depth=4, basis_dim=4)
        tree.use_ndc = True
        tree.ndc_width, tree.ndc_height, tree.ndc_focal = 1008.0, 756.0, 800.0
    kw = dict(lut_levels=lut_levels, force_sparse_brick=force)
    return (tree, tt.upload_tree(tree, device="cpu", **kw),
            jt.upload_tree(tree, **kw))


def _aimed(seed, n=R):
    """n unit rays of ``synthetic.aimed_rays`` (the shells' walls): dirs
    and their origins."""
    d, _, o = psynthetic.aimed_rays(np.random.default_rng(seed), n)
    return d, o


def _dst(seed, spp, n=R):
    u = np.random.default_rng(seed).random((n, spp), dtype=np.float32)
    return make_sorted_dst(torch.from_numpy(u))


def _jopt(spp=2, **kw):
    return jr.FrozenOptions.from_options(JRenderOptions(spp=spp, **kw))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _both(name, lut, d, v, c, dst, tmax=None, force=False,
          max_steps=MAX_STEPS):
    """(port, JAX) trace_rays on the same inputs, as NumPy."""
    _, dt, dj = _trees(name, lut, force)
    spp = dst.shape[1]
    got = tr.trace_rays(dt, _t(d), _t(v), _t(c), dst, RenderOptions(spp=spp),
                        tmax_bg=None if tmax is None else _t(tmax),
                        max_steps=max_steps)
    ref = _jax_trace(max_steps)(
        dj, jnp.asarray(d), jnp.asarray(v), jnp.asarray(c),
        jnp.asarray(dst.numpy()), opt=_jopt(spp),
        tmax_bg=None if tmax is None else jnp.asarray(tmax))
    return got.numpy(), np.asarray(ref)


def _hits(out):
    """Most rays hit the tree."""
    assert np.isfinite(out).all()
    assert (out[:, 3] > 0).mean() > 0.5


@pytest.mark.parametrize("spp", [1, 2, 6])
def test_trace_rays_matches_jax(spp):
    d, c = _aimed(1)
    got, ref = _both("shell4", 4, d, d, c, _dst(2, spp))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    _hits(got)


def test_tmax_bg_finite_inf_and_past_1e9():
    """A world depth on every ray: finite ones that cut through the shell,
    inf and 3e9 on others (no 1e9 clamp: they trace as without a mesh)."""
    d, c = _aimed(3)
    tmax = np.random.default_rng(4).uniform(2.0, 3.5, R).astype(np.float32)
    tmax[::4] = np.inf
    tmax[1::8] = 3e9
    dst = _dst(5, 2)
    got, ref = _both("shell4", 4, d, d, c, dst, tmax)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    _hits(got)
    free, _ = _both("shell4", 4, d, d, c, dst)
    far = ~np.isfinite(tmax) | (tmax > 1e9)
    assert np.array_equal(got[far], free[far])
    assert np.abs(got - free).max() > 1e-3  # the clip bites


@pytest.mark.parametrize("case", ["rotated vdirs", "non-unit dirs"])
def test_view_dirs_and_unnormalised_rays_match_jax(case):
    """vdirs rotated away from dirs (the basis takes them as given); dirs
    and vdirs scaled by 0.5-2 (the march takes 1 / |dir * scale|, the
    basis the vdir as it is)."""
    d, c = _aimed(6)
    if case == "rotated vdirs":
        v = np.array(jr.rodrigues_jnp(jnp.asarray([0.3, -0.5, 0.8],
                                                    jnp.float32),
                                        jnp.asarray(d)))
    else:
        rs = np.random.default_rng(7)
        d = d * rs.uniform(0.5, 2.0, (R, 1)).astype(np.float32)
        v = d * rs.uniform(0.5, 2.0, (R, 1)).astype(np.float32)
    got, ref = _both("shell4", 4, d, v, c, _dst(8, 2))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    _hits(got)
    same, _ = _both("shell4", 4, d / np.linalg.norm(d, axis=1,
                                                    keepdims=True),
                    d, c, _dst(8, 2))
    assert np.abs(got - same).max() > 1e-3  # the vdirs moved the colour


def test_ndc_rays_match_jax():
    """An LLFF blobs tree in NDC: a 16x16 camera's rays warped by the
    port's maybe_world2ndc, the view dirs unwarped."""
    from rt_octree_tpu_torch.core.camera import Camera
    _, dt, _ = _trees("blobs", 4)
    cam = Camera(width=16, height=16, fx=60.0, fy=60.0)
    cam.center = np.array([0.02, 0.01, 0.3], np.float32)
    cam.v_back = np.array([0.0, 0.0, 1.0], np.float32)
    cam.v_world_up = np.array([0.0, 1.0, 0.0], np.float32)
    cam.update()
    dirs, cens = tr.device_camera_rays(_t(cam.transform[:3, :4]), 16, 16,
                                       cam.fx, cam.fy)
    wd, wc = tr.maybe_world2ndc(dt, dirs, cens)
    got, ref = _both("blobs", 4, wd.numpy(), dirs.numpy(), wc.numpy(),
                     _dst(9, 6, 256))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    _hits(got)


@pytest.mark.parametrize("tree,lut,force", [("shell4", 0, False),
                                            ("shell4", 2, True)],
                         ids=["no LUT", "partial LUT"])
def test_lut_layouts_match_jax(tree, lut, force):
    """No LUT (every step descends from the root), and a partial LUT at
    level 2 of the depth-4 shell with skip distances over its marked
    cells."""
    _, dt, _ = _trees(tree, lut, force)
    assert dt.lut_levels == lut and (dt.skip_cap > 0) == force
    d, c = _aimed(10)
    got, ref = _both(tree, lut, d, d, c, _dst(11, 2), force=force)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    _hits(got)


@pytest.mark.parametrize("max_steps", [7, 8192])
@pytest.mark.parametrize("unroll", [1, 2, 3])
def test_trace_rays_classic_matches_jax(unroll, max_steps):
    """The step limit tested every ``unroll`` steps: at max_steps 7 a ray
    takes up to 7, 8 or 9 steps."""
    _, dt, dj = _trees("shell5", 5)
    d, c = _aimed(12)
    got = tr.trace_rays_classic(dt, _t(d), _t(d), _t(c), RenderOptions(),
                                max_steps=max_steps, unroll=unroll).numpy()
    ref = np.asarray(_jax_classic(max_steps, unroll)(
        dj, jnp.asarray(d), jnp.asarray(d), jnp.asarray(c), opt=_jopt()))
    np.testing.assert_allclose(got, ref, atol=CLASSIC_TOL, rtol=0)
    _hits(got)


def test_classic_step_limit_rounds_up_to_unroll():
    """A ray of the plain classic march takes ceil(max_steps / unroll) *
    unroll steps at most, and the rounding changes the result."""
    _, dt, _ = _trees("shell5", 5)
    d, c = _aimed(12)
    outs = []
    for unroll, limit in ((1, 7), (2, 8), (3, 9)):
        out, steps = tr.march_classic_plain(dt, _t(d), _t(d), _t(c),
                                            RenderOptions(), max_steps=7,
                                            unroll=unroll)
        assert int(steps.max()) == limit
        outs.append(out)
    assert not torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[1], outs[2])


def test_mesh_depth_clip_matches_oracle():
    """tests/test_render.py:314-360 on the port: a 12x12 camera's rays on
    the depth-4 shell without a LUT, each clipped at a depth that cuts
    through the shell, against the oracle's per-ray march; the clip must
    bite somewhere."""
    from rt_octree_tpu.core.camera import Camera as JCamera
    from rt_octree_tpu.core.camera import camera_rays
    from rt_octree_tpu.core.oracle import trace_ray
    from rt_octree_tpu.utils.rng import Pcg32 as JPcg32
    tree, dt, _ = _trees("shell4", 0)
    cam = JCamera(width=12, height=12, fx=40.0, fy=40.0)
    opt = JRenderOptions(spp=2, denoise=False)
    dirs, origin = camera_rays(cam)
    n = dirs.shape[0]
    depth = np.linspace(4.2, 5.2, n).astype(np.float32)
    rng = JPcg32(20230418)
    cen = tree.offset + tree.scale * origin
    outs, full = np.zeros((n, 4), np.float32), np.zeros((n, 4), np.float32)
    uniforms = np.zeros((n, opt.spp), np.float32)
    for i in range(n):
        for dst_row, tmax in ((outs, float(depth[i])), (full, 1e9)):
            r = rng.copy()
            r.advance(i * opt.spp)
            dst_row[i] = trace_ray(tree, dirs[i], dirs[i], cen, opt, tmax, r,
                                   opt.spp)
        r = rng.copy()
        r.advance(i * opt.spp)
        uniforms[i] = [r.next_float() for _ in range(opt.spp)]
    got = tr.trace_rays(dt, _t(dirs), _t(dirs), _t(np.tile(origin, (n, 1))),
                        make_sorted_dst(_t(uniforms)),
                        RenderOptions(spp=2, denoise=False),
                        tmax_bg=_t(depth), max_steps=512).numpy()
    np.testing.assert_allclose(got, outs, atol=TOL, rtol=0)
    _hits(got)
    assert np.abs(full - outs).max() > 1e-3


def _good(n=8, spp=2):
    d, c = _aimed(13, n)
    return _t(d), _t(d), _t(c), _dst(14, spp, n)


@pytest.mark.parametrize("bad", [
    "dirs shape", "vdirs shape", "cens dtype", "dst rows", "dst 1-d",
    "dst no spp", "tmax shape", "tmax dtype", "not contiguous", "no rays",
    "numpy dirs", "other device"])
def test_bad_inputs_raise(bad):
    """Every refusal is a ValueError, on the CPU as on the card: shapes,
    dtypes, devices, contiguity, an empty batch."""
    _, dt, _ = _trees("shell4", 4)
    d, v, c, dst = _good()
    tmax = None
    if bad == "dirs shape":
        d = d[:, :2].contiguous()
    elif bad == "vdirs shape":
        v = v[:4]
    elif bad == "cens dtype":
        c = c.double()
    elif bad == "dst rows":
        dst = dst[:7]
    elif bad == "dst 1-d":
        dst = dst[:, 0].contiguous()
    elif bad == "dst no spp":
        dst = dst[:, :0]
    elif bad == "tmax shape":
        tmax = torch.ones((8, 1))
    elif bad == "tmax dtype":
        tmax = torch.ones(8, dtype=torch.float16)
    elif bad == "not contiguous":
        d = torch.empty((3, 8)).T.copy_(d)
    elif bad == "no rays":
        d, v, c, dst = d[:0], v[:0], c[:0], dst[:0]
    elif bad == "numpy dirs":
        d = d.numpy()
    elif bad == "other device":
        v = v.to("meta")
    with pytest.raises(ValueError):
        tr.trace_rays(dt, d, v, c, dst, RenderOptions(spp=2), tmax_bg=tmax)
    if not bad.startswith("dst"):
        with pytest.raises(ValueError):
            tr.trace_rays_classic(dt, d, v, c, RenderOptions(), tmax_bg=tmax)


def test_classic_refuses_unroll_below_one():
    _, dt, _ = _trees("shell4", 4)
    d, v, c, _ = _good()
    with pytest.raises(ValueError):
        tr.trace_rays_classic(dt, d, v, c, RenderOptions(), unroll=0)


def test_scheduling_arguments_are_accepted_and_ignored():
    """schedule, phase1_steps, compact_frac and shade_cap_div tune the JAX
    package's compaction; the port's result is the same with any."""
    _, dt, _ = _trees("shell4", 4)
    d, v, c, dst = _good(32, 6)
    opt = RenderOptions(spp=6)
    ref = tr.trace_rays(dt, d, v, c, dst, opt)
    assert torch.equal(ref, tr.trace_rays(
        dt, d, v, c, dst, opt, schedule=((8, 1), (0, 4)), phase1_steps=8,
        compact_frac=4, shade_cap_div=2))
    _hits(ref.numpy())
