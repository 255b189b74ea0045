"""The port's multi-device module (rt_octree_tpu_torch/parallel) on CPU
ranks over gloo, against the port's single process and the JAX package's
rt_octree_tpu/parallel/mesh.py on the conftest's 8 virtual devices.

Each world (1, 2 and 4 ranks) is launched once a module, in a
module-scoped fixture: one spawn runs every port-side case in every rank
(``_world_cases``) and the tests compare what the ranks returned in the
parent.  The ranks import this module, so its own imports are numpy,
torch and pytest only; JAX is imported inside the tests, and every rank
checks that no JAX and no JAX-package module entered its process.

Tolerances are those of tests/test_parallel.py: the frame's img 2e-5 and
aux 4e-5 against JAX, img 2e-4 with the denoiser; the train step's loss
rtol 2e-5.  Against the port's single process the noisy frame is bit for
bit (K1's plain band is the frame's rows), the denoised one within K2's
bar 1e-5.  The train step's parameters after one Adam step are held
within 1e-6 (1 % of a step at lr 1e-4) in f32; in bf16, the training
numerics, each rank's weight gradient is rounded to bf16 before the
average, so the averaged gradient is held within 2^-7 of the tensor's
largest gradient, and the loss within rtol 2e-5.

JAX's renderers take ``schedule=((0, 1),)`` (no compaction: the same
frame, compiled faster).

The sharded ray tracer (``render_rays_sharded``) runs the dry run's batch
(__graft_entry__.dryrun_multichip: 64 random unit rays from (-2, 0, 2)
through the depth-3 shell without a LUT, SPP 2, max_steps 64; it hits the
tree twice) and a batch of 64 aimed at the shell, in every world: bit for
bit the single process's ``trace_rays`` (a ray's result is its own), and
within the img bar 2e-5 of JAX's render_rays_sharded on 4 virtual devices
(its default compacting schedule).  A batch of 65, which JAX refuses on 4
devices, is refused by every rank of the worlds of 2 and 4, and a batch
whose vdirs are short by every rank of every world."""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2, 4)
NO_COMPACTION = ((0, 1),)
IMG_TOL, AUX_TOL, DENOISED_TOL, K2_TOL = 2e-5, 4e-5, 2e-4, 1e-5
LOSS_RTOL, PARAM_TOL, BF16_GRAD_REL = 2e-5, 1e-6, 2.0 ** -7
SEED = 20230418
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rt_octree_tpu")
# the net of tests/test_parallel.py: 8 -> 8 -> 4 channels, supports 1, 2
# (halo 4), and its identity-level twin (supports 0, 1)
NET = dict(in_channels=8, mid_channels=8, num_layers=2, num_branches=2,
           kernel_levels=2)
# name -> (tree, W, H, fx, spp, estimator, denoise, identity_level, scale)
FRAMES = {
    "rt": ("shell3", 16, 16, 30.0, 2, "rt", False, False, 1.0),
    "rt denoise": ("shell3", 16, 16, 30.0, 2, "rt", True, False, 1.0),
    "fast s=0.5": ("shell3", 32, 32, 60.0, 2, "rt", True, False, 0.5),
    "classic identity": ("shell3", 16, 16, 30.0, 1, "classic", True, True,
                         1.0),
    "lod d3": ("lod3", 16, 16, 30.0, 2, "rt", False, False, 1.0),
}
# (W, H, render_scale) that the JAX package refuses on 2 or 4 devices
BAD_SIZES = ((16, 18, 1.0), (32, 30, 0.5), (16, 18, 0.9), (17, 16, 1.0))
TRAIN_B, TRAIN_HW = 4, 16
MAX_STEPS = 256
# the sharded ray tracer's batches and their settings (the dry run's)
RAY_LABELS = ("dry run", "aimed")
RAY_R, RAY_SPP, RAY_MAX_STEPS = 64, 2, 64


def _port_tree(name):
    from rt_octree_tpu_torch.io import synthetic
    from rt_octree_tpu_torch.io.lod import build_lod
    if name == "shell3":
        return synthetic.make_synthetic_tree("shell", depth=3, basis_dim=4)
    return build_lod(synthetic.make_synthetic_tree("shell", depth=4,
                                                   basis_dim=4), 3)


def _options(spp, estimator, denoise):
    from rt_octree_tpu_torch.core.options import RenderOptions
    return RenderOptions(spp=spp, denoise=denoise, estimator=estimator)


def _transform(W, H, fx):
    from rt_octree_tpu_torch.core.camera import Camera
    return Camera(width=W, height=H, fx=fx, fy=fx).transform


def _train_inputs():
    rng = np.random.default_rng(0)
    B, S = TRAIN_B, TRAIN_HW
    return (rng.random((B, 8, S, S), np.float32),
            rng.random((B, S, S, 4), np.float32),
            rng.random((B, S, S, 4), np.float32))


def _ray_batches():
    """label -> (dirs, vdirs, cens, uniforms) of RAY_R rays, and "65": the
    aimed batch and one more ray (a size JAX refuses on 4 devices)."""
    from rt_octree_tpu_torch.io import synthetic
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((RAY_R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cens = np.tile(np.array([[-2.0, 0.0, 2.0]], np.float32), (RAY_R, 1))
    uniforms = rng.random((RAY_R, RAY_SPP)).astype(np.float32) * \
        np.float32(0.99)
    rs = np.random.default_rng(1)
    d, _, o = synthetic.aimed_rays(rs, RAY_R + 1, spread=0.4)
    aimed = (d, d, o, rs.random((RAY_R + 1, RAY_SPP)).astype(np.float32))
    return {"dry run": (dirs, dirs, cens, uniforms),
            "aimed": tuple(a[:RAY_R] for a in aimed), "65": aimed}


def _world_cases(dev, net_params, compact):
    """Every port-side case in one rank: the mesh, each frame of FRAMES,
    the factory's size checks and one train step in bf16 and in f32 ->
    a dict of CPU results."""
    import torch.distributed as dist
    from rt_octree_tpu_torch.models.guidance_net import (GuidanceNetConfig,
                                                         build_compact)
    from rt_octree_tpu_torch.ops import traversal as tt
    from rt_octree_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(device_type=dev.type)
    out = {"rank": dist.get_rank(), "mesh": tuple(mesh.shape),
           "flat": pm.flat_rank(mesh), "frames": {}, "errors": {},
           "train": {}}
    trees = {}
    for label, (tree, W, H, fx, spp, est, den, ident, scale) in \
            FRAMES.items():
        if tree not in trees:
            trees[tree] = tt.upload_tree(_port_tree(tree), lut_levels=3,
                                         device=dev)
        net = build_compact(GuidanceNetConfig(**NET, identity_level=ident),
                            compact, dev) if den else None
        frame = pm.make_sharded_frame_renderer(
            mesh, trees[tree], W, H, fx, fx, _options(spp, est, den),
            max_steps=MAX_STEPS, net=net, render_scale=scale)
        img, aux = frame(_transform(W, H, fx), _rng_state())
        out["frames"][label] = (img.cpu(), aux.cpu())
    for W, H, scale in BAD_SIZES:
        try:
            pm.make_sharded_frame_renderer(
                mesh, trees["shell3"], W, H, 30.0, 30.0,
                _options(2, "rt", False), render_scale=scale)
        except ValueError as e:
            out["errors"][(W, H, scale)] = str(e)
    rays = _ray_batches()
    dry = tt.upload_tree(_port_tree("shell3"), lut_levels=0, device=dev)
    opt = _options(RAY_SPP, "rt", False)
    out["rays"] = {label: pm.render_rays_sharded(
        mesh, dry, *rays[label], opt, max_steps=RAY_MAX_STEPS).cpu()
        for label in RAY_LABELS}
    try:
        pm.render_rays_sharded(mesh, dry, *rays["65"], opt,
                               max_steps=RAY_MAX_STEPS)
        out["rays 65"] = None
    except ValueError as e:
        out["rays 65"] = str(e)
    d, v, c, u = rays["aimed"]
    try:
        pm.render_rays_sharded(mesh, dry, d, v[:-4], c, u, opt,
                               max_steps=RAY_MAX_STEPS)
        out["rays short vdirs"] = None
    except ValueError as e:
        out["rays short vdirs"] = str(e)
    aux, img_in, img_gt = (torch.from_numpy(a) for a in _train_inputs())
    cfg = GuidanceNetConfig(**NET)
    for dtype in (torch.bfloat16, torch.float32):
        step, model, _ = pm.make_sharded_train_step(mesh, cfg,
                                                    params=net_params,
                                                    dtype=dtype)
        loss = step(aux, img_in, img_gt)
        out["train"][str(dtype)] = (
            float(loss),
            {k: p.grad.cpu() for k, p in model.named_parameters()},
            {k: p.detach().cpu() for k, p in model.named_parameters()})
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in FORBIDDEN)
    return out


def _rng_state():
    from rt_octree_tpu_torch.utils.rng import Pcg32
    return Pcg32(SEED).state


def _raise_in_rank_one(dev):
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise RuntimeError("rank one fails on purpose")
    dist.barrier()


def _hang(dev):
    import time
    time.sleep(600)


# ---------------------------------------------------------------------------
# fixtures: JAX's init, the worlds, the references
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    import jax
    from rt_octree_tpu.models.guidance_net import (
        GuidanceNetConfig, compact_params, init_params)
    cfg = GuidanceNetConfig(**NET)
    params = _plain(init_params(cfg, jax.random.PRNGKey(0)))
    return params, _plain(compact_params(cfg, params))


def _plain(tree):
    """A params tree as nested dicts of NumPy arrays (what a rank can
    unpickle without flax)."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _single_frames(jax_params):
    """Each frame of FRAMES by the port's single-process Renderer."""
    from rt_octree_tpu_torch.models.guidance_net import GuidanceNetConfig
    from rt_octree_tpu_torch.ops import traversal as tt
    from rt_octree_tpu_torch.render.renderer import Renderer
    out = {}
    for label, (tree, W, H, fx, spp, est, den, ident, scale) in \
            FRAMES.items():
        dt = tt.upload_tree(_port_tree(tree), lut_levels=3, device="cpu")
        r = Renderer(dt, W, H, fx, fx, options=_options(spp, est, den),
                     max_steps=MAX_STEPS, render_scale=scale)
        if den:
            r.set_denoiser(GuidanceNetConfig(**NET, identity_level=ident),
                           jax_params[1])
        out[label] = r.render(_transform(W, H, fx))
    return out


def _jax_frames(jax_params):
    """Each frame of FRAMES by the JAX package's sharded renderer on 4 of
    the virtual devices."""
    import jax.numpy as jnp
    from rt_octree_tpu.core.options import RenderOptions
    from rt_octree_tpu.io import lod, synthetic
    from rt_octree_tpu.models.guidance_net import GuidanceNetConfig
    from rt_octree_tpu.ops.traversal import upload_tree
    from rt_octree_tpu.parallel.mesh import (make_mesh,
                                             make_sharded_frame_renderer)
    from rt_octree_tpu.render.renderer import FrozenOptions
    shell3 = synthetic.make_synthetic_tree("shell", depth=3, basis_dim=4)
    trees = {"shell3": upload_tree(shell3, lut_levels=3),
             "lod3": upload_tree(lod.build_lod(synthetic.make_synthetic_tree(
                 "shell", depth=4, basis_dim=4), 3), lut_levels=3)}
    mesh = make_mesh(4)
    state = _rng_state()
    out = {}
    for label, (tree, W, H, fx, spp, est, den, ident, scale) in \
            FRAMES.items():
        opt = RenderOptions(spp=spp, denoise=den, estimator=est)
        frame = make_sharded_frame_renderer(
            mesh, trees[tree], W, H, fx, fx, FrozenOptions.from_options(opt),
            max_steps=MAX_STEPS, schedule=NO_COMPACTION,
            net_cfg=GuidanceNetConfig(**NET, identity_level=ident)
            if den else None, net_params=jax_params[1] if den else None,
            render_scale=scale)
        img, aux = frame(jnp.asarray(_transform(W, H, fx)),
                         jnp.uint32(state >> 32),
                         jnp.uint32(state & 0xFFFFFFFF))
        out[label] = (np.asarray(img), np.asarray(aux))
    return out


def _single_rays():
    """Each ray batch by the port's single-process trace_rays."""
    from rt_octree_tpu_torch.ops import traversal as tt
    from rt_octree_tpu_torch.render.renderer import trace_rays
    from rt_octree_tpu_torch.utils.rng import make_sorted_dst
    dt = tt.upload_tree(_port_tree("shell3"), lut_levels=0, device="cpu")
    rays = _ray_batches()
    out = {}
    for label in RAY_LABELS:
        d, v, c, u = (torch.from_numpy(a) for a in rays[label])
        out[label] = trace_rays(dt, d, v, c, make_sorted_dst(u),
                                _options(RAY_SPP, "rt", False),
                                max_steps=RAY_MAX_STEPS)
    return out


def _jax_rays():
    """Each ray batch by the JAX package's sharded ray tracer on 4 of the
    virtual devices (render_rays_sharded is make_sorted_dst then this
    tracer; one tracer compiles once for both batches), and the error of
    its render_rays_sharded on the batch of 65."""
    import jax.numpy as jnp
    from rt_octree_tpu.core.options import RenderOptions
    from rt_octree_tpu.io import synthetic
    from rt_octree_tpu.ops.traversal import upload_tree
    from rt_octree_tpu.parallel.mesh import (make_mesh,
                                             make_sharded_ray_tracer,
                                             render_rays_sharded)
    from rt_octree_tpu.render.renderer import FrozenOptions, make_sorted_dst
    dt = upload_tree(synthetic.make_synthetic_tree("shell", depth=3,
                                                   basis_dim=4),
                     lut_levels=0)
    mesh = make_mesh(4)
    opt = FrozenOptions.from_options(RenderOptions(spp=RAY_SPP,
                                                   denoise=False))
    tracer = make_sharded_ray_tracer(mesh, dt, opt, RAY_MAX_STEPS)
    rays = _ray_batches()
    out = {}
    for label in RAY_LABELS:
        d, v, c, u = rays[label]
        out[label] = np.asarray(tracer(jnp.asarray(d), jnp.asarray(v),
                                       jnp.asarray(c),
                                       make_sorted_dst(jnp.asarray(u))))
    try:
        render_rays_sharded(mesh, dt, *rays["65"][:3],
                            jnp.asarray(rays["65"][3]), opt,
                            max_steps=RAY_MAX_STEPS)
        out["65"] = None
    except ValueError as e:
        out["65"] = str(e)
    return out


def _jax_loss(jax_params):
    """The JAX package's sharded train step's loss on 4 virtual devices."""
    import jax.numpy as jnp
    from rt_octree_tpu.models.guidance_net import GuidanceNetConfig
    from rt_octree_tpu.parallel.mesh import make_mesh, make_sharded_train_step
    step, optimizer = make_sharded_train_step(make_mesh(4),
                                              GuidanceNetConfig(**NET))
    params = jax_params[0]
    _, _, loss = step(params, optimizer.init(params),
                      *(jnp.asarray(a) for a in _train_inputs()))
    return float(loss)


def _single_steps(jax_params):
    """One train step of the port's single process, bf16 and f32: (loss,
    grads, params after Adam)."""
    from rt_octree_tpu_torch.models.guidance_net import (
        GuidanceNet, GuidanceNetConfig, params_from_numpy)
    from rt_octree_tpu_torch.ops.filtering import guided_filter_batch
    from rt_octree_tpu_torch.train.metrics import smape_loss
    cfg = GuidanceNetConfig(**NET)
    aux, img_in, img_gt = (torch.from_numpy(a) for a in _train_inputs())
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = GuidanceNet(cfg, dtype=dtype)
        model.load_state_dict(params_from_numpy(cfg, jax_params[0]))
        opt = torch.optim.Adam(model.parameters(), lr=1e-4,
                               betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=5e-4)
        w, g = model(aux.permute(0, 2, 3, 1))
        res = guided_filter_batch(w, g, img_in, cfg.supports())
        loss = smape_loss(res[..., :3], img_gt[..., :3])
        loss.backward()
        opt.step()
        out[str(dtype)] = (float(loss.detach()),
                           {k: p.grad for k, p in model.named_parameters()},
                           {k: p.detach() for k, p in
                            model.named_parameters()})
    return out


@pytest.fixture(scope="module")
def runs(jax_params):
    """The three worlds, launched at once in threads, while the parent
    computes the references: {"worlds": {world: [rank values]},
    "single_frames", "jax_frames", "jax_loss", "single_steps"}."""
    from concurrent.futures import ThreadPoolExecutor
    from rt_octree_tpu_torch.parallel.launch import launch
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {w: pool.submit(launch, _world_cases, w, backend="gloo",
                                  device="cpu", args=jax_params,
                                  timeout_s=240)
                   for w in WORLDS}
        out = {"jax_frames": _jax_frames(jax_params),
               "jax_loss": _jax_loss(jax_params),
               "jax_rays": _jax_rays(),
               "single_frames": _single_frames(jax_params),
               "single_steps": _single_steps(jax_params),
               "single_rays": _single_rays()}
        out["worlds"] = {w: f.result() for w, f in futures.items()}
    return out


@pytest.fixture(scope="module")
def worlds(runs):
    return runs["worlds"]


@pytest.fixture(scope="module")
def single_frames(runs):
    return runs["single_frames"]


@pytest.fixture(scope="module")
def jax_frames(runs):
    return runs["jax_frames"]


@pytest.fixture(scope="module")
def jax_loss(runs):
    return runs["jax_loss"]


@pytest.fixture(scope="module")
def single_steps(runs):
    return runs["single_steps"]


@pytest.fixture(scope="module")
def jax_rays(runs):
    return runs["jax_rays"]


@pytest.fixture(scope="module")
def single_rays(runs):
    return runs["single_rays"]


# ---------------------------------------------------------------------------
# the mesh and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shape_matches_jax(n):
    from rt_octree_tpu.parallel.mesh import make_mesh
    from rt_octree_tpu_torch.parallel.mesh import mesh_shape
    assert mesh_shape(n) == tuple(make_mesh(n).devices.shape)


@pytest.mark.parametrize("world", WORLDS)
def test_rank_meshes_flatten_as_jax(worlds, world):
    """Every rank's DeviceMesh has JAX's (dp, sp), and its flat index
    dp_index * sp + sp_index is its rank."""
    from rt_octree_tpu_torch.parallel.mesh import mesh_shape
    for r, o in enumerate(worlds[world]):
        assert o["rank"] == r and o["flat"] == r
        assert o["mesh"] == mesh_shape(world)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_no_jax(worlds, world):
    assert [o["modules"] for o in worlds[world]] == [[]] * world


def test_launch_raises_a_ranks_error_within_its_deadline():
    from rt_octree_tpu_torch.parallel.launch import launch
    with pytest.raises(Exception, match="rank one fails on purpose"):
        launch(_raise_in_rank_one, 2, backend="gloo", device="cpu",
               timeout_s=120)


def test_launch_stops_hung_ranks_at_its_deadline():
    import time
    from rt_octree_tpu_torch.parallel.launch import launch
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        launch(_hang, 2, backend="gloo", device="cpu", timeout_s=5)
    assert time.monotonic() - t0 < 35


def test_launch_refuses_what_cannot_serve_the_ranks():
    from rt_octree_tpu_torch.parallel.launch import launch
    for kw in (dict(backend="nccl", device="cpu"),
               dict(backend="mpi", device="cpu"),
               dict(backend="gloo", device="tpu")):
        with pytest.raises(ValueError):
            launch(_hang, 2, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            launch(_hang, 1, backend="gloo", device="cuda")


# ---------------------------------------------------------------------------
# the band geometry
# ---------------------------------------------------------------------------

def test_halo_of_the_committed_nets():
    """Two blocks and the ladder 1..4: 6 rows; the identity-level nets'
    supports 0..3: 5 rows."""
    import glob
    from rt_octree_tpu_torch.models.guidance_net import load_compact
    from rt_octree_tpu_torch.parallel.mesh import halo
    nets = glob.glob(os.path.join(REPO, "benchmarks", "*", "*.gnet"))
    assert len(nets) >= 8
    for p in nets:
        cfg = load_compact(p)[0]
        assert (cfg.num_layers, cfg.kernel_levels) == (2, 4)
        assert halo(cfg) == (5 if cfg.identity_level else 6)


def test_bands_tile_the_frame_and_crops_clamp():
    """n = 4 at H = 16 with the test net's halo 4: every crop reaches an
    image edge, the first and last only one."""
    from rt_octree_tpu_torch.models.guidance_net import GuidanceNetConfig
    from rt_octree_tpu_torch.parallel.mesh import band, crop, halo
    h = halo(GuidanceNetConfig(**NET))
    assert h == 4
    bands = [band(r, 4, 16) for r in range(4)]
    assert bands == [(0, 4), (4, 8), (8, 12), (12, 16)]
    assert [crop(*b, h, 16) for b in bands] == [(0, 8), (0, 12), (4, 16),
                                                (8, 16)]


@pytest.mark.parametrize("size", BAD_SIZES)
@pytest.mark.parametrize("n", [2, 4])
def test_size_checks_match_jax(size, n):
    """The same sizes refused with the same message as JAX's factory, and
    the same accepted."""
    from rt_octree_tpu.core.options import RenderOptions
    from rt_octree_tpu.parallel.mesh import (make_mesh,
                                             make_sharded_frame_renderer)
    from rt_octree_tpu.render.renderer import FrozenOptions
    from rt_octree_tpu_torch.parallel.mesh import inner_size
    W, H, scale = size
    try:
        make_sharded_frame_renderer(
            make_mesh(n), None, W, H, 30.0, 30.0,
            FrozenOptions.from_options(RenderOptions()), render_scale=scale)
        want = None
    except ValueError as e:
        want = str(e)
    except Exception:  # past the checks: the tree is None
        want = None
    try:
        inner_size(n, W, H, scale)
        got = None
    except ValueError as e:
        got = str(e)
    assert got == want


@pytest.mark.parametrize("world", WORLDS)
def test_factory_refuses_the_sizes_jax_refuses(worlds, world):
    from rt_octree_tpu_torch.parallel.mesh import inner_size
    for o in worlds[world]:
        for W, H, scale in BAD_SIZES:
            try:
                inner_size(world, W, H, scale)
                want = None
            except ValueError as e:
                want = str(e)
            assert o["errors"].get((W, H, scale)) == want
    assert worlds[4][0]["errors"]


# ---------------------------------------------------------------------------
# the sharded frame
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", list(FRAMES))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_frame_matches_single(worlds, single_frames, world, label):
    """aux bit for bit (K1's plain band is the frame's rows); img bit for
    bit without the denoiser, within K2's bar with it; every rank holds the
    same frame."""
    img1, aux1 = single_frames[label]
    denoise = FRAMES[label][6]
    for o in worlds[world]:
        img, aux = o["frames"][label]
        assert img.shape == img1.shape and aux.shape == aux1.shape
        assert torch.equal(aux, aux1)
        if denoise:
            torch.testing.assert_close(img, img1, atol=K2_TOL, rtol=0)
        else:
            assert torch.equal(img, img1)
        assert torch.equal(img, worlds[world][0]["frames"][label][0])


@pytest.mark.parametrize("label", list(FRAMES))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_frame_matches_jax(worlds, jax_frames, world, label):
    img_j, aux_j = jax_frames[label]
    img, aux = worlds[world][0]["frames"][label]
    assert np.isfinite(img.numpy()).all()
    np.testing.assert_allclose(
        img.numpy(), img_j, rtol=0,
        atol=DENOISED_TOL if FRAMES[label][6] else IMG_TOL)
    np.testing.assert_allclose(aux.numpy(), aux_j, atol=AUX_TOL, rtol=0)


def test_frames_see_the_tree_and_the_denoiser(worlds):
    frames = worlds[1][0]["frames"]
    for img, aux in frames.values():
        assert float(aux[3].max()) > 0.5  # rays hit the shell
    noisy = frames["rt"][0]
    assert float((frames["rt denoise"][0] - noisy).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# the sharded ray tracer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", RAY_LABELS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_rays_match_single(worlds, single_rays, world, label):
    """Every rank holds the single process's trace_rays bit for bit."""
    for o in worlds[world]:
        assert torch.equal(o["rays"][label], single_rays[label])


@pytest.mark.parametrize("label", RAY_LABELS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_rays_match_jax(worlds, jax_rays, world, label):
    got = worlds[world][0]["rays"][label].numpy()
    assert got.shape == (RAY_R, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_rays[label], atol=IMG_TOL, rtol=0)


def test_aimed_rays_hit_and_the_dry_run_mostly_misses(single_rays):
    """The aimed batch hits the shell on most rays; the dry run's batch,
    on a few only (why it does not stand alone)."""
    assert float((single_rays["aimed"][:, 3] > 0).float().mean()) > 0.5
    assert float((single_rays["dry run"][:, 3] > 0).float().mean()) < 0.2


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_rays_refuse_what_jax_refuses(worlds, jax_rays, world):
    """65 rays: JAX's sharding on 4 devices refuses them; every rank of a
    world they do not divide raises ValueError (world 1 takes them)."""
    assert "divisible by 4" in jax_rays["65"]
    for o in worlds[world]:
        if world == 1:
            assert o["rays 65"] is None
        else:
            assert f"divisible by {world}" in o["rays 65"]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_rays_refuse_unequal_rows(worlds, world):
    """vdirs 4 rays short of dirs: every rank raises ValueError before it
    traces (a short input on one rank alone would leave the others
    waiting in the gather)."""
    for o in worlds[world]:
        assert "they must all have R" in o["rays short vdirs"]
        assert "[64, 60, 64, 64]" in o["rays short vdirs"]


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_loss_matches_jax(worlds, jax_loss, world):
    for o in worlds[world]:
        np.testing.assert_allclose(o["train"][str(torch.bfloat16)][0],
                                   jax_loss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_single_in_f32(worlds, single_steps, world):
    """The loss within rtol 2e-5 and every parameter after one Adam step
    within 1e-6 of the single process's; every rank holds the same."""
    loss1, _, params1 = single_steps[str(torch.float32)]
    for o in worlds[world]:
        loss, _, params = o["train"][str(torch.float32)]
        np.testing.assert_allclose(loss, loss1, rtol=LOSS_RTOL)
        for k, p in params1.items():
            torch.testing.assert_close(params[k], p, atol=PARAM_TOL, rtol=0)
            assert torch.equal(params[k],
                               worlds[world][0]["train"][str(
                                   torch.float32)][2][k])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_single_in_bf16(worlds, single_steps, world):
    """The training numerics: the loss within rtol 2e-5, the averaged
    gradient within 2^-7 of each tensor's largest gradient (each rank's
    weight gradient is rounded to bf16 before the average)."""
    loss1, grads1, _ = single_steps[str(torch.bfloat16)]
    for o in worlds[world]:
        loss, grads, _ = o["train"][str(torch.bfloat16)]
        np.testing.assert_allclose(loss, loss1, rtol=LOSS_RTOL)
        for k, g in grads1.items():
            bar = BF16_GRAD_REL * float(g.abs().max())
            assert float((grads[k] - g).abs().max()) <= bar, k


# ---------------------------------------------------------------------------
# on the card: K1's bands, K7 and K2 on halo crops, K5 and K6 in the step
# ---------------------------------------------------------------------------

# world -> backend: one rank on nccl, several ranks on one card over gloo
CARD_WORLDS = {1: "nccl", 2: "gloo", 4: "gloo"}
# name -> (W, H, render_scale, estimator, the kernels of one frame)
CARD_FRAMES = {
    "rt denoise": (64, 64, 1.0, "rt",
                   {"render": 1, "guidance_net": 1, "guided_filter": 1}),
    "fast s=0.5": (64, 64, 0.5, "rt",
                   {"render": 1, "upsample": 1, "guidance_net": 1,
                    "guided_filter": 1}),
    "classic": (64, 64, 1.0, "classic",
                {"render_classic": 1, "guidance_net": 1,
                 "guided_filter": 1}),
}


def _card_tree():
    from rt_octree_tpu_torch.io import synthetic
    return synthetic.make_synthetic_tree("shell", depth=5, basis_dim=9)


def _card_net_params():
    from rt_octree_tpu_torch.models.guidance_net import (
        GuidanceNetConfig, compact_params, init_params)
    cfg = GuidanceNetConfig(**NET)
    params = init_params(cfg, torch.Generator().manual_seed(3))
    return params, compact_params(cfg, params)


def _card_cases(dev):
    """Every card case in one rank: each frame of CARD_FRAMES with its
    launch counts, and one train step in bf16 and f32 with the step's
    launches."""
    from rt_octree_tpu_torch.models.guidance_net import (GuidanceNetConfig,
                                                         build_compact)
    from rt_octree_tpu_torch.native import build as native
    from rt_octree_tpu_torch.ops import traversal as tt
    from rt_octree_tpu_torch.parallel import mesh as pm
    mesh = pm.make_mesh()
    params, compact = _card_net_params()
    dt = tt.upload_tree(_card_tree(), lut_levels=5, device=dev)
    out = {"frames": {}, "train": {}}
    for label, (W, H, scale, est, _) in CARD_FRAMES.items():
        frame = pm.make_sharded_frame_renderer(
            mesh, dt, W, H, 80.0, 80.0, _options(6, est, True),
            max_steps=8192, net=build_compact(GuidanceNetConfig(**NET),
                                              compact, dev),
            render_scale=scale)
        native.reset_launches()
        img, aux = frame(_transform(W, H, 80.0), _rng_state())
        torch.cuda.synchronize()
        out["frames"][label] = (img.cpu(), aux.cpu(), {
            k: v for k, v in native.LAUNCHES.items() if v})
    aux, img_in, img_gt = (torch.from_numpy(a) for a in _train_inputs())
    for dtype in (torch.bfloat16, torch.float32):
        step, model, _ = pm.make_sharded_train_step(
            mesh, GuidanceNetConfig(**NET), params=params, dtype=dtype)
        native.reset_launches()
        loss = step(aux, img_in, img_gt)
        torch.cuda.synchronize()
        out["train"][str(dtype)] = (
            float(loss),
            {k: p.grad.cpu() for k, p in model.named_parameters()},
            {k: p.detach().cpu() for k, p in model.named_parameters()},
            {k: v for k, v in native.LAUNCHES.items() if v})
    return out


@pytest.fixture(scope="module")
def card_runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rt_octree_tpu_torch.parallel.launch import launch
    return {w: launch(_card_cases, w, backend=b, device="cuda",
                      timeout_s=300)
            for w, b in CARD_WORLDS.items()}


@pytest.fixture(scope="module")
def card_single():
    """The single process on the card: each frame by the Renderer, and the
    train step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rt_octree_tpu_torch.models.guidance_net import (
        GuidanceNet, GuidanceNetConfig, params_from_numpy)
    from rt_octree_tpu_torch.ops import traversal as tt
    from rt_octree_tpu_torch.ops.filtering import guided_filter_batch
    from rt_octree_tpu_torch.render.renderer import Renderer
    from rt_octree_tpu_torch.train.metrics import smape_loss
    params, compact = _card_net_params()
    cfg = GuidanceNetConfig(**NET)
    dt = tt.upload_tree(_card_tree(), lut_levels=5, device="cuda")
    out = {"frames": {}, "train": {}}
    for label, (W, H, scale, est, _) in CARD_FRAMES.items():
        r = Renderer(dt, W, H, 80.0, 80.0, options=_options(6, est, True),
                     render_scale=scale)
        r.set_denoiser(cfg, compact)
        img, aux = r.render(_transform(W, H, 80.0))
        out["frames"][label] = (img.cpu(), aux.cpu())
    aux, img_in, img_gt = (torch.from_numpy(a).cuda()
                           for a in _train_inputs())
    for dtype in (torch.bfloat16, torch.float32):
        model = GuidanceNet(cfg, dtype=dtype)
        model.load_state_dict(params_from_numpy(cfg, params))
        model = model.cuda()
        opt = torch.optim.Adam(model.parameters(), lr=1e-4,
                               betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=5e-4)
        w, g = model(aux.permute(0, 2, 3, 1))
        res = guided_filter_batch(w, g, img_in, cfg.supports())
        loss = smape_loss(res[..., :3], img_gt[..., :3])
        loss.backward()
        opt.step()
        out["train"][str(dtype)] = (
            float(loss.detach()),
            {k: p.grad.cpu() for k, p in model.named_parameters()},
            {k: p.detach().cpu() for k, p in model.named_parameters()})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(CARD_FRAMES))
@pytest.mark.parametrize("world", list(CARD_WORLDS))
def test_card_frame_matches_single(card_runs, card_single, world, label):
    """aux bit for bit (K1's band on the card is the frame's rows), img
    within K2's bar; each rank launches each kernel of the frame once."""
    img1, aux1 = card_single["frames"][label]
    for o in card_runs[world]:
        img, aux, launches = o["frames"][label]
        assert torch.equal(aux, aux1)
        torch.testing.assert_close(img, img1, atol=K2_TOL, rtol=0)
        assert launches == CARD_FRAMES[label][4]


@pytest.mark.cuda
@pytest.mark.parametrize("world", list(CARD_WORLDS))
def test_card_step_matches_single(card_runs, card_single, world):
    """f32: the loss within rtol 2e-5 and the parameters within 1e-6;
    bf16: the loss, and the averaged gradient within 2^-7 of each tensor's
    largest; K5 and K6 once a step in each rank."""
    for o in card_runs[world]:
        for dtype in (torch.float32, torch.bfloat16):
            loss1, grads1, params1 = card_single["train"][str(dtype)]
            loss, grads, params, launches = o["train"][str(dtype)]
            np.testing.assert_allclose(loss, loss1, rtol=LOSS_RTOL)
            assert launches == {"guided_filter_batch": 1,
                                "guided_filter_batch_bwd": 1}
            for k in params1:
                if dtype == torch.float32:
                    torch.testing.assert_close(params[k], params1[k],
                                               atol=PARAM_TOL, rtol=0)
                else:
                    bar = BF16_GRAD_REL * float(grads1[k].abs().max())
                    assert float((grads[k] - grads1[k]).abs().max()) <= bar
