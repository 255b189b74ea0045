#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (rt_octree_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
  2. build every kernel from csrc/ with nvcc (sm_90a);
  3. K3 (LUT build + skip distances) vs its plain version, integer-exact,
     on a depth-7 shell, a deep chain and a random 512^3 LUT (occupancy
     1e-3, cap 12);
  4. K1 (fused frame) vs its plain version at 128x128, SPP 1/6/32, on a
     depth-7 shell tree and an NDC blobs tree; then on both scenes K1 with a
     random mesh pass, K1's classic variant (render_classic) with and
     without one, and K1 with the octree grid's mesh pass (show_grid),
     each vs its plain version; and K4 (fast mode's joint upsample) vs its
     plain version at 400->800, 320->800 and odd sizes (75x47 from
     s = 0.5, 0.4, 0.7), with and without aux_chw;
  5. PCG32: the kernel's per-pixel uniforms equal the tensor twin, bit-exact;
  6. K2 (guided filter from the net's bf16 activation) vs its plain version
     at 800x800, L=4, both support ladders, channels-last strides and a
     guidance range above 60 nats; K7 (the compact GuidanceNet) vs its
     plain version (compact_activation_plain) on random aux at 800x800
     with trained.gnet and at 256x256 with random nets of one block, of
     4 and 6 channels and a 3-block chain, and on a permuted NCHW aux;
  7. the main paths, each a headless CLI run on the depth-9 SH9 shell tree
     with the level-9 LUT, SPP 6, denoise on, its launch counts reset just
     before it and read just after: the headline frame (trained.gnet; K1,
     K2, K3 must launch), fast mode at s = 0.5 (fast.gnet; K1 at 400x400,
     K4, K2) and at s = 0.4 (fast_s0.4.gnet; 320x320), and a run with a
     drawlist, the grid, the probe and the classic estimator
     (render_classic must launch; K7 in every run); the headline flags
     through the
     dispatcher (``rtoctree render``, apps/cli.py), and the dispatcher's
     ``lod`` (the tree pooled to depth 8) and ``compress`` (the quant
     phase's depth-7 shell, --retain 1), which must launch no kernel; then
     the load of that
     tree, step by step, printed as one JSON line {"load": ...} (npz read,
     host preparation, host-to-device copies, K3's two entries, Renderer
     and set_denoiser, the first frame, their sum, one whole upload_tree
     and the peak device memory);
  8. the quality gates on the 8 held-out poses of benchmarks/quality: the
     headline frame, fast mode at s = 0.5 and 0.4 with their nets, and the
     classic estimator;
  9. every kernel vs its plain version on the main path's own inputs (the
     800x800 SPP 6 frame of the depth-9 tree, K7 on its aux, the net's
     activation, the 512^3 LUT and skip lanes); K1's statistics variant on
     that frame, printed as one JSON line {"k1_stats": ...} (steps per
     ray, SIMT lane efficiency of fixed warp tiles, the distinct LUT cells
     and data rows read, and K1's bound); then each
     kernel's time vs its plain version there (each K3 entry alone: the
     LUT it updates in place is restored outside the timed window), and
     the headline frame's time, by CUDA events; render_classic vs its plain
     version on the headline tree at 800x800, without a mesh pass and with
     the fourth run's drawlist pass, its statistics and time; K4 at
     400->800 timed against F.interpolate; for each fast frame (s = 0.5,
     0.4), K1 at its inner size and scaled focal lengths vs its plain
     version, K4 on what K1 wrote there vs its plain version, K7 on K4's
     aux with the rung's net, and the Renderer's noisy frame vs the plain
     chain, then its time with the
     phase split; the probe overlay and the host rasterizer, timed as
     plain rows ({"plain_rows": ...}); then the training path: a kit
     rendered by the port's tools/make_quality_dataset.py from the
     headline tree (32 train and 8 test poses at 800x800, SPP 6 aux and
     classic-estimator GT, under build/chip_smoke/train_kit), K5 (the
     batched guided filter) and K6 (its backward) vs their plain versions
     on a real batch of 32 80x80 slices with the ladder and the identity
     supports, the f32 train step with both kernels vs the plain chain,
     ``rtoctree train`` on configs/blender.txt for TRAIN_EPOCHS epochs
     (its launch counts reset just before it and read just after: K5 and
     K6 once a step), a resume of one more epoch, the test and compact
     tasks, the exported .gnet in the headline Renderer (PSNR on the 8
     poses, no bar), the step's time and split (net forward, K5, loss,
     K6, net backward, Adam) and K5's and K6's times, printed as one JSON
     line {"train": ...};
 10. the scenes of the JAX package's bench (SCENES: solid 800x800, tt
     1920x1080 and its fast rung, the llff blobs scene in NDC at 1008x756
     with its fast, LOD d8 and interactive rungs), each through the
     Renderer with its kit's net: K1 vs its plain version on the scene's
     own frame (tt: the central 64x64 pixels), fast rungs held at their
     own shapes (K1 at the inner size, K4 on its output, the frame vs the
     plain chain, K7 on K4's aux), K7 on the scene's aux with its net
     (and its time at the scene's size), K2 on the net's activation, the
     8-pose gate against the JAX package's CPU bars with
     denoise_recommended, the frame time and phase split; then the
     quantized depth-7 shell (K1 held on its
     decode, PSNR against the float frame and the npz bytes ratio against
     the JAX package's), printed as one JSON line {"scenes": ...};
 11. the depth-11 shell (the headline tree refined 2 levels,
     tools/bench_deep.py) uploaded with the partial-LUT skip and with
     skip_cap=0: K3's marker lanes and distances vs its plain version on
     the 512^3 partial LUT, K1 vs its plain version on a 128x128 crop of
     both, the two 800x800 frames against each other, K1's statistics,
     frame times and peak device memory, as one JSON line {"deep": ...};
 12. probes: the six probe kernels (csrc/probes.cu, the port of the Pallas
     kernels of tools/tpu_probe.py and tools/microbench_gather.py) vs their
     plain versions at the tools' own shapes (bit-equal; P4 within 1e-5
     relative of a float64 sum), each one's time vs its plain version, then
     the tools' entry points (gpu_probe basic vgather vgather_loop dma,
     microbench_gather b and c) with the counts reset: every probe kernel's
     launch count in that run must be > 0.

After phase 10 it prints K7's holds and times as one JSON line
{"k7": ...}: per input, the largest difference from the plain version in
bf16 ulps of the tensor's largest magnitude and of each element's, the
share of elements not bit-equal; K7, its plain version and the cuDNN chain
it replaces at 800x800 and 1920x1080.

Prints the kernel table as one JSON line (per kernel: launches on the main
path, max abs error, ms, plain ms, the bound in ms and whether bytes or
operations set it, and the time of one PyTorch call that computes the same
function where there is one), then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
K3's rows are its two C entries, with their kernel launches per tree load:
lut_build is ceil(levels / 3) launches of lut_step_kernel, skip_distances
skip_rows_kernel and two launches of skip_axis_kernel.
Needs one CUDA card; exits non-zero without one.

    python3 chip_smoke.py --load-only TREE.npz

loads an npz of the headline tree twice with the package found beside this
file and times each K3 entry alone, printing the {"load": ...} lines and
one {"k3_ms": ...} line; run from a copy of another commit's tree, it times
that commit's load by the same code.

    python3 chip_smoke.py --load-pairs OTHER_ROOT [PAIRS]

runs --load-only in PAIRS (default 10) pairs of processes, this checkout's
and OTHER_ROOT's in turns (other, this, this, other, ...; a copy of this
script must stand in OTHER_ROOT), on the headline npz (made first if it is
not there), and prints each side's least value, quartiles and largest
value of every step, and those of the paired differences of the sums, as
one JSON line {"load_pairs": ...}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from rt_octree_tpu_torch.utils.timer import cuda_ms, device_ms  # noqa: E402

KIT = os.path.join(HERE, "benchmarks", "quality")
WORK = os.path.join(HERE, "build", "chip_smoke")
# The JAX package's gate on this kit, as tools/quality_gate_jax_cpu.py
# scores it on the CPU (BASELINE.md:66 rounds it to 44.55 / 55.22), and the
# port's allowed distance from it.
GATE_NOISY, GATE_DENOISED = 44.553, 55.221
GATE_NOISY_TOL, GATE_DENOISED_TOL = 0.05, 0.10
# The JAX package's own CPU bars for fast mode (s = 0.5 with fast.gnet, s =
# 0.4 with fast_s0.4.gnet) and the classic estimator (trained.gnet), from
#   python tools/quality_gate_jax_cpu.py --render_scale 0.5 \
#       --gnet benchmarks/quality/fast.gnet
#   python tools/quality_gate_jax_cpu.py --render_scale 0.4 \
#       --gnet benchmarks/quality/fast_s0.4.gnet
#   python tools/quality_gate_jax_cpu.py --estimator classic
# (noisy, denoised dB), held to the same distances.
GATES_FAST = {0.5: ("fast.gnet", 43.124, 50.524),
              0.4: ("fast_s0.4.gnet", 40.869, 48.439)}
GATE_CLASSIC = (62.368, 59.994)
# The scenes of the JAX package's bench (bench.py:343-620), as data: the
# depth-9 SH9 tree kind, the output size, the focal length (None: the
# Camera's default), NDC, the kit under benchmarks/, its net, the fast-mode
# scale and the LOD depth (0: none), SPP 6, step 1e-4, sigma threshold
# 1e-2, background 1.0, LUT at min(9, depth); and the JAX package's own CPU
# bars (noisy, denoised dB) from
#   python tools/quality_gate_jax_cpu.py --scene SCENE \
#       [--render_scale 0.5 --gnet benchmarks/KIT/fast.gnet] [--lod_depth 8]
# held to the same distances as the headline's.  The llff rungs' kit has no
# fast_lod8_s0.5.gnet: bench.py:_fast_denoiser's search ends at fast.gnet.
_SOLID = dict(tree="solid", ndc=False, lod=0, crop=None)
_TT = dict(_SOLID, size=(1920, 1080), focal=1158.0, kit="quality_tt")
_LLFF = dict(tree="blobs", size=(1008, 756), focal=800.0, ndc=True,
             kit="quality_blobs", crop=None)
SCENES = {
    "solid": dict(_SOLID, size=(800, 800), focal=None, kit="quality_solid",
                  gnet="trained.gnet", scale=1.0, bars=(54.803, 54.835)),
    "tt": dict(_TT, gnet="trained.gnet", scale=1.0, bars=(60.054, 60.095),
               crop=64),
    "tt fast s=0.5": dict(_TT, gnet="fast.gnet", scale=0.5,
                          bars=(43.255, 43.98)),
    "llff": dict(_LLFF, gnet="trained.gnet", scale=1.0, lod=0,
                 bars=(28.66, 45.225)),
    "llff fast s=0.5": dict(_LLFF, gnet="fast.gnet", scale=0.5, lod=0,
                            bars=(32.686, 40.327)),
    "llff lod d8": dict(_LLFF, gnet="trained.gnet", scale=1.0, lod=8,
                        bars=(28.656, 45.234)),
    "llff interactive": dict(_LLFF, gnet="fast.gnet", scale=0.5, lod=8,
                             bars=(32.685, 40.327)),
}
# bench.py:quant_fidelity (:624-672): a depth-7 SH9 shell compressed with
# --retain 1, float and quantized frames at 256x256, SPP 6, no denoise, the
# default camera, LUT min(7, depth); the JAX package's PSNR of the
# quantized frame against the float one, and the sizes of its two npz files
# (python tools/quality_gate_jax_cpu.py --quant), which the port's copies
# of the same NumPy code must write byte for byte.
QUANT_DEPTH, QUANT_SIZE = 7, 256
QUANT_PSNR, QUANT_PSNR_TOL = 42.882, 0.05
QUANT_BYTES = (16141546, 2804348)  # float, quantized
# tools/bench_deep.py:38-54: the headline depth-9 shell refined 2 levels
# at its occupied deepest leaves, 800x800, SPP 6, no denoise, level-9 LUT;
# K1 is held on the frame's central DEEP_CROP^2 pixels
DEEP_LEVELS, DEEP_LUT, DEEP_SIZE, DEEP_CROP = 2, 9, 800, 128
# K1 vs plain: both run on the card with the same libm (log1pf, expf) and
# IEEE division, so they differ only by summation order in the shade.
K1_IMG_TOL, K1_AUX_TOL = 2e-5, 4e-5
# K4 vs plain: the same f32 operations in the same order, on [0, 1] values.
UPSAMPLE_TOL = 1e-6
K2_TOL = 1e-5  # f32 sums of up to 49 softmax taps, in another order
# K5 vs plain: the same sums as K2's (up to 81 taps at support 4); K6 vs
# plain: the gather of up to 81 taps of exp * (u.x - v) with FMA
# contraction, within 1e-4 of the plain gradient's largest magnitude; the
# f32 train step with kernels vs the plain chain (torch autograd through
# the plain filter): each parameter's gradient within rtol 1e-4 of its
# largest magnitude (sums over 204,800 pixels round in f32 either way: on
# the CPU both routes sit ~1e-5 of that from a float64 step).
K5_TOL, K6_REL_TOL, STEP_RTOL = 1e-5, 1e-4, 1e-4
# K7 vs plain: both sum each conv in f32, in other orders (tensor cores /
# cuDNN), so a bf16 rounding may land one ulp apart; it moves the next
# block's sums, and a bias that cancels its conv output turns one ulp of
# the conv into many of the result.  So each element is held within K7_ULPS
# bf16 ulps of the tensor's largest magnitude, and at most
# K7_UNEQUAL_SHARE of the elements may differ at all (rounding the conv
# and the bias in one step fails that: tests/test_torch_net.py).
K7_ULPS, K7_UNEQUAL_SHARE = 2.0, 1e-3
# the train phase: configs/blender.txt on a kit that the port renders from
# the headline tree (32 train and 8 test poses at 800x800); TRAIN_EPOCHS
# epochs, then a resume of one more
TRAIN_EPOCHS = 5
# The least time for a kernel's work on an H100 SXM (NVIDIA's data sheet):
# the bytes it must move over the memory rate, or its operations over the
# peak of their type (f32 on the CUDA cores; K7's bf16 products on the
# tensor cores, dense), whichever is larger.
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
BF16_TC_OPS_PER_S = 989e12
# K1's f32 operations, counted from csrc/render.cu and kept as a floor
# (integer work, the ray setup and the basis are left out): a leaf step
# ~100 (clip 12, LUT cell 18, leaf cube ~10, DDA 22, skip box 36), a shaded
# leaf 6 bd + 16 (three dot products, sigmoids, the weighted sum).
K1_OPS_PER_STEP = 100

FRAME_KERNELS = {
    "render": ("rt_octree_tpu_torch/csrc/render.cu",
               "rt_octree_tpu/render/renderer.py:1145"),
    "render_classic": ("rt_octree_tpu_torch/csrc/render.cu",
                       "rt_octree_tpu/render/renderer.py:1060"),
    "upsample": ("rt_octree_tpu_torch/csrc/upsample.cu",
                 "rt_octree_tpu/render/renderer.py:1302"),
    "guided_filter": ("rt_octree_tpu_torch/csrc/filter.cu",
                      "rt_octree_tpu/ops/filtering.py:153"),
    "guidance_net": ("rt_octree_tpu_torch/csrc/net.cu",
                     "rt_octree_tpu/models/guidance_net.py:124"),
    "lut_build": ("rt_octree_tpu_torch/csrc/lut.cu",
                  "rt_octree_tpu/ops/traversal.py:102"),
    "skip_distances": ("rt_octree_tpu_torch/csrc/lut.cu",
                       "rt_octree_tpu/ops/traversal.py:173"),
}
# the training step's kernels (the batched filter and its backward)
TRAIN_KERNELS = {
    "guided_filter_batch": ("rt_octree_tpu_torch/csrc/filter.cu",
                            "rt_octree_tpu/ops/filtering.py:188"),
    "guided_filter_batch_bwd": ("rt_octree_tpu_torch/csrc/filter.cu",
                                "rt_octree_tpu/ops/filtering.py:188"),
}
# the probe kernels: launch name -> the Pallas call they replace
PROBE_KERNELS = {
    "probe_affine": "tools/tpu_probe.py:46",
    "lane_gather": "tools/tpu_probe.py:69",
    "lane_gather_chain": "tools/tpu_probe.py:104",
    "row_sum_ring": "tools/tpu_probe.py:158",
    "row_ring_rounds": "tools/microbench_gather.py:132",
    "flat_gather_chain": "tools/microbench_gather.py:183",
}
KERNELS = {**FRAME_KERNELS, **TRAIN_KERNELS,
           **{k: ("rt_octree_tpu_torch/csrc/probes.cu", v)
              for k, v in PROBE_KERNELS.items()}}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float = 0.0, ops_per_s: float = F32_OPS_PER_S):
    """(bound ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def psnr(img, gt_u8) -> float:
    gt = gt_u8.astype(np.float32) / 255.0
    mse = float(np.mean((img[..., :3] - gt) ** 2))
    return -10.0 * np.log10(mse)


def phase_k3(err):
    import torch
    from rt_octree_tpu_torch.io import synthetic
    from rt_octree_tpu_torch.ops import traversal as T

    def hold(label, res, lut_k, lut_p, cap=12):
        skip_k = T.add_skip_distances(lut_k.clone(), res, cap)
        skip_p = T.add_skip_distances_plain(lut_p, res, cap)
        d_skip = int((skip_k.long() - skip_p.long()).abs().max())
        d_lut = int((lut_k.long() - lut_p.long()).abs().max())
        n_skip = int(((skip_p[:, 1] > 0) & (skip_p[:, 1] <= cap)).sum())
        log(f"[k3] {label}: {res}^3 cells, lut max|diff| {d_lut}, skip "
            f"max|diff| {d_skip} ({n_skip} cells carry a distance)")
        require(d_lut == 0 and d_skip == 0, f"K3 disagrees on {label}")
        err["lut_build"] = max(err.get("lut_build", 0.0), float(d_lut))
        err["skip_distances"] = max(err.get("skip_distances", 0.0),
                                    float(d_skip))

    cases = [("shell d7", synthetic.make_synthetic_tree(
        "shell", depth=7, basis_dim=9), 7),
        ("deep chain d10 @5", synthetic.make_deep_chain_tree(10), 5)]
    for label, tree, levels in cases:
        dt = T.upload_tree(tree, lut_levels=0, device="cuda")
        lut_k = T.build_lut(dt.chs, tree.N, levels)
        lut_p = T.lut_build_plain(dt.chs, tree.N, levels)
        hold(label, tree.N ** levels, lut_k, lut_p)
    lut = torch.from_numpy(synthetic.random_lut(512, 1e-3, 11)).cuda()
    hold("random occupancy 1e-3 (no build)", 512, lut, lut)


def k1_scenes():
    from rt_octree_tpu_torch.core.camera import Camera
    from rt_octree_tpu_torch.io import synthetic
    shell = synthetic.make_synthetic_tree("shell", depth=7, basis_dim=9)
    cam = Camera(width=128, height=128, fx=175.0, fy=175.0)
    blobs = synthetic.make_synthetic_tree("blobs", depth=7, basis_dim=4)
    blobs.use_ndc = True
    blobs.ndc_width, blobs.ndc_height, blobs.ndc_focal = 1008.0, 756.0, 800.0
    ncam = Camera(width=128, height=128, fx=480.0, fy=480.0)
    ncam.center = np.array([0.02, 0.01, 0.3], np.float32)
    ncam.v_back = np.array([0.0, 0.0, 1.0], np.float32)
    ncam.v_world_up = np.array([0.0, 1.0, 0.0], np.float32)
    ncam.update()
    return [("shell d7", shell, cam), ("ndc blobs d7", blobs, ncam)]


def phase_k1(err):
    import torch
    from rt_octree_tpu_torch.core.options import RenderOptions
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.render import renderer as R
    from rt_octree_tpu_torch.utils.rng import Pcg32
    worst = 0.0
    for label, tree, cam in k1_scenes():
        dt = upload_tree(tree, lut_levels=tree.max_depth, device="cuda")
        tf = torch.from_numpy(cam.transform.astype(np.float32)).cuda()
        rng = Pcg32(20230418)
        for spp in (1, 6, 32):
            opt = RenderOptions(spp=spp, denoise=False)
            kw = dict(width=cam.width, height=cam.height, fx=cam.fx,
                      fy=cam.fy, opt=opt)
            ik, nk, ck = R.render_noisy(dt, tf, rng.state, rng.inc, **kw)
            ip, npl, cp = R.render_noisy_plain(dt, tf, rng.state, rng.inc,
                                               **kw)
            e_img = float((ik - ip).abs().max())
            e_aux = max(float((ck - cp).abs().max()),
                        float((nk - npl).abs().max()))
            alpha = float(ck[3].max())
            log(f"[k1] {label} spp {spp}: max|img diff| {e_img:.3g}, "
                f"max|aux diff| {e_aux:.3g}, max alpha {alpha:.3f}")
            require(bool(torch.isfinite(ik).all()), "K1 image not finite")
            require(e_img <= K1_IMG_TOL and e_aux <= K1_AUX_TOL,
                    f"K1 disagrees with its plain version on {label}")
            require(alpha > 0.5, f"{label}: the scene is not visible")
            worst = max(worst, e_img, e_aux)
            rng.advance()
    err["render"] = worst


def hold_k1(label, dt, tf, kw, err_key, err, rng=(20230418, 1), **mesh):
    """K1 (the estimator of kw["opt"]) vs its plain version on one frame
    from the PCG32 (state, inc) ``rng``; returns (kernel's, plain's)."""
    import torch
    from rt_octree_tpu_torch.render import renderer as R
    got = R.render_noisy(dt, tf, *rng, **kw, **mesh)
    ref = R.render_noisy_plain(dt, tf, *rng, **kw, **mesh)
    e_img = float((got[0] - ref[0]).abs().max())
    e_aux = max(float((got[1] - ref[1]).abs().max()),
                float((got[2] - ref[2]).abs().max()))
    log(f"[k1] {label}: max|img diff| {e_img:.3g}, max|aux diff| "
        f"{e_aux:.3g}, max alpha {float(got[2][3].max()):.3f}")
    require(bool(torch.isfinite(got[0]).all()), f"{label}: not finite")
    require(e_img <= K1_IMG_TOL and e_aux <= K1_AUX_TOL,
            f"{label}: the kernel disagrees with its plain version")
    err[err_key] = max(err.get(err_key, 0.0), e_img, e_aux)
    return got, ref


def hold_fast(rf, pose, err, scene="headline"):
    """The fast frame as the main path makes it, vs its plain chain: K1 at
    the inner size with fx, fy scaled by inner / output (vs its plain
    version), K4 on what K1 wrote there (vs its plain version on the same
    aux), and the Renderer's noisy frame vs the plain march upsampled by
    the plain K4, at the K1 tolerances."""
    from rt_octree_tpu_torch.ops.resize import fast_upsample_plain
    iw, ih, H, W = rf.inner_width, rf.inner_height, rf.height, rf.width
    rng = (rf.rng.state, rf.rng.inc)
    kw = dict(width=iw, height=ih, fx=rf.fx * (iw / W), fy=rf.fy * (ih / H),
              opt=rf.options)
    label = f"fast s={rf.render_scale} inner {iw}x{ih}, pose r_0"
    inner_k, inner_p = hold_k1(label, rf.tree, rf._transform(pose), kw,
                               "render", err, rng)
    got = rf.render_noisy(pose)
    hold_k7(f"{scene} {label} -> {W}x{H}, K4's aux, the rung's net",
            rf.net, got[1][None], err)
    own = fast_upsample_plain(inner_k[1], H, W, True)
    chain = fast_upsample_plain(inner_p[1], H, W, True)
    e_k4 = max(float((g - o).abs().max()) for g, o in zip(got, own))
    e_img = float((got[0] - chain[0]).abs().max())
    e_aux = max(float((got[1] - chain[1]).abs().max()),
                float((got[2] - chain[2]).abs().max()))
    log(f"[fast] {label} -> {W}x{H}: K4 on K1's aux max|diff| {e_k4:.3g}; "
        f"frame vs the plain chain max|img diff| {e_img:.3g}, max|aux "
        f"diff| {e_aux:.3g}")
    require(e_k4 <= UPSAMPLE_TOL, f"{label}: K4 disagrees with its plain "
            "version on K1's output")
    require(e_img <= K1_IMG_TOL and e_aux <= K1_AUX_TOL,
            f"{label}: the fast frame disagrees with its plain chain")
    err["upsample"] = max(err["upsample"], e_k4)
    err["render"] = max(err["render"], e_img, e_aux)


def phase_k1_mesh_classic(err):
    """K1 with a random mesh pass, render_classic with and without one, and
    K1 with the grid's mesh pass, vs their plain versions on phase 4's
    scenes."""
    import torch
    from rt_octree_tpu_torch.core.options import RenderOptions
    from rt_octree_tpu_torch.io import synthetic
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.render.renderer import Renderer
    for label, tree, cam in k1_scenes():
        dt = upload_tree(tree, lut_levels=tree.max_depth, device="cuda")
        tf = torch.from_numpy(cam.transform.astype(np.float32)).cuda()
        n = cam.width * cam.height
        mc, md = (torch.from_numpy(a).cuda()
                  for a in synthetic.random_mesh_pass(len(label), n))
        for est in ("rt", "classic"):
            kw = dict(width=cam.width, height=cam.height, fx=cam.fx,
                      fy=cam.fy, opt=RenderOptions(spp=6, denoise=False,
                                                   estimator=est))
            key = "render" if est == "rt" else "render_classic"
            with_mesh = hold_k1(f"{label} {est} + random mesh pass", dt, tf,
                                kw, key, err, mesh_color=mc, mesh_depth=md)[0]
            if est == "classic":
                plain = hold_k1(f"{label} classic", dt, tf, kw, key, err)[0]
                require(not torch.equal(with_mesh[0], plain[0]),
                        "the mesh pass did not show")
        r = Renderer(dt, cam.width, cam.height, cam.fx, cam.fy,
                     options=RenderOptions(spp=6, denoise=False,
                                           show_grid=True))
        r.set_grid_mesh(tree, 2)
        color, depth = r._grid_mesh_pass(cam.transform, None, None)
        kw = dict(width=cam.width, height=cam.height, fx=cam.fx, fy=cam.fy,
                  opt=r.options)
        hold_k1(f"{label} rt + grid pass ({int(np.isfinite(depth).sum())} "
                "px of wireframe)", dt, tf, kw, "render", err,
                mesh_color=torch.from_numpy(color.reshape(-1, 3)).cuda(),
                mesh_depth=torch.from_numpy(depth.reshape(-1)).cuda())


UPSAMPLE_CASES = [((400, 400), (800, 800)), ((320, 320), (800, 800)),
                  ((24, 38), (47, 75)), ((19, 30), (47, 75)),
                  ((33, 52), (47, 75))]


def upsample_input(h, w, seed=5):
    """An inner aux [h, w, 8] on the card: rgba in [0, 1] and its square."""
    import torch
    rgba = np.random.default_rng(seed).random((h, w, 4), np.float32)
    return torch.from_numpy(np.concatenate([rgba, rgba * rgba], -1)).cuda()


def phase_k4(err):
    """K4 vs its plain version at the fast frames' sizes (400->800 at s =
    0.5, 320->800 at 0.4) and at 75x47 from s = 0.5, 0.4 and 0.7, with and
    without aux_chw."""
    from rt_octree_tpu_torch.ops.resize import (fast_upsample,
                                                fast_upsample_plain)
    worst = 0.0
    for (h, w), (H, W) in UPSAMPLE_CASES:
        aux = upsample_input(h, w)
        for want in (True, False):
            got = fast_upsample(aux, H, W, want)
            ref = fast_upsample_plain(aux, H, W, want)
            e = max(float((g - r).abs().max()) for g, r in zip(got, ref)
                    if r is not None)
            require((got[2] is None) == (not want), "K4 aux_chw")
            require(e <= UPSAMPLE_TOL, f"K4 disagrees with its plain version "
                    f"at {w}x{h} -> {W}x{H}")
            worst = max(worst, e)
        log(f"[k4] {w}x{h} -> {W}x{H}: max|diff| {e:.3g} (with and without "
            "aux_chw)")
    err["upsample"] = worst


def phase_pcg():
    import torch
    from rt_octree_tpu_torch.core.options import RenderOptions
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.render import renderer as R
    from rt_octree_tpu_torch.utils.rng import Pcg32, pcg32_uniforms_range
    label, tree, cam = k1_scenes()[0]
    dt = upload_tree(tree, lut_levels=tree.max_depth, device="cuda")
    tf = torch.from_numpy(cam.transform.astype(np.float32)).cuda()
    for seq, spp in ((1, 6), (7, 32)):
        rng = Pcg32(20230418, seq)
        rng.advance()
        n = cam.width * cam.height
        u_k = torch.empty((n, spp), dtype=torch.float32, device="cuda")
        R.render_noisy(dt, tf, rng.state, rng.inc, width=cam.width,
                       height=cam.height, fx=cam.fx, fy=cam.fy,
                       opt=RenderOptions(spp=spp, denoise=False),
                       uniforms_out=u_k)
        u_t = pcg32_uniforms_range(rng.state, n=n * spp, inc=rng.inc,
                                   device="cuda").reshape(n, spp)
        same = bool(torch.equal(u_k.view(torch.int32),
                                u_t.view(torch.int32)))
        host = Pcg32(20230418, seq)
        host.advance()
        host.advance(12345 * spp)
        ref = [host.next_float() for _ in range(spp)]
        log(f"[pcg] stream {seq} spp {spp}: kernel == twin on {n * spp} "
            f"uniforms: {same}; pixel 12345 == host Pcg32: "
            f"{u_k[12345].tolist() == ref}")
        require(same and u_k[12345].tolist() == ref, "PCG32 mismatch")


def filter_activation(rs, L, H, W, gscale, layout="contiguous"):
    """A bf16 activation [1, 2L, H, W] like the net's: level logits, then
    guidance at ``gscale``."""
    import torch
    act = np.concatenate([rs.standard_normal((L, H, W)) * 2.0,
                          rs.standard_normal((L, H, W)) * gscale])[None]
    act = torch.from_numpy(act.astype(np.float32)).cuda().to(torch.bfloat16)
    if layout == "channels_last":
        act = act.contiguous(memory_format=torch.channels_last)
    return act


def phase_k2(err):
    import torch
    from rt_octree_tpu_torch.ops.filtering import (guided_filter,
                                                   guided_filter_act_plain)
    rs = np.random.default_rng(7)
    H = W = 800
    L = 4
    img = torch.from_numpy(rs.random((H, W, 4), np.float32)).cuda()
    worst = 0.0
    for label, supports, gscale, layout in (
            ("ladder 1..4", (1, 2, 3, 4), 3.0, "contiguous"),
            ("ladder 0..3", (0, 1, 2, 3), 3.0, "channels_last"),
            ("range > 60 nats", (0, 1, 2, 3), 40.0, "contiguous")):
        act = filter_activation(rs, L, H, W, gscale, layout)
        out_k = guided_filter(act, img, supports)
        out_p = guided_filter_act_plain(act, img, supports)
        e = float((out_k - out_p).abs().max())
        g = act[0, L:].float()
        log(f"[k2] {label} ({layout}): guidance range "
            f"{float(g.max() - g.min()):.1f} nats, max|diff| {e:.3g}")
        require(e <= K2_TOL and bool(torch.isfinite(out_k).all()),
                f"K2 disagrees with its plain version ({label})")
        worst = max(worst, e)
    # level logits (0, -200, -200, -200): weights exactly one-hot on the
    # support-0 level
    act[0, 1:L] = -200.0
    act[0, 0] = 0.0
    out = guided_filter(act, img, (0, 1, 2, 3))
    exact = bool(torch.equal(out[..., :3], img[..., :3]))
    log(f"[k2] support-0 passthrough bit-exact: {exact}")
    require(exact and bool((out[..., 3] == 1).all()), "K2 passthrough")
    err["guided_filter"] = worst


def bf16_ulps(got, ref):
    """(largest difference in bf16 ulps of the tensor's largest magnitude,
    largest in ulps of each element's larger magnitude, share of elements
    not equal, largest absolute difference)."""
    import torch
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    big = torch.maximum(g.abs(), r.abs())

    def ulp(m):
        return torch.exp2(torch.floor(torch.log2(m.clamp_min(2.0 ** -126)))
                          - 7)
    return (float(d.max() / ulp(big.max())), float((d / ulp(big)).max()),
            float((g != r).float().mean()), float(d.max()))


def hold_k7(label, net, aux_nhwc, err):
    """K7 (net.activation on the card) vs compact_activation_plain on the
    same aux [B, H, W, C], at K7_ULPS and K7_UNEQUAL_SHARE."""
    import torch
    from rt_octree_tpu_torch.models.guidance_net import \
        compact_activation_plain
    with torch.no_grad():
        act = net.activation(aux_nhwc)
        ref = compact_activation_plain(aux_nhwc,
                                       [c.weight for c in net.convs],
                                       [c.bias for c in net.convs])
    t_ulps, e_ulps, share, e = bf16_ulps(act, ref)
    log(f"[k7] {label}: {tuple(act.shape)}, max|diff| {e:.3g} = {t_ulps:g} "
        f"ulps of the largest |value| ({e_ulps:g} of the element's), "
        f"{share:.3g} of the elements not bit-equal")
    require(act.shape == ref.shape and bool(torch.isfinite(
        act.float()).all()), f"K7 output bad on {label}")
    require(t_ulps <= K7_ULPS and share <= K7_UNEQUAL_SHARE,
            f"K7 disagrees with its plain version on {label}")
    err["guidance_net"] = max(err.get("guidance_net", 0.0), e)
    # K7's holds and times, printed after phase 10 as {"k7": ...}
    k7 = err.setdefault("k7", {"holds": {}, "ms": {}})
    k7["holds"][label] = {"ulps_of_max": t_ulps, "ulps_of_element":
                               e_ulps, "unequal_share": share,
                               "max_abs": e, "elements": act.numel()}


def k7_bound(net, n):
    """K7's bound on n pixels: the f32 aux read and the bf16 activation
    written once; 2 operations a multiply-add of every block's 3x3 taps,
    on the bf16 tensor cores."""
    chans = net.config.layer_channels()
    nbytes = n * (4 * chans[0][0] + 2 * chans[-1][1])
    ops = n * 2 * 9 * sum(cin * cout for cin, cout in chans)
    return bound(nbytes, ops, BF16_TC_OPS_PER_S)


def time_k7(label, net, aux_nhwc, err):
    """K7, its plain version and the cuDNN chain it replaces on aux_nhwc
    [1, H, W, C]: (kernel ms, plain ms, chain ms), recorded in err["k7"].
    The kernel and the chain by device_ms (their launches are shorter than
    the host's queuing), the plain version as every plain row, cuda_ms."""
    import torch
    from rt_octree_tpu_torch.models.guidance_net import \
        compact_activation_plain
    ws = [c.weight for c in net.convs]
    bs = [c.bias for c in net.convs]
    with torch.no_grad():
        k_ms = device_ms(lambda: net.activation(aux_nhwc), 200, 10)
        p_ms = cuda_ms(lambda: compact_activation_plain(aux_nhwc, ws, bs),
                       20, 3)
        # the chain K7 replaces: permute, cast, then per block conv
        # (cuDNN), bias add, relu6, with the weights cast once outside
        wb = [w.to(torch.bfloat16) for w in ws]
        bb = [b.to(torch.bfloat16)[None, :, None, None] for b in bs]

        def chain():
            x = aux_nhwc.permute(0, 3, 1, 2).to(torch.bfloat16)
            for w, b in zip(wb, bb):
                x = torch.nn.functional.relu6(
                    torch.nn.functional.conv2d(x, w, padding=1) + b)
            return x
        l_ms = device_ms(chain, 200, 10)
    H, W = aux_nhwc.shape[1:3]
    b_ms, b_by = k7_bound(net, H * W)
    log(f"[timing] K7 {label} {W}x{H}: kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, cuDNN chain {l_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    err["k7"]["ms"][f"{W}x{H}"] = {"net": label, "kernel": k_ms, "plain": p_ms,
                                 "cudnn_chain": l_ms, "bound": b_ms,
                                 "bound_by": b_by}
    return k_ms, p_ms, l_ms


def k7_aux(H, W, C=8, seed=11):
    """Random f32 aux [1, H, W, C] on the card like K1's: rgba-like means
    in [0, 1], then their squares."""
    import torch
    rs = np.random.default_rng(seed)
    aux = rs.random((1, H, W, C), np.float32)
    aux[..., C // 2:2 * (C // 2)] = aux[..., :C // 2] ** 2
    return torch.from_numpy(aux).cuda()


def phase_k7(err):
    """K7 vs its plain version on random aux: trained.gnet at 800x800 and
    on a permuted NCHW aux (the runner's test split), random nets of the
    JAX tests' shapes and a 3-block chain at 256x256."""
    from rt_octree_tpu_torch.models.guidance_net import (GuidanceNetConfig,
                                                         build_compact,
                                                         load_model)
    net, _ = load_model(os.path.join(KIT, "trained.gnet"), "cuda")
    aux = k7_aux(800, 800)
    hold_k7("random aux 800x800, trained.gnet", net, aux, err)
    nchw = aux.permute(0, 3, 1, 2).contiguous()
    hold_k7("random aux 800x800 read from NCHW, trained.gnet", net,
            nchw.permute(0, 2, 3, 1), err)
    rs = np.random.default_rng(12)
    for cfg in (GuidanceNetConfig(mid_channels=4, num_layers=1,
                                  kernel_levels=2),
                GuidanceNetConfig(mid_channels=4, kernel_levels=2),
                GuidanceNetConfig(in_channels=6, mid_channels=6,
                                  kernel_levels=3),
                GuidanceNetConfig(mid_channels=8, num_layers=3)):
        params = {f"block_{i}": {
            "kernel": (rs.standard_normal((3, 3, cin, cout)) * 0.4).astype(
                np.float32),
            "bias": (rs.standard_normal(cout) * 0.1).astype(np.float32)}
            for i, (cin, cout) in enumerate(cfg.layer_channels())}
        chans = " -> ".join(str(c) for c in [cfg.in_channels] + [
            cout for _, cout in cfg.layer_channels()])
        hold_k7(f"random aux 256x256, random net {chans}",
                build_compact(cfg, params, "cuda"),
                k7_aux(256, 256, cfg.in_channels), err)


def headline_tree_path():
    """Build the depth-9 SH9 shell tree and save it as an npz for the CLI;
    returns the tree, the path and the seconds each step took."""
    from rt_octree_tpu_torch.io import synthetic
    t0 = time.perf_counter()
    tree = synthetic.make_synthetic_tree("shell", depth=9, basis_dim=9)
    t1 = time.perf_counter()
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "shell_d9_sh9.npz")
    synthetic.save_npz(tree, path)
    t2 = time.perf_counter()
    log(f"[main] depth-9 shell tree: {tree.capacity} nodes, max depth "
        f"{tree.max_depth}, built in {t1 - t0:.1f} s, saved in "
        f"{t2 - t1:.1f} s")
    return tree, path, {"generate_s": t1 - t0, "save_npz_s": t2 - t1}


def headline_options():
    from rt_octree_tpu_torch.core.options import RenderOptions
    return RenderOptions(spp=6, denoise=True, step_size=1e-4,
                         sigma_thresh=1e-2, background_brightness=1.0)


def measure_load(tree_path, extra=None):
    """The load of the headline tree as a user pays it, step by step, each
    between two torch.cuda.synchronize(): the npz read, upload_tree's host
    preparation (the chs stack and the f16 data) and its host-to-device
    copies, K3's two entries (also by CUDA events), Renderer plus
    set_denoiser, and the first frame.  The steps are upload_tree's own,
    run one by one from here; one whole upload_tree call is timed after
    them and must give the same tensors.  Prints and returns
    {"load": ...}."""
    import torch
    from rt_octree_tpu_torch.io import n3tree
    from rt_octree_tpu_torch.io.poses import load_poses
    from rt_octree_tpu_torch.ops import traversal as T
    from rt_octree_tpu_torch.render.renderer import Renderer
    dev = torch.device("cuda")
    levels, cap = 9, 12
    ps = load_poses("blender", os.path.join(KIT, "transforms_test.json"),
                    800, 800)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sec = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec[name] = time.perf_counter() - t0
        return out

    tree = step("read_s", lambda: n3tree.load(tree_path))
    require(tree.N == 2 and tree.max_depth == levels,
            f"not the headline tree: N {tree.N}, depth {tree.max_depth}")

    def prep():
        sigma = np.ascontiguousarray(tree.data[:, tree.data_dim - 1])
        bits = sigma.astype(np.float32).view(np.int32)
        chs = np.stack([tree.child.astype(np.int32), bits], axis=-1)
        return chs, np.require(tree.data, np.float16, ["C", "W"])
    chs_np, data_np = step("host_prep_s", prep)

    def h2d():
        put = lambda a, t: torch.from_numpy(  # noqa: E731
            np.require(a, t, ["C", "W"])).to(dev)
        return (put(chs_np, np.int32), put(data_np, np.float16),
                put(tree.offset, np.float32), put(tree.scale, np.float32))
    chs, data, offset, scale = step("h2d_s", h2d)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    res = tree.N ** levels

    def k3():
        ev[0].record()
        lut = T.build_lut(chs, tree.N, levels)
        ev[1].record()
        lut = T.add_skip_distances(lut, res, cap)
        ev[2].record()
        return lut
    lut = step("k3_s", k3)
    dt = T.DeviceTree(
        data=data, chs=chs, offset=offset, scale=scale,
        extra=torch.zeros(0, dtype=torch.float32, device=dev), lut=lut,
        N=tree.N, data_dim=tree.data_dim,
        basis_dim=tree.data_format.basis_dim,
        fmt=tree.data_format.format.value, max_depth=tree.max_depth,
        lut_levels=levels, skip_cap=cap, ndc=None)

    def renderer():
        r = Renderer(dt, 800, 800, ps.fx, ps.fy, options=headline_options())
        r.set_denoiser(os.path.join(KIT, "trained.gnet"))
        return r
    r = step("renderer_s", renderer)
    img = step("first_frame_s",
               lambda: r.render(ps.poses[0], want_aux=False)[0])
    require(tuple(img.shape) == (800, 800, 4)
            and bool(torch.isfinite(img).all()), "first frame: bad image")
    peak = torch.cuda.max_memory_allocated()
    total = sum(sec.values())
    del r, dt, img
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = T.upload_tree(tree, lut_levels=levels, device=dev, skip_cap=cap)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    require(all(torch.equal(a, b) for a, b in (
        (whole.chs, chs), (whole.data, data), (whole.offset, offset),
        (whole.scale, scale), (whole.lut, lut))),
        "upload_tree gave other tensors than its steps one by one")
    del whole, lut, chs, data
    line = {"load": {
        "tree": f"shell npz, depth {tree.max_depth}, basis "
                f"{tree.data_format.basis_dim}, {tree.capacity} nodes, "
                f"level-{levels} LUT, skip_cap {cap}",
        **(extra or {}), **sec,
        "lut_build_ms": ev[0].elapsed_time(ev[1]),
        "skip_distances_ms": ev[1].elapsed_time(ev[2]),
        "total_s": total, "upload_tree_s": upload_s,
        "h2d_bytes": chs_np.nbytes + data_np.nbytes,
        "peak_allocated_bytes": peak, "allocated_before_bytes": base}}
    log(json.dumps(line))
    return line


def time_k3(chs, lut, N=2, levels=9, cap=12):
    """Each K3 entry alone on the headline tree as upload_tree calls it, by
    CUDA events: the build from chs, and the skip distances on a copy of
    ``lut`` (the LUT without distances) restored before each call, outside
    the timed window."""
    import torch
    from rt_octree_tpu_torch.ops import traversal as T
    buf = lut.clone()
    res = N ** levels
    build_ms = cuda_ms(lambda: T.build_lut(chs, N, levels), 5, 1)
    require(bool(torch.equal(T.build_lut(chs, N, levels), lut)),
            "the timed build disagrees with the checked LUT")
    return (build_ms,
            cuda_ms(lambda: T.add_skip_distances(buf, res, cap), 5, 1,
                    flush=lambda: buf.copy_(lut)))


def load_only(tree_path):
    """--load-only: two loads of ``tree_path`` and K3's entry times, with
    the package beside this file."""
    import torch
    from rt_octree_tpu_torch.native import build as native
    from rt_octree_tpu_torch.ops import traversal as T
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    log(f"{smi[0]} ({HERE})")
    t0 = time.time()
    native.build()
    log(f"[build] in {time.time() - t0:.1f} s")
    torch.zeros(1, device="cuda")
    for rep_ in range(2):
        measure_load(tree_path, {"rep": rep_})
    from rt_octree_tpu_torch.io import n3tree
    chs = T.upload_tree(n3tree.load(tree_path), lut_levels=0,
                        device="cuda").chs
    lut = T.build_lut(chs, 2, 9)
    b_ms, s_ms = time_k3(chs, lut)
    log(json.dumps({"k3_ms": {"lut_build": b_ms, "skip_distances": s_ms,
                              "root": HERE}}))
    return 0


LOAD_KEYS = ("read_s", "host_prep_s", "h2d_s", "k3_s", "lut_build_ms",
             "skip_distances_ms", "renderer_s", "first_frame_s", "total_s",
             "upload_tree_s", "peak_allocated_bytes")


def load_pairs(other_root, pairs):
    """--load-pairs: ``pairs`` pairs of --load-only processes, OTHER_ROOT's
    and this checkout's in turns, on the headline npz; each side's least
    value, quartiles and largest value of each step, for the first load of
    a process ("fresh"), its second ("warm") and K3's entries alone."""
    other_root = os.path.abspath(other_root)
    require(os.path.isfile(os.path.join(other_root, "chip_smoke.py")),
            f"no chip_smoke.py in {other_root}")
    tree_path = os.path.join(WORK, "shell_d9_sh9.npz")
    if not os.path.isfile(tree_path):
        headline_tree_path()
    roots = {"other": other_root, "this": HERE}
    runs = {side: {"fresh": [], "warm": [], "k3_ms": []} for side in roots}
    raw = os.path.join(WORK, "load_pairs.jsonl")
    with open(raw, "w") as f:
        for i in range(pairs):
            for side in (("other", "this") if i % 2 == 0
                         else ("this", "other")):
                t0 = time.perf_counter()
                out = subprocess.run(
                    [sys.executable, os.path.join(roots[side],
                                                  "chip_smoke.py"),
                     "--load-only", tree_path], capture_output=True,
                    text=True, cwd=roots[side])
                require(out.returncode == 0,
                        f"{side} load {i} failed:\n{out.stderr[-3000:]}")
                lines = [json.loads(ln) for ln in out.stdout.splitlines()
                         if ln.startswith("{")]
                loads = [ln["load"] for ln in lines if "load" in ln]
                k3 = [ln["k3_ms"] for ln in lines if "k3_ms" in ln]
                require(len(loads) == 2 and len(k3) == 1,
                        f"{side} load {i}: unexpected output")
                runs[side]["fresh"].append(loads[0])
                runs[side]["warm"].append(loads[1])
                runs[side]["k3_ms"].append(k3[0])
                f.write(json.dumps({"pair": i, "side": side,
                                    "root": roots[side], "loads": loads,
                                    "k3_ms": k3[0]}) + "\n")
                log(f"[load-pairs] pair {i} {side}: warm sum "
                    f"{loads[1]['total_s']:.3f} s, process "
                    f"{time.perf_counter() - t0:.1f} s")

    def spread(values):
        q = np.percentile(values, [0, 25, 50, 75, 100])
        return dict(zip(("min", "q1", "median", "q3", "max"),
                        map(float, q)))
    summary = {"pairs": pairs, "order": "other, this, this, other, ...",
               "roots": roots, "raw": os.path.relpath(raw, HERE)}
    for side, r in runs.items():
        summary[side] = {
            **{kind: {k: spread([ld[k] for ld in r[kind]])
                      for k in LOAD_KEYS} for kind in ("fresh", "warm")},
            "k3_ms": {k: spread([x[k] for x in r["k3_ms"]])
                      for k in ("lut_build", "skip_distances")}}
    # within each pair: this checkout's sum less the other's
    summary["total_s_this_less_other"] = {
        kind: spread([a["total_s"] - b["total_s"] for a, b in zip(
            runs["this"][kind], runs["other"][kind])])
        for kind in ("fresh", "warm")}
    log(json.dumps({"load_pairs": summary}))
    return 0


def make_drawlist():
    """The second run's drawlist (as tests/test_apps.py:366-369 writes
    one), read back with the port's io/mesh.py."""
    from rt_octree_tpu_torch.io.mesh import load_drawlist
    path = os.path.join(WORK, "marker.draw.npz")
    np.savez_compressed(path, marker="cube",
                        marker__color=np.array([0.9, 0.1, 0.1]),
                        marker__scale=0.4)
    meshes = load_drawlist(path)
    require(len(meshes) == 1 and meshes[0].n_verts == 8, "drawlist")
    return path


# The main paths: label -> (CLI flags after the tree and the poses, the
# kernels that must launch in that run).  The probe sits on the shell
# (world radius 0.6 of the shell tree).
def main_paths(draw_path):
    net = lambda name: os.path.join(KIT, name)  # noqa: E731
    common = ["--spp", "6", "--lut_levels", "9", "--warmup", "3",
              "--device", "cuda"]
    return {
        "headline": (["--gnet", net("trained.gnet")] + common,
                     ("render", "guidance_net", "guided_filter",
                      "lut_build", "skip_distances")),
        "fast s=0.5": (["--render_scale", "0.5", "--gnet", net("fast.gnet")]
                       + common, ("render", "upsample", "guidance_net",
                                  "guided_filter")),
        "fast s=0.4": (["--render_scale", "0.4",
                        "--gnet", net("fast_s0.4.gnet")] + common,
                       ("render", "upsample", "guidance_net",
                        "guided_filter")),
        "mesh, grid, probe, classic": (
            ["--draw", draw_path, "--grid", "4", "--probe", "0.6,0,0",
             "--estimator", "classic", "--gnet", net("trained.gnet")]
            + common, ("render_classic", "guidance_net", "guided_filter")),
    }


def phase_main(native, tree_path, label, flags, required, dispatcher=False):
    """One headless run (``dispatcher``: through ``rtoctree render``, the
    port's apps/cli.py) with the launch counts reset just before it and
    read just after; returns the counts."""
    from rt_octree_tpu_torch.apps import cli, headless
    from rt_octree_tpu_torch.io.png import read_png
    out_dir = os.path.join(WORK, "frames_" + label.split(",")[0].replace(
        " ", "_").replace("=", ""))
    argv = [tree_path, os.path.join(KIT, "transforms_test.json"),
            "-o", out_dir] + flags
    shown = " ".join(os.path.relpath(a, HERE) if os.sep in a else a
                     for a in argv)
    log(f"[main] {label}: {'cli render' if dispatcher else 'headless'} "
        f"{shown}")
    native.reset_launches()
    t0 = time.time()
    rc = cli.main(["render"] + argv) if dispatcher else headless.run(argv)
    counts = dict(native.LAUNCHES)
    log(f"[main] {label}: rc {rc} in {time.time() - t0:.1f} s; launches "
        f"{counts}")
    require(rc == 0, f"headless run failed ({label})")
    require(all(counts[k] > 0 for k in required),
            f"a kernel of the main path never launched ({label}): {counts}")
    for i in range(8):
        img = read_png(os.path.join(out_dir, f"r_{i}.png"))
        require(img.shape == (800, 800, 4), f"frame r_{i}: {img.shape}")
    return counts


def phase_tool(native, label, argv, outputs):
    """One run of the dispatcher's ``lod`` or ``compress`` (host NumPy)
    with the launch counts reset just before it and read just after: it
    must launch no kernel and write ``outputs``; returns the counts."""
    from rt_octree_tpu_torch.apps import cli
    shown = " ".join(os.path.relpath(a, HERE) if os.sep in a else a
                     for a in argv)
    log(f"[main] {label}: cli {shown}")
    native.reset_launches()
    t0 = time.time()
    rc = cli.main(argv)
    counts = dict(native.LAUNCHES)
    log(f"[main] {label}: rc {rc} in {time.time() - t0:.1f} s; launches "
        f"{counts}")
    require(rc == 0, f"{label} failed")
    require(not any(counts.values()), f"{label} launched a kernel: {counts}")
    require(all(os.path.isfile(o) for o in outputs), f"{label}: no output")
    return counts


def tool_paths(tree_path, quant_src):
    """The dispatcher's host commands on the main path: label -> (argv,
    the files it must write).  ``lod`` pools the headline tree to depth 8;
    ``compress`` quantizes the quant phase's depth-7 shell."""
    qdir = os.path.join(WORK, "quant")
    lod_out = os.path.join(WORK, "shell_d9_lod8.npz")
    return {
        "cli lod": (["lod", tree_path, "-d", "8", "-o", lod_out], [lod_out]),
        "cli compress": (["compress", quant_src, "--out_dir", qdir,
                          "--retain", "1", "--overwrite"],
                         [os.path.join(qdir, os.path.basename(quant_src))]),
    }


def make_headline_renderer(tree):
    from rt_octree_tpu_torch.io.poses import load_poses
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.render.renderer import Renderer
    ps = load_poses("blender", os.path.join(KIT, "transforms_test.json"),
                    800, 800)
    dt = upload_tree(tree, lut_levels=9, device="cuda")
    r = Renderer(dt, 800, 800, ps.fx, ps.fy, options=headline_options())
    r.set_denoiser(os.path.join(KIT, "trained.gnet"))
    return r, ps


def quality_psnr(r, poses, kit=KIT):
    """bench.quality_report's protocol: per pose rng.seed(20230418, 1),
    noisy then denoised, whole-image PSNR vs the committed GT PNGs of
    ``kit`` -> (noisy mean, denoised mean, per-pose lists); every frame
    must be finite."""
    from rt_octree_tpu_torch.io.png import read_png
    acc = {"noisy": [], "denoised": []}
    for i, pose in enumerate(poses[:8]):
        gt = read_png(os.path.join(kit, "test", f"r_{i}.png"))[..., :3]
        r.rng.seed(20230418, 1)
        for mode in ("noisy", "denoised"):
            r.options.denoise = mode == "denoised"
            img = r.render(pose, want_aux=False)[0].cpu().numpy()
            require(img.shape == (r.height, r.width, 4)
                    and np.isfinite(img).all(), f"pose {i} {mode}: bad frame")
            acc[mode].append(psnr(img, gt))
    r.options.denoise = True
    return float(np.mean(acc["noisy"])), float(np.mean(acc["denoised"])), acc


def phase_quality(r, poses, label="headline",
                  bars=(GATE_NOISY, GATE_DENOISED), kit=KIT):
    """bench.quality_report's protocol: per pose rng.seed(20230418, 1),
    noisy then denoised, whole-image PSNR vs the committed GT PNGs of
    ``kit``, held to the JAX package's CPU bars."""
    bar_noisy, bar_den = bars
    noisy, den, acc = quality_psnr(r, poses, kit)
    log(f"[quality] {label}, 8 poses, whole-image PSNR: noisy {noisy:.3f} "
        f"dB (JAX {bar_noisy}), denoised {den:.3f} dB (JAX {bar_den})")
    for mode in ("noisy", "denoised"):
        log(f"[quality] {label} per pose {mode} "
            f"{[round(float(v), 3) for v in acc[mode]]}")
    require(abs(noisy - bar_noisy) <= GATE_NOISY_TOL,
            f"{label}: noisy PSNR {noisy:.3f} not within {GATE_NOISY_TOL} dB")
    require(abs(den - bar_den) <= GATE_DENOISED_TOL,
            f"{label}: denoised PSNR {den:.3f} not within "
            f"{GATE_DENOISED_TOL} dB")
    return noisy, den


def k1_stats(tree, st, kw, frame):
    """K1's statistics on one frame as a dict; K1's bound (ms, "bytes" or
    "operations") from what the frame reads."""
    import torch
    from rt_octree_tpu_torch.render import renderer as R
    steps = st.steps.flatten().float()
    p50, p99 = torch.quantile(
        steps, torch.tensor([0.5, 0.99], device=steps.device)).tolist()
    n = kw["width"] * kw["height"]
    # the timed call writes img, aux_nhwc and aux_chw: 16 + 32 + 32 B a
    # pixel; it reads the pose, each LUT cell and chs row once (8 B) and
    # each shaded f16 row once
    nbytes = (80 * n + 48 + 8 * (st.lut_cells + st.chs_rows)
              + 2 * tree.data_dim * st.data_rows)
    ops = (K1_OPS_PER_STEP * float(steps.sum())
           + (6 * max(tree.basis_dim, 0) + 16) * st.data_rows)
    b_ms, b_by = bound(nbytes, ops)
    return {
        "frame": frame, "steps_mean": float(steps.mean()), "steps_p50": p50,
        "steps_p99": p99, "steps_max": int(steps.max()),
        "rays_stepping": int((steps > 0).sum()), "rays": n,
        "steps_total": int(steps.sum()),
        "descents_total": int(st.descents.sum()),
        "lane_efficiency": {f"{w}x{h}": R.lane_efficiency(st.steps, w, h)
                            for w, h in ((32, 1), (8, 4), (4, 8))},
        "lut_cells": st.lut_cells, "chs_rows": st.chs_rows,
        "data_rows": st.data_rows, "bound_bytes": nbytes,
        "bound_f32_ops": ops, "bound_us": b_ms * 1e3,
        "bound_by": b_by}, b_ms, b_by


def k1_stats_line(r, st, kw):
    """K1's statistics on the headline frame as one JSON line; returns
    K1's bound (ms, "bytes" or "operations")."""
    stats, b_ms, b_by = k1_stats(
        r.tree, st, kw, f"{kw['width']}x{kw['height']} spp {kw['opt'].spp} "
        "depth-9 shell, level-9 LUT, pose r_0")
    log(json.dumps({"k1_stats": stats}))
    return b_ms, b_by


def phase_headline(r, ps, err):
    """Every kernel against its plain version on the main path's own
    inputs (the 800x800 SPP 6 frame of the depth-9 tree, the net's real
    activation, the 512^3 LUT), K1's statistics, then each kernel's time
    and bound."""
    import torch
    from rt_octree_tpu_torch.ops import traversal as T
    from rt_octree_tpu_torch.ops.filtering import (guided_filter,
                                                   guided_filter_act_plain)
    from rt_octree_tpu_torch.render import renderer as R
    from rt_octree_tpu_torch.utils.timer import PhaseTimer
    ms, bounds = {}, {}
    pose = ps.poses[0]
    tf = r._transform(pose)
    kw = dict(width=800, height=800, fx=r.fx, fy=r.fy, opt=r.options)
    st, inc = r.rng.state, r.rng.inc
    n = 800 * 800

    ik, nk, ck = R.render_noisy(r.tree, tf, st, inc, **kw)
    ip, npl, cp = R.render_noisy_plain(r.tree, tf, st, inc, **kw)
    e_img = float((ik - ip).abs().max())
    e_aux = max(float((ck - cp).abs().max()), float((nk - npl).abs().max()))
    log(f"[headline] K1 800x800 spp 6 depth-9 LUT-9 pose r_0: max|img "
        f"diff| {e_img:.3g}, max|aux diff| {e_aux:.3g}")
    require(bool(torch.isfinite(ik).all()), "K1 headline image not finite")
    require(e_img <= K1_IMG_TOL and e_aux <= K1_AUX_TOL,
            "K1 disagrees with its plain version on the headline frame")
    err["render"] = max(err["render"], e_img, e_aux)
    del ip, npl, cp
    stats = R.render_stats(r.tree, tf, st, inc, **kw)
    same = stats.equals(R.render_stats_plain(r.tree, tf, st, inc, **kw))
    log(f"[headline] K1 statistics variant == plain march's counts: {same}")
    require(same, "K1's statistics disagree with the plain march's")
    bounds["render"] = k1_stats_line(r, stats, kw) + (None,)

    hold_k7("headline aux 800x800 (K1, pose r_0), trained.gnet", r.net,
            nk[None], err)
    act = r.net_forward(nk)
    img = ik
    sup = r.net_cfg.supports()
    log(f"[headline] net activation {tuple(act.shape)} {act.dtype}, "
        f"strides {act.stride()}")
    e = float((guided_filter(act, img, sup)
               - guided_filter_act_plain(act, img, sup)).abs().max())
    log(f"[headline] K2 on the net's activation (supports {sup}): "
        f"max|diff| {e:.3g}")
    require(e <= K2_TOL, "K2 disagrees with its plain version on the "
            "headline frame")
    err["guided_filter"] = max(err["guided_filter"], e)
    L = act.shape[1] // 2
    taps = sum((2 * s + 1) ** 2 for s in sup if s > 0)
    # the activation at 2 B, rgb at 12 B and the output at 16 B a pixel;
    # per window tap a subtraction, an expf, an add and three multiply-adds
    # (9 operations), per pixel a softmax over L and the level blend
    bounds["guided_filter"] = bound(
        act.numel() * 2 + n * (12 + 16), n * (9 * taps + 10 * L)) + (None,)

    chs = r.tree.chs
    lut_k = T.build_lut(chs, 2, 9)
    lut_p = T.lut_build_plain(chs, 2, 9)
    d_lut = int((lut_k.long() - lut_p.long()).abs().max())
    skip_k = T.add_skip_distances(lut_k.clone(), 512, 12)
    skip_p = T.add_skip_distances_plain(lut_p, 512, 12)
    d_skip = int((skip_k.long() - skip_p.long()).abs().max())
    same_upload = bool(torch.equal(skip_k, r.tree.lut))
    log(f"[headline] K3 512^3 LUT: lut max|diff| {d_lut}, skip max|diff| "
        f"{d_skip}, equal to the uploaded tree's LUT: {same_upload}")
    require(d_lut == 0 and d_skip == 0 and same_upload,
            "K3 disagrees with its plain version at 512^3")
    err["lut_build"] = max(err["lut_build"], float(d_lut))
    err["skip_distances"] = max(err["skip_distances"], float(d_skip))
    del lut_p, skip_k, skip_p
    cells = 512 ** 3
    # lut_build writes the 8-byte cells and reads chs once; the skip
    # distances need only the sigma lane, read (4 B a cell) and written
    # (4 B), with 12 rounds of a separable 3x3x3 min (6 operations a cell a
    # round)
    bounds["lut_build"] = bound(8 * cells + chs.numel() * 4) + (None,)
    bounds["skip_distances"] = bound(8 * cells, 12 * 6 * cells) + (None,)

    ms["render"] = (
        cuda_ms(lambda: R.render_noisy(r.tree, tf, st, inc, **kw), 20, 3),
        cuda_ms(lambda: R.render_noisy_plain(r.tree, tf, st, inc, **kw), 2))
    ms["guided_filter"] = (
        cuda_ms(lambda: guided_filter(act, img, sup), 50, 3),
        cuda_ms(lambda: guided_filter_act_plain(act, img, sup), 5))
    k_ms, p_ms, l_ms = time_k7("headline aux, trained.gnet", r.net, nk[None],
                               err)
    ms["guidance_net"] = (k_ms, p_ms)
    bounds["guidance_net"] = k7_bound(r.net, n) + (l_ms,)
    k3_ms = time_k3(chs, lut_k)
    ms["lut_build"] = (k3_ms[0],
                       cuda_ms(lambda: T.lut_build_plain(chs, 2, 9), 1))
    ms["skip_distances"] = (
        k3_ms[1], cuda_ms(lambda: T.add_skip_distances_plain(lut_k, 512, 12),
                          1))
    del lut_k
    for k, (kms, pms) in ms.items():
        log(f"[timing] {k}: kernel {kms:.4f} ms, plain {pms:.3f} ms, bound "
            f"{bounds[k][0]:.4f} ms ({bounds[k][1]})")

    def frame():
        r.render(pose, want_aux=False)
        r.advance_rng()
    frame_ms = cuda_ms(frame, 20, 3)
    timer = PhaseTimer("cuda")
    for _ in range(20):
        R.render_timed(r, pose, timer)
        r.advance_rng()
    log(f"[timing] headline frame (800x800, SPP 6, denoise on, depth-9 "
        f"shell, pose r_0): {frame_ms:.3f} ms/frame "
        f"({1000.0 / frame_ms:.2f} FPS) over 20 frames")
    log(timer.report())
    return ms, bounds


def frame_timing(r, pose, label):
    """ms/frame of ``r`` by CUDA events over 20 back-to-back frames (RNG
    advanced each frame), then the PhaseTimer split of 20 render_timed
    frames."""
    from rt_octree_tpu_torch.render import renderer as R
    from rt_octree_tpu_torch.utils.timer import PhaseTimer

    def frame():
        r.render(pose, want_aux=False)
        r.advance_rng()
    frame_ms = cuda_ms(frame, 20, 3)
    timer = PhaseTimer("cuda")
    for _ in range(20):
        R.render_timed(r, pose, timer)
        r.advance_rng()
    log(f"[timing] {label} frame: {frame_ms:.3f} ms/frame "
        f"({1000.0 / frame_ms:.2f} FPS) over 20 frames")
    log(timer.report())
    return frame_ms, timer.means_ms()


def phase_fast_classic(r, ps, err, tree_host):
    """The slice's new paths on the headline tree: render_classic vs its
    plain version at 800x800, without a mesh pass and with the fourth CLI
    run's drawlist pass, with its statistics, bound and time; K4 at
    400->800 against F.interpolate; the classic gate; each fast frame held
    at its own shapes (hold_fast), its gate, time and phase split; the
    probe overlay and the host rasterizer as plain rows.  Returns (ms,
    bounds) of the two new kernels."""
    import torch
    import torch.nn.functional as F
    from rt_octree_tpu_torch.core.camera import Camera
    from rt_octree_tpu_torch.io.mesh import load_drawlist
    from rt_octree_tpu_torch.ops.resize import (fast_upsample,
                                                fast_upsample_plain)
    from rt_octree_tpu_torch.render import renderer as R
    from rt_octree_tpu_torch.render.raster import rasterize_meshes
    ms, bounds = {}, {}
    pose = ps.poses[0]
    n = 800 * 800

    # render_classic on the headline tree, 800x800
    opt = headline_options()
    opt.estimator = "classic"
    rc = R.Renderer(r.tree, 800, 800, r.fx, r.fy, options=opt)
    rc.set_denoiser(os.path.join(KIT, "trained.gnet"))
    tf = rc._transform(pose)
    kw = dict(width=800, height=800, fx=r.fx, fy=r.fy, opt=opt)
    plain = hold_k1("headline tree 800x800 classic, pose r_0", r.tree, tf,
                    kw, "render_classic", err)[0][0]
    # with the drawlist's pass, rasterized as the fourth CLI run composites
    # it (background 1, pose r_0)
    cam = Camera(800, 800, r.fx, r.fy)
    cam.set_pose(pose)
    meshes = load_drawlist(make_drawlist())
    color, depth = rasterize_meshes(meshes, cam,
                                    background=np.ones(3, np.float32))
    covered = int(np.isfinite(depth).sum())
    with_mesh = hold_k1(
        f"headline tree 800x800 classic + drawlist pass ({covered} px), "
        "pose r_0", r.tree, tf, kw, "render_classic", err,
        mesh_color=torch.from_numpy(color.reshape(-1, 3)).cuda(),
        mesh_depth=torch.from_numpy(depth.reshape(-1)).cuda())[0][0]
    # the cube sits inside the shell, whose front wall stops the rays
    # before it: the pass may change no pixel, only clip the rays behind
    changed = int((with_mesh[..., :3] != plain[..., :3]).any(-1).sum())
    log(f"[headline] the drawlist pass changes {changed} px of the classic "
        "frame")
    require(covered > 0, "the drawlist pass covers no pixel")
    st = R.render_stats(r.tree, tf, 0, 0, **kw)
    same = st.equals(R.render_stats_plain(r.tree, tf, 0, 0, **kw))
    log(f"[headline] render_classic statistics == plain march's counts: "
        f"{same}")
    require(same, "render_classic's statistics disagree with the plain "
            "march's")
    steps = float(st.steps.sum())
    # as K1's bound: the three outputs, each LUT cell and chs row read once
    # (8 B), each shaded f16 row once; a classic step shades
    nbytes = (80 * n + 48 + 8 * (st.lut_cells + st.chs_rows)
              + 2 * r.tree.data_dim * st.data_rows)
    ops = (K1_OPS_PER_STEP + 6 * max(r.tree.basis_dim, 0) + 16) * steps
    bounds["render_classic"] = bound(nbytes, ops) + (None,)
    log(json.dumps({"classic_stats": {
        "frame": "800x800 classic depth-9 shell, level-9 LUT, pose r_0",
        "steps_total": int(steps), "steps_max": int(st.steps.max()),
        "rays_stepping": int((st.steps > 0).sum()),
        "lut_cells": st.lut_cells, "chs_rows": st.chs_rows,
        "data_rows": st.data_rows, "bound_bytes": nbytes,
        "bound_f32_ops": ops, "bound_us": bounds["render_classic"][0] * 1e3,
        "bound_by": bounds["render_classic"][1]}}))
    ms["render_classic"] = (
        cuda_ms(lambda: R.render_noisy(r.tree, tf, 0, 0, **kw), 20, 3),
        cuda_ms(lambda: R.render_noisy_plain(r.tree, tf, 0, 0, **kw), 1))

    # K4 at the s = 0.5 frame's size, with aux_chw as the CLI's frames
    # take it (16 B read per inner pixel, 80 B written per output pixel);
    # device_ms, as the kernel is shorter than its wrapper's host code
    aux = upsample_input(400, 400)
    rgba = aux[..., :4].permute(2, 0, 1)[None].contiguous()
    ms["upsample"] = (
        device_ms(lambda: fast_upsample(aux, 800, 800), 200, 10),
        device_ms(lambda: fast_upsample_plain(aux, 800, 800), 20, 3))
    lib_ms = device_ms(lambda: F.interpolate(
        rgba, size=(800, 800), mode="bilinear", align_corners=False,
        antialias=False), 200, 10)
    bounds["upsample"] = bound(16 * 400 * 400 + 80 * n) + (lib_ms,)
    no_aux = device_ms(lambda: fast_upsample(aux, 800, 800, False), 200, 10)
    log(f"[timing] upsample 400->800 without aux_chw: {no_aux:.4f} ms "
        f"(bound {bound(16 * 400 * 400 + 48 * n)[0]:.4f} ms)")
    for k in ("render_classic", "upsample"):
        log(f"[timing] {k}: kernel {ms[k][0]:.4f} ms, plain {ms[k][1]:.3f} "
            f"ms, bound {bounds[k][0]:.4f} ms ({bounds[k][1]}), library "
            + ("none" if bounds[k][2] is None else f"{bounds[k][2]:.4f} ms"))
    del aux, rgba

    # quality gates and frame times
    phase_quality(rc, ps.poses, "classic", GATE_CLASSIC)
    for scale, (gnet, g_noisy, g_den) in GATES_FAST.items():
        rf = R.Renderer(r.tree, 800, 800, r.fx, r.fy,
                        options=headline_options(), render_scale=scale)
        rf.set_denoiser(os.path.join(KIT, gnet))
        hold_fast(rf, pose, err)
        phase_quality(rf, ps.poses, f"fast s={scale} ({gnet})",
                      (g_noisy, g_den))
        frame_timing(rf, pose, f"fast s={scale} ({rf.inner_width}x"
                     f"{rf.inner_height} march, 800x800 out, {gnet})")

    # plain rows: the probe overlay (tensor code on the card) and the
    # host rasterizer (NumPy)
    rc.options.enable_probe = True
    rc.options.probe = (0.6, 0.0, 0.0)
    img = rc.render(pose, want_aux=False)[0]
    probe_ms = cuda_ms(lambda: rc.probe_overlay(img, pose), 50, 3)
    t0 = time.perf_counter()
    rasterize_meshes(meshes, cam, background=np.ones(3, np.float32))
    raster_s = time.perf_counter() - t0
    rg = R.Renderer(r.tree, 800, 800, r.fx, r.fy, options=headline_options())
    t0 = time.perf_counter()
    rg.set_grid_mesh(tree_host, 2)
    color, depth = rg._grid_mesh_pass(pose, None, None)
    grid_s = time.perf_counter() - t0
    log(json.dumps({"plain_rows": {
        "probe_overlay_ms": probe_ms,
        "probe_overlay": "800x800 frame, probe_disp_size 100, on the card",
        "rasterize_drawlist_s": raster_s,
        "rasterize_drawlist": "one cube, 800x800, host NumPy",
        "grid_pass_s": grid_s,
        "grid_pass": f"wireframe to depth 2 ({int(np.isfinite(depth).sum())}"
                     " px), 800x800, host NumPy"}}))
    return ms, bounds


def train_argv(kit, epochs, task="train"):
    """``rtoctree train`` on the kit with configs/blender.txt: a checkpoint
    and a .gnet every epoch, no test inside the run."""
    return ["train", "--config", os.path.join(HERE, "configs", "blender.txt"),
            "--task", task, "--data_dir", kit,
            "--logs_root", os.path.join(WORK, "train_logs"),
            "--exp_name", "shell", "--epochs", str(epochs), "--i_save", "1",
            "--device", "cuda"]


def train_cli(native, label, argv, required=(), absent=()):
    """One ``rtoctree train`` run with the launch counts reset just before
    it and read just after; returns the counts."""
    from rt_octree_tpu_torch.apps import cli
    log(f"[train] {label}: cli train " + " ".join(
        os.path.relpath(a, HERE) if os.sep in a else a for a in argv[1:]))
    native.reset_launches()
    t0 = time.time()
    rc = cli.main(argv)
    counts = dict(native.LAUNCHES)
    log(f"[train] {label}: rc {rc} in {time.time() - t0:.1f} s; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    require(rc == 0, f"rtoctree train failed ({label})")
    require(all(counts[k] > 0 for k in required),
            f"a kernel of the train path never launched ({label})")
    require(not any(counts[k] for k in absent),
            f"{label} launched a training kernel")
    return counts


def train_step_split(runner, batch, reps=20, warmup=5):
    """Mean ms of the training step over ``reps`` steps after ``warmup``,
    by CUDA events: the whole step (Runner.train_step), then the same step
    staged as net forward, K5, loss (forward and backward), K6, net
    backward and Adam (the gradients cut at the filter's inputs and
    output, so each part is its own span)."""
    import torch
    from rt_octree_tpu_torch.ops.filtering import guided_filter_batch
    aux, img, gt = batch
    whole = cuda_ms(lambda: runner.train_step(aux, img, gt), reps, warmup)
    names = ("net_forward", "k5", "loss", "k6", "net_backward", "adam")
    sums = dict.fromkeys(names, 0.0)
    for it in range(warmup + reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        runner.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        w, g = runner.model(aux.permute(0, 2, 3, 1))
        ev[1].record()
        wd, gd = w.detach().requires_grad_(), g.detach().requires_grad_()
        out = guided_filter_batch(wd, gd, img, runner.supports)
        ev[2].record()
        od = out.detach().requires_grad_()
        runner.loss_fn(od[..., :3], gt[..., :3]).backward()
        ev[3].record()
        out.backward(od.grad)
        ev[4].record()
        torch.autograd.backward([w, g], [wd.grad, gd.grad])
        ev[5].record()
        runner.optimizer_step()
        ev[6].record()
        torch.cuda.synchronize()
        if it >= warmup:
            for i, k in enumerate(names):
                sums[k] += ev[i].elapsed_time(ev[i + 1])
    split = {k: v / reps for k, v in sums.items()}
    return whole, split


def phase_train(native, r, tree_path, err):
    """The training path: a kit rendered by the port from the headline
    tree; K5 and K6 held against their plain versions on a real batch of
    32 80x80 slices (the net's weight and guidance, the loss's gradient)
    with the identity supports and the ladder; the f32 train step with
    the kernels against the plain chain; ``rtoctree train`` on the
    canonical config for TRAIN_EPOCHS epochs, a resume of one more, the
    test and compact tasks; the exported .gnet in the headline Renderer
    (PSNR on benchmarks/quality's 8 poses, no bar); the step's time and
    split; K5's and K6's times and bounds.  Prints {"train": ...} and
    returns (launch counts, ms, bounds) of K5 and K6."""
    import torch
    from rt_octree_tpu_torch.models.guidance_net import (GuidanceNet,
                                                         params_to_numpy)
    from rt_octree_tpu_torch.ops.filtering import (
        guided_filter_backward_plain, guided_filter_batch,
        guided_filter_batch_bwd, guided_filter_batch_fwd,
        guided_filter_batch_plain)
    from rt_octree_tpu_torch.tools import make_quality_dataset as mq
    from rt_octree_tpu_torch.train.config import parse_args
    from rt_octree_tpu_torch.train.dataset import (BlenderDataset,
                                                   DatasetConfig)
    from rt_octree_tpu_torch.train.runner import Runner
    out = {}
    kit = os.path.join(WORK, "train_kit")
    t0 = time.time()
    if not os.path.isfile(os.path.join(kit, "transforms_test.json")):
        require(mq.main(["--out", kit, "--tree", tree_path,
                         "--device", "cuda"]) == 0, "kit build failed")
    out["kit_s"] = time.time() - t0
    t0 = time.time()
    ds = BlenderDataset(DatasetConfig(data_dir=kit, spp=6, nx=10, ny=10))
    out["load_s"] = time.time() - t0
    args = parse_args(train_argv(kit, TRAIN_EPOCHS)[1:])
    out["slices"] = len(ds.splits["train"].aux)
    out["steps_per_epoch"] = ds.num_batches("train", args.batch_size)
    log(f"[train] kit {out['kit_s']:.1f} s, loaded in {out['load_s']:.1f} s:"
        f" {out['slices']} train slices of 80x80 (of 3200), "
        f"{out['steps_per_epoch']} steps of {args.batch_size} an epoch")

    # ---- K5 / K6 on a real batch ----
    runner = Runner(args, dataset=ds)
    aux_all, in_all, gt_all = ds.device_split("train", "cuda")
    idx = torch.from_numpy(next(ds.iter_batch_indices(
        "train", args.batch_size, shuffle=True, seed=1))).cuda()
    batch = (aux_all[idx], in_all[idx], gt_all[idx])
    aux, img, gt = batch
    with torch.no_grad():
        w, g = runner.model(aux.permute(0, 2, 3, 1))
    w, g = w.contiguous(), g.contiguous()
    worst = {"guided_filter_batch": 0.0, "guided_filter_batch_bwd": 0.0}
    for label, sup in (("ladder", (1, 2, 3, 4)), ("identity", (0, 1, 2, 3))):
        ref = guided_filter_batch_plain(w, g, img, sup).requires_grad_()
        runner.loss_fn(ref[..., :3], gt[..., :3]).backward()
        G = ref.grad
        ref = ref.detach()
        o, saved = guided_filter_batch_fwd(w, g, img, sup)
        e5 = float((o - ref).abs().max())
        gw, gg = guided_filter_batch_bwd(G, w, g, img, saved, sup)
        rw, rg = guided_filter_backward_plain(G, w, g, img, sup)
        e_w, e_g = float((gw - rw).abs().max()), float((gg - rg).abs().max())
        m_w, m_g = float(rw.abs().max()), float(rg.abs().max())
        log(f"[train] K5 {label} {tuple(w.shape)}: max|diff| {e5:.3g}; K6 "
            f"dL/dw max|diff| {e_w:.3g} of {m_w:.3g}, dL/dg {e_g:.3g} of "
            f"{m_g:.3g}; guidance range {float(g.max() - g.min()):.3g}")
        require(e5 <= K5_TOL and bool(torch.isfinite(o).all()),
                f"K5 disagrees with its plain version ({label})")
        require(e_w <= K6_REL_TOL * m_w and e_g <= K6_REL_TOL * m_g
                and bool(torch.isfinite(gg).all()),
                f"K6 disagrees with its plain version ({label})")
        worst["guided_filter_batch"] = max(worst["guided_filter_batch"], e5)
        worst["guided_filter_batch_bwd"] = max(
            worst["guided_filter_batch_bwd"], e_w, e_g)
    err.update(worst)

    # ---- the f32 train step: kernels vs the plain chain ----
    grads = {}
    for route in ("kernels", "plain"):
        net = GuidanceNet(runner.net_cfg, dtype=torch.float32).cuda()
        net.load_state_dict(runner.model.state_dict())
        wt, gt_ = net(aux.permute(0, 2, 3, 1))
        o = (guided_filter_batch(wt, gt_, img, runner.supports)
             if route == "kernels" else
             guided_filter_batch_plain(wt, gt_, img, runner.supports))
        loss = runner.loss_fn(o[..., :3], gt[..., :3])
        loss.backward()
        grads[route] = (loss.item(), params_to_numpy(
            runner.net_cfg, {n: p.grad for n, p in net.named_parameters()}))
    loss_k, gk = grads["kernels"]
    loss_p, gp = grads["plain"]
    worst_step = 0.0
    for bname in gp:
        for conv in gp[bname]:
            for leaf in ("kernel", "bias"):
                a, b = gk[bname][conv][leaf], gp[bname][conv][leaf]
                rel = float(np.abs(a - b).max() / np.abs(b).max())
                worst_step = max(worst_step, rel)
                require(rel <= STEP_RTOL, f"f32 train step: {bname}/{conv}/"
                        f"{leaf} gradient disagrees with the plain chain")
    log(f"[train] f32 step, kernels vs plain chain: loss {loss_k:.7g} vs "
        f"{loss_p:.7g}; gradients within {worst_step:.3g} of each "
        f"tensor's largest (bar {STEP_RTOL})")

    # ---- the main path: rtoctree train, resume, test, compact ----
    work = os.path.join(WORK, "train_logs", "shell")
    if os.path.isdir(work):
        import shutil
        shutil.rmtree(work)
    counts = train_cli(native, "train", train_argv(kit, TRAIN_EPOCHS),
                       required=TRAIN_KERNELS)
    steps = out["steps_per_epoch"] * TRAIN_EPOCHS
    require(all(counts[k] == steps for k in TRAIN_KERNELS),
            f"K5 / K6 launches {[counts[k] for k in TRAIN_KERNELS]} != "
            f"{steps} steps")
    c2 = train_cli(native, "resume", train_argv(kit, TRAIN_EPOCHS + 1),
                   required=TRAIN_KERNELS)
    require(all(c2[k] == out["steps_per_epoch"] for k in TRAIN_KERNELS),
            "the resume did not run one epoch")
    train_cli(native, "test", train_argv(kit, TRAIN_EPOCHS + 1, "test"),
              required=("guided_filter",), absent=TRAIN_KERNELS)
    train_cli(native, "compact",
              train_argv(kit, TRAIN_EPOCHS + 1, "compact"),
              absent=TRAIN_KERNELS)
    with open(os.path.join(work, "log.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    losses = [d["train/loss"] for d in logs if "train/loss" in d]
    tests = [d for d in logs if "test/psnr" in d]
    out["loss_per_epoch"] = losses
    out["test"] = {k.split("/")[1]: v for k, v in tests[-1].items()
                   if k.startswith("test/")}
    log(f"[train] loss per epoch {losses}; test split {out['test']}")
    require(len(losses) == TRAIN_EPOCHS + 1 and losses[-1] < losses[0],
            f"the loss did not fall: {losses}")
    gnet = os.path.join(work, "ts_latest.gnet")
    require(all(os.path.isfile(os.path.join(work, f)) for f in (
        "ts_latest.gnet", f"ts_{TRAIN_EPOCHS + 1:06d}.gnet",
        f"checkpoint_{TRAIN_EPOCHS + 1:06d}.pt")), "artifacts missing")

    # ---- the exported net in the headline Renderer ----
    from rt_octree_tpu_torch.io.poses import load_poses
    r.set_denoiser(gnet)
    ps = load_poses("blender", os.path.join(KIT, "transforms_test.json"),
                    800, 800)
    noisy, den, _ = quality_psnr(r, ps.poses)
    out["quality"] = {"noisy_db": noisy, "denoised_db": den}
    log(f"[train] the exported .gnet in the headline Renderer, 8 poses of "
        f"benchmarks/quality: noisy {noisy:.3f} dB, denoised {den:.3f} dB "
        f"({TRAIN_EPOCHS + 1} epochs; no bar)")

    # ---- the step's time and split; K5 and K6 alone ----
    runner.optimizer = runner.make_optimizer()
    runner._steps_per_epoch = out["steps_per_epoch"]
    whole, split = train_step_split(runner, batch)
    out["step_ms"] = whole
    out["step_split_ms"] = split
    log(f"[timing] train step (batch {args.batch_size} x 80x80, bf16 net, "
        f"K5, SMAPE, K6, Adam): {whole:.3f} ms over 20 steps; split "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    sup = runner.supports
    with torch.no_grad():
        w, g = runner.model(aux.permute(0, 2, 3, 1))
    w, g = w.contiguous(), g.contiguous()
    _, saved = guided_filter_batch_fwd(w, g, img, sup)
    G = torch.randn_like(img)
    # device_ms for the kernels: a call's host code may outlast its kernel
    ms = {"guided_filter_batch": (
              device_ms(lambda: guided_filter_batch_fwd(w, g, img, sup), 50,
                        3),
              cuda_ms(lambda: guided_filter_batch_plain(w, g, img, sup), 3)),
          "guided_filter_batch_bwd": (
              device_ms(lambda: guided_filter_batch_bwd(G, w, g, img, saved,
                                                        sup), 50, 3),
              cuda_ms(lambda: guided_filter_backward_plain(G, w, g, img,
                                                           sup), 3))}
    B, L, H, W = w.shape
    n, nl = B * H * W, B * L * H * W
    taps = sum((2 * s + 1) ** 2 for s in sup if s > 0)
    # K5: weight and guidance (8 B a pixel and level) and rgba (16 B) in,
    # out (16 B) and fm, den (20 B a pixel and level) written; a tap is a
    # subtraction, an expf, an add and three multiply-adds (9 operations),
    # a level's blend 6.  K6: G and rgba (32 B), weight, guidance, fm, den
    # (28 B a pixel and level) in, two gradients (8 B) out; a tap of the
    # gather is a subtraction, an expf, three multiply-adds for u.x, a
    # subtraction and a multiply-add (12 operations), a staged pixel 12
    bounds = {
        "guided_filter_batch": bound(n * 32 + nl * 28,
                                     n * (9 * taps + 6 * L)) + (None,),
        "guided_filter_batch_bwd": bound(n * 32 + nl * 36,
                                         n * (12 * taps + 12 * L)) + (None,)}
    for k, (kms, pms) in ms.items():
        log(f"[timing] {k} {tuple(w.shape)} supports {sup}: kernel "
            f"{kms:.4f} ms, plain {pms:.3f} ms, bound {bounds[k][0]:.4f} ms "
            f"({bounds[k][1]}), library none")
    out["k5_ms"], out["k6_ms"] = (ms["guided_filter_batch"][0],
                                  ms["guided_filter_batch_bwd"][0])
    log(json.dumps({"train": out}))
    return ({k: counts[k] for k in TRAIN_KERNELS}, ms, bounds)


def cached_tree(name, make):
    """The tree ``make()`` builds, saved as WORK/<name>.npz on the first
    call and read from there after."""
    from rt_octree_tpu_torch.io import n3tree, synthetic
    path = os.path.join(WORK, f"{name}.npz")
    t0 = time.perf_counter()
    if os.path.isfile(path):
        tree, how = n3tree.load(path), "read"
    else:
        tree, how = make(), "built"
        os.makedirs(WORK, exist_ok=True)
        synthetic.save_npz(tree, path)
    log(f"[trees] {name}: {tree.capacity} nodes, max depth "
        f"{tree.max_depth}, {how} in {time.perf_counter() - t0:.1f} s")
    return tree


def quant_source():
    """bench.py:quant_fidelity's float tree, saved for ``cli compress``."""
    from rt_octree_tpu_torch.io import synthetic
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, f"shell_d{QUANT_DEPTH}_sh9.npz")
    synthetic.save_npz(synthetic.make_synthetic_tree(
        "shell", depth=QUANT_DEPTH, basis_dim=9), path)
    return path


def scene_camera(cfg):
    """bench.py's camera of a scene (the llff one looks down -z from near
    the NDC origin)."""
    from rt_octree_tpu_torch.core.camera import Camera
    W, H = cfg["size"]
    f = cfg["focal"]
    cam = Camera(W, H) if f is None else Camera(W, H, fx=f, fy=f)
    if cfg["ndc"]:
        cam.center = np.array([0.02, 0.01, 0.3], np.float32)
        cam.v_back = np.array([0.0, 0.0, 1.0], np.float32)
        cam.v_world_up = np.array([0.0, 1.0, 0.0], np.float32)
        cam.update()
    return cam


def phase_scenes(err, quant_src):
    """Every scene and rung of SCENES through the Renderer: K1 vs its plain
    version on the scene's own frame (tt: its central 64x64 pixels, whose
    rays are the full frame's), fast rungs held at their own shapes
    (hold_fast: K1 at the inner size, K4 on its output, the frame vs the
    plain chain), K2 on the net's activation, the 8-pose gate against the
    JAX CPU bars, the frame time and phase split; then the quantized tree
    (K1 held on its decode, PSNR against the float frame, bytes ratio).
    Prints one {"scenes": ...} line."""
    import torch
    from rt_octree_tpu_torch.io import synthetic
    from rt_octree_tpu_torch.io.lod import build_lod
    from rt_octree_tpu_torch.io.n3tree import load as load_npz
    from rt_octree_tpu_torch.io.poses import load_poses
    from rt_octree_tpu_torch.ops.filtering import (guided_filter,
                                                   guided_filter_act_plain)
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.render import renderer as R
    from rt_octree_tpu_torch.core.options import RenderOptions
    from rt_octree_tpu_torch.core.camera import Camera
    trees, uploads, out = {}, {}, {}
    for label, cfg in SCENES.items():
        kind, lod = cfg["tree"], cfg["lod"]
        if kind not in trees:
            trees[kind] = cached_tree(f"{kind}_d9_sh9", lambda: (
                synthetic.make_synthetic_tree(kind, depth=9, basis_dim=9)))
            if cfg["ndc"]:
                W, H = cfg["size"]
                trees[kind].use_ndc = True
                trees[kind].ndc_width = float(W)
                trees[kind].ndc_height = float(H)
                trees[kind].ndc_focal = float(cfg["focal"])
        if (kind, lod) not in uploads:
            tree = trees[kind]
            if lod:
                t0 = time.perf_counter()
                tree = build_lod(tree, min(lod, tree.max_depth))
                log(f"[trees] {kind} LOD d{lod}: {tree.capacity} nodes, "
                    f"pooled in {time.perf_counter() - t0:.1f} s")
            uploads[kind, lod] = upload_tree(
                tree, lut_levels=min(9, tree.max_depth), device="cuda")
        dt = uploads[kind, lod]
        W, H = cfg["size"]
        cam = scene_camera(cfg)
        kit = os.path.join(HERE, "benchmarks", cfg["kit"])
        r = R.Renderer(dt, W, H, cam.fx, cam.fy, options=headline_options(),
                       render_scale=cfg["scale"])
        r.set_denoiser(os.path.join(kit, cfg["gnet"]))
        pose = cam.transform
        if r.fast:
            hold_fast(r, pose, err, label)
        else:
            c = cfg["crop"]
            w, h = (c, c) if c else (W, H)
            kw = dict(width=w, height=h, fx=r.fx, fy=r.fy, opt=r.options)
            hold_k1(f"{label} {w}x{h}" + (f" (central crop of {W}x{H})"
                                          if c else ""),
                    dt, r._transform(pose), kw, "render", err)
        img, aux_nhwc, _ = r.render_noisy(pose)
        if not r.fast:  # hold_fast held K7 on K4's aux
            hold_k7(f"{label} aux {W}x{H}, {cfg['kit']}/{cfg['gnet']}",
                    r.net, aux_nhwc[None], err)
        if label == "tt":
            time_k7(f"{cfg['kit']}/{cfg['gnet']}", r.net, aux_nhwc[None],
                    err)
        act = r.net_forward(aux_nhwc)
        sup = r.net_cfg.supports()
        e2 = float((guided_filter(act, img, sup)
                    - guided_filter_act_plain(act, img, sup)).abs().max())
        log(f"[scenes] {label}: K2 on the net's activation {tuple(act.shape)}"
            f" (supports {sup}): max|diff| {e2:.3g}")
        require(e2 <= K2_TOL, f"{label}: K2 disagrees with its plain version")
        err["guided_filter"] = max(err["guided_filter"], e2)
        del img, aux_nhwc, act
        ps = load_poses("blender", os.path.join(kit, "transforms_test.json"),
                        W, H)
        noisy, den = phase_quality(r, ps.poses, label, cfg["bars"], kit)
        log(f"[scenes] {label}: denoise_recommended "
            f"{r.denoise_recommended}")
        frame_ms, split = frame_timing(
            r, pose, f"{label} ({r.inner_width}x{r.inner_height} march, "
            f"{W}x{H} out, {cfg['gnet']})")
        out[label] = {"size": f"{W}x{H}", "march": f"{r.inner_width}x"
                      f"{r.inner_height}", "gnet": f"{cfg['kit']}/"
                      f"{cfg['gnet']}", "lod": cfg["lod"],
                      "nodes": int(dt.chs.shape[0] // 8),
                      "psnr_noisy": noisy, "psnr_denoised": den,
                      "bars": list(cfg["bars"]),
                      "denoise_recommended": r.denoise_recommended,
                      "frame_ms": frame_ms, "split_ms": split}
        del r
    del uploads
    torch.cuda.empty_cache()

    # the quantized tree (written by the main path's cli compress)
    qpath = os.path.join(WORK, "quant", os.path.basename(quant_src))
    cam = Camera(QUANT_SIZE, QUANT_SIZE)
    opt = RenderOptions(spp=6, denoise=False)
    imgs = {}
    for label, path in (("float", quant_src), ("quant", qpath)):
        t = load_npz(path)
        dt = upload_tree(t, lut_levels=min(7, t.max_depth), device="cuda")
        r = R.Renderer(dt, QUANT_SIZE, QUANT_SIZE, cam.fx, cam.fy,
                       options=opt)
        kw = dict(width=QUANT_SIZE, height=QUANT_SIZE, fx=cam.fx, fy=cam.fy,
                  opt=opt)
        hold_k1(f"quant d{QUANT_DEPTH} {label} tree {QUANT_SIZE}x"
                f"{QUANT_SIZE}", dt, r._transform(cam.transform), kw,
                "render", err, (r.rng.state, r.rng.inc))
        imgs[label] = r.render(cam.transform,
                               want_aux=False)[0].cpu().numpy()
    mse = float(np.mean((imgs["float"][..., :3]
                         - imgs["quant"][..., :3]) ** 2))
    q_psnr = -10.0 * np.log10(max(mse, 1e-12))
    sizes = (os.path.getsize(quant_src), os.path.getsize(qpath))
    ratio = sizes[1] / sizes[0]
    log(f"[scenes] quant d{QUANT_DEPTH}: PSNR vs float {q_psnr:.3f} dB (JAX "
        f"{QUANT_PSNR}), npz bytes {sizes}, ratio {ratio:.5f} (JAX "
        f"{QUANT_BYTES}, {QUANT_BYTES[1] / QUANT_BYTES[0]:.5f})")
    require(abs(q_psnr - QUANT_PSNR) <= QUANT_PSNR_TOL,
            f"quant PSNR {q_psnr:.3f} not within {QUANT_PSNR_TOL} dB")
    require(sizes == QUANT_BYTES, "the npz files are not the JAX package's")
    out["quant"] = {"depth": QUANT_DEPTH, "size": f"{QUANT_SIZE}x"
                    f"{QUANT_SIZE}", "psnr_vs_float": q_psnr,
                    "bar": QUANT_PSNR, "bytes": list(sizes),
                    "bytes_ratio": ratio}
    log(json.dumps({"scenes": out}))
    return out


def deep_tree(base):
    """tools/bench_deep.py:get_tree: ``base`` (the headline depth-9 shell)
    refined DEEP_LEVELS levels at its occupied deepest leaves."""
    from rt_octree_tpu_torch.io import synthetic
    thickness = max(3.0 / 2 ** base.max_depth, 0.02)
    def make():
        return synthetic.refine_tree(
            base, lambda p: synthetic.shell_sigma(
                p, thickness=thickness, amplitude=4.0 / thickness),
            synthetic.position_color, levels=DEEP_LEVELS)
    return cached_tree(f"shell_d{base.max_depth + DEEP_LEVELS}_refined",
                       make)


def phase_deep(err, base):
    """The depth-11 shell uploaded twice, with the partial-LUT skip (LUT at
    level 9 = max_depth - 2, internal cells marked) and with skip_cap=0:
    K3's marker lanes and distances vs its plain version on the 512^3
    partial LUT, K1 vs its plain version on a central 128x128 crop of both,
    the two uploads' 800x800 frames against each other, K1's statistics,
    frame times and peak device memory.  Prints one {"deep": ...} line."""
    import torch
    from rt_octree_tpu_torch.core.camera import Camera
    from rt_octree_tpu_torch.core.options import RenderOptions
    from rt_octree_tpu_torch.ops import traversal as T
    from rt_octree_tpu_torch.render import renderer as R
    tree = deep_tree(base)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dts = {"skip": T.upload_tree(tree, lut_levels=DEEP_LUT, device="cuda"),
           "no skip": T.upload_tree(tree, lut_levels=DEEP_LUT, skip_cap=0,
                                    device="cuda")}
    res = 2 ** DEEP_LUT
    require(dts["skip"].lut_levels == DEEP_LUT == tree.max_depth - 2
            and dts["skip"].skip_cap == 12 and dts["no skip"].skip_cap == 0,
            "the depth-11 tree did not get the partial-LUT skip")
    chs, mark = dts["skip"].chs, T.LUT_INTERNAL_MARK
    lut_k = T.build_lut(chs, 2, DEEP_LUT, mark)
    lut_p = T.lut_build_plain(chs, 2, DEEP_LUT, mark)
    d_lut = int((lut_k.long() - lut_p.long()).abs().max())
    marked = int((lut_p[:, 1] == mark).sum())
    skip_k = T.add_skip_distances(lut_k.clone(), res, 12)
    skip_p = T.add_skip_distances_plain(lut_p, res, 12)
    d_skip = int((skip_k.long() - skip_p.long()).abs().max())
    lanes = skip_p[:, 1]
    n_dist = int(((lanes > 0) & (lanes <= 12)).sum())
    same = (torch.equal(skip_k, dts["skip"].lut)
            and torch.equal(lut_k, dts["no skip"].lut))
    log(f"[deep] K3 {res}^3 partial LUT: {marked} cells marked internal, "
        f"{n_dist} carry a distance; lut max|diff| {d_lut}, skip max|diff| "
        f"{d_skip}; equal to the uploads' LUTs: {same}")
    require(d_lut == 0 and d_skip == 0 and same and marked > 0,
            "K3 disagrees with its plain version on the partial LUT")
    err["lut_build"] = max(err["lut_build"], float(d_lut))
    err["skip_distances"] = max(err["skip_distances"], float(d_skip))
    del lut_k, lut_p, skip_k, skip_p, lanes

    S, C = DEEP_SIZE, DEEP_CROP
    cam = Camera(S, S)
    opt = RenderOptions(spp=6, denoise=False)
    out = {"nodes": tree.capacity, "max_depth": tree.max_depth,
           "lut_levels": DEEP_LUT, "marked_cells": marked,
           "cells_with_distance": n_dist}
    frames = {}
    for label, dt in dts.items():
        r = R.Renderer(dt, S, S, cam.fx, cam.fy, options=opt)
        tf = r._transform(cam.transform)
        rng = (r.rng.state, r.rng.inc)
        crop = dict(width=C, height=C, fx=r.fx, fy=r.fy, opt=opt)
        hold_k1(f"deep d{tree.max_depth} {label} {C}x{C} (central crop of "
                f"{S}x{S})", dt, tf, crop, "render", err, rng)
        kw = dict(width=S, height=S, fx=r.fx, fy=r.fy, opt=opt)
        frames[label] = R.render_noisy(dt, tf, *rng, **kw)
        st = R.render_stats(dt, tf, *rng, **kw)
        stats = k1_stats(dt, st, kw, f"{S}x{S} spp 6 depth-{tree.max_depth}"
                         f" refined shell, level-{DEEP_LUT} LUT, skip_cap "
                         f"{dt.skip_cap}")[0]
        frame_ms, split = frame_timing(r, cam.transform,
                                       f"deep d{tree.max_depth} {label}")
        out[label] = {"k1_stats": stats, "frame_ms": frame_ms,
                      "split_ms": split}
        del r, st
    e_img = float((frames["skip"][0] - frames["no skip"][0]).abs().max())
    e_aux = max(float((frames["skip"][i] - frames["no skip"][i]).abs().max())
                for i in (1, 2))
    log(f"[deep] {S}x{S} frame with vs without the partial-LUT skip: "
        f"max|img diff| {e_img:.3g}, max|aux diff| {e_aux:.3g}")
    require(e_img <= K1_IMG_TOL and e_aux <= K1_AUX_TOL,
            "the partial-LUT skip changed the deep frame")
    out["img_diff_skip_vs_no_skip"] = e_img
    out["aux_diff_skip_vs_no_skip"] = e_aux
    out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    log(json.dumps({"deep": out}))
    del dts, frames
    torch.cuda.empty_cache()
    return out


def phase_probes(native, err):
    """Every probe entry against its plain version at the tools' own
    shapes and its device time against the plain version's (``device_ms``:
    several of these kernels take less time than their wrapper's host
    code), then the tools' Pallas-probe paths with the launch counts
    reset."""
    import torch
    import torch.nn.functional as F
    from rt_octree_tpu_torch.ops import probes as P
    from rt_octree_tpu_torch.tools import gpu_probe as gp
    from rt_octree_tpu_torch.tools import microbench_gather as mb
    dev = torch.device("cuda", 0)
    ms, bounds = {}, {}

    def distinct(*index_tensors) -> int:
        return int(torch.unique(torch.cat(
            [t.flatten().long() for t in index_tensors])).numel())

    def chain_touched(step, cur, rounds):
        """Every index a chained gather reads, round by round."""
        seen = []
        for _ in range(rounds):
            seen.append(cur)
            cur = step(cur)
        return seen

    def hold(name, label, kernel, plain, reps=None):
        got, ref = kernel(), plain()
        d = float((got.double() - ref.double()).abs().max())
        same = torch.equal(got, ref)
        log(f"[probes] {name} {label}: bit-equal {same}, max|diff| {d:.3g}")
        require(same, f"{name} disagrees with its plain version ({label})")
        err[name] = max(err.get(name, 0.0), d)
        if reps:
            ms[name] = (device_ms(kernel, reps, 2), device_ms(plain, reps, 2))

    # bounds: each index array, each distinct table element or row a
    # probe reads, and the output once; integer work counts at the f32 rate
    x = gp.basic_input(dev)
    hold("probe_affine", "8x128", lambda: P.probe_affine(x),
         lambda: P.probe_affine_plain(x), 50)
    bounds["probe_affine"] = bound(8 * x.numel(), 2 * x.numel()) + (None,)
    tab, idx = gp.vgather_inputs(dev)
    hold("lane_gather", f"tab {tuple(tab.shape)} idx {tuple(idx.shape)}",
         lambda: P.lane_gather(tab, idx),
         lambda: P.lane_gather_plain(tab, idx), 50)
    lanes = torch.arange(tab.shape[1], device=dev)
    idx64 = idx.long()
    bounds["lane_gather"] = bound(
        8 * idx.numel() + 4 * distinct(idx64 * tab.shape[1] + lanes)) + (
        device_ms(lambda: torch.gather(tab, 0, idx64), 50, 2),)
    tab, idx = gp.vgather_loop_inputs(dev)
    hold("lane_gather_chain", f"tab {tuple(tab.shape)} idx "
         f"{tuple(idx.shape)} K {gp.VL_K}",
         lambda: P.lane_gather_chain(tab, idx, gp.VL_K),
         lambda: P.lane_gather_chain_plain(tab, idx, gp.VL_K), 5)
    lanes = torch.arange(tab.shape[1], device=dev)
    seen = chain_touched(
        lambda c: P.lane_gather_chain_plain(tab, c, 1), idx, gp.VL_K)
    bounds["lane_gather_chain"] = bound(
        8 * idx.numel()
        + 4 * distinct(*(c.long() * tab.shape[1] + lanes for c in seen)),
        3 * gp.VL_K * idx.numel()) + (None,)

    idx, tab = gp.dma_inputs(dev)
    got = P.row_sum_ring(idx, tab)
    ref = P.row_sum_ring_plain(idx, tab)
    rel_k = gp.dma_rel_err(got, idx, tab)
    rel_p = gp.dma_rel_err(ref, idx, tab)
    d = float((got - ref).abs().max())
    log(f"[probes] row_sum_ring {gp.DMA_N} rows of tab {tuple(tab.shape)}: "
        f"rel err vs float64 kernel {rel_k:.3g}, plain {rel_p:.3g}; "
        f"max|kernel - plain| {d:.3g}")
    require(rel_k <= gp.DMA_RTOL, f"row_sum_ring rel err {rel_k:.3g} > "
            f"{gp.DMA_RTOL} against the float64 sum")
    err["row_sum_ring"] = d
    ms["row_sum_ring"] = (device_ms(lambda: P.row_sum_ring(idx, tab), 5),
                          device_ms(lambda: P.row_sum_ring_plain(idx, tab),
                                    5))
    idx64, offsets = idx.long(), torch.zeros(1, dtype=torch.long, device=dev)
    bounds["row_sum_ring"] = bound(
        4 * idx.numel() + 4 * tab.shape[1] * (distinct(idx) + 1),
        idx.numel() * tab.shape[1]) + (device_ms(
            lambda: F.embedding_bag(idx64, tab, offsets, mode="sum"), 5),)
    del idx, tab, got, ref

    for w, n, nbuf, table, idx in mb.dma_configs(dev):
        timed = (w, n, nbuf) == (128, 8192, 32)
        hold("row_ring_rounds", f"rows {w * 4} B n {n} nbuf {nbuf}",
             lambda: P.row_ring_rounds(idx, table, nbuf, mb.RING_ROUNDS),
             lambda: P.row_ring_rounds_plain(idx, table, nbuf,
                                             mb.RING_ROUNDS),
             5 if timed else None)
        if timed:  # the probe copies whole rows: each distinct row once
            bounds["row_ring_rounds"] = bound(
                4 * n + 4 * w * distinct(idx) + 4,
                n * mb.RING_ROUNDS) + (None,)
    del table, idx
    for S, n, table, idx in mb.vmem_configs(dev):
        timed = (S, n) == (1 << 18, 131072)
        hold("flat_gather_chain", f"S {S} n {n}",
             lambda: P.flat_gather_chain(idx, table, mb.CHAIN_ROUNDS),
             lambda: P.flat_gather_chain_plain(idx, table, mb.CHAIN_ROUNDS),
             5 if timed else None)
        if timed:
            seen = chain_touched(
                lambda c: P.flat_gather_chain_plain(c, table, 1), idx,
                mb.CHAIN_ROUNDS)
            bounds["flat_gather_chain"] = bound(
                8 * n + 4 * distinct(*seen),
                2 * mb.CHAIN_ROUNDS * n) + (None,)
    del table, idx
    for k, (kms, pms) in ms.items():
        lib = bounds[k][2]
        log(f"[timing] {k}: kernel {kms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{bounds[k][0]:.6f} ms ({bounds[k][1]}), library "
            + ("none" if lib is None else f"{lib:.4f} ms"))

    native.reset_launches()
    t0 = time.time()
    rcs = [gp.main(["basic", "vgather", "vgather_loop", "dma"]),
           mb.main(["b"]), mb.main(["c"])]
    counts = {k: native.LAUNCHES[k] for k in PROBE_KERNELS}
    log(f"[probes] tools rc {rcs} in {time.time() - t0:.1f} s; launches "
        f"{counts}")
    require(rcs == [0, 0, 0], "a tool failed")
    require(all(v > 0 for v in counts.values()),
            f"a probe kernel never launched in the tools' run: {counts}")
    return counts, ms, bounds


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test needs one GPU",
              file=sys.stderr)
        return 1
    if argv[:1] == ["--load-only"] and len(argv) == 2:
        return load_only(argv[1])
    if argv[:1] == ["--load-pairs"] and len(argv) in (2, 3):
        return load_pairs(argv[1], int(argv[2]) if len(argv) == 3 else 10)
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    from rt_octree_tpu_torch.native import build as native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    log(smi[0])
    kind = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{kind}, {torch.cuda.device_count()} visible")

    err = {}
    t0 = time.time()
    paths = native.build(verbose=True)
    log(f"[build] {len(paths)} libraries in {time.time() - t0:.1f} s: "
        f"{sorted(os.path.basename(p) for p in paths.values())}")
    phase_k3(err)
    phase_k1(err)
    phase_k1_mesh_classic(err)
    phase_k4(err)
    phase_pcg()
    phase_k2(err)
    phase_k7(err)
    tree, tree_path, gen = headline_tree_path()
    paths = main_paths(make_drawlist())
    runs = {label: phase_main(native, tree_path, label, flags, required)
            for label, (flags, required) in paths.items()}
    flags, required = paths["headline"]
    runs["cli render"] = phase_main(native, tree_path, "cli render", flags,
                                    required, dispatcher=True)
    quant_src = quant_source()
    for label, (argv, outputs) in tool_paths(tree_path, quant_src).items():
        runs[label] = phase_tool(native, label, argv, outputs)
    # each kernel's launches in the main path that carries it
    counts = {k: runs["headline"][k] for k in
              ("render", "guidance_net", "guided_filter", "lut_build",
               "skip_distances")}
    counts["upsample"] = runs["fast s=0.5"]["upsample"]
    counts["render_classic"] = runs["mesh, grid, probe, classic"][
        "render_classic"]
    measure_load(tree_path, gen)
    r, ps = make_headline_renderer(tree)
    phase_quality(r, ps.poses)
    ms, bounds = phase_headline(r, ps, err)
    ms_new, bounds_new = phase_fast_classic(r, ps, err, tree)
    ms.update(ms_new)
    bounds.update(bounds_new)
    train_counts, ms_new, bounds_new = phase_train(native, r, tree_path, err)
    counts.update(train_counts)
    ms.update(ms_new)
    bounds.update(bounds_new)
    del r
    phase_scenes(err, quant_src)
    log(json.dumps({"k7": err["k7"]}))
    phase_deep(err, tree)
    del tree
    probe_counts, probe_ms, probe_bounds = phase_probes(native, err)
    counts.update(probe_counts)
    ms.update(probe_ms)
    bounds.update(probe_bounds)

    table = []
    for name, (source, replaces) in KERNELS.items():
        kms, pms = ms[name]
        b_ms, b_by, lib_ms = bounds[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": counts[name],
                      "max_abs_err": err[name], "ms": kms, "plain_ms": pms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_ms})
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
