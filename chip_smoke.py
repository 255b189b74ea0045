#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (rt_octree_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
  2. build every kernel from csrc/ with nvcc (sm_90a); ptxas's report of
     every render_classic instance (registers; no stack frame, no spills),
     printed as one JSON line {"ptxas_render_classic": ...};
  3. K3 (LUT build + skip distances) vs its plain version, integer-exact,
     on a depth-7 shell, a deep chain and a random 512^3 LUT (occupancy
     1e-3, cap 12);
  4. K1 (fused frame) vs its plain version at 128x128 at every SPP of the
     viewer's panel (1, 2, 4, 6, 8, 16, 32), on a depth-7 shell tree and an
     NDC blobs tree; then on both scenes K1 with a
     random mesh pass, K1's classic variant (render_classic) with and
     without one, and K1 with the octree grid's mesh pass (show_grid),
     each vs its plain version; render_classic on each of its instances
     (depth-6 shells with SH rows at basis_dim 1, 4, 9, 16, 25, raw rgb
     rows, SG and ASG rows, an RGBA-format tree with a basis_dim) with the
     full-depth and a level-3 LUT, on SH9 and SH25 rows that start off 8
     bytes, and on SH9 with a basis_minmax mask, stop_thresh 0.3 and
     1e-6, max_steps 1 to 5 and ragged sizes (1x1, 37x23, 33x9), each vs
     its plain version and with its statistics equal to the plain
     march's; and K4 (fast mode's joint upsample) vs its
     plain version at 400->800, 320->800 and odd sizes (75x47 from
     s = 0.5, 0.4, 0.7), with and without aux_chw;
  5. PCG32: the kernel's per-pixel uniforms equal the tensor twin, bit-exact;
  6. K2 (guided filter from the net's bf16 activation) vs its plain version
     at 800x800, L=4, both support ladders, channels-last strides and a
     guidance range above 60 nats; K7 (the compact GuidanceNet) vs its
     plain version (compact_activation_plain) on random aux at 800x800
     with trained.gnet and at 256x256 with random nets of one block, of
     4 and 6 channels, a 3-block chain, 8 -> 64 -> 16 and 64 -> 64 -> 64,
     and on a permuted NCHW aux; then trained.gnet and the chain at
     K7_EDGES (sizes one pixel past K7's 56x16 tiles and exact multiples,
     frames with fewer tiles than the persistent grid's blocks, a batch of
     three images), and the chain on the nets and aux of K7_CHAIN_SEEDS
     at 799x801;
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
     version on the headline tree at 800x800, without a mesh pass, with
     the fourth run's drawlist pass and at the ground-truth settings of
     make_quality_dataset (max_steps 16384), its statistics as one JSON
     line {"classic_stats": ...} (steps per ray, shaded steps, lane
     efficiency, distinct reads, bound, its time at both settings); K4 at
     400->800 timed (F.interpolate on its rgba planes as a note: no
     PyTorch call writes K4's image and aux); for each fast frame (s = 0.5,
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
     own frame (tt: the central 64x64 pixels), render_classic the same way
     on solid, tt and llff, fast rungs held at their
     own shapes (K1 at the inner size, K4 on its output, the frame vs the
     plain chain, K7 on K4's aux), K7 on the scene's aux with its net
     (and its time at the scene's size), K2 on the net's activation, the
     8-pose gate against the JAX package's CPU bars with
     denoise_recommended, the frame time and phase split; then the
     quantized depth-7 shell (K1 held on its
     decode, PSNR against the float frame and the npz bytes ratio against
     the JAX package's), printed as one JSON line {"scenes": ...};
 10b. kits: the port's kit tools (rt_octree_tpu_torch/tools), each run
     with the launch counts reset just before it and read just after: the
     ground-truth kits of solid, tt and blobs (--gt_only with 16 train
     poses drawn first, the committed kits' poses) on phase 10's cached
     trees, each test PNG against the committed one (PSNR >= KIT_GT_PSNR,
     max |diff|, share of unequal pixels; render_classic 8 launches, K1
     none, K3 3 + 3 an upload), and phase 9's shell kit the same way; the
     shell fast kit at s = 0.5 (32 teacher frames with trained.gnet, 40
     student buffers: K1 72, K4 40, K7 32, K2 32; its test PNGs byte-equal
     to the committed ones) and the llff interactive rung's test split
     (LOD d8 x s = 0.5: K1 8, K4 8), each scored by eval_gnet_kit with the
     committed fast net (K7 8, K2 8) within KIT_EVAL_TOL dB of phase 8's
     fast s = 0.5 gate and phase 10's llff interactive gate; ``rtoctree
     train`` on the port's shell fast kit for KIT_TRAIN_EPOCHS epochs (K5
     and K6 once a step) and compact, the net stamped by set_gnet_meta
     fast_scale=0.5, read back and rendered at s = 0.5 on the 8 committed
     poses (PSNR, no bar); printed as one JSON line {"kits": ...};
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
 13. apps: ``rtoctree view`` (apps/viewer.py) on the depth-9 shell npz at
     800x800, SPP 6, level-9 LUT, trained.gnet, denoise turned on by an
     options event, behind ThreadingHTTPServer on 127.0.0.1:0: after 3
     warm-up frames, 20 timed /frame.png with the counts reset (K1, K7 and
     K2 once a frame; the first decoded frame bit-equal to a fresh
     Renderer's at the same camera, options and PCG32 state); then the
     panel, each step one frame that must launch its kernels and change:
     an orbit drag, every SPP of the page, the classic estimator
     (render_classic), the fast rungs 0.75 / 0.5 / 0.4 (K4), the grid, the
     probe, a sphere primitive and a drawlist; the animation editor's
     export of two keyframes at 10 fps (10 PNGs, /state polled to 101);
     and a load_remote of the quant phase's depth-7 npz from a second
     local http.server (K3 must launch).  ``rtoctree anim`` on
     examples/orbit_keyframes.json at 800x800 with trained.gnet (90
     frames; K1, K7, K2 90 times; frame 0 bit-equal to a fresh Renderer's
     at keyframe 0) and with --render_scale 0.5 and fast.gnet (K4 90
     times); ``rtoctree tools`` (both subcommands, no kernel) on a scene
     folder of the quality kit's poses.  Printed as one JSON line
     {"apps": ...}: the /frame.png round trip (least, quartiles, largest
     in ms) and its parts, timed from the outside on the viewer's state
     (the render's host time, the kernels' device time a render by
     torch.profiler, the host copy with to_uint8, the PNG encode, and
     HTTP as the median round trip less the parts' medians), the anim
     runs' frames per second, and every run's launch counts.

After phase 10 it prints K7's holds and times as one JSON line
{"k7": ...}: per input, the largest difference from the plain version in
bf16 ulps of the tensor's largest magnitude and of each element's, the
share of elements not bit-equal; K7, its plain version and the cuDNN chain
it replaces at 800x800 and 1920x1080, with one run of K7's statistics
instance at each (per phase, staging, block 0, block 1 and its stores, the
clock64() cycles a tile summed over the blocks, and their shares).

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
file and times each K3 entry alone, then the headline frame five times (as
phase 9 does), printing the {"load": ...} lines, one {"k3_ms": ...} line and
one {"frame_ms": [...]} line; run from a copy of another commit's tree, it
times that commit's load and frame by the same code.

    python3 chip_smoke.py --load-pairs OTHER_ROOT [PAIRS]

runs --load-only in PAIRS (default 10) pairs of processes, this checkout's
and OTHER_ROOT's in turns (other, this, this, other, ...; a copy of this
script must stand in OTHER_ROOT), on the headline npz (made first if it is
not there), and prints each side's least value, quartiles and largest
value of every step and of the median headline frame, and those of the
paired differences of the sums and frames, as one JSON line
{"load_pairs": ...}.

    python3 chip_smoke.py --k7-only
    python3 chip_smoke.py --k7-pairs OTHER_ROOT [PAIRS]

--k7-only times K7 of the package beside this file alone (as phase 9
does) at 800x800 with benchmarks/quality/trained.gnet and at 1920x1080
with benchmarks/quality_tt/trained.gnet, beside its bound, as one JSON line
{"k7_ms": ...}; --k7-pairs runs it in PAIRS (default 6) pairs of processes
as --load-pairs does, and prints each side's times and their paired
differences as one JSON line {"k7_pairs": ...}.

    python3 chip_smoke.py --classic-only [ROOT]
    python3 chip_smoke.py --classic-pairs OTHER_ROOT [PAIRS]

--classic-only times render_classic of the package under ROOT (default:
beside this file) alone on the headline tree (build/chip_smoke's npz, made
first if absent) at 800x800, pose r_0, at CLASSIC_SETTINGS (the CLI's
defaults and make_quality_dataset's ground-truth settings), and K1 and the
headline frame the same way, with each frame's digest, as one JSON line
{"classic_ms": ...}; --classic-pairs runs it in PAIRS (default 6) pairs of
processes, this script on OTHER_ROOT's package and on its own in turns
(OTHER_ROOT needs no copy of this script), and prints each side's times,
their paired differences and whether the two sides' frames are bit-equal,
as one JSON line {"classic_pairs": ...}.

    python3 chip_smoke.py --filter-only [ROOT]
    python3 chip_smoke.py --filter-pairs OTHER_ROOT [PAIRS]

--filter-only times K5 and K6 of the package under ROOT (default: beside
this file) alone by device_ms, on phase 9's real batch when
build/chip_smoke/train_kit exists (a fresh Runner's net on the kit's first
shuffled batch), else on seeded inputs at the training shape (32 slices of
80x80, supports 1..4), beside their bounds and plain versions, with the
share of tiles that took the guard (where the package counts it), an
output digest and, on the real batch, the device operations of one
training step (torch.profiler), as one JSON line {"filter_ms": ...};
--filter-pairs runs it in PAIRS (default 6) pairs of processes, this
script on OTHER_ROOT's package and on its own in turns, and prints each
side's times, their paired differences and each side's digests as one
JSON line {"filter_pairs": ...}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# --classic-only ROOT and --filter-only ROOT import the package of another
# checkout (the timers of --classic-pairs and --filter-pairs); every other
# mode imports the one beside this file
PKG_ROOT = (os.path.abspath(sys.argv[2])
            if sys.argv[1:2] in (["--classic-only"], ["--filter-only"])
            and len(sys.argv) == 3 else HERE)
sys.path.insert(0, PKG_ROOT)

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
# K5 vs plain: softmax sums of up to 81 taps at support 4, separable under
# a tile stabiliser (per window on a guard tile); K6 vs plain: the same
# factorised sums (or the gather) of exp * (u.x - v) with FMA contraction,
# within 1e-4 of the plain gradient's largest magnitude; the
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
# (images, height, width) at K7's 56x16 output tiles' edges
K7_EDGES = ((1, 1, 19), (1, 2, 1), (1, 16, 56), (1, 17, 57), (1, 33, 113),
            (3, 17, 57), (1, 801, 799))
# seeds of the 3-block chain's further nets and aux (phase 6)
K7_CHAIN_SEEDS = (101, 102, 103, 104, 105, 106)
# render_classic on the headline tree at 800x800, pose r_0: the CLI's
# defaults (the headline flags with --estimator classic) and the
# ground-truth settings of rt_octree_tpu_torch/tools/make_quality_dataset.py
# (SPP 1, no denoise, the classic estimator, GT_MAX_STEPS), as (label,
# max_steps)
CLASSIC_SETTINGS = (("cli", 8192), ("ground_truth", 16384))
CLASSIC_REPS = 50  # timed calls a setting, after 5 untimed
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
# The kits phase: each scene's ground-truth kit with the committed kit's
# poses (benchmarks/quality_<kit> drew 16 train poses before its 8 test
# poses; benchmarks/quality 32), every pose's PNG held to the committed one
# at KIT_GT_PSNR or more (the classic estimator is deterministic: the
# shell's classic frame reads 62.368 dB against its committed GT at the
# CLI's smaller max_steps, and 55 dB still allows one 8-bit level on
# about a tenth of the pixels); the committed fast nets evaluated on the
# port's fast kits within KIT_EVAL_TOL dB of the same run's gate of the
# same frames; a fast net trained on the port's shell fast kit for
# KIT_TRAIN_EPOCHS epochs.
KIT_GT_SCENES = {"solid": "quality_solid", "tt": "quality_tt",
                 "blobs": "quality_blobs"}
KIT_GT_TRAIN, KIT_GT_PSNR = 16, 55.0
KIT_EVAL_TOL = 0.01
KIT_TRAIN_EPOCHS = 2
# The apps phase: the viewer at the headline's width, driven over HTTP as a
# browser drives it, the keyframe animator's CLI and the tools' CLI.
APPS_SIZE, APPS_SPP, APPS_WARMUP, APPS_FRAMES = 800, 6, 3, 20
APPS_PANEL_SPP = (1, 2, 4, 6, 8, 16, 32)  # the viewer page's SPP choices
APPS_FAST = (0.75, 0.5, 0.4)  # the page's fast rungs below full
APPS_DEADLINE_S = 300.0
# the viewer's frame kernels with denoise on
APPS_DENOISED = ("guidance_net", "guided_filter")

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


def ptxas_kernels(report, kernel):
    """ptxas's -v report -> {mangled name: {"registers", "stack_bytes",
    "spill_store_bytes", "spill_load_bytes"}} of every entry function whose
    name holds ``kernel``."""
    import re
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            cur = m.group(1) if kernel in m.group(1) else None
            if cur:
                out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(zip(("stack_bytes", "spill_store_bytes",
                                 "spill_load_bytes"), map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def phase_ptxas(native):
    """Every render_classic_kernel instance (7 row layouts, each with and
    without statistics) as ptxas compiled it: no stack frame, no spills.
    Prints one {"ptxas_render_classic": ...} line."""
    import re
    found = ptxas_kernels(native.PTXAS.get("render", ""),
                          "render_classic_kernel")
    table = {}
    for name, v in found.items():
        m = re.search(r"render_classic_kernelIL(i|in)(\d+)ELb([01])EE", name)
        bd = (-1 if m.group(1) == "in" else 1) * int(m.group(2))
        layout = {-1: "rgba", 0: "any"}.get(bd, f"sh{bd}")
        table[layout + (" stats" if m.group(3) == "1" else "")] = v
    log(json.dumps({"ptxas_render_classic": table}))
    require(len(table) == 14 and all(len(v) == 4 for v in table.values()),
            f"ptxas reported {sorted(table)}, not the 14 render_classic "
            "instances")
    require(all(v["stack_bytes"] == v["spill_store_bytes"]
                == v["spill_load_bytes"] == 0 for v in table.values()),
            "a render_classic instance has a stack frame or spills")
    return table


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
        for spp in APPS_PANEL_SPP:
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


def classic_layout_trees():
    """A depth-6 shell in each row layout render_classic is instantiated
    on: SH at basis_dim 1, 4, 9, 16, 25, raw rgb, SG and ASG at basis_dim
    4 and 25 (random lobes), and an RGBA-format tree with a basis_dim (a
    zero basis, the "any" instance); as (label, tree, layout)."""
    from rt_octree_tpu_torch.io import synthetic
    from rt_octree_tpu_torch.io.n3tree import BasisFormat, DataFormat
    out = []
    for bd in (1, 4, 9, 16, 25):
        out.append((f"SH{bd}", synthetic.make_synthetic_tree(
            "shell", depth=6, basis_dim=bd), f"sh{bd}"))
    rgba = synthetic.make_synthetic_tree("shell", depth=6, basis_dim=1)
    rgba.data_format = DataFormat(BasisFormat.RGBA, -1)
    rgb = rgba.data[:, :3].astype(np.float32)
    rgba.data[:, :3] = (1.0 / (1.0 + np.exp(-rgb))).astype(np.float16)
    out.append(("RGBA", rgba, "rgba"))
    rs = np.random.default_rng(17)
    for fmt, width in ((BasisFormat.SG, 4), (BasisFormat.ASG, 11)):
        for bd in (4, 25):
            t = synthetic.make_synthetic_tree("shell", depth=6, basis_dim=bd)
            t.data_format = DataFormat(fmt, bd)
            extra = rs.standard_normal((bd, width))
            extra[:, :width - 9 if fmt == BasisFormat.ASG else 1] = \
                rs.uniform(0.5, 4.0, (bd, 2 if fmt == BasisFormat.ASG else 1))
            t.extra = extra.astype(np.float32)
            out.append((f"{fmt.name}{bd}", t, "any"))
    zero = synthetic.make_synthetic_tree("shell", depth=6, basis_dim=4)
    zero.data_format = DataFormat(BasisFormat.RGBA, 4)
    out.append(("RGBA-format basis_dim 4", zero, "any"))
    return out


def hold_classic_stats(label, dt, tf, kw):
    """render_classic's statistics instance == the plain march's counts."""
    from rt_octree_tpu_torch.render import renderer as R
    st = R.render_stats(dt, tf, 0, 0, **kw)
    same = st.equals(R.render_stats_plain(dt, tf, 0, 0, **kw))
    log(f"[classic] {label}: statistics == plain march's: {same} (steps "
        f"{int(st.steps.sum())}, max {int(st.steps.max())}, shaded "
        f"{int(st.shaded.sum())}, rows {st.data_rows})")
    require(same, f"{label}: render_classic's statistics disagree with the "
            "plain march's")
    return st


def phase_classic_layouts(err):
    """render_classic on every instance vs its plain version and its
    statistics vs the plain march's: each layout of classic_layout_trees
    at 128x128 with the full-depth LUT (skips) and a level-3 LUT
    (descents); on SH9 and SH25 rows that start off 8 bytes (the data seen
    through a view 1 and 3 halfs in), a basis_minmax mask, stop_thresh
    0.3 and 1e-6, max_steps 1 to 5 (around the one-step lookahead) and
    ragged sizes 1x1, 37x23 and 33x9."""
    import dataclasses
    import torch
    from rt_octree_tpu_torch.core.camera import Camera
    from rt_octree_tpu_torch.core.options import RenderOptions
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.render import renderer as R

    def opt(**k):
        return RenderOptions(**{"spp": 1, "denoise": False,
                                "estimator": "classic", **k})

    def frame(size):
        cam = Camera(width=size[0], height=size[1], fx=175.0 * size[0] / 128,
                     fy=175.0 * size[0] / 128)
        return (torch.from_numpy(cam.transform.astype(np.float32)).cuda(),
                dict(width=cam.width, height=cam.height, fx=cam.fx,
                     fy=cam.fy))
    tf, base = frame((128, 128))
    seen = set()
    trees = classic_layout_trees()
    for label, tree, layout in trees:
        for levels in (6, 3):
            dt = upload_tree(tree, lut_levels=levels, device="cuda")
            require(R.classic_layout(dt.fmt, dt.basis_dim, dt.data_dim)
                    == layout, f"{label}: not the {layout} instance")
            kw = dict(base, opt=opt())
            name = f"{label} LUT {levels} 128x128"
            hold_k1(f"{name} classic", dt, tf, kw, "render_classic", err)
            hold_classic_stats(name, dt, tf, kw)
            seen.add(layout)
        if label in ("SH9", "SH25"):
            for off in (1, 3):
                flat = torch.zeros(dt.data.numel() + 4, dtype=dt.data.dtype,
                                   device="cuda")
                view = flat[off:off + dt.data.numel()].view(dt.data.shape)
                view.copy_(dt.data)
                skew = dataclasses.replace(dt, data=view)
                hold_k1(f"{label} rows {off} half(s) off 8 bytes classic",
                        skew, tf, dict(base, opt=opt()), "render_classic",
                        err)
    require(seen == set(R.CLASSIC_LAYOUTS), f"instances held: {seen}")
    sh9 = upload_tree(trees[2][1], lut_levels=6, device="cuda")
    cases = [("basis_minmax (2, 5)", {}, opt(basis_minmax=(2, 5)), (128, 128)),
             ("stop_thresh 0.3", {}, opt(stop_thresh=0.3), (128, 128)),
             ("stop_thresh 1e-6", {}, opt(stop_thresh=1e-6), (128, 128))]
    cases += [(f"max_steps {m}", {"max_steps": m}, opt(), (128, 128))
              for m in (1, 2, 3, 4, 5)]
    cases += [(f"{w}x{h}", {}, opt(), (w, h))
              for w, h in ((1, 1), (37, 23), (33, 9))]
    for label, extra, o, size in cases:
        tf_s, kw = frame(size)
        kw = dict(kw, opt=o, **extra)
        hold_k1(f"SH9 {label} classic", sh9, tf_s, kw, "render_classic", err)
        hold_classic_stats(f"SH9 {label}", sh9, tf_s, kw)


UPSAMPLE_CASES = [((600, 600), (800, 800)), ((400, 400), (800, 800)),
                  ((320, 320), (800, 800)),
                  ((24, 38), (47, 75)), ((19, 30), (47, 75)),
                  ((33, 52), (47, 75))]


def upsample_input(h, w, seed=5):
    """An inner aux [h, w, 8] on the card: rgba in [0, 1] and its square."""
    import torch
    rgba = np.random.default_rng(seed).random((h, w, 4), np.float32)
    return torch.from_numpy(np.concatenate([rgba, rgba * rgba], -1)).cuda()


def phase_k4(err):
    """K4 vs its plain version at the fast frames' sizes (600->800 at s =
    0.75, the viewer's first rung, 400->800 at 0.5, 320->800 at 0.4) and
    at 75x47 from s = 0.5, 0.4 and 0.7, with and without aux_chw."""
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


def k7_ms(net, aux_nhwc):
    """K7 alone on aux_nhwc: device_ms of 200 launches after 10 untimed
    (its launches are shorter than the host's queuing)."""
    import torch
    with torch.no_grad():
        return device_ms(lambda: net.activation(aux_nhwc), 200, 10)


def time_k7(label, net, aux_nhwc, err):
    """K7, its plain version and the cuDNN chain it replaces on aux_nhwc
    [1, H, W, C]: (kernel ms, plain ms, chain ms), recorded in err["k7"]
    with one run of K7's statistics instance (cycles a tile of each phase).
    The kernel and the chain by device_ms (their launches are shorter than
    the host's queuing), the plain version as every plain row, cuda_ms."""
    import torch
    from rt_octree_tpu_torch.models.guidance_net import \
        compact_activation_plain
    from rt_octree_tpu_torch.ops.guidance import guidance_net_stats
    ws = [c.weight for c in net.convs]
    bs = [c.bias for c in net.convs]
    k_ms = k7_ms(net, aux_nhwc)
    with torch.no_grad():
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
    with torch.no_grad():
        st = guidance_net_stats(aux_nhwc, net.packed)
    log(f"[k7] statistics {W}x{H}: {st['tiles']} tiles on {st['blocks']} "
        f"blocks, cycles a tile {st['cycles_per_tile']}")
    err["k7"].setdefault("stats", {})[f"{W}x{H}"] = {"net": label, **st}
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
    JAX tests' shapes, a 3-block chain and two wide nets at 256x256, then
    trained.gnet and the chain at K7_EDGES, and the chain with the nets
    and aux of K7_CHAIN_SEEDS at 799x801."""
    import torch
    from rt_octree_tpu_torch.models.guidance_net import (GuidanceNetConfig,
                                                         build_compact,
                                                         load_model)
    net, _ = load_model(os.path.join(KIT, "trained.gnet"), "cuda")
    aux = k7_aux(800, 800)
    hold_k7("random aux 800x800, trained.gnet", net, aux, err)
    nchw = aux.permute(0, 3, 1, 2).contiguous()
    hold_k7("random aux 800x800 read from NCHW, trained.gnet", net,
            nchw.permute(0, 2, 3, 1), err)
    def random_params(cfg, rs):
        return {f"block_{i}": {
            "kernel": (rs.standard_normal((3, 3, cin, cout)) * 0.4).astype(
                np.float32),
            "bias": (rs.standard_normal(cout) * 0.1).astype(np.float32)}
            for i, (cin, cout) in enumerate(cfg.layer_channels())}
    rs = np.random.default_rng(12)
    chain_cfg = GuidanceNetConfig(mid_channels=8, num_layers=3)
    # the JAX tests' shapes, the chain, and two wide nets: block 0's
    # weights through the cache, two and eight n-tiles in the last block,
    # 4-row tiles at 64 -> 64 -> 64
    for cfg in (GuidanceNetConfig(mid_channels=4, num_layers=1,
                                  kernel_levels=2),
                GuidanceNetConfig(mid_channels=4, kernel_levels=2),
                GuidanceNetConfig(in_channels=6, mid_channels=6,
                                  kernel_levels=3),
                chain_cfg,
                GuidanceNetConfig(mid_channels=64, kernel_levels=8),
                GuidanceNetConfig(in_channels=64, mid_channels=64,
                                  kernel_levels=32)):
        params = random_params(cfg, rs)
        chans = " -> ".join(str(c) for c in [cfg.in_channels] + [
            cout for _, cout in cfg.layer_channels()])
        hold_k7(f"random aux 256x256, random net {chans}",
                build_compact(cfg, params, "cuda"),
                k7_aux(256, 256, cfg.in_channels), err)
        if cfg is chain_cfg:
            chain = build_compact(cfg, params, "cuda")
    # K7's 56x16 tiles at their edges (one pixel past a multiple, exact
    # multiples), frames with fewer tiles than the persistent grid's
    # blocks, and three images walked by one grid
    for B, H, W in K7_EDGES:
        aux = torch.cat([k7_aux(H, W, seed=13 + b) for b in range(B)])
        for name, m in (("trained.gnet", net), ("random net 8 -> 8 -> 8 "
                                                "-> 8", chain)):
            hold_k7(f"random aux {B}x{W}x{H}, {name}", m, aux, err)
    # the chain reads nearest the ulps bar: more nets and aux at 799x801
    for seed in K7_CHAIN_SEEDS:
        hold_k7(f"random aux 1x799x801, chain seed {seed}",
                build_compact(chain_cfg, random_params(
                    chain_cfg, np.random.default_rng(seed)), "cuda"),
                k7_aux(801, 799, seed=seed), err)


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
    del chs, lut
    r, ps = make_headline_renderer(n3tree.load(tree_path))
    log(json.dumps({"frame_ms": [frame_timing(r, ps.poses[0],
                                              HEADLINE_FRAME)[0]
                                 for _ in range(5)]}))
    return 0


LOAD_KEYS = ("read_s", "host_prep_s", "h2d_s", "k3_s", "lut_build_ms",
             "skip_distances_ms", "renderer_s", "first_frame_s", "total_s",
             "upload_tree_s", "peak_allocated_bytes")


def alternate(other_root, pairs, argv, name, own_script=False):
    """``pairs`` pairs of processes, OTHER_ROOT's copy of this script and
    this one in turns (other, this, this, other, ...), each run as
    ``chip_smoke.py ARGV`` from its own root; yields (pair, side, the JSON
    lines it printed) and records them in build/chip_smoke/NAME.jsonl.
    ``own_script``: both sides run this script, the other side as
    ``chip_smoke.py ARGV OTHER_ROOT`` (it imports OTHER_ROOT's package)."""
    other_root = os.path.abspath(other_root)
    require(os.path.exists(os.path.join(
        other_root, "rt_octree_tpu_torch" if own_script else "chip_smoke.py")),
        f"no {'package' if own_script else 'chip_smoke.py'} in {other_root}")
    roots = {"other": other_root, "this": HERE}
    os.makedirs(WORK, exist_ok=True)
    with open(os.path.join(WORK, f"{name}.jsonl"), "w") as f:
        for i in range(pairs):
            for side in (("other", "this") if i % 2 == 0
                         else ("this", "other")):
                t0 = time.perf_counter()
                cmd = ([os.path.join(HERE, "chip_smoke.py"), *argv]
                       + ([other_root] if side == "other" else [])
                       if own_script else
                       [os.path.join(roots[side], "chip_smoke.py"), *argv])
                out = subprocess.run([sys.executable, *cmd],
                                     capture_output=True, text=True,
                                     cwd=roots[side])
                require(out.returncode == 0, f"{name}: {side} process {i} "
                        f"failed:\n{out.stderr[-3000:]}")
                lines = [json.loads(ln) for ln in out.stdout.splitlines()
                         if ln.startswith("{")]
                f.write(json.dumps({"pair": i, "side": side,
                                    "root": roots[side], "lines": lines})
                        + "\n")
                log(f"[{name}] pair {i} {side}: process "
                    f"{time.perf_counter() - t0:.1f} s")
                yield i, side, lines


def spread(values):
    """The least value, quartiles and largest value of ``values``."""
    q = np.percentile(values, [0, 25, 50, 75, 100])
    return dict(zip(("min", "q1", "median", "q3", "max"), map(float, q)))


def load_pairs(other_root, pairs):
    """--load-pairs: ``pairs`` pairs of --load-only processes, OTHER_ROOT's
    and this checkout's in turns, on the headline npz; each side's least
    value, quartiles and largest value of each step, for the first load of
    a process ("fresh"), its second ("warm") and K3's entries alone."""
    tree_path = os.path.join(WORK, "shell_d9_sh9.npz")
    if not os.path.isfile(tree_path):
        headline_tree_path()
    runs = {side: {"fresh": [], "warm": [], "k3_ms": [], "frame_ms": []}
            for side in ("other", "this")}
    for i, side, lines in alternate(other_root, pairs,
                                    ["--load-only", tree_path],
                                    "load_pairs"):
        loads = [ln["load"] for ln in lines if "load" in ln]
        k3 = [ln["k3_ms"] for ln in lines if "k3_ms" in ln]
        fr = [ln["frame_ms"] for ln in lines if "frame_ms" in ln]
        require(len(loads) == 2 and len(k3) == 1 and len(fr) == 1,
                f"{side} load {i}: unexpected output")
        runs[side]["fresh"].append(loads[0])
        runs[side]["warm"].append(loads[1])
        runs[side]["k3_ms"].append(k3[0])
        runs[side]["frame_ms"].append(float(np.median(fr[0])))
    summary = {"pairs": pairs, "order": "other, this, this, other, ...",
               "roots": {"other": os.path.abspath(other_root),
                         "this": HERE}}
    for side, r in runs.items():
        summary[side] = {
            **{kind: {k: spread([ld[k] for ld in r[kind]])
                      for k in LOAD_KEYS} for kind in ("fresh", "warm")},
            "k3_ms": {k: spread([x[k] for x in r["k3_ms"]])
                      for k in ("lut_build", "skip_distances")},
            "frame_ms": spread(r["frame_ms"])}
    # within each pair: this checkout's sum less the other's
    summary["total_s_this_less_other"] = {
        kind: spread([a["total_s"] - b["total_s"] for a, b in zip(
            runs["this"][kind], runs["other"][kind])])
        for kind in ("fresh", "warm")}
    summary["frame_ms_this_less_other"] = spread(np.subtract(
        runs["this"]["frame_ms"], runs["other"]["frame_ms"]))
    log(json.dumps({"load_pairs": summary}))
    return 0


# K7 alone: (size, height, width, the kit whose trained.gnet it runs)
K7_SIZES = (("800x800", 800, 800, "quality"),
            ("1920x1080", 1080, 1920, "quality_tt"))


def k7_only():
    """--k7-only: K7 of the package beside this file at K7_SIZES, on
    k7_aux, by k7_ms, beside its bound; one JSON line {"k7_ms": ...}."""
    from rt_octree_tpu_torch.models.guidance_net import load_model
    from rt_octree_tpu_torch.native import build as native
    native.build()
    res = {"root": HERE}
    for label, H, W, kit in K7_SIZES:
        net, _ = load_model(os.path.join(HERE, "benchmarks", kit,
                                         "trained.gnet"), "cuda")
        b_ms, b_by = k7_bound(net, H * W)
        res[label] = {"kernel": k7_ms(net, k7_aux(H, W)), "bound": b_ms,
                      "bound_by": b_by}
    log(json.dumps({"k7_ms": res}))
    return 0


def k7_pairs(other_root, pairs):
    """--k7-pairs: ``pairs`` pairs of --k7-only processes, OTHER_ROOT's and
    this checkout's in turns; each side's K7 times at K7_SIZES (least,
    quartiles, largest) and this side's less the other's within a pair."""
    ms = {side: {s[0]: [] for s in K7_SIZES} for side in ("other", "this")}
    for i, side, lines in alternate(other_root, pairs, ["--k7-only"],
                                    "k7_pairs"):
        k7 = [ln["k7_ms"] for ln in lines if "k7_ms" in ln]
        require(len(k7) == 1, f"{side} K7 process {i}: unexpected output")
        for label in ms[side]:
            ms[side][label].append(k7[0][label]["kernel"])
    log(json.dumps({"k7_pairs": {
        "pairs": pairs, "order": "other, this, this, other, ...",
        "roots": {"other": os.path.abspath(other_root), "this": HERE},
        "raw_ms": ms,
        **{side: {k: spread(v) for k, v in ms[side].items()}
           for side in ms},
        "this_less_other": {k: spread(np.subtract(ms["this"][k],
                                                  ms["other"][k]))
                            for k in ms["this"]}}}))
    return 0


def classic_options(label):
    """The RenderOptions of a CLASSIC_SETTINGS label."""
    from rt_octree_tpu_torch.core.options import RenderOptions
    if label == "ground_truth":
        return RenderOptions(spp=1, denoise=False, estimator="classic")
    opt = headline_options()
    opt.estimator = "classic"
    return opt


def frame_digest(frame) -> str:
    """The first 16 hex digits of the sha256 of a frame's tensors."""
    import hashlib
    h = hashlib.sha256()
    for t in frame:
        if t is not None:
            h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def classic_only(root):
    """--classic-only [ROOT]: render_classic of the package under ROOT
    (default: beside this file) alone on the headline tree at 800x800, pose
    r_0, at CLASSIC_SETTINGS, by cuda_ms over CLASSIC_REPS calls after a
    warm-up; K1 alone and the headline frame (K1, K7, K2) the same way; and
    each frame's digest, so that two checkouts' frames can be compared bit
    for bit.  One JSON line {"classic_ms": ...}."""
    import torch
    from rt_octree_tpu_torch.io import n3tree
    from rt_octree_tpu_torch.io.poses import load_poses
    from rt_octree_tpu_torch.native import build as native
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.render import renderer as R
    native.build()
    tree_path = os.path.join(WORK, "shell_d9_sh9.npz")
    if not os.path.isfile(tree_path):
        headline_tree_path()
    dt = upload_tree(n3tree.load(tree_path), lut_levels=9, device="cuda")
    ps = load_poses("blender", os.path.join(KIT, "transforms_test.json"),
                    800, 800)
    r = R.Renderer(dt, 800, 800, ps.fx, ps.fy, options=headline_options())
    r.set_denoiser(os.path.join(KIT, "trained.gnet"))
    pose = ps.poses[0]
    tf = r._transform(pose)
    res = {"root": root, "package": os.path.dirname(os.path.dirname(
        os.path.abspath(R.__file__)))}
    for label, max_steps in CLASSIC_SETTINGS:
        kw = dict(width=800, height=800, fx=ps.fx, fy=ps.fy,
                  opt=classic_options(label), max_steps=max_steps)
        res[label] = {
            "ms": cuda_ms(lambda: R.render_noisy(dt, tf, 0, 0, **kw),
                          CLASSIC_REPS, 5),
            "max_steps": max_steps,
            "digest": frame_digest(R.render_noisy(dt, tf, 0, 0, **kw))}
    kw = dict(width=800, height=800, fx=ps.fx, fy=ps.fy, opt=r.options)
    rng = (r.rng.state, r.rng.inc)
    res["k1"] = {"ms": cuda_ms(lambda: R.render_noisy(dt, tf, *rng, **kw),
                               CLASSIC_REPS, 5),
                 "digest": frame_digest(R.render_noisy(dt, tf, *rng, **kw))}

    def frame():
        r.render(pose, want_aux=False)
        r.advance_rng()
    res["headline_frame"] = {"ms": cuda_ms(frame, CLASSIC_REPS, 5)}
    log(json.dumps({"classic_ms": res}))
    return 0


def classic_pairs(other_root, pairs):
    """--classic-pairs: ``pairs`` pairs of --classic-only processes, this
    script on OTHER_ROOT's package and on its own in turns; each side's
    times (least, quartiles, largest), this side's less the other's within
    a pair, and whether the two sides' frames are bit-equal.  One JSON line
    {"classic_pairs": ...}."""
    if not os.path.isfile(os.path.join(WORK, "shell_d9_sh9.npz")):
        headline_tree_path()
    keys = [label for label, _ in CLASSIC_SETTINGS] + ["k1",
                                                       "headline_frame"]
    ms = {side: {k: [] for k in keys} for side in ("other", "this")}
    digests = {side: {} for side in ms}
    for i, side, lines in alternate(other_root, pairs, ["--classic-only"],
                                    "classic_pairs", own_script=True):
        got = [ln["classic_ms"] for ln in lines if "classic_ms" in ln]
        require(len(got) == 1, f"{side} classic process {i}: unexpected "
                "output")
        for k in keys:
            ms[side][k].append(got[0][k]["ms"])
            if "digest" in got[0][k]:
                digests[side].setdefault(k, set()).add(got[0][k]["digest"])
    log(json.dumps({"classic_pairs": {
        "pairs": pairs, "order": "other, this, this, other, ...",
        "roots": {"other": os.path.abspath(other_root), "this": HERE},
        "raw_ms": ms,
        **{side: {k: spread(v) for k, v in ms[side].items()} for side in ms},
        "this_less_other": {k: spread(np.subtract(ms["this"][k],
                                                  ms["other"][k]))
                            for k in keys},
        "bit_equal": {k: len(digests["this"][k] | digests["other"][k]) == 1
                      for k in digests["this"]},
        "digests": {side: {k: sorted(v) for k, v in d.items()}
                    for side, d in digests.items()}}}))
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
    frame_timing(r, pose, HEADLINE_FRAME)
    return ms, bounds


HEADLINE_FRAME = "headline (800x800, SPP 6, denoise on, depth-9 shell, pose r_0)"


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


def phase_fast_classic(r, ps, err, tree_host, gates):
    """The slice's new paths on the headline tree: render_classic vs its
    plain version at 800x800, without a mesh pass and with the fourth CLI
    run's drawlist pass, with its statistics, bound and time; K4 at
    400->800 (F.interpolate on its rgba planes timed as a note); the
    classic gate; each fast frame held
    at its own shapes (hold_fast), its gate, time and phase split; the
    probe overlay and the host rasterizer as plain rows.  Records each fast
    gate's (noisy, denoised) dB in ``gates`` and returns (ms, bounds) of
    the two new kernels."""
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
    # at the ground-truth settings of make_quality_dataset
    kw_gt = dict(width=800, height=800, fx=r.fx, fy=r.fy,
                 opt=classic_options("ground_truth"),
                 max_steps=dict(CLASSIC_SETTINGS)["ground_truth"])
    hold_k1("headline tree 800x800 classic at the ground-truth settings "
            f"(max_steps {kw_gt['max_steps']}), pose r_0", r.tree, tf, kw_gt,
            "render_classic", err)
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
    st = hold_classic_stats("headline tree 800x800", r.tree, tf, kw)
    steps = st.steps.flatten().float()
    p50, p99 = torch.quantile(
        steps, torch.tensor([0.5, 0.99], device=steps.device)).tolist()
    shaded = int(st.shaded.sum())
    # as K1's bound: the three outputs, each LUT cell and chs row read once
    # (8 B), each shaded f16 row once; every step marches, a shaded step
    # also shades
    nbytes = (80 * n + 48 + 8 * (st.lut_cells + st.chs_rows)
              + 2 * r.tree.data_dim * st.data_rows)
    ops = (K1_OPS_PER_STEP * float(steps.sum())
           + (6 * max(r.tree.basis_dim, 0) + 16) * shaded)
    bounds["render_classic"] = bound(nbytes, ops) + (None,)
    ms["render_classic"] = (
        cuda_ms(lambda: R.render_noisy(r.tree, tf, 0, 0, **kw),
                CLASSIC_REPS, 5),
        cuda_ms(lambda: R.render_noisy_plain(r.tree, tf, 0, 0, **kw), 1))
    gt_ms = cuda_ms(lambda: R.render_noisy(r.tree, tf, 0, 0, **kw_gt),
                    CLASSIC_REPS, 5)
    log(json.dumps({"classic_stats": {
        "frame": "800x800 classic depth-9 shell, level-9 LUT, pose r_0",
        "steps_mean": float(steps.mean()), "steps_p50": p50,
        "steps_p99": p99, "steps_max": int(steps.max()),
        "rays_stepping": int((steps > 0).sum()), "rays": n,
        "steps_total": int(steps.sum()), "shaded_total": shaded,
        "shaded_share": shaded / max(float(steps.sum()), 1.0),
        "descents_total": int(st.descents.sum()),
        "lane_efficiency": {f"{w}x{h}": R.lane_efficiency(st.steps, w, h)
                            for w, h in ((32, 1), (8, 4), (4, 8))},
        "lut_cells": st.lut_cells, "chs_rows": st.chs_rows,
        "data_rows": st.data_rows, "bound_bytes": nbytes,
        "bound_f32_ops": ops, "bound_us": bounds["render_classic"][0] * 1e3,
        "bound_by": bounds["render_classic"][1],
        "ms": {"cli": ms["render_classic"][0], "ground_truth": gt_ms}}}))

    # K4 at the s = 0.5 frame's size, with aux_chw as the CLI's frames
    # take it (16 B read per inner pixel, 80 B written per output pixel);
    # device_ms, as the kernel is shorter than its wrapper's host code
    aux = upsample_input(400, 400)
    rgba = aux[..., :4].permute(2, 0, 1)[None].contiguous()
    ms["upsample"] = (
        device_ms(lambda: fast_upsample(aux, 800, 800), 200, 10),
        device_ms(lambda: fast_upsample_plain(aux, 800, 800), 20, 3))
    # no single PyTorch call writes K4's image and aux, so its library
    # column is none; F.interpolate on the rgba planes alone (a quarter of
    # K4's output) is timed as a note
    rgba_ms = device_ms(lambda: F.interpolate(
        rgba, size=(800, 800), mode="bilinear", align_corners=False,
        antialias=False), 200, 10)
    log(f"[timing] note: F.interpolate on the rgba planes alone, 400->800 "
        f"(not K4's function: {4 * 4 * n} of K4's {80 * n} bytes written): "
        f"{rgba_ms:.4f} ms")
    bounds["upsample"] = bound(16 * 400 * 400 + 80 * n) + (None,)
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
        gates[f"fast s={scale}"] = phase_quality(
            rf, ps.poses, f"fast s={scale} ({gnet})", (g_noisy, g_den))
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


def train_argv(kit, epochs, task="train", exp_name="shell"):
    """``rtoctree train`` on the kit with configs/blender.txt: a checkpoint
    and a .gnet every epoch, no test inside the run."""
    return ["train", "--config", os.path.join(HERE, "configs", "blender.txt"),
            "--task", task, "--data_dir", kit,
            "--logs_root", os.path.join(WORK, "train_logs"),
            "--exp_name", exp_name, "--epochs", str(epochs), "--i_save",
            "1", "--device", "cuda"]


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


def k56_bounds(B, L, H, W, sup):
    """K5's and K6's bounds (bound ms, "bytes" or "operations", library
    ms None) at [B, L, H, W] with supports ``sup``.  K5: weight and
    guidance (8 B a pixel and level) and rgba (16 B) in, out (16 B) and
    fm, den (20 B a pixel and level) written; a tap is a subtraction, an
    expf, an add and three multiply-adds (9 operations), a level's blend
    6.  K6: G and rgba (32 B), weight, guidance, fm, den (28 B a pixel and
    level) in, two gradients (8 B) out; a tap of the gather is a
    subtraction, an expf, three multiply-adds for u.x, a subtraction and a
    multiply-add (12 operations), a staged pixel 12.  The counts are
    those of the per-tap form, kept for every version of the kernels so
    that their shares of the bound read the same work."""
    n, nl = B * H * W, B * L * H * W
    taps = sum((2 * s + 1) ** 2 for s in sup if s > 0)
    return {
        "guided_filter_batch": bound(n * 32 + nl * 28,
                                     n * (9 * taps + 6 * L)) + (None,),
        "guided_filter_batch_bwd": bound(n * 32 + nl * 36,
                                         n * (12 * taps + 12 * L)) + (None,)}


def train_batch(kit):
    """The train phase's real batch: the kit's training split, a fresh
    Runner on configs/blender.txt (its net drawn with seed 0) and the
    first shuffled batch (seed 1) on the card -> (runner, dataset, args,
    (aux, img_in, img_gt))."""
    import torch
    from rt_octree_tpu_torch.train.config import parse_args
    from rt_octree_tpu_torch.train.dataset import (BlenderDataset,
                                                   DatasetConfig)
    from rt_octree_tpu_torch.train.runner import Runner
    ds = BlenderDataset(DatasetConfig(data_dir=kit, spp=6, nx=10, ny=10))
    args = parse_args(train_argv(kit, TRAIN_EPOCHS)[1:])
    runner = Runner(args, dataset=ds)
    aux_all, in_all, gt_all = ds.device_split("train", "cuda")
    idx = torch.from_numpy(next(ds.iter_batch_indices(
        "train", args.batch_size, shuffle=True, seed=1))).cuda()
    return runner, ds, args, (aux_all[idx], in_all[idx], gt_all[idx])


def guard_share(fn, tiles):
    """The share of a K5 or K6 call's ``tiles`` (tile, level) pairs that
    took the guard: ``fn(guards)`` calls the wrapper with the counter."""
    import torch
    guards = torch.zeros(1, dtype=torch.int32, device="cuda")
    fn(guards)
    return int(guards) / tiles


def device_ops(fn, reps=1):
    """The device operations of ``reps`` calls of ``fn``, by
    torch.profiler: {kernel: [launches, device ms]}, their number and
    summed device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0:
            ops[e.key] = [e.count, t / 1e3]
    return {"ops": ops, "launches": sum(c for c, _ in ops.values()),
            "device_ms": sum(t for _, t in ops.values())}


def step_ops(runner, batch, warmup=3):
    """The device operations of one training step (Runner.train_step)
    after ``warmup`` steps (device_ops).  Moves the runner's net."""
    if runner.optimizer is None:
        runner.optimizer = runner.make_optimizer()
    for _ in range(warmup):
        runner.train_step(*batch)
    return device_ops(lambda: runner.train_step(*batch))


def filter_only(root):
    """--filter-only [ROOT]: K5 and K6 of the package under ROOT alone, on
    the real batch when the train kit exists (else seeded inputs at the
    training shape), by device_ms; their plain versions' times and
    errors, bounds, guard shares, an output digest, and on the real batch
    one training step's device operations.  One JSON line
    {"filter_ms": ...}."""
    import inspect

    import torch
    from rt_octree_tpu_torch.native import build as native
    from rt_octree_tpu_torch.ops import filtering as F
    native.build()
    res = {"root": root, "package": os.path.dirname(os.path.dirname(
        os.path.abspath(F.__file__)))}
    kit = os.path.join(WORK, "train_kit")
    rs = np.random.default_rng(0)
    runner = None
    if os.path.isfile(os.path.join(kit, "transforms_test.json")):
        runner, _, _, batch = train_batch(kit)
        aux, img, _ = batch
        with torch.no_grad():
            w, g = runner.model(aux.permute(0, 2, 3, 1))
        sup = runner.supports
        res["inputs"] = "real batch"
    else:
        B, L, H, W = 32, 4, 80, 80
        logits = rs.standard_normal((B, L, H, W)) * 2.0
        w = torch.softmax(torch.from_numpy(logits).float().cuda(), 1)
        g = torch.from_numpy(rs.standard_normal((B, L, H, W)) * 3.0) \
            .float().cuda()
        img = torch.from_numpy(rs.random((B, H, W, 4))).float().cuda()
        sup = (1, 2, 3, 4)
        res["inputs"] = "seeded"
    w, g = w.contiguous(), g.contiguous()
    G = torch.from_numpy(rs.standard_normal(tuple(img.shape))).float() \
        .cuda()
    B, L, H, W = w.shape
    fwd, bwd = F.guided_filter_batch_fwd, F.guided_filter_batch_bwd
    out, saved = fwd(w, g, img, sup)
    gw, gg = bwd(G, w, g, img, saved, sup)
    ref = F.guided_filter_batch_plain(w, g, img, sup)
    rw, rg = F.guided_filter_backward_plain(G, w, g, img, sup)
    res["err"] = {"k5": float((out - ref).abs().max()),
                  "k6_rel": max(float((a - b).abs().max() / b.abs().max())
                                for a, b in ((gw, rw), (gg, rg)))}
    res["digest"] = frame_digest((out, gw, gg))
    res["shape"], res["supports"] = [B, L, H, W], list(sup)
    res["guidance_range"] = float(g.max() - g.min())
    ms = {"k5": device_ms(lambda: fwd(w, g, img, sup), 50, 3),
          "k6": device_ms(lambda: bwd(G, w, g, img, saved, sup), 50, 3)}
    res["plain_ms"] = {
        "k5": cuda_ms(lambda: F.guided_filter_batch_plain(w, g, img, sup), 3),
        "k6": cuda_ms(lambda: F.guided_filter_backward_plain(
            G, w, g, img, sup), 3)}
    bounds = k56_bounds(B, L, H, W, sup)
    res["ms"] = ms
    res["bound_ms"] = {"k5": bounds["guided_filter_batch"][0],
                       "k6": bounds["guided_filter_batch_bwd"][0]}
    res["share_of_bound"] = {k: res["bound_ms"][k] / ms[k] for k in ms}
    if "guards" in inspect.signature(fwd).parameters:
        tiles = F.batch_tiles(B, H, W, sup)
        res["guard_share"] = {
            "k5": guard_share(lambda d: fwd(w, g, img, sup, guards=d), tiles),
            "k6": guard_share(lambda d: bwd(G, w, g, img, saved, sup,
                                            guards=d), tiles),
            "tiles": tiles}
    if runner is not None:
        res["step_ops"] = step_ops(runner, batch)
    log(json.dumps({"filter_ms": res}))
    return 0


def filter_pairs(other_root, pairs):
    """--filter-pairs: ``pairs`` pairs of --filter-only processes, this
    script on OTHER_ROOT's package and on its own in turns; each side's K5
    and K6 times (least, quartiles, largest), this side's less the other's
    within a pair, each side's digests (one a side: deterministic) and
    its last process's line.  One JSON line {"filter_pairs": ...}."""
    ms = {side: {"k5": [], "k6": []} for side in ("other", "this")}
    digests = {side: set() for side in ms}
    last = {}
    for i, side, lines in alternate(other_root, pairs, ["--filter-only"],
                                    "filter_pairs", own_script=True):
        got = [ln["filter_ms"] for ln in lines if "filter_ms" in ln]
        require(len(got) == 1, f"{side} filter process {i}: unexpected "
                "output")
        for k in ms[side]:
            ms[side][k].append(got[0]["ms"][k])
        digests[side].add(got[0]["digest"])
        last[side] = got[0]
    log(json.dumps({"filter_pairs": {
        "pairs": pairs, "order": "other, this, this, other, ...",
        "roots": {"other": os.path.abspath(other_root), "this": HERE},
        "raw_ms": ms,
        **{side: {k: spread(v) for k, v in ms[side].items()} for side in ms},
        "this_less_other": {k: spread(np.subtract(ms["this"][k],
                                                  ms["other"][k]))
                            for k in ms["this"]},
        "other_over_this": {k: float(np.median(ms["other"][k]) /
                                     np.median(ms["this"][k]))
                            for k in ms["this"]},
        "digests": {side: sorted(d) for side, d in digests.items()},
        "step_ops": step_ops_diff(last),
        "last": last}}))
    return 0


def step_ops_diff(last):
    """Each side's device operations a training step (launches, device
    ms) and the kernels whose launch counts differ (this less other), from
    the last --filter-only line of each side; None without the real
    batch."""
    if any("step_ops" not in last[side] for side in ("other", "this")):
        return None
    ops = {side: last[side]["step_ops"]["ops"] for side in ("other", "this")}
    return {
        **{side: {k: last[side]["step_ops"][k]
                  for k in ("launches", "device_ms")} for side in ops},
        "launches_this_less_other": {
            k: ops["this"].get(k, [0])[0] - ops["other"].get(k, [0])[0]
            for k in sorted(set(ops["this"]) | set(ops["other"]))
            if ops["this"].get(k, [0])[0] != ops["other"].get(k, [0])[0]}}


def phase_train(native, r, tree_path, err):
    """The training path: a kit rendered by the port from the headline
    tree; K5 and K6 held against their plain versions on a real batch of
    32 80x80 slices (the net's weight and guidance as its strided views,
    the loss's gradient) with the identity supports and the ladder, and
    the share of tiles that took the guard; the f32 train step with
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
        batch_tiles, guided_filter_backward_plain, guided_filter_batch,
        guided_filter_batch_bwd, guided_filter_batch_fwd,
        guided_filter_batch_plain)
    from rt_octree_tpu_torch.tools import make_quality_dataset as mq
    out = {}
    kit = os.path.join(WORK, "train_kit")
    t0 = time.time()
    if not os.path.isfile(os.path.join(kit, "transforms_test.json")):
        require(mq.main(["--out", kit, "--tree", tree_path,
                         "--device", "cuda"]) == 0, "kit build failed")
    out["kit_s"] = time.time() - t0
    t0 = time.time()
    runner, ds, args, batch = train_batch(kit)
    out["load_s"] = time.time() - t0
    out["slices"] = len(ds.splits["train"].aux)
    out["steps_per_epoch"] = ds.num_batches("train", args.batch_size)
    log(f"[train] kit {out['kit_s']:.1f} s, loaded in {out['load_s']:.1f} s:"
        f" {out['slices']} train slices of 80x80 (of 3200), "
        f"{out['steps_per_epoch']} steps of {args.batch_size} an epoch")

    # ---- K5 / K6 on a real batch: the net's own strided views ----
    aux, img, gt = batch
    with torch.no_grad():
        w, g = runner.model(aux.permute(0, 2, 3, 1))
    worst = {"guided_filter_batch": 0.0, "guided_filter_batch_bwd": 0.0}
    out["guard_share"] = {}
    for label, sup in (("ladder", (1, 2, 3, 4)), ("identity", (0, 1, 2, 3))):
        ref = guided_filter_batch_plain(w, g, img, sup).requires_grad_()
        runner.loss_fn(ref[..., :3], gt[..., :3]).backward()
        G = ref.grad
        ref = ref.detach()
        guards = torch.zeros(2, dtype=torch.int32, device="cuda")
        o, saved = guided_filter_batch_fwd(w, g, img, sup, guards=guards[0])
        e5 = float((o - ref).abs().max())
        gw, gg = guided_filter_batch_bwd(G, w, g, img, saved, sup,
                                         guards=guards[1])
        rw, rg = guided_filter_backward_plain(G, w, g, img, sup)
        e_w, e_g = float((gw - rw).abs().max()), float((gg - rg).abs().max())
        m_w, m_g = float(rw.abs().max()), float(rg.abs().max())
        tiles = batch_tiles(*w.shape[:1], *w.shape[2:], sup)
        share = [int(n) / tiles for n in guards.tolist()]
        out["guard_share"][label] = {"k5": share[0], "k6": share[1],
                                     "tiles": tiles}
        log(f"[train] K5 {label} {tuple(w.shape)} (guidance strides "
            f"{g.stride()}): max|diff| {e5:.3g}; K6 dL/dw max|diff| "
            f"{e_w:.3g} of {m_w:.3g}, dL/dg {e_g:.3g} of {m_g:.3g}; guidance "
            f"range {float(g.max() - g.min()):.3g}; guard share K5 "
            f"{share[0]:.4g}, K6 {share[1]:.4g} of {tiles} tile-levels")
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
    bounds = k56_bounds(*w.shape, sup)
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
            name = f"{label} {w}x{h}" + (f" (central crop of {W}x{H})"
                                         if c else "")
            hold_k1(name, dt, r._transform(pose), kw, "render", err)
            if not lod:  # render_classic on the scene's own rays
                opt = headline_options()
                opt.estimator = "classic"
                hold_k1(f"{name} classic", dt, r._transform(pose),
                        dict(kw, opt=opt), "render_classic", err)
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


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def png_psnr(path, ref_path):
    """(PSNR in dB, the MSE floored at 1e-12 as eval_gnet_kit does; max
    |diff| in 8-bit levels; share of unequal pixels) of a PNG's rgb
    against another's."""
    from rt_octree_tpu_torch.io.png import read_png
    a = read_png(path)[..., :3].astype(np.float64)
    b = read_png(ref_path)[..., :3].astype(np.float64)
    require(a.shape == b.shape, f"{path}: shape {a.shape} != {b.shape}")
    mse = float(np.mean(((a - b) / 255.0) ** 2))
    return (float(-10.0 * np.log10(max(mse, 1e-12))),
            int(np.abs(a - b).max()),
            float((a != b).any(-1).mean()))


def kit_tool(native, label, main, argv):
    """One kit tool's ``main(argv)`` with the launch counts reset just
    before it and read just after -> (counts, seconds, its result)."""
    log(f"[kits] {label}: " + " ".join(
        os.path.relpath(a, HERE) if os.sep in a else a for a in argv))
    native.reset_launches()
    t0 = time.time()
    res = main(argv)
    secs = time.time() - t0
    counts = {k: v for k, v in native.LAUNCHES.items() if v}
    log(f"[kits] {label}: {secs:.1f} s; launches {counts}")
    return counts, secs, res


def require_launches(label, counts, want):
    got = {k: counts.get(k, 0) for k in want}
    require(got == want, f"{label}: launches {got}, expected {want}")


def hold_gt_kit(label, kit, ref_kit):
    """A kit's test poses equal to the committed kit's (matrices exactly,
    camera_angle_x within 1e-12), and each test PNG against the committed
    one at KIT_GT_PSNR dB or more."""
    with open(os.path.join(kit, "transforms_test.json")) as f:
        got = json.load(f)
    with open(os.path.join(ref_kit, "transforms_test.json")) as f:
        ref = json.load(f)
    require(len(got["frames"]) == len(ref["frames"]) and all(
        np.array_equal(np.asarray(a["transform_matrix"]),
                       np.asarray(b["transform_matrix"]))
        for a, b in zip(got["frames"], ref["frames"])),
        f"{label}: the test poses are not {ref_kit}'s")
    require(abs(got["camera_angle_x"] - ref["camera_angle_x"]) <= 1e-12,
            f"{label}: camera_angle_x {got['camera_angle_x']} != "
            f"{ref['camera_angle_x']}")
    rows = [png_psnr(os.path.join(kit, "test", f"{n}.png"),
                     os.path.join(ref_kit, "test", f"{n}.png"))
            for n in (os.path.basename(fr["file_path"])
                      for fr in ref["frames"])]
    held = {"psnr": [r[0] for r in rows], "max_diff": [r[1] for r in rows],
            "unequal": [r[2] for r in rows]}
    log(f"[kits] {label} vs {os.path.relpath(ref_kit, HERE)}: poses equal; "
        f"per pose PSNR {[round(v, 3) for v in held['psnr']]} dB, max "
        f"|diff| {held['max_diff']} levels, unequal pixels "
        f"{[round(v, 5) for v in held['unequal']]}")
    require(min(held["psnr"]) >= KIT_GT_PSNR,
            f"{label}: a pose is under {KIT_GT_PSNR} dB against the "
            "committed ground truth")
    return held


def hold_eval(label, means, net, gate):
    """eval_gnet_kit's noisy and denoised means against the same run's gate
    of the same frames, within KIT_EVAL_TOL dB."""
    got = (means["noisy"]["psnr"], means[net]["psnr"])
    log(f"[kits] {label}: eval_gnet_kit noisy {got[0]:.4f} / denoised "
        f"{got[1]:.4f} dB ({means[net]['poses']} poses; psnr_obj "
        f"{means[net]['psnr_obj']:.3f}, ssim {means[net]['ssim']:.5f}); "
        f"the gate {gate[0]:.4f} / {gate[1]:.4f}")
    require(means[net]["poses"] == 8
            and all(abs(a - b) <= KIT_EVAL_TOL for a, b in zip(got, gate)),
            f"{label}: the evaluation is not within {KIT_EVAL_TOL} dB of "
            "the gate")
    return {"noisy": got[0], "denoised": got[1], "gate": list(gate),
            "psnr_obj": means[net]["psnr_obj"], "ssim": means[net]["ssim"]}


def phase_kits(native, r, tree_path, gates):
    """The kit tools on the card, each run with the launch counts reset
    just before it and read just after: the solid, tt and blobs GT kits
    (--gt_only, KIT_GT_TRAIN train poses drawn first) on the cached trees,
    held to the committed kits (hold_gt_kit; render_classic 8 launches, K1
    none, K3 3 + 3 an upload), and phase_train's shell kit held the same
    way; the shell fast kit at s = 0.5 (32 train + 8 test, its test PNGs
    byte-equal to the committed ones) and the llff interactive rung's test
    split (LOD d8 x s = 0.5), each evaluated with the committed fast net by
    eval_gnet_kit against the gate of ``gates``; a fast net trained on the
    port's shell fast kit (K5 and K6 once a step), compacted, stamped with
    set_gnet_meta fast_scale=0.5 and rendered at s = 0.5 on the 8
    committed poses (PSNR, no bar).  Prints one {"kits": ...} line."""
    import filecmp
    import torch
    from rt_octree_tpu_torch.io.poses import load_poses
    from rt_octree_tpu_torch.models.guidance_net import load_compact
    from rt_octree_tpu_torch.render import renderer as R
    from rt_octree_tpu_torch.tools import eval_gnet_kit as ek
    from rt_octree_tpu_torch.tools import make_fast_kit as fk
    from rt_octree_tpu_torch.tools import make_quality_dataset as mq
    from rt_octree_tpu_torch.tools import set_gnet_meta as sm
    t_phase = time.time()
    root = os.path.join(WORK, "kits")
    if os.path.isdir(root):
        shutil.rmtree(root)
    out = {"gt": {}}

    # ---- ground-truth kits of the three scenes ----
    for scene, name in KIT_GT_SCENES.items():
        kit = os.path.join(root, f"gt_{scene}")
        counts, secs, _ = kit_tool(native, f"GT kit {scene}", mq.main, [
            "--out", kit, "--scene", scene, "--gt_only", "--n_train",
            str(KIT_GT_TRAIN), "--device", "cuda", "--tree",
            os.path.join(WORK, f"{mq.tree_kind(scene)}_d9_sh9.npz")])
        require_launches(f"GT kit {scene}", counts, {
            "render_classic": 8, "render": 0, "lut_build": 3,
            "skip_distances": 3})
        out["gt"][scene] = dict(hold_gt_kit(
            f"GT kit {scene}", kit, os.path.join(HERE, "benchmarks", name)),
            s=secs, bytes=dir_bytes(kit), launches=counts)
    out["gt"]["shell"] = hold_gt_kit(
        "phase_train's shell kit", os.path.join(WORK, "train_kit"), KIT)

    # ---- the fast kits, and the committed fast nets on them ----
    def fast_kit(label, kit, argv, launches, gt_kit, net, gate):
        counts, secs, _ = kit_tool(native, label, fk.main, [
            "--out", kit, "--gt_kit", gt_kit, "--device", "cuda"] + argv)
        require_launches(label, counts, launches)
        with open(os.path.join(gt_kit, "transforms_test.json")) as f:
            names = [os.path.basename(fr["file_path"])
                     for fr in json.load(f)["frames"]]
        require(all(filecmp.cmp(os.path.join(kit, "test", f"{n}.png"),
                                os.path.join(gt_kit, "test", f"{n}.png"),
                                shallow=False) for n in names),
                f"{label}: a test PNG is not the committed one")
        ev_counts, ev_s, means = kit_tool(
            native, f"{label}: eval_gnet_kit", ek.main,
            [kit, net, "--device", "cuda"])
        require_launches(f"{label}: eval_gnet_kit", ev_counts, {
            "guidance_net": 8, "guided_filter": 8, "render": 0})
        return dict(s=secs, bytes=dir_bytes(kit), launches=counts,
                    eval=dict(hold_eval(label, means, net, gate), s=ev_s,
                              launches=ev_counts))

    fast = os.path.join(root, "fast_shell")
    out["fast_shell"] = fast_kit(
        "shell fast kit s=0.5", fast, ["--tree", tree_path],
        {"render": 72, "upsample": 40, "guidance_net": 32,
         "guided_filter": 32, "render_classic": 0, "lut_build": 3,
         "skip_distances": 3}, KIT,
        os.path.join(KIT, "fast.gnet"), gates["fast s=0.5"])
    blobs_kit = os.path.join(HERE, "benchmarks", "quality_blobs")
    out["llff_interactive"] = fast_kit(
        "llff interactive test split", os.path.join(root, "fast_blobs_lod8"),
        ["--scene", "blobs", "--lod", "8", "--splits", "test", "--tree",
         os.path.join(WORK, "blobs_d9_sh9.npz")],
        {"render": 8, "upsample": 8, "guidance_net": 0, "guided_filter": 0,
         "render_classic": 0, "lut_build": 6, "skip_distances": 6},
        blobs_kit,
        os.path.join(blobs_kit, "fast.gnet"), gates["llff interactive"])

    # ---- a fast net trained on the port's own kit ----
    work = os.path.join(WORK, "train_logs", "fast")
    if os.path.isdir(work):
        shutil.rmtree(work)
    t0 = time.time()
    counts = train_cli(native, "fast kit",
                       train_argv(fast, KIT_TRAIN_EPOCHS, exp_name="fast"),
                       required=TRAIN_KERNELS)
    ckpt = torch.load(os.path.join(work, f"checkpoint_{KIT_TRAIN_EPOCHS:06d}"
                                   ".pt"), map_location="cpu",
                      weights_only=True)
    steps = int(ckpt["optimizer"]["state"][0]["step"])
    require(steps > 0 and all(counts[k] == steps for k in TRAIN_KERNELS),
            f"K5 / K6 launches {[counts[k] for k in TRAIN_KERNELS]} != "
            f"{steps} steps")
    train_cli(native, "fast kit compact",
              train_argv(fast, KIT_TRAIN_EPOCHS, "compact", "fast"),
              absent=TRAIN_KERNELS)
    gnet = os.path.join(work, "ts_latest.gnet")
    require(sm.main([gnet, "fast_scale=0.5"]) == 0, "set_gnet_meta failed")
    meta = load_compact(gnet, with_meta=True)[2]
    require(meta.get("fast_scale") == 0.5, f"the stamped meta reads {meta}")
    rf = R.Renderer(r.tree, r.width, r.height, r.fx, r.fy,
                    options=headline_options(), render_scale=0.5)
    rf.set_denoiser(gnet)
    ps = load_poses("blender", os.path.join(KIT, "transforms_test.json"),
                    r.width, r.height)
    noisy, den, _ = quality_psnr(rf, ps.poses)
    log(f"[kits] the port's fast net ({KIT_TRAIN_EPOCHS} epochs on its own "
        f"kit) at s=0.5, 8 poses of benchmarks/quality: noisy {noisy:.3f} "
        f"dB, denoised {den:.3f} dB (no bar; fast.gnet: "
        f"{gates['fast s=0.5'][1]:.3f})")
    out["train"] = {"epochs": KIT_TRAIN_EPOCHS, "steps": steps,
                    "launches": {k: counts[k] for k in TRAIN_KERNELS},
                    "s": time.time() - t0, "meta": meta,
                    "noisy_db": noisy, "denoised_db": den}
    out["phase_s"] = time.time() - t_phase
    log(json.dumps({"kits": out}))
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


def launched(native, required, label):
    """The launch counts since the last reset: each kernel of ``required``
    launched at least once; -> the non-zero counts."""
    counts = {k: v for k, v in native.LAUNCHES.items() if v}
    require(all(counts.get(k, 0) > 0 for k in required),
            f"{label}: a kernel never launched ({counts})")
    return counts


class _HttpClient:
    """GET and POST on one local server, as the viewer's page does."""

    def __init__(self, base):
        self.base = base

    def get(self, path):
        import urllib.request
        with urllib.request.urlopen(self.base + path,
                                    timeout=APPS_DEADLINE_S) as resp:
            return resp.read()

    def post(self, ev):
        import urllib.request
        req = urllib.request.Request(self.base + "/event",
                                     data=json.dumps(ev).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=APPS_DEADLINE_S) as resp:
            require(resp.status == 200, f"event {ev}: HTTP {resp.status}")

    def state(self):
        return json.loads(self.get("/state"))

    def wait(self, progress, label):
        """Poll /state until ``progress(state)`` leaves 0..100."""
        t0 = time.time()
        while True:
            st = self.state()
            p = progress(st)
            if not 0.0 <= p <= 100.0:
                return st
            require(time.time() - t0 < APPS_DEADLINE_S, f"{label} timed out")
            time.sleep(0.05)


def _serve(handler):
    import threading
    from http.server import ThreadingHTTPServer
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def fetch_frames(client):
    """APPS_FRAMES /frame.png round trips; -> (list of PNGs, the client's
    wall time of each in ms)."""
    pngs, trips = [], []
    for _ in range(APPS_FRAMES):
        t0 = time.perf_counter()
        pngs.append(client.get("/frame.png"))
        trips.append((time.perf_counter() - t0) * 1e3)
    return pngs, trips


def time_frame_parts(st, pngs, trips):
    """The parts of the round trips ``trips`` that served ``pngs``, timed
    from the outside with the viewer's lock held, on its state and through
    the Renderer it holds: the render to the frame on the card (host wall
    time), the kernels' own device time a render (torch.profiler over
    APPS_FRAMES renders), the host copy with to_uint8 and encode_png of
    each served frame.  The timing renders do not advance the PCG32
    state, so the viewer's next frame is the one it would have served.
    -> (dict of per-frame lists in ms, device ms a render)."""
    import torch
    from rt_octree_tpu_torch.io.png import decode_png, encode_png, to_uint8
    parts = {k: [] for k in ("render", "copy", "encode")}
    with st.lock:
        r, pose = st.renderer, st.cam.transform
        for png in pngs:
            frame = decode_png(png)
            t0 = time.perf_counter()
            img, _ = r.render_with_probe(pose, want_aux=False)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            to_uint8(img.cpu().numpy())
            t2 = time.perf_counter()
            encode_png(frame)
            t3 = time.perf_counter()
            for k, a, b in (("render", t0, t1), ("copy", t1, t2),
                            ("encode", t2, t3)):
                parts[k].append((b - a) * 1e3)
        device = device_ops(lambda: r.render_with_probe(pose,
                                                        want_aux=False),
                            APPS_FRAMES)["device_ms"] / APPS_FRAMES
    parts["round_trip"] = trips
    parts["png_kib"] = [len(p) / 1024 for p in pngs]
    return parts, device


def viewer_panel(native, client, frame0):
    """Each control of the page that the main path's kernels serve, one
    step at a time: the step's events, then one /frame.png with the counts
    reset just before it; each must launch its kernels and change the
    frame.  -> {step: launch counts}."""
    from rt_octree_tpu_torch.io.mesh import load_drawlist
    draw = os.path.join(WORK, "apps_marker.draw.npz")
    np.savez_compressed(draw, marker="cube", marker__scale=0.3,
                        marker__translation=np.array([0.0, 0.0, 1.0]),
                        marker__color=np.array([0.1, 0.2, 0.9]))
    require(len(load_drawlist(draw)) == 1, "the viewer's drawlist")
    steps = [("orbit", [{"type": "begin_drag", "x": 400, "y": 400,
                         "pan": False, "about_origin": True},
                        {"type": "drag_update", "x": 470, "y": 380},
                        {"type": "end_drag"}], ("render",))]
    steps += [(f"spp {s}", [{"type": "options", "spp": s}], ("render",))
              for s in APPS_PANEL_SPP]
    steps += [("classic", [{"type": "options", "estimator": "classic"}],
               ("render_classic",)),
              ("rt", [{"type": "options", "estimator": "rt"}], ("render",))]
    steps += [(f"render_scale {s}", [{"type": "options", "render_scale": s}],
               ("render", "upsample")) for s in APPS_FAST]
    steps += [("render_scale 1", [{"type": "options", "render_scale": 1.0}],
               ("render",)),
              ("grid", [{"type": "options", "show_grid": True}], ("render",)),
              ("no grid, probe", [{"type": "options", "show_grid": False,
                                   "enable_probe": True,
                                   "probe": [0.6, 0.0, 0.0]}], ("render",)),
              ("sphere", [{"type": "options", "enable_probe": False},
                          {"type": "add_primitive", "kind": "sphere"}],
               ("render",)),
              ("drawlist", [{"type": "clear_meshes"},
                            {"type": "load_mesh", "path": draw}],
               ("render",))]
    out, last = {}, frame0
    for label, events, required in steps:
        for ev in events:
            client.post(ev)
        native.reset_launches()
        png = client.get("/frame.png")
        out[label] = launched(native, required + APPS_DENOISED,
                              f"viewer {label}")
        require(png != last, f"viewer {label}: the frame did not change")
        last = png
    client.post({"type": "clear_meshes"})
    st = client.state()
    require(st["options"]["spp"] == 32 and st["render_scale"] == 1.0,
            f"viewer state after the panel: {st['options']}")
    return out


def phase_viewer(native, tree_path, quant_src):
    """rtoctree view at the headline's width (800x800, SPP 6, level-9 LUT,
    trained.gnet, denoise on) behind ThreadingHTTPServer on 127.0.0.1:0:
    APPS_FRAMES timed /frame.png (K1, K7, K2 once each a frame; the first
    bit-equal to a fresh Renderer's), the panel, the animation editor's
    export and a load_remote of the quant phase's npz from a second local
    server (K3 must launch)."""
    import dataclasses
    import functools
    from http.server import SimpleHTTPRequestHandler
    from rt_octree_tpu_torch.apps import viewer as V
    from rt_octree_tpu_torch.io.png import decode_png, to_uint8
    from rt_octree_tpu_torch.render.renderer import Renderer
    gnet = os.path.join(KIT, "trained.gnet")
    t0 = time.time()
    st = V.ViewerState(tree_path, APPS_SIZE, APPS_SIZE, gnet, lut_levels=9,
                       spp=APPS_SPP, device="cuda")
    load_s = time.time() - t0
    httpd, base = _serve(V.make_handler(st))
    fsrv, furl = _serve(functools.partial(SimpleHTTPRequestHandler,
                                          directory=os.path.dirname(
                                              quant_src)))
    client = _HttpClient(base)
    out = {"load_s": load_s}
    try:
        require(b"rt-octree-tpu" in client.get("/"), "the viewer's page")
        client.post({"type": "options", "denoise": True})
        for _ in range(APPS_WARMUP):
            client.get("/frame.png")
        native.reset_launches()
        pngs, trips = fetch_frames(client)
        counts = launched(native, ("render",) + APPS_DENOISED, "viewer")
        require(all(counts.get(k) == APPS_FRAMES
                    for k in ("render",) + APPS_DENOISED),
                f"viewer: K1, K7, K2 not once a frame: {counts}")
        parts, device = time_frame_parts(st, pngs, trips)
        # a fresh Renderer at the viewer's camera and options, its PCG32
        # advanced past the warm-up frames
        r = Renderer(st.dt, APPS_SIZE, APPS_SIZE, st.cam.fx, st.cam.fy,
                     options=dataclasses.replace(st.renderer.options))
        r.set_denoiser(gnet)
        for _ in range(APPS_WARMUP):
            r.advance_rng()
        img, _ = r.render(st.cam.transform, want_aux=False)
        ref = to_uint8(img.cpu().numpy())
        got = decode_png(pngs[0])
        require(got.shape == (APPS_SIZE, APPS_SIZE, 4)
                and np.array_equal(got, ref),
                "viewer: the first frame is not the fresh Renderer's")
        require(float(ref[..., 3].mean()) > 0, "viewer: an empty frame")
        del r, img
        out.update({"frames": APPS_FRAMES, "launches": counts,
                    "bit_equal": True, "device_ms": device,
                    **{k: spread(v) for k, v in parts.items()}})
        # HTTP and the client: the median round trip less the medians of
        # the parts (timed in a second pass, so not frame by frame)
        out["http_ms"] = out["round_trip"]["median"] - sum(
            out[k]["median"] for k in ("render", "copy", "encode"))
        log(f"[apps] viewer: {APPS_FRAMES} frames, round trip "
            f"{out['round_trip']}, kernels' device time {device:.4f} ms")
        out["panel"] = viewer_panel(native, client, pngs[-1])
        log(f"[apps] viewer panel: {out['panel']}")

        # the animation editor: two keyframes an orbit apart, exported at
        # 10 fps (1 s: 10 frames)
        client.post({"type": "anim_add", "duration": 1.0})
        for ev in ({"type": "begin_drag", "x": 400, "y": 400, "pan": False,
                    "about_origin": True},
                   {"type": "drag_update", "x": 300, "y": 420},
                   {"type": "end_drag"}):
            client.post(ev)
        client.post({"type": "anim_add", "duration": 1.0})
        client.post({"type": "anim_fps", "fps": 10})
        anim_dir = os.path.join(WORK, "viewer_anim")
        shutil.rmtree(anim_dir, ignore_errors=True)
        native.reset_launches()
        t0 = time.time()
        client.post({"type": "anim_render", "out_dir": anim_dir})
        s = client.wait(lambda s: s["anim"]["progress"], "viewer export")
        export_s = time.time() - t0
        require(s["anim"]["progress"] == 101.0,
                f"viewer export: {s['anim']['error']}")
        n_png = len([f for f in os.listdir(anim_dir) if f.endswith(".png")])
        require(n_png == 10, f"viewer export wrote {n_png} PNGs, not 10")
        out["anim_export"] = {"frames": n_png, "s": export_s,
                              "launches": launched(
                                  native, ("render",) + APPS_DENOISED,
                                  "viewer export")}
        require(out["anim_export"]["launches"]["render"] == 10,
                "viewer export: K1 not once a frame")

        # load_remote of the quant phase's depth-7 npz
        native.reset_launches()
        t0 = time.time()
        client.post({"type": "load_remote",
                     "url": f"{furl}/{os.path.basename(quant_src)}"})
        s = client.wait(lambda s: s["load_progress"], "load_remote")
        require(s["load_progress"] == 101.0,
                f"load_remote: {s['load_error']}")
        png = client.get("/frame.png")
        out["load_remote"] = {"s": time.time() - t0, "launches": launched(
            native, ("lut_build", "skip_distances", "render"),
            "load_remote")}
        require(decode_png(png).shape == (APPS_SIZE, APPS_SIZE, 4),
                "load_remote: the frame")
    finally:
        httpd.shutdown()
        httpd.server_close()
        fsrv.shutdown()
        fsrv.server_close()
    return out


def phase_anim_cli(native, tree_path, label, extra, required):
    """``rtoctree anim TREE examples/orbit_keyframes.json`` at 800x800 with
    the counts reset just before it and read just after: 90 frames (60 +
    30 at 30 fps), each kernel of ``required`` once a frame.  -> its
    figures and the output directory."""
    from rt_octree_tpu_torch.apps import cli
    out_dir = os.path.join(WORK, "anim_" + label)
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["anim", tree_path, os.path.join(HERE, "examples",
                                            "orbit_keyframes.json"),
            "-o", out_dir, "-w", str(APPS_SIZE), "--height", str(APPS_SIZE)]
    argv += extra
    native.reset_launches()
    t0 = time.time()
    rc = cli.main(argv)
    wall = time.time() - t0
    counts = launched(native, required, f"anim {label}")
    require(rc == 0, f"anim {label} failed")
    names = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    require(len(names) == 90, f"anim {label} wrote {len(names)} frames")
    require(all(counts[k] == 90 for k in required),
            f"anim {label}: not once a frame: {counts}")
    stamps = [os.stat(os.path.join(out_dir, f)).st_mtime_ns for f in names]
    fps = 89 / ((stamps[-1] - stamps[0]) * 1e-9)
    log(f"[apps] anim {label}: 90 frames in {wall:.1f} s "
        f"({fps:.1f} fps between the first and last frame); {counts}")
    return {"s": wall, "fps": fps, "fps_with_load": 90 / wall,
            "launches": counts}, out_dir


def phase_tools_cli(native):
    """``rtoctree tools`` on a scene folder whose transforms_{test,train}
    are the quality kit's test poses: no kernel launches, and the pose
    txts, intrinsics.txt and a drawlist the port reads are written."""
    from rt_octree_tpu_torch.apps import cli
    from rt_octree_tpu_torch.io.mesh import load_drawlist
    root = os.path.join(WORK, "tools_scenes")
    shutil.rmtree(root, ignore_errors=True)
    scene = os.path.join(root, "shell")
    os.makedirs(scene)
    for split in ("test", "train"):
        shutil.copy(os.path.join(KIT, "transforms_test.json"),
                    os.path.join(scene, f"transforms_{split}.json"))
    out = {}
    for cmd in ("extract-test-poses", "extract-cams-drawlist"):
        native.reset_launches()
        rc = cli.main(["tools", cmd, root])
        out[cmd] = {k: v for k, v in native.LAUNCHES.items() if v}
        require(rc == 0 and not out[cmd], f"tools {cmd}: rc {rc}, "
                f"launches {out[cmd]}")
    poses = sorted(os.listdir(os.path.join(scene, "pose")))
    require(poses == [f"r_{i}.txt" for i in range(8)], f"poses {poses}")
    require(os.path.isfile(os.path.join(scene, "intrinsics.txt")),
            "intrinsics.txt")
    meshes = load_drawlist(os.path.join(scene, "shell_cams.draw.npz"))
    require(len(meshes) == 1 and meshes[0].face_size == 2,
            "the camera drawlist")
    return out


def phase_apps(native, tree_path, quant_src, card):
    """rtoctree view, anim and tools (see the module docstring's phase 13);
    prints one {"apps": ...} line."""
    from rt_octree_tpu_torch.apps.anim import interp_keyframes, \
        load_keyframes
    from rt_octree_tpu_torch.io import n3tree
    from rt_octree_tpu_torch.io.png import read_png, to_uint8
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.render.renderer import Renderer
    t_phase = time.time()
    out = {"card": card, "viewer": phase_viewer(native, tree_path,
                                                 quant_src)}
    trained = os.path.join(KIT, "trained.gnet")
    out["anim"], anim_dir = phase_anim_cli(
        native, tree_path, "headline", ["--gnet", trained],
        ("render",) + APPS_DENOISED)
    # frame 0 against a fresh Renderer at keyframe 0's camera, built as
    # the CLI builds its own (the tree at upload_tree's default LUT)
    kfs, _ = load_keyframes(os.path.join(HERE, "examples",
                                         "orbit_keyframes.json"))
    cam, options = interp_keyframes(kfs[0], kfs[1], 0.0)
    r = Renderer(upload_tree(n3tree.load(tree_path), device="cuda"),
                 APPS_SIZE, APPS_SIZE, cam.fx, cam.fy, options=options)
    r.set_denoiser(trained)
    img, _ = r.render(cam.transform)
    require(np.array_equal(read_png(os.path.join(anim_dir, "000000.png")),
                           to_uint8(img.cpu().numpy())),
            "anim: frame 0 is not the fresh Renderer's")
    out["anim"]["frame0_bit_equal"] = True
    del r, img
    out["anim_fast"], _ = phase_anim_cli(
        native, tree_path, "fast_s0.5",
        ["--render_scale", "0.5", "--gnet", os.path.join(KIT, "fast.gnet")],
        ("render", "upsample") + APPS_DENOISED)
    out["tools"] = phase_tools_cli(native)
    out["phase_s"] = time.time() - t_phase
    log(json.dumps({"apps": out}, separators=(",", ":")))
    return out


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
    if argv == ["--k7-only"]:
        return k7_only()
    if argv[:1] == ["--k7-pairs"] and len(argv) in (2, 3):
        return k7_pairs(argv[1], int(argv[2]) if len(argv) == 3 else 6)
    if argv[:1] == ["--classic-only"] and len(argv) in (1, 2):
        return classic_only(PKG_ROOT)
    if argv[:1] == ["--classic-pairs"] and len(argv) in (2, 3):
        return classic_pairs(argv[1], int(argv[2]) if len(argv) == 3 else 6)
    if argv[:1] == ["--filter-only"] and len(argv) in (1, 2):
        return filter_only(PKG_ROOT)
    if argv[:1] == ["--filter-pairs"] and len(argv) in (2, 3):
        return filter_pairs(argv[1], int(argv[2]) if len(argv) == 3 else 6)
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
    paths = native.build(verbose=True, force=True)
    log(f"[build] {len(paths)} libraries in {time.time() - t0:.1f} s: "
        f"{sorted(os.path.basename(p) for p in paths.values())}")
    phase_ptxas(native)
    phase_k3(err)
    phase_k1(err)
    phase_k1_mesh_classic(err)
    phase_classic_layouts(err)
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
    gates = {}
    ms_new, bounds_new = phase_fast_classic(r, ps, err, tree, gates)
    ms.update(ms_new)
    bounds.update(bounds_new)
    train_counts, ms_new, bounds_new = phase_train(native, r, tree_path, err)
    counts.update(train_counts)
    ms.update(ms_new)
    bounds.update(bounds_new)
    scenes = phase_scenes(err, quant_src)
    gates["llff interactive"] = (scenes["llff interactive"]["psnr_noisy"],
                                 scenes["llff interactive"]["psnr_denoised"])
    phase_kits(native, r, tree_path, gates)
    del r
    log(json.dumps({"k7": err["k7"]}))
    phase_deep(err, tree)
    del tree
    probe_counts, probe_ms, probe_bounds = phase_probes(native, err)
    counts.update(probe_counts)
    ms.update(probe_ms)
    bounds.update(probe_bounds)
    phase_apps(native, tree_path, quant_src, smi[0])

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
