#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (rt_octree_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
  2. build every kernel from csrc/ with nvcc (sm_90a); ptxas's report of
     every render_classic instance (the frame's, its statistics' and the
     ray mode's; registers; no stack frame, no spills), of every
     render_kernel and render_wide_kernel instance (K1's wide instances at
     SPP <= 8, frame and ray mode: no stack frame, no spills), printed as
     JSON lines {"ptxas_render_classic": ...} and {"ptxas_render": ...};
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
     s = 0.5, 0.4, 0.7), with and without aux_chw; the ray mode
     (trace_rays, trace_rays_classic: K1's render_rays and
     render_classic_rays) vs its plain version on the NDC blobs tree's
     camera rays and on every classic instance's tree (RAY_LAYOUT_RAYS
     aimed rays with world depths, unroll 1, 2, 3 at an odd max_steps),
     every batch also permuted (its outputs the batch's, permuted, bit for
     bit);
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
  6b. the wide instances (phase_wide), each vs its plain version and
     timed: K7's wide instances on 8 -> 96 -> 24 (the fused wide
     instance, one launch a frame), 8 -> 128 -> 128 -> 8 and 8 -> 256 ->
     64 nets (the per-block plan, one launch a block) at 800x800 and at
     K7's tile edges, block by block on the input the chain gives it and
     the whole net at both bars (K7_SHARE_TIES: the share reported beside
     each side's distance from an f64 sum), the per-block plan's nets
     launch by launch (k7_chain_split: each launch's time, bound and share
     beside cuDNN's conv, bias and relu6 for the same block, and the
     chains), K2's at 12, 16 and 32 levels
     (as given and channels last; the guard's share; an 80-nat spike that
     must take the guard), K5's and K6's on the L = 12 train batch and past 65,535
     slices (K5's guard share there and with an 80-nat spike that must
     take the guard exactly where its regions hold it; on the train batch
     its statistics instance, cycles a block by phase), K1's and
     render_classic's (frame and ray mode) on SG / ASG
     trees of basis_dim 32, 48, 96 and 232 at every SPP (K1 also with a
     basis_minmax mask and WIDE_ROT_DIRS' rotations), and on the path's
     depth-8 SG32 / ASG32 frames at 800x800 and the SG32 frame's 640,000
     rays, render_classic's chunked wide instance on WIDE_CHUNKED_TREE's
     frame and rays (phase 4 holds render_classic's on
     classic_layout_trees' SG32 / ASG48 / SG96 too);
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
     plain rows ({"plain_rows": ...}); the ray mode on the headline tree:
     RAY_AIMED aimed rays at every SPP of the kernel with and without
     world depths vs its plain version, then the ray path: the headline
     frame's own 640,000 rays (plain camera rays, rodrigues,
     maybe_world2ndc) and K1's own thresholds through trace_rays and
     trace_rays_classic with the counts set to 0 just before and read just
     after (each ray kernel once), composited against K1's and
     render_classic's frames (max |diff|, share of pixels unequal), a
     seeded permutation of the rays (both modes' results the row order's,
     permuted), the medians of RAY_REPS calls in turns of both ray modes in
     row order and permuted, K1's frame and render_classic's frame, the
     plain times and the bounds, as one JSON line {"rays": ...}; then the
     training path: a kit
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
  9a. the wide path (phase_wide_path), each run with its launch counts
     reset just before and read just after: rtoctree train of two
     8 -> 96 -> 24 nets of 12 levels (the ladder, --identity_level) and a
     3-block 128-wide net (--mid_channels 128 --num_layers 3, 4 levels)
     for WIDE_TRAIN_EPOCHS on the train kit, their compact task, rtoctree
     render on the headline tree with each .gnet (the header checked; PSNR,
     no bar; the 96-wide nets: K7's fused wide instance and K2 wide once a
     frame, K2 wide's guard share on pose r_0; the 128-wide net: K7's
     per-block plan three times a frame, K2 once), rtoctree
     render of SG32 / ASG32 depth-8 trees with both estimators and of
     WIDE_CHUNKED_TREE with the classic one, and trace_rays /
     trace_rays_classic on aimed rays: {"wide_path": ...};
  9b. multi-device (rt_octree_tpu_torch/parallel, ranks launched by
     parallel/launch.py on the one card): the headline frame sharded by
     row bands at world 1 on nccl and, with fast mode at s = 0.5 and the
     classic estimator, at world 2 on gloo (both ranks on the card), each
     rank uploading the tree (K3), marching its band (K1 or
     render_classic), K4 on the gathered inner frame in fast mode, K7 and
     K2 on its halo crop: pose r_0's aux bit-equal and img within K2_TOL
     of the single process's frame at the same PCG32 state, every rank's
     frame the same, the 8-pose gates within MD_GATE_TOL of phase 8's,
     each kernel of the frame launched once a frame in every rank; then
     the train step on phase 9's real batch at world 2 (dp 2) and 4 (dp 2
     x sp 2, halo crops) on gloo against the single process from the same
     params (loss; f32 parameters after one Adam step; bf16 gradients),
     K5 and K6 once a step in every rank; at worlds 1 and 2,
     render_rays_sharded on the headline frame's rays and K1's own
     uniforms, bit-equal to the single process's trace_rays and
     render_rays once a rank; the frames' and the step's ms
     (CUDA events, the largest rank) split by stage, each run's wall
     seconds; one JSON line {"multidev": ...};
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
     relative of a float64 sum; P3 and P6 in every config of section c
     with the plan each takes; the other staging paths of both on edge
     shapes), each one's time vs its
     plain version (G3 with its CTA count and each CTA's ring depth), then
     the tools' entry points (gpu_probe basic vgather vgather_loop dma,
     microbench_gather b and c) with the counts reset: every probe
     kernel's launch count in that run must be > 0.
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
operations set it, the time of one PyTorch call that computes the same
function where there is one, and its launches in each multi-device run,
summed over the ranks), then as the last line
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

    python3 chip_smoke.py --wide-times [ROOT]
    python3 chip_smoke.py --wide-pairs OTHER_ROOT [PAIRS]

--wide-times times the wide path's kernels of the package under ROOT
(default: beside this file) alone: K7 on the seeded 8 -> 96 -> 24 net at
800x800, K2 wide on its channels-last activation (ladder 1..12), the
headline tree's 800x800 frame (pose r_0, SPP 6) denoised by that net,
render_classic's wide instance on the SG32 depth-8 shell at 800x800
(frame and ray mode, the rays in row order and in the frame's 8x4
tiles), its chunked instance on WIDE_CHUNKED_TREE (frame and rays), and
K5's and K6's wide instances on the L = 12 train batch, and K7's
per-block plan launch by launch (--k7-chain-times), as one JSON line
{"wide_times": ...}, the outputs saved in build/chip_smoke (with the
classic frames and rays of WIDE_PAIRS_TREES); --wide-pairs runs it in
PAIRS (default 6) pairs of processes, this script on OTHER_ROOT's
package and on its own in turns, and prints each side's times, their
paired differences and the largest differences between the two sides'
outputs (K7's per-block plan launch by launch bit for bit, by digest; the
denoised frames at most WIDE_PAIRS_FRAME_TOL,
render_classic's frames and rays 0, K5's outputs at most K5_TOL, K6's
gradients at most K6_REL_TOL of the other side's largest) as one JSON
line {"wide_pairs": ...}.

    python3 chip_smoke.py --k7-chain-times [ROOT]

--k7-chain-times times K7's per-block plan of the package under ROOT
(default: beside this file) on the seeded nets of WIDE_K7_CHAINS at
800x800, launch by launch on the input the chain gives each block, beside
cuDNN's conv, bias and relu6 for the same block, with each launch's bound,
share and output digest, as one JSON line {"k7_chain": ...}; --wide-times
carries the same line's numbers, and --wide-pairs holds the digests of
both sides equal.

    python3 chip_smoke.py --wide-sweep [ROOT]

--wide-sweep times render_classic's wide instances of the package under
ROOT on depth-7 shells of SG rows at each basis_dim of WIDE_SWEEP
(800x800), with the instance each frame took and its digest, and K1's
wide frame there (render_wide, SPP 6), as one JSON line
{"wide_sweep": ...}: where the shared-memory instance gives way to the
chunked one, and where K1's shade stops holding the whole basis in shared
memory (kWideFullBasis).

    python3 chip_smoke.py --probe-times [ROOT]
    python3 chip_smoke.py --probe-pairs OTHER_ROOT [PAIRS]

--probe-times times the probes of the package under ROOT (default: beside
this file) alone by device_medians at the tools' shapes: P1 (probe_affine)
and P2 (lane_gather) in turns of their own beside their library calls
(torch.add(1, x, alpha=2), torch.gather) and the launch floor (an empty
kernel, torch.cuda._sleep(0)), each also less the floor; P4 (row_sum_ring
on gpu_probe's 4096 rows of 512 B from a 512 MiB table) beside
F.embedding_bag's sum of the same rows, and P5 (row_ring_rounds, 4
rounds) in every config of microbench_gather's section b, its 512 B rows
at n 8192 also at every nbuf of RING_DEPTHS and PROBE_ROUNDS rounds (a
call's fixed cost, and the time of a round at each ring depth); P3
(lane_gather_chain at gpu_probe's shape) at 32 and 1056 rounds and P6
(flat_gather_chain) in every config of section c at 16 and 1040 rounds,
with the marginal round of each; and P4 once more from a cold L2
(cuda_ms, the L2 flushed before each call), with P4's relative error
against the float64 sum and whether every P1, P2, P3, P5 and P6 result is
bit-equal to its plain version, as one JSON line {"probe_ms": ...};
--probe-pairs runs it in PAIRS (default 6) pairs of processes, this script
on OTHER_ROOT's package and on its own in turns, and prints each side's
times, times less the floor and marginal rounds and their paired
differences as one JSON line {"probe_pairs": ...}.

    python3 chip_smoke.py --ray-times [ROOT]
    python3 chip_smoke.py --ray-pairs OTHER_ROOT [PAIRS]

--ray-times times the ray modes of the package under ROOT (default:
beside this file) alone by device_medians, each call the whole
trace_rays or trace_rays_classic: the headline frame's 640,000 rays in row
order and in the RAY_PERM_SEED permutation (render_rays,
render_classic_rays), the SG32 depth-8 shell's render_wide frame and its
rays (render_rays_wide, render_classic_rays_wide, both orders),
WIDE_CHUNKED_TREE's rays (render_classic_rays_wide_chunked, both orders)
and K1's wide frame and rays on the SG96 and SG232 trees of
WIDE_K1_TREES (its whole basis in shared memory, and a prefix of 32), as
one JSON line {"ray_times": ...},
the outputs saved in build/chip_smoke; --ray-pairs runs it in PAIRS
(default 6) pairs of processes, this script on OTHER_ROOT's package (the
parent unpacked by ``git archive <commit> rt_octree_tpu_torch | tar -x -C
build/parent``) and on its own in turns, and prints each side's times,
their paired differences, the digests and the largest differences between
the two sides' outputs (0 for every ray mode and the render_wide frame)
as one JSON line {"ray_pairs": ...}.
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
# --classic-only ROOT, --filter-only ROOT, --wide-times ROOT, --wide-sweep
# ROOT, --ray-times ROOT, --k7-chain-times ROOT and --probe-times ROOT
# import the package of another checkout (the timers of --classic-pairs,
# --filter-pairs, --wide-pairs, --ray-pairs and --probe-pairs, and a copy
# of the package with one change); every other mode imports the one beside
# this file
PKG_ROOT = (os.path.abspath(sys.argv[2])
            if sys.argv[1:2] in (["--classic-only"], ["--filter-only"],
                                 ["--wide-times"], ["--wide-sweep"],
                                 ["--ray-times"], ["--k7-chain-times"],
                                 ["--probe-times"])
            and len(sys.argv) == 3 else HERE)
sys.path.insert(0, PKG_ROOT)

from rt_octree_tpu_torch.utils.timer import cuda_ms, device_ms  # noqa: E402
from rt_octree_tpu_torch.utils.timer import device_medians  # noqa: E402

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
# the ray mode of K1 and render_classic (trace_rays, trace_rays_classic)
RAY_KERNELS = {
    "render_rays": ("rt_octree_tpu_torch/csrc/render.cu",
                    "rt_octree_tpu/render/renderer.py:540"),
    "render_classic_rays": ("rt_octree_tpu_torch/csrc/render.cu",
                            "rt_octree_tpu/render/renderer.py:1060"),
}
# The ray phases: RAY_AIMED rays aimed at the headline tree and
# RAY_LAYOUT_RAYS at each classic instance's tree (from a sphere of radius 3
# towards points of [-0.5, 0.5]^3; dirs and the view dirs, rotated from
# them, scaled by 0.5-2), each held within K1_IMG_TOL of its plain version
# with most rays hitting; the classic instances at max_steps
# RAY_ODD_STEPS with each unroll of RAY_UNROLLS and at 8192 with unroll 2.
# The headline's own rays are timed RAY_REPS times each after RAY_WARMUP,
# in turns: row order, the permutation seeded by RAY_PERM_SEED, K1's frame
# (and the classic ray mode beside render_classic's frame).  The sharded
# ray tracer of phase 9b takes the API's step limit.
RAY_AIMED, RAY_LAYOUT_RAYS = 65536, 16384
RAY_UNROLLS, RAY_ODD_STEPS = (1, 2, 3), 7
RAY_REPS, RAY_WARMUP, RAY_PERM_SEED = 20, 3, 15
RAY_MIN_HIT = 0.5
RAY_SHARDED_MAX_STEPS = 512
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
# the probe instances in ptxas's report: G1, G2's single gather (4 columns
# a thread or 1), G3 (P4, P5 at every nbuf), G2's chain (power-of-two rows
# or not), G4 (global, local)
PROBE_PTXAS = {"affine_kernel": 1, "lane_gather_kernel": 2,
               "row_ring_kernel": 6, "lane_chain_kernel": 2,
               "flat_gather_chain_kernel": 2}
# the wide kernels' entry functions in ptxas's report: (source, kernel) ->
# instances (K7's fused wide instance a block-1 n-group of 2, 3, 4; its
# per-block plan's ring an n-tile group of 1, 2, 4, 8 and its first-block
# instance; K2's tiles of 32 x 32 and 16 x 8, and the 32 x
# 32 statistics instance; K5's and K6's timed and statistics instances)
WIDE_PTXAS = {("net", "guidance_wide2_kernel"): 3,
              ("net", "guidance_wide_kernel"): 4,
              ("net", "guidance_wide_first_kernel"): 1,
              ("filter", "guided_filter_wide_kernel"): 3,
              ("filter", "guided_filter_batch_wide_kernel"): 2,
              ("filter", "guided_filter_batch_bwd_wide_kernel"): 2}
# the wide kernels (launch name -> source, what they stand in for)
WIDE_KERNELS = {
    "guidance_net_wide": ("rt_octree_tpu_torch/csrc/net.cu",
                          "rt_octree_tpu/models/guidance_net.py:124"),
    # K7's per-block plan (launch name guidance_net_wide too): its row reads
    # the 3-block 128-wide net's path and times
    "guidance_net_wide_chain": ("rt_octree_tpu_torch/csrc/net.cu",
                                "rt_octree_tpu/models/guidance_net.py:124"),
    "guided_filter_wide": ("rt_octree_tpu_torch/csrc/filter.cu",
                           "rt_octree_tpu/ops/filtering.py:153"),
    "guided_filter_batch_wide": ("rt_octree_tpu_torch/csrc/filter.cu",
                                 "rt_octree_tpu/ops/filtering.py:188"),
    "guided_filter_batch_bwd_wide": ("rt_octree_tpu_torch/csrc/filter.cu",
                                     "rt_octree_tpu/ops/filtering.py:188"),
    "render_wide": ("rt_octree_tpu_torch/csrc/render.cu",
                    "rt_octree_tpu/render/renderer.py:1145"),
    "render_classic_wide": ("rt_octree_tpu_torch/csrc/render.cu",
                            "rt_octree_tpu/render/renderer.py:1060"),
    "render_rays_wide": ("rt_octree_tpu_torch/csrc/render.cu",
                         "rt_octree_tpu/render/renderer.py:540"),
    "render_classic_rays_wide": ("rt_octree_tpu_torch/csrc/render.cu",
                                 "rt_octree_tpu/render/renderer.py:1060"),
    # render_classic's chunked wide instance: basis_dim above 40
    "render_classic_wide_chunked": ("rt_octree_tpu_torch/csrc/render.cu",
                                    "rt_octree_tpu/render/renderer.py:1060"),
    "render_classic_rays_wide_chunked": (
        "rt_octree_tpu_torch/csrc/render.cu",
        "rt_octree_tpu/render/renderer.py:1060"),
}
KERNELS = {**FRAME_KERNELS, **RAY_KERNELS, **TRAIN_KERNELS, **WIDE_KERNELS,
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
    """Every render_classic_kernel instance (7 row layouts, each for the
    frame, its statistics and the ray mode, and the two wide layouts'
    frame and ray mode) as ptxas compiled it: no stack frame, no spills;
    every render_kernel instance (8 SPP, each for the frame, its
    statistics and the ray mode) and render_wide_kernel instance (the wide
    rows' frame and ray mode), recorded, the ray mode at SPP 16 and 32
    too, the wide ones at SPP <= 8 with no stack frame and no spills (the
    unrolled instances keep their basis in a local array, a 104-byte stack
    frame, as before); and the wide instances of K7, K2, K5 and K6.
    The probes' instances of PROBE_PTXAS (G1's, G2's, G3's and G4's), with
    no stack frame and no spills.  Prints one {"ptxas_render_classic": ...}, one
    {"ptxas_render": ...}, one {"ptxas_wide": ...} and one
    {"ptxas_probes": ...} line."""
    import re
    report = native.PTXAS.get("render", "")

    def mode(stats, rays):
        return " stats" if stats == "1" else " rays" if rays == "1" else ""
    table = {}
    for name, v in ptxas_kernels(report, "render_classic_kernel").items():
        m = re.search(r"render_classic_kernelIL(i|in)(\d+)ELb([01])ELb([01])"
                      "EE", name)
        bd = (-1 if m.group(1) == "in" else 1) * int(m.group(2))
        layout = {-1: "rgba", 0: "any", -2: "wide",
                  -3: "wide_chunked"}.get(bd, f"sh{bd}")
        table[layout + mode(m.group(3), m.group(4))] = v
    log(json.dumps({"ptxas_render_classic": table}))
    rt = {}
    for name, v in ptxas_kernels(report, "render_kernel").items():
        m = re.search(r"render_kernelILi(\d+)ELb([01])ELb([01])EE", name)
        rt[f"spp{m.group(1)}" + mode(m.group(2), m.group(3))] = v
    for name, v in ptxas_kernels(report, "render_wide_kernel").items():
        m = re.search(r"render_wide_kernelILi(\d+)ELb([01])EE", name)
        rt[f"spp{m.group(1)}" + mode("0", m.group(2)) + " wide"] = v
    log(json.dumps({"ptxas_render": rt}))
    wide = {}
    for src, kernel in WIDE_PTXAS:
        for name, v in ptxas_kernels(native.PTXAS.get(src, ""),
                                     kernel).items():
            args = re.findall(r"L[ib](\d+)E", name.split(kernel)[1])
            wide[kernel + (f"<{', '.join(args)}>" if args else "")] = v
    log(json.dumps({"ptxas_wide": wide}))
    require(len(table) == 25 and all(len(v) == 4 for v in table.values()),
            f"ptxas reported {sorted(table)}, not the 25 render_classic "
            "instances")
    require(len(rt) == 40, f"ptxas reported {sorted(rt)}, not the 40 "
            "render_kernel instances")
    require(len(wide) == sum(WIDE_PTXAS.values()), f"ptxas reported "
            f"{sorted(wide)}, not the {sum(WIDE_PTXAS.values())} wide "
            "instances of K7, K2, K5 and K6")

    def clean(v):
        return v["stack_bytes"] == v["spill_store_bytes"] == \
            v["spill_load_bytes"] == 0
    require(all(clean(v) for v in table.values()),
            "a render_classic instance has a stack frame or spills")
    wide_k1 = {k: v for k, v in rt.items() if k.endswith(" wide")
               and int(k.split()[0][3:]) <= 8}
    require(len(wide_k1) == 12 and all(clean(v) for v in wide_k1.values()),
            f"K1's wide instances at SPP <= 8 have a stack frame or spills: "
            f"{wide_k1}")
    probes = {}
    for kernel, count in PROBE_PTXAS.items():
        found = ptxas_kernels(native.PTXAS.get("probes", ""), kernel)
        for name, v in found.items():
            args = re.findall(r"L[ib](\d+)E", name.split(kernel)[1])
            probes[kernel + (f"<{', '.join(args)}>" if args else "")] = v
        require(len(found) == count, f"ptxas reported {sorted(found)}, not "
                f"the {count} instances of {kernel}")
    log(json.dumps({"ptxas_probes": probes}))
    require(all(clean(v) for v in probes.values()),
            f"a probe instance (G1's, G2's two, G3's six, G2 chain's two, "
            f"G4's two) has a stack frame or spills: {probes}")
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
    4 and 25 (random lobes), an RGBA-format tree with a basis_dim (a
    zero basis, the "any" instance), SG32 and ASG40 (the wide instance)
    and ASG48, SG96 and SG232 (the chunked wide instance, SG232 past its
    shared prefix); as (label, tree, layout)."""
    from rt_octree_tpu_torch.io import synthetic
    from rt_octree_tpu_torch.io.n3tree import BasisFormat, DataFormat
    from rt_octree_tpu_torch.render import renderer as R
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
    for label, fmt, bd in (("SG32", "SG", 32), ("ASG40", "ASG", 40),
                           ("ASG48", "ASG", 48), ("SG96", "SG", 96),
                           ("SG232", "SG", 232)):
        t = wide_tree(label, fmt, bd)
        out.append((label, t, R.classic_layout(
            t.data_format.format.value, bd, t.data_dim)))
    require([t[2] for t in out[-5:]] == ["wide"] * 2 + ["wide_chunked"] * 3,
            "the wide trees do not take the wide and chunked instances")
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
    statistics (the wide instance has none) vs the plain march's: each
    layout of classic_layout_trees
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
            hold_k1(f"{name} classic", dt, tf, kw, "render_classic"
                    + R.wide_suffix(dt, True), err)
            if not R.is_wide(dt):  # the wide instances have no statistics
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


def aimed_rays(dt, n, spp, seed):
    """n rays of synthetic.aimed_rays on the tree's device, not unit
    length (see RAY_AIMED): (dirs, vdirs, cens, dst), dst the sorted
    thresholds of seeded uniforms."""
    import torch
    from rt_octree_tpu_torch.io import synthetic
    from rt_octree_tpu_torch.utils.rng import make_sorted_dst
    rs = np.random.default_rng(seed)
    rays = synthetic.aimed_rays(rs, n, unit=False)
    u = rs.random((n, spp), np.float32)
    return (*(torch.from_numpy(a).to(dt.device) for a in rays),
            make_sorted_dst(torch.from_numpy(u).to(dt.device)))


def ray_tmax(dt, n, seed):
    """synthetic.ray_world_depths of n rays on the tree's device."""
    import torch
    from rt_octree_tpu_torch.io import synthetic
    return torch.from_numpy(synthetic.ray_world_depths(
        np.random.default_rng(seed), n)).to(dt.device)


def hold_rays(label, dt, rays, opt, err, min_hit=RAY_MIN_HIT, **kw):
    """K1's ray mode (rays = (dirs, vdirs, cens, dst)) or render_classic's
    (rays = (dirs, vdirs, cens)) vs its plain version on the same card
    (hold_ray_result), and the batch permuted by RAY_PERM_SEED: its
    outputs the batch's, permuted, bit for bit."""
    import torch
    from rt_octree_tpu_torch.render import renderer as R
    trace = R.trace_rays if len(rays) == 4 else R.trace_rays_classic
    got = trace(dt, *rays, opt, **kw)
    if len(rays) == 4:
        key, ref = "render_rays", R.trace_rays_plain(dt, *rays, opt, **kw)
    else:
        key = "render_classic_rays"
        ref = R.trace_rays_classic_plain(dt, *rays, opt, **kw)
    key += R.wide_suffix(dt, len(rays) == 3)
    hold_ray_result(label, key, got, ref, err, min_hit)
    perm = torch.randperm(rays[0].shape[0], generator=torch.Generator()
                          .manual_seed(RAY_PERM_SEED)).to(dt.device)
    pkw = dict(kw)
    if kw.get("tmax_bg") is not None:
        pkw["tmax_bg"] = kw["tmax_bg"][perm].contiguous()
    same = torch.equal(trace(dt, *(t[perm].contiguous() for t in rays), opt,
                             **pkw), got[perm])
    require(same, f"{label}: {key}'s outputs on the permuted batch are not "
            "the batch's, permuted")


def hold_ray_result(label, key, got, ref, err, min_hit=RAY_MIN_HIT):
    """A ray mode's output ``got`` (kernel ``key``) vs its plain version's
    ``ref`` within K1_IMG_TOL, finite, more than ``min_hit`` of the rays
    hitting."""
    import torch
    e = float((got - ref).abs().max())
    hit = float((got[:, 3] > 0).float().mean())
    log(f"[rays] {label} {key} ({got.shape[0]} rays): max|diff| {e:.3g}, "
        f"share hit {hit:.3f}")
    require(bool(torch.isfinite(got).all()), f"{label}: not finite")
    require(e <= K1_IMG_TOL, f"{label}: {key} disagrees with its plain "
            "version")
    require(hit > min_hit, f"{label}: too many rays miss the tree")
    err[key] = max(err.get(key, 0.0), e)


def phase_rays(err):
    """The ray mode (trace_rays, trace_rays_classic) vs its plain versions
    on phase 4's NDC blobs tree (its camera's rays, NDC-warped) and on
    every classic instance's tree of classic_layout_trees (RAY_LAYOUT_RAYS
    aimed rays with world depths, unroll 1, 2, 3 at RAY_ODD_STEPS steps
    and unroll 2 at 8192)."""
    import torch
    from rt_octree_tpu_torch.core.options import RenderOptions
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.render import renderer as R
    from rt_octree_tpu_torch.utils.rng import make_sorted_dst
    label, tree, cam = k1_scenes()[1]
    dt = upload_tree(tree, lut_levels=tree.max_depth, device="cuda")
    tf = torch.from_numpy(cam.transform.astype(np.float32)).cuda()
    dirs, cens = R.device_camera_rays(tf, cam.width, cam.height, cam.fx,
                                      cam.fy)
    wd, wc = (t.contiguous() for t in R.maybe_world2ndc(dt, dirs, cens))
    u = torch.from_numpy(np.random.default_rng(21).random(
        (cam.width * cam.height, 6)).astype(np.float32)).cuda()
    hold_rays(f"{label} camera rays in NDC", dt,
              (wd, dirs, wc, make_sorted_dst(u)), RenderOptions(spp=6), err)
    hold_rays(f"{label} camera rays in NDC", dt, (wd, dirs, wc),
              RenderOptions(estimator="classic"), err)
    for i, (label, tree, _) in enumerate(classic_layout_trees()):
        dt = upload_tree(tree, lut_levels=6, device="cuda")
        rays = aimed_rays(dt, RAY_LAYOUT_RAYS, 1, 30 + i)[:3]
        tm = ray_tmax(dt, RAY_LAYOUT_RAYS, 30 + i)
        opt = RenderOptions(estimator="classic")
        for unroll, steps in ([(u, RAY_ODD_STEPS) for u in RAY_UNROLLS]
                              + [(2, 8192)]):
            hold_rays(f"{label} unroll {unroll} max_steps {steps}", dt, rays,
                      opt, err, tmax_bg=tm, max_steps=steps, unroll=unroll)


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


# ---------------------------------------------------------------------------
# the wide instances: nets and trees past the unrolled instances' shapes
# ---------------------------------------------------------------------------

# K7's wide nets (GuidanceNetConfig keywords): the path's 8 -> 96 -> 24
# (--mid_channels 96 --kernel_levels 12), a 3-block 128-wide chain and a
# 256-wide block; each held at 800x800 and at WIDE_K7_EDGES
WIDE_K7_NETS = (dict(mid_channels=96, kernel_levels=12),
                dict(mid_channels=128, num_layers=3, kernel_levels=4),
                dict(mid_channels=256, kernel_levels=32))
WIDE_K7_EDGES = ((1, 37, 53), (1, 17, 57), (3, 17, 57), (1, 801, 799))
# The one wide hold whose whole chain passes K7_UNEQUAL_SHARE: a rounding
# tie carried through three 128-wide blocks on a small batch (1.89e-3 of
# its elements unequal; block by block, K7 and the plain chain lie equally
# far from the f64 sum).  Its share is reported; each of its launches is
# held at both bars
K7_SHARE_TIES = ("random aux 3x57x17, random net 8 -> 128 -> 128 -> 8",)
# K2's wide cases: (label, supports, height, width); the plain version of
# a support-32 window is 4,225 shifted adds a level, so L = 32 runs small
WIDE_K2_CASES = (("ladder 1..12", tuple(range(1, 13)), 800, 800),
                 ("ladder 1..12", tuple(range(1, 13)), 801, 799),
                 ("identity 0..15", tuple(range(16)), 800, 800),
                 ("ladder 1..32", tuple(range(1, 33)), 80, 96))
# K2 wide's guard: a spike of WIDE_K2_SPIKE nats in every guidance level
# at one pixel of a seeded activation (3 nats elsewhere), so that the
# (tile, level) pairs whose region holds it take the per-window form
WIDE_K2_SPIKE = 80.0
WIDE_K2_GUARD_CASE = ("ladder 1..12, an 80-nat spike", tuple(range(1, 13)),
                      160, 192, (77, 101))
# K5 / K6's wide cases: (label, B, supports, H, W); the training batch at
# L = 12 with either ladder, and batches past 65,535 slices
WIDE_K56_CASES = (("train batch ladder 1..12", 32, tuple(range(1, 13)), 80,
                   80),
                  ("train batch identity 0..11", 32, tuple(range(12)), 80,
                   80),
                  ("B x L = 65,600", 16400, (1, 2, 3, 4), 8, 8),
                  ("B = 66,000", 66000, (0, 1), 8, 8))
# K5 wide's guard: WIDE_K2_SPIKE nats at this pixel of image 0 in every
# guidance level of the train batch (3 nats elsewhere), so that the (tile,
# level) pairs whose region holds it take the per-window form
WIDE_K5_SPIKE_YX = (37, 45)
# K1's and render_classic's wide trees: depth-6 shells with SG / ASG rows
# of basis_dim 32, 48, 96 (K1 wide's whole basis in shared memory) and 232
# (a prefix of 32, csrc/render.cu:kWideFullBasis) (synthetic.with_lobes),
# held at every SPP of K1
WIDE_BASIS_TREES = (("SG32", "SG", 32), ("ASG32", "ASG", 32),
                    ("SG48", "SG", 48), ("ASG48", "ASG", 48),
                    ("SG96", "SG", 96), ("SG232", "SG", 232))
# the rotations of the view dirs K1 wide is held at on those trees (frame
# and ray mode): a small one and one whose f32 angle (2.2e5 rad) takes the
# host's cos / sin
WIDE_ROT_DIRS = ((0.3, -0.2, 0.5), (1e5, 2e5, 0.0))


def wide_net_params(cfg, rs):
    """Seeded Flax-layout params of ``cfg`` at weights of std
    1.5 / sqrt(9 cin), so that a wide block's sums stay inside relu6's
    range."""
    return {f"block_{i}": {
        "kernel": (rs.standard_normal((3, 3, cin, cout))
                   * (1.5 / np.sqrt(9 * cin))).astype(np.float32),
        "bias": (rs.standard_normal(cout) * 0.1).astype(np.float32)}
        for i, (cin, cout) in enumerate(cfg.layer_channels())}


def wide_tree(label, fmt, bd, depth=6):
    """A shell of ``depth`` with SG or ASG rows of basis_dim ``bd``
    (synthetic.with_lobes, seeded by bd)."""
    from rt_octree_tpu_torch.io import synthetic
    from rt_octree_tpu_torch.io.n3tree import BasisFormat
    tree = synthetic.make_synthetic_tree("shell", depth=depth, basis_dim=bd)
    return synthetic.with_lobes(tree, BasisFormat[fmt], bd)


# render_classic's chunked wide instance (basis_dim above 40) on the card:
# (label, format, basis_dim, shell depth) of the tree it is timed on and
# that the wide path renders
WIDE_CHUNKED_TREE = ("SG96", "SG", 96, 7)
# --ray-times' trees for K1's wide shade past the SG32 frame: the whole
# basis in shared memory at basis_dim 96 (48 KB a block), a prefix of 32
# at 232 (csrc/render.cu:kWideFullBasis)
WIDE_K1_TREES = (WIDE_CHUNKED_TREE, ("SG232", "SG", 232, 6))


def wide_tree_path(label, fmt, bd, depth):
    """The npz of wide_tree(label, fmt, bd, depth) in WORK, built and saved
    first if absent; returns (path, seconds spent building).  Its name
    carries the format, basis_dim, depth and a hash of io/synthetic.py,
    which builds it, so that a changed generator builds the tree anew."""
    import hashlib
    from rt_octree_tpu_torch.io import synthetic
    with open(synthetic.__file__, "rb") as f:
        gen = hashlib.sha256(f.read()).hexdigest()[:12]
    path = os.path.join(WORK, f"shell_d{depth}_{fmt}{bd}_{gen}.npz")
    t0 = time.time()
    if not os.path.isfile(path):
        os.makedirs(WORK, exist_ok=True)
        tree = wide_tree(label, fmt, bd, depth=depth)
        synthetic.save_npz(tree, path + ".tmp.npz")
        os.replace(path + ".tmp.npz", path)
    return path, time.time() - t0


def load_wide_tree(label, fmt, bd, depth, lut_levels=None):
    """wide_tree_path's tree uploaded to the card (LUT at its depth)."""
    from rt_octree_tpu_torch.io import n3tree
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    path, _ = wide_tree_path(label, fmt, bd, depth)
    return upload_tree(n3tree.load(path), device="cuda",
                       lut_levels=depth if lut_levels is None else lut_levels)


def filter_batch_inputs(rs, B, L, H, W):
    """Seeded K5 / K6 inputs on the card: softmaxed weight, guidance at 3
    nats, rgba in [0, 1] and dL/dout."""
    import torch
    w = torch.softmax(torch.from_numpy(rs.standard_normal(
        (B, L, H, W)).astype(np.float32)), 1)
    g = torch.from_numpy((rs.standard_normal((B, L, H, W)) * 3.0).astype(
        np.float32))
    x = torch.from_numpy(rs.random((B, H, W, 4), np.float32))
    G = torch.from_numpy(rs.standard_normal((B, H, W, 4)).astype(np.float32))
    return tuple(t.cuda() for t in (w, g, x, G))


def hold_k56(label, w, g, x, G, sup, err):
    """K5 and K6 (their wrappers' choice of instance) vs the plain forward
    and backward on the same inputs; returns the saved tensors."""
    import torch
    from rt_octree_tpu_torch.ops.filtering import (
        guided_filter_backward_plain, guided_filter_batch_bwd,
        guided_filter_batch_fwd, guided_filter_batch_plain, wide_plan)
    B, L = w.shape[:2]
    o, saved = guided_filter_batch_fwd(w, g, x, sup)
    ref = guided_filter_batch_plain(w, g, x, sup)
    e5 = float((o - ref).abs().max())
    gw, gg = guided_filter_batch_bwd(G, w, g, x, saved, sup)
    rw, rg = guided_filter_backward_plain(G, w, g, x, sup)
    e_w, e_g = float((gw - rw).abs().max()), float((gg - rg).abs().max())
    m_w, m_g = float(rw.abs().max()), float(rg.abs().max())
    kinds = ("wide" if wide_plan(B, L, sup) else "unrolled",
             "wide" if wide_plan(B * L, L, sup) else "unrolled")
    log(f"[wide] K5 ({kinds[0]}) {label} {tuple(w.shape)}: max|diff| "
        f"{e5:.3g}; K6 ({kinds[1]}) dL/dw {e_w:.3g} of {m_w:.3g}, dL/dg "
        f"{e_g:.3g} of {m_g:.3g}")
    require(e5 <= K5_TOL and bool(torch.isfinite(o).all()),
            f"K5 disagrees with its plain version ({label})")
    require(e_w <= K6_REL_TOL * m_w and e_g <= K6_REL_TOL * m_g
            and bool(torch.isfinite(gg).all()),
            f"K6 disagrees with its plain version ({label})")
    for key, kind, e in (("guided_filter_batch", kinds[0], e5),
                         ("guided_filter_batch_bwd", kinds[1],
                          max(e_w, e_g))):
        key += "_wide" if kind == "wide" else ""
        err[key] = max(err.get(key, 0.0), e)
    return saved


def hold_k7_wide(label, net, aux_nhwc, err):
    """A net with a block past 64 channels.  Each block alone as a chain
    launch (ops.guidance.chain_block: the per-block plan for a wide block)
    is held at K7's bars against the plain block on the input the chain
    gives it: block 0 the f32 aux, each later block the plain chain's bf16
    output, its channels padded with 0 as the chain pads them (no rounding
    carried over, as tests/test_torch_net.py holds K7 block by block), and
    its padded output channels must be 0.  Then the whole net as K7 runs
    it (the fused wide instance's one launch, or the chain) against the
    plain chain at both bars, but for the K7_SHARE_TIES, whose share is
    reported beside how far K7's blocks and the plain chain (cuDNN) each
    lie, block by block, from the block summed in f64 and rounded as the
    net rounds (a rounding tie carried through the chain moves elements in
    either; a bug moves K7 alone).  The fused wide instance's output must
    equal the per-block plan's chain bit for bit (the same sums)."""
    import torch
    import torch.nn.functional as F
    from rt_octree_tpu_torch.models.guidance_net import \
        compact_activation_plain
    from rt_octree_tpu_torch.ops.guidance import (chain_block, is_wide,
                                                  net_plan)
    ws = [c.weight for c in net.convs]
    bs = [c.bias for c in net.convs]
    xk = xp = aux_nhwc  # the kernel's input to a block, the plain block's
    f64 = {"k7_unequal_share": [], "plain_unequal_share": []}
    with torch.no_grad():
        for i, layer in enumerate(net.packed):
            last = i == len(net.packed) - 1
            out = chain_block(xk, layer, layer.cout if last
                              else layer.nt * 8)
            got = out[..., :layer.cout].permute(0, 3, 1, 2)
            ref = compact_activation_plain(xp, ws[i:i + 1], bs[i:i + 1])
            t_ulps, e_ulps, share, e = bf16_ulps(got, ref)
            pad_zero = not bool(out[..., layer.cout:].any())
            kind = "per-block plan" if is_wide(layer) else "fused instance"
            log(f"[k7] {label}, block {i} ({layer.cin} -> {layer.cout}, "
                f"{kind}) on the plain chain's {xk.dtype} input of "
                f"{xk.shape[-1]} channels: max|diff| {e:.3g} = {t_ulps:g} "
                f"ulps of the largest |value|, {share:.3g} of the elements "
                f"not bit-equal; padded channels 0: {pad_zero}")
            require(t_ulps <= K7_ULPS and share <= K7_UNEQUAL_SHARE
                    and pad_zero, f"K7 disagrees with its plain version on "
                    f"{label}, block {i}")
            key = ("guidance_net_wide_chain" if is_wide(layer)
                   else "guidance_net")
            err[key] = max(err.get(key, 0.0), e)
            # the block summed in f64, rounded to bf16, the bf16 bias
            # added and rounded, relu6
            xin = xp.permute(0, 3, 1, 2).to(torch.bfloat16).double()
            y = F.conv2d(xin, ws[i].to(torch.bfloat16).double(), padding=1)
            y = y.to(torch.bfloat16) + bs[i].to(torch.bfloat16)[
                None, :, None, None]
            r64 = F.relu6(y)
            f64["k7_unequal_share"].append(float((got != r64).float()
                                                 .mean()))
            f64["plain_unequal_share"].append(float((ref != r64).float()
                                                    .mean()))
            xp = ref.permute(0, 2, 3, 1)
            xk = F.pad(xp, (0, layer.nt * 8 - layer.cout)).contiguous()
        act = net.activation(aux_nhwc)
        ref = compact_activation_plain(aux_nhwc, ws, bs)
        if net_plan(net.packed) == "fused_wide":
            # one launch, the per-block plan's sums: its chain bit for bit
            x = aux_nhwc
            for i, layer in enumerate(net.packed):
                x = chain_block(x, layer, layer.cout if i == len(
                    net.packed) - 1 else layer.nt * 8)
            same = bool(torch.equal(act.permute(0, 2, 3, 1), x))
            log(f"[k7] {label}: the fused wide instance bit-equal to the "
                f"per-block plan's chain: {same}")
            require(same, f"K7's fused wide instance is not the per-block "
                    f"plan's chain bit for bit on {label}")
    t_ulps, e_ulps, share, e = bf16_ulps(act, ref)
    tie = label in K7_SHARE_TIES
    log(f"[k7] {label}, the whole chain: max|diff| {e:.3g} = {t_ulps:g} "
        f"ulps of the largest |value|, {share:.3g} of the elements not "
        f"bit-equal{' (a named tie: the share reported)' if tie else ''}; "
        f"block by block against the f64 sum, K7 "
        f"{f64['k7_unequal_share']} and the plain chain "
        f"{f64['plain_unequal_share']} of the elements unequal")
    require(act.shape == ref.shape and bool(torch.isfinite(
        act.float()).all()) and t_ulps <= K7_ULPS and (
            tie or share <= K7_UNEQUAL_SHARE),
            f"K7 disagrees with its plain version on {label}")
    key = ("guidance_net_wide" if net_plan(net.packed) == "fused_wide"
           else "guidance_net_wide_chain")
    err[key] = max(err.get(key, 0.0), e)
    k7 = err.setdefault("k7", {"holds": {}, "ms": {}})
    k7["holds"][label] = {"ulps_of_max": t_ulps, "ulps_of_element": e_ulps,
                          "unequal_share": share, "max_abs": e,
                          "elements": act.numel(), "vs_f64_by_block": f64,
                          "share_bar": not tie}


def k2_bound(L, sup, n):
    """K2's bound as phase 9 counts it: the activation (2L bf16), rgb and
    the output once; 9 operations a window tap, 10 a level a pixel."""
    taps = sum((2 * s + 1) ** 2 for s in sup if s > 0)
    return bound(n * (4 * L + 12 + 16), n * (9 * taps + 10 * L))


def k2_wide_bound(L, sup, n, guard=0.0):
    """K2 wide's bound in the form it takes: the activation (2L bf16), rgb
    and the output once; a pixel and level of support s > 0 in the
    separable form 16 s + 8 operations (as k56_bounds counts K5's), the
    guarded share of the (tile, level) pairs at 9 operations a window tap
    (spread evenly over the levels), and 10 a level for the blend."""
    pos = [s for s in sup if s > 0]
    sep = sum(16 * s + 8 for s in pos)
    taps = sum((2 * s + 1) ** 2 for s in pos)
    ops = (1 - guard) * sep + guard * 9 * taps + 10 * L
    return bound(n * (4 * L + 12 + 16), n * ops)


def k2_spike(act, L, yx):
    """The activation ``act`` [1, 2L, H, W] with WIDE_K2_SPIKE in every
    guidance level at pixel ``yx`` (WIDE_K2_GUARD_CASE)."""
    act = act.clone()
    act[0, L:, yx[0], yx[1]] = WIDE_K2_SPIKE
    return act


def k2_guards(act, img, sup):
    """One K2 call with the guard counter: (guarded (tile, level) pairs,
    their share of wide_filter_tiles)."""
    import torch
    from rt_octree_tpu_torch.ops import filtering as Fm
    guards = torch.zeros(1, dtype=torch.int32, device="cuda")
    Fm.guided_filter(act, img, sup, guards=guards)
    n = int(guards)
    return n, n / Fm.wide_filter_tiles(img.shape[0], img.shape[1], sup)


def k7_wide_launches(net, aux):
    """K7's launches for one activation of ``net`` -> (plan, launches
    (guidance_net_wide, guidance_net), what the plan launches): the fused
    wide instance once, a chain once a block (the per-block plan for its
    wide blocks, a fused instance for the others)."""
    import torch
    from rt_octree_tpu_torch.native import build as native
    from rt_octree_tpu_torch.ops.guidance import is_wide, net_plan
    native.reset_launches()
    with torch.no_grad():
        net.activation(aux)
    torch.cuda.synchronize()
    got = (native.LAUNCHES["guidance_net_wide"],
           native.LAUNCHES["guidance_net"])
    plan = net_plan(net.packed)
    wide = sum(map(is_wide, net.packed))
    want = (1, 0) if plan == "fused_wide" else (wide, len(net.packed) - wide)
    return plan, got, want


# the nets of WIDE_K7_NETS that K7 runs as a chain of the per-block plan
# (the first takes the fused wide instance)
WIDE_K7_CHAINS = WIDE_K7_NETS[1:]


def net_label(cfg):
    """"8 -> 128 -> 128 -> 8": a GuidanceNetConfig's channels."""
    return " -> ".join(str(c) for c in [cfg.in_channels] + [
        cout for _, cout in cfg.layer_channels()])


def k7_chain_split(net, aux, reps=20):
    """The per-block plan's chain of ``net`` on ``aux`` [B, H, W, 8], launch
    by launch: each block on the input the chain gives it (chain_block),
    timed alone by device_medians in turns with cuDNN's conv, bias and
    relu6 of the same block (on the block's NCHW bf16 input; block 0 with
    the aux's permute and cast), with its bound (its input read once: the
    f32 aux or the chain's padded bf16 intermediate; its output written
    once; 2 operations a multiply-add of its real channels' 3x3 taps on
    the bf16 tensor cores) and share; the whole chain (net.activation)
    and cuDNN's chain timed in the same turns; a digest of each launch's
    output.  -> {"launches": [...], "chain_ms", "cudnn_chain_ms",
    "bound_ms", "digest"}."""
    import torch
    import torch.nn.functional as F
    from rt_octree_tpu_torch.ops.guidance import chain_block
    n = aux.shape[0] * aux.shape[1] * aux.shape[2]
    wb = [c.weight.to(torch.bfloat16) for c in net.convs]
    bb = [c.bias.to(torch.bfloat16)[None, :, None, None] for c in net.convs]
    fns, rows, xs = {}, [], []
    x = aux
    with torch.no_grad():
        for i, layer in enumerate(net.packed):
            last = i == len(net.packed) - 1
            width = layer.cout if last else layer.nt * 8
            out = chain_block(x, layer, width)
            xs.append((x, layer, width))
            if i == 0:
                lib = (lambda w_, b_: lambda: F.relu6(F.conv2d(
                    aux.permute(0, 3, 1, 2).to(torch.bfloat16), w_,
                    padding=1) + b_))(wb[0], bb[0])
            else:
                xin = x[..., :layer.cin].permute(0, 3, 1, 2).contiguous()
                lib = (lambda x_, w_, b_: lambda: F.relu6(F.conv2d(
                    x_, w_, padding=1) + b_))(xin, wb[i], bb[i])
            in_bytes = (4 * layer.cin if x.dtype == torch.float32
                        else 2 * x.shape[-1])
            b_ms, b_by = bound(n * (in_bytes + 2 * width),
                               n * 2 * 9 * layer.cin * layer.cout,
                               BF16_TC_OPS_PER_S)
            rows.append({"block": i, "channels": f"{layer.cin} -> "
                         f"{layer.cout}", "bound_ms": b_ms,
                         "bound_by": b_by, "digest": frame_digest((out,))})
            fns[f"k7 {i}"] = (lambda a: lambda: chain_block(*a))(xs[-1])
            fns[f"cudnn {i}"] = lib
            x = out
        fns["k7 chain"] = lambda: net.activation(aux)

        def cudnn_chain():
            y = aux.permute(0, 3, 1, 2).to(torch.bfloat16)
            for w_, b_ in zip(wb, bb):
                y = F.relu6(F.conv2d(y, w_, padding=1) + b_)
            return y
        fns["cudnn chain"] = cudnn_chain
        med = device_medians(fns, reps, 3)
    for r in rows:
        r["ms"] = med[f"k7 {r['block']}"]
        r["cudnn_ms"] = med[f"cudnn {r['block']}"]
        r["share"] = r["bound_ms"] / r["ms"]
    return {"launches": rows, "chain_ms": med["k7 chain"],
            "cudnn_chain_ms": med["cudnn chain"],
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "digest": frame_digest((x,))}


def k7_chain_times():
    """The per-block plan's nets (WIDE_K7_CHAINS, wide_net_params seeded
    by 43) on random aux at 800x800, launch by launch (k7_chain_split) ->
    {net label: split}."""
    from rt_octree_tpu_torch.models.guidance_net import (GuidanceNetConfig,
                                                         build_compact)
    res = {}
    for kw in WIDE_K7_CHAINS:
        cfg = GuidanceNetConfig(**kw)
        net = build_compact(cfg, wide_net_params(cfg, np.random.default_rng(
            43)), "cuda")
        res[net_label(cfg)] = k7_chain_split(net, k7_aux(800, 800))
    for label, sp in res.items():
        log(f"[wide] K7 per-block plan, {label} at 800x800: chain "
            f"{sp['chain_ms']:.4f} ms (bound {sp['bound_ms']:.4f}), cuDNN "
            f"chain {sp['cudnn_chain_ms']:.4f} ms; " + "; ".join(
                f"block {r['block']} ({r['channels']}) {r['ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} {r['bound_by']}, share "
                f"{r['share']:.3f}, cuDNN {r['cudnn_ms']:.4f}"
                for r in sp["launches"]))
    return res


def phase_wide(err):
    """The wide instances against their plain versions on the card, and
    their times: K7's wide instances on WIDE_K7_NETS (800x800 and
    WIDE_K7_EDGES, K7's bars), K2's wide instance on WIDE_K2_CASES, K5's
    and K6's on WIDE_K56_CASES, and K1's and render_classic's wide
    instances (frame and ray mode; render_classic's statistics) on
    WIDE_BASIS_TREES: K1 at every SPP of the kernel at 128x128, a
    basis_minmax mask and WIDE_ROT_DIRS' rotations (frame and ray mode),
    the ray mode on RAY_LAYOUT_RAYS aimed rays; the
    classic frames and rays ride in phases 4 (classic_layout_trees).
    Then the path's shapes: the depth-8 SG32 and ASG32 trees' 800x800
    frames (SPP 6, classic) held, and the SG32 frame's own 640,000 rays
    held in both ray modes.  K7's launches a frame are pinned for each
    net (net_plan); K2 is held on each case as given and channels last,
    and on WIDE_K2_GUARD_CASE, which must take the guard; K5's and K6's
    statistics instances give their timed instances' outputs bit for bit
    on the train batch (their phase splits logged), and on the train
    batch with a spike each takes its guard exactly where its regions span
    GUARD_RANGE.  Returns (ms, bounds) of the wide kernels, each timed at
    the path's shapes: the 8 -> 96 -> 24 net (the fused wide instance),
    the per-block plan on the 8 -> 128 -> 128 -> 8 net (its own row; both
    of WIDE_K7_CHAINS' nets logged launch by launch beside cuDNN's blocks,
    k7_chain_times) and K2 at L = 12 (channels last) at 800x800, K5 and K6
    on the L = 12
    train batch (K2's, K5's and K6's bounds from the run's guard shares),
    K1, render_classic and their ray modes on the SG32 tree at 800x800
    (SPP 6), and the chunked instance on WIDE_CHUNKED_TREE."""
    import torch
    from rt_octree_tpu_torch.core.camera import Camera
    from rt_octree_tpu_torch.core.options import RenderOptions
    from rt_octree_tpu_torch.models.guidance_net import (
        GuidanceNetConfig, build_compact, compact_activation_plain)
    from rt_octree_tpu_torch.ops import filtering as Fm
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.render import renderer as R
    ms, bounds = {}, {}
    # ---- K7's wide instances ----
    rs = np.random.default_rng(41)
    nets = {}
    for kw in WIDE_K7_NETS:
        cfg = GuidanceNetConfig(**kw)
        chans = net_label(cfg)
        net = build_compact(cfg, wide_net_params(cfg, rs), "cuda")
        nets[chans] = net
        plan, got, want = k7_wide_launches(net, k7_aux(800, 800))
        with torch.no_grad():  # strided channels: cp.async, not TMA
            nchw = k7_aux(800, 800).permute(0, 3, 1, 2).contiguous()
            strided = bool(torch.equal(net.activation(
                nchw.permute(0, 2, 3, 1)), net.activation(k7_aux(800, 800))))
        log(f"[wide] K7 {chans}: plan {plan}, launches (guidance_net_wide, "
            f"guidance_net) {got} a frame; a permuted NCHW aux bit-equal: "
            f"{strided}")
        require(got == want and strided, f"K7 on {chans}: launches {got}, "
                f"not {want} ({plan}), or another activation from a "
                "permuted aux")
        hold_k7_wide(f"random aux 800x800, random net {chans}", net,
                     k7_aux(800, 800), err)
        for B, H, W in WIDE_K7_EDGES:
            aux = torch.cat([k7_aux(H, W, seed=51 + b) for b in range(B)])
            hold_k7_wide(f"random aux {B}x{W}x{H}, random net {chans}", net,
                         aux, err)
    net = nets["8 -> 96 -> 24"]
    aux = k7_aux(800, 800)
    ws = [c.weight for c in net.convs]
    bs = [c.bias for c in net.convs]

    def cudnn_chain(net_):
        """cuDNN's chain for net_ (permute, cast, then conv, bias and relu6
        a block): the library yardstick, used nowhere in the port."""
        wb = [c.weight.to(torch.bfloat16) for c in net_.convs]
        bb = [c.bias.to(torch.bfloat16)[None, :, None, None]
              for c in net_.convs]

        def run():
            x = aux.permute(0, 3, 1, 2).to(torch.bfloat16)
            for w_, b_ in zip(wb, bb):
                x = torch.nn.functional.relu6(
                    torch.nn.functional.conv2d(x, w_, padding=1) + b_)
            return x
        return run
    chain = nets["8 -> 128 -> 128 -> 8"]
    with torch.no_grad():
        ms["guidance_net_wide"] = (
            device_ms(lambda: net.activation(aux), 50, 5),
            cuda_ms(lambda: compact_activation_plain(aux, ws, bs), 10, 2))
        lib = device_ms(cudnn_chain(net), 50, 5)
        chain_plain = cuda_ms(lambda: compact_activation_plain(
            aux, [c.weight for c in chain.convs],
            [c.bias for c in chain.convs]), 10, 2)
    bounds["guidance_net_wide"] = k7_bound(net, 800 * 800) + (lib,)
    # the per-block plan's nets launch by launch, beside cuDNN's blocks
    split = k7_chain_times()
    sp = split["8 -> 128 -> 128 -> 8"]
    ms["guidance_net_wide_chain"] = (sp["chain_ms"], chain_plain)
    bounds["guidance_net_wide_chain"] = (sp["bound_ms"], "operations",
                                         sp["cudnn_chain_ms"])
    k7_ms = err.setdefault("k7", {"holds": {}, "ms": {}})["ms"]
    k7_ms["per-block plan 800x800"] = split
    # ---- K2's wide instance ----
    for label, sup, H, W in WIDE_K2_CASES:
        L = len(sup)
        act = filter_activation(rs, L, H, W, 3.0)
        img = torch.from_numpy(rs.random((H, W, 4), np.float32)).cuda()
        ref = Fm.guided_filter_act_plain(act, img, sup)
        # the activation as given and channels last (as K7 hands it over)
        for layout, a in (("contiguous", act), ("channels last", act.contiguous(
                memory_format=torch.channels_last))):
            got = Fm.guided_filter(a, img, sup)
            e = float((got - ref).abs().max())
            n_guard, share = k2_guards(a, img, sup)
            log(f"[wide] K2 {label} {W}x{H} {layout}: max|diff| {e:.3g}, "
                f"{n_guard} (tile, level) pairs took the guard")
            require(e <= K2_TOL and bool(torch.isfinite(got).all()),
                    f"K2's wide instance disagrees with its plain version "
                    f"({label}, {layout})")
            err["guided_filter_wide"] = max(
                err.get("guided_filter_wide", 0.0), e)
        if (label, H) == ("ladder 1..12", 800):
            ms["guided_filter_wide"] = (
                device_ms(lambda: Fm.guided_filter(a, img, sup), 20, 2),
                cuda_ms(lambda: Fm.guided_filter_act_plain(act, img, sup),
                        1, 0))
            contiguous_ms = device_ms(lambda: Fm.guided_filter(act, img, sup),
                                      20, 2)
            bounds["guided_filter_wide"] = k2_wide_bound(
                L, sup, H * W, share) + (None,)
            got_st, stats = Fm.guided_filter_wide_stats(a, img, sup)
            require(bool(torch.equal(got_st, Fm.guided_filter(a, img, sup))),
                    "K2 wide's statistics instance gave another image")
            log(f"[wide] K2 ladder 1..12 800x800: channels last "
                f"{ms['guided_filter_wide'][0]:.4f} ms, contiguous "
                f"{contiguous_ms:.4f} ms; guard share {share:.4g}; cycles "
                f"a tile (thread 0) {stats['cycles_per_tile']}")
            err.setdefault("k2_wide", {})["ladder 1..12 800x800"] = {
                "channels_last_ms": ms["guided_filter_wide"][0],
                "contiguous_ms": contiguous_ms, "guard_share": share,
                "stats": stats}
    label, sup, H, W, yx = WIDE_K2_GUARD_CASE
    L = len(sup)
    act = k2_spike(filter_activation(rs, L, H, W, 3.0), L, yx)
    img = torch.from_numpy(rs.random((H, W, 4), np.float32)).cuda()
    got = Fm.guided_filter(act, img, sup)
    e = float((got - Fm.guided_filter_act_plain(act, img, sup)).abs().max())
    n_guard, share = k2_guards(act, img, sup)
    log(f"[wide] K2 {label} {W}x{H}: max|diff| {e:.3g}, {n_guard} (tile, "
        f"level) pairs took the guard ({share:.4g})")
    require(e <= K2_TOL and bool(torch.isfinite(got).all()) and n_guard >= 1,
            f"K2's wide instance on {label}: max|diff| {e:.3g}, {n_guard} "
            "guarded pairs")
    err["guided_filter_wide"] = max(err["guided_filter_wide"], e)
    err["k2_wide"][label] = {"max_abs": e, "guarded_pairs": n_guard,
                             "guard_share": share}
    # ---- K5 / K6's wide instances ----
    for label, B, sup, H, W in WIDE_K56_CASES:
        w, g, x, G = filter_batch_inputs(rs, B, len(sup), H, W)
        saved = hold_k56(label, w, g, x, G, sup, err)
        if label == "train batch ladder 1..12":
            ms["guided_filter_batch_wide"] = (
                device_ms(lambda: Fm.guided_filter_batch_fwd(w, g, x, sup),
                          20, 2),
                cuda_ms(lambda: Fm.guided_filter_batch_plain(w, g, x, sup),
                        1, 0))
            ms["guided_filter_batch_bwd_wide"] = (
                device_ms(lambda: Fm.guided_filter_batch_bwd(
                    G, w, g, x, saved, sup), 20, 2),
                cuda_ms(lambda: Fm.guided_filter_backward_plain(
                    G, w, g, x, sup), 1, 0))
            tiles = Fm.batch_tiles(B, H, W, sup)
            guard = (guard_share(lambda d: Fm.guided_filter_batch_fwd(
                         w, g, x, sup, guards=d), tiles),
                     guard_share(lambda d: Fm.guided_filter_batch_bwd(
                         G, w, g, x, saved, sup, guards=d), tiles))
            log(f"[wide] K5 / K6 {label}: guard share {guard[0]:.4g} / "
                f"{guard[1]:.4g} of {tiles} tile-levels")
            b56 = k56_bounds(B, len(sup), H, W, sup, guard)
            bounds["guided_filter_batch_wide"] = b56["guided_filter_batch"]
            bounds["guided_filter_batch_bwd_wide"] = b56[
                "guided_filter_batch_bwd"]
            got = Fm.guided_filter_batch_fwd(w, g, x, sup)
            got_st = Fm.guided_filter_batch_wide_stats(w, g, x, sup)
            require(all(bool(torch.equal(a, c)) for a, c in zip(
                (got[0],) + tuple(got[1]), (got_st[0],) + tuple(got_st[1]))),
                    "K5 wide's statistics instance gave other outputs")
            log(f"[wide] K5 {label}: cycles a block (thread 0) "
                f"{got_st[2]['cycles_per_block']}")
            err.setdefault("k5_wide", {})[label] = {"guard_share": guard[0],
                                                    "stats": got_st[2]}
            gw, gg = Fm.guided_filter_batch_bwd(G, w, g, x, saved, sup)
            gw_st, gg_st, st6 = Fm.guided_filter_batch_bwd_wide_stats(
                G, w, g, x, saved, sup)
            require(bool(torch.equal(gw, gw_st) and torch.equal(gg, gg_st)),
                    "K6 wide's statistics instance gave other gradients")
            log(f"[wide] K6 {label}: cycles a block (thread 0) "
                f"{st6['cycles_per_block']}, share {st6['share']}")
            err.setdefault("k6_wide", {})[label] = {"guard_share": guard[1],
                                                    "stats": st6}
    # K5 wide's guard on the train batch with a spike in image 0: exactly
    # the (tile, level) pairs whose staged region holds it
    label, B, sup, H, W = WIDE_K56_CASES[0]
    w, g, x, G = filter_batch_inputs(rs, B, len(sup), H, W)
    y, xx = WIDE_K5_SPIKE_YX
    g[0, :, y, xx] = WIDE_K2_SPIKE
    label += f", an {WIDE_K2_SPIKE:g}-nat spike"
    saved = hold_k56(label, w, g, x, G, sup, err)
    tiles = Fm.batch_tiles(B, H, W, sup)
    want = sum(1 for s in sup if s > 0
               for y0 in range(0, H, Fm.BATCH_TILE_H)
               for x0 in range(0, W, Fm.BATCH_TILE_W)
               if y0 - s <= y < y0 + Fm.BATCH_TILE_H + s
               and x0 - s <= xx < x0 + Fm.BATCH_TILE_W + s)
    share = guard_share(lambda d: Fm.guided_filter_batch_fwd(
        w, g, x, sup, guards=d), tiles)
    log(f"[wide] K5 {label}: guard share {share:.4g} of {tiles} "
        f"tile-levels ({round(share * tiles)}, {want} hold the spike)")
    require(round(share * tiles) == want,
            f"K5 wide's guard on {label}: {round(share * tiles)} (tile, "
            f"level) pairs, not the {want} whose region holds the spike")
    err["k5_wide"][label] = {"guard_share": share, "guarded_pairs": want}
    # K6 wide's guard: exactly the (tile, level) pairs whose region of
    # saved stabilisers spans GUARD_RANGE nats
    m = saved[0][..., 3].cpu().numpy()
    want6 = 0
    for b in range(B):
        for l, s in enumerate(sup):
            for y0 in range(0, H, Fm.BATCH_TILE_H) if s else ():
                for x0 in range(0, W, Fm.BATCH_TILE_W):
                    r = m[b, l, max(y0 - s, 0):y0 + Fm.BATCH_TILE_H + s,
                          max(x0 - s, 0):x0 + Fm.BATCH_TILE_W + s]
                    want6 += int(r.max() - r.min() >= Fm.GUARD_RANGE)
    share6 = guard_share(lambda d: Fm.guided_filter_batch_bwd(
        G, w, g, x, saved, sup, guards=d), tiles)
    log(f"[wide] K6 {label}: guard share {share6:.4g} of {tiles} "
        f"tile-levels ({round(share6 * tiles)}, {want6} whose saved "
        "stabilisers span the guard's range)")
    require(round(share6 * tiles) == want6 and want6 > 0,
            f"K6 wide's guard on {label}: {round(share6 * tiles)} (tile, "
            f"level) pairs, not the {want6} whose region spans it")
    err["k6_wide"][label] = {"guard_share": share6, "guarded_pairs": want6}
    # ---- K1's and render_classic's wide instances ----
    cam = Camera(width=128, height=128, fx=175.0, fy=175.0)
    tf = torch.from_numpy(cam.transform.astype(np.float32)).cuda()
    base = dict(width=128, height=128, fx=cam.fx, fy=cam.fy)
    for i, (label, fmt, bd) in enumerate(WIDE_BASIS_TREES):
        dt = upload_tree(wide_tree(label, fmt, bd), lut_levels=6,
                         device="cuda")
        require(R.is_wide(dt), f"{label}: not a wide tree")
        for spp in R.SPP_KERNEL:
            hold_k1(f"{label} 128x128 spp {spp}", dt, tf,
                    dict(base, opt=RenderOptions(spp=spp, denoise=False)),
                    "render_wide", err, rng=(20230418 + spp, 1))
        hold_k1(f"{label} 128x128 spp 6 basis_minmax (3, 20)", dt, tf,
                dict(base, opt=RenderOptions(spp=6, denoise=False,
                                             basis_minmax=(3, 20))),
                "render_wide", err)
        for rot in WIDE_ROT_DIRS:
            hold_k1(f"{label} 128x128 spp 6 rot_dirs {rot}", dt, tf,
                    dict(base, opt=RenderOptions(spp=6, denoise=False,
                                                 rot_dirs=rot)),
                    "render_wide", err)
        for spp in (1, 6, 32):
            rays = aimed_rays(dt, RAY_LAYOUT_RAYS, spp, 60 + i)
            hold_rays(f"{label} spp {spp}", dt, rays,
                      RenderOptions(spp=spp), err,
                      tmax_bg=ray_tmax(dt, RAY_LAYOUT_RAYS, 60 + i))
        d, v, c, dst = aimed_rays(dt, RAY_LAYOUT_RAYS, 6, 60 + i)
        hold_rays(f"{label} spp 6 basis_minmax (3, 20)", dt, (d, v, c, dst),
                  RenderOptions(spp=6, basis_minmax=(3, 20)), err,
                  tmax_bg=ray_tmax(dt, RAY_LAYOUT_RAYS, 60 + i))
        for rot in WIDE_ROT_DIRS:
            hold_rays(f"{label} spp 6 rot_dirs {rot}", dt,
                      (d, R.rodrigues(rot, v).contiguous(), c, dst),
                      RenderOptions(spp=6), err,
                      tmax_bg=ray_tmax(dt, RAY_LAYOUT_RAYS, 60 + i))
    # the times at the path's shapes: the SG32 tree at 800x800, SPP 6
    dt = load_wide_tree("SG32", "SG", 32, WIDE_TREE_DEPTH)
    cam = Camera(width=800, height=800, fx=1111.0, fy=1111.0)
    tf = torch.from_numpy(cam.transform.astype(np.float32)).cuda()
    kw = dict(width=800, height=800, fx=cam.fx, fy=cam.fy)
    opt = RenderOptions(spp=6, denoise=False)
    copt = RenderOptions(spp=1, denoise=False, estimator="classic")
    asg = load_wide_tree("ASG32", "ASG", 32, WIDE_TREE_DEPTH)
    ck = load_wide_tree(*WIDE_CHUNKED_TREE)
    for label, tree in (("SG32", dt), ("ASG32", asg)):
        hold_k1(f"{label} depth-8 800x800 spp 6", tree, tf,
                dict(kw, opt=opt), "render_wide", err)
        hold_k1(f"{label} depth-8 800x800 classic", tree, tf,
                dict(kw, opt=copt), "render_classic_wide", err)
    del asg, tree
    ck_label = f"{WIDE_CHUNKED_TREE[0]} depth-{WIDE_CHUNKED_TREE[3]}"
    hold_k1(f"{ck_label} 800x800 classic", ck, tf, dict(kw, opt=copt),
            "render_classic_wide_chunked", err)
    # the frame's own rays and PCG32 thresholds (the ray mode's bound
    # reads the frame's statistics)
    dirs, cens = R.device_camera_rays(tf, 800, 800, cam.fx, cam.fy)
    vdirs = R.rodrigues(opt.rot_dirs, dirs)
    d, c = (t.contiguous() for t in R.maybe_world2ndc(dt, dirs, cens))
    u = torch.empty((800 * 800, 6), dtype=torch.float32, device="cuda")
    R.render_noisy(dt, tf, 7, 1, opt=opt, uniforms_out=u, **kw)
    dst = R.make_sorted_dst(u)
    # the timed rays held against the plain versions (most miss the shell)
    hold_rays("SG32 depth-8, the 800x800 frame's rays, spp 6", dt,
              (d, vdirs, c, dst), opt, err, min_hit=0.0)
    hold_rays("SG32 depth-8, the 800x800 frame's rays, classic", dt,
              (d, vdirs, c), copt, err, min_hit=0.0)
    hold_rays(f"{ck_label}, the 800x800 frame's rays, classic", ck,
              (d, vdirs, c), copt, err, min_hit=0.0)
    ms["render_wide"] = (
        cuda_ms(lambda: R.render_noisy(dt, tf, 7, 1, opt=opt, **kw), 20, 3),
        cuda_ms(lambda: R.render_noisy_plain(dt, tf, 7, 1, opt=opt, **kw),
                1, 0))
    ms["render_classic_wide"] = (
        cuda_ms(lambda: R.render_noisy(dt, tf, 0, 0, opt=copt, **kw), 20, 3),
        cuda_ms(lambda: R.render_noisy_plain(dt, tf, 0, 0, opt=copt, **kw),
                1, 0))
    ms["render_rays_wide"] = (
        cuda_ms(lambda: R.trace_rays(dt, d, vdirs, c, dst, opt), 20, 3),
        cuda_ms(lambda: R.trace_rays_plain(dt, d, vdirs, c, dst, opt), 1, 0))
    ms["render_classic_rays_wide"] = (
        cuda_ms(lambda: R.trace_rays_classic(dt, d, vdirs, c, copt), 20, 3),
        cuda_ms(lambda: R.trace_rays_classic_plain(dt, d, vdirs, c, copt),
                1, 0))
    ms["render_classic_wide_chunked"] = (
        cuda_ms(lambda: R.render_noisy(ck, tf, 0, 0, opt=copt, **kw), 20, 3),
        cuda_ms(lambda: R.render_noisy_plain(ck, tf, 0, 0, opt=copt, **kw),
                1, 0))
    ms["render_classic_rays_wide_chunked"] = (
        cuda_ms(lambda: R.trace_rays_classic(ck, d, vdirs, c, copt), 20, 3),
        cuda_ms(lambda: R.trace_rays_classic_plain(ck, d, vdirs, c, copt),
                1, 0))
    n = 800 * 800
    # as K1's and the ray mode's bounds (phase 9), from the plain march's
    # statistics of the same frame: a shaded row costs 6 bd + 16 operations
    for key, tree, o, rng, ray_extra in (
            ("render_wide", dt, opt, (7, 1), None),
            ("render_classic_wide", dt, copt, (0, 0), None),
            ("render_rays_wide", dt, opt, (7, 1), 4 * opt.spp),
            ("render_classic_rays_wide", dt, copt, (0, 0), 0),
            ("render_classic_wide_chunked", ck, copt, (0, 0), None),
            ("render_classic_rays_wide_chunked", ck, copt, (0, 0), 0)):
        st = R.render_stats_plain(tree, tf, *rng, opt=o, **kw)
        shaded = (float(st.shaded.sum()) if st.shaded is not None
                  else st.data_rows)
        io = (80 * n + 48 if ray_extra is None else
              40 * n + (12 + ray_extra) * int((st.steps > 0).sum()))
        nbytes = (io + 8 * (st.lut_cells + st.chs_rows)
                  + 2 * tree.data_dim * st.data_rows)
        ops = (K1_OPS_PER_STEP * float(st.steps.sum())
               + (6 * tree.basis_dim + 16) * shaded)
        bounds[key] = bound(nbytes, ops) + (None,)
    for k in WIDE_KERNELS:
        log(f"[timing] {k}: kernel {ms[k][0]:.4f} ms, plain {ms[k][1]:.3f} "
            f"ms, bound {bounds[k][0]:.4f} ms ({bounds[k][1]}), library "
            f"{bounds[k][2]}")
    return ms, bounds


def wide_only():
    """--wide-only: build, phase 2's ptxas lines, the wide instances' holds
    and times (phase_wide); one {"wide_ms": ...} line."""
    from rt_octree_tpu_torch.native import build as native
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    t0 = time.time()
    native.build(verbose=True, force=True)
    log(f"[build] {time.time() - t0:.1f} s")
    phase_ptxas(native)
    err = {}
    ms, bounds = phase_wide(err)
    log(json.dumps({"wide_ms": {k: {"ms": ms[k][0], "plain_ms": ms[k][1],
                                    "bound_ms": bounds[k][0],
                                    "bound_by": bounds[k][1],
                                    "library_ms": bounds[k][2],
                                    "max_abs_err": err.get(k)}
                                for k in WIDE_KERNELS}}))
    log_wide_holds(err)
    return 0


def k7_chain_only():
    """--k7-chain-times [ROOT]: the card's name and power limit, the build
    of csrc/net.cu with ptxas's report of K7's wide instances (one
    {"ptxas_k7_wide": ...} line), and the per-block plan's nets of the
    package under ROOT launch by launch (k7_chain_times); one
    {"k7_chain": ...} line."""
    import re
    from rt_octree_tpu_torch.native import build as native
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    native.build(["net"], verbose=True, force=True)
    log(json.dumps({"ptxas_k7_wide": {
        re.sub(r".*?(guidance_wide\w*?_kernel)IL[ib](\d+)E.*", r"\1<\2>",
               name): v
        for name, v in ptxas_kernels(native.PTXAS.get("net", ""),
                                     "guidance_wide").items()}}))
    log(json.dumps({"k7_chain": k7_chain_times()}))
    return 0


def log_wide_holds(err):
    """One {"wide_holds": ...} line: K7's wide holds, K2 wide's, K5 wide's
    and K6 wide's errors, guard shares and statistics."""
    log(json.dumps({"wide_holds": {k: err.get(k) for k in (
        "k7", "k2_wide", "k5_wide", "k6_wide")}}))


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


def pair_times(other_root, pairs, ms):
    """The paired processes' times ``ms`` {side: {key: [ms a process]}}:
    each side's least value, quartiles and largest value, this side's less
    the other's within a pair, and the raw lists."""
    return {"pairs": pairs, "order": "other, this, this, other, ...",
            "roots": {"other": os.path.abspath(other_root), "this": HERE},
            "raw_ms": ms,
            **{side: {k: spread(v) for k, v in ms[side].items()}
               for side in ms},
            "this_less_other": {k: spread(np.subtract(ms["this"][k],
                                                      ms["other"][k]))
                                for k in ms["this"]}}


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
    import torch
    h = hashlib.sha256()
    for t in frame:
        if t is not None:
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
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
        **pair_times(other_root, pairs, ms),
        "bit_equal": {k: len(digests["this"][k] | digests["other"][k]) == 1
                      for k in digests["this"]},
        "digests": {side: {k: sorted(v) for k, v in d.items()}
                    for side, d in digests.items()}}}))
    return 0


PROBE_REPS = 20  # --probe-times: calls a median
PROBE_SMALL_REPS = 100  # --probe-times: calls a median of P1, P2, the floor
PROBE_ROUNDS = (0, 1, 16, 64)  # --probe-times: P5's other round counts


def affine_library(one, x):
    """P1's function as one PyTorch call, ``1 + 2x`` (``one`` a 0-d tensor
    of 1): doubling is exact, so it rounds as the plain version's
    ``x * 2 + 1``.  Timed beside G1; the port never calls it."""
    import torch
    return torch.add(one, x, alpha=2.0)


def probe_times(root):
    """--probe-times [ROOT]: the probes of the package under ROOT (default:
    beside this file) at the tools' shapes, each call alone by
    device_medians in turns.  First P1 and P2 in turns of their own (their
    inputs stay in the L2) with their library calls, torch.add(1, x,
    alpha=2) and torch.gather (its int64 index made outside the timed
    call), P2 on 8x the rows (the marginal time of its L2 sectors), and
    the launch floor, an empty kernel (torch.cuda._sleep(0)); each of
    those also less the floor.  Then P4 on gpu_probe's dma inputs
    beside F.embedding_bag's sum of the same rows, P5 in every config of
    microbench_gather's section b at its RING_ROUNDS, and its 512 B rows at
    n 8192 also at every nbuf and PROBE_ROUNDS (a call's fixed cost and the
    time of a round); P3 and P6 at two round counts; P4 from a cold L2 by
    cuda_ms.  One JSON line {"probe_ms": ...}."""
    import functools
    import hashlib
    import itertools
    import torch
    import torch.nn.functional as F
    from rt_octree_tpu_torch.native import build as native
    from rt_octree_tpu_torch.ops import probes as P
    from rt_octree_tpu_torch.tools import gpu_probe as gp
    from rt_octree_tpu_torch.tools import microbench_gather as mb
    from rt_octree_tpu_torch.utils.timer import l2_flusher
    native.build(["probes"])
    dev = torch.device("cuda", 0)
    x, one = gp.basic_input(dev), torch.ones((), device=dev)
    vtab, vidx = gp.vgather_inputs(dev)
    vidx64 = vidx.long()
    # P2 on 8x the rows: the marginal time of its L2 sectors
    vidx8 = torch.from_numpy(np.random.default_rng(1).integers(
        0, gp.VG_T, (8 * gp.VG_R, vtab.shape[1]), dtype=np.int32)).to(dev)
    small = {"floor": lambda: torch.cuda._sleep(0),
             "probe_affine": lambda: P.probe_affine(x),
             "affine torch.add": lambda: affine_library(one, x),
             "lane_gather": lambda: P.lane_gather(vtab, vidx),
             "gather torch.gather": lambda: torch.gather(vtab, 0, vidx64),
             "lane_gather 8x rows": lambda: P.lane_gather(vtab, vidx8)}
    p1_ref = P.probe_affine_plain(x)
    p1_p2_bit_equal = (
        torch.equal(small["probe_affine"](), p1_ref)
        and torch.equal(small["affine torch.add"](), p1_ref)
        and torch.equal(small["lane_gather"](),
                        P.lane_gather_plain(vtab, vidx))
        and torch.equal(small["gather torch.gather"](),
                        P.lane_gather_plain(vtab, vidx))
        and torch.equal(small["lane_gather 8x rows"](),
                        P.lane_gather_plain(vtab, vidx8)))
    small_ms = device_medians(small, PROBE_SMALL_REPS, 3)
    idx, tab = gp.dma_inputs(dev)
    idx64 = idx.long()
    offsets = torch.zeros(1, dtype=torch.long, device=dev)
    fns = {"row_sum_ring": lambda: P.row_sum_ring(idx, tab),
           "embedding_bag": lambda: F.embedding_bag(idx64, tab, offsets,
                                                    mode="sum")}
    p4 = P.row_sum_ring(idx, tab)
    res = {"root": root, "p4_rel_err": gp.dma_rel_err(p4, idx, tab),
           "p4_digest": hashlib.sha1(p4.cpu().numpy().tobytes()).hexdigest(),
           "p1_p2_bit_equal": p1_p2_bit_equal, "p5_bit_equal": True}
    for w, n, nbuf, table, ridx in list(mb.dma_configs(dev)):
        def run(table=table, ridx=ridx, nbuf=nbuf):
            return P.row_ring_rounds(ridx, table, nbuf, mb.RING_ROUNDS)
        res["p5_bit_equal"] &= torch.equal(run(), P.row_ring_rounds_plain(
            ridx, table, nbuf, mb.RING_ROUNDS))
        fns[f"row_ring_rounds {w * 4} B n {n} nbuf {nbuf}"] = run
        if (w, n, nbuf) == (128, 8192, 32):  # fixed cost, one round's
            for depth, rounds in itertools.product(P.RING_DEPTHS,
                                                   PROBE_ROUNDS):
                fns[f"row_ring_rounds {w * 4} B n {n} nbuf {depth} rounds "
                    f"{rounds}"] = functools.partial(
                        P.row_ring_rounds, ridx, table, depth, rounds)
    # P3 at gpu_probe's shape, P6 in every config of section c, each at
    # two round counts (the marginal per round), the short counts first so
    # that no call finds its table left in the L2 by the same config's
    # other count; bit-equal holds
    res["p3_p6_bit_equal"] = True
    chains = {}
    ctab, cidx = gp.vgather_loop_inputs(dev)
    flat = list(mb.vmem_configs(dev))
    for p3_rounds, p6_rounds in ((gp.VL_K, mb.CHAIN_ROUNDS),
                                 (gp.VL_K_LONG, mb.CHAIN_ROUNDS_LONG)):
        chains[f"lane_gather_chain {p3_rounds} rounds"] = (
            functools.partial(P.lane_gather_chain, ctab, cidx, p3_rounds),
            functools.partial(P.lane_gather_chain_plain, ctab, cidx,
                              p3_rounds))
        for S, n, table, fidx in flat:
            chains[f"flat_gather_chain S {S} n {n} rounds {p6_rounds}"] = (
                functools.partial(P.flat_gather_chain, fidx, table,
                                  p6_rounds),
                functools.partial(P.flat_gather_chain_plain, fidx, table,
                                  p6_rounds))
    for k, (kernel, plain) in chains.items():
        res["p3_p6_bit_equal"] &= torch.equal(kernel(), plain())
        fns[k] = kernel
    res["ms"] = {**small_ms, **device_medians(fns, PROBE_REPS, 3)}
    res["over_floor_ms"] = {k: v - small_ms["floor"]
                            for k, v in small_ms.items() if k != "floor"}
    res["ms"]["row_sum_ring cold"] = cuda_ms(fns["row_sum_ring"], 5, 1,
                                             flush=l2_flusher(dev))
    res["marginal_ns"] = probe_marginals(res["ms"])
    log(json.dumps({"probe_ms": res}))
    return 0


def probe_marginals(ms):
    """The time of one more round (ns) of P3 and of P6 in each config: the
    difference of two round counts' medians over their difference."""
    from rt_octree_tpu_torch.tools import gpu_probe as gp
    from rt_octree_tpu_torch.tools import microbench_gather as mb
    out = {"lane_gather_chain": (
        ms[f"lane_gather_chain {gp.VL_K_LONG} rounds"]
        - ms[f"lane_gather_chain {gp.VL_K} rounds"])
        / (gp.VL_K_LONG - gp.VL_K) * 1e6}
    for S, n in mb.VMEM_CONFIGS + mb.PAST_L2_CONFIGS:
        key = f"flat_gather_chain S {S} n {n} rounds"
        out[f"flat_gather_chain S {S} n {n}"] = (
            ms[f"{key} {mb.CHAIN_ROUNDS_LONG}"]
            - ms[f"{key} {mb.CHAIN_ROUNDS}"]) / (
            mb.CHAIN_ROUNDS_LONG - mb.CHAIN_ROUNDS) * 1e6
    return out


def probe_pairs(other_root, pairs):
    """--probe-pairs: ``pairs`` pairs of --probe-times processes, this
    script on OTHER_ROOT's package and on its own in turns; each side's
    times (least, quartiles, largest), this side's less the other's within
    a pair, P1's and P2's times less the floor, the marginal rounds, P4's
    relative errors and the holds.  One JSON line {"probe_pairs": ...}."""
    ms, holds = {"other": {}, "this": {}}, {"other": [], "this": []}
    marginal = {"other": {}, "this": {}}
    over_floor = {"other": {}, "this": {}}
    for i, side, lines in alternate(other_root, pairs, ["--probe-times"],
                                    "probe_pairs", own_script=True):
        got = [ln["probe_ms"] for ln in lines if "probe_ms" in ln]
        require(len(got) == 1, f"{side} probe process {i}: unexpected "
                "output")
        for k, v in got[0]["ms"].items():
            ms[side].setdefault(k, []).append(v)
        for k, v in got[0]["marginal_ns"].items():
            marginal[side].setdefault(k, []).append(v)
        for k, v in got[0]["over_floor_ms"].items():
            over_floor[side].setdefault(k, []).append(v)
        holds[side].append({k: got[0][k] for k in
                            ("p4_rel_err", "p4_digest", "p1_p2_bit_equal",
                             "p5_bit_equal", "p3_p6_bit_equal")})
    require(all(h["p1_p2_bit_equal"] and h["p5_bit_equal"]
                and h["p3_p6_bit_equal"] for v in holds.values() for h in v),
            "a P1, P2, P3, P5 or P6 result (or a library call's) differs "
            "from its plain version")
    log(json.dumps({"probe_pairs": {
        **pair_times(other_root, pairs, ms),
        "over_floor_ms": {side: {k: spread(v) for k, v in d.items()}
                          for side, d in over_floor.items()},
        "marginal_ns": {side: {k: spread(v) for k, v in d.items()}
                        for side, d in marginal.items()},
        "holds": holds}}))
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
    gates["classic"] = phase_quality(rc, ps.poses, "classic", GATE_CLASSIC)
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


def headline_ray_batch(dt, pose, fx, fy):
    """The headline frame's rays at ``pose`` as a ray batch on the tree's
    device: the plain device_camera_rays, rodrigues and maybe_world2ndc,
    and K1's own PCG32 uniforms of that frame at the quality protocol's
    state (20230418, 1).  Returns (dirs, vdirs, cens, uniforms, K1's
    frame (img, aux_nhwc, aux_chw), transform, (state, inc))."""
    import torch
    from rt_octree_tpu_torch.render import renderer as R
    from rt_octree_tpu_torch.utils.rng import Pcg32
    rng = Pcg32(20230418, 1)
    opt = headline_options()
    tf = torch.from_numpy(np.ascontiguousarray(
        np.asarray(pose, np.float32)[:3, :4])).to(dt.device)
    u = torch.empty((MD_SIZE * MD_SIZE, opt.spp), device=dt.device)
    frame = R.render_noisy(dt, tf, rng.state, rng.inc, width=MD_SIZE,
                           height=MD_SIZE, fx=fx, fy=fy, opt=opt,
                           uniforms_out=u)
    dirs, cens = R.device_camera_rays(tf, MD_SIZE, MD_SIZE, fx, fy)
    vdirs = R.rodrigues(opt.rot_dirs, dirs)
    wd, wc = R.maybe_world2ndc(dt, dirs, cens)
    return (wd.contiguous(), vdirs.contiguous(), wc.contiguous(), u, frame,
            tf, (rng.state, rng.inc))


def phase_rays_headline(r, ps, err, card):
    """The ray mode on the headline tree (see the module docstring's phase
    9): RAY_AIMED aimed rays at every SPP of the kernel with and without
    world depths vs the plain version; the headline frame's own rays and
    thresholds with the counts set to 0 just before and read just after
    (render_rays and render_classic_rays once each), composited against
    K1's and render_classic's frames; a seeded permutation of the same
    rays (both modes); the times, plain times and bounds.  Prints
    {"rays": ...} and returns (ms, bounds, launches) of the two ray
    kernels."""
    import torch
    from rt_octree_tpu_torch.native import build as native
    from rt_octree_tpu_torch.render import renderer as R
    from rt_octree_tpu_torch.utils.rng import make_sorted_dst
    dt = r.tree
    tm = ray_tmax(dt, RAY_AIMED, 40)
    for spp in R.SPP_KERNEL:
        rays = aimed_rays(dt, RAY_AIMED, spp, 40 + spp)
        opt = headline_options()
        opt.spp = spp
        for kw in ({}, {"tmax_bg": tm}):
            hold_rays(f"headline tree, {RAY_AIMED} aimed rays, spp {spp}"
                      + (", world depths" if kw else ""), dt, rays, opt,
                      err, **kw)
    n = MD_SIZE * MD_SIZE
    d, v, c, u, frame, tf, rng = headline_ray_batch(dt, ps.poses[0], r.fx,
                                                    r.fy)
    dst = make_sorted_dst(u)
    opt, copt = headline_options(), classic_options("cli")
    kw = dict(width=MD_SIZE, height=MD_SIZE, fx=r.fx, fy=r.fy)
    native.reset_launches()
    out = R.trace_rays(dt, d, v, c, dst, opt)
    out_c = R.trace_rays_classic(dt, d, v, c, copt)
    torch.cuda.synchronize()
    launches = {k: native.LAUNCHES[k] for k in RAY_KERNELS}
    log(f"[rays] the headline frame's {n} rays: launches {launches}")
    require(launches == {k: 1 for k in RAY_KERNELS},
            f"the ray path launched {launches}")
    res = {"card": card, "rays": n, "launches": launches, "vs_frame": {}}
    frame_c = R.render_noisy(dt, tf, 0, 0, opt=copt, **kw)[0]
    for key, o, img in (("render_rays", out, frame[0]),
                        ("render_classic_rays", out_c, frame_c)):
        comp = R.composite(o, MD_SIZE, MD_SIZE,
                           float(opt.background_brightness))[0]
        diff = (comp - img).abs()
        e = float(diff.max())
        share = float((diff > 0).any(-1).float().mean())
        res["vs_frame"][key] = {"max_abs_err": e, "share_unequal": share}
        log(f"[rays] {key} on the headline's rays, composited, vs the "
            f"frame's img: max|diff| {e:.3g}, share of pixels unequal "
            f"{share:.4f}")
        require(e <= K1_IMG_TOL, f"{key}: the ray mode is not the frame")
        err[key] = max(err.get(key, 0.0), e)
    gen = torch.Generator().manual_seed(RAY_PERM_SEED)
    perm = torch.randperm(n, generator=gen).cuda()
    pd, pv, pc, pdst = (t[perm].contiguous() for t in (d, v, c, dst))
    same = bool(torch.equal(R.trace_rays(dt, pd, pv, pc, pdst, opt),
                            out[perm])) and bool(torch.equal(
        R.trace_rays_classic(dt, pd, pv, pc, copt), out_c[perm]))
    log(f"[rays] the permuted rays' results are the row order's, "
        f"permuted: {same}")
    require(same, "a ray's result depends on its place in the batch")
    st, inc = rng
    ms = device_medians({
        "rays_row": lambda: R.trace_rays(dt, d, v, c, dst, opt),
        "rays_perm": lambda: R.trace_rays(dt, pd, pv, pc, pdst, opt),
        "frame": lambda: R.render_noisy(dt, tf, st, inc, opt=opt, **kw),
        "classic_rays_row": lambda: R.trace_rays_classic(dt, d, v, c, copt),
        "classic_rays_perm": lambda: R.trace_rays_classic(dt, pd, pv, pc,
                                                          copt),
        "classic_frame": lambda: R.render_noisy(dt, tf, 0, 0, opt=copt,
                                                **kw)}, RAY_REPS, RAY_WARMUP)
    plain = {"render_rays": cuda_ms(
        lambda: R.trace_rays_plain(dt, d, v, c, dst, opt), 1, 0),
        "render_classic_rays": cuda_ms(
        lambda: R.trace_rays_classic_plain(dt, d, v, c, copt), 1, 0)}
    # the frame's reads (each LUT cell and chs row once at 8 B, each shaded
    # f16 row once) and operations, from the statistics of the same rays;
    # the ray mode reads dirs and cens (24 B) and writes [R, 4] (16 B) for
    # every ray, and the vdir (12 B) and the thresholds (4 B each; the
    # classic mode none) only for a ray that takes a step: a ray that
    # misses the tree's box is 0 from its dir and cen alone
    bounds, sbytes = {}, {}
    for key, o, extra in (("render_rays", opt, 4 * opt.spp),
                          ("render_classic_rays", copt, 0)):
        sta = R.render_stats(dt, tf, st, inc, opt=o, **kw)
        shaded = (float(sta.shaded.sum()) if sta.shaded is not None
                  else sta.data_rows)
        stepping = int((sta.steps > 0).sum())
        nbytes = (40 * n + (12 + extra) * stepping
                  + 8 * (sta.lut_cells + sta.chs_rows)
                  + 2 * dt.data_dim * sta.data_rows)
        ops = (K1_OPS_PER_STEP * float(sta.steps.sum())
               + (6 * max(dt.basis_dim, 0) + 16) * shaded)
        bounds[key] = bound(nbytes, ops) + (None,)
        sbytes[key] = nbytes
    res.update({"ms": ms, "plain_ms": plain,
                "bound_ms": {k: b[0] for k, b in bounds.items()},
                "bound_by": {k: b[1] for k, b in bounds.items()},
                "bound_bytes": sbytes, "perm_seed": RAY_PERM_SEED,
                "timing": f"median of {RAY_REPS} calls each after "
                          f"{RAY_WARMUP} rounds, in turns, CUDA events, "
                          "host queuing hidden behind a sleep kernel"})
    log(json.dumps({"rays": res}))
    return ({"render_rays": (ms["rays_row"], plain["render_rays"]),
             "render_classic_rays": (ms["classic_rays_row"],
                                     plain["render_classic_rays"])},
            bounds, launches)


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


def k56_bounds(B, L, H, W, sup, guard=(0.0, 0.0)):
    """K5's and K6's bounds (bound ms, "bytes" or "operations", library
    ms None) at [B, L, H, W] with supports ``sup``; ``guard``: the shares
    of K5's and K6's (tile, level) pairs that took the guard on this
    run's data.  Bytes: K5 reads weight and guidance (8 B a pixel and
    level) and rgba (16 B), writes out (16 B) and fm, den (20 B a pixel
    and level); K6 reads G and rgba (32 B) and weight, guidance, fm, den
    (28 B a pixel and level), writes two gradients (8 B).  Operations, a
    pixel and level of support s > 0, in the separable form the kernels
    take: K5 an expf and its subtraction, e rgb (3), the row and column
    sums of (e rgb, e) (16 s adds) and the division by the denominator
    (3), 16 s + 8; K6 E_p = exp(c' - m_p) (2), u_p = (w_p / D_p) G_p (4),
    v_p = u_p . f_p (3), E u and E v (4), their row and column sums
    (16 s) and dL/dg_q = exp(g_q - c') (x_q . U_q - V_q) (7), 16 s + 20.
    A guarded pair takes the per-window form, a window tap 9 operations
    in K5 (a subtraction, an expf, an add, three multiply-adds) and 12 in
    K6 (a subtraction, an expf, three multiply-adds for u.x, a subtraction
    and a multiply-add); the guard's share is spread evenly over the
    levels.  Every level adds its blend, 6 (K5), and its staged pixel, 12
    (K6)."""
    n, nl = B * H * W, B * L * H * W
    pos = [s for s in sup if s > 0]
    taps = sum((2 * s + 1) ** 2 for s in pos)
    sep5, sep6 = sum(16 * s + 8 for s in pos), sum(16 * s + 20 for s in pos)
    ops5 = (1 - guard[0]) * sep5 + guard[0] * 9 * taps + 6 * L
    ops6 = (1 - guard[1]) * sep6 + guard[1] * 12 * taps + 12 * L
    return {
        "guided_filter_batch": bound(n * 32 + nl * 28, n * ops5) + (None,),
        "guided_filter_batch_bwd": bound(n * 32 + nl * 36, n * ops6)
        + (None,)}


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
        **pair_times(other_root, pairs, ms),
        "other_over_this": {k: float(np.median(ms["other"][k]) /
                                     np.median(ms["this"][k]))
                            for k in ms["this"]},
        "digests": {side: sorted(d) for side, d in digests.items()},
        "step_ops": step_ops_diff(last),
        "last": last}}))
    return 0


WIDE_PAIRS_FRAME_TOL = 2e-5  # the two packages' wide frames (K2's bar x 2)


def wide_frame_path(root):
    """Where --wide-times saves the wide frame of the package under
    ``root``: this checkout's or the other one's."""
    side = "this" if os.path.abspath(root) == HERE else "other"
    return os.path.join(WORK, f"wide_frame_{side}.npy")


def wide_outputs_path(root):
    """Where --wide-times saves the classic wide frame and rays and K5
    wide's outputs of the package under ``root``."""
    side = "this" if os.path.abspath(root) == HERE else "other"
    return os.path.join(WORK, f"wide_outputs_{side}.npz")


def tile_order(width, height, tw, th):
    """The pixel indices (row major) of a width x height frame in the
    order of tw x th tiles, the tiles in row order and the pixels of a
    tile in row order: a CUDA long tensor; width and height multiples of
    the tile."""
    import torch
    y, x = np.divmod(np.arange(width * height), width)
    key = ((y // th) * (width // tw) + x // tw) * (tw * th) + \
        (y % th) * tw + x % tw
    return torch.from_numpy(np.argsort(key)).cuda()


def wide_times(root):
    """--wide-times [ROOT]: the wide path's K7 and K2 of the package under
    ROOT (default: beside this file) alone, by device_ms: K7 on the
    8 -> 96 -> 24 net (WIDE_K7_NETS' first, seeded as phase_wide) on
    random aux at 800x800, K2 wide on that net's activation (channels last,
    ladder 1..12) with seeded rgb, and whether K7's activation equals the
    net run one block a launch (chain_block) bit for bit; then the
    headline tree's 800x800 frame (pose r_0, SPP 6, PCG32 seeded 20230418,
    1) denoised by that net, by cuda_ms, saved for --wide-pairs; then
    render_classic's wide instance on the SG32 depth-8 shell at 800x800
    (phase_wide's camera), the frame and its 640,000 rays in ray mode (in
    row order, and in the order of the frame's 8x4 warp tiles: equal
    outputs, both timed), K5's and K6's wide instances on seeded inputs
    at the L = 12 train batch (WIDE_K56_CASES' first), by device_ms,
    their outputs saved for --wide-pairs with their digests, the chunked
    instance's frame and rays on WIDE_CHUNKED_TREE, timed, and the
    classic frames and rays of WIDE_PAIRS_TREES, saved too.  One JSON
    line {"wide_times": ...}."""
    import torch
    from rt_octree_tpu_torch.io import n3tree
    from rt_octree_tpu_torch.io.poses import load_poses
    from rt_octree_tpu_torch.models.guidance_net import (GuidanceNetConfig,
                                                         build_compact)
    from rt_octree_tpu_torch.native import build as native
    from rt_octree_tpu_torch.ops import filtering as Fm
    from rt_octree_tpu_torch.ops.guidance import chain_block
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.render.renderer import Renderer
    native.build()
    res = {"root": root, "package": os.path.dirname(os.path.dirname(
        os.path.abspath(Fm.__file__)))}
    cfg = GuidanceNetConfig(**WIDE_K7_NETS[0])
    params = wide_net_params(cfg, np.random.default_rng(41))
    net = build_compact(cfg, params, "cuda")
    aux = k7_aux(800, 800)
    sup = cfg.supports()
    img = torch.from_numpy(np.random.default_rng(7).random(
        (800, 800, 4), np.float32)).cuda()
    with torch.no_grad():
        act = net.activation(aux)
        res["k7_ms"] = device_ms(lambda: net.activation(aux), 50, 5)
        x = aux  # the net one block a launch
        for i, layer in enumerate(net.packed):
            x = chain_block(x, layer, layer.cout if i == len(net.packed) - 1
                            else layer.nt * 8)
    res["k7_equals_chain"] = bool(torch.equal(act.permute(0, 2, 3, 1), x))
    res["k7_chain"] = k7_chain_times()
    res["k2_ms"] = device_ms(lambda: Fm.guided_filter(act, img, sup), 50, 5)
    tree_path = os.path.join(WORK, "shell_d9_sh9.npz")
    if not os.path.isfile(tree_path):
        headline_tree_path()
    dt = upload_tree(n3tree.load(tree_path), lut_levels=9, device="cuda")
    ps = load_poses("blender", os.path.join(KIT, "transforms_test.json"),
                    800, 800)
    r = Renderer(dt, 800, 800, ps.fx, ps.fy, options=headline_options())
    r.set_denoiser(cfg, params)
    pose = ps.poses[0]
    r.rng.seed(20230418, 1)
    frame = r.render(pose, want_aux=False)[0]
    require(bool(torch.isfinite(frame).all()), "the wide frame is not finite")
    np.save(wide_frame_path(root), frame.cpu().numpy())
    res["digest"] = frame_digest((frame,))
    res["frame_ms"] = cuda_ms(lambda: r.render(pose, want_aux=False), 20, 3)
    del r, dt
    from rt_octree_tpu_torch.core.camera import Camera
    from rt_octree_tpu_torch.core.options import RenderOptions
    from rt_octree_tpu_torch.render import renderer as R
    sg = load_wide_tree("SG32", "SG", 32, WIDE_TREE_DEPTH)
    cam = Camera(width=800, height=800, fx=1111.0, fy=1111.0)
    tf = torch.from_numpy(cam.transform.astype(np.float32)).cuda()
    kw = dict(width=800, height=800, fx=cam.fx, fy=cam.fy)
    copt = RenderOptions(spp=1, denoise=False, estimator="classic")
    classic = R.render_noisy(sg, tf, 0, 0, opt=copt, **kw)[:2]
    dirs, cens = R.device_camera_rays(tf, 800, 800, cam.fx, cam.fy)
    vdirs = R.rodrigues(copt.rot_dirs, dirs)
    d, c = (t.contiguous() for t in R.maybe_world2ndc(sg, dirs, cens))
    rays = R.trace_rays_classic(sg, d, vdirs, c, copt)
    res["classic_ms"] = device_ms(
        lambda: R.render_noisy(sg, tf, 0, 0, opt=copt, **kw), 20, 3)
    res["classic_rays_ms"] = device_ms(
        lambda: R.trace_rays_classic(sg, d, vdirs, c, copt), 20, 3)
    # the same rays in the frame's warp order (a warp an 8x4 pixel tile,
    # csrc/render.cu:kTileW x kTileH), their outputs equal to row order's
    tile = tile_order(800, 800, 8, 4)
    dt_, ct_, vt_ = (t.reshape(-1, t.shape[-1])[tile].contiguous()
                     for t in (d, c, vdirs))
    rays_t = torch.empty_like(rays)
    rays_t[tile] = R.trace_rays_classic(sg, dt_, vt_, ct_, copt)
    require(bool(torch.equal(rays_t, rays)), "render_classic wide's rays "
            "in tile order are not those in row order")
    res["classic_rays_tiled_ms"] = device_ms(
        lambda: R.trace_rays_classic(sg, dt_, vt_, ct_, copt), 20, 3)
    _, B, sup5, H, W = WIDE_K56_CASES[0]
    w, g, x, _ = filter_batch_inputs(np.random.default_rng(43), B, len(sup5),
                                     H, W)
    k5 = Fm.guided_filter_batch_fwd(w, g, x, sup5)
    k5 = (k5[0],) + tuple(k5[1])  # out, fm, den
    res["k5_ms"] = device_ms(lambda: Fm.guided_filter_batch_fwd(w, g, x,
                                                                sup5), 50, 5)
    G = torch.from_numpy(np.random.default_rng(44).standard_normal(
        (B, H, W, 4)).astype(np.float32)).cuda()
    k6 = Fm.guided_filter_batch_bwd(G, w, g, x, k5[1:], sup5)
    res["k6_ms"] = device_ms(lambda: Fm.guided_filter_batch_bwd(
        G, w, g, x, k5[1:], sup5), 50, 5)
    res["classic_digest"] = frame_digest(classic + (rays,))
    res["k5_digest"] = frame_digest(k5)
    res["k6_digest"] = frame_digest(k6)
    outs = {"classic_SG32_img": classic[0], "classic_SG32_aux": classic[1],
            "classic_SG32_rays": rays,
            **{f"k5_{k}": t for k, t in zip(("out", "fm", "den"), k5)},
            **{f"k6_{k}": t for k, t in zip(("dw", "dg"), k6)}}
    # the chunked instance on the wide path's tree, timed, and the other
    # wide row layouts' classic frames and rays, for the pairs'
    # bit-equality
    del sg
    ck = load_wide_tree(*WIDE_CHUNKED_TREE)
    res["classic_chunked_ms"] = device_ms(
        lambda: R.render_noisy(ck, tf, 0, 0, opt=copt, **kw), 20, 3)
    res["classic_chunked_rays_ms"] = device_ms(
        lambda: R.trace_rays_classic(ck, d, vdirs, c, copt), 20, 3)
    del ck
    for label, fmt, bd, depth in WIDE_PAIRS_TREES:
        tree = load_wide_tree(label, fmt, bd, depth)
        outs[f"classic_{label}_img"], outs[f"classic_{label}_aux"] = \
            R.render_noisy(tree, tf, 0, 0, opt=copt, **kw)[:2]
        outs[f"classic_{label}_rays"] = R.trace_rays_classic(
            tree, d, vdirs, c, copt)
    np.savez(wide_outputs_path(root),
             **{k: t.cpu().numpy() for k, t in outs.items()})
    log(json.dumps({"wide_times": res}))
    return 0


def wide_pairs(other_root, pairs):
    """--wide-pairs: ``pairs`` pairs of --wide-times processes, this
    script on OTHER_ROOT's package and on its own in turns; each side's
    times (least, quartiles, largest), this side's less the other's within
    a pair, each side's frame digests and the largest |difference| between
    the two sides' frames (at most WIDE_PAIRS_FRAME_TOL), render_classic
    wide's frames and rays (bit-equal) and K5 wide's out, fm and den (at
    most K5_TOL).  One JSON line {"wide_pairs": ...}."""
    if not os.path.isfile(os.path.join(WORK, "shell_d9_sh9.npz")):
        headline_tree_path()
    wide_tree_path("SG32", "SG", 32, WIDE_TREE_DEPTH)
    for label, fmt, bd, depth in WIDE_PAIRS_TREES:
        wide_tree_path(label, fmt, bd, depth)
    keys = ("k7_ms", "k2_ms", "frame_ms", "classic_ms", "classic_rays_ms",
            "classic_rays_tiled_ms", "classic_chunked_ms",
            "classic_chunked_rays_ms", "k5_ms", "k6_ms")
    ms = {side: {k: [] for k in keys} for side in ("other", "this")}
    digests = {side: set() for side in ms}
    chain_digests = {side: set() for side in ms}
    for i, side, lines in alternate(other_root, pairs, ["--wide-times"],
                                    "wide_pairs", own_script=True):
        got = [ln["wide_times"] for ln in lines if "wide_times" in ln]
        require(len(got) == 1, f"{side} wide process {i}: unexpected output")
        for k, v in k7_chain_ms(got[0]["k7_chain"]).items():
            got[0][k] = v
            ms[side].setdefault(k, [])
        for k in ms[side]:
            ms[side][k].append(got[0][k])
        digests[side].add(tuple(got[0][k] for k in ("digest",
                                                    "classic_digest",
                                                    "k5_digest",
                                                    "k6_digest")))
        chain_digests[side].add(tuple(
            (label, sp["digest"], *(r["digest"] for r in sp["launches"]))
            for label, sp in sorted(got[0]["k7_chain"].items())))
    frames = {side: np.load(wide_frame_path(root)) for side, root in
              (("this", HERE), ("other", other_root))}
    diff = float(np.abs(frames["this"] - frames["other"]).max())
    outs = {side: np.load(wide_outputs_path(root)) for side, root in
            (("this", HERE), ("other", other_root))}
    diffs = {k: float(np.abs(outs["this"][k] - outs["other"][k]).max())
             for k in outs["this"].files}
    log(json.dumps({"wide_pairs": {
        **pair_times(other_root, pairs, ms),
        "digests": {side: sorted(d) for side, d in digests.items()},
        "k7_chain_digests": {side: sorted(d) for side, d in
                             chain_digests.items()},
        "frame_max_abs_diff": diff, "outputs_max_abs_diff": diffs}}))
    require(len(chain_digests["this"]) == 1 and
            chain_digests["this"] == chain_digests["other"],
            "K7's per-block plan is not the other package's bit for bit "
            f"(launch by launch): {chain_digests}")
    require(diff <= WIDE_PAIRS_FRAME_TOL, f"the two packages' wide frames "
            f"differ by {diff:.3g}")
    require(all(diffs[k] == 0 for k in diffs if k.startswith("classic")),
            f"render_classic's wide outputs are not the other package's bit "
            f"for bit: {diffs}")
    require(all(diffs[k] <= K5_TOL for k in diffs if k.startswith("k5")),
            f"K5 wide's outputs differ from the other package's: {diffs}")
    require(all(diffs[k] <= K6_REL_TOL * float(np.abs(
        outs["other"][k]).max()) for k in diffs if k.startswith("k6")),
            f"K6 wide's gradients differ from the other package's: {diffs}")
    return 0


def k7_chain_ms(chains):
    """--wide-times' k7_chain results -> flat {key: ms} of each net's
    chain, its launches and cuDNN's chain, for pair_times."""
    out = {}
    for label, sp in chains.items():
        out[f"k7_chain {label}"] = sp["chain_ms"]
        out[f"k7_chain {label} cudnn"] = sp["cudnn_chain_ms"]
        for r in sp["launches"]:
            out[f"k7_chain {label} block {r['block']}"] = r["ms"]
    return out


# --wide-times' other classic trees, held bit for bit by --wide-pairs:
# (label, format, basis_dim, shell depth); the chunked instance's SG96,
# ASG96 and SG232, whose basis passes the shared prefix of 216
WIDE_PAIRS_TREES = (("ASG32", "ASG", 32, 7), ("SG48", "SG", 48, 7),
                    ("ASG48", "ASG", 48, 7), ("SG96", "SG", 96, 7),
                    ("ASG96", "ASG", 96, 7), ("SG232", "SG", 232, 6))
# --wide-sweep's trees: (label, format, basis_dim), depth-7 shells
WIDE_SWEEP = (("SG32", "SG", 32), ("SG40", "SG", 40), ("SG48", "SG", 48),
              ("SG64", "SG", 64), ("SG72", "SG", 72), ("SG80", "SG", 80),
              ("SG88", "SG", 88), ("SG96", "SG", 96), ("SG128", "SG", 128),
              ("SG160", "SG", 160), ("SG192", "SG", 192),
              ("SG232", "SG", 232))


def wide_sweep(root):
    """--wide-sweep [ROOT]: render_classic's classic frame at 800x800
    (phase_wide's camera) on a depth-7 shell of each WIDE_SWEEP row
    layout, by device_ms, with the launch name of the instance it took
    and the frame's digest; and K1's frame there (render_wide, SPP 6),
    its ms and digest.  One JSON line {"wide_sweep": ...}."""
    import torch
    from rt_octree_tpu_torch.core.camera import Camera
    from rt_octree_tpu_torch.core.options import RenderOptions
    from rt_octree_tpu_torch.native import build as native
    from rt_octree_tpu_torch.render import renderer as R
    native.build()
    cam = Camera(width=800, height=800, fx=1111.0, fy=1111.0)
    tf = torch.from_numpy(cam.transform.astype(np.float32)).cuda()
    kw = dict(width=800, height=800, fx=cam.fx, fy=cam.fy)
    copt = RenderOptions(spp=1, denoise=False, estimator="classic")
    o6 = RenderOptions(spp=6, denoise=False)
    res = {"root": root}
    for label, fmt, bd in WIDE_SWEEP:
        dt = load_wide_tree(label, fmt, bd, 7)
        native.reset_launches()
        frame = R.render_noisy(dt, tf, 0, 0, opt=copt, **kw)[:2]
        torch.cuda.synchronize()
        res[label] = {
            "instance": [k for k, n in native.LAUNCHES.items() if n],
            "digest": frame_digest(frame),
            "ms": device_ms(lambda: R.render_noisy(dt, tf, 0, 0, opt=copt,
                                                   **kw), 20, 3),
            "k1_digest": frame_digest(R.render_noisy(dt, tf, 7, 1, opt=o6,
                                                     **kw)[:2]),
            "k1_ms": device_ms(lambda: R.render_noisy(dt, tf, 7, 1, opt=o6,
                                                      **kw), 20, 3)}
        del dt
    log(json.dumps({"wide_sweep": res}))
    return 0


def ray_outputs_path(root):
    """Where --ray-times saves the ray modes' and render_wide's outputs of
    the package under ``root``: this checkout's or the other one's."""
    side = "this" if os.path.abspath(root) == HERE else "other"
    return os.path.join(WORK, f"ray_outputs_{side}.npz")


def ray_times(root):
    """--ray-times [ROOT]: the ray modes of the package under ROOT
    (default: beside this file) alone, by device_medians (RAY_REPS calls
    each in turns after RAY_WARMUP rounds), each call the whole
    trace_rays / trace_rays_classic: the headline frame's 640,000 rays
    (pose r_0, K1's own thresholds) in row order and in the RAY_PERM_SEED
    permutation through render_rays and render_classic_rays; the SG32
    depth-8 shell's render_wide frame (phase_wide's camera, SPP 6) and its
    rays through render_rays_wide and render_classic_rays_wide;
    WIDE_CHUNKED_TREE's rays through render_classic_rays_wide_chunked (both
    orders); and the render_wide frame and render_rays_wide on each tree of
    WIDE_K1_TREES.  Each permuted output must be its row order's,
    permuted; the outputs are saved for --ray-pairs with their digests.
    One JSON line {"ray_times": ...}."""
    import torch
    from rt_octree_tpu_torch.core.camera import Camera
    from rt_octree_tpu_torch.core.options import RenderOptions
    from rt_octree_tpu_torch.io import n3tree
    from rt_octree_tpu_torch.io.poses import load_poses
    from rt_octree_tpu_torch.native import build as native
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.render import renderer as R
    from rt_octree_tpu_torch.utils.rng import make_sorted_dst
    native.build()
    res = {"root": root, "package": os.path.dirname(os.path.dirname(
        os.path.abspath(R.__file__))), "card": torch.cuda.get_device_name(0)}
    tree_path = os.path.join(WORK, "shell_d9_sh9.npz")
    if not os.path.isfile(tree_path):
        headline_tree_path()
    dt = upload_tree(n3tree.load(tree_path), lut_levels=9, device="cuda")
    ps = load_poses("blender", os.path.join(KIT, "transforms_test.json"),
                    800, 800)
    d, v, c, u = headline_ray_batch(dt, ps.poses[0], ps.fx, ps.fy)[:4]
    n = d.shape[0]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(
        RAY_PERM_SEED)).cuda()

    def permuted(*ts):
        return tuple(t[perm].contiguous() for t in ts)
    opt, copt = headline_options(), classic_options("cli")
    dst = make_sorted_dst(u)
    fns = {"rays_row": lambda: R.trace_rays(dt, d, v, c, dst, opt),
           "rays_perm": lambda: R.trace_rays(dt, *permuted(d, v, c, dst),
                                             opt),
           "classic_rays_row": lambda: R.trace_rays_classic(dt, d, v, c,
                                                            copt),
           "classic_rays_perm": lambda: R.trace_rays_classic(
               dt, *permuted(d, v, c), copt)}
    outs = {}

    def run(fns):
        # the outputs, each permuted one held to its row order's, then
        # the times with the inputs permuted beforehand
        for k, fn in fns.items():
            outs[k] = fn()
        for k in fns:
            if k.endswith("_perm"):
                require(torch.equal(outs[k], outs[k[:-5] + "_row"][perm]),
                        f"{k}: not the row order's outputs, permuted")
        return fns
    run(fns)
    pd, pv, pc, pdst = permuted(d, v, c, dst)
    ms = device_medians({
        "rays_row": fns["rays_row"],
        "rays_perm": lambda: R.trace_rays(dt, pd, pv, pc, pdst, opt),
        "classic_rays_row": fns["classic_rays_row"],
        "classic_rays_perm": lambda: R.trace_rays_classic(dt, pd, pv, pc,
                                                          copt)},
        RAY_REPS, RAY_WARMUP)
    del dt
    sg = load_wide_tree("SG32", "SG", 32, WIDE_TREE_DEPTH)
    cam = Camera(width=800, height=800, fx=1111.0, fy=1111.0)
    tf = torch.from_numpy(cam.transform.astype(np.float32)).cuda()
    kw = dict(width=800, height=800, fx=cam.fx, fy=cam.fy)
    o6 = RenderOptions(spp=6, denoise=False)
    wopt = RenderOptions(spp=1, denoise=False, estimator="classic")
    dirs, cens = R.device_camera_rays(tf, 800, 800, cam.fx, cam.fy)
    wv = R.rodrigues(o6.rot_dirs, dirs).contiguous()
    wd, wc = (t.contiguous() for t in R.maybe_world2ndc(sg, dirs, cens))
    wu = torch.empty((n, 6), dtype=torch.float32, device="cuda")
    R.render_noisy(sg, tf, 7, 1, opt=o6, uniforms_out=wu, **kw)
    wdst = make_sorted_dst(wu)
    outs["render_wide_img"], outs["render_wide_aux"] = R.render_noisy(
        sg, tf, 7, 1, opt=o6, **kw)[:2]
    pwd, pwv, pwc, pwdst = permuted(wd, wv, wc, wdst)
    wide = run({
        "rays_wide_row": lambda: R.trace_rays(sg, wd, wv, wc, wdst, o6),
        "rays_wide_perm": lambda: R.trace_rays(sg, pwd, pwv, pwc, pwdst,
                                               o6),
        "classic_rays_wide_row": lambda: R.trace_rays_classic(
            sg, wd, wv, wc, wopt),
        "classic_rays_wide_perm": lambda: R.trace_rays_classic(
            sg, pwd, pwv, pwc, wopt)})
    ms.update(device_medians({
        "render_wide": lambda: R.render_noisy(sg, tf, 7, 1, opt=o6, **kw),
        **wide}, RAY_REPS, RAY_WARMUP))
    del sg
    ck = load_wide_tree(*WIDE_CHUNKED_TREE)
    ms.update(device_medians(run({
        "classic_rays_wide_chunked_row": lambda: R.trace_rays_classic(
            ck, wd, wv, wc, wopt),
        "classic_rays_wide_chunked_perm": lambda: R.trace_rays_classic(
            ck, pwd, pwv, pwc, wopt)}), RAY_REPS, RAY_WARMUP))
    del ck
    for label, *tree in WIDE_K1_TREES:
        kt = load_wide_tree(label, *tree)
        tag = label.lower()
        outs[f"render_wide_{tag}_img"], outs[f"render_wide_{tag}_aux"] = \
            R.render_noisy(kt, tf, 7, 1, opt=o6, **kw)[:2]
        ms.update(device_medians({
            f"render_wide_{tag}": lambda: R.render_noisy(kt, tf, 7, 1,
                                                         opt=o6, **kw),
            **run({f"rays_wide_{tag}_row": lambda: R.trace_rays(
                kt, wd, wv, wc, wdst, o6)})}, RAY_REPS, RAY_WARMUP))
        del kt
    res["ms"] = ms
    res["digest"] = frame_digest(tuple(outs[k] for k in sorted(outs)))
    res["timing"] = (f"median of {RAY_REPS} calls each after {RAY_WARMUP} "
                     "rounds, in turns, CUDA events, host queuing hidden "
                     "behind a sleep kernel")
    np.savez(ray_outputs_path(root),
             **{k: t.cpu().numpy() for k, t in outs.items()})
    log(json.dumps({"ray_times": res}))
    return 0


def ray_pairs(other_root, pairs):
    """--ray-pairs: ``pairs`` pairs of --ray-times processes, this script
    on OTHER_ROOT's package and on its own in turns; each side's times
    (least, quartiles, largest; the keys both sides time paired, any
    other this side's alone), this side's less the other's within a pair,
    each side's digests and the largest |difference| between the two
    sides' outputs, which must be 0 for every ray mode in both orders and
    for the render_wide frames.  One JSON line {"ray_pairs": ...}."""
    if not os.path.isfile(os.path.join(WORK, "shell_d9_sh9.npz")):
        headline_tree_path()
    for tree in (("SG32", "SG", 32, WIDE_TREE_DEPTH), WIDE_CHUNKED_TREE,
                 *WIDE_K1_TREES):
        wide_tree_path(*tree)
    ms = {"other": {}, "this": {}}
    digests = {side: set() for side in ms}
    for i, side, lines in alternate(other_root, pairs, ["--ray-times"],
                                    "ray_pairs", own_script=True):
        got = [ln["ray_times"] for ln in lines if "ray_times" in ln]
        require(len(got) == 1, f"{side} ray process {i}: unexpected output")
        for k, t in got[0]["ms"].items():
            ms[side].setdefault(k, []).append(t)
        digests[side].add(got[0]["digest"])
    both = sorted(set(ms["this"]) & set(ms["other"]))
    paired = {side: {k: ms[side][k] for k in both} for side in ms}
    outs = {side: np.load(ray_outputs_path(root)) for side, root in
            (("this", HERE), ("other", other_root))}
    diffs = {k: float(np.abs(outs["this"][k] - outs["other"][k]).max())
             for k in outs["this"].files}
    log(json.dumps({"ray_pairs": {
        **pair_times(other_root, pairs, paired),
        "this_only": {k: spread(v) for k, v in ms["this"].items()
                      if k not in both},
        "digests": {side: sorted(d) for side, d in digests.items()},
        "outputs_max_abs_diff": diffs}}))
    require(all(diffs[k] == 0 for k in diffs),
            f"the ray modes' or render_wide's outputs are not the other "
            f"package's bit for bit: {diffs}")
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


# The wide path: two 96-wide nets of 12 levels (the ladder 1..12, and
# --identity_level's 0..11) and a 3-block 128-wide net of 4 levels trained
# by the CLI on the train phase's kit for WIDE_TRAIN_EPOCHS, each rendered
# by the CLI on the headline tree; and SG and ASG trees of basis_dim 32
# (depth WIDE_TREE_DEPTH) rendered by the CLI with both estimators and
# traced by the ray API.
WIDE_TRAIN_FLAGS = ["--mid_channels", "96", "--kernel_levels", "12"]
WIDE_TRAIN_EPOCHS = 1
# (label, the CLI's flags, the exported header's (mid_channels,
# num_layers, kernel_levels, identity_level)): the 96-wide nets take K7's
# fused wide instance (one launch a frame), K2 wide and K5 / K6 wide; the
# 128-wide net K7's per-block plan (three launches a frame), K2 and K5 /
# K6 at 4 levels
WIDE_PATH_NETS = (
    ("ladder", WIDE_TRAIN_FLAGS, (96, 2, 12, False)),
    ("identity", WIDE_TRAIN_FLAGS + ["--identity_level"], (96, 2, 12, True)),
    ("chain128", ["--mid_channels", "128", "--num_layers", "3"],
     (128, 3, 4, False)))
WIDE_TREE_DEPTH = 8
WIDE_PATH_RAYS = 65536


def path_guard_share(r, ps, gnet):
    """K2 wide's guarded (tile, level) pairs on the headline frame (pose
    r_0, SPP 6) denoised by the .gnet at ``gnet``: a Renderer on the tree
    of ``r``, K1's noisy frame, K7 on its aux, then K2 with the counter."""
    from rt_octree_tpu_torch.render.renderer import Renderer
    w = Renderer(r.tree, 800, 800, ps.fx, ps.fy, options=headline_options())
    w.set_denoiser(gnet)
    img, aux_nhwc, _ = w.render_noisy(ps.poses[0])
    n, share = k2_guards(w.net_forward(aux_nhwc), img, w.net_cfg.supports())
    return {"guarded_pairs": n, "share": share}


def phase_wide_path(native, r, ps, tree_path, err):
    """The wide path through the entry points a user calls, each run with
    the launch counts set to 0 just before it and read just after:
    ``rtoctree train`` of the two wide nets (K5 and K6's wide instances
    once a step; the test split after the last epoch through K7's fused
    wide instance and K2's wide instance) and its compact task, ``rtoctree
    render`` with each exported .gnet (K7's fused wide instance and K2's
    wide instance once a frame; PSNR on benchmarks/quality's 8 poses, no
    bar; K2 wide's guard share on pose r_0 through a Renderer on the tree
    of ``r``), ``rtoctree render`` on the SG32 and ASG32 trees with
    the headline flags and with --estimator classic (K1's and
    render_classic's wide instances) and on WIDE_CHUNKED_TREE with
    --estimator classic (render_classic's chunked wide instance), and
    trace_rays / trace_rays_classic on aimed rays at those trees (their
    ray modes), their outputs held against the plain versions after the
    counts are read.  Prints {"wide_path": ...}; returns each wide
    kernel's launches on its path."""
    import torch
    from rt_octree_tpu_torch.core.options import RenderOptions
    from rt_octree_tpu_torch.io import n3tree
    from rt_octree_tpu_torch.io.png import read_png
    from rt_octree_tpu_torch.models.guidance_net import load_compact
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.render import renderer as R
    kit = os.path.join(WORK, "train_kit")
    out, counts = {}, dict.fromkeys(WIDE_KERNELS, 0)
    common = ["--spp", "6", "--warmup", "1", "--device", "cuda"]
    gt = [read_png(os.path.join(KIT, "test", f"r_{i}.png"))[..., :3]
          for i in range(8)]
    wide_k56 = ("guided_filter_batch_wide", "guided_filter_batch_bwd_wide")
    for label, flags, header in WIDE_PATH_NETS:
        chain = header[1] > 2  # K7's per-block plan, K2 / K5 / K6 at 4 levels
        name = f"wide_{label}"
        work = os.path.join(WORK, "train_logs", name)
        if os.path.isdir(work):
            shutil.rmtree(work)
        argv = train_argv(kit, WIDE_TRAIN_EPOCHS, exp_name=name) + flags
        k56, other = ((tuple(TRAIN_KERNELS), wide_k56) if chain
                      else (wide_k56, tuple(TRAIN_KERNELS)))
        c = train_cli(native, f"wide {label}", argv, required=k56,
                      absent=other)
        if not chain:
            for k in wide_k56:
                counts[k] = max(counts[k], c[k])
        train_cli(native, f"wide {label} compact",
                  train_argv(kit, WIDE_TRAIN_EPOCHS, "compact", name)
                  + flags, absent=TRAIN_KERNELS)
        gnet = os.path.join(work, "ts_latest.gnet")
        cfg, _ = load_compact(gnet)
        require((cfg.mid_channels, cfg.num_layers, cfg.kernel_levels,
                 cfg.identity_level) == header,
                f"the exported .gnet's header: {cfg}")
        k2 = "guided_filter" if chain else "guided_filter_wide"
        c = phase_main(native, tree_path, f"wide net {label}",
                       ["--gnet", gnet, "--lut_levels", "9"] + common,
                       ("render", "guidance_net_wide", k2))
        # K7's launches a frame: the fused wide instance once, the
        # per-block plan once a block
        require(not c["guidance_net"] and not c[
            "guided_filter_wide" if chain else "guided_filter"],
            f"the wide net {label} ran another instance of K7 or K2")
        plan = ("per-block plan once a block" if chain
                else "fused wide instance once")
        require(c["guidance_net_wide"] == (cfg.num_layers if chain else 1)
                * c["render"] and c[k2] == c["render"],
                f"the wide net {label}'s frames did not launch K7's {plan} "
                f"and K2 once a frame: {c}")
        if chain:
            counts["guidance_net_wide_chain"] = c["guidance_net_wide"]
        else:
            for k in ("guidance_net_wide", "guided_filter_wide"):
                counts[k] = max(counts[k], c[k])
        frames_dir = os.path.join(WORK, f"frames_wide_net_{label}")
        den = [psnr(read_png(os.path.join(frames_dir, f"r_{i}.png"))
                    .astype(np.float32) / 255.0, g)
               for i, g in enumerate(gt)]
        out[f"net {label}"] = {"denoised_db": float(np.mean(den)),
                               "supports": list(cfg.supports()),
                               "k7_launches_a_frame": c["guidance_net_wide"]
                               / c["render"]}
        if not chain:
            out[f"net {label}"]["k2_guard"] = path_guard_share(r, ps, gnet)
        log(f"[wide] net {label} ({WIDE_TRAIN_EPOCHS} epoch): denoised "
            f"{np.mean(den):.3f} dB on benchmarks/quality's 8 poses (no "
            f"bar; supports {cfg.supports()}); {out[f'net {label}']}")
    for label, fmt, bd, depth in (("SG32", "SG", 32, WIDE_TREE_DEPTH),
                                  ("ASG32", "ASG", 32, WIDE_TREE_DEPTH),
                                  WIDE_CHUNKED_TREE):
        path, sec = wide_tree_path(label, fmt, bd, depth)
        tree = n3tree.load(path)
        # render_classic's instance (the host's choice) names its launches
        wide = "_" + R.classic_layout(tree.data_format.format.value,
                                      tree.data_format.basis_dim,
                                      tree.data_dim)
        log(f"[wide] {label} depth-{depth} shell: {tree.data.shape[0]} rows "
            f"of {tree.data_dim} halfs, built and saved in {sec:.1f} s")
        flags = ["--gnet", os.path.join(KIT, "trained.gnet"), "--lut_levels",
                 str(depth)] + common
        if wide == "_wide":  # K1's wide instance (the chunked tree: classic)
            c = phase_main(native, path, f"{label} tree", flags,
                           ("render_wide", "guidance_net", "guided_filter"))
            counts["render_wide"] = max(counts["render_wide"],
                                        c["render_wide"])
        c = phase_main(native, path, f"{label} tree classic",
                       flags + ["--estimator", "classic"],
                       ("render_classic" + wide,))
        counts["render_classic" + wide] = max(counts["render_classic" + wide],
                                              c["render_classic" + wide])
        require(not c["render"] and not c["render_classic"] and
                sum(c[k] for k in ("render_classic_wide",
                                   "render_classic_wide_chunked"))
                == c["render_classic" + wide],
                "a wide tree ran another render_classic instance")
        dt = upload_tree(tree, lut_levels=depth, device="cuda")
        d, v, cen, dst = aimed_rays(dt, WIDE_PATH_RAYS, 6, 70)
        native.reset_launches()
        rt = R.trace_rays(dt, d, v, cen, dst, RenderOptions(spp=6))
        cl = R.trace_rays_classic(dt, d, v, cen,
                                  RenderOptions(estimator="classic"))
        torch.cuda.synchronize()
        c = dict(native.LAUNCHES)
        log(f"[wide] {label} ray API, {WIDE_PATH_RAYS} aimed rays: launches "
            f"{ {k: n for k, n in c.items() if n} }")
        require(c["render_rays_wide"] == 1 and
                c["render_classic_rays" + wide] == 1,
                "the ray API did not run the wide instances")
        hold_ray_result(f"{label} ray API", "render_rays_wide", rt,
                        R.trace_rays_plain(dt, d, v, cen, dst,
                                           RenderOptions(spp=6)), err)
        hold_ray_result(f"{label} ray API classic",
                        "render_classic_rays" + wide, cl,
                        R.trace_rays_classic_plain(
                            dt, d, v, cen, RenderOptions(estimator="classic")),
                        err)
        for k in ("render_rays_wide", "render_classic_rays" + wide):
            counts[k] = max(counts[k], c[k])
    out["launches"] = counts
    log(json.dumps({"wide_path": out}))
    return counts


# ---------------------------------------------------------------------------
# the multi-device phase: rt_octree_tpu_torch/parallel on the one card
# ---------------------------------------------------------------------------

# The sharded frames: label -> (render_scale, net of benchmarks/quality,
# estimator, the kernels each rank launches once a frame).
MD_FRAMES = {
    "headline": (1.0, "trained.gnet", "rt",
                 ("render", "guidance_net", "guided_filter")),
    "fast s=0.5": (0.5, "fast.gnet", "rt",
                   ("render", "upsample", "guidance_net", "guided_filter")),
    "classic": (1.0, "trained.gnet", "classic",
                ("render_classic", "guidance_net", "guided_filter")),
}
# The runs: (world, backend, frames, whether the train step runs): one
# rank on nccl; two ranks on the one card over gloo (NCCL refuses two ranks
# on one device), frames and the step at dp 2 x sp 1; four over gloo, the
# step at dp 2 x sp 2 (image rows over sp, halo crops).
MD_RUNS = ((1, "nccl", ("headline",), False),
           (2, "gloo", tuple(MD_FRAMES), True),
           (4, "gloo", (), True))
MD_SIZE = 800  # the headline frame's width and height
MD_REPS, MD_WARMUP = 10, 3
MD_GATE_TOL = 0.001  # dB from phase 8's gates: the same frames
# The step against the single process: the loss within rtol 2e-5; in f32
# the parameters after one Adam step within 1e-6 (1 % of a step at lr
# 1e-4); in bf16, the training numerics, each rank's weight gradient is
# rounded to bf16 before the average, so the averaged gradient within 2^-7
# of each tensor's largest (Adam's first step, g / (|g| + eps), turns such
# a difference into up to a whole step where the weight decay cancels the
# gradient, so bf16 parameters are recorded, not held).
MD_LOSS_RTOL, MD_PARAM_TOL, MD_GRAD_REL = 2e-5, 1e-6, 2.0 ** -7
MD_TIMEOUT_S = 300.0


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def md_timed(fn):
    """Medians over MD_REPS calls of ``fn(marks)`` (after MD_WARMUP untimed
    calls) of the whole call and of each stage between its marks, in ms by
    CUDA events on this rank."""
    import torch
    for _ in range(MD_WARMUP):
        fn(None)
    torch.cuda.synchronize()
    runs = []
    for _ in range(MD_REPS):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        marks = [("start", start)]
        fn(marks)
        runs.append(marks)
    torch.cuda.synchronize()
    split = {}
    for marks in runs:
        for (_, a), (name, b) in zip(marks, marks[1:]):
            split.setdefault(name, []).append(a.elapsed_time(b))
        split.setdefault("whole", []).append(
            marks[0][1].elapsed_time(marks[-1][1]))
    return {k: float(np.median(v)) for k, v in split.items()}


def md_rank(dev, frames, train):
    """One rank of a multi-device run: the sharded frames (``frames``, the
    arguments of md_frames, or None) and the train step (``train``, those
    of md_train, or None) on one ("dp", "sp") mesh."""
    from rt_octree_tpu_torch.parallel import mesh as pm
    mesh = pm.make_mesh(device_type=dev.type)
    return {"mesh": tuple(mesh.shape),
            "frames": md_frames(dev, mesh, *frames) if frames else None,
            "train": md_train(dev, mesh, *train) if train else None}


def md_frames(dev, mesh, tree_path, labels, poses, fx, fy):
    """A rank's sharded frames: the headline tree read and uploaded on this
    rank's device (K3 here), then per frame of ``labels`` the launches of
    pose r_0's frame, its digest (rank 0: the frame), the 8-pose gate
    (rank 0) and the frame's time and split; then render_rays_sharded on
    the headline frame's rays (headline_ray_batch): its launches and the
    digest of its [R, 4]."""
    import hashlib

    import torch
    import torch.distributed as dist
    from rt_octree_tpu_torch.io import n3tree
    from rt_octree_tpu_torch.io.png import read_png
    from rt_octree_tpu_torch.models.guidance_net import load_model
    from rt_octree_tpu_torch.native import build as native
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.parallel import mesh as pm
    from rt_octree_tpu_torch.utils.rng import Pcg32
    t0 = time.perf_counter()
    native.reset_launches()
    dt = upload_tree(n3tree.load(tree_path), lut_levels=9, device=dev)
    torch.cuda.synchronize()
    rank = dist.get_rank()
    out = {"rank": rank, "load_s": time.perf_counter() - t0,
           "upload_launches": _nonzero(native.LAUNCHES), "frames": {}}
    # bench.quality_report's protocol: rng.seed(20230418, 1) for every pose
    state = Pcg32(20230418, 1).state
    for label in labels:
        scale, gnet, est, _ = MD_FRAMES[label]
        opt = headline_options()
        opt.estimator = est
        net, _ = load_model(os.path.join(KIT, gnet), dev)
        frame = pm.make_sharded_frame_renderer(
            mesh, dt, MD_SIZE, MD_SIZE, fx, fy, opt, max_steps=8192, net=net,
            render_scale=scale)
        native.reset_launches()
        img, aux = frame(poses[0], state)
        torch.cuda.synchronize()
        res = {"launches": _nonzero(native.LAUNCHES), "digest": hashlib.sha1(
            img.cpu().numpy().tobytes() + aux.cpu().numpy().tobytes())
            .hexdigest()}
        if rank == 0:
            res["frame0"] = (img.cpu(), aux.cpu())
        acc = {"noisy": [], "denoised": []}
        for i, pose in enumerate(poses[:8]):
            img, aux = frame(pose, state)
            if rank == 0:
                gt = read_png(os.path.join(KIT, "test", f"r_{i}.png"))[..., :3]
                acc["noisy"].append(psnr(
                    aux[:3].permute(1, 2, 0).cpu().numpy(), gt))
                acc["denoised"].append(psnr(img.cpu().numpy(), gt))
        if rank == 0:
            res["psnr"] = (float(np.mean(acc["noisy"])),
                           float(np.mean(acc["denoised"])))
        res["ms"] = md_timed(lambda marks: frame(poses[0], state, marks))
        out["frames"][label] = res
    # the sharded ray tracer on the headline frame's rays and K1's own
    # thresholds, the counts set to 0 just before it and read just after
    d, v, c, u = headline_ray_batch(dt, poses[0], fx, fy)[:4]
    native.reset_launches()
    got = pm.render_rays_sharded(mesh, dt, d, v, c, u, headline_options(),
                                 max_steps=RAY_SHARDED_MAX_STEPS)
    torch.cuda.synchronize()
    out["rays"] = {"launches": _nonzero(native.LAUNCHES),
                   "digest": hashlib.sha1(got.cpu().numpy().tobytes())
                   .hexdigest()}
    return out


def md_train(dev, mesh, cfg, params, batch):
    """A rank's sharded train step: one step from ``params`` in bf16 and in
    f32 (loss, the averaged gradients, the parameters after Adam, the
    step's launches), then the bf16 step's time and split."""
    import torch
    import torch.distributed as dist
    from rt_octree_tpu_torch.native import build as native
    from rt_octree_tpu_torch.parallel import mesh as pm
    batch = tuple(t.to(dev) for t in batch)
    out = {"rank": dist.get_rank(), "steps": {}}
    for dtype in (torch.bfloat16, torch.float32):
        step, model, _ = pm.make_sharded_train_step(mesh, cfg, params=params,
                                                    dtype=dtype)
        native.reset_launches()
        loss = step(*batch)
        torch.cuda.synchronize()
        out["steps"][str(dtype)] = (
            float(loss), {k: p.grad.cpu() for k, p in model.named_parameters()},
            {k: p.detach().cpu() for k, p in model.named_parameters()},
            _nonzero(native.LAUNCHES))
    step, _, _ = pm.make_sharded_train_step(mesh, cfg, params=params)
    out["ms"] = md_timed(lambda marks: step(*batch, marks=marks))
    return out


def md_single_steps(cfg, params, batch):
    """The single process's step from ``params`` on the card, bf16 and f32:
    dtype -> (loss, gradients, parameters after Adam), and the bf16 step's
    ms (CUDA events, MD_REPS steps after MD_WARMUP)."""
    import torch
    from rt_octree_tpu_torch.models.guidance_net import (GuidanceNet,
                                                         params_from_numpy)
    from rt_octree_tpu_torch.ops.filtering import guided_filter_batch
    from rt_octree_tpu_torch.train.metrics import smape_loss
    aux, img_in, img_gt = batch
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = GuidanceNet(cfg, dtype=dtype)
        model.load_state_dict(params_from_numpy(cfg, params))
        model = model.cuda()
        opt = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                               eps=1e-8, weight_decay=5e-4)

        def step():
            opt.zero_grad(set_to_none=True)
            w, g = model(aux.permute(0, 2, 3, 1))
            res = guided_filter_batch(w, g, img_in, cfg.supports())
            loss = smape_loss(res[..., :3], img_gt[..., :3])
            loss.backward()
            opt.step()
            return loss
        loss = float(step().detach())
        out[str(dtype)] = (
            loss, {k: p.grad.cpu().clone()
                   for k, p in model.named_parameters()},
            {k: p.detach().cpu().clone()
             for k, p in model.named_parameters()})
        if dtype == torch.bfloat16:
            out["ms"] = cuda_ms(step, MD_REPS, MD_WARMUP)
    return out


def phase_multidev(r, ps, tree_path, gates, card):
    """The multi-device module on the one card (rt_octree_tpu_torch/
    parallel): the runs of MD_RUNS, the ranks' counts set to 0 just before
    each frame or step and read just after, held against the single
    process of this call.  Prints {"multidev": ...} and returns each
    kernel's launches in each run, summed over its ranks."""
    import hashlib

    from rt_octree_tpu_torch.parallel.launch import launch
    from rt_octree_tpu_torch.render import renderer as R
    from rt_octree_tpu_torch.utils.rng import make_sorted_dst
    out = {"card": card, "runs": {}}
    sharded = {}

    def count(run, launches):
        for c in launches:
            for k, n in c.items():
                sharded.setdefault(k, {})
                sharded[k][run] = sharded[k].get(run, 0) + n

    # the single process: pose r_0 at the quality protocol's PCG32 state
    single = {}
    for label, (scale, gnet, est, _) in MD_FRAMES.items():
        opt = headline_options()
        opt.estimator = est
        rs = R.Renderer(r.tree, MD_SIZE, MD_SIZE, r.fx, r.fy, options=opt,
                        render_scale=scale)
        rs.set_denoiser(os.path.join(KIT, gnet))
        rs.rng.seed(20230418, 1)
        img, aux = rs.render(ps.poses[0])
        single[label] = (img.cpu(), aux.cpu(),
                         cuda_ms(lambda: rs.render(ps.poses[0]), MD_REPS,
                                 MD_WARMUP))
    # the sharded ray tracer's single process: trace_rays on the same rays
    d, v, c, u = headline_ray_batch(r.tree, ps.poses[0], r.fx, r.fy)[:4]
    single["rays"] = hashlib.sha1(R.trace_rays(
        r.tree, d, v, c, make_sorted_dst(u), headline_options(),
        max_steps=RAY_SHARDED_MAX_STEPS).cpu().numpy().tobytes()).hexdigest()
    del d, v, c, u
    # the train step on phase 9's real batch, from a fresh Runner's net
    runner, _, _, batch = train_batch(os.path.join(WORK, "train_kit"))
    cfg, params = runner.net_cfg, runner.params()
    del runner
    single_step = md_single_steps(cfg, params, batch)
    train_args = (cfg, params, tuple(t.cpu() for t in batch))
    poses = list(ps.poses[:8])
    for world, backend, labels, train in MD_RUNS:
        run = f"world {world} {backend}"
        t0 = time.time()
        ranks = launch(md_rank, world, backend=backend,
                       args=((tree_path, labels, poses, r.fx, r.fy)
                             if labels else None,
                             train_args if train else None),
                       timeout_s=MD_TIMEOUT_S)
        rec = {"mesh": ranks[0]["mesh"], "wall_s": time.time() - t0}
        if labels:
            rec["frames"] = md_hold_frames(
                [o["frames"] for o in ranks], labels, single, gates, run,
                count)
        if train:
            rec["train"] = md_hold_train([o["train"] for o in ranks],
                                         single_step, run, count)
        log(f"[multidev] {run} (mesh {rec['mesh']}): wall {rec['wall_s']:.1f}"
            " s with the ranks' start")
        out["runs"][run] = rec
    out["launches"] = sharded
    log(json.dumps({"multidev": out}))
    return sharded


def md_hold_frames(ranks, labels, single, gates, run, count):
    """Hold one run's sharded frames (each rank's md_frames) against the
    single process and phase 8's gates; their record."""
    import torch
    rec = {"load_s": [o["load_s"] for o in ranks],
           "upload_launches": [o["upload_launches"] for o in ranks]}
    count(run, rec["upload_launches"])
    for label in labels:
        kernels = MD_FRAMES[label][3]
        img1, aux1, single_ms = single[label]
        res = [o["frames"][label] for o in ranks]
        img, aux = res[0]["frame0"]
        img_err = float((img - img1).abs().max())
        noisy, den = res[0]["psnr"]
        g_noisy, g_den = gates[label]
        ms = {k: max(o["ms"][k] for o in res) for k in res[0]["ms"]}
        rec[label] = {
            "launches": [o["launches"] for o in res],
            "aux_bit_equal": bool(torch.equal(aux, aux1)),
            "img_max_abs_err": img_err,
            "ranks_equal": len({o["digest"] for o in res}) == 1,
            "psnr": [noisy, den], "gate": [g_noisy, g_den],
            "ms": ms, "single_ms": single_ms}
        log(f"[multidev] {label} frame, {run}: aux bit-equal "
            f"{rec[label]['aux_bit_equal']}, img max|diff| {img_err:.3g} (bar "
            f"{K2_TOL}); 8 poses noisy {noisy:.4f} / denoised {den:.4f} dB "
            f"(phase 8: {g_noisy:.4f} / {g_den:.4f}); launches a frame a rank"
            f" {rec[label]['launches']}; ms a frame (largest rank) "
            + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
            + f"; the single process {single_ms:.3f}")
        require(rec[label]["aux_bit_equal"] and img_err <= K2_TOL
                and rec[label]["ranks_equal"],
                f"multidev {label} {run}: the sharded frame is not the "
                "single process's")
        require(abs(noisy - g_noisy) <= MD_GATE_TOL
                and abs(den - g_den) <= MD_GATE_TOL,
                f"multidev {label} {run}: gates moved")
        for o in res:
            require(all(o["launches"].get(k) == 1 for k in kernels),
                    f"multidev {label} {run}: a rank launched "
                    f"{o['launches']}, not {kernels} once each")
        count(run, rec[label]["launches"])
    rays = [o["rays"] for o in ranks]
    rec["rays"] = {"launches": [o["launches"] for o in rays],
                   "bit_equal": all(o["digest"] == single["rays"]
                                    for o in rays)}
    log(f"[multidev] render_rays_sharded on the headline's {MD_SIZE ** 2} "
        f"rays, {run}: bit-equal to the single process "
        f"{rec['rays']['bit_equal']}; launches a rank "
        f"{rec['rays']['launches']}")
    require(rec["rays"]["bit_equal"], f"multidev rays {run}: not the single "
            "process's")
    require(all(c == {"render_rays": 1} for c in rec["rays"]["launches"]),
            f"multidev rays {run}: launches {rec['rays']['launches']}")
    count(run, rec["rays"]["launches"])
    return rec


def md_hold_train(ranks, single, run, count):
    """Hold one run's sharded train step (each rank's md_train) against
    the single process's (md_single_steps); its record."""
    rec = {"ms": {k: max(o["ms"][k] for o in ranks) for k in ranks[0]["ms"]},
           "single_ms": single["ms"]}
    for dtype in ("torch.bfloat16", "torch.float32"):
        loss1, grads1, params1 = single[dtype]
        steps = [o["steps"][dtype] for o in ranks]
        loss_err = max(abs(s[0] - loss1) / abs(loss1) for s in steps)
        grad_rel = max(float((s[1][k] - g).abs().max()) / float(g.abs().max())
                       for s in steps for k, g in grads1.items())
        param_err = max(float((s[2][k] - p).abs().max())
                        for s in steps for k, p in params1.items())
        launches = [s[3] for s in steps]
        rec[dtype.split(".")[1]] = {
            "loss": [s[0] for s in steps], "single_loss": loss1,
            "loss_rel_err": loss_err, "grad_rel_err": grad_rel,
            "param_max_abs_err": param_err, "launches": launches}
        log(f"[multidev] train step, {run}, {dtype}: loss {steps[0][0]:.7g} "
            f"vs {loss1:.7g} (rel {loss_err:.3g}); gradients within "
            f"{grad_rel:.3g} of each tensor's largest; parameters after one "
            f"step within {param_err:.3g}; launches {launches}")
        require(loss_err <= MD_LOSS_RTOL, f"multidev train {run} {dtype}: "
                "loss")
        require(all(c == {"guided_filter_batch": 1,
                          "guided_filter_batch_bwd": 1} for c in launches),
                f"multidev train {run}: K5 / K6 launches {launches}")
        if dtype == "torch.float32":
            require(param_err <= MD_PARAM_TOL,
                    f"multidev train {run}: f32 parameters")
        else:
            require(grad_rel <= MD_GRAD_REL,
                    f"multidev train {run}: bf16 gradients")
        count(run, launches)
    log(f"[multidev] train step, {run}: ms a step (largest rank) "
        + ", ".join(f"{k} {v:.3f}" for k, v in rec["ms"].items())
        + f"; the single process {single['ms']:.3f}")
    return rec

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
    one = torch.ones((), device=dev)
    hold("probe_affine", "8x128", lambda: P.probe_affine(x),
         lambda: P.probe_affine_plain(x), 50)
    require(torch.equal(affine_library(one, x), P.probe_affine_plain(x)),
            "torch.add(1, x, alpha=2) differs from P1's plain version")
    bounds["probe_affine"] = bound(8 * x.numel(), 2 * x.numel()) + (
        device_ms(lambda: affine_library(one, x), 50, 2),)
    tab, idx = gp.vgather_inputs(dev)
    hold("lane_gather", f"tab {tuple(tab.shape)} idx {tuple(idx.shape)}, "
         f"{P.gather_plan(tab.shape[1], idx.shape[0])}",
         lambda: P.lane_gather(tab, idx),
         lambda: P.lane_gather_plain(tab, idx), 50)
    lanes = torch.arange(tab.shape[1], device=dev)
    idx64 = idx.long()
    bounds["lane_gather"] = bound(
        8 * idx.numel() + 4 * distinct(idx64 * tab.shape[1] + lanes)) + (
        device_ms(lambda: torch.gather(tab, 0, idx64), 50, 2),)
    tab, idx = gp.vgather_loop_inputs(dev)
    hold("lane_gather_chain", f"tab {tuple(tab.shape)} idx "
         f"{tuple(idx.shape)} K {gp.VL_K}, "
         f"{P.chain_plan(*tab.shape, idx.shape[0])}",
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
        f"{len(P.ring_chunks(gp.DMA_N))} CTAs, ring depth 2 a CTA; rel err "
        f"vs float64 kernel {rel_k:.3g}, plain {rel_p:.3g}; "
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
        hold("row_ring_rounds", f"rows {w * 4} B n {n}: "
             f"{len(P.ring_chunks(n))} CTAs, ring depth {nbuf} a CTA",
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
        hold("flat_gather_chain", f"S {S} n {n}, {P.flat_plan(S, n)}",
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
    # the other paths: G1 and G2's single gather from views 4 B off (a
    # float, a column a thread); G2's chain on 6 columns (2 a block, staged
    # by 4-byte stores) and from a table view 4 B off, rows not a power of
    # two; G4 on its largest local table and from a view 4 B off (4-byte
    # staging)
    x, (tab, idx) = gp.basic_input(dev), gp.vgather_inputs(dev)
    xo, tabo, idxo = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(
        t.shape) for t in (x, tab, idx))
    hold("probe_affine", "8x128 4 B off", lambda: P.probe_affine(xo),
         lambda: P.probe_affine_plain(x))
    hold("lane_gather", f"tab {tuple(tab.shape)} idx {tuple(idx.shape)} "
         "4 B off", lambda: P.lane_gather(tabo, idxo),
         lambda: P.lane_gather_plain(tab, idx))
    rs = np.random.default_rng(23)
    for T, W, off in ((8191, 6, 0), (8191, 128, 1)):
        flat = torch.from_numpy(rs.integers(
            -2 ** 31, 2 ** 31, T * W + off, dtype=np.int64).astype(
                np.int32)).to(dev)
        tab = flat[off:].view(T, W)
        idx = torch.from_numpy(rs.integers(0, T, (2049, W),
                                           dtype=np.int32)).to(dev)
        hold("lane_gather_chain", f"tab {T}x{W} {4 * off} B off, idx "
             f"2049x{W}, {P.chain_plan(T, W, 2049)}",
             lambda: P.lane_gather_chain(tab, idx, 33),
             lambda: P.lane_gather_chain_plain(tab, idx, 33))
    for S, off in ((1 << 15, 0), (1 << 14, 1)):
        flat = torch.from_numpy(rs.integers(1, 1000, S + off,
                                            dtype=np.int32)).to(dev)
        table = flat[off:]
        idx = torch.from_numpy(rs.integers(0, S, 8193,
                                           dtype=np.int32)).to(dev)
        hold("flat_gather_chain", f"S {S} {4 * off} B off n 8193, "
             f"{P.flat_plan(S, 8193)}",
             lambda: P.flat_gather_chain(idx, table, 33),
             lambda: P.flat_gather_chain_plain(idx, table, 33))
    del flat, tab, table, idx, xo, tabo, idxo
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
    if argv == ["--wide-only"]:
        return wide_only()
    if argv[:1] == ["--wide-times"] and len(argv) in (1, 2):
        return wide_times(PKG_ROOT)
    if argv[:1] == ["--wide-pairs"] and len(argv) in (2, 3):
        return wide_pairs(argv[1], int(argv[2]) if len(argv) == 3 else 6)
    if argv[:1] == ["--k7-chain-times"] and len(argv) in (1, 2):
        return k7_chain_only()
    if argv[:1] == ["--wide-sweep"] and len(argv) in (1, 2):
        return wide_sweep(PKG_ROOT)
    if argv[:1] == ["--ray-times"] and len(argv) in (1, 2):
        return ray_times(PKG_ROOT)
    if argv[:1] == ["--probe-times"] and len(argv) in (1, 2):
        return probe_times(PKG_ROOT)
    if argv[:1] == ["--probe-pairs"] and len(argv) in (2, 3):
        return probe_pairs(argv[1], int(argv[2]) if len(argv) == 3 else 6)
    if argv[:1] == ["--ray-pairs"] and len(argv) in (2, 3):
        return ray_pairs(argv[1], int(argv[2]) if len(argv) == 3 else 6)
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
    phase_rays(err)
    phase_k4(err)
    phase_pcg()
    phase_k2(err)
    phase_k7(err)
    wide_ms, wide_bounds = phase_wide(err)
    log_wide_holds(err)
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
    gates = {"headline": phase_quality(r, ps.poses)}
    ms, bounds = phase_headline(r, ps, err)
    ms_new, bounds_new = phase_fast_classic(r, ps, err, tree, gates)
    ms.update(ms_new)
    bounds.update(bounds_new)
    ms_new, bounds_new, ray_counts = phase_rays_headline(r, ps, err, smi[0])
    ms.update(ms_new)
    bounds.update(bounds_new)
    counts.update(ray_counts)
    train_counts, ms_new, bounds_new = phase_train(native, r, tree_path, err)
    counts.update(train_counts)
    ms.update(ms_new)
    bounds.update(bounds_new)
    counts.update(phase_wide_path(native, r, ps, tree_path, err))
    ms.update(wide_ms)
    bounds.update(wide_bounds)
    sharded = phase_multidev(r, ps, tree_path, gates, smi[0])
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
                      "library_ms": lib_ms,
                      "sharded_launches": sharded.get(name, {})})
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
