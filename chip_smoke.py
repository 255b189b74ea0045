#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (rt_octree_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
  2. build every kernel from csrc/ with nvcc (sm_90a);
  3. K3 (LUT build + skip distances) vs its plain version, integer-exact;
  4. K1 (fused frame) vs its plain version at 128x128, SPP 1/6/32, on a
     depth-7 shell tree and an NDC blobs tree;
  5. PCG32: the kernel's per-pixel uniforms equal the tensor twin, bit-exact;
  6. K2 (guided filter) vs its plain version at 800x800, L=4, both support
     ladders and a guidance range above 60 nats;
  7. the main path: the headless CLI on the depth-9 SH9 shell tree with the
     level-9 LUT, the committed trained.gnet, SPP 6, denoise on; every
     kernel's launch count in that run must be > 0;
  8. the quality gate on the 8 held-out poses of benchmarks/quality;
  9. every kernel vs its plain version on the main path's own inputs (the
     800x800 SPP 6 frame of the depth-9 tree, the net's weight and
     guidance, the 512^3 LUT and skip lanes), then each kernel's time vs
     its plain version there, and the headline frame's time, by CUDA
     events.

Prints the kernel table as one JSON line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs one CUDA card; exits non-zero without one.
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

KIT = os.path.join(HERE, "benchmarks", "quality")
WORK = os.path.join(HERE, "build", "chip_smoke")
# The JAX package's gate on this kit, as tools/quality_gate_jax_cpu.py
# scores it on the CPU (BASELINE.md:66 rounds it to 44.55 / 55.22), and the
# port's allowed distance from it.
GATE_NOISY, GATE_DENOISED = 44.553, 55.221
GATE_NOISY_TOL, GATE_DENOISED_TOL = 0.05, 0.10
# K1 vs plain: both run on the card with the same libm (log1pf, expf) and
# IEEE division, so they differ only by summation order in the shade.
K1_IMG_TOL, K1_AUX_TOL = 2e-5, 4e-5
K2_TOL = 1e-5  # f32 sums of up to 49 softmax taps, in another order

KERNELS = {
    "render": ("rt_octree_tpu_torch/csrc/render.cu",
               "rt_octree_tpu/render/renderer.py:1145"),
    "guided_filter": ("rt_octree_tpu_torch/csrc/filter.cu",
                      "rt_octree_tpu/ops/filtering.py:153"),
    "lut_build": ("rt_octree_tpu_torch/csrc/lut.cu",
                  "rt_octree_tpu/ops/traversal.py:102"),
    "skip_min": ("rt_octree_tpu_torch/csrc/lut.cu",
                 "rt_octree_tpu/ops/traversal.py:173"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device ms of fn() over reps runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def psnr(img, gt_u8) -> float:
    gt = gt_u8.astype(np.float32) / 255.0
    mse = float(np.mean((img[..., :3] - gt) ** 2))
    return -10.0 * np.log10(mse)


def phase_k3(err):
    import torch
    from rt_octree_tpu.io import synthetic
    from rt_octree_tpu_torch.ops import traversal as T
    cases = [("shell d7", synthetic.make_synthetic_tree(
        "shell", depth=7, basis_dim=9), 7),
        ("deep chain d10 @5", synthetic.make_deep_chain_tree(10), 5)]
    for label, tree, levels in cases:
        dt = T.upload_tree(tree, lut_levels=0, device="cuda")
        lut_k = T.build_lut(dt.chs, tree.N, levels)
        lut_p = T.lut_build_plain(dt.chs, tree.N, levels)
        res = tree.N ** levels
        skip_k = T.add_skip_distances(lut_k.clone(), res, 12)
        skip_p = T.add_skip_distances_plain(lut_p, res, 12)
        torch.cuda.synchronize()
        d_lut = int((lut_k.long() - lut_p.long()).abs().max())
        d_skip = int((skip_k.long() - skip_p.long()).abs().max())
        n_skip = int(((skip_p[:, 1] > 0) & (skip_p[:, 1] <= 12)).sum())
        log(f"[k3] {label}: {res}^3 cells, lut max|diff| {d_lut}, skip "
            f"max|diff| {d_skip} ({n_skip} cells carry a distance)")
        require(d_lut == 0 and d_skip == 0, f"K3 disagrees on {label}")
        err["lut_build"] = max(err.get("lut_build", 0.0), float(d_lut))
        err["skip_min"] = max(err.get("skip_min", 0.0), float(d_skip))


def k1_scenes():
    from rt_octree_tpu.core.camera import Camera
    from rt_octree_tpu.io import synthetic
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
    from rt_octree_tpu.core.options import RenderOptions
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


def phase_pcg():
    import torch
    from rt_octree_tpu.core.options import RenderOptions
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


def phase_k2(err):
    import torch
    from rt_octree_tpu_torch.ops.filtering import (guided_filter,
                                                   guided_filter_plain)
    rs = np.random.default_rng(7)
    H = W = 800
    L = 4
    img = torch.from_numpy(rs.random((H, W, 4), np.float32)).cuda()
    worst = 0.0
    for label, supports, gscale in (("ladder 1..4", (1, 2, 3, 4), 3.0),
                                    ("ladder 0..3", (0, 1, 2, 3), 3.0),
                                    ("range > 60 nats", (0, 1, 2, 3), 40.0)):
        logits = torch.from_numpy(rs.standard_normal((L, H, W), np.float32))
        weight = torch.softmax(logits, 0).cuda().contiguous()
        guid = torch.from_numpy(
            (rs.standard_normal((L, H, W)) * gscale).astype(np.float32)).cuda()
        out_k = guided_filter(weight, guid, img, supports)
        out_p = guided_filter_plain(weight, guid, img, supports)
        e = float((out_k - out_p).abs().max())
        grange = float(guid.max() - guid.min())
        log(f"[k2] {label}: guidance range {grange:.1f} nats, max|diff| "
            f"{e:.3g}")
        require(e <= K2_TOL and bool(torch.isfinite(out_k).all()),
                f"K2 disagrees with its plain version ({label})")
        worst = max(worst, e)
    onehot = torch.zeros((L, H, W), device="cuda")
    onehot[0] = 1.0
    out = guided_filter(onehot, guid, img, (0, 1, 2, 3))
    exact = bool(torch.equal(out[..., :3], img[..., :3]))
    log(f"[k2] support-0 passthrough bit-exact: {exact}")
    require(exact and bool((out[..., 3] == 1).all()), "K2 passthrough")
    err["guided_filter"] = worst


def headline_tree_path():
    """Build the depth-9 SH9 shell tree and save it as an npz for the CLI."""
    from rt_octree_tpu.io import synthetic
    t0 = time.time()
    tree = synthetic.make_synthetic_tree("shell", depth=9, basis_dim=9)
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "shell_d9_sh9.npz")
    synthetic.save_npz(tree, path)
    log(f"[main] depth-9 shell tree: {tree.capacity} nodes, max depth "
        f"{tree.max_depth}, built and saved in {time.time() - t0:.1f} s")
    return tree, path


def phase_main(native, tree_path):
    from rt_octree_tpu_torch.apps import headless
    from rt_octree_tpu_torch.io.png import read_png
    out_dir = os.path.join(WORK, "frames")
    argv = [tree_path, os.path.join(KIT, "transforms_test.json"),
            "-o", out_dir, "--gnet", os.path.join(KIT, "trained.gnet"),
            "--spp", "6", "--lut_levels", "9", "--warmup", "3",
            "--device", "cuda"]
    log(f"[main] headless {' '.join(os.path.relpath(a, HERE) if os.sep in a else a for a in argv)}")
    native.reset_launches()
    t0 = time.time()
    rc = headless.run(argv)
    counts = dict(native.LAUNCHES)
    log(f"[main] rc {rc} in {time.time() - t0:.1f} s; launches {counts}")
    require(rc == 0, "headless run failed")
    require(all(counts[k] > 0 for k in KERNELS),
            f"a kernel of the main path never launched: {counts}")
    for i in range(8):
        img = read_png(os.path.join(out_dir, f"r_{i}.png"))
        require(img.shape == (800, 800, 4), f"frame r_{i}: {img.shape}")
    return counts


def make_headline_renderer(tree):
    from rt_octree_tpu.core.options import RenderOptions
    from rt_octree_tpu.io.poses import load_poses
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    from rt_octree_tpu_torch.render.renderer import Renderer
    ps = load_poses("blender", os.path.join(KIT, "transforms_test.json"),
                    800, 800)
    dt = upload_tree(tree, lut_levels=9, device="cuda")
    opt = RenderOptions(spp=6, denoise=True, step_size=1e-4,
                        sigma_thresh=1e-2, background_brightness=1.0)
    r = Renderer(dt, 800, 800, ps.fx, ps.fy, options=opt)
    r.set_denoiser(os.path.join(KIT, "trained.gnet"))
    return r, ps


def phase_quality(r, ps):
    """bench.quality_report's protocol: per pose rng.seed(20230418, 1),
    noisy then denoised, whole-image PSNR vs the committed GT PNGs."""
    from rt_octree_tpu_torch.io.png import read_png
    acc = {"noisy": [], "denoised": []}
    for i, pose in enumerate(ps.poses[:8]):
        gt = read_png(os.path.join(KIT, "test", f"r_{i}.png"))[..., :3]
        r.rng.seed(20230418, 1)
        for mode in ("noisy", "denoised"):
            r.options.denoise = mode == "denoised"
            img = r.render(pose, want_aux=False)[0].cpu().numpy()
            require(img.shape == (800, 800, 4) and np.isfinite(img).all(),
                    f"pose {i} {mode}: bad frame")
            acc[mode].append(psnr(img, gt))
    r.options.denoise = True
    noisy = float(np.mean(acc["noisy"]))
    den = float(np.mean(acc["denoised"]))
    log(f"[quality] 8 poses, whole-image PSNR: noisy {noisy:.3f} dB "
        f"(JAX {GATE_NOISY}), denoised {den:.3f} dB (JAX {GATE_DENOISED})")
    for mode in ("noisy", "denoised"):
        log(f"[quality] per pose {mode} "
            f"{[round(float(v), 3) for v in acc[mode]]}")
    require(abs(noisy - GATE_NOISY) <= GATE_NOISY_TOL,
            f"noisy PSNR {noisy:.3f} not within {GATE_NOISY_TOL} dB")
    require(abs(den - GATE_DENOISED) <= GATE_DENOISED_TOL,
            f"denoised PSNR {den:.3f} not within {GATE_DENOISED_TOL} dB")
    return noisy, den


def phase_headline(r, ps, err):
    """Every kernel against its plain version on the main path's own
    inputs (the 800x800 SPP 6 frame of the depth-9 tree, the net's real
    weight and guidance, the 512^3 LUT), then each one's time."""
    import torch
    from rt_octree_tpu_torch.ops import traversal as T
    from rt_octree_tpu_torch.ops.filtering import (guided_filter,
                                                   guided_filter_plain)
    from rt_octree_tpu_torch.render import renderer as R
    from rt_octree_tpu_torch.utils.timer import PhaseTimer
    ms = {}
    pose = ps.poses[0]
    tf = r._transform(pose)
    kw = dict(width=800, height=800, fx=r.fx, fy=r.fy, opt=r.options)
    st, inc = r.rng.state, r.rng.inc

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

    w, g = r.net_forward(nk)
    img = ik
    sup = r.net_cfg.supports()
    e = float((guided_filter(w, g, img, sup)
               - guided_filter_plain(w, g, img, sup)).abs().max())
    log(f"[headline] K2 on the net's weight/guidance (supports {sup}): "
        f"max|diff| {e:.3g}")
    require(e <= K2_TOL, "K2 disagrees with its plain version on the "
            "headline frame")
    err["guided_filter"] = max(err["guided_filter"], e)

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
    err["skip_min"] = max(err["skip_min"], float(d_skip))
    del lut_p, skip_k, skip_p

    ms["render"] = (
        cuda_ms(lambda: R.render_noisy(r.tree, tf, st, inc, **kw), 20, 3),
        cuda_ms(lambda: R.render_noisy_plain(r.tree, tf, st, inc, **kw), 2))
    ms["guided_filter"] = (
        cuda_ms(lambda: guided_filter(w, g, img, sup), 50, 3),
        cuda_ms(lambda: guided_filter_plain(w, g, img, sup), 5))
    ms["lut_build"] = (cuda_ms(lambda: T.build_lut(chs, 2, 9), 3),
                       cuda_ms(lambda: T.lut_build_plain(chs, 2, 9), 1))
    ms["skip_min"] = (
        cuda_ms(lambda: T.add_skip_distances(lut_k.clone(), 512, 12), 3),
        cuda_ms(lambda: T.add_skip_distances_plain(lut_k, 512, 12), 1))
    del lut_k
    for k, (kms, pms) in ms.items():
        log(f"[timing] {k}: kernel {kms:.3f} ms, plain {pms:.3f} ms")

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
    return ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test needs one GPU",
              file=sys.stderr)
        return 1
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
    phase_pcg()
    phase_k2(err)
    tree, tree_path = headline_tree_path()
    counts = phase_main(native, tree_path)
    r, ps = make_headline_renderer(tree)
    phase_quality(r, ps)
    ms = phase_headline(r, ps, err)

    table = []
    for name, (source, replaces) in KERNELS.items():
        kms, pms = ms[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": counts[name],
                      "max_abs_err": err[name], "ms": kms, "plain_ms": pms})
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
