#!/usr/bin/env python3
"""The JAX package's quality gates, on the CPU.

Run from the repository root:

    python tools/quality_gate_jax_cpu.py [--scene shell|solid|tt|blobs]
                                         [--render_scale S] [--gnet PATH]
                                         [--estimator rt|classic]
                                         [--lod_depth D]
    python tools/quality_gate_jax_cpu.py --quant

Renders one configuration of the JAX package's bench through rt_octree_tpu
on the CPU and scores it with bench.quality_report: per pose
rng.seed(20230418, 1), noisy then denoised, PSNR against the committed GT
PNGs of the scene's 8 held-out poses.  The scenes (SPP 6, step 1e-4,
sigma threshold 1e-2, background 1.0, depth-9 SH9 synthetic trees, LUT at
min(9, depth)):

  shell   800x800, the default camera, benchmarks/quality
          (bench.py:690-748, the headline frame);
  solid   800x800, the default camera, benchmarks/quality_solid
          (bench.py:343-391);
  tt      1920x1080, focal 1158, the solid tree, benchmarks/quality_tt
          (bench.py:394-474);
  blobs   the llff scene: 1008x756, focal 800, the blobs tree in NDC, the
          forward-facing camera, benchmarks/quality_blobs
          (bench.py:477-620).

The net defaults to the kit's trained.gnet.  ``--render_scale`` runs fast
mode (the march at that fraction of the output, joint-upsampled before the
net; its bars use the kit's fast net, e.g. ``--gnet
benchmarks/quality_tt/fast.gnet``), ``--estimator classic`` the classic
exponential-transmittance marcher, ``--lod_depth D`` the tree pooled to
depth D by io/lod.build_lod (the llff LOD and interactive rungs).

``--quant`` is bench.quant_fidelity (bench.py:624-672): a depth-7 SH9 shell
compressed by the JAX dispatcher's ``compress --retain 1`` into
build/quality_gate/, the float and the quantized tree rendered at 256x256,
SPP 6, no denoise, LUT min(7, depth), from the default camera and the
Renderer's own RNG; it prints the PSNR of the quantized frame against the
float one and the ratio of the npz sizes.

These are the bars that chip_smoke.py holds the port to.  A depth-9 scene
needs about 6 GB of host memory (tt and blobs more); the frames take a few
seconds each after the first two compiles.
"""

import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

WORK = os.path.join(HERE, "build", "quality_gate")
KITS = {"shell": "quality", "solid": "quality_solid", "tt": "quality_tt",
        "blobs": "quality_blobs"}


def scene_setup(scene):
    """(tree, width, height, camera) of one of bench.py's scenes."""
    from rt_octree_tpu.core.camera import Camera
    from rt_octree_tpu.io import synthetic
    kind = "solid" if scene == "tt" else scene
    tree = synthetic.make_synthetic_tree(kind, depth=9, basis_dim=9)
    if scene == "tt":
        W, H, focal = 1920, 1080, 1158.0
        cam = Camera(width=W, height=H, fx=focal, fy=focal)
    elif scene == "blobs":
        W, H, focal = 1008, 756, 800.0
        tree.use_ndc = True
        tree.ndc_width, tree.ndc_height, tree.ndc_focal = (
            float(W), float(H), focal)
        cam = Camera(width=W, height=H, fx=focal, fy=focal)
        cam.center = np.array([0.02, 0.01, 0.3], np.float32)
        cam.v_back = np.array([0.0, 0.0, 1.0], np.float32)
        cam.v_world_up = np.array([0.0, 1.0, 0.0], np.float32)
        cam.update()
    else:
        W = H = 800
        cam = Camera(width=W, height=H)
    return tree, W, H, cam


def quant() -> int:
    from rt_octree_tpu.apps.cli import main as cli_main
    from rt_octree_tpu.core.camera import Camera
    from rt_octree_tpu.core.options import RenderOptions
    from rt_octree_tpu.io import n3tree, synthetic
    from rt_octree_tpu.ops.traversal import upload_tree
    from rt_octree_tpu.render.renderer import Renderer

    os.makedirs(WORK, exist_ok=True)
    src = os.path.join(WORK, "shell_d7_sh9.npz")
    synthetic.save_npz(synthetic.make_synthetic_tree(
        "shell", depth=7, basis_dim=9), src)
    qdir = os.path.join(WORK, "quant")
    t0 = time.time()
    rc = cli_main(["compress", src, "--out_dir", qdir, "--retain", "1",
                   "--overwrite"])
    print(f"compress rc {rc} in {time.time() - t0:.1f} s", flush=True)
    qpath = os.path.join(qdir, os.path.basename(src))
    size = 256
    cam = Camera(width=size, height=size)
    opt = RenderOptions(spp=6, denoise=False)
    imgs = {}
    for label, path in (("float", src), ("quant", qpath)):
        t = n3tree.load(path)
        r = Renderer(upload_tree(t, lut_levels=min(7, t.max_depth)),
                     size, size, cam.fx, cam.fy, options=opt)
        imgs[label] = np.asarray(r.render(cam.transform,
                                          want_aux=False)[0])
    mse = float(np.mean((imgs["float"][..., :3]
                         - imgs["quant"][..., :3]) ** 2))
    psnr = -10.0 * np.log10(max(mse, 1e-12))
    ratio = os.path.getsize(qpath) / os.path.getsize(src)
    print({"depth": 7, "psnr_vs_float": psnr, "bytes_ratio": ratio,
           "float_bytes": os.path.getsize(src),
           "quant_bytes": os.path.getsize(qpath)})
    return 0 if rc == 0 and np.isfinite(psnr) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=tuple(KITS), default="shell")
    ap.add_argument("--render_scale", type=float, default=1.0)
    ap.add_argument("--gnet", default=None,
                    help="default: the scene kit's trained.gnet")
    ap.add_argument("--estimator", choices=("rt", "classic"), default="rt")
    ap.add_argument("--lod_depth", type=int, default=0,
                    help="pool the tree to this depth (io/lod.build_lod)")
    ap.add_argument("--quant", action="store_true",
                    help="bench.quant_fidelity's PSNR and bytes ratio")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.quant:
        return quant()
    import bench
    from rt_octree_tpu.core.options import RenderOptions
    from rt_octree_tpu.io.lod import build_lod
    from rt_octree_tpu.ops.traversal import upload_tree
    from rt_octree_tpu.render.renderer import Renderer

    kit = os.path.join(HERE, "benchmarks", KITS[args.scene])
    gnet = args.gnet or os.path.join(kit, "trained.gnet")
    t0 = time.time()
    tree, W, H, cam = scene_setup(args.scene)
    if args.lod_depth:
        tree = build_lod(tree, min(args.lod_depth, tree.max_depth))
    dt = upload_tree(tree, lut_levels=min(9, tree.max_depth))
    print(f"{args.scene} tree {tree.capacity} nodes, depth "
          f"{tree.max_depth}, built and uploaded in {time.time() - t0:.1f} "
          "s", flush=True)
    opt = RenderOptions(spp=6, denoise=True, step_size=1e-4,
                        sigma_thresh=1e-2, background_brightness=1.0,
                        estimator=args.estimator)
    r = Renderer(dt, W, H, cam.fx, cam.fy, options=opt,
                 render_scale=args.render_scale)
    r.set_denoiser(gnet)
    t0 = time.time()
    out = bench.quality_report(r, [kit], "jax-cpu")
    print(f"16 frames scored in {time.time() - t0:.1f} s (scene "
          f"{args.scene} {W}x{H}, render_scale {args.render_scale}, "
          f"lod_depth {args.lod_depth}, estimator {args.estimator}, gnet "
          f"{os.path.relpath(gnet, HERE)}, denoise_recommended "
          f"{r.denoise_recommended})", flush=True)
    print(out)
    return 0 if out else 1


if __name__ == "__main__":
    sys.exit(main())
