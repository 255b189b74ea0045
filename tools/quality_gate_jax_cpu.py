#!/usr/bin/env python3
"""The JAX package's quality gate for the headline frame, on the CPU.

Run from the repository root:

    python tools/quality_gate_jax_cpu.py [--render_scale S] [--gnet PATH]
                                         [--estimator rt|classic]

Renders the headline configuration (depth-9 SH9 shell tree, level-9 LUT
with skip distances, 800x800, SPP 6, benchmarks/quality/trained.gnet)
through rt_octree_tpu on the CPU and scores it with bench.quality_report:
per pose rng.seed(20230418, 1), noisy then denoised, PSNR against the
committed GT PNGs of the 8 held-out poses.  ``--render_scale`` runs fast
mode (the march at that fraction of 800x800, joint-upsampled before the
net; its bars use the fast-mode net, e.g. ``--gnet
benchmarks/quality/fast.gnet`` at 0.5 and ``fast_s0.4.gnet`` at 0.4),
``--estimator classic`` the classic exponential-transmittance marcher.
These are the bars that chip_smoke.py holds the port to.  Needs about
6 GB of host memory; the frames take a few seconds each after the first
two compiles.
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    kit = os.path.join(HERE, "benchmarks", "quality")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--render_scale", type=float, default=1.0)
    ap.add_argument("--gnet", default=os.path.join(kit, "trained.gnet"))
    ap.add_argument("--estimator", choices=("rt", "classic"), default="rt")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import bench
    from rt_octree_tpu.core.camera import Camera
    from rt_octree_tpu.core.options import RenderOptions
    from rt_octree_tpu.io import synthetic
    from rt_octree_tpu.ops.traversal import upload_tree
    from rt_octree_tpu.render.renderer import Renderer

    t0 = time.time()
    tree = synthetic.make_synthetic_tree("shell", depth=9, basis_dim=9)
    dt = upload_tree(tree, lut_levels=9)
    print(f"tree {tree.capacity} nodes built and uploaded in "
          f"{time.time() - t0:.1f} s", flush=True)
    opt = RenderOptions(spp=6, denoise=True, step_size=1e-4,
                        sigma_thresh=1e-2, background_brightness=1.0,
                        estimator=args.estimator)
    cam = Camera(width=800, height=800)
    r = Renderer(dt, 800, 800, cam.fx, cam.fy, options=opt,
                 render_scale=args.render_scale)
    r.set_denoiser(args.gnet)
    t0 = time.time()
    out = bench.quality_report(r, [kit], "jax-cpu")
    print(f"16 frames scored in {time.time() - t0:.1f} s "
          f"(render_scale {args.render_scale}, estimator {args.estimator}, "
          f"gnet {os.path.relpath(args.gnet, HERE)})", flush=True)
    print(out)
    return 0 if out else 1


if __name__ == "__main__":
    sys.exit(main())
