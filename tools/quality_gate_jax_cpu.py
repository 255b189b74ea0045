#!/usr/bin/env python3
"""The JAX package's quality gate for the headline frame, on the CPU.

Run from the repository root:  python tools/quality_gate_jax_cpu.py

Renders the headline configuration (depth-9 SH9 shell tree, level-9 LUT
with skip distances, 800x800, SPP 6, benchmarks/quality/trained.gnet)
through rt_octree_tpu on the CPU and scores it with bench.quality_report:
per pose rng.seed(20230418, 1), noisy then denoised, PSNR against the
committed GT PNGs of the 8 held-out poses.  These are the bars that
chip_smoke.py holds the port to.  Needs about 6 GB of host memory; the
frames take a few seconds each after the first two compiles.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import bench
    from rt_octree_tpu.core.camera import Camera
    from rt_octree_tpu.core.options import RenderOptions
    from rt_octree_tpu.io import synthetic
    from rt_octree_tpu.ops.traversal import upload_tree
    from rt_octree_tpu.render.renderer import Renderer

    kit = os.path.join(HERE, "benchmarks", "quality")
    t0 = time.time()
    tree = synthetic.make_synthetic_tree("shell", depth=9, basis_dim=9)
    dt = upload_tree(tree, lut_levels=9)
    print(f"tree {tree.capacity} nodes built and uploaded in "
          f"{time.time() - t0:.1f} s", flush=True)
    opt = RenderOptions(spp=6, denoise=True, step_size=1e-4,
                        sigma_thresh=1e-2, background_brightness=1.0)
    cam = Camera(width=800, height=800)
    r = Renderer(dt, 800, 800, cam.fx, cam.fy, options=opt)
    r.set_denoiser(os.path.join(kit, "trained.gnet"))
    t0 = time.time()
    out = bench.quality_report(r, [kit], "jax-cpu")
    print(f"16 frames scored in {time.time() - t0:.1f} s", flush=True)
    print(out)
    return 0 if out else 1


if __name__ == "__main__":
    sys.exit(main())
