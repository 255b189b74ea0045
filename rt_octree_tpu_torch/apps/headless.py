"""Headless offline renderer / FPS benchmark CLI on the port.

Counterpart of rt_octree_tpu/apps/headless.py (reference:
renderer/main_headless.cpp): load poses by dataset type, load the tree,
warm up, render every pose with per-phase timing, optionally write PNGs
(``-o``) or raw aux buffers (``--write_buffer``: ``buf_<name>.bin``, f32
[8, H, W], byte-compatible with the JAX package's dumps), advance the RNG
by 2^32 between frames, and print the per-phase report.

Usage:
  python -m rt_octree_tpu_torch.apps.headless TREE.npz POSES \
      [--dataset blender|tt|llff] [-o OUTDIR] [--write_buffer] \
      [--gnet net.gnet] [--options opt.json] [--spp N] [--device cuda] ...

Flags of the JAX CLI that the port does not cover yet (mesh drawlists,
grid, probe, classic estimator, profiler, schedule tuning, fast mode) exit
non-zero with "not yet ported".
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from rt_octree_tpu.core.camera import Camera
from rt_octree_tpu.core.options import RenderOptions
from rt_octree_tpu.io import n3tree
from rt_octree_tpu.io.poses import load_poses

from ..io.png import write_png
from ..ops.traversal import upload_tree
from ..render.renderer import Renderer, render_timed
from ..utils.timer import PhaseTimer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "rtoctree-headless-torch",
        description="Headless PlenOctree regular-tracking renderer "
                    "(PyTorch + CUDA)")
    p.add_argument("file", help="npz file storing octree data")
    p.add_argument("poses", help="pose source: transforms json (blender), "
                   "pose txt dir (tt), or poses_bounds.npy (llff)")
    p.add_argument("-o", "--write_images", default="",
                   help="output directory of images; if empty, DOES NOT "
                        "save (for timing only)")
    p.add_argument("-i", "--intrin", default="",
                   help="intrinsics 4x4 txt; overrides fx/fy")
    p.add_argument("-r", "--reverse_yz", action="store_true",
                   help="use OpenCV camera convention instead of NeRF")
    p.add_argument("--scale", type=float, default=1.0,
                   help="scaling to apply to image")
    p.add_argument("--max_imgs", type=int, default=0,
                   help="max images to render")
    p.add_argument("--options", default="", help="render options json")
    p.add_argument("--dataset", default="blender",
                   choices=["blender", "tt", "llff"])
    p.add_argument("--gnet", "--ts_module", dest="gnet", default="",
                   help="path to compact GuidanceNet (.gnet) artifact")
    p.add_argument("--write_buffer", action="store_true",
                   help="save auxiliary buffers instead of images")
    p.add_argument("-w", "--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--fx", type=float, default=-1.0)
    p.add_argument("--fy", type=float, default=-1.0)
    p.add_argument("--bg", type=float, default=1.0)
    p.add_argument("-s", "--step_size", type=float, default=1e-4)
    p.add_argument("-e", "--stop_thresh", type=float, default=1e-2)
    p.add_argument("-a", "--sigma_thresh", type=float, default=1e-2)
    p.add_argument("--spp", type=int, default=None,
                   help="override spp from options")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--denoise-auto", action="store_true",
                   help="honor the .gnet artifact's denoise_recommended "
                        "advice")
    p.add_argument("--warmup", type=int, default=100,
                   help="warm-up frame count (reference uses 100)")
    p.add_argument("--lut_levels", type=int, default=7)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    return p


def run(argv: Optional[Sequence[str]] = None) -> int:
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        print(f"not yet ported: {' '.join(unknown)} (the port's headless "
              "CLI covers the flags listed by --help)", file=sys.stderr)
        return 2

    ps = load_poses(args.dataset, args.poses, width=args.width,
                    height=args.height, reverse_yz=args.reverse_yz)
    width, height, fx, fy = ps.width, ps.height, ps.fx, ps.fy
    if args.fx > 0:
        fx = args.fx
        fy = args.fy if args.fy > 0 else fx
    if args.intrin:
        vals = np.loadtxt(args.intrin).reshape(-1)
        fx, fy = float(vals[0]), float(vals[5])

    tree = n3tree.load(args.file)
    if args.dataset == "llff":
        tree.use_ndc = True
        tree.ndc_width = width
        tree.ndc_height = height
        tree.ndc_focal = fx

    if args.scale != 1.0:
        ow, oh = width, height
        width = int(width * args.scale)
        height = int(height * args.scale)
        fx *= width / ow
        fy *= height / oh

    poses = ps.poses
    basenames = ps.basenames
    if args.max_imgs > 0:
        poses = poses[:args.max_imgs]
        basenames = basenames[:args.max_imgs]
    if len(poses) == 0:
        print("WARNING: No camera poses specified, quitting", file=sys.stderr)
        return 1

    if args.options:
        options = RenderOptions.from_json_file(args.options)
    else:
        options = RenderOptions(
            background_brightness=args.bg, step_size=args.step_size,
            stop_thresh=args.stop_thresh, sigma_thresh=args.sigma_thresh)
    if args.spp is not None:
        options.spp = args.spp
    if args.no_denoise or not args.gnet:
        options.denoise = False

    device = torch.device(args.device)
    dt = upload_tree(tree, lut_levels=args.lut_levels, device=device)
    renderer = Renderer(dt, width, height, fx, fy, options=options)
    if args.gnet:
        renderer.set_denoiser(args.gnet)
        if (args.denoise_auto and options.denoise
                and not renderer.denoise_recommended):
            print("[rtoctree] .gnet advises denoise off for this scene "
                  "(measured quality loss); honoring --denoise-auto",
                  file=sys.stderr)
            options.denoise = False

    out_dir = args.write_images
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    # warm-up (main_headless.cpp:470-479)
    timer = PhaseTimer(device)
    cam = Camera(width, height, fx, fy)
    cam.set_pose(poses[0])
    for _ in range(args.warmup):
        render_timed(renderer, cam.transform, timer)
        renderer.advance_rng()
    timer.means_ms()  # drain the warm-up events before the reset
    timer.reset()

    for i, pose in enumerate(poses):
        cam.set_pose(pose)
        img, aux = render_timed(renderer, cam.transform, timer)
        renderer.advance_rng()
        if not out_dir:
            continue
        if args.write_buffer:
            buf = aux.cpu().numpy().astype(np.float32)
            buf.tofile(os.path.join(out_dir, f"buf_{basenames[i]}.bin"))
        else:
            write_png(os.path.join(out_dir, f"{basenames[i]}.png"),
                      img.cpu().numpy())

    print(timer.report())
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
