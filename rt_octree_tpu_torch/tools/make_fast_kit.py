"""Build a fast-mode denoiser training kit by distillation on the card (the
counterpart of tools/make_fast_kit.py).

The kit's

  * inputs are fast-mode aux buffers: the student marches at
    ``--fast_scale`` of the output size (K1) and K4 joint-upsamples its
    image and aux to the output size, denoise off (what the fast path
    feeds the net); with ``--lod D`` it marches ``io/lod.build_lod(tree,
    D)``, the llff interactive rung's tree;
  * train targets are TEACHER frames: the full-size pipeline (SPP 6, K1,
    then K7 and K2 with ``<gt_kit>/trained.gnet``), with denoise off when
    that net's ``denoise_recommended`` says so.

The test split is not distilled: it takes the committed real-GT kit's
poses and copies its GT PNGs byte for byte, with student buffers rendered
under ``rng.seed(20230418, 1)`` per pose (bench.quality_report's seed),
so its numbers are the quality gate's.  Teacher and student run SPP 6,
``step_size=1e-4``, ``sigma_thresh=1e-2`` and background 1.0; each
advances its PCG32 stream after each of its frames.  Train poses come
from ``np.random.default_rng(20230418)``: orbit poses as
make_quality_dataset's, and for blobs a forward pose whose view direction
(x, y) is drawn before its centre (x, y, z), the JAX tool's order.
Every buffer is f32 [8, H, W] at the output size.

Layout (train/dataset.py's blender reader):

    OUT/transforms_{train,test}.json
    OUT/{train,test}/r_*.png         teacher (train) / real GT (test)
    OUT/spp_6/{train,test}/buf_*.bin fast-mode aux dumps

    python -m rt_octree_tpu_torch.tools.make_fast_kit --out DIR \\
        [--scene shell|solid|tt|blobs] [--fast_scale 0.5] [--lod D] \\
        [--gt_kit benchmarks/quality_<scene>] [--splits train,test] \\
        [--n_train 32] [--res 800] [--scale 1] [--tree TREE.npz | \\
        --depth 9] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from ..core.camera import Camera
from ..core.options import RenderOptions
from ..io.lod import build_lod
from ..ops.traversal import upload_tree
from ..render.renderer import Renderer
from . import make_quality_dataset as mq

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TEST_SEED = (20230418, 1)  # bench.quality_report's per-pose seed


def default_gt_kit(scene: str) -> str:
    return os.path.join(REPO, "benchmarks", "quality" if scene == "shell"
                        else f"quality_{scene}")


def kit_options(denoise: bool) -> RenderOptions:
    return RenderOptions(spp=mq.SPP, denoise=denoise, step_size=1e-4,
                         sigma_thresh=1e-2, background_brightness=1.0)


def train_poses(scene: str, n: int, width: int, height: int,
                focal=None) -> list:
    """The train split's cameras, drawn in the JAX tool's order."""
    rng = np.random.default_rng(20230418)
    poses = []
    for _ in range(n):
        if scene == "blobs":
            tx, ty = rng.uniform(-0.08, 0.08), rng.uniform(-0.08, 0.08)
            jx, jy = rng.uniform(-0.2, 0.2), rng.uniform(-0.15, 0.15)
            jz = rng.uniform(0.15, 0.45)
            poses.append(mq.forward_pose(jx, jy, jz, tx, ty, width, height,
                                         focal))
        else:
            azim = rng.uniform(0, 2 * np.pi)
            elev = rng.uniform(np.deg2rad(-25), np.deg2rad(65))
            poses.append(mq.orbit_pose(azim, elev, width, height, focal))
    return poses


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("make_fast_kit")
    p.add_argument("--out", required=True, help="kit directory")
    p.add_argument("--scene", default="shell", choices=mq.SCENES)
    p.add_argument("--fast_scale", type=float, default=0.5)
    p.add_argument("--n_train", type=int, default=32)
    p.add_argument("--res", type=int, default=800,
                   help="frame size of shell and solid")
    p.add_argument("--scale", type=float, default=1.0,
                   help="shrink every frame size and focal")
    p.add_argument("--splits", default="train,test")
    p.add_argument("--lod", type=int, default=0,
                   help="the student marches the tree pooled to this depth")
    p.add_argument("--gt_kit", default="",
                   help="real-GT kit with trained.gnet (default: "
                        "benchmarks/quality for the shell, else "
                        "benchmarks/quality_<scene>)")
    p.add_argument("--tree", default="",
                   help="tree npz (default: generate the scene's SH9 tree "
                        "at --depth)")
    p.add_argument("--depth", type=int, default=9)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    splits = mq.parse_splits(args.splits)
    gt_kit = args.gt_kit or default_gt_kit(args.scene)
    dev = torch.device(args.device)
    t0 = time.time()
    W, H, focal = mq.scene_frame(args.scene, args.res, args.scale)
    tree = mq.load_tree(args.scene, args.tree, args.depth, W, H, focal)
    dt = upload_tree(tree, lut_levels=min(9, tree.max_depth), device=dev)
    print(f"scene {args.scene}, scale {args.fast_scale}, {W}x{H}, out "
          f"{args.out}, GT kit {gt_kit}; on {dev}", flush=True)
    if args.lod:
        # the teacher stays full-depth: the quality anchor does not move
        tree_s = build_lod(tree, args.lod)
        dt_s = upload_tree(tree_s, lut_levels=min(9, tree_s.max_depth),
                           device=dev)
        print(f"[fastkit] student tree: LOD depth {args.lod} "
              f"({tree_s.capacity} nodes)", flush=True)
    else:
        dt_s = dt
    cam0 = Camera(width=W, height=H, **mq.focal_kw(focal))

    teacher = Renderer(dt, W, H, cam0.fx, cam0.fy, options=kit_options(True))
    teacher.set_denoiser(os.path.join(gt_kit, "trained.gnet"))
    if not teacher.denoise_recommended:
        # the kit's net advises against filtering (hard surfaces near
        # convergence at SPP 6): the teacher is the advised configuration
        teacher.options.denoise = False
        print("[fastkit] teacher denoise OFF (kit advice)", flush=True)
    student = Renderer(dt_s, W, H, cam0.fx, cam0.fy,
                       options=kit_options(False),
                       render_scale=args.fast_scale)

    def dump(split, name, transform, gt_png=None):
        """The student's buffer for one pose, and its target: the
        teacher's frame, or a copy of the real-GT PNG ``gt_png``."""
        _, aux = student.render(transform)
        student.advance_rng()
        mq.write_buffer(args.out, split, name, aux)
        png = os.path.join(args.out, split, f"{name}.png")
        if gt_png is None:
            img_t, _ = teacher.render(transform, want_aux=False)
            teacher.advance_rng()
            mq.write_frame(png, img_t)
        else:
            shutil.copyfile(gt_png, png)

    if "train" in splits:
        mq.make_dirs(args.out, "train")
        frames = []
        for i, cam in enumerate(train_poses(args.scene, args.n_train, W, H,
                                            focal)):
            dump("train", f"r_{i}", cam.transform)
            frames.append(mq.frame_entry("train", f"r_{i}", cam.transform))
            print(f"[train {i + 1}/{args.n_train}]", flush=True)
        with open(os.path.join(args.out, "transforms_train.json"), "w") as f:
            json.dump({"camera_angle_x": 2 * np.arctan(W / (2 * cam0.fx)),
                       "frames": frames}, f)

    if "test" in splits:
        mq.make_dirs(args.out, "test")
        with open(os.path.join(gt_kit, "transforms_test.json")) as f:
            tj = json.load(f)
        for i, fr in enumerate(tj["frames"]):
            name = os.path.basename(fr["file_path"])
            pose = np.asarray(fr["transform_matrix"], np.float32)[:3]
            student.rng.seed(*TEST_SEED)
            dump("test", name, pose,
                 gt_png=os.path.join(gt_kit, "test", f"{name}.png"))
            print(f"[test {i + 1}/{len(tj['frames'])}]", flush=True)
        with open(os.path.join(args.out, "transforms_test.json"), "w") as f:
            json.dump(tj, f)
    print(f"DONE in {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
