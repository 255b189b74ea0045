"""Build a denoiser quality kit on the card (the counterpart of
tools/make_quality_dataset.py:14-213).

For seeded poses over a synthetic bench tree it renders:
  * noisy SPP 6 aux buffers (``Renderer.render`` with denoise off; the
    f32 [8, H, W] ``buf_<name>.bin`` of --write_buffer,
    main_headless.cpp:512-523), and
  * converged ground truth from the classic exponential-transmittance
    estimator (``max_steps=16384``), written as 8-bit PNG.

Scenes (``--scene``): ``shell`` (the headline bench scene) and ``solid``
(its hard-surface companion) at ``--res`` square with the Camera's
default focal; ``tt``, the solid tree at TanksAndTemples' 1920x1080,
focal 1158; ``blobs``, the LLFF scene: forward-facing poses and the NDC
warp at 1008x756, focal 800.  ``--scale`` shrinks every size and focal
(truncated to int, as the JAX tool).  The tree is ``--tree`` or
``make_synthetic_tree(kind, depth=--depth, basis_dim=9)`` (bench.py's
get_tree); ``tt`` uses the solid tree.

The layout is the blender one that train/dataset.py reads
(``transforms_{split}.json``, ``{split}/r_i.png``,
``spp_6/{split}/buf_r_i.bin``), so ``rtoctree train --config
configs/blender.txt --data_dir OUT`` runs the canonical protocol on it.
``--gt_only`` renders the ground truth alone (the test split alone by
default) and writes no ``spp_6/`` directory: the kit that the quality
gates read.  The poses are the JAX tool's: ``np.random.default_rng(7)``,
train poses first, then test; an orbit pose draws an azimuth in [0, 2 pi)
and an elevation in [-25, 65] degrees and looks at the origin from
radius 5.02, a forward pose draws a centre (x, y, z) and a view
direction's (x, y).  The committed kits benchmarks/quality_solid,
quality_tt and quality_blobs were drawn with 16 train poses
(``--n_train 16``), benchmarks/quality with 32: their test poses are
this tool's.  The noisy renderer's PCG32 stream advances once per frame
across both splits.  Buffers are written in f32 in both splits (the JAX
tool rounds train buffers to f16 by default to save link bandwidth; here
nothing crosses a link).

    python -m rt_octree_tpu_torch.tools.make_quality_dataset --out DIR \\
        [--scene shell|solid|tt|blobs] [--gt_only] [--splits train,test] \\
        [--tree TREE.npz | --depth 9] [--n_train 32] [--n_test 8] \\
        [--res 800] [--scale 1] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..core.camera import Camera
from ..core.options import RenderOptions
from ..io import n3tree, synthetic
from ..io.png import to_uint8, write_png
from ..ops.traversal import upload_tree
from ..render.renderer import Renderer

SPP = 6
GT_MAX_STEPS = 16384
SCENES = ("shell", "solid", "tt", "blobs")


def tree_kind(scene: str) -> str:
    """The synthetic tree a scene renders: tt is the solid tree."""
    return {"tt": "solid"}.get(scene, scene)


def scene_frame(scene: str, res: int, scale: float = 1.0):
    """(width, height, focal or None for the Camera's default) of a scene,
    truncated to int as the JAX tool does."""
    if scene == "blobs":  # the canonical LLFF factor-4 resolution
        return int(1008 * scale), int(756 * scale), 800.0 * scale
    if scene == "tt":  # bench.py tt_scene_fps
        return int(1920 * scale), int(1080 * scale), 1158.0 * scale
    return int(res * scale), int(res * scale), None


def load_tree(scene: str, path: str = "", depth: int = 9,
              width: int = 0, height: int = 0, focal=None) -> n3tree.N3Tree:
    """The scene's host tree (``path`` or the synthetic depth-``depth`` SH9
    tree); blobs gets the NDC warp of its frame, set before the upload."""
    tree = (n3tree.load(path) if path else synthetic.make_synthetic_tree(
        tree_kind(scene), depth=depth, basis_dim=9))
    if scene == "blobs":
        tree.use_ndc = True
        tree.ndc_width = float(width)
        tree.ndc_height = float(height)
        tree.ndc_focal = focal
    return tree


def focal_kw(focal) -> dict:
    return {"fx": focal, "fy": focal} if focal else {}


def orbit_pose(azim: float, elev: float, width: int, height: int,
               focal=None, radius: float = 5.02) -> Camera:
    c = radius * np.array([np.cos(elev) * np.cos(azim),
                           np.cos(elev) * np.sin(azim),
                           np.sin(elev)], np.float32)
    return Camera(width=width, height=height, center=c,
                  v_back=c / np.linalg.norm(c), **focal_kw(focal))


def forward_pose(jx: float, jy: float, jz: float, tx: float, ty: float,
                 width: int, height: int, focal) -> Camera:
    """LLFF-style forward-facing pose: a small translation jitter and a
    view direction near +z (the capture regime NDC was designed for)."""
    back = np.array([tx, ty, 1.0], np.float32)
    back /= np.linalg.norm(back)
    return Camera(width=width, height=height,
                  center=np.array([jx, jy, jz], np.float32), v_back=back,
                  **focal_kw(focal))


def kit_poses(scene: str, n_train: int, n_test: int, width: int,
              height: int, focal=None) -> dict:
    """split -> cameras, drawn in the JAX tool's order."""
    rng = np.random.default_rng(7)
    poses = {}
    for split, n in (("train", n_train), ("test", n_test)):
        poses[split] = []
        for _ in range(n):
            if scene == "blobs":
                poses[split].append(forward_pose(
                    rng.uniform(-0.2, 0.2), rng.uniform(-0.15, 0.15),
                    rng.uniform(0.15, 0.45), rng.uniform(-0.08, 0.08),
                    rng.uniform(-0.08, 0.08), width, height, focal))
            else:
                azim = rng.uniform(0, 2 * np.pi)
                elev = rng.uniform(np.deg2rad(-25), np.deg2rad(65))
                poses[split].append(orbit_pose(azim, elev, width, height,
                                               focal))
    return poses


def frame_entry(split: str, name: str, transform) -> dict:
    """A frame of transforms_<split>.json: the 4x4 c2w of a [3, 4] pose."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :] = transform
    return {"file_path": f"./{split}/{name}",
            "transform_matrix": c2w.tolist()}


def write_buffer(out: str, split: str, name: str, aux) -> np.ndarray:
    """aux [8, H, W] -> ``out/spp_6/<split>/buf_<name>.bin`` in f32."""
    aux = aux.cpu().numpy().astype(np.float32)
    aux.tofile(os.path.join(out, f"spp_{SPP}", split, f"buf_{name}.bin"))
    return aux


def write_frame(path: str, img) -> np.ndarray:
    """A frame's rgb [H, W, 3] as ``to_uint8`` PNG; returns the float rgb."""
    rgb = img[..., :3].cpu().numpy()
    write_png(path, to_uint8(rgb))
    return rgb


def make_dirs(out: str, split: str, buffers: bool = True) -> None:
    os.makedirs(os.path.join(out, split), exist_ok=True)
    if buffers:
        os.makedirs(os.path.join(out, f"spp_{SPP}", split), exist_ok=True)


def parse_splits(text: str) -> list:
    return [s for s in text.split(",") if s]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("make_quality_dataset")
    p.add_argument("--out", required=True, help="kit directory")
    p.add_argument("--scene", default="shell", choices=SCENES)
    p.add_argument("--tree", default="",
                   help="tree npz (default: generate the scene's SH9 tree "
                        "at --depth)")
    p.add_argument("--depth", type=int, default=9)
    p.add_argument("--gt_only", action="store_true",
                   help="render the ground truth alone: no spp_6/ buffers")
    p.add_argument("--splits", default=None,
                   help="comma list (default: test with --gt_only, else "
                        "train,test)")
    p.add_argument("--n_train", type=int, default=32)
    p.add_argument("--n_test", type=int, default=8)
    p.add_argument("--res", type=int, default=800,
                   help="frame size of shell and solid")
    p.add_argument("--scale", type=float, default=1.0,
                   help="shrink every frame size and focal")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    splits = parse_splits(args.splits if args.splits is not None else
                          "test" if args.gt_only else "train,test")
    if args.gt_only and "train" in splits:
        print("[warn] --gt_only with a 'train' split renders converged-GT "
              "train frames that have no aux buffers and cannot train a "
              "net", file=sys.stderr)
    dev = torch.device(args.device)
    t0 = time.time()
    W, H, focal = scene_frame(args.scene, args.res, args.scale)
    tree = load_tree(args.scene, args.tree, args.depth, W, H, focal)
    dt = upload_tree(tree, lut_levels=min(9, tree.max_depth), device=dev)
    poses = kit_poses(args.scene, args.n_train, args.n_test, W, H, focal)
    print(f"scene {args.scene}, splits {splits}, {W}x{H}, ndc "
          f"{tree.use_ndc}; tree {tree.capacity} nodes, depth "
          f"{tree.max_depth} ({time.time() - t0:.1f} s); on {dev}",
          flush=True)

    cam0 = poses["train"][0] if poses["train"] else poses["test"][0]
    r_noisy = None if args.gt_only else Renderer(
        dt, W, H, cam0.fx, cam0.fy,
        options=RenderOptions(spp=SPP, denoise=False))
    r_gt = Renderer(dt, W, H, cam0.fx, cam0.fy,
                    options=RenderOptions(spp=1, denoise=False,
                                          estimator="classic"),
                    max_steps=GT_MAX_STEPS)
    for split in splits:
        # only a trainable kit carries the noisy aux-buffer directory
        make_dirs(args.out, split, buffers=not args.gt_only)
        frames = []
        for i, cam in enumerate(poses[split]):
            name = f"r_{i}"
            alpha_max = float("nan")
            if r_noisy is not None:
                _, aux = r_noisy.render(cam.transform)
                r_noisy.advance_rng()
                alpha_max = float(write_buffer(args.out, split, name,
                                               aux)[3].max())
            img_gt, _ = r_gt.render(cam.transform, want_aux=False)
            rgb = write_frame(os.path.join(args.out, split, f"{name}.png"),
                              img_gt)
            frames.append(frame_entry(split, name, cam.transform))
            print(f"[{split} {i + 1}/{len(poses[split])}] "
                  f"gt_mean={float(rgb.mean()):.4f} "
                  f"noisy_alpha_max={alpha_max:.3f}", flush=True)
        with open(os.path.join(args.out, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": 2 * np.arctan(W / (2 * cam0.fx)),
                       "frames": frames}, f)
    print(f"DONE in {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
