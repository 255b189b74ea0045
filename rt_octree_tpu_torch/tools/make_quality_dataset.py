"""Build a denoiser training kit on the card from the shell scene (the
counterpart of tools/make_quality_dataset.py:63-230, shell only).

For seeded orbit poses over the depth-9 SH9 shell tree it renders:
  * noisy SPP 6 aux buffers (``Renderer.render`` with denoise off; the
    f32 [8, H, W] ``buf_<name>.bin`` of --write_buffer,
    main_headless.cpp:512-523), and
  * converged ground truth from the classic exponential-transmittance
    estimator (``max_steps=16384``), written as 8-bit PNG.

The layout is the blender one that train/dataset.py reads
(``transforms_{split}.json``, ``{split}/r_i.png``,
``spp_6/{split}/buf_r_i.bin``), so ``rtoctree train --config
configs/blender.txt --data_dir OUT`` runs the canonical protocol on it.
The poses are the JAX tool's: ``np.random.default_rng(7)``, per pose an
azimuth in [0, 2 pi) and an elevation in [-25, 65] degrees, the camera at
radius 5.02 looking at the origin; train poses first, then test.  The
noisy renderer's PCG32 stream advances once per frame across both splits.
Train buffers are written in f32 (the JAX tool rounds them to f16 by
default to save link bandwidth; here nothing crosses a link).

    python -m rt_octree_tpu_torch.tools.make_quality_dataset --out DIR \\
        [--tree TREE.npz] [--n_train 32] [--n_test 8] [--res 800] \\
        [--device cuda]

Without ``--tree`` the headline tree is generated (``make_synthetic_tree
("shell", depth=9, basis_dim=9)``, as bench.py's get_tree).
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


def orbit_pose(azim: float, elev: float, width: int, height: int,
               radius: float = 5.02) -> Camera:
    c = radius * np.array([np.cos(elev) * np.cos(azim),
                           np.cos(elev) * np.sin(azim),
                           np.sin(elev)], np.float32)
    return Camera(width=width, height=height, center=c,
                  v_back=c / np.linalg.norm(c))


def kit_poses(n_train: int, n_test: int, width: int, height: int) -> dict:
    """split -> cameras, drawn in the JAX tool's order."""
    rng = np.random.default_rng(7)
    poses = {}
    for split, n in (("train", n_train), ("test", n_test)):
        poses[split] = []
        for _ in range(n):
            azim = rng.uniform(0, 2 * np.pi)
            elev = rng.uniform(np.deg2rad(-25), np.deg2rad(65))
            poses[split].append(orbit_pose(azim, elev, width, height))
    return poses


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("make_quality_dataset")
    p.add_argument("--out", required=True, help="kit directory")
    p.add_argument("--tree", default="",
                   help="tree npz (default: generate the depth-9 SH9 shell)")
    p.add_argument("--n_train", type=int, default=32)
    p.add_argument("--n_test", type=int, default=8)
    p.add_argument("--res", type=int, default=800)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    t0 = time.time()
    tree = (n3tree.load(args.tree) if args.tree else
            synthetic.make_synthetic_tree("shell", depth=9, basis_dim=9))
    dt = upload_tree(tree, lut_levels=min(9, tree.max_depth), device=dev)
    W = H = args.res
    poses = kit_poses(args.n_train, args.n_test, W, H)
    print(f"tree {tree.capacity} nodes, depth {tree.max_depth} "
          f"({time.time() - t0:.1f} s); {W}x{H} on {dev}", flush=True)

    cam0 = poses["train"][0]
    r_noisy = Renderer(dt, W, H, cam0.fx, cam0.fy,
                       options=RenderOptions(spp=SPP, denoise=False))
    r_gt = Renderer(dt, W, H, cam0.fx, cam0.fy,
                    options=RenderOptions(spp=1, denoise=False,
                                          estimator="classic"),
                    max_steps=GT_MAX_STEPS)
    for split in ("train", "test"):
        os.makedirs(os.path.join(args.out, split), exist_ok=True)
        os.makedirs(os.path.join(args.out, f"spp_{SPP}", split),
                    exist_ok=True)
        frames = []
        for i, cam in enumerate(poses[split]):
            name = f"r_{i}"
            _, aux = r_noisy.render(cam.transform)
            r_noisy.advance_rng()
            aux = aux.cpu().numpy().astype(np.float32)
            aux.tofile(os.path.join(args.out, f"spp_{SPP}", split,
                                    f"buf_{name}.bin"))
            img_gt, _ = r_gt.render(cam.transform, want_aux=False)
            rgb = img_gt[..., :3].cpu().numpy()
            write_png(os.path.join(args.out, split, f"{name}.png"),
                      to_uint8(rgb))
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :] = cam.transform
            frames.append({"file_path": f"./{split}/{name}",
                           "transform_matrix": c2w.tolist()})
            print(f"[{split} {i + 1}/{len(poses[split])}] "
                  f"gt_mean={float(rgb.mean()):.4f} "
                  f"noisy_alpha_max={float(aux[3].max()):.3f}", flush=True)
        with open(os.path.join(args.out, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": 2 * np.arctan(W / (2 * cam0.fx)),
                       "frames": frames}, f)
    print(f"DONE in {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
