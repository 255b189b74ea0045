"""Offline data-preparation tools (NumPy; no kernel).

The port's own copy of rt_octree_tpu/apps/tools.py.  Reference:
renderer/scripts/extract_test_poses.py (json -> per-frame 4x4 pose txts +
intrinsics.txt for the headless tt-style loader) and
renderer/scripts/extract_cams_drawlist.py (json -> camera-frustum drawlist
npz consumed by the mesh subsystem).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np


def rotation_matrix_to_rotvec(R: np.ndarray) -> np.ndarray:
    """Batch [n,3,3] rotation matrices -> axis-angle vectors (no scipy
    dependency needed at runtime; matches Rotation.as_rotvec)."""
    tr = np.trace(R, axis1=-2, axis2=-1)
    cos_t = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_t)
    ax = np.stack([R[:, 2, 1] - R[:, 1, 2],
                   R[:, 0, 2] - R[:, 2, 0],
                   R[:, 1, 0] - R[:, 0, 1]], axis=-1)
    sin_t = np.sin(theta)
    small = sin_t < 1e-6
    scale = np.where(small, 0.5, theta / np.maximum(2 * sin_t, 1e-12))
    out = ax * scale[:, None]
    # theta ~ pi needs the symmetric part; rare for camera orbits --
    # fall back per-element
    for i in np.nonzero(small & (cos_t < 0))[0]:
        w, v = np.linalg.eigh(R[i])
        axis = v[:, np.argmin(np.abs(w - 1.0))]
        out[i] = axis * np.pi
    return out


def extract_test_poses(root: str) -> int:
    """For each <root>/*/transforms_test.json, write pose/<name>.txt 4x4
    matrices and intrinsics.txt."""
    n = 0
    for tpath in sorted(glob.glob(os.path.join(root, "*",
                                               "transforms_test.json"))):
        scene_dir = os.path.dirname(tpath)
        poses_dir = os.path.join(scene_dir, "pose")
        os.makedirs(poses_dir, exist_ok=True)
        with open(tpath) as f:
            j = json.load(f)
        for frame in j["frames"]:
            base = os.path.basename(frame["file_path"])
            mtx = np.asarray(frame["transform_matrix"], np.float64)
            np.savetxt(os.path.join(poses_dir, base + ".txt"), mtx)
        half_w = 400
        focal = half_w / np.tan(0.5 * j["camera_angle_x"])
        K = np.diag([focal, focal, 1.0, 1.0])
        K[:2, 2] = [half_w, half_w]
        np.savetxt(os.path.join(scene_dir, "intrinsics.txt"), K)
        n += 1
        print(tpath)
    return n


def extract_cams_drawlist(root: str) -> int:
    """For each <root>/*/transforms_train.json, write a camera-frustum
    drawlist npz (format consumed by io/mesh.py load_drawlist)."""
    n = 0
    for tpath in sorted(glob.glob(os.path.join(root, "*",
                                               "transforms_train.json"))):
        scene_dir = os.path.dirname(tpath)
        out_path = os.path.join(
            scene_dir, os.path.basename(scene_dir) + "_cams.draw.npz")
        with open(tpath) as f:
            j = json.load(f)
        mtx = np.asarray([fr["transform_matrix"] for fr in j["frames"]],
                         np.float64)
        t = mtx[:, :3, 3]
        rvec = rotation_matrix_to_rotvec(mtx[:, :3, :3])
        half_w = 400
        focal = half_w / np.tan(0.5 * j["camera_angle_x"])
        np.savez_compressed(
            out_path,
            cameras="camerafrustum",
            cameras__t=t,
            cameras__r=rvec,
            cameras__focal_length=focal,
            cameras_image_width=half_w * 2,
            cameras_image_height=half_w * 2,
            cameras_z=-0.25,
            cameras_color=np.array([1.0, 0.5, 0.0]))
        n += 1
        print(tpath, "->", out_path)
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser("rtoctree-tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("extract-test-poses")
    sp.add_argument("root")
    sc = sub.add_parser("extract-cams-drawlist")
    sc.add_argument("root")
    args = p.parse_args(argv)
    if args.cmd == "extract-test-poses":
        extract_test_poses(args.root)
    else:
        extract_cams_drawlist(args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
