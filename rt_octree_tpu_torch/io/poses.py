"""Camera pose loading for blender / TanksAndTemples / LLFF datasets.

The port's own copy of rt_octree_tpu/io/poses.py (NumPy).
Reference: renderer/main_headless.cpp:251-390 (pose loaders + camera
convention transforms), :64-105 (txt matrix / intrinsics readers),
:144-188 (LLFF pose averaging and recentering).

All loaders return (poses, basenames, intrinsics) where poses is
[n, 3, 4] float32 c2w with columns [right, up, back, center] and
intrinsics is a dict with width/height/fx/fy.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class PoseSet:
    poses: np.ndarray  # [n, 3, 4]
    basenames: List[str]
    width: int
    height: int
    fx: float
    fy: float
    dataset_type: str = "blender"


def load_blender(poses_path: str, width: int = 800, height: int = 800) -> PoseSet:
    """transforms_{split}.json (main_headless.cpp:255-272)."""
    with open(poses_path) as f:
        meta = json.load(f)
    fx = fy = 0.5 * width / np.tan(0.5 * float(meta["camera_angle_x"]))
    poses, basenames = [], []
    for i, frame in enumerate(meta["frames"]):
        m = np.asarray(frame["transform_matrix"], np.float32)
        poses.append(m[:3, :4])
        basenames.append(f"r_{i}")
    return PoseSet(np.stack(poses), basenames, width, height, float(fx),
                   float(fy), "blender")


def read_transform_matrices(path: str) -> np.ndarray:
    """One or more whitespace 4x4 (or 3x4) c2w matrices from a txt file
    (main_headless.cpp:64-92)."""
    vals = np.loadtxt(path).reshape(-1)
    mats = []
    # the reference reads rows of 4 floats; 4th row (0001) is consumed
    per = 16 if vals.size % 16 == 0 else 12
    for off in range(0, vals.size, per):
        m = vals[off:off + per].reshape(-1, 4)[:3, :4]
        mats.append(m.astype(np.float32))
    return np.stack(mats)


def read_intrins(path: str) -> tuple[float, float]:
    """intrinsics.txt: fx at [0], fy at [5] (main_headless.cpp:94-105)."""
    vals = np.loadtxt(path).reshape(-1)
    return float(vals[0]), float(vals[5])


def load_tt(pose_dir: str, width: int = 1920, height: int = 1080) -> PoseSet:
    """TanksAndTemples: directory of per-image pose txts + ../intrinsics.txt
    (main_headless.cpp:273-297)."""
    intrin_path = os.path.join(pose_dir, "..", "intrinsics.txt")
    fx, fy = read_intrins(intrin_path)
    poses, basenames = [], []
    for entry in sorted(os.listdir(pose_dir)):
        path = os.path.join(pose_dir, entry)
        if not os.path.isfile(path):
            continue
        mats = read_transform_matrices(path)
        fname = os.path.splitext(entry)[0]
        if len(mats) == 1:
            basenames.append(fname)
        else:
            basenames.extend(f"{fname}_{i:06d}" for i in range(len(mats)))
        poses.extend(mats)
    return PoseSet(np.stack(poses), basenames, width, height, fx, fy, "tt")


def _viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    y /= np.linalg.norm(y)
    return np.stack([x, y, z, pos], axis=1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """Average c2w (main_headless.cpp:153-174)."""
    z_avg = poses[:, :, 2].sum(0) / len(poses)
    up_avg = poses[:, :, 1].sum(0) / len(poses)
    cen_avg = poses[:, :, 3].sum(0) / len(poses)
    return _viewmatrix(z_avg, up_avg, cen_avg)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """pose <- inv(avg) @ pose (main_headless.cpp:176-188)."""
    avg = np.eye(4, dtype=np.float64)
    avg[:3, :4] = poses_avg(poses)
    inv = np.linalg.inv(avg)
    out = []
    for p in poses:
        p4 = np.eye(4)
        p4[:3, :4] = p
        out.append((inv @ p4)[:3, :4].astype(np.float32))
    return np.stack(out)


def load_llff(poses_bounds_path: str, factor: int = 4,
              images_dir: Optional[str] = None) -> PoseSet:
    """LLFF poses_bounds.npy (main_headless.cpp:298-370): axis-swizzle
    [down,right,back] -> [right,up,back], translation rescale by
    1/(bds_min*0.75), then recentering about the average pose."""
    pb = np.load(poses_bounds_path).astype(np.float64).reshape(-1, 17)
    width = int(pb[0, 9] / factor)
    height = int(pb[0, 4] / factor)
    fx = fy = float(pb[0, 14] / factor)
    bds_min = pb[:, 15].min()
    scale = 1.0 / (bds_min * 0.75)

    poses = []
    for row in pb:
        m = row[:15].reshape(3, 5)[:, :4]
        # m columns: [down, right, back, center]; cam_trans swizzle at
        # main_headless.cpp:327-346 gives [right, -down, back, center]
        m = np.stack([m[:, 1], -m[:, 0], m[:, 2], m[:, 3]], axis=1)
        m[:, 3] *= scale
        poses.append(m.astype(np.float32))
    poses = recenter_poses(np.stack(poses))

    basenames = []
    if images_dir is None:
        root = os.path.dirname(os.path.abspath(poses_bounds_path))
        images_dir = os.path.join(
            root, f"images_{factor}" if factor > 1 else "images")
    if os.path.isdir(images_dir):
        basenames = sorted(
            os.path.splitext(f)[0] for f in os.listdir(images_dir)
            if os.path.isfile(os.path.join(images_dir, f)))
    if len(basenames) != len(poses):
        basenames = [f"{i:06d}" for i in range(len(poses))]
    return PoseSet(poses, basenames, width, height, fx, fy, "llff")


OPENCV_FLIP = np.diag([1.0, -1.0, -1.0]).astype(np.float32)


def apply_opencv_convention(poses: np.ndarray) -> np.ndarray:
    """Negate up and back columns: transform @ diag(1,-1,-1,1)
    (main_headless.cpp:373-384)."""
    out = poses.copy()
    out[:, :, 1] *= -1
    out[:, :, 2] *= -1
    return out


def load_poses(dataset_type: str, poses_path: str, width: int = 800,
               height: int = 800, reverse_yz: bool = False) -> PoseSet:
    """Dispatch + convention handling as in main_headless.cpp:251-390."""
    if dataset_type == "blender":
        ps = load_blender(poses_path, width, height)
    elif dataset_type == "tt":
        ps = load_tt(poses_path)
    elif dataset_type == "llff":
        ps = load_llff(poses_path)
    else:
        raise ValueError(f"unknown dataset type: {dataset_type}")

    if dataset_type == "tt" or reverse_yz:
        ps.poses = apply_opencv_convention(ps.poses)
    return ps
