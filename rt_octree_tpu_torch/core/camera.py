"""Camera model: the c2w pose the renderer consumes.

The port's own copy of the pose part of rt_octree_tpu/core/camera.py
(NumPy).  Reference: renderer/src/camera.cpp:26-76 (transform
orthonormalization, default pose), camera.hpp:12 (default focal 1111.11).
The interactive drag/pan state machine belongs to the viewer, which the port
does not have yet; per-pixel rays are computed on the device
(render/renderer.py:device_camera_rays and kernel K1).

The camera-to-world transform is stored as a 3x4 float32 matrix whose
columns are [right, up, back, center] -- identical layout to the glm
mat4x3 uploaded to the GPU as 12 floats.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_FOCAL_LENGTH = 1111.11


@dataclasses.dataclass
class Camera:
    width: int = 800
    height: int = 800
    fx: float = DEFAULT_FOCAL_LENGTH
    fy: float = -1.0
    # c2w: columns right, up, back, center
    transform: np.ndarray = None
    center: np.ndarray = None
    v_back: np.ndarray = None
    v_world_up: np.ndarray = None
    origin: np.ndarray = None
    movement_speed: float = 1.0
    v_right: np.ndarray = None
    v_up: np.ndarray = None

    def __post_init__(self):
        if self.fx < 0:
            self.fx = DEFAULT_FOCAL_LENGTH
        if self.fy < 0:
            self.fy = self.fx
        if self.center is None:
            self.center = np.array([-3.55, 0.0, 3.55], np.float32)
        if self.v_back is None:
            self.v_back = np.array([-0.7071068, 0.0, 0.7071068], np.float32)
        if self.v_world_up is None:
            self.v_world_up = np.array([0.0, 0.0, 1.0], np.float32)
        if self.origin is None:
            self.origin = np.zeros(3, np.float32)
        if self.transform is None:
            self.update()

    def update(self, transform_from_vecs: bool = True) -> None:
        """Rebuild c2w from {center, v_back, v_world_up} (camera.cpp:47-56)."""
        if transform_from_vecs:
            back = self.v_back / np.linalg.norm(self.v_back)
            right = np.cross(self.v_world_up, back)
            right = right / np.linalg.norm(right)
            up = np.cross(back, right)
            self.v_back, self.v_right, self.v_up = (
                back.astype(np.float32), right.astype(np.float32),
                up.astype(np.float32))
            self.transform = np.stack(
                [right, up, back, self.center], axis=1).astype(np.float32)

    def set_pose(self, c2w: np.ndarray) -> None:
        """Set the full 3x4 c2w pose (columns right/up/back/center)."""
        c2w = np.asarray(c2w, np.float32)
        if c2w.shape == (4, 4):
            c2w = c2w[:3, :]
        if c2w.shape != (3, 4):
            raise ValueError(f"pose must be 3x4 or 4x4, got {c2w.shape}")
        self.transform = np.ascontiguousarray(c2w)
        self.center = self.transform[:, 3].copy()
        self.v_back = self.transform[:, 2].copy()
        self.v_right = self.transform[:, 0].copy()
        self.v_up = self.transform[:, 1].copy()

    @property
    def w2c(self) -> np.ndarray:
        R = self.transform[:, :3]
        t = self.transform[:, 3]
        out = np.zeros((3, 4), np.float32)
        out[:, :3] = R.T
        out[:, 3] = -R.T @ t
        return out
