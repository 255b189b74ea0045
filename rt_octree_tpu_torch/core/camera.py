"""Camera model: the c2w pose the renderer consumes.

The port's own copy of the pose part of rt_octree_tpu/core/camera.py
(NumPy).  Reference: renderer/src/camera.cpp:26-76 (transform
orthonormalization, default pose, the drag/pan/zoom state machine),
camera.hpp:12 (default focal 1111.11).  Per-pixel rays are computed on the
device (render/renderer.py:device_camera_rays and kernel K1).

The camera-to-world transform is stored as a 3x4 float32 matrix whose
columns are [right, up, back, center] -- identical layout to the glm
mat4x3 uploaded to the GPU as 12 floats.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_FOCAL_LENGTH = 1111.11


@dataclasses.dataclass
class _DragState:
    """Saved pose at begin_drag (camera.cpp:14-24)."""
    is_dragging: bool = False
    is_panning: bool = False
    about_origin: bool = False
    start: np.ndarray = None  # [2] mouse xy
    start_back: np.ndarray = None
    start_right: np.ndarray = None
    start_up: np.ndarray = None
    start_center: np.ndarray = None
    start_origin: np.ndarray = None


def _axis_rotation(angle: float, axis: np.ndarray) -> np.ndarray:
    """3x3 rotation about a unit axis (glm::rotate semantics)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    c, s = np.cos(angle), np.sin(angle)
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], np.float64)
    return (c * np.eye(3) + s * K +
            (1.0 - c) * np.outer(axis, axis)).astype(np.float32)


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
        self._drag = _DragState()
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

    # ------------------------------------------------------------------
    # interactive drag/pan/zoom state machine (camera.cpp:78-138)
    # ------------------------------------------------------------------

    def begin_drag(self, x: float, y: float, is_pan: bool,
                   about_origin: bool) -> None:
        """Start a mouse drag, snapshotting the pose (camera.cpp:78-88)."""
        if self.v_right is None or self.v_up is None:
            self.update()
        d = self._drag
        d.is_dragging = True
        d.is_panning = bool(is_pan)
        d.about_origin = bool(about_origin)
        d.start = np.array([x, y], np.float32)
        d.start_back = self.v_back.copy()
        d.start_right = self.v_right.copy()
        d.start_up = self.v_up.copy()
        d.start_center = self.center.copy()
        d.start_origin = self.origin.copy()

    def drag_update(self, x: float, y: float) -> None:
        """Apply the drag at the current mouse position (camera.cpp:89-131).

        Pan translates center (and origin when about_origin) along the
        saved right/up axes; rotate orbits v_back about world-up and the
        saved right axis, with the pole-flip guard, optionally orbiting
        center about ``origin``."""
        d = self._drag
        if not d.is_dragging:
            return
        delta = (np.array([x, y], np.float32) - d.start)
        delta *= -2.0 * self.movement_speed / max(self.width, self.height)
        if d.is_panning:
            shift = delta[0] * d.start_right - delta[1] * d.start_up
            self.center = (d.start_center + shift).astype(np.float32)
            if d.about_origin:
                self.origin = (d.start_origin + shift).astype(np.float32)
            self.transform[:, 3] = self.center  # pure translation: keep frame
            return
        if d.about_origin:
            delta = -delta
        # pole-flip guard: would the tilt cross the world-up pole?
        tilt = _axis_rotation(-delta[1], d.start_right)
        back_tmp = tilt @ d.start_back
        if float(np.dot(np.cross(self.v_world_up, back_tmp),
                        d.start_right)) < 0.0:
            return
        m = (_axis_rotation(np.fmod(-delta[0], 2.0 * np.pi),
                            self.v_world_up) @ tilt)
        self.v_back = (m @ d.start_back).astype(np.float32)
        if d.about_origin:
            self.center = (m @ (d.start_center - self.origin) +
                           self.origin).astype(np.float32)
        self.update()

    def end_drag(self) -> None:
        self._drag.is_dragging = False

    def is_dragging(self) -> bool:
        return self._drag.is_dragging

    def move(self, xyz: np.ndarray) -> None:
        """Translate center (WASD/zoom), drag-aware (camera.cpp:134-138)."""
        step = np.asarray(xyz, np.float32) * self.movement_speed
        self.center = (self.center + step).astype(np.float32)
        if self._drag.is_dragging:
            self._drag.start_center = (
                self._drag.start_center + step).astype(np.float32)
        self.transform[:, 3] = self.center

    @property
    def w2c(self) -> np.ndarray:
        R = self.transform[:, :3]
        t = self.transform[:, 3]
        out = np.zeros((3, 4), np.float32)
        out[:, :3] = R.T
        out[:, 3] = -R.T @ t
        return out
