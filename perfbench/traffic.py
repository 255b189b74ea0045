"""The one generator of every traffic mix: a viewer's orbit, from a mix's
parameters and the run's seed.

The camera circles the scene's centre at the configuration's radius, z
up, looking at the centre: the azimuth advances ``az_step_deg`` a frame
and the elevation swings sinusoidally between ``el_min_deg`` and
``el_max_deg`` once every ``el_period_turns`` turns.  The seed draws the
start azimuth, the elevation's phase and the PCG32 stream's starting
frame; every seed then sweeps every azimuth and elevation many times a
window.

What is the same for every mix is fixed here, not in a mix's file: the
range of the stream's starting frame, the warm-up frames, and the poses on
which the rooflines count a frame's work.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PCG32_OFFSET_RANGE = 1 << 20  # the stream's first frame: below this
WARMUP_FRAMES = 64  # the orbit's first frames, run in set-up
# the rooflines' frames: spread evenly over one period of the orbit from
# azimuth 0 and elevation phase 0, with the stream's frames 0, 1, ...; a
# prime count, so that the poses take as many azimuths as there are poses
COUNT_POSES = 11


@dataclasses.dataclass
class Orbit:
    poses: np.ndarray  # [period, 3, 4] f32 camera-to-world, one a frame
    pcg32_offset: int  # the stream's frame at the first warm-up frame

    def pose(self, frame: int) -> np.ndarray:
        return self.poses[frame % len(self.poses)]


def look_at(center: np.ndarray) -> np.ndarray:
    """[3, 4] camera-to-world at ``center`` looking at the origin, z up:
    columns right, up, back (away from the view), centre."""
    back = center / np.linalg.norm(center)
    right = np.cross(np.array([0.0, 0.0, 1.0]), back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    return np.stack([right, up, back, center], axis=1)


def period(o: dict) -> int:
    """Frames in one period of the orbit ``o``."""
    return round(360.0 / float(o["az_step_deg"])) * int(o["el_period_turns"])


def _poses(o: dict, radius: float, az0: float, phase0: float,
           frames=None) -> np.ndarray:
    """[n, 3, 4] poses of the orbit ``o`` started at azimuth ``az0`` (deg)
    and elevation phase ``phase0``: of ``frames``, or of one period."""
    step = float(o["az_step_deg"])
    n = period(o)
    f = (np.arange(n, dtype=np.float64) if frames is None
         else np.asarray(frames, dtype=np.float64))
    az = np.radians(az0 + step * f)
    mid = 0.5 * (o["el_min_deg"] + o["el_max_deg"])
    amp = 0.5 * (o["el_max_deg"] - o["el_min_deg"])
    el = np.radians(mid + amp * np.sin(phase0 + 2.0 * np.pi * f / n))
    centers = radius * np.stack([np.cos(el) * np.cos(az),
                                 np.cos(el) * np.sin(az), np.sin(el)], -1)
    poses = np.stack([look_at(c) for c in centers]).astype(np.float32)
    return np.ascontiguousarray(poses)


def orbit(mix: dict, radius: float, seed: int) -> Orbit:
    rs = np.random.default_rng(int(seed))
    az0 = rs.uniform(0.0, 360.0)
    phase0 = rs.uniform(0.0, 2.0 * np.pi)
    offset = int(rs.integers(0, PCG32_OFFSET_RANGE))
    return Orbit(poses=_poses(mix["orbit"], radius, az0, phase0),
                 pcg32_offset=offset)


def counted(mix: dict, radius: float) -> list:
    """[(pose, the stream's frame)] of the COUNT_POSES frames on which the
    rooflines count a frame's work: the same for every seed."""
    n = period(mix["orbit"])
    frames = [k * n // COUNT_POSES for k in range(COUNT_POSES)]
    poses = _poses(mix["orbit"], radius, 0.0, 0.0, frames)
    return [(poses[k], k) for k in range(COUNT_POSES)]
