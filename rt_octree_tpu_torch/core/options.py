"""Render options with JSON (de)serialization parity.

The port's own copy of rt_octree_tpu/core/options.py (pure Python).
Reference: renderer/include/volrend/render_options.hpp:13-78 (defaults and
the NLOHMANN serialized field set), renderer/src/opts.cpp:44-66 (flags),
renderer/options/opt.json (shipped canonical config: spp=6, denoise=true).

Note: like the reference CUDA path, the regular-tracking estimator does
not use ``stop_thresh``; the classic estimator (the legacy GL marcher,
shaders/rt.frag:314) stops a ray once its transmittance falls under it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

GLOBAL_BASIS_MAX = 25  # VOLREND_GLOBAL_BASIS_MAX (render_options.hpp:8)
SPP_ALLOWED = (1, 2, 3, 4, 6, 8, 16, 32)  # volrend.cu:266-278


@dataclasses.dataclass
class RenderOptions:
    step_size: float = 1e-4
    sigma_thresh: float = 1e-2
    stop_thresh: float = 1e-2
    background_brightness: float = 1.0

    render_bbox: tuple = (0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
    basis_minmax: tuple = (0, GLOBAL_BASIS_MAX - 1)
    rot_dirs: tuple = (0.0, 0.0, 0.0)

    show_grid: bool = False
    grid_max_depth: int = 4

    enable_probe: bool = False
    probe: tuple = (0.0, 0.0, 1.0)
    probe_disp_size: int = 100

    denoise: bool = True
    spp: int = 1

    # Estimator selection: "rt" (batched regular tracking,
    # rt_core.cuh:195-332) or "classic" (exponential-transmittance marcher
    # with the stop_thresh early-out, shaders/rt.frag:222-327; K1's
    # render_classic variant)
    estimator: str = "rt"

    SPP_DEFAULT = 4

    _JSON_FIELDS = (
        "step_size", "sigma_thresh", "stop_thresh", "background_brightness",
        "show_grid", "grid_max_depth", "enable_probe", "probe",
        "probe_disp_size", "denoise", "spp", "estimator")

    def validate(self) -> None:
        if self.spp not in SPP_ALLOWED:
            raise ValueError(
                f"spp == {self.spp} not supported (allowed: {SPP_ALLOWED})")
        if self.estimator not in ("rt", "classic"):
            raise ValueError(f"unknown estimator {self.estimator!r}")

    def to_json_dict(self) -> dict[str, Any]:
        out = {}
        for k in self._JSON_FIELDS:
            v = getattr(self, k)
            out[k] = list(v) if isinstance(v, tuple) else v
        return out

    @classmethod
    def from_json_dict(cls, d: dict[str, Any]) -> "RenderOptions":
        opts = cls()
        for k in cls._JSON_FIELDS:
            if k in d:
                v = d[k]
                setattr(opts, k, tuple(v) if isinstance(v, list) else v)
        return opts

    @classmethod
    def from_json_file(cls, path: str) -> "RenderOptions":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json_dict(), f, indent=2, sort_keys=True)
