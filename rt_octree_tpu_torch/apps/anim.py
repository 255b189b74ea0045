"""Keyframe animation: capture, interpolate, offline-render PNG sequences.

Reference: renderer/main_anim.cpp -- AnimKF captures full renderer state
(camera vectors + render options, :136-182), camera orbits use spherical
interpolation about the origin incl. extra full loops (sphc_interp,
:60-92), scalar options lerp per-property (AnimState::update :230-344),
and offline export renders at a fixed fps to numbered PNGs (:1254-1262).
The interactive ImGui timeline is GUI-only; this module provides the
persistence format + the offline renderer (the portable part).

The port's own copy of rt_octree_tpu/apps/anim.py: the same keyframe
format and interpolation (NumPy), with the offline export rendered by the
port's Renderer (kernels K1, K7 and K2; K4 under --render_scale) on
``--device`` (default cuda) and written by io/png.py.

Keyframe JSON:
{
  "fps": 30,
  "keyframes": [
    {"duration": 1.5,            # seconds to next keyframe
     "spherical": true,          # orbit about origin vs linear path
     "loops": 0,                 # extra full orbits
     "camera": {"center": [..], "v_back": [..], "v_world_up": [..],
                "origin": [..], "fx": f, "fy": f},
     "options": { RenderOptions json fields }},
    ...
  ]
}
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

from ..core.camera import Camera
from ..core.options import RenderOptions


@dataclasses.dataclass
class AnimKF:
    center: np.ndarray
    v_back: np.ndarray
    v_world_up: np.ndarray
    origin: np.ndarray
    fx: float
    fy: float
    options: RenderOptions
    duration: float = 1.0
    spherical: bool = True
    loops: int = 0
    # keyframed mesh manipulation (main_anim.cpp MeshState :112-134):
    # per-mesh {name, translation[3], rotation[3], scale, visible},
    # lerped between keyframes and applied to scene meshes by name
    mesh_state: list = dataclasses.field(default_factory=list)

    @staticmethod
    def from_renderer(cam: Camera, options: RenderOptions,
                      duration: float = 1.0, spherical: bool = True,
                      loops: int = 0, meshes=()) -> "AnimKF":
        return AnimKF(
            center=np.array(cam.center, np.float32),
            v_back=np.array(cam.v_back, np.float32),
            v_world_up=np.array(cam.v_world_up, np.float32),
            origin=np.array(cam.origin, np.float32),
            fx=cam.fx, fy=cam.fy,
            options=options, duration=duration, spherical=spherical,
            loops=loops,
            mesh_state=[{
                "name": m.name,
                "translation": np.asarray(m.translation,
                                          np.float32).tolist(),
                "rotation": np.asarray(m.rotation, np.float32).tolist(),
                "scale": float(m.scale),
                "visible": bool(m.visible),
            } for m in meshes])

    def to_renderer(self, cam: Camera) -> RenderOptions:
        cam.center = self.center.copy()
        cam.v_back = self.v_back.copy()
        cam.v_world_up = self.v_world_up.copy()
        cam.origin = self.origin.copy()
        cam.fx, cam.fy = self.fx, self.fy
        cam.update()
        return self.options

    def to_json(self) -> dict:
        return {
            "duration": self.duration,
            "spherical": self.spherical,
            "loops": self.loops,
            "meshes": self.mesh_state,
            "camera": {
                "center": self.center.tolist(),
                "v_back": self.v_back.tolist(),
                "v_world_up": self.v_world_up.tolist(),
                "origin": self.origin.tolist(),
                "fx": self.fx, "fy": self.fy,
            },
            "options": self.options.to_json_dict(),
        }

    @staticmethod
    def from_json(d: dict) -> "AnimKF":
        c = d["camera"]
        return AnimKF(
            center=np.asarray(c["center"], np.float32),
            v_back=np.asarray(c["v_back"], np.float32),
            v_world_up=np.asarray(c["v_world_up"], np.float32),
            origin=np.asarray(c.get("origin", [0, 0, 0]), np.float32),
            fx=float(c["fx"]), fy=float(c["fy"]),
            options=RenderOptions.from_json_dict(d.get("options", {})),
            duration=float(d.get("duration", 1.0)),
            spherical=bool(d.get("spherical", True)),
            loops=int(d.get("loops", 0)),
            mesh_state=list(d.get("meshes", [])))


def save_keyframes(path: str, kfs: List[AnimKF], fps: float = 30.0) -> None:
    with open(path, "w") as f:
        json.dump({"fps": fps, "keyframes": [k.to_json() for k in kfs]},
                  f, indent=2)


def load_keyframes(path: str):
    with open(path) as f:
        d = json.load(f)
    return [AnimKF.from_json(k) for k in d["keyframes"]], float(
        d.get("fps", 30.0))


def sphc_interp(c0: np.ndarray, c1: np.ndarray, origin: np.ndarray,
                t: float, loops: int = 0) -> np.ndarray:
    """Spherical interpolation of a camera position about ``origin``
    (main_anim.cpp:60-92): slerp of direction, lerp of radius, plus
    ``loops`` extra full revolutions about the axis."""
    r0 = c0 - origin
    r1 = c1 - origin
    n0 = np.linalg.norm(r0)
    n1 = np.linalg.norm(r1)
    if n0 < 1e-9 or n1 < 1e-9:
        return (1 - t) * c0 + t * c1
    u0 = r0 / n0
    u1 = r1 / n1
    dot = float(np.clip(u0 @ u1, -1.0, 1.0))
    omega = np.arccos(dot)
    axis = np.cross(u0, u1)
    an = np.linalg.norm(axis)
    if an < 1e-9:
        # parallel: pick any perpendicular axis for loops, else lerp
        if loops == 0:
            u = u0
            radius = (1 - t) * n0 + t * n1
            return origin + u * radius
        axis = np.cross(u0, np.array([0.0, 0.0, 1.0]))
        if np.linalg.norm(axis) < 1e-9:
            axis = np.cross(u0, np.array([0.0, 1.0, 0.0]))
        an = np.linalg.norm(axis)
    axis = axis / an
    total = omega + loops * 2.0 * np.pi
    ang = total * t
    # rodrigues rotation of u0 about axis by ang
    u = (u0 * np.cos(ang) + np.cross(axis, u0) * np.sin(ang) +
         axis * (axis @ u0) * (1 - np.cos(ang)))
    radius = (1 - t) * n0 + t * n1
    return origin + u * radius


def interp_options(o0: RenderOptions, o1: RenderOptions,
                   t: float) -> RenderOptions:
    """Per-property lerp of scalar options; discrete ones switch at the
    keyframe (main_anim.cpp:230-344)."""
    out = RenderOptions()
    lerp = lambda a, b: (1 - t) * a + t * b
    out.step_size = lerp(o0.step_size, o1.step_size)
    out.sigma_thresh = lerp(o0.sigma_thresh, o1.sigma_thresh)
    out.stop_thresh = lerp(o0.stop_thresh, o1.stop_thresh)
    out.background_brightness = lerp(o0.background_brightness,
                                     o1.background_brightness)
    out.render_bbox = tuple(
        lerp(a, b) for a, b in zip(o0.render_bbox, o1.render_bbox))
    out.rot_dirs = tuple(
        lerp(a, b) for a, b in zip(o0.rot_dirs, o1.rot_dirs))
    out.basis_minmax = o0.basis_minmax
    out.denoise = o0.denoise
    out.spp = o0.spp
    out.show_grid = o0.show_grid
    out.grid_max_depth = o0.grid_max_depth
    out.enable_probe = o0.enable_probe
    out.probe = o0.probe
    out.probe_disp_size = o0.probe_disp_size
    return out


def interp_mesh_state(k0: AnimKF, k1: AnimKF, t: float) -> list:
    """Lerp per-mesh transforms between two keyframes, matched by name
    (main_anim.cpp AnimState::update mesh lerp); a mesh present only in
    k0 holds its k0 state.  Visibility switches at the keyframe."""
    by_name = {m["name"]: m for m in k1.mesh_state}
    out = []
    for m0 in k0.mesh_state:
        m1 = by_name.get(m0["name"])
        if m1 is None:
            out.append(dict(m0))
            continue
        lerp3 = lambda a, b: [(1 - t) * x + t * y for x, y in zip(a, b)]
        out.append({
            "name": m0["name"],
            "translation": lerp3(m0["translation"], m1["translation"]),
            "rotation": lerp3(m0["rotation"], m1["rotation"]),
            "scale": (1 - t) * m0["scale"] + t * m1["scale"],
            "visible": bool(m0["visible"]),
        })
    return out


def interp_keyframes(k0: AnimKF, k1: AnimKF, t: float):
    """Camera + options at fraction t between two keyframes."""
    cam = Camera(fx=(1 - t) * k0.fx + t * k1.fx,
                 fy=(1 - t) * k0.fy + t * k1.fy)
    if k0.spherical:
        cam.center = sphc_interp(k0.center, k1.center, k0.origin, t,
                                 k0.loops).astype(np.float32)
        back0 = k0.v_back / np.linalg.norm(k0.v_back)
        # keep looking toward the orbit origin (reference orbits track it)
        look = cam.center - k0.origin
        n = np.linalg.norm(look)
        cam.v_back = (look / n).astype(np.float32) if n > 1e-9 else back0
    else:
        cam.center = ((1 - t) * k0.center + t * k1.center).astype(np.float32)
        vb = (1 - t) * k0.v_back + t * k1.v_back
        cam.v_back = (vb / np.linalg.norm(vb)).astype(np.float32)
    cam.v_world_up = k0.v_world_up.copy()
    cam.origin = k0.origin.copy()
    cam.update()
    return cam, interp_options(k0.options, k1.options, t)


def timeline_at(kfs: List[AnimKF], frac: float):
    """(camera, options, mesh_state) at global timeline fraction
    ``frac`` in [0, 1] (the editor's seek/scrub; total duration = sum of
    all segment durations, the last keyframe being the endpoint).
    Requires >= 2 keyframes."""
    if len(kfs) < 2:
        raise ValueError("timeline needs at least 2 keyframes")
    durs = [max(float(k.duration), 1e-6) for k in kfs[:-1]]
    total = sum(durs)
    t_abs = float(np.clip(frac, 0.0, 1.0)) * total
    acc = 0.0
    for i, d in enumerate(durs):
        if t_abs <= acc + d or i == len(durs) - 1:
            t = min((t_abs - acc) / d, 1.0)
            cam, options = interp_keyframes(kfs[i], kfs[i + 1], t)
            return cam, options, interp_mesh_state(kfs[i], kfs[i + 1], t)
        acc += d


def render_animation(renderer_factory, kfs: List[AnimKF], fps: float,
                     out_dir: str, width: int, height: int) -> int:
    """Offline PNG-sequence export (main_anim.cpp:1254-1262).

    renderer_factory(cam, options) -> callable(transform) -> img array.
    Returns number of frames written.
    """
    from ..io.png import write_png

    os.makedirs(out_dir, exist_ok=True)
    frame = 0
    for k0, k1 in zip(kfs[:-1], kfs[1:]):
        n = max(int(round(k0.duration * fps)), 1)
        for i in range(n):
            t = i / n
            cam, options = interp_keyframes(k0, k1, t)
            cam.width, cam.height = width, height
            img = renderer_factory(cam, options)
            write_png(os.path.join(out_dir, f"{frame:06d}.png"),
                      np.asarray(img))
            frame += 1
    return frame


def main(argv=None) -> int:
    """CLI: offline keyframe animation rendering."""
    import argparse

    import torch

    from ..io import n3tree
    from ..ops.traversal import upload_tree
    from ..render.renderer import Renderer

    p = argparse.ArgumentParser("rtoctree-anim")
    p.add_argument("file", help="tree npz")
    p.add_argument("keyframes", help="keyframe json")
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("-w", "--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--gnet", default="")
    p.add_argument("--render_scale", type=float, default=1.0,
                   help="fast mode: march at this fraction of the "
                        "output resolution, joint-upsample through the "
                        "fused denoise")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    args = p.parse_args(argv)

    tree = n3tree.load(args.file)
    dt = upload_tree(tree, device=torch.device(args.device))
    kfs, fps = load_keyframes(args.keyframes)

    renderers = {}

    def factory(cam, options):
        key = options.spp
        if key not in renderers:
            r = Renderer(dt, args.width, args.height, cam.fx, cam.fy,
                         options=options, render_scale=args.render_scale)
            if args.gnet:
                r.set_denoiser(args.gnet)
            renderers[key] = r
        r = renderers[key]
        r.options = options
        # propagate interpolated focal (keyframes may animate fx/fy)
        r.fx, r.fy = float(cam.fx), float(cam.fy)
        img, _ = r.render(cam.transform)
        r.advance_rng()
        return img.cpu().numpy()

    n = render_animation(factory, kfs, fps, args.out_dir, args.width,
                         args.height)
    print(f"wrote {n} frames to {args.out_dir}")
    return 0


if __name__ == "__main__":
    main()
