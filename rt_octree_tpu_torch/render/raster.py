"""Software mesh rasterizer: color + ray-distance depth buffers.

The port's own copy of rt_octree_tpu/render/raster.py (NumPy).
Reference role: the GUI renderer rasterizes meshes with OpenGL and the
volume kernel composites against them -- reading mesh depth as the ray's
t_max (volrend.cu:146-153) and mesh color as the background behind
transmissive volume (volrend.cu:180-184).  This host-side rasterizer
produces the same two buffers for the offline pipeline: depth is the
distance along each pixel's *normalized* camera ray (the unit trace_rays
expects for tmax_bg), +inf where no mesh.

Meshes are small (probe cubes, camera frustums, wireframes, modest OBJs),
so a NumPy per-primitive loop with vectorized bbox coverage is adequate.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.camera import Camera
from ..io.mesh import Mesh


def _project(cam: Camera, pos: np.ndarray):
    """World -> (pixel x, pixel y, cam-space p, cam z)."""
    w2c = cam.w2c
    p = pos @ w2c[:, :3].T + w2c[:, 3]
    z = p[:, 2]  # negative in front of camera
    with np.errstate(divide="ignore", invalid="ignore"):
        px = p[:, 0] / (-z) * cam.fx + 0.5 * cam.width
        py = -(p[:, 1] / (-z)) * cam.fy + 0.5 * cam.height
    return px, py, p, z


def rasterize_meshes(meshes: List[Mesh], cam: Camera,
                     background: Optional[np.ndarray] = None,
                     light_dir=(0.5, -0.7, 0.5)):
    """Returns (color [H,W,3] float32, depth_t [H,W] float32 with +inf)."""
    H, W = cam.height, cam.width
    color = (np.zeros((H, W, 3), np.float32) if background is None
             else np.broadcast_to(
                 np.asarray(background, np.float32), (H, W, 3)).copy())
    depth = np.full((H, W), np.inf, np.float32)
    ld = np.asarray(light_dir, np.float64)
    ld /= np.linalg.norm(ld)

    for mesh in meshes:
        if not mesh.visible or mesh.n_verts == 0:
            continue
        pos = mesh.transformed_positions()
        px, py, pcam, z = _project(cam, pos)
        t = np.linalg.norm(pcam, axis=-1)
        vcol = mesh.vert[:, 3:6]
        if not mesh.unlit and mesh.face_size == 3:
            lam = np.abs(mesh.vert[:, 6:9] @ ld)
            vcol = vcol * (0.3 + 0.7 * lam[:, None])

        if mesh.face_size == 3:
            for f in mesh.faces.reshape(-1, 3):
                _raster_tri(color, depth, px[f], py[f], pcam[f], z[f],
                            vcol[f])
        elif mesh.face_size == 2:
            for f in mesh.faces.reshape(-1, 2):
                _raster_line(color, depth, px[f], py[f], t[f], z[f],
                             vcol[f])
        else:
            for i in mesh.faces:
                _raster_point(color, depth, px[i], py[i], t[i], z[i],
                              vcol[i])
    return color, depth


def _raster_tri(color, depth, px, py, pcam, z, vcol):
    if np.any(z > -1e-6) or not np.all(np.isfinite(px)):
        return
    H, W = depth.shape
    x0 = max(int(np.floor(px.min())), 0)
    x1 = min(int(np.ceil(px.max())) + 1, W)
    y0 = max(int(np.floor(py.min())), 0)
    y1 = min(int(np.ceil(py.max())) + 1, H)
    if x0 >= x1 or y0 >= y1:
        return
    xs = np.arange(x0, x1) + 0.0
    ys = np.arange(y0, y1) + 0.0
    X, Y = np.meshgrid(xs, ys)
    d = ((px[1] - px[0]) * (py[2] - py[0]) -
         (px[2] - px[0]) * (py[1] - py[0]))
    if abs(d) < 1e-12:
        return
    w1 = ((X - px[0]) * (py[2] - py[0]) - (Y - py[0]) * (px[2] - px[0])) / d
    w2 = ((Y - py[0]) * (px[1] - px[0]) - (X - px[0]) * (py[1] - py[0])) / d
    w0 = 1.0 - w1 - w2
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    if not inside.any():
        return
    # perspective-correct interpolation (attributes weighted by 1/|z|);
    # ray distance = norm of the interpolated cam-space position, which
    # IS affine over the surface (|p| is not)
    iz = 1.0 / np.abs(z)
    zi = w0 * iz[0] + w1 * iz[1] + w2 * iz[2]
    pi = (w0[..., None] * pcam[0] * iz[0] +
          w1[..., None] * pcam[1] * iz[1] +
          w2[..., None] * pcam[2] * iz[2]) / zi[..., None]
    ti = np.linalg.norm(pi, axis=-1)
    ci = (w0[..., None] * vcol[0] * iz[0] + w1[..., None] * vcol[1] * iz[1] +
          w2[..., None] * vcol[2] * iz[2]) / zi[..., None]
    sub_d = depth[y0:y1, x0:x1]
    upd = inside & (ti < sub_d)
    sub_d[upd] = ti[upd]
    color[y0:y1, x0:x1][upd] = ci[upd]


def _raster_line(color, depth, px, py, t, z, vcol):
    if np.any(z > -1e-6) or not np.all(np.isfinite(px)):
        return
    H, W = depth.shape
    n = int(max(abs(px[1] - px[0]), abs(py[1] - py[0]))) + 1
    n = min(n, 4 * max(H, W))
    u = np.linspace(0.0, 1.0, n)
    xs = np.round(px[0] + (px[1] - px[0]) * u).astype(int)
    ys = np.round(py[0] + (py[1] - py[0]) * u).astype(int)
    ts = t[0] + (t[1] - t[0]) * u
    cs = vcol[0][None] + (vcol[1] - vcol[0])[None] * u[:, None]
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    xs, ys, ts, cs = xs[ok], ys[ok], ts[ok], cs[ok]
    closer = ts < depth[ys, xs]
    depth[ys[closer], xs[closer]] = ts[closer]
    color[ys[closer], xs[closer]] = cs[closer]


def _raster_point(color, depth, px, py, t, z, vcol):
    if z > -1e-6 or not np.isfinite(px):
        return
    H, W = depth.shape
    x, y = int(round(px)), int(round(py))
    if 0 <= x < W and 0 <= y < H and t < depth[y, x]:
        depth[y, x] = t
        color[y, x] = vcol
