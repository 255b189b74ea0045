"""Mesh subsystem: primitives, OBJ loading, drawlist npz, transforms.

The port's own copy of rt_octree_tpu/io/mesh.py (NumPy).
Reference: renderer/src/mesh.cpp + include/volrend/mesh.hpp.  Vertex
format is pos(3) + color(3) + normal(3); ``faces`` indexes vertices with
``face_size`` of 1 (points), 2 (lines) or 3 (triangles).  The drawlist
npz convention (mesh.cpp:769-935): key ``<name>`` holds the type string,
``<name>__<field>`` the fields; camerafrustum supports repeated
placements via ``t``/``r`` (axis-angle) arrays plus trajectory
``connect``.

The reference renders meshes with OpenGL for display and feeds their
depth to the volume renderer for compositing (volrend.cu:146-153).  Here
meshes are host-side data; render/raster.py rasterizes their color+depth
for the same compositing contract.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

VERT_SZ = 9
DEFAULT_COLOR = (1.0, 0.5, 0.2)


@dataclasses.dataclass
class Mesh:
    vert: np.ndarray  # [n, 9] float32 (pos, color, normal)
    faces: np.ndarray  # [m] int32
    face_size: int = 3  # 1 points, 2 lines, 3 triangles
    name: str = "Mesh"
    visible: bool = True
    unlit: bool = False
    scale: float = 1.0
    translation: np.ndarray = None
    rotation: np.ndarray = None  # axis-angle

    def __post_init__(self):
        self.vert = np.asarray(self.vert, np.float32).reshape(-1, VERT_SZ)
        self.faces = np.asarray(self.faces, np.int32).reshape(-1)
        if self.translation is None:
            self.translation = np.zeros(3, np.float32)
        if self.rotation is None:
            self.rotation = np.zeros(3, np.float32)

    @property
    def n_verts(self) -> int:
        return self.vert.shape[0]

    def transformed_positions(self) -> np.ndarray:
        """Apply model transform (rotation axis-angle, scale, translation)."""
        pos = self.vert[:, :3] * self.scale
        pos = _rotate_axis_angle(self.rotation, pos)
        return pos + self.translation

    def repeat(self, n: int) -> None:
        """Duplicate geometry n times (mesh.cpp repeat for frustum arrays)."""
        nv = self.n_verts
        self.vert = np.tile(self.vert, (n, 1))
        offs = (np.arange(n, dtype=np.int32)[:, None] * nv)
        self.faces = (np.tile(self.faces, (n, 1)) + offs).reshape(-1)

    def apply_transform(self, rotation, translation, start: int,
                        end: int) -> None:
        """Rotate (axis-angle) + translate vertices [start, end)."""
        pos = self.vert[start:end, :3]
        self.vert[start:end, :3] = _rotate_axis_angle(rotation, pos) + \
            np.asarray(translation, np.float32)


def _rotate_axis_angle(aa, pos: np.ndarray) -> np.ndarray:
    aa = np.asarray(aa, np.float64)
    angle = np.linalg.norm(aa)
    if angle < 1e-12:
        return pos
    k = aa / angle
    c, s = np.cos(angle), np.sin(angle)
    cross = np.cross(np.broadcast_to(k, pos.shape), pos)
    dot = pos @ k
    return (pos * c + cross * s +
            k[None, :] * dot[:, None] * (1 - c)).astype(np.float32)


def _with_color(pos: np.ndarray, color) -> np.ndarray:
    v = np.zeros((pos.shape[0], VERT_SZ), np.float32)
    v[:, :3] = pos
    v[:, 3:6] = color
    v[:, 8] = 1.0
    return v


# ---------------------------------------------------------------------------
# primitives (mesh.hpp:52-78)
# ---------------------------------------------------------------------------

def cube(color=DEFAULT_COLOR, side: float = 1.0) -> Mesh:
    c = side / 2
    corners = np.array([[x, y, z] for x in (-c, c) for y in (-c, c)
                        for z in (-c, c)], np.float32)
    # 12 triangles
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, cq, d in quads:
        faces += [a, b, cq, a, cq, d]
    m = Mesh(_with_color(corners, color), np.array(faces), 3, "Cube")
    estimate_normals(m)
    return m


def sphere(rings: int = 15, sectors: int = 30,
           color=DEFAULT_COLOR) -> Mesh:
    phi = np.linspace(-np.pi / 2, np.pi / 2, rings)
    theta = np.linspace(0, 2 * np.pi, sectors, endpoint=False)
    P, T = np.meshgrid(phi, theta, indexing="ij")
    pos = np.stack([np.cos(P) * np.cos(T), np.cos(P) * np.sin(T),
                    np.sin(P)], -1).reshape(-1, 3)
    faces = []
    for r in range(rings - 1):
        for s in range(sectors):
            a = r * sectors + s
            b = r * sectors + (s + 1) % sectors
            faces += [a, b, a + sectors, b, b + sectors, a + sectors]
    v = _with_color(pos.astype(np.float32), color)
    v[:, 6:9] = pos  # unit sphere normals = positions
    return Mesh(v, np.array(faces), 3, "Sphere")


def lattice(reso: int = 8, color=(0.5, 0.5, 0.5)) -> Mesh:
    g = (np.arange(reso) + 0.5) / reso
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pos = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    return Mesh(_with_color(pos, color),
                np.arange(pos.shape[0], dtype=np.int32), 1, "Lattice")


def camera_frustum(focal_length: float = 1111.0, image_width: float = 800,
                   image_height: float = 800, z: float = -0.3,
                   color=DEFAULT_COLOR) -> Mesh:
    hx = 0.5 * image_width * abs(z) / focal_length
    hy = 0.5 * image_height * abs(z) / focal_length
    pos = np.array([
        [0, 0, 0],
        [-hx, -hy, z], [hx, -hy, z], [hx, hy, z], [-hx, hy, z],
    ], np.float32)
    lines = [0, 1, 0, 2, 0, 3, 0, 4, 1, 2, 2, 3, 3, 4, 4, 1]
    return Mesh(_with_color(pos, color), np.array(lines), 2,
                "CameraFrustum")


def line(a, b, color=DEFAULT_COLOR) -> Mesh:
    pos = np.stack([np.asarray(a, np.float32), np.asarray(b, np.float32)])
    return Mesh(_with_color(pos, color), np.array([0, 1]), 2, "Line")


def lines(points: np.ndarray, color=DEFAULT_COLOR) -> Mesh:
    pos = np.asarray(points, np.float32).reshape(-1, 3)
    n = pos.shape[0]
    faces = np.stack([np.arange(n - 1), np.arange(1, n)], -1).reshape(-1)
    return Mesh(_with_color(pos, color), faces.astype(np.int32), 2, "Lines")


def points(pts: np.ndarray, color=DEFAULT_COLOR) -> Mesh:
    pos = np.asarray(pts, np.float32).reshape(-1, 3)
    return Mesh(_with_color(pos, color),
                np.arange(pos.shape[0], dtype=np.int32), 1, "Points")


def estimate_normals(mesh: Mesh) -> None:
    """Area-weighted vertex normals from triangle faces."""
    if mesh.face_size != 3 or len(mesh.faces) < 3:
        return
    f = mesh.faces.reshape(-1, 3)
    p = mesh.vert[:, :3]
    fn = np.cross(p[f[:, 1]] - p[f[:, 0]], p[f[:, 2]] - p[f[:, 0]])
    normals = np.zeros_like(p)
    for k in range(3):
        np.add.at(normals, f[:, k], fn)
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    mesh.vert[:, 6:9] = normals / np.maximum(lens, 1e-12)


# ---------------------------------------------------------------------------
# OBJ loading (mesh.cpp:680-768; tinyobj replaced by a direct parser)
# ---------------------------------------------------------------------------

def load_obj(path_or_str: str, from_string: bool = False) -> Mesh:
    """Triangulating OBJ parser with optional vertex colors
    ('v x y z [r g b]') and normals."""
    text = path_or_str if from_string else open(path_or_str).read()
    verts, colors, normals, faces = [], [], [], []
    vert_normal_idx = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if ln.startswith("v "):
            parts = ln.split()[1:]
            verts.append([float(x) for x in parts[:3]])
            # vertices without explicit colors default to white, like
            # tinyobj with vertex_color=True
            colors.append([float(x) for x in parts[3:6]]
                          if len(parts) >= 6 else [1.0, 1.0, 1.0])
        elif ln.startswith("vn "):
            normals.append([float(x) for x in ln.split()[1:4]])
        elif ln.startswith("f "):
            idx = []
            for tok in ln.split()[1:]:
                comps = tok.split("/")
                vi = int(comps[0])
                vi = vi - 1 if vi > 0 else len(verts) + vi
                idx.append(vi)
                if len(comps) >= 3 and comps[2]:
                    ni = int(comps[2])
                    vert_normal_idx[vi] = ni - 1 if ni > 0 else \
                        len(normals) + ni
            for k in range(1, len(idx) - 1):  # fan triangulation
                faces += [idx[0], idx[k], idx[k + 1]]
    pos = np.asarray(verts, np.float32).reshape(-1, 3)
    v = _with_color(pos, DEFAULT_COLOR)
    if colors:
        v[:, 3:6] = np.asarray(colors, np.float32)
    m = Mesh(v, np.asarray(faces, np.int32), 3,
             "OBJ" if from_string else os.path.basename(path_or_str))
    if normals and vert_normal_idx:
        nrm = np.asarray(normals, np.float32)
        for vi, ni in vert_normal_idx.items():
            if ni < len(nrm):
                m.vert[vi, 6:9] = nrm[ni]
    else:
        estimate_normals(m)
    if not from_string:
        _apply_offs_sidecar(m, path_or_str)
    return m


def _apply_offs_sidecar(m: Mesh, obj_path: str) -> None:
    """Auto offset from a ``<mesh>.obj.offs`` sidecar: whitespace-separated
    ``tx ty tz [scale]`` applied to the mesh transform at load time
    (main.cpp:448-465).  A malformed translation leaves the mesh untouched;
    a present translation with a missing/malformed scale keeps scale=1
    (the reference's stream-state semantics)."""
    try:
        toks = open(obj_path + ".offs").read().split()
    except OSError:
        return
    try:
        t = np.asarray([float(x) for x in toks[:3]], np.float32)
    except ValueError:
        return
    if t.shape[0] != 3:
        return
    m.translation = t
    if len(toks) >= 4:
        try:
            m.scale = float(toks[3])
        except ValueError:
            pass


# ---------------------------------------------------------------------------
# drawlist npz (mesh.cpp:769-935)
# ---------------------------------------------------------------------------

def _split2(name: str):
    i = name.find("__")
    return (name,) if i < 0 else (name[:i], name[i + 2:])


def _as_str(arr) -> str:
    if arr.dtype.kind in ("U", "S"):
        s = arr.reshape(()).item()
        return s.decode() if isinstance(s, bytes) else s
    return arr.tobytes().decode("utf-32-le", errors="ignore").strip("\x00")


def load_drawlist(path: str, default_visible: bool = True) -> List[Mesh]:
    with np.load(path, allow_pickle=False) as f:
        npz = {k: f[k] for k in f.files}
    groups: dict = {}
    for full, arr in npz.items():
        spl = _split2(full)
        g = groups.setdefault(spl[0], {"type": None, "fields": {}})
        if len(spl) == 1:
            g["type"] = _as_str(arr).lower()
        else:
            g["fields"][spl[1]] = arr

    def getf(fields, key, default):
        if key not in fields:
            return default
        return float(np.asarray(fields[key]).reshape(-1)[0])

    def getv3(fields, key, default):
        if key not in fields:
            return np.asarray(default, np.float32)
        return np.asarray(fields[key], np.float32).reshape(3)

    meshes = []
    for name, g in sorted(groups.items()):
        ftype, fields = g["type"], g["fields"]
        if ftype is None:
            continue
        color = getv3(fields, "color", DEFAULT_COLOR)
        if ftype == "cube":
            me = cube(color)
        elif ftype == "sphere":
            me = sphere(int(getf(fields, "rings", 15)),
                        int(getf(fields, "sectors", 30)), color)
        elif ftype == "line":
            me = line(getv3(fields, "a", (0, 0, 0)),
                      getv3(fields, "b", (0, 0, 1)), color)
        elif ftype == "camerafrustum":
            me = camera_frustum(getf(fields, "focal_length", 1111.0),
                                getf(fields, "image_width", 800.0),
                                getf(fields, "image_height", 800.0),
                                getf(fields, "z", -0.3), color)
            if "t" in fields:
                t = np.asarray(fields["t"], np.float32).reshape(-1, 3)
                r = np.asarray(fields["r"], np.float32).reshape(-1, 3)
                nv = me.n_verts
                me.repeat(len(t))
                for i in range(len(t)):
                    me.apply_transform(r[i], t[i], nv * i, nv * (i + 1))
                if int(getf(fields, "connect", 0)):
                    traj = []
                    for i in range(len(t) - 1):
                        traj += [nv * i, nv * (i + 1)]
                    me.faces = np.concatenate(
                        [me.faces, np.asarray(traj, np.int32)])
        elif ftype == "lines":
            me = lines(np.asarray(fields["points"], np.float32), color)
            if "segs" in fields:
                me.faces = np.asarray(fields["segs"], np.int32).reshape(-1)
        elif ftype == "points":
            me = points(np.asarray(fields["points"], np.float32), color)
        elif ftype == "mesh":
            me = points(np.asarray(fields["points"], np.float32), color)
            me.face_size = int(getf(fields, "face_size", 3))
            if "faces" in fields:
                me.faces = np.asarray(fields["faces"], np.int32).reshape(-1)
            if me.face_size == 3:
                estimate_normals(me)
        else:
            print(f"WARNING: mesh '{name}' has unsupported type '{ftype}'")
            continue
        if "vert_color" in fields:
            vc = np.asarray(fields["vert_color"], np.float32).reshape(-1, 3)
            if len(vc) == me.n_verts:
                me.vert[:, 3:6] = vc
        me.name = name
        me.scale = getf(fields, "scale", 1.0)
        me.translation = getv3(fields, "translation", (0, 0, 0))
        me.rotation = getv3(fields, "rotation", (0, 0, 0))
        me.visible = bool(int(getf(fields, "visible", default_visible)))
        me.unlit = bool(int(getf(fields, "unlit", 0)))
        meshes.append(me)
    return meshes
