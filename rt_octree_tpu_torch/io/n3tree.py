"""PlenOctree (.npz) loading into host arrays.

The port's own copy of the loader of rt_octree_tpu/io/n3tree.py, in NumPy.
Reference: renderer/src/n3tree.cpp:111-362 (open/load_npz incl. legacy
format inference and quantized-color codebook decode), renderer/include/
volrend/n3tree.hpp, renderer/include/volrend/data_format.hpp.

On-disk contract (same npz produced by PlenOctrees / compress_octree.py):
  data_dim      int64 scalar
  data_format   unicode string, e.g. "SH9" (optional; legacy files infer)
  invradius3    f32[3]  or  invradius f64 scalar
  offset        f32[3]
  child         i32 [capacity, N, N, N]   relative node links (0 = leaf)
  data          f16 [capacity, N, N, N, data_dim]
  -- or quantized:
  quant_colors  f16 [n_basis_q, 65536, 3] codebooks
  quant_map     u16 [n_basis_q, capacity*N^3]
  sigma         f16 [capacity*N^3]
  data_retained f16 [n_retain, capacity*N^3, 3] (optional)
  extra_data    f32 [...] (SG/ASG only, optional)

The tree becomes two flat arrays: ``data`` indexed by "sub-pointer"
(node*N^3 + child_index, the CUDA layout of renderer/src/cuda/n3tree.cu:
13-27) and ``child`` with relative skips.  The quantized decode and the
depth search run in NumPy: the JAX package's optional C++ helpers are not
used.  The jump LUT is not built here: kernel K3 builds it on the card
(ops/traversal.py:upload_tree).
"""

from __future__ import annotations

import ast
import dataclasses
import enum
import os
import struct
import zipfile
import zlib
from typing import Any, Optional

import numpy as np


class BasisFormat(enum.Enum):
    RGBA = 0
    SH = 1
    SG = 2
    ASG = 3


@dataclasses.dataclass(frozen=True)
class DataFormat:
    """Parsed data format string, e.g. "SH9" (ref data_format.hpp:55-101)."""

    format: BasisFormat = BasisFormat.RGBA
    basis_dim: int = -1

    @staticmethod
    def parse(s: str) -> "DataFormat":
        nonalph = next((i for i, c in enumerate(s) if not c.isalpha()), None)
        if nonalph is not None:
            basis_dim = int(s[nonalph:] or -1)
            prefix = s[:nonalph]
            fmt = {
                "ASG": BasisFormat.ASG,
                "SG": BasisFormat.SG,
                "SH": BasisFormat.SH,
            }.get(prefix, BasisFormat.RGBA)
            return DataFormat(fmt, basis_dim)
        return DataFormat(BasisFormat.RGBA, -1)

    def to_string(self) -> str:
        out = self.format.name
        if self.basis_dim != -1:
            out += str(self.basis_dim)
        return out


@dataclasses.dataclass
class N3Tree:
    """Host-side tree: flat numpy arrays plus metadata."""

    data: np.ndarray  # [capacity*N3, data_dim] float16
    child: np.ndarray  # [capacity*N3] int32 (relative node skips, 0=leaf)
    offset: np.ndarray  # [3] float32 (world->tree: x' = offset + scale*x)
    scale: np.ndarray  # [3] float32
    N: int
    data_dim: int
    data_format: DataFormat
    extra: Optional[np.ndarray] = None  # SG/ASG params
    capacity: int = 0
    max_depth: int = 0  # levels of descent (leaf cube size >= N^-(max_depth+1))
    # NDC (LLFF forward-facing) config; ndc_width <= 0 disables
    use_ndc: bool = False
    ndc_width: float = -1.0
    ndc_height: float = -1.0
    ndc_focal: float = -1.0
    ndc_avg_up: Optional[np.ndarray] = None
    ndc_avg_back: Optional[np.ndarray] = None
    ndc_avg_cen: Optional[np.ndarray] = None
    npz_path: str = ""

    @property
    def N3(self) -> int:
        return self.N ** 3

    @property
    def n_nodes(self) -> int:
        return self.child.shape[0] // self.N3


def _decode_data_format(npz: dict, data_dim: int) -> DataFormat:
    if "data_format" in npz:
        raw = npz["data_format"]
        if raw.dtype.kind in ("U", "S"):
            s = str(raw.reshape(()).item())
            if isinstance(s, bytes):
                s = s.decode()
        else:
            # raw bytes of a UTF-32 string (as the C++ loader sees them)
            b = raw.tobytes()
            s = b.decode("utf-32-le", errors="ignore").strip("\x00")
        return DataFormat.parse(s)
    # Legacy auto-infer (n3tree.cpp:241-253)
    if data_dim == 4:
        return DataFormat(BasisFormat.RGBA, -1)
    return DataFormat(BasisFormat.SH, (data_dim - 1) // 3)


def _decode_quantized(npz: dict, N3: int, data_dim: int) -> tuple[np.ndarray, int]:
    """Expand median-cut codebooks (n3tree.cpp:279-340) -> [n_child, data_dim] f16."""
    quant_colors = npz["quant_colors"]  # [n_q, 65536, 3] f16
    # quant_map may be stored [n_q, capacity, N, N, N] (compress tool) --
    # the C++ loader reads shape[1] as capacity either way
    quant_map = np.asarray(npz["quant_map"])
    capacity = quant_map.shape[1] if quant_map.ndim > 2 else (
        quant_map.shape[1] // N3)
    quant_map = quant_map.reshape(quant_map.shape[0], -1)
    sigma = npz["sigma"].reshape(-1)  # [n_child] f16
    n_q, n_child = quant_map.shape
    retained = npz["data_retained"] if "data_retained" in npz else None
    n_retain = 0 if retained is None else retained.shape[0]
    n_basis = n_q + n_retain

    data = np.zeros((n_child, data_dim), np.float16)
    qc = quant_colors.reshape(n_q, -1, 3)
    for j in range(n_q):
        colors = qc[j][quant_map[j].astype(np.int64)]  # [n_child, 3]
        for k in range(3):
            data[:, n_retain + j + k * n_basis] = colors[:, k]
    if retained is not None:
        ret = np.asarray(retained).reshape(n_retain, n_child, 3)
        for j in range(n_retain):
            for k in range(3):
                data[:, j + k * n_basis] = ret[j, :, k]
    data[:, data_dim - 1] = sigma.astype(np.float16)
    return data, capacity


def compute_max_depth(child: np.ndarray, N3: int) -> int:
    """Maximum descent iterations a query needs (deepest leaf level),
    via BFS over node links.  A root-only tree returns 1."""
    child_nodes = child.reshape(-1, N3)
    depth = 1
    frontier = np.array([0], np.int64)
    while True:
        links = child_nodes[frontier]  # [F, N3]
        nodes, subs = np.nonzero(links)
        if len(nodes) == 0:
            return depth
        frontier = frontier[nodes] + links[nodes, subs].astype(np.int64)
        frontier = np.unique(frontier)
        depth += 1
        if depth > 64:
            raise ValueError("Octree deeper than 64 levels; corrupt child links?")


def unpack_llff_poses_bounds(pb: np.ndarray):
    """Mean pose/intrinsics extraction from poses_bounds.npy
    (n3tree.cpp:21-52).  pb: [n_cams, 17]."""
    pb = np.asarray(pb, np.float64).reshape(-1, 17)
    height = pb[0, 4]
    width = pb[0, 9]
    focal = pb[0, 14]
    rows = pb[:, :15].reshape(-1, 3, 5)
    up = -rows[:, :, 0].sum(0)
    backward = rows[:, :, 2].sum(0)
    cen = rows[:, :, 3].sum(0)
    bd_min = pb[:, 15:17].min()
    n = pb.shape[0]
    cen = cen / (n * bd_min * 0.75)
    backward = backward / np.linalg.norm(backward)
    right = np.cross(up, backward)
    right /= np.linalg.norm(right)
    up = np.cross(backward, right)
    up /= np.linalg.norm(up)
    return (float(width), float(height), float(focal),
            up.astype(np.float32), backward.astype(np.float32),
            cen.astype(np.float32))


def _parse_npy(data: bytes) -> np.ndarray:
    if data[:6] != b"\x93NUMPY":
        raise ValueError("not an npy member")
    if data[6] == 1:
        (hlen,) = struct.unpack("<H", data[8:10])
        off = 10 + hlen
    else:
        (hlen,) = struct.unpack("<I", data[8:12])
        off = 12 + hlen
    d = ast.literal_eval(data[off - hlen:off].decode("latin1"))
    dtype = np.dtype(d["descr"])
    if d.get("fortran_order"):
        return np.frombuffer(data, dtype=dtype, offset=off).reshape(
            d["shape"], order="F").copy()
    return np.frombuffer(data, dtype=dtype, offset=off).reshape(d["shape"])


def _load_npz_fast(path: str) -> dict[str, np.ndarray]:
    """Every ``.npy`` member of an npz, each read in one piece and
    decompressed with one zlib call (np.load streams members in small
    chunks, which costs minutes on multi-100 MB octrees).  The arrays are
    read-only views of the member bytes."""
    out = {}
    with open(path, "rb") as f:
        zf = zipfile.ZipFile(f)
        for info in zf.infolist():
            name = info.filename
            if not name.endswith(".npy"):
                continue
            # the member data follows its 30-byte local header, name, extra
            f.seek(info.header_offset)
            lh = f.read(30)
            if lh[:4] != b"PK\x03\x04":
                raise ValueError(f"bad local header for {name}")
            name_len, extra_len = struct.unpack("<HH", lh[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            raw = f.read(info.compress_size)
            if info.compress_type == zipfile.ZIP_STORED:
                data = raw
            elif info.compress_type == zipfile.ZIP_DEFLATED:
                data = zlib.decompress(raw, -15)
            else:
                with zf.open(info) as m:
                    data = m.read()
            out[name[:-4]] = _parse_npy(data)
    return out


def load(path: str | os.PathLike) -> N3Tree:
    """Load a PlenOctree npz (plus optional `<name>_poses_bounds.npy` NDC
    sidecar, n3tree.cpp:121-148)."""
    path = os.fspath(path)
    try:
        npz = _load_npz_fast(path)
    except (ValueError, KeyError, SyntaxError, struct.error,
            zipfile.BadZipFile, zlib.error):
        with np.load(path, allow_pickle=False) as f:
            npz = {k: f[k] for k in f.files}
    tree = from_npz_dict(npz)
    tree.npz_path = path

    pb_path = path[:-4] + "_poses_bounds.npy" if path.endswith(".npz") else ""
    if pb_path and os.path.isfile(pb_path):
        pb = np.load(pb_path)
        (tree.ndc_width, tree.ndc_height, tree.ndc_focal, tree.ndc_avg_up,
         tree.ndc_avg_back, tree.ndc_avg_cen) = unpack_llff_poses_bounds(pb)
        tree.use_ndc = True
    return tree


def from_npz_dict(npz: dict[str, Any]) -> N3Tree:
    data_dim = int(np.asarray(npz["data_dim"]).reshape(()))
    data_format = _decode_data_format(npz, data_dim)

    if "invradius3" in npz:
        scale = np.asarray(npz["invradius3"], np.float32).reshape(3)
    else:
        scale = np.full(3, float(np.asarray(npz["invradius"]).reshape(())),
                        np.float32)
    offset = np.asarray(npz["offset"], np.float32).reshape(3)

    child_raw = npz["child"]
    N = int(child_raw.shape[1])
    N3 = N ** 3
    child = np.ascontiguousarray(child_raw, np.int32).reshape(-1)

    if "quant_colors" in npz:
        data, capacity = _decode_quantized(npz, N3, data_dim)
    else:
        data = np.ascontiguousarray(npz["data"]).reshape(-1, data_dim)
        if data.dtype != np.float16:
            raise ValueError("tree data must be float16")
        capacity = data.shape[0] // N3

    extra = None
    if "extra_data" in npz and npz["extra_data"].size:
        extra = np.asarray(npz["extra_data"], np.float32).reshape(-1)

    max_depth = compute_max_depth(child, N3)
    return N3Tree(
        data=data, child=child, offset=offset, scale=scale, N=N,
        data_dim=data_dim, data_format=data_format, extra=extra,
        capacity=capacity, max_depth=max_depth)
