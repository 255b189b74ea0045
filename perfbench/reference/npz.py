"""Reads a PlenOctree npz (float rows) into host arrays.

The members are read whole and decompressed by one zlib call each: numpy's
own reader streams a member in small pieces, which takes minutes on an
800 MB tree.  Only what the benchmark's scenes hold is accepted: float16
rows of an SH basis, no quantized codebooks, no NDC sidecar.
"""

from __future__ import annotations

import ast
import dataclasses
import struct
import zipfile
import zlib

import numpy as np


@dataclasses.dataclass
class HostTree:
    data: np.ndarray  # [M, data_dim] f16, M = nodes * N^3
    child: np.ndarray  # [M] i32: node skip of an inner slot, 0 for a leaf
    offset: np.ndarray  # [3] f32: tree = offset + scale * world
    scale: np.ndarray  # [3] f32
    N: int
    data_dim: int
    basis_dim: int
    max_depth: int


def _parse_npy(raw: bytes) -> np.ndarray:
    if raw[:6] != b"\x93NUMPY":
        raise ValueError("not an npy member")
    if raw[6] == 1:
        (hlen,) = struct.unpack("<H", raw[8:10])
        off = 10 + hlen
    else:
        (hlen,) = struct.unpack("<I", raw[8:12])
        off = 12 + hlen
    head = ast.literal_eval(raw[off - hlen:off].decode("latin1"))
    if head.get("fortran_order"):
        raise ValueError("fortran-ordered member")
    return np.frombuffer(raw, dtype=np.dtype(head["descr"]),
                         offset=off).reshape(head["shape"])


def read_members(path: str) -> dict:
    out = {}
    with open(path, "rb") as f:
        zf = zipfile.ZipFile(f)
        for info in zf.infolist():
            if not info.filename.endswith(".npy"):
                continue
            f.seek(info.header_offset)
            lh = f.read(30)
            if lh[:4] != b"PK\x03\x04":
                raise ValueError(f"bad local header of {info.filename}")
            name_len, extra_len = struct.unpack("<HH", lh[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            raw = f.read(info.compress_size)
            if info.compress_type == zipfile.ZIP_DEFLATED:
                raw = zlib.decompress(raw, -15)
            elif info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"unsupported compression of "
                                 f"{info.filename}")
            out[info.filename[:-4]] = _parse_npy(raw)
    return out


def depth_of(child: np.ndarray, N3: int) -> int:
    """Levels a root-to-leaf descent takes at most (1 for a lone root)."""
    nodes = child.reshape(-1, N3)
    depth, frontier = 1, np.array([0], np.int64)
    while True:
        links = nodes[frontier]
        at, slot = np.nonzero(links)
        if len(at) == 0:
            return depth
        frontier = np.unique(frontier[at] + links[at, slot].astype(np.int64))
        depth += 1


def read_tree(path: str) -> HostTree:
    m = read_members(path)
    if "quant_colors" in m:
        raise ValueError("quantized trees are not read by the reference")
    data_dim = int(np.asarray(m["data_dim"]).reshape(()))
    fmt = str(np.asarray(m["data_format"]).reshape(()).item()) \
        if "data_format" in m else f"SH{(data_dim - 1) // 3}"
    if not fmt.startswith("SH"):
        raise ValueError(f"format {fmt}: the reference shades SH rows only")
    basis_dim = int(fmt[2:])
    child_raw = m["child"]
    N = int(child_raw.shape[1])
    child = np.ascontiguousarray(child_raw, np.int32).reshape(-1)
    data = np.ascontiguousarray(m["data"]).reshape(-1, data_dim)
    if data.dtype != np.float16:
        raise ValueError("tree rows must be float16")
    return HostTree(
        data=data, child=child,
        offset=np.asarray(m["offset"], np.float32).reshape(3),
        scale=np.asarray(m["invradius3"], np.float32).reshape(3),
        N=N, data_dim=data_dim, basis_dim=basis_dim,
        max_depth=depth_of(child, N ** 3))
