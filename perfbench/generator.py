"""The scenes' trees: a frozen copy of the port's synthetic generator
(rt_octree_tpu_torch/io/synthetic.py: ``build_tree``, the shell and solid
densities, ``position_color``), so that a benchmark tree stays the tree
the committed nets were trained on whatever the program's copy becomes.

``build_tree`` resolves an N^3-tree wherever the density passes
``sigma_eps`` at a cell centre; the rows are f16 SH coefficients from
``position_color`` and the density.  ``save_npz`` writes PlenOctree's
on-disk layout (data_dim, data_format, invradius3, offset, child, data).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np

# Host threads for the density and colour functions.  The functions are
# row-wise NumPy (ufuncs release the GIL), so a chunk's rows come out as
# they would in one call: the tree is the JAX package's, bit for bit.  A
# depth-9 blobs tree takes minutes in one thread.
_WORKERS = min(os.cpu_count() or 1, 8)
_ROWS = 1 << 22  # rows per threaded call of a leaf-data function


def _rowwise(fn, pos: np.ndarray, *args) -> np.ndarray:
    """fn(pos, *args) for a row-wise fn, in chunks of _ROWS rows on the
    thread pool."""
    n = pos.shape[0]
    if n <= _ROWS or _WORKERS == 1:
        return fn(pos, *args)
    with ThreadPoolExecutor(_WORKERS) as ex:
        parts = list(ex.map(lambda i: fn(pos[i:i + _ROWS], *args),
                            range(0, n, _ROWS)))
    return np.concatenate(parts)


def _occupancy_pyramid(occ_fine: np.ndarray, N: int, depth: int):
    """occ[l] of shape (N^l,)*3 for l=0..depth, by N^3 any-reduction."""
    levels = [occ_fine]
    cur = occ_fine
    for _ in range(depth):
        r = cur.shape[0] // N
        cur = cur.reshape(r, N, r, N, r, N).any(axis=(1, 3, 5))
        levels.append(cur)
    levels.reverse()  # levels[l] has resolution N^l
    return levels


def build_tree(
    sigma_fn: Callable[[np.ndarray], np.ndarray],
    color_fn: Callable[[np.ndarray, int], np.ndarray],
    depth: int = 7,
    N: int = 2,
    basis_dim: int = 9,
    sigma_eps: float = 1e-3,
    offset=(0.5, 0.5, 0.5),
    scale=(0.5, 0.5, 0.5),
) -> dict:
    """Build an N^3-tree whose leaves resolve wherever sigma > sigma_eps.

    sigma_fn(pos[ M,3 in tree space 0..1]) -> [M] densities
    color_fn(pos[M,3], basis_dim) -> [M, 3*basis_dim] SH coefficients
    """
    res = N ** depth
    # fine-grid occupancy from cell centers (chunked, f32: the grid can be
    # hundreds of millions of points at depth >= 9)
    g = ((np.arange(res, dtype=np.float32) + 0.5) / res)
    occ_fine = np.empty((res, res, res), bool)
    chunk = max(1, (1 << 24) // (res * res))
    if res ** 3 > _ROWS:  # at least one chunk a thread
        chunk = max(1, min(chunk, -(-res // _WORKERS)))

    def fill(x0):
        xs = g[x0:x0 + chunk]
        X, Y, Z = np.meshgrid(xs, g, g, indexing="ij")
        pos = np.stack([X, Y, Z], -1).reshape(-1, 3)
        occ_fine[x0:x0 + chunk] = (
            sigma_fn(pos) > sigma_eps).reshape(len(xs), res, res)
    with ThreadPoolExecutor(_WORKERS) as ex:
        list(ex.map(fill, range(0, res, chunk)))
    occ = _occupancy_pyramid(occ_fine, N, depth)

    # nodes: level l in [0, depth-1]; a cell is a node iff occupied
    # (root level 0 is always a node)
    node_cells = []  # per level: sorted flat cell indices that are nodes
    for l in range(depth):
        r = N ** l
        if l == 0:
            node_cells.append(np.array([0], np.int64))
        else:
            flat = np.nonzero(occ[l].reshape(-1))[0]
            node_cells.append(flat)
    level_offset = np.zeros(depth + 1, np.int64)
    for l in range(depth):
        level_offset[l + 1] = level_offset[l] + len(node_cells[l])
    n_nodes = int(level_offset[depth])

    N3 = N ** 3
    data_dim = 3 * basis_dim + 1
    child = np.zeros((n_nodes, N3), np.int32)
    data = np.zeros((n_nodes, N3, data_dim), np.float16)

    for l in range(depth):
        cells = node_cells[l]
        if len(cells) == 0:
            continue
        node_ids = level_offset[l] + np.arange(len(cells))
        r = N ** l
        cx = cells // (r * r)
        cy = (cells // r) % r
        cz = cells % r
        rc = r * N
        # child cell coords for each of the N3 slots
        ii, jj, kk = np.meshgrid(np.arange(N), np.arange(N), np.arange(N),
                                 indexing="ij")
        ccx = cx[:, None] * N + ii.reshape(-1)[None, :]
        ccy = cy[:, None] * N + jj.reshape(-1)[None, :]
        ccz = cz[:, None] * N + kk.reshape(-1)[None, :]
        ccell = (ccx * rc + ccy) * rc + ccz  # [n_l, N3] child cell flat idx

        # which child cells are themselves nodes at level l+1?
        skips = np.zeros_like(ccell)
        if l + 1 < depth and len(node_cells[l + 1]):
            next_cells = node_cells[l + 1]
            pos_in_next = np.searchsorted(next_cells, ccell)
            pos_in_next = np.clip(pos_in_next, 0, len(next_cells) - 1)
            is_node = next_cells[pos_in_next] == ccell
            child_ids = level_offset[l + 1] + pos_in_next
            skips = np.where(is_node, child_ids - node_ids[:, None], 0)
        # slot axis is already in (i*N+j)*N+k order (k fastest in meshgrid)
        child[node_ids] = skips.astype(np.int32)

        # leaf data at child-cell centers
        centers = np.stack(
            [(ccx + 0.5) / rc, (ccy + 0.5) / rc, (ccz + 0.5) / rc],
            axis=-1).reshape(-1, 3)
        sig = _rowwise(sigma_fn, centers).astype(np.float16)
        col = _rowwise(color_fn, centers, basis_dim).astype(np.float16)
        d = np.concatenate([col, sig[:, None]], axis=-1)
        data[node_ids] = d.reshape(len(cells), N3, data_dim)

    return {"data": data.reshape(-1, data_dim), "child": child.reshape(-1),
            "offset": np.asarray(offset, np.float32),
            "scale": np.asarray(scale, np.float32), "N": N,
            "data_dim": data_dim, "basis_dim": basis_dim,
            "capacity": n_nodes, "max_depth": depth}


def shell_sigma(pos: np.ndarray, center=(0.5, 0.5, 0.5), radius=0.3,
                thickness=0.05, amplitude=60.0) -> np.ndarray:
    """Spherical shell density: high sigma near |p-c| == radius.  The
    quartic falloff keeps occupancy a few voxel layers thick (real
    PlenOctrees are surface-sparse; a soft gaussian at high resolution
    would occupy tens of millions of voxels)."""
    p = pos.astype(np.float32) - np.asarray(center, np.float32)
    d = np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2 + p[..., 2] ** 2)
    return amplitude * np.exp(-((d - radius) / thickness) ** 4)


def solid_sigma(pos: np.ndarray, seed: int = 3,
                amplitude: float = 600.0) -> np.ndarray:
    """HARD-surface scene: union of solid spheres + boxes with constant
    high sigma inside and zero outside -- the NeRF-synthetic "lego"
    occupancy class (opaque surfaces; rays consume their SPP thresholds
    within a couple of leaf crossings after first contact), the scene
    family the 30 FPS target was set on.  Unlike ``shell_sigma`` there
    is no soft low-sigma fringe for survivor rays to graze."""
    rng = np.random.default_rng(seed)
    p = pos.astype(np.float32)
    inside = np.zeros(p.shape[0], bool)
    for c, r in zip(rng.uniform(0.3, 0.7, (5, 3)),
                    rng.uniform(0.06, 0.16, 5)):
        inside |= np.linalg.norm(p - c.astype(np.float32), axis=-1) < r
    for c, h in zip(rng.uniform(0.3, 0.7, (3, 3)),
                    rng.uniform(0.04, 0.12, (3, 3))):
        inside |= np.all(np.abs(p - c.astype(np.float32)) <
                         h.astype(np.float32), axis=-1)
    return np.where(inside, amplitude, 0.0).astype(np.float32)


def position_color(pos: np.ndarray, basis_dim: int) -> np.ndarray:
    """SH coefficients: DC from position (pre-sigmoid logits), small
    deterministic higher-order terms."""
    M = pos.shape[0]
    out = np.zeros((M, 3 * basis_dim), np.float32)
    # DC components per channel (sigmoid(SH(dir).c) ~ position-hued)
    C0 = 0.28209479177387814
    logits = 4.0 * (pos - 0.5)  # in [-2, 2]
    for c in range(3):
        out[:, c * basis_dim] = logits[:, c] / C0
        if basis_dim > 1:
            out[:, c * basis_dim + 1] = 0.3 * np.sin(12.3 * pos[:, c])
            out[:, c * basis_dim + 2] = 0.2 * np.cos(7.7 * pos[:, (c + 1) % 3])
    return out


def make_synthetic_tree(kind: str = "shell", depth: int = 7,
                        basis_dim: int = 9) -> dict:
    if kind == "shell":
        res = 2 ** depth
        thickness = max(3.0 / res, 0.02)
        amplitude = 4.0 / thickness  # shell optical depth ~4 (mostly opaque)
        return build_tree(
            lambda p: shell_sigma(p, thickness=thickness,
                                  amplitude=amplitude),
            position_color, depth=depth, basis_dim=basis_dim,
            sigma_eps=1e-2)
    if kind == "solid":
        return build_tree(solid_sigma, position_color, depth=depth,
                          basis_dim=basis_dim, sigma_eps=1e-2)
    raise ValueError(kind)


def save_npz(tree: dict, path: str) -> None:
    """``tree`` as ``build_tree`` returns it, in the npz layout."""
    N, dd = tree["N"], tree["data_dim"]
    cap = tree["child"].shape[0] // N ** 3
    np.savez(path, data_dim=np.int64(dd),
             data_format=np.str_(f"SH{tree['basis_dim']}"),
             invradius3=tree["scale"].astype(np.float32),
             offset=tree["offset"].astype(np.float32),
             child=tree["child"].reshape(cap, N, N, N),
             data=tree["data"].reshape(cap, N, N, N, dd))
