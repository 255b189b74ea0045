"""Procedural PlenOctree generation for tests and benchmarks.

The port's own copy of rt_octree_tpu/io/synthetic.py (NumPy), plus
``with_lobes`` (SG and ASG rows of any basis_dim on a synthetic tree),
``random_lut``, the random jump LUTs that kernel K3's skip distances are
tested on, ``random_mesh_pass``, and ``aimed_rays`` with
``ray_world_depths``, ray batches for the ray-batch API.

No scene data ships with this environment, so benchmarks and end-to-end
tests build octrees with the same on-disk format, topology statistics
(sparse, deep where occupied) and data layout as real PlenOctrees
(see io/n3tree.py for the format contract).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np

from .n3tree import BasisFormat, DataFormat, N3Tree


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
) -> N3Tree:
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

    tree = N3Tree(
        data=data.reshape(-1, data_dim),
        child=child.reshape(-1),
        offset=np.asarray(offset, np.float32),
        scale=np.asarray(scale, np.float32),
        N=N, data_dim=data_dim,
        data_format=DataFormat(BasisFormat.SH, basis_dim),
        capacity=n_nodes, max_depth=depth)
    return tree


def shell_sigma(pos: np.ndarray, center=(0.5, 0.5, 0.5), radius=0.3,
                thickness=0.05, amplitude=60.0) -> np.ndarray:
    """Spherical shell density: high sigma near |p-c| == radius.  The
    quartic falloff keeps occupancy a few voxel layers thick (real
    PlenOctrees are surface-sparse; a soft gaussian at high resolution
    would occupy tens of millions of voxels)."""
    p = pos.astype(np.float32) - np.asarray(center, np.float32)
    d = np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2 + p[..., 2] ** 2)
    return amplitude * np.exp(-((d - radius) / thickness) ** 4)


def blob_sigma(pos: np.ndarray, seed: int = 0, n_blobs: int = 24,
               amplitude: float = 80.0) -> np.ndarray:
    """Union of gaussian blobs -- irregular occupancy like real scenes."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, (n_blobs, 3))
    radii = rng.uniform(0.02, 0.12, n_blobs)
    out = np.zeros(pos.shape[0])
    for c, r in zip(centers, radii):
        d = np.linalg.norm(pos - c, axis=-1)
        out += amplitude * np.exp(-((d / r) ** 2) * 4)
    return out


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
                        basis_dim: int = 9) -> N3Tree:
    if kind == "shell":
        res = 2 ** depth
        thickness = max(3.0 / res, 0.02)
        amplitude = 4.0 / thickness  # shell optical depth ~4 (mostly opaque)
        return build_tree(
            lambda p: shell_sigma(p, thickness=thickness,
                                  amplitude=amplitude),
            position_color, depth=depth, basis_dim=basis_dim,
            sigma_eps=1e-2)
    if kind == "blobs":
        return build_tree(blob_sigma, position_color, depth=depth,
                          basis_dim=basis_dim, sigma_eps=1e-2)
    if kind == "solid":
        return build_tree(solid_sigma, position_color, depth=depth,
                          basis_dim=basis_dim, sigma_eps=1e-2)
    raise ValueError(kind)


def with_lobes(tree: N3Tree, fmt: BasisFormat, seed: int,
               coef_scale: float = 0.5) -> N3Tree:
    """``tree`` (any basis_dim) turned into SG or ASG rows, in place: its
    data format set to ``fmt`` at its basis_dim, a seeded ``extra`` of the
    format's layout (SG [bd, 4]: sharpness in [0.5, 4], a lobe axis; ASG
    [bd, 11]: two sharpnesses in [0.5, 4], three axes; normal draws
    elsewhere), and seeded normal coefficients of scale ``coef_scale``
    added to every row's 3 x bd values, so that every lobe shades."""
    bd = tree.data_format.basis_dim
    rs = np.random.default_rng(seed)
    width, sharp = (4, 1) if fmt == BasisFormat.SG else (11, 2)
    extra = rs.standard_normal((bd, width))
    extra[:, :sharp] = rs.uniform(0.5, 4.0, (bd, sharp))
    coef = tree.data[:, :3 * bd].astype(np.float32)
    coef += coef_scale * rs.standard_normal(coef.shape).astype(np.float32)
    tree.data[:, :3 * bd] = coef.astype(tree.data.dtype)
    tree.data_format = DataFormat(fmt, bd)
    tree.extra = extra.astype(np.float32)
    return tree


def refine_tree(tree: N3Tree, sigma_fn: Callable, color_fn: Callable,
                levels: int = 2, max_refine: int = 150_000,
                sigma_eps: float = 1e-2) -> N3Tree:
    """Subdivide the tree's DEEPEST occupied leaves ``levels`` further,
    evaluating sigma/color at the finer cell centers.

    Dense-grid generation at depth 11 needs a 2048^3 occupancy grid
    (tens of GB); this instead deepens an existing tree only where
    occupied -- the same surface-sparse structure real PlenOctrees have.
    ``max_refine`` bounds the per-level refinement (deterministic
    stride subsample)."""
    N = tree.N
    assert N == 2
    N3 = 8
    data_dim = tree.data_dim
    child = tree.child.reshape(-1, N3).copy()
    data = tree.data.reshape(-1, N3, data_dim).copy()

    # level-order sweep: per-node depth + cell coords (resolution
    # 2^depth), vectorized one frontier at a time
    cap = child.shape[0]
    node_depth = np.zeros(cap, np.int32)
    node_cell = np.zeros((cap, 3), np.int64)
    ii, jj, kk = np.meshgrid(np.arange(2), np.arange(2), np.arange(2),
                             indexing="ij")
    digits = np.stack([ii, jj, kk], -1).reshape(N3, 3)
    frontier = np.array([0], np.int64)
    d = 0
    while len(frontier):
        sk = child[frontier]  # [F, 8]
        mask = sk != 0
        kid_ids = (frontier[:, None] + sk)[mask]
        kid_cells = (node_cell[frontier][:, None, :] * 2 +
                     digits[None, :, :])[mask]
        node_depth[kid_ids] = d + 1
        node_cell[kid_ids] = kid_cells
        frontier = kid_ids
        d += 1

    max_d = int(node_depth.max()) + 1  # leaf depth of the deepest slots
    for lvl in range(levels):
        depth_now = max_d + lvl
        # leaf slots at the current deepest level with sigma > eps
        deepest = node_depth == depth_now - 1
        cand_nodes, cand_slots = np.nonzero(
            (child == 0) & deepest[:, None] &
            (data[..., data_dim - 1].astype(np.float32) > sigma_eps))
        if len(cand_nodes) > max_refine:
            stride = len(cand_nodes) // max_refine + 1
            cand_nodes = cand_nodes[::stride]
            cand_slots = cand_slots[::stride]
        k = len(cand_nodes)
        if k == 0:
            break
        base = child.shape[0]
        child[cand_nodes, cand_slots] = (base + np.arange(k) -
                                         cand_nodes).astype(np.int32)
        # new nodes' cells = refined slot cells; children at depth_now+1
        slot_cell = (node_cell[cand_nodes] * 2 + digits[cand_slots])
        child_cells = (slot_cell[:, None, :] * 2 +
                       digits[None, :, :])  # [k, 8, 3]
        res = float(2 ** (depth_now + 1))
        centers = ((child_cells.astype(np.float64) + 0.5) / res
                   ).reshape(-1, 3).astype(np.float32)
        sig = sigma_fn(centers).astype(np.float16)
        col = color_fn(centers, (data_dim - 1) // 3).astype(np.float16)
        nd = np.concatenate([col, sig[:, None]], -1).reshape(k, N3,
                                                             data_dim)
        child = np.concatenate([child, np.zeros((k, N3), np.int32)])
        data = np.concatenate([data, nd])
        node_depth = np.concatenate(
            [node_depth, np.full(k, depth_now, np.int32)])
        node_cell = np.concatenate([node_cell, slot_cell])

    return N3Tree(
        data=data.reshape(-1, data_dim), child=child.reshape(-1),
        offset=tree.offset, scale=tree.scale, N=N, data_dim=data_dim,
        data_format=tree.data_format, capacity=child.shape[0],
        max_depth=int(node_depth.max()) + 1)


def make_deep_chain_tree(depth: int, basis_dim: int = 1) -> N3Tree:
    """Tiny tree of arbitrary depth: one node per level, slot 0
    subdivides into the next level, the other 7 slots are leaves with
    graded sigma/DC color.  Exercises deep-tree machinery (continued
    descent below the LUT) without a huge occupancy grid."""
    data_dim = 3 * basis_dim + 1
    cap = depth
    child = np.zeros((cap, 8), np.int32)
    data = np.zeros((cap, 8, data_dim), np.float16)
    C0 = 0.28209479177387814
    for l in range(cap):
        if l + 1 < cap:
            child[l, 0] = 1  # skip to the next node
        data[l, :, data_dim - 1] = np.linspace(0.4, 3.0, 8) * (
            1.0 + 0.1 * l)
        for c in range(3):
            data[l, :, c * basis_dim] = (np.linspace(-1.5, 1.5, 8) / C0
                                         ) * (1 if c != 1 else -1)
    return N3Tree(
        data=data.reshape(-1, data_dim),
        child=child.reshape(-1),
        offset=np.asarray((0.5, 0.5, 0.5), np.float32),
        scale=np.asarray((0.5, 0.5, 0.5), np.float32),
        N=2, data_dim=data_dim,
        data_format=DataFormat(BasisFormat.SH, basis_dim),
        capacity=cap, max_depth=depth)


def tree_to_npz_dict(tree: N3Tree) -> dict:
    """Round-trip a tree into the on-disk npz key set (with SG / ASG
    lobes, their ``extra_data``)."""
    N3 = tree.N3
    cap = tree.child.shape[0] // N3
    out = {
        "data_dim": np.int64(tree.data_dim),
        "data_format": np.str_(tree.data_format.to_string()),
        "invradius3": tree.scale.astype(np.float32),
        "offset": tree.offset.astype(np.float32),
        "child": tree.child.reshape(cap, tree.N, tree.N, tree.N),
        "data": tree.data.reshape(cap, tree.N, tree.N, tree.N, tree.data_dim),
    }
    if tree.extra is not None:
        out["extra_data"] = tree.extra.astype(np.float32)
    return out


def save_npz(tree: N3Tree, path: str) -> None:
    np.savez(path, **tree_to_npz_dict(tree))


def random_lut(res: int, occupancy: float, seed: int) -> np.ndarray:
    """A [res^3, 2] int32 jump LUT of random packed entries whose sigma
    lane holds random non-zero bits at a share ``occupancy`` of the cells
    and 0 at the others."""
    rs = np.random.default_rng(seed)
    n = res ** 3
    lut = rs.integers(-2 ** 31, 2 ** 31, (n, 2), dtype=np.int32)
    occ = rs.random(n, dtype=np.float32) < occupancy
    lut[:, 1] = np.where(occ, np.maximum(lut[:, 1] & 0x7fffffff, 1), 0)
    return lut


def random_mesh_pass(seed: int, n: int, background=None):
    """A mesh pass for ``n`` pixels as f32 arrays: colour [n, 3] in [0, 1)
    and ray depth [n] in [2, 6), +inf (no mesh) on about half the pixels;
    with ``background`` the neutral pass (no mesh anywhere, every pixel
    that colour)."""
    if background is not None:
        return (np.full((n, 3), background, np.float32),
                np.full(n, np.inf, np.float32))
    rs = np.random.default_rng(seed)
    depth = rs.uniform(2.0, 6.0, n).astype(np.float32)
    depth[rs.random(n) < 0.5] = np.inf
    return rs.random((n, 3), np.float32), depth


def aimed_rays(rs: np.random.Generator, n: int, spread: float = 0.5,
               unit: bool = True):
    """n rays drawn from ``rs``, from a sphere of radius 3 towards uniform
    points of [-spread, spread]^3 (through the synthetic shells' walls):
    (dirs, vdirs, cens), float32 [n, 3].  The view dirs are the dirs
    rotated (each mixed with its [1, 2, 0] permutation); ``unit=False``
    scales the dirs, then the view dirs, by factors in [0.5, 2)."""
    o = rs.standard_normal((n, 3))
    o *= 3.0 / np.linalg.norm(o, axis=1, keepdims=True)
    d = rs.uniform(-spread, spread, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v = d[:, [1, 2, 0]] * 0.6 + d * 0.8
    if not unit:
        d = d * rs.uniform(0.5, 2.0, (n, 1))
        v = v * rs.uniform(0.5, 2.0, (n, 1))
    return tuple(np.ascontiguousarray(a, np.float32) for a in (d, v, o))


def ray_world_depths(rs: np.random.Generator, n: int) -> np.ndarray:
    """World depths [n] float32 for ``aimed_rays``: finite ones that cut
    through the shells' walls, inf on a quarter of the rays and 3e9 (past
    the frame's 1e9 clamp of a mesh depth) on an eighth."""
    tm = rs.uniform(2.0, 3.5, n)
    tm[::4] = np.inf
    tm[1::8] = 3e9
    return tm.astype(np.float32)
