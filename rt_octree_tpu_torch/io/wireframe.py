"""Octree wireframe generation for grid visualization.

The port's own copy of rt_octree_tpu/io/wireframe.py (NumPy).
Reference: N3Tree::gen_wireframe (n3tree.cpp:364-434): emit the 12 edges
of every leaf cube down to a max depth, as line-list vertices in world
space with vertex format pos(3)+color(3)+normal(3) (blue wireframe).

TPU adaptation: iterative level-order expansion in vectorized numpy
instead of per-node recursion (the reference recurses per node in C++).
"""

from __future__ import annotations

import numpy as np

from .n3tree import N3Tree


def _leaf_cells(tree: N3Tree, max_depth: int):
    """All drawable cells: (x, y, z, gridsz) for leaves (or depth-capped
    nodes), integer coords at each cell's own resolution."""
    N = tree.N
    N3 = tree.N3
    child = tree.child.reshape(-1, N3)
    out = []
    # frontier: node id + its cell coords at resolution gridsz/N
    nodes = np.array([0], np.int64)
    coords = np.zeros((1, 3), np.int64)
    depth = 0
    gridsz = N
    while len(nodes):
        links = child[nodes]  # [F, N3]
        ii, jj, kk = np.meshgrid(*([np.arange(N)] * 3), indexing="ij")
        offs = np.stack([ii, jj, kk], -1).reshape(N3, 3)
        ccoords = coords[:, None, :] * N + offs[None, :, :]  # [F, N3, 3]
        is_leaf = (links == 0) | (depth >= max_depth)
        lx = ccoords[is_leaf]
        out.append(np.concatenate(
            [lx, np.full((len(lx), 1), gridsz, np.int64)], axis=1))
        if depth >= max_depth:
            break
        sel = ~is_leaf
        f_idx, slot = np.nonzero(sel)
        nodes = nodes[f_idx] + links[f_idx, slot].astype(np.int64)
        coords = ccoords[f_idx, slot]
        depth += 1
        gridsz *= N
    return np.concatenate(out) if out else np.zeros((0, 4), np.int64)


_EDGE_CORNERS = []
for i in (0, 1):
    for j in (0, 1):
        _EDGE_CORNERS += [((0, i, j), (1, i, j)),
                          ((i, 0, j), (i, 1, j)),
                          ((i, j, 0), (i, j, 1))]
_EDGE_CORNERS = np.array(_EDGE_CORNERS, np.float32)  # [12, 2, 3]


def gen_wireframe(tree: N3Tree, max_depth: int = 4) -> np.ndarray:
    """Returns line-list vertices [n_verts, 9] (pos, color=0, normal=+z),
    the same vertex layout the reference feeds GL."""
    cells = _leaf_cells(tree, max_depth)
    if not len(cells):
        return np.zeros((0, 9), np.float32)
    xyz = cells[:, :3].astype(np.float32)
    inv_g = 1.0 / cells[:, 3].astype(np.float32)
    # world-space bbox corners: (cell/g - offset) / scale
    lo = (xyz * inv_g[:, None] - tree.offset) / tree.scale
    hi = ((xyz + 1) * inv_g[:, None] - tree.offset) / tree.scale

    # [C, 12, 2, 3]: select lo/hi per corner-axis flag
    sel = _EDGE_CORNERS[None]  # [1, 12, 2, 3]
    pos = lo[:, None, None, :] * (1 - sel) + hi[:, None, None, :] * sel
    pos = pos.reshape(-1, 3)
    verts = np.zeros((pos.shape[0], 9), np.float32)
    verts[:, :3] = pos
    verts[:, 8] = 1.0  # normal z=1 (the reference pushes 0,0,...,1)
    return verts
