"""Level-of-detail tree construction: cap an octree at a target depth.

The port's own copy of rt_octree_tpu/io/lod.py (NumPy).  A forward-facing
NDC scene crosses about 90 occupied level-9 leaves per ray, so a coarser
tree is the speed knob there.  The reference has no LOD mechanism (its CUDA
marcher always descends to the stored leaf); this is an offline tool that
pools leaves into a depth-capped tree, trading PSNR for fewer leaf steps.
The output is a plain N3Tree, rendered by the normal pipeline (every
estimator and option works on it).

Pooling: children aggregate into their parent cell with
density-weighted color -- coeffs_parent = sum(w_c * coeffs_c) / sum(w_c)
with w_c = max(sigma_c, 0) (empty children contribute no color; a fully
empty cell keeps zeros), and sigma_parent = mean(sigma_c) (volume-
uniform: expected optical depth through the cell is preserved).  The
same convention PlenOctree-style viewers use for decimation.

CLI: ``python -m rt_octree_tpu_torch.apps.cli lod TREE.npz -d DEPTH -o
OUT.npz``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .n3tree import N3Tree


def node_depths(child: np.ndarray, n3: int) -> np.ndarray:
    """Depth of every node (root = 0) from the relative-skip child
    table; unreachable nodes get -1."""
    n_nodes = child.shape[0] // n3
    depth = np.full(n_nodes, -1, np.int64)
    depth[0] = 0
    frontier = np.array([0], np.int64)
    d = 0
    while frontier.size:
        subs = (frontier[:, None] * n3 + np.arange(n3)[None, :]).reshape(-1)
        skips = child[subs].astype(np.int64)
        nxt = np.unique(subs[skips > 0] // n3 + skips[skips > 0])
        nxt = nxt[depth[nxt] < 0]
        depth[nxt] = d + 1
        frontier = nxt
        d += 1
    return depth


def build_lod(tree: N3Tree, depth: int) -> N3Tree:
    """Pool ``tree`` into a copy whose leaves sit at most ``depth``
    levels below the root (depth >= 1).  A tree already within the cap
    round-trips unchanged (modulo dropped unreachable nodes)."""
    if depth < 1:
        raise ValueError("lod depth must be >= 1")
    n3 = tree.N3
    child = tree.child.reshape(-1).astype(np.int64)
    data = np.asarray(tree.data, np.float32).reshape(-1, tree.data_dim)
    n_nodes = child.shape[0] // n3
    depths = node_depths(child, n3)

    sub_node = np.arange(child.shape[0]) // n3
    child_node = np.where(child > 0, sub_node + child, -1)

    # bottom-up pooled value per NODE (only needed for nodes that will
    # become leaf data, but computing all is simple and exact)
    pooled = np.zeros((n_nodes, tree.data_dim), np.float32)
    max_d = int(depths.max(initial=0))
    for d in range(max_d, -1, -1):
        nodes = np.nonzero(depths == d)[0]
        if nodes.size == 0:
            continue
        subs = (nodes[:, None] * n3 +
                np.arange(n3)[None, :]).reshape(-1)  # [k*n3]
        cn = child_node[subs]
        vals = np.where((cn >= 0)[:, None], pooled[np.maximum(cn, 0)],
                        data[subs])  # children pooled already (deeper)
        vals = vals.reshape(nodes.size, n3, tree.data_dim)
        sigma = vals[..., -1]
        w = np.clip(sigma, 0.0, None) + 1e-12
        coeffs = (vals[..., :-1] * w[..., None]).sum(1) / \
            w.sum(1)[:, None]
        pooled[nodes, :-1] = coeffs
        pooled[nodes, -1] = sigma.mean(1)

    # keep nodes shallower than the cap; subcells of depth-(cap-1)
    # nodes that pointed deeper become leaves holding the pooled value
    keep = (depths >= 0) & (depths <= depth - 1)
    new_idx = np.cumsum(keep) - 1  # old node -> new node (where kept)
    n_new = int(keep.sum())
    new_child = np.zeros(n_new * n3, np.int32)
    new_data = np.zeros((n_new * n3, tree.data_dim), np.float32)

    old_nodes = np.nonzero(keep)[0]
    subs = (old_nodes[:, None] * n3 + np.arange(n3)[None, :]).reshape(-1)
    cn = child_node[subs]
    cut = (cn >= 0) & (depths[old_nodes].repeat(n3) == depth - 1)
    kept_link = (cn >= 0) & ~cut
    # renumbered relative skips for kept links
    new_sub_node = new_idx[old_nodes].repeat(n3)
    new_child[kept_link] = (new_idx[np.maximum(cn, 0)] -
                            new_sub_node)[kept_link].astype(np.int32)
    # data: leaves copy through; cut links take the pooled child value
    new_data[:] = data[subs]
    new_data[cut] = pooled[np.maximum(cn, 0)][cut]

    return dataclasses.replace(
        tree,
        data=new_data.astype(np.float16),
        child=new_child.astype(np.int32),
        capacity=n_new,
        max_depth=min(tree.max_depth, depth),
        npz_path="",
    )


def main(argv=None) -> int:
    """CLI: `rtoctree lod <tree.npz> -d <depth> -o <out.npz>`."""
    import argparse

    from . import n3tree
    from .synthetic import save_npz

    p = argparse.ArgumentParser(
        "rtoctree-lod", description="depth-capped LOD tree construction")
    p.add_argument("file", help="octree npz")
    p.add_argument("-d", "--depth", type=int, required=True,
                   help="max levels of descent in the output")
    p.add_argument("-o", "--out", required=True, help="output npz")
    args = p.parse_args(argv)
    tree = n3tree.load(args.file)
    out = build_lod(tree, args.depth)
    save_npz(out, args.out)
    print(f"lod d={args.depth}: {tree.n_nodes} -> {out.n_nodes} nodes "
          f"({args.out})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
