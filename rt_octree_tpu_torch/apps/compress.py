"""Octree compression: median-cut SH quantization + deflate.

The port's own copy of rt_octree_tpu/apps/compress.py (NumPy).
Reference: renderer/scripts/compress_octree.py -- per SH basis function,
the (r,g,b) coefficient triplets of all occupied voxels are quantized
into a 2^bits-entry codebook by median cut; the first ``retain`` basis
functions stay uncompressed; voxels with sigma <= sigma_thresh are
zeroed and excluded.  Output npz keys (decoded by io/n3tree.py, matching
the C++ loader at n3tree.cpp:279-340): quant_colors [n_q, 2^bits, 3] f16,
quant_map [n_q, capacity, N,N,N] u16, sigma f16, data_retained
[retain, capacity, N,N,N, 3] f16.

The reference shells out to svox's CUDA median-cut; this is a vectorized
NumPy median cut (sort-based bucket splitting, exact same algorithm
family; codebooks are content-dependent so byte-identity with svox is
not a goal -- the *format* is the contract).

CLI: ``python -m rt_octree_tpu_torch.apps.cli compress TREE.npz
[--out_dir DIR] [--retain K] [--bits B] [--sigma_thresh S]``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np


def median_cut(points: np.ndarray, bits: int = 16,
               weights: Optional[np.ndarray] = None):
    """Quantize [n, 3] float points into 2^bits codebook entries.

    Returns (colors [2^bits, 3] float32, ids [n] uint16|uint32).
    Vectorized bucket splitting: each round sorts points within their
    bucket along the bucket's widest axis and splits at the median.
    """
    n = points.shape[0]
    ids = np.zeros(n, np.int64)
    pts = points.astype(np.float32)
    if n == 0:
        return np.zeros((2 ** bits, 3), np.float32), ids.astype(np.uint16)

    for _ in range(bits):
        n_buckets = int(ids.max()) + 1
        # per-bucket extent per axis
        mins = np.full((n_buckets, 3), np.inf, np.float32)
        maxs = np.full((n_buckets, 3), -np.inf, np.float32)
        np.minimum.at(mins, ids, pts)
        np.maximum.at(maxs, ids, pts)
        widest = np.argmax(maxs - mins, axis=1)  # [n_buckets]

        coord = pts[np.arange(n), widest[ids]]
        order = np.lexsort((coord, ids))
        sorted_ids = ids[order]
        # rank of each point within its bucket run
        counts = np.bincount(ids, minlength=n_buckets)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank_sorted = np.arange(n) - starts[sorted_ids]
        upper = rank_sorted >= (counts[sorted_ids] + 1) // 2
        new_ids = sorted_ids * 2 + upper
        ids = np.empty(n, np.int64)
        ids[order] = new_ids

    k = 2 ** bits
    colors = np.zeros((k, 3), np.float64)
    cnt = np.bincount(ids, minlength=k).astype(np.float64)
    if weights is not None and weights.size:
        w = weights.astype(np.float64)
        np.add.at(colors, ids, pts * w[:, None])
        wsum = np.zeros(k, np.float64)
        np.add.at(wsum, ids, w)
        cnt = np.maximum(wsum, 1e-12)
    else:
        np.add.at(colors, ids, pts)
        cnt = np.maximum(cnt, 1)
    colors = colors / cnt[:, None]
    id_dtype = np.uint16 if bits <= 16 else np.uint32
    return colors.astype(np.float32), ids.astype(id_dtype)


def compress_tree_dict(z: dict, bits: int = 16, sigma_thresh: float = 2.0,
                       retain: int = 1, weighted: bool = False) -> dict:
    """Apply quantization to a loaded tree npz dict (in place semantics of
    the reference script; returns a new dict)."""
    z = dict(z)
    for k in ("parent_depth", "geom_resize_fact", "n_free", "n_internal",
              "depth_limit"):
        z.pop(k, None)

    data = np.asarray(z["data"])
    N = data.shape[1]
    data_flat = data.reshape(-1, data.shape[-1])
    sigma = data_flat[:, -1].astype(np.float32).copy()
    snz = sigma > sigma_thresh
    sigma[~snz] = 0.0

    coeffs = data_flat[:, :-1].astype(np.float32)
    basis_dim = coeffs.shape[-1] // 3
    coeffs = coeffs.reshape(-1, 3, basis_dim)[snz]  # [n_occ, 3, basis_dim]

    weights = None
    if weighted:
        weights = 1.0 - np.exp(-0.01 * sigma[snz])

    quant_colors, quant_maps, retained = [], [], []
    for i in range(basis_dim):
        tri = np.ascontiguousarray(coeffs[:, :, i])  # [n_occ, 3]
        if i < retain:
            full = np.zeros((snz.shape[0], 3), np.float16)
            full[snz] = tri.astype(np.float16)
            retained.append(full.reshape(-1, N, N, N, 3))
            continue
        colors, id_map = median_cut(tri, bits, weights)
        full_map = np.zeros(snz.shape[0], id_map.dtype)
        full_map[snz] = id_map
        quant_colors.append(colors.astype(np.float16))
        quant_maps.append(full_map.reshape(-1, N, N, N).astype(np.uint16))

    if not quant_colors:
        # retain >= basis_dim leaves nothing to quantize: keep the tree
        # uncompressed rather than emit empty codebooks the decoder
        # (n3tree.cpp:279-340 parity) has no layout for
        print(f"retain={retain} >= basis_dim={basis_dim}: nothing to "
              "quantize; tree left uncompressed", file=sys.stderr)
        return dict(z, data=data)
    z["quant_colors"] = np.stack(quant_colors)
    z["quant_map"] = np.stack(quant_maps)
    z["sigma"] = sigma.astype(np.float16).reshape(-1, N, N, N)
    if retain:
        z["data_retained"] = np.stack(retained)
    del z["data"]
    return z


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("rtoctree-compress")
    parser.add_argument("input", type=str, nargs="+")
    parser.add_argument("--noquant", action="store_true")
    parser.add_argument("--bits", type=int, default=16)
    parser.add_argument("--out_dir", type=str, default="min_alt")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--weighted", action="store_true")
    parser.add_argument("--sigma_thresh", type=float, default=2.0)
    parser.add_argument("--retain", type=int, default=1,
                        help="keep first x SH coeffs uncompressed "
                             "(use 4 for lego)")
    args = parser.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    for fname in args.input:
        out = os.path.join(args.out_dir, os.path.basename(fname))
        if not args.overwrite and os.path.exists(out):
            print(f"{out}: exists, skip")
            continue
        with np.load(fname) as f:
            z = {k: f[k] for k in f.files}
        if not args.noquant:
            if "quant_colors" in z:
                print(f"{fname}: already compressed, skip")
                continue
            z = compress_tree_dict(z, args.bits, args.sigma_thresh,
                                   args.retain, args.weighted)
        np.savez_compressed(out, **z)
        print(f"{fname} -> {out}: "
              f"{os.path.getsize(fname)//2**20} MB -> "
              f"{os.path.getsize(out)//2**20} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
