"""Octree traversal tensors, the jump-LUT build (kernel K3) and the
vectorized query, in PyTorch.

Counterpart of rt_octree_tpu/ops/traversal.py without its TPU wide-row
machinery (brick tables, pair-packed data, sparse bricks): the port marches
one thread per pixel over the packed jump LUT plus continued ``chs``
descent, as the reference does (n3tree_query.hpp:13-48).  Where the JAX
package anchors a deep tree's LUT at its sparse-brick level, the port
anchors it at the same level and marks the cells still internal there
occupied, so that the LUT carries the same empty-space skip distances.

Kernel K3 (csrc/lut.cu) builds the LUT and its empty-space skip distances
on the card; ``lut_build_plain`` and ``add_skip_distances_plain`` are its
plain PyTorch versions, which CPU tensors take.
"""

from __future__ import annotations

import ctypes
import dataclasses
import sys
from typing import Optional

import numpy as np
import torch

from ..io.n3tree import N3Tree
from ..native import build as native

LUT_PTR_BITS = 27
LUT_DEPTH_SENTINEL = (1 << 5) - 1  # depth field all-ones => internal node
LUT_PTR_MASK = (1 << LUT_PTR_BITS) - 1
# sigma lane of the internal cells of a deep tree's partial LUT: non-zero
# (occupied for the skip build) and above the distances' 1..255; as f32
# bits a denormal.  The march descends from such a cell and reads the
# leaf's own sigma, never this lane.
LUT_INTERNAL_MARK = 1 << 8
# deepest LUT level of a deep tree's partial LUT (JAX: its sparse bricks)
PARTIAL_LUT_MAX_LEVELS = 9
# cells per chunk of the plain LUT build (bounds its int64 temporaries)
_PLAIN_CHUNK = 1 << 22


@dataclasses.dataclass
class DeviceTree:
    """Tree tensors on one device plus static metadata."""

    data: torch.Tensor  # [M, data_dim] f16 shading rows
    # fused march rows: chs[:, 0] = child skip, chs[:, 1] = f32 sigma bits
    chs: torch.Tensor  # [M, 2] i32
    offset: torch.Tensor  # [3] f32
    scale: torch.Tensor  # [3] f32
    extra: torch.Tensor  # [E] f32 (SG/ASG) or [0]
    # lut[:, 0] = packed (depth<<27 | ptr); lut[:, 1] = f32 sigma bits of
    # the shallow leaf, or the skip distance bits; 0 when still internal
    # (LUT_INTERNAL_MARK on a deep tree's partial LUT)
    lut: torch.Tensor  # [res^3, 2] i32, or [0, 2]
    N: int
    data_dim: int
    basis_dim: int
    fmt: int  # BasisFormat.value
    max_depth: int
    lut_levels: int
    # empty-space skip radius cap (0 = no distances in the LUT)
    skip_cap: int = 0
    # (width, height, focal) or None
    ndc: Optional[tuple] = None

    @property
    def N3(self) -> int:
        return self.N ** 3

    @property
    def device(self) -> torch.device:
        return self.chs.device


# ---------------------------------------------------------------------------
# kernel K3: LUT build + skip distances
# ---------------------------------------------------------------------------

def lut_build_plain(chs: torch.Tensor, N: int, levels: int,
                    internal_mark: int = 0) -> torch.Tensor:
    """Plain version of K3's LUT build (traversal.py:_device_lut_build):
    per cell of the (N^levels)^3 grid, the root-to-level descent into
    (depth<<27 | ptr, sigma bits), or (31<<27 | node, ``internal_mark``)
    where the cell is still internal.  Built level by level, as the kernel
    builds it 3 levels a launch: a cell copies its parent cell when that is
    a leaf, and otherwise descends one level from the parent's node."""
    dev = chs.device
    N3 = N ** 3
    chs64 = chs.to(torch.int64)
    # level 0: the root, internal, node 0; entries (packed, sigma bits) in
    # int64 so that depth 31 stays positive until the last level
    table = torch.tensor([[LUT_DEPTH_SENTINEL << LUT_PTR_BITS, 0]],
                         dtype=torch.int64, device=dev)
    for lev in range(levels):
        res, pres = N ** (lev + 1), N ** lev
        n_cells = res ** 3
        last = lev == levels - 1
        mark = internal_mark if last else 0
        out = torch.empty((n_cells, 2), dtype=torch.int64, device=dev)
        for c0 in range(0, n_cells, _PLAIN_CHUNK):
            idx = torch.arange(c0, min(c0 + _PLAIN_CHUNK, n_cells),
                               dtype=torch.int64, device=dev)
            z = idx % res
            y = (idx // res) % res
            x = idx // (res * res)
            parent = table[((x // N) * pres + y // N) * pres + z // N]
            node = parent[:, 0] & LUT_PTR_MASK
            internal = (parent[:, 0] >> LUT_PTR_BITS) == LUT_DEPTH_SENTINEL
            sub = node * N3 + ((x % N) * N + y % N) * N + z % N
            row = chs64[torch.where(internal, sub, 0)]
            leaf = internal & (row[:, 0] == 0)
            inner = internal & ~leaf
            packed = torch.where(leaf, ((lev + 1) << LUT_PTR_BITS) | sub,
                                 parent[:, 0])
            packed = torch.where(inner, (LUT_DEPTH_SENTINEL << LUT_PTR_BITS)
                                 | (node + row[:, 0]), packed)
            sig = torch.where(leaf, row[:, 1], parent[:, 1])
            out[c0:c0 + idx.numel(), 0] = packed
            out[c0:c0 + idx.numel(), 1] = torch.where(inner, mark, sig)
        table = out
    if levels <= 0:
        table[:, 1] = internal_mark
    # wrap to i32 two's complement (depth 31 sets the sign bit)
    table[:, 0] = torch.where(table[:, 0] >= (1 << 31),
                              table[:, 0] - (1 << 32), table[:, 0])
    return table.to(torch.int32)


def build_lut(chs: torch.Tensor, N: int, levels: int,
              internal_mark: int = 0) -> torch.Tensor:
    """K3 LUT build wrapper: plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor (one launch per 3 levels, the top launch
    taking the remainder).  ``internal_mark`` goes into the sigma lane of
    the cells still internal at ``levels``."""
    if chs.device.type == "cpu":
        return lut_build_plain(chs, N, levels, internal_mark)
    _check_cuda_i32(chs, "chs")
    if chs.shape[0] >= (1 << LUT_PTR_BITS):
        raise ValueError("chs rows >= 2^27 cannot be packed into the LUT")
    res = N ** levels
    lut = torch.empty((res ** 3, 2), dtype=torch.int32, device=chs.device)
    cells = ctypes.c_longlong()
    native.check(native.entry("rt_lut_build_scratch")(
        N, levels, ctypes.byref(cells)), "rt_lut_build_scratch")
    # the coarse tables of the levels above, 3 levels apart
    scratch = torch.empty((max(cells.value, 1), 2), dtype=torch.int32,
                          device=chs.device)
    launches = ctypes.c_int()
    fn = native.entry("rt_lut_build")
    with torch.cuda.device(chs.device):
        rc = fn(chs.data_ptr(), lut.data_ptr(), scratch.data_ptr(), N,
                levels, internal_mark, ctypes.byref(launches),
                native.stream_ptr(chs.device))
        native.count_launch("lut_build", launches.value)
    native.check(rc, "lut_step_kernel")
    return lut


def add_skip_distances_plain(lut: torch.Tensor, res: int,
                             cap: int = 12) -> torch.Tensor:
    """Plain version of K3's skip build (traversal.py:_add_skip_distances):
    ``cap`` rounds of the 3x3x3 min-window + 1 give the capped Chebyshev
    distance to the nearest occupied (sigma bits != 0) cell, stored as the
    integer bits 1..cap in the sigma lane of empty cells."""
    occ = (lut[:, 1] != 0).reshape(res, res, res)
    inf = float(cap + 1)
    d = torch.where(occ, 0.0, inf)
    for _ in range(cap):
        # the 3x3x3 min-window, one axis at a time (a min over a box is
        # separable); taps outside the grid are left out, which is the INF
        # padding of the reference (the centre tap is in every window, so
        # padding never lowers a minimum)
        m = d.clone()
        for ax in range(3):
            prev = m.clone()
            lo, hi = m.narrow(ax, 1, res - 1), m.narrow(ax, 0, res - 1)
            torch.minimum(lo, prev.narrow(ax, 0, res - 1), out=lo)
            torch.minimum(hi, prev.narrow(ax, 1, res - 1), out=hi)
        d = torch.minimum(d, m + 1.0)
    d = torch.clamp(d, max=float(cap)).reshape(-1).to(torch.int32)
    lane1 = torch.where(occ.reshape(-1), lut[:, 1], d)
    return torch.stack([lut[:, 0], lane1], dim=-1)


def add_skip_distances(lut: torch.Tensor, res: int,
                       cap: int = 12) -> torch.Tensor:
    """K3 skip-distance wrapper: plain version for a CPU tensor, the CUDA
    kernels for a CUDA tensor, which update ``lut`` in place and return it:
    the same capped Chebyshev distance as three passes of a 1-D transform,
    along z, y and x (csrc/lut.cu)."""
    if lut.device.type == "cpu":
        return add_skip_distances_plain(lut, res, cap)
    _check_cuda_i32(lut, "lut")
    if not 1 <= cap <= 253:
        raise ValueError(f"skip cap {cap} outside 1..253 (uint8 scratch)")
    if lut.shape != (res ** 3, 2):
        raise ValueError(f"lut shape {tuple(lut.shape)} != ({res ** 3}, 2)")
    # the per-axis distances after the z and the y pass
    scratch = torch.empty((2, res ** 3), dtype=torch.uint8,
                          device=lut.device)
    launches = ctypes.c_int()
    fn = native.entry("rt_skip_distances")
    with torch.cuda.device(lut.device):
        rc = fn(lut.data_ptr(), scratch[0].data_ptr(),
                scratch[1].data_ptr(), res, cap, ctypes.byref(launches),
                native.stream_ptr(lut.device))
        native.count_launch("skip_distances", launches.value)
    native.check(rc, "skip_rows_kernel / skip_axis_kernel")
    return lut


def _check_cuda_i32(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got "
                         f"{t.device}")
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 2 \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous [n, 2] int32 "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# upload
# ---------------------------------------------------------------------------

def upload_tree(tree: N3Tree, lut_levels: int = 7, *, device,
                skip_cap: int = 12,
                force_sparse_brick: bool = False) -> DeviceTree:
    """Host tree -> tensors on ``device``.  ``lut_levels=0`` disables the
    LUT.  The LUT is built on the device (kernel K3).  When it witnesses
    every leaf's occupancy, ``skip_cap > 0`` bakes the Chebyshev
    empty-space skip distances into its sigma lane: at the tree's full
    depth, or on the partial LUT of a deep tree (N = 2, depth > 9, or any
    depth >= 3 with ``force_sparse_brick``, kept for tests under the JAX
    package's name).  That LUT is anchored where the JAX package anchors
    its sparse bricks, at min(lut_levels, max_depth - 2, 9), and when it
    lands on max_depth - 2 its internal cells carry LUT_INTERNAL_MARK, so
    that they count as occupied.  Trees with >= 2^27 sub-pointers, which
    the packed LUT cannot address, fall back EXPLICITLY (stderr) to
    per-level descent."""
    device = torch.device(device)
    sigma_np = np.ascontiguousarray(tree.data[:, tree.data_dim - 1])
    sigma_bits = sigma_np.astype(np.float32).view(np.int32)
    chs_np = np.stack([tree.child.astype(np.int32), sigma_bits], axis=-1)
    chs = torch.from_numpy(chs_np).to(device)

    partial = tree.N == 2 and tree.max_depth >= 3 and (
        tree.max_depth > PARTIAL_LUT_MAX_LEVELS or force_sparse_brick)
    eff_levels = 0
    if lut_levels > 0 and tree.max_depth > 0:
        lut_levels = min(lut_levels, tree.max_depth)
        if partial:
            lut_levels = min(lut_levels, tree.max_depth - 2,
                             PARTIAL_LUT_MAX_LEVELS)
            partial = lut_levels == tree.max_depth - 2
        max_ptr = max(tree.child.shape[0], 1)
        if max_ptr < (1 << LUT_PTR_BITS):
            eff_levels = lut_levels
        else:
            print(f"[rt-octree] tree has {max_ptr} sub-pointers >= 2^"
                  f"{LUT_PTR_BITS}: packed jump LUT unavailable, "
                  "marching by per-level descent (slow path)",
                  file=sys.stderr)
    if tree.max_depth > 11:
        print(f"[rt-octree] max_depth {tree.max_depth} > 11: marching "
              f"with a level-{eff_levels} LUT + descent", file=sys.stderr)

    # a tree's max_depth is its deepest leaf, so level max_depth - 2 has
    # internal cells wherever the partial rule applies
    marked = partial and eff_levels > 0
    if eff_levels > 0:
        lut = build_lut(chs, tree.N, eff_levels,
                        LUT_INTERNAL_MARK if marked else 0)
    else:
        lut = torch.zeros((0, 2), dtype=torch.int32, device=device)
    eff_skip = 0
    if skip_cap > 0 and eff_levels > 0 and (
            eff_levels == tree.max_depth or marked):
        lut = add_skip_distances(lut, tree.N ** eff_levels, skip_cap)
        eff_skip = skip_cap

    extra = tree.extra if tree.extra is not None else np.zeros(0, np.float32)
    ndc = None
    if tree.use_ndc and tree.ndc_width > 0:
        ndc = (float(tree.ndc_width), float(tree.ndc_height),
               float(tree.ndc_focal))

    def put(a, dtype):
        # np.require copies only arrays that are read-only (npz loads) or
        # not contiguous; torch.from_numpy needs a writable buffer
        return torch.from_numpy(np.require(a, dtype, ["C", "W"])).to(device)

    return DeviceTree(
        data=put(tree.data, np.float16),
        chs=chs,
        offset=put(tree.offset, np.float32),
        scale=put(tree.scale, np.float32),
        extra=put(extra, np.float32),
        lut=lut,
        N=tree.N,
        data_dim=tree.data_dim,
        basis_dim=tree.data_format.basis_dim,
        fmt=tree.data_format.format.value,
        max_depth=max(tree.max_depth, 1),
        lut_levels=eff_levels,
        skip_cap=eff_skip,
        ndc=ndc,
    )


# ---------------------------------------------------------------------------
# vectorized query (plain twin of the query inside kernel K1)
# ---------------------------------------------------------------------------

def tree_query_full(tree: DeviceTree, pos: torch.Tensor, active=None,
                    touched: Optional[dict] = None):
    """Vectorized root-to-leaf query (traversal.py:tree_query_full).

    pos: [R, 3] tree-space coordinates.  Returns (sub_ptr [R] i32,
    cube [R] f32, local [R, 3] f32, sigma [R] f32, sigma_bits [R] i32);
    ``local`` is the position inside the leaf cube in [0, 1)
    (n3tree_query.hpp:29-33).  ``touched`` (the statistics of
    renderer.render_stats) records what the active rays read, in place:
    bool masks ``"lut"`` [res^3] and ``"chs"`` [M] of the LUT cells and chs
    rows, and ``"descents"`` [R] i32, the chs reads per ray."""
    N = tree.N
    fN = float(N)
    N3 = tree.N3
    R = pos.shape[0]
    dev = pos.device
    pos = torch.clamp(pos, 0.0, 1.0 - 1e-6)
    if active is None:
        active = torch.ones(R, dtype=torch.bool, device=dev)
    # exact N^k (the JAX version takes exp2(k * log2 N), exact for N = 2)
    cube_of = torch.tensor([float(N) ** k for k in range(32)],
                           dtype=torch.float32, device=dev)

    if tree.lut_levels > 0:
        res = N ** tree.lut_levels
        scaled = pos * res
        fl = torch.floor(scaled)
        cell = torch.clamp(fl.to(torch.int64), 0, res - 1)
        flat = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
        flat = torch.where(active, flat, 0)
        if touched is not None:
            touched["lut"][flat[active]] = True
        row = tree.lut[flat]
        e = row[:, 0]
        sigma_bits = row[:, 1]
        # >> is arithmetic on i32: mask after the shift
        depth = (e >> LUT_PTR_BITS) & LUT_DEPTH_SENTINEL
        ptr_e = e & LUT_PTR_MASK
        shallow = depth < LUT_DEPTH_SENTINEL
        done = shallow
        sub_ptr = torch.where(shallow, ptr_e, 0)
        cube = torch.where(shallow, cube_of[depth.to(torch.int64)], 0.0)
        node_ptr = torch.where(shallow, 0, ptr_e)
        xyz = scaled - fl
        cur_cube = torch.full((R,), float(N ** (tree.lut_levels + 1)),
                              dtype=torch.float32, device=dev)
        start_level = tree.lut_levels
    else:
        done = torch.zeros(R, dtype=torch.bool, device=dev)
        sub_ptr = torch.zeros(R, dtype=torch.int32, device=dev)
        cube = torch.zeros(R, dtype=torch.float32, device=dev)
        node_ptr = torch.zeros(R, dtype=torch.int32, device=dev)
        xyz = pos
        cur_cube = torch.full((R,), fN, dtype=torch.float32, device=dev)
        start_level = 0
        sigma_bits = torch.zeros(R, dtype=torch.int32, device=dev)

    for _ in range(tree.max_depth - start_level):
        xyzN = xyz * fN
        digit = torch.floor(xyzN)
        index = ((digit[:, 0] * fN + digit[:, 1]) * fN +
                 digit[:, 2]).to(torch.int32)
        sub = node_ptr * N3 + index
        if touched is not None:
            reading = active & ~done
            touched["chs"][sub[reading].to(torch.int64)] = True
            touched["descents"] += reading.to(torch.int32)
        row = tree.chs[torch.where(done | ~active, 0, sub).to(torch.int64)]
        skip = row[:, 0]
        is_leaf = (skip == 0) & ~done
        sub_ptr = torch.where(is_leaf, sub, sub_ptr)
        cube = torch.where(is_leaf, cur_cube, cube)
        sigma_bits = torch.where(is_leaf, row[:, 1], sigma_bits)
        done = done | is_leaf
        node_ptr = torch.where(done, node_ptr, node_ptr + skip)
        xyz = xyzN - digit
        cur_cube = cur_cube * fN

    local = pos * cube[:, None]
    local = local - torch.floor(local)
    sigma = sigma_bits.view(torch.float32)
    return sub_ptr, cube, local, sigma, sigma_bits
