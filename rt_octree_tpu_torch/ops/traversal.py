"""Octree traversal tensors, the jump-LUT build (kernel K3) and the
vectorized query, in PyTorch.

Counterpart of rt_octree_tpu/ops/traversal.py without its TPU wide-row
machinery (brick tables, pair-packed data, sparse bricks): the port marches
one thread per pixel over the packed jump LUT plus continued ``chs``
descent, as the reference does (n3tree_query.hpp:13-48).

Kernel K3 (csrc/lut.cu) builds the LUT and its empty-space skip distances
on the card; ``lut_build_plain`` and ``add_skip_distances_plain`` are its
plain PyTorch versions, which CPU tensors take.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np
import torch

from rt_octree_tpu.io.n3tree import N3Tree

from ..native import build as native

LUT_PTR_BITS = 27
LUT_DEPTH_SENTINEL = (1 << 5) - 1  # depth field all-ones => internal node
LUT_PTR_MASK = (1 << LUT_PTR_BITS) - 1
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
    # the shallow leaf (0 when still internal), or the skip distance bits
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

def lut_build_plain(chs: torch.Tensor, N: int, levels: int) -> torch.Tensor:
    """Plain version of K3's LUT build (traversal.py:_device_lut_build):
    per cell of the (N^levels)^3 grid, the root-to-level descent into
    (depth<<27 | ptr, sigma bits)."""
    res = N ** levels
    n_cells = res ** 3
    N3 = N ** 3
    out = torch.empty((n_cells, 2), dtype=torch.int32, device=chs.device)
    chs64 = chs.to(torch.int64)
    for c0 in range(0, n_cells, _PLAIN_CHUNK):
        idx = torch.arange(c0, min(c0 + _PLAIN_CHUNK, n_cells),
                           dtype=torch.int64, device=chs.device)
        z = idx % res
        y = (idx // res) % res
        x = idx // (res * res)
        node = torch.zeros_like(idx)
        out_ptr = torch.zeros_like(idx)
        out_depth = torch.full_like(idx, LUT_DEPTH_SENTINEL)
        sig = torch.zeros_like(idx)
        done = torch.zeros(idx.shape, dtype=torch.bool, device=chs.device)
        for lev in range(levels):
            div = N ** (levels - 1 - lev)
            ci = (((x // div) % N) * N + (y // div) % N) * N + (z // div) % N
            sub = node * N3 + ci
            row = chs64[torch.where(done, 0, sub)]
            is_leaf = (row[:, 0] == 0) & ~done
            out_ptr = torch.where(is_leaf, sub, out_ptr)
            out_depth = torch.where(is_leaf, lev + 1, out_depth)
            sig = torch.where(is_leaf, row[:, 1], sig)
            done = done | is_leaf
            node = torch.where(done, node, node + row[:, 0])
        out_ptr = torch.where(done, out_ptr, node)
        packed = (out_depth << LUT_PTR_BITS) | out_ptr
        # wrap to i32 two's complement (depth 31 sets the sign bit)
        packed = torch.where(packed >= (1 << 31), packed - (1 << 32), packed)
        out[c0:c0 + idx.numel(), 0] = packed.to(torch.int32)
        out[c0:c0 + idx.numel(), 1] = sig.to(torch.int32)
    return out


def build_lut(chs: torch.Tensor, N: int, levels: int) -> torch.Tensor:
    """K3 LUT build wrapper: plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor."""
    if chs.device.type == "cpu":
        return lut_build_plain(chs, N, levels)
    _check_cuda_i32(chs, "chs")
    if chs.shape[0] >= (1 << LUT_PTR_BITS):
        raise ValueError("chs rows >= 2^27 cannot be packed into the LUT")
    res = N ** levels
    lut = torch.empty((res ** 3, 2), dtype=torch.int32, device=chs.device)
    fn = native.entry("rt_lut_build")
    with torch.cuda.device(chs.device):
        rc = fn(chs.data_ptr(), lut.data_ptr(), N, levels,
                native.stream_ptr(chs.device))
        native.count_launch("lut_build")
    native.check(rc, "lut_build_kernel")
    return lut


def add_skip_distances_plain(lut: torch.Tensor, res: int,
                             cap: int = 12) -> torch.Tensor:
    """Plain version of K3's skip build (traversal.py:_add_skip_distances):
    ``cap`` rounds of the 3x3x3 min-window + 1 give the capped Chebyshev
    distance to the nearest occupied (sigma bits != 0) cell, stored as the
    integer bits 1..cap in the sigma lane of empty cells."""
    occ = (lut[:, 1] != 0).reshape(1, 1, res, res, res)
    inf = float(cap + 1)
    d = torch.where(occ, 0.0, inf)
    for _ in range(cap):
        # min-window as -maxpool(-d); the pool ignores out-of-grid taps,
        # which is the INF padding of the reference (the centre tap is in
        # every window, so padding never lowers a minimum)
        m = -torch.nn.functional.max_pool3d(-d, 3, stride=1, padding=1)
        d = torch.minimum(d, m + 1.0)
    d = torch.clamp(d, max=float(cap)).reshape(-1).to(torch.int32)
    lane1 = torch.where(occ.reshape(-1), lut[:, 1], d)
    return torch.stack([lut[:, 0], lane1], dim=-1)


def add_skip_distances(lut: torch.Tensor, res: int,
                       cap: int = 12) -> torch.Tensor:
    """K3 skip-distance wrapper: plain version for a CPU tensor, the CUDA
    kernels for a CUDA tensor (which update ``lut`` in place and return
    it)."""
    if lut.device.type == "cpu":
        return add_skip_distances_plain(lut, res, cap)
    _check_cuda_i32(lut, "lut")
    if not 1 <= cap <= 253:
        raise ValueError(f"skip cap {cap} outside 1..253 (uint8 scratch)")
    if lut.shape != (res ** 3, 2):
        raise ValueError(f"lut shape {tuple(lut.shape)} != ({res ** 3}, 2)")
    scratch = torch.empty((2, res ** 3), dtype=torch.uint8,
                          device=lut.device)
    fn = native.entry("rt_skip_distances")
    with torch.cuda.device(lut.device):
        rc = fn(lut.data_ptr(), scratch[0].data_ptr(),
                scratch[1].data_ptr(), res, cap,
                native.stream_ptr(lut.device))
        native.count_launch("skip_min")
    native.check(rc, "skip_min_kernel")
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
                skip_cap: int = 12) -> DeviceTree:
    """Host tree -> tensors on ``device``.  ``lut_levels=0`` disables the
    LUT.  The LUT is built on the device (kernel K3).  When it reaches the
    tree's full depth it witnesses every leaf's occupancy, and
    ``skip_cap > 0`` bakes the Chebyshev empty-space skip distances into
    its sigma lane.  Trees with >= 2^27 sub-pointers, which the packed LUT
    cannot address, fall back EXPLICITLY (stderr) to per-level descent."""
    device = torch.device(device)
    sigma_np = np.ascontiguousarray(tree.data[:, tree.data_dim - 1])
    sigma_bits = sigma_np.astype(np.float32).view(np.int32)
    chs_np = np.stack([tree.child.astype(np.int32), sigma_bits], axis=-1)
    chs = torch.from_numpy(chs_np).to(device)

    eff_levels = 0
    if lut_levels > 0 and tree.max_depth > 0:
        lut_levels = min(lut_levels, tree.max_depth)
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

    if eff_levels > 0:
        lut = build_lut(chs, tree.N, eff_levels)
    else:
        lut = torch.zeros((0, 2), dtype=torch.int32, device=device)
    eff_skip = 0
    if skip_cap > 0 and eff_levels > 0 and eff_levels == tree.max_depth:
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

def tree_query_full(tree: DeviceTree, pos: torch.Tensor, active=None):
    """Vectorized root-to-leaf query (traversal.py:tree_query_full).

    pos: [R, 3] tree-space coordinates.  Returns (sub_ptr [R] i32,
    cube [R] f32, local [R, 3] f32, sigma [R] f32, sigma_bits [R] i32);
    ``local`` is the position inside the leaf cube in [0, 1)
    (n3tree_query.hpp:29-33)."""
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
