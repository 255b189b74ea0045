"""The probe ports (rt_octree_tpu_torch.ops.probes and the two tools in
rt_octree_tpu_torch.tools) against the TPU tools' own Pallas kernels.

tools/tpu_probe.py and tools/microbench_gather.py run here unchanged: their
``pallas_call`` goes through Pallas's TPU interpreter on the CPU, and their
``timeit`` is replaced by a capture of one call's inputs and output (for
P1, which calls no ``timeit``, ``jax.jit`` records the call).  The port's
wrappers take their plain versions on CPU tensors; every integer result
must equal the Pallas kernel's exactly.  P4's Pallas body copies a
``(width,)`` row into a ``(1, width)`` scratch slot, which the interpreter
refuses, so P4 is held against a float64 numpy sum instead.
"""

import functools
import importlib.util
import itertools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rt_octree_tpu_torch.ops import probes as P
from rt_octree_tpu_torch.tools import gpu_probe, microbench_gather

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# settings that importing tools/microbench_gather.py changes (:28-31)
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


class _Stop(BaseException):
    """Ends a tool's loop after the first config; the tools catch only
    Exception, so this passes through."""


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tpu_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))


@pytest.fixture
def tpu_probe(interpret):
    return _load_tool("tpu_probe")


@pytest.fixture
def tpu_microbench(interpret, monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        yield _load_tool("microbench_gather")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def _capture(module, monkeypatch, stop_after=None):
    """Replace ``module.timeit`` by one call whose numpy inputs and output
    are appended to the returned list; raise _Stop after ``stop_after``
    captures."""
    calls = []

    def timeit(fn, *args, **_):
        out = np.asarray(fn(*args))
        calls.append(([np.asarray(a) for a in args], out))
        if stop_after is not None and len(calls) >= stop_after:
            raise _Stop
        return 1.0
    monkeypatch.setattr(module, "timeit", timeit)
    return calls


def _t(a):
    return torch.from_numpy(np.array(a))


def test_p1_affine_equals_pallas(tpu_probe, monkeypatch):
    calls, real_jit = [], jax.jit

    def recording_jit(fun, **kw):
        jitted = real_jit(fun, **kw)
        if getattr(fun, "__module__", None) != tpu_probe.__name__:
            return jitted

        def call(*args):
            out = jitted(*args)
            calls.append(([np.asarray(a) for a in args], np.asarray(out)))
            return out
        return call
    monkeypatch.setattr(jax, "jit", recording_jit)
    tpu_probe.probe_basic()
    (x,), out = calls[0]
    assert x.shape == (8, 128)
    assert torch.equal(P.probe_affine(_t(x)), _t(out))
    assert torch.equal(gpu_probe.basic_input("cpu"), _t(x))


def _affine_library_inputs(case):
    if case == "tool arange":
        return gpu_probe.basic_input("cpu")
    if case == "normals":
        return _t(np.random.default_rng(1).standard_normal(
            (3, 1000)).astype(np.float32))
    f32 = np.finfo(np.float32)
    return _t(np.array([0.0, -0.0, 1e-45, -1e-45, 1.2e-40, f32.tiny, 1.0,
                        -0.5, -1.0, 1e38, -1e38, f32.max, -f32.max, np.inf,
                        -np.inf], np.float32))


@pytest.mark.parametrize("case", ["tool arange", "normals", "specials"])
def test_g1_library_call_equals_plain(case):
    """P1's library call, ``torch.add(1, x, alpha=2)`` (chip_smoke.py's
    ``affine_library``, timed beside G1), computes the plain version's
    ``x * 2 + 1`` bit for bit: on the tool's 8x128 arange, on seeded
    normals, and on +-0, subnormals, +-1e38, the largest floats (2x
    overflows to inf on both sides) and +-inf.  Doubling is exact, so a
    fused multiply-add rounds as the two ops do."""
    x = _affine_library_inputs(case)
    got = torch.add(torch.ones(()), x, alpha=2.0)
    ref = P.probe_affine_plain(x)
    assert got.dtype == ref.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(P.probe_affine(x).view(torch.int32),
                       ref.view(torch.int32))


def test_p2_lane_gather_equals_pallas(tpu_probe, monkeypatch):
    calls = _capture(tpu_probe, monkeypatch)
    tpu_probe.probe_vgather()
    (tab, idx), out = calls[0]
    assert tab.shape == (gpu_probe.VG_T, 128)
    assert idx.shape == out.shape == (gpu_probe.VG_R, 128)
    assert torch.equal(P.lane_gather(_t(tab), _t(idx)), _t(out))


def test_p3_lane_gather_chain_equals_pallas(tpu_probe, monkeypatch):
    calls = _capture(tpu_probe, monkeypatch)
    tpu_probe.probe_vgather_loop()
    (tab, idx), out = calls[0]
    assert tab.shape == (gpu_probe.VL_T, 128)
    assert idx.shape == out.shape == (gpu_probe.VL_R, 128)
    got = P.lane_gather_chain(_t(tab), _t(idx), gpu_probe.VL_K)
    assert got.dtype == torch.int32
    assert torch.equal(got, _t(out))


def test_p4_row_sum_within_tolerance_of_float64():
    """f32 sums of 1000 rows of [0, 1) values, in any order, lie within
    gpu_probe.DMA_RTOL (1e-5) of the float64 sum, relative to its largest
    column (the tool holds the kernel to the same bound)."""
    rs = np.random.default_rng(4)
    tab = rs.random((3000, 128), dtype=np.float32)
    idx = rs.integers(0, 3000, (1000,), dtype=np.int32)
    got = P.row_sum_ring(_t(idx), _t(tab))
    assert got.shape == (1, 128) and got.dtype == torch.float32
    ref = tab[idx].astype(np.float64).sum(0)
    rel = np.abs(got.numpy()[0] - ref).max() / np.abs(ref).max()
    assert rel <= gpu_probe.DMA_RTOL
    assert gpu_probe.dma_rel_err(got, _t(idx), _t(tab)) == pytest.approx(rel)


def _chunk_order_row_sum(idx, table):
    """G3's f32 row sum in its chunk order (a NumPy statement): each chunk
    of RING_CHUNK indices summed in the order of i from 0, then the chunks'
    sums in chunk order from 0."""
    total = np.zeros(table.shape[1], np.float32)
    for start in range(0, len(idx), P.RING_CHUNK):
        part = np.zeros(table.shape[1], np.float32)
        for i in idx[start:start + P.RING_CHUNK]:
            part = part + table[i]
        total = total + part
    return total


@pytest.mark.parametrize("n", [1, 31, 32, 33, gpu_probe.DMA_N, 8192, 12345])
def test_g3_chunk_plan(n):
    """G3's chunk plan, as NumPy states it: row i in chunk i // RING_CHUNK,
    the chunks in order, each i exactly once."""
    plan = P.ring_chunks(n)
    assert all(b > a for a, b in plan)
    rows = np.concatenate([np.arange(a, b) for a, b in plan])
    assert np.array_equal(rows, np.arange(n))
    chunk_of = np.repeat(np.arange(len(plan)), [b - a for a, b in plan])
    assert np.array_equal(chunk_of, np.arange(n) // P.RING_CHUNK)


def test_g3_chunk_plan_is_the_kernels():
    """The plan's chunk is the kernel's compile-time kRingChunk, and G3's
    source reads no property of the card (its SM count), so the f32 sum
    order is the same on any card; the tools' P4 and P5 fill 128 and 256
    CTAs; a CTA's ring of 32 slots of 512 B is 16 KB."""
    with open(os.path.join(REPO, "rt_octree_tpu_torch", "csrc",
                           "probes.cu")) as f:
        src = f.read()
    assert f"constexpr int kRingChunk = {P.RING_CHUNK};" in src
    for call in ("MultiProcessorCount", "cudaGetDeviceProperties",
                 "cudaDeviceGetAttribute", "cudaOccupancy"):
        assert call not in src
    assert len(P.ring_chunks(gpu_probe.DMA_N)) == 128
    assert len(P.ring_chunks(8192)) == 256
    assert P.ring_smem_bytes(512, 32) == 16 * 32 + 4 * 32 + 16384


def test_p4_chunk_order_within_tolerance_of_float64():
    """G3's chunk-order f32 sum at the tool's 4096 rows of 128 columns lies
    within gpu_probe.DMA_RTOL of the float64 sum and of the plain
    version, relative to the largest column."""
    rs = np.random.default_rng(0)
    tab = rs.random((1 << 13, gpu_probe.DMA_W), dtype=np.float32)
    idx = rs.integers(0, 1 << 13, (gpu_probe.DMA_N,), dtype=np.int32)
    got = _chunk_order_row_sum(idx, tab)
    assert gpu_probe.dma_rel_err(_t(got[None]), _t(idx), _t(tab)) <= \
        gpu_probe.DMA_RTOL
    plain = P.row_sum_ring_plain(_t(idx), _t(tab)).numpy()[0]
    assert np.abs(got - plain).max() / np.abs(plain).max() <= \
        gpu_probe.DMA_RTOL


def test_p5_row_ring_rounds_equals_pallas(tpu_microbench, monkeypatch):
    """The tool's first config (rows of 8 B, n 1024, nbuf 8, 4 rounds), on
    the inputs the port's section b draws first."""
    calls = _capture(tpu_microbench, monkeypatch, stop_after=1)
    with pytest.raises(_Stop):
        tpu_microbench.bench_pallas_dma()
    (idx, table), out = calls[0]
    width, n, nbuf, p_table, p_idx = next(microbench_gather.dma_configs("cpu"))
    assert (width, n, nbuf) == (2, 1024, 8)
    assert torch.equal(p_table, _t(table)) and torch.equal(p_idx, _t(idx))
    got = P.row_ring_rounds(p_idx, p_table, nbuf,
                            microbench_gather.RING_ROUNDS)
    assert got.shape == (1, 1) and got.dtype == torch.int32
    assert torch.equal(got, _t(out))


def test_p6_flat_gather_chain_equals_pallas(tpu_microbench, monkeypatch):
    """All four configs of the tool, on the inputs the port's section c
    draws for them."""
    calls = _capture(tpu_microbench, monkeypatch)
    tpu_microbench.bench_pallas_vmem_gather()
    ported = itertools.islice(microbench_gather.vmem_configs("cpu"),
                              len(calls))
    assert len(calls) == len(microbench_gather.VMEM_CONFIGS)
    for ((idx, table), out), (S, n, p_table, p_idx) in zip(calls, ported):
        assert table.shape == (S,) and idx.shape == out.shape == (n,)
        assert torch.equal(p_table, _t(table)) and torch.equal(p_idx,
                                                               _t(idx))
        got = P.flat_gather_chain(p_idx, p_table,
                                  microbench_gather.CHAIN_ROUNDS)
        assert torch.equal(got, _t(out))


# G4: the path and the CTAs of each plan --------------------------------------

@pytest.mark.parametrize("log2", range(10, 19))
def test_g4_plan_covers_every_chain(log2):
    """A NumPy statement of G4's plan for a table of 2^log2 entries: the
    local path exactly where the table and the barrier fit a CTA's shared
    memory, whole warps, the local path's CTAs at most FLAT_LOCAL_CTAS
    until they reach MAX_THREADS, and every chain in exactly one thread."""
    size = 1 << log2
    for n in (1, 500, 8193, 131072, 131073):
        plan = P.flat_plan(size, n)
        local = 4 * size + 16 <= P.MAX_SMEM_BYTES
        assert plan.path == ("local" if local else "global")
        assert plan.threads % 32 == 0
        assert P.FLAT_THREADS <= plan.threads <= P.MAX_THREADS
        grid = _flat_grid(plan, n)
        if local:
            assert (grid <= P.FLAT_LOCAL_CTAS
                    or plan.threads == P.MAX_THREADS)
        else:
            assert plan.threads == P.FLAT_THREADS
        i = (np.arange(grid)[:, None] * plan.threads
             + np.arange(plan.threads)).ravel()
        assert np.array_equal(i[i < n], np.arange(n))
        assert (i >= n).sum() < plan.threads


def _flat_grid(plan, n):
    """G4's CTAs (csrc/probes.cu launch_flat): enough for n chains."""
    return -(-n // plan.threads)


def test_g4_plan_of_the_tool_configs():
    """Every config of the tool's section c: the path, its shared memory
    within a CTA's 227 KB, every chain in exactly one thread."""
    paths = {}
    for S, n in (microbench_gather.VMEM_CONFIGS
                 + microbench_gather.PAST_L2_CONFIGS):
        plan = P.flat_plan(S, n)
        paths[S, n] = plan.path
        assert plan.path in P.FLAT_PATHS
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= P.MAX_THREADS
        if plan.path == "local":
            assert 4 * S + 16 <= P.MAX_SMEM_BYTES
        grid = _flat_grid(plan, n)
        # chain (CTA b, thread t): the kernel's index
        i = (np.arange(grid)[:, None] * plan.threads
             + np.arange(plan.threads)).ravel()
        assert np.array_equal(i[i < n], np.arange(n))
    assert paths == FLAT_TOOL_PATHS
    assert P.flat_plan(1 << 14, 8192) == P.FlatPlan("local", 256)
    assert P.flat_plan(1 << 14, 131072) == P.FlatPlan("local", 1024)
    assert P.flat_plan(1 << 15, 500) == P.FlatPlan("local", 256)
    assert P.flat_plan(1 << 16, 8192) == P.FlatPlan("global", 256)
    assert P.flat_plan(1 << 18, 131072) == P.FlatPlan("global", 256)


# the path each config of section c takes (a sweep of plans, PERF.md)
FLAT_TOOL_PATHS = {(1 << 14, 8192): "local", (1 << 18, 8192): "global",
                   (1 << 20, 8192): "global", (1 << 18, 131072): "global",
                   (1 << 28, 8192): "global", (1 << 28, 131072): "global"}


# G2's single gather: pieces of columns a thread over the card's SMs ---------

def _gather_cover(plan, width, rows_out, cols):
    """A NumPy statement of csrc/probes.cu lane_gather_kernel<cols> on
    ``plan``'s CTAs: each thread's first (row, piece) by one division, then
    the grid's stride split into rows and pieces, one carry a step; -> how
    many times each output element is written."""
    pieces = width // cols
    stride = plan.ctas * plan.threads
    assert stride <= 2 ** 31 - 1  # the kernel's unsigned indices never wrap
    drow, dpiece = divmod(stride, pieces)
    first = np.arange(stride, dtype=np.int64)
    row, piece = first // pieces, first - first // pieces * pieces
    count = np.zeros((rows_out, width), np.int64)
    while (live := row < rows_out).any():
        for j in range(cols):
            np.add.at(count, (row[live], piece[live] * cols + j), 1)
        row, piece = row + drow, piece + dpiece
        carry = piece >= pieces
        piece[carry] -= pieces
        row[carry] += 1
    return count


@pytest.mark.parametrize("rows_out", [1, 41, 1024, 2049])
@pytest.mark.parametrize("width", [1, 3, 4, 6, 12, 128, 129])
def test_g2_gather_plan_covers_every_element(width, rows_out):
    """G2's single-gather plan: GATHER_COLS columns a thread exactly where
    the width is a multiple, CTAs of at least a warp and at most
    GATHER_MAX_THREADS, and every output element written exactly once, by
    the plan's own pieces and by a column a thread on the same CTAs (a view
    of idx or out off 16 bytes)."""
    plan = P.gather_plan(width, rows_out)
    assert plan.cols == (P.GATHER_COLS if width % P.GATHER_COLS == 0 else 1)
    assert 32 <= plan.threads <= P.GATHER_MAX_THREADS <= P.MAX_THREADS
    pieces = rows_out * width // plan.cols
    assert 1 <= plan.ctas <= max(P.CARD_SMS,
                                 -(-pieces // P.GATHER_MAX_THREADS))
    for cols in {plan.cols, 1}:
        assert (_gather_cover(plan, width, rows_out, cols) == 1).all(), cols


def test_g2_gather_plan_of_the_tool():
    """The tool's 1024 x 128 lookups: 32,768 pieces of 4 columns, spread
    over all 132 SMs (1024-thread CTAs of an element a thread would fill
    128 with half their warps)."""
    plan = P.gather_plan(128, gpu_probe.VG_R)
    assert plan == P.GatherPlan(4, 249, P.CARD_SMS)
    assert plan.ctas >= 128
    assert plan.ctas * plan.threads >= gpu_probe.VG_R * 128 // 4
    assert P.gather_plan(128, 8 * gpu_probe.VG_R) == P.GatherPlan(4, 256,
                                                                  1024)


# G2's chain: column blocks, parts of rows, clusters -------------------------

def _chain_tiles(plan, rows_out, width):
    """csrc/probes.cu lane_chain_kernel's tiles: each CTA's (column block,
    part, rows [r0, r1), columns [c0, c1)) in launch order, the parts of a
    block rounded up to whole clusters, a CTA past the rows taking none."""
    parts = -(-rows_out // plan.share)
    parts = -(-parts // plan.cluster) * plan.cluster
    tiles = []
    for x in range(width // plan.cols * parts):
        block, part = divmod(x, parts)
        r0 = min(part * plan.share, rows_out)
        tiles.append((block, part, (r0, min(r0 + plan.share, rows_out)),
                      (block * plan.cols, (block + 1) * plan.cols)))
    return tiles


@pytest.mark.parametrize("rows_out", [1, 3, 41, 2047, 2048, 2049, 5000])
@pytest.mark.parametrize("width", [4, 6, 12, 128])
def test_g2_chain_tiles(width, rows_out):
    """A NumPy statement of G2 chain's tiles: the CTAs' (column block, part)
    tiles cover every (i, l) of rows_out x width exactly once, a cluster's
    CTAs share their column block, and no CTA runs more than its share."""
    plan = P.chain_plan(8192, width, rows_out)
    tiles = _chain_tiles(plan, rows_out, width)
    count = np.zeros((rows_out, width), np.int64)
    for block, part, (r0, r1), (c0, c1) in tiles:
        assert 0 <= r1 - r0 <= plan.share and c1 - c0 == plan.cols
        count[r0:r1, c0:c1] += 1
    assert (count == 1).all()
    assert len(tiles) % plan.cluster == 0
    for k in range(0, len(tiles), plan.cluster):
        assert len({t[0] for t in tiles[k:k + plan.cluster]}) == 1
    assert plan.threads * P.CHAIN_PER_THREAD >= min(
        plan.share * plan.cols, P.MAX_THREADS * P.CHAIN_PER_THREAD)


def test_g2_chain_plan():
    """P3's shape: 4 CTAs a 4-column block in clusters of 2, 128 CTAs, 2048
    chains a CTA on 1024 threads.  The columns a block at the edges: the
    last table that takes 4 and one past it (2), the last that takes 2 and
    one past it (1); a width of 6 (2) and of 12 (4)."""
    plan = P.chain_plan(gpu_probe.VL_T, 128, gpu_probe.VL_R)
    assert plan == P.ChainPlan(4, 512, 1024, 2)
    assert len(_chain_tiles(plan, gpu_probe.VL_R, 128)) == 128
    for T, W, cols in ((14528, 4, 4), (14529, 4, 2), (29056, 4, 2),
                       (29057, 4, 1), (58112, 12, 1), (64, 6, 2),
                       (64, 12, 4)):
        assert P.chain_plan(T, W, 41).cols == cols
        assert cols * T * 4 <= P.MAX_SMEM_BYTES
    with pytest.raises(ValueError):
        P.chain_plan(58113, 4, 41)


def _reciprocal(d):
    """csrc/probes.cu chain_reciprocal: Granlund and Montgomery's magic
    number and shifts for unsigned 32-bit division by d, and 2^31 mod d."""
    l = (d - 1).bit_length()  # ceil(log2 d)
    magic = ((1 << 32) * ((1 << l) - d)) // d + 1
    assert 0 < magic < 1 << 32
    return magic, min(l, 1), max(l - 1, 0), (1 << 31) % d


def _chain_mod(s, d):
    """csrc/probes.cu chain_mod<false> on the int32 sums s, in uint64."""
    magic, sh1, sh2, c31 = _reciprocal(d)
    u = (s.astype(np.int64) + 2 ** 31).astype(np.uint64)
    t = (u * np.uint64(magic)) >> np.uint64(32)
    q = (t + ((u - t) >> np.uint64(sh1))) >> np.uint64(sh2)
    r = (u - q * np.uint64(d)).astype(np.int64) - c31
    return np.where(r < 0, r + d, r)


@pytest.mark.parametrize("d", [1, 3, 7, 61, 1000, 8191, 14337, 29057, 58111,
                               2 ** 31 - 1])
def test_g2_chain_reciprocal_is_floor_mod(d):
    """The kernel's remainder by a reciprocal equals jnp.remainder's floor
    mod on int32 sums across their whole range: the extremes, the
    multiples of d and their neighbours, and random sums."""
    rs = np.random.default_rng(d)
    i32 = np.iinfo(np.int32)
    k = np.arange(-4, 5, dtype=np.int64)
    s = np.concatenate([
        [i32.min, i32.min + 1, -1, 0, 1, i32.max - 1, i32.max],
        np.clip((np.arange(-300, 300)[:, None] * d + k).ravel(),
                i32.min, i32.max),
        rs.integers(i32.min, i32.max, 200_000, endpoint=True)])
    assert np.array_equal(_chain_mod(s, d), np.mod(s, d))


def test_probe_plans_are_the_kernels():
    """The plans' constants are csrc/probes.cu's, and the NumPy statements
    of the single gather's stepping and of the reciprocal are the
    kernel's."""
    with open(os.path.join(REPO, "rt_octree_tpu_torch", "csrc",
                           "probes.cu")) as f:
        src = f.read()
    for line in (f"constexpr int kMaxSmemBytes = {P.MAX_SMEM_BYTES};",
                 f"constexpr int kLaneThreads = {P.MAX_THREADS};",
                 f"constexpr int kCardSms = {P.CARD_SMS};",
                 f"constexpr int kGatherCols = {P.GATHER_COLS};",
                 "unsigned row = first / (unsigned)a.pieces;",
                 "const long long stride = (long long)ctas * threads;",
                 "a.drow = (int)(stride / a.pieces);",
                 "(long long)ctas * threads > 0x7fffffffLL)",
                 f"constexpr int kChainMaxCluster = {P.CHAIN_MAX_CLUSTER};",
                 f"constexpr int kChainPerThread = {P.CHAIN_PER_THREAD};",
                 "const long long smem = (long long)rows_tab * cols * 4;",
                 "const long long smem = local ? 16 + 4LL * size : 0;",
                 "a.magic = (uint32_t)(((1ull << 32) * ((1ull << l) - d)) / "
                 "d + 1);",
                 "const uint32_t q = (t + ((u - t) >> a.sh1)) >> a.sh2;",
                 "a.c31 = (uint32_t)((1ull << 31) % d);"):
        assert line in src, line


def test_row_ring_rounds_wraps_like_int32():
    rs = np.random.default_rng(5)
    table = rs.integers(2 ** 30, 2 ** 31, (64, 3)).astype(np.int32)
    idx = rs.integers(0, 64, (300,), dtype=np.int32)
    ref = np.full(1, table[idx, 0].sum(dtype=np.int32)) * np.int32(3)
    got = P.row_ring_rounds(_t(idx), _t(table), 8, 3)
    assert int(got) == int(ref[0])


def test_tool_arguments():
    assert gpu_probe.parse_args([]).probes == list(gpu_probe.PROBES)
    assert gpu_probe.parse_args(["dma", "basic"]).probes == ["dma", "basic"]
    assert microbench_gather.parse_args([]).which == "all"
    assert microbench_gather.parse_args(["c"]).which == "c"
    for parse, argv in ((gpu_probe.parse_args, ["basic", "nope"]),
                        (microbench_gather.parse_args, ["e"])):
        with pytest.raises(SystemExit) as e:
            parse(argv)
        assert e.value.code == 2


@pytest.mark.parametrize("module,argv", [("gpu_probe", ["basic"]),
                                         ("microbench_gather", ["b"])])
def test_tools_refuse_to_run_without_cuda(module, argv):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    tool = {"gpu_probe": gpu_probe,
            "microbench_gather": microbench_gather}[module]
    with pytest.raises(SystemExit) as e:
        tool.main(argv)
    assert e.value.code not in (0, None)
    out = subprocess.run(
        [sys.executable, "-m", f"rt_octree_tpu_torch.tools.{module}"] + argv,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "[basic]" not in out.stdout and "==" not in out.stdout
