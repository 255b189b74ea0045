"""The probe kernels G1-G4 (csrc/probes.cu) and their plain versions.

One wrapper per Pallas function of the TPU measurement tools:

    probe_affine       P1  tools/tpu_probe.py:46           probe_basic.f
    lane_gather        P2  tools/tpu_probe.py:69           probe_vgather.f
    lane_gather_chain  P3  tools/tpu_probe.py:104          probe_vgather_loop.f
    row_sum_ring       P4  tools/tpu_probe.py:158          probe_dma.f
    row_ring_rounds    P5  tools/microbench_gather.py:132  bench_pallas_dma.make
    flat_gather_chain  P6  tools/microbench_gather.py:183  bench_pallas_vmem_gather

Each wrapper takes its plain version (``*_plain``) for CPU tensors and
launches its kernel for CUDA tensors, after checking dtype, shape and
contiguity; it never falls back.  Integer results wrap as JAX's int32 does.
The gathers launch the plans that ``gather_plan``, ``chain_plan`` and
``flat_plan`` make from the shapes alone.

What bounds each on the H100: P1 moves 8 KB, so a launch's own cost on the
device (an empty kernel's time) is its floor.  P2 reads each of its
131,072 values from a random table row: a 32-byte L2 sector a value, so the
L2's sector rate and that floor bound it, and staging the table in shared
memory would cost more than the call (each element is read ~0.25 times).
P3 and P6 chain dependent gathers, bound by a round's latency where the
table lies; P4 and P5 fetch rows by dynamic index, bound by the copies a
CTA keeps in flight.

P4's Pallas body copies a ``(width,)`` row into a ``(1, width)`` scratch
slot, which Pallas's TPU interpreter refuses; the port computes its
evident intent, ``out[0, :] = sum_i tab[idx[i], :]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..native import build as native

# Shared memory one block may opt into on sm_90 (csrc/probes.cu).
MAX_SMEM_BYTES = 232448
RING_DEPTHS = (2, 4, 8, 16, 32)  # row_ring_rounds' nbuf (kernel templates)
RING_CHUNK = 32  # G3: rows a CTA takes (csrc/probes.cu kRingChunk)
ROW_SUM_MAX_WIDTH = 128  # row_sum_ring: 4 columns a lane of one warp
MAX_THREADS = 1024  # G2, G4: threads a CTA (csrc/probes.cu kLaneThreads)
CARD_SMS = 132  # the H100's SMs: G1's and G2's CTAs spread over all of them
GATHER_COLS = 4  # G2: adjacent columns a thread (16-byte idx and out pieces)
GATHER_MAX_THREADS = 256  # G2: threads a CTA at most, then more CTAs
CHAIN_PARTS = 4  # G2 chain: CTAs a column block (parts of its rows)
CHAIN_CLUSTER = 2  # G2 chain: CTAs that stage one column block together
CHAIN_MAX_CLUSTER = 8  # G2 chain: the most CTAs the kernel takes a cluster
CHAIN_MAX_SHARE = 512  # G2 chain: the most output rows a CTA takes
CHAIN_PER_THREAD = 2  # G2 chain: chains a thread runs interleaved
FLAT_PATHS = ("global", "local")  # G4: the table where it lies, or staged
FLAT_THREADS = 256  # G4: threads a CTA, and the fewest on the local path
FLAT_LOCAL_CTAS = 32  # G4 local path: CTAs before they grow past 256
_I32_MAX = 2 ** 31 - 1


def _check(fn: str, name: str, t: torch.Tensor, dtype, ndim: int,
           device: torch.device) -> None:
    if (t.device != device or t.dtype != dtype or t.dim() != ndim
            or not t.is_contiguous() or t.numel() > _I32_MAX):
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} CUDA tensor with "
            f"{ndim} dims on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _cuda_device(fn: str, t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: tensors must lie on the CPU (plain "
                         f"version) or on a CUDA card, not {t.device}")
    return t.device


def _launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    fn = native.entry(entry)
    with torch.cuda.device(device):
        rc = fn(*args, native.stream_ptr(device))
        native.count_launch(kernel)
    native.check(rc, entry)


def _wrap_i32(total: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced to int32 with two's-complement wrap."""
    return (((total + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


# P1 ------------------------------------------------------------------------

def probe_affine_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0 + 1.0


def probe_affine(x: torch.Tensor) -> torch.Tensor:
    """``2x + 1`` of an f32 tensor (G1)."""
    if x.device.type == "cpu":
        return probe_affine_plain(x)
    dev = _cuda_device("probe_affine", x)
    _check("probe_affine", "x", x, torch.float32, x.dim(), dev)
    if x.numel() == 0:
        raise ValueError("probe_affine: x is empty")
    out = torch.empty_like(x)
    _launch("probe_affine", "rt_probe_affine", dev, x.data_ptr(),
            out.data_ptr(), x.numel())
    return out


# P2, P3 ---------------------------------------------------------------------

def lane_gather_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(tab, 0, idx.long())


def lane_gather_chain_plain(tab: torch.Tensor, idx: torch.Tensor,
                            rounds: int) -> torch.Tensor:
    rows = tab.shape[0]
    cur = idx
    for _ in range(rounds):
        cur = torch.remainder(cur + torch.gather(tab, 0, cur.long()) + 1,
                              rows)
    return cur


def _check_lane(fn: str, tab: torch.Tensor, idx: torch.Tensor, dtype):
    dev = _cuda_device(fn, idx)
    _check(fn, "tab", tab, dtype, 2, dev)
    _check(fn, "idx", idx, torch.int32, 2, dev)
    if idx.shape[1] != tab.shape[1] or 0 in idx.shape or tab.shape[0] == 0:
        raise ValueError(f"{fn}: idx {tuple(idx.shape)} must have the "
                         f"width of tab {tuple(tab.shape)}, both non-empty")
    return dev


class GatherPlan(NamedTuple):
    """G2's single gather: ``cols`` adjacent columns a thread (a piece),
    ``threads`` a CTA, ``ctas`` CTAs, in a grid-stride loop over the
    pieces."""
    cols: int
    threads: int
    ctas: int


def gather_plan(width: int, rows_out: int) -> GatherPlan:
    """The plan for [rows_out, width] lookups, from the shapes alone:
    GATHER_COLS columns a thread where the width is a multiple (else 1), a
    piece a thread spread evenly over CARD_SMS CTAs of at least a warp, up
    to GATHER_MAX_THREADS a CTA, then more CTAs (the tool's 32,768 pieces:
    132 CTAs of 249 threads; 8x its rows: 1024 CTAs of 256, which beat 256
    CTAs of 1024 and 264 of 993 on the H100, PERF.md).  The kernel takes a
    column a thread, on the same CTAs, where idx or out is not 16-byte
    aligned."""
    cols = GATHER_COLS if width % GATHER_COLS == 0 else 1
    pieces = rows_out * (width // cols)
    threads = min(GATHER_MAX_THREADS, max(32, -(-pieces // CARD_SMS)))
    return GatherPlan(cols, threads,
                      min(-(-pieces // threads), _I32_MAX // threads))


def lane_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane gather ``out[i, l] = tab[idx[i, l], l]`` (G2): tab f32
    [T, W], idx i32 [R, W] -> f32 [R, W], launched by ``gather_plan``."""
    if idx.device.type == "cpu":
        return lane_gather_plain(tab, idx)
    dev = _check_lane("lane_gather", tab, idx, torch.float32)
    plan = gather_plan(tab.shape[1], idx.shape[0])
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    _launch("lane_gather", "rt_lane_gather", dev, tab.data_ptr(),
            idx.data_ptr(), out.data_ptr(), tab.shape[0], tab.shape[1],
            idx.shape[0], plan.cols, plan.threads, plan.ctas)
    return out


class ChainPlan(NamedTuple):
    """G2 chain's launch: column blocks of ``cols``, ``share`` output rows
    a CTA, ``threads`` a CTA with CHAIN_PER_THREAD chains each, in
    clusters of ``cluster`` CTAs that read their block once and store it
    into every CTA's shared memory."""
    cols: int
    share: int
    threads: int
    cluster: int


def chain_plan(rows_tab: int, width: int, rows_out: int) -> ChainPlan:
    """The plan for a [rows_tab, width] table and [rows_out, width]
    chains, from the shapes alone.  4 columns a block where the width and
    shared memory allow, else 2, else 1; CHAIN_PARTS CTAs a block in
    clusters of CHAIN_CLUSTER (as a sweep of plans on the H100 chose,
    PERF.md)."""
    cols = next((c for c in (4, 2, 1) if width % c == 0
                 and c * rows_tab * 4 <= MAX_SMEM_BYTES), None)
    if cols is None:
        raise ValueError(f"lane_gather_chain: a column of {rows_tab} rows "
                         f"exceeds {MAX_SMEM_BYTES} B of shared memory")
    share = min(-(-rows_out // CHAIN_PARTS), CHAIN_MAX_SHARE)
    threads = -(-share * cols // CHAIN_PER_THREAD)
    threads = min(MAX_THREADS, max(128, -(-threads // 32) * 32))
    return ChainPlan(cols, share, threads, CHAIN_CLUSTER)


def lane_gather_chain(tab: torch.Tensor, idx: torch.Tensor,
                      rounds: int) -> torch.Tensor:
    """``rounds`` chained per-lane gathers ``cur = (cur + tab[cur, l] + 1)
    mod T`` (G2): tab i32 [T, W], idx i32 [R, W] -> i32 [R, W].  One column
    of tab must fit in shared memory (T <= 58112).  On the card each block
    of ``chain_plan``'s columns is staged in the shared memory of each CTA
    that runs chains on it, and every round is a shared-memory load."""
    if idx.device.type == "cpu":
        return lane_gather_chain_plain(tab, idx, rounds)
    dev = _check_lane("lane_gather_chain", tab, idx, torch.int32)
    if tab.shape[0] * 4 > MAX_SMEM_BYTES or rounds < 0:
        raise ValueError(f"lane_gather_chain: a column of {tab.shape[0]} "
                         f"rows exceeds {MAX_SMEM_BYTES} B of shared memory, "
                         f"or rounds {rounds} < 0")
    plan = chain_plan(tab.shape[0], tab.shape[1], idx.shape[0])
    out = torch.empty_like(idx)
    _launch("lane_gather_chain", "rt_lane_gather_chain", dev, tab.data_ptr(),
            idx.data_ptr(), out.data_ptr(), tab.shape[0], tab.shape[1],
            idx.shape[0], rounds, plan.cols, plan.share, plan.threads,
            plan.cluster)
    return out


# P4, P5 ---------------------------------------------------------------------

def row_sum_ring_plain(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    return tab.index_select(0, idx.long()).sum(0, keepdim=True)


def row_ring_rounds_plain(idx: torch.Tensor, table: torch.Tensor, nbuf: int,
                          rounds: int) -> torch.Tensor:
    """``rounds`` passes summing element 0 of each row: rounds * sum, as
    wrapping int32.  ``nbuf`` sets only how many copies the kernel keeps in
    flight; the sum does not depend on it."""
    total = table.index_select(0, idx.long())[:, 0].to(torch.int64).sum()
    return _wrap_i32(total * rounds).reshape(1, 1)


def ring_chunks(n: int) -> list:
    """G3's chunk plan: the rows ``[start, stop)`` of idx that each CTA
    takes, in chunk order.  It depends on ``n`` alone, not on the card, so
    ``row_sum_ring``'s f32 sum order is the same everywhere."""
    return [(c, min(c + RING_CHUNK, n)) for c in range(0, n, RING_CHUNK)]


def ring_smem_bytes(row_bytes: int, nbuf: int) -> int:
    """One G3 CTA's shared memory: a full and an empty mbarrier a slot, the
    chunk's indices, and ``nbuf`` slots of the row rounded up to 16 B."""
    return 16 * nbuf + 4 * RING_CHUNK + nbuf * -(-row_bytes // 16) * 16


# G3's [CTAs finished, running sum] pair, one per (device, stream), zeroed
# once here and set back to zero by each launch's last CTA: a call is one
# kernel, with no memset before it
_RING_COUNTERS: dict = {}


def _ring_counter(dev: torch.device) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _RING_COUNTERS:
        _RING_COUNTERS[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _RING_COUNTERS[key]


def _check_ring(fn: str, idx: torch.Tensor, tab: torch.Tensor, dtype,
                slots: int):
    dev = _cuda_device(fn, idx)
    _check(fn, "idx", idx, torch.int32, 1, dev)
    _check(fn, "table", tab, dtype, 2, dev)
    if idx.shape[0] == 0 or 0 in tab.shape:
        raise ValueError(f"{fn}: idx and table must be non-empty")
    if ring_smem_bytes(tab.shape[1] * 4, slots) > MAX_SMEM_BYTES:
        raise ValueError(f"{fn}: {slots} row slots of {tab.shape[1] * 4} B "
                         f"exceed {MAX_SMEM_BYTES} B of shared memory")
    return dev


def row_sum_ring(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """``sum_i tab[idx[i], :]`` by row copies through a ring of 2 slots in
    each CTA (G3): idx i32 [n], tab f32 [M, W <= 128] -> f32 [1, W].  Each
    chunk of ``ring_chunks(n)`` is summed in the order of i, then the
    chunks' sums in chunk order: one order for any card.  One launch."""
    if idx.device.type == "cpu":
        return row_sum_ring_plain(idx, tab)
    dev = _check_ring("row_sum_ring", idx, tab, torch.float32, 2)
    if tab.shape[1] > ROW_SUM_MAX_WIDTH:
        raise ValueError(f"row_sum_ring: {tab.shape[1]} columns > "
                         f"{ROW_SUM_MAX_WIDTH} (the sums live in registers)")
    out = torch.empty((1, tab.shape[1]), dtype=torch.float32, device=dev)
    partials = torch.empty((len(ring_chunks(idx.shape[0])), tab.shape[1]),
                           dtype=torch.float32, device=dev)
    _launch("row_sum_ring", "rt_row_sum_ring", dev, idx.data_ptr(),
            idx.shape[0], tab.data_ptr(), tab.shape[0], tab.shape[1],
            out.data_ptr(), partials.data_ptr(),
            _ring_counter(dev).data_ptr())
    return out


def row_ring_rounds(idx: torch.Tensor, table: torch.Tensor, nbuf: int,
                    rounds: int) -> torch.Tensor:
    """``rounds`` passes of whole-row copies through a ring of ``nbuf`` slots
    in each CTA (G3), summing element 0 of each row: idx i32 [n], table i32
    [S, W] -> i32 [1, 1] = rounds * sum_i table[idx[i], 0], wrapping.  One
    launch."""
    if idx.device.type == "cpu":
        return row_ring_rounds_plain(idx, table, nbuf, rounds)
    dev = _check_ring("row_ring_rounds", idx, table, torch.int32, nbuf)
    if nbuf not in RING_DEPTHS or rounds < 0:
        raise ValueError(f"row_ring_rounds: nbuf {nbuf} not in "
                         f"{RING_DEPTHS}, or rounds {rounds} < 0")
    out = torch.empty((1, 1), dtype=torch.int32, device=dev)
    _launch("row_ring_rounds", "rt_row_ring_rounds", dev, idx.data_ptr(),
            idx.shape[0], table.data_ptr(), table.shape[0], table.shape[1],
            nbuf, rounds, out.data_ptr(), _ring_counter(dev).data_ptr())
    return out


# P6 -------------------------------------------------------------------------

def flat_gather_chain_plain(idx: torch.Tensor, table: torch.Tensor,
                            rounds: int) -> torch.Tensor:
    mask = table.shape[0] - 1
    cur = idx
    for _ in range(rounds):
        cur = (cur + table[cur.long()]) & mask
    return cur


class FlatPlan(NamedTuple):
    """G4's launch: the path (FLAT_PATHS) and ``threads`` a CTA, a chain a
    thread."""
    path: str
    threads: int


def flat_plan(size: int, n: int) -> FlatPlan:
    """The plan for a table of ``size`` entries and ``n`` chains, from the
    shapes alone: the table in each CTA's shared memory where it fits, else
    read where it lies, FLAT_THREADS a CTA.  Each local CTA stages the
    whole table, so past FLAT_LOCAL_CTAS x FLAT_THREADS chains its CTAs
    grow to up to 1024 threads before their number grows."""
    if 4 * size + 16 <= MAX_SMEM_BYTES:
        threads = -(-n // FLAT_LOCAL_CTAS // 32) * 32
        return FlatPlan("local", min(MAX_THREADS, max(FLAT_THREADS, threads)))
    return FlatPlan("global", FLAT_THREADS)


def flat_gather_chain(idx: torch.Tensor, table: torch.Tensor,
                      rounds: int) -> torch.Tensor:
    """``rounds`` chained gathers ``idx = (idx + table[idx]) & (S - 1)``
    (G4): idx i32 [n], table i32 [S], S a power of two -> i32 [n].  On the
    card ``flat_plan`` keeps a table of up to 2^15 entries in each CTA's
    shared memory and reads a larger one where it lies (the L2 binds it)."""
    if idx.device.type == "cpu":
        return flat_gather_chain_plain(idx, table, rounds)
    dev = _cuda_device("flat_gather_chain", idx)
    _check("flat_gather_chain", "idx", idx, torch.int32, 1, dev)
    _check("flat_gather_chain", "table", table, torch.int32, 1, dev)
    size = table.shape[0]
    if idx.shape[0] == 0 or size == 0 or size & (size - 1) or rounds < 0:
        raise ValueError(f"flat_gather_chain: need a non-empty idx, a table "
                         f"size that is a power of two (got {size}) and "
                         f"rounds >= 0 (got {rounds})")
    plan = flat_plan(size, idx.shape[0])
    out = torch.empty_like(idx)
    _launch("flat_gather_chain", "rt_flat_gather_chain", dev, idx.data_ptr(),
            idx.shape[0], table.data_ptr(), size, rounds, out.data_ptr(),
            FLAT_PATHS.index(plan.path), plan.threads)
    return out
