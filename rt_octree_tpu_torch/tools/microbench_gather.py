"""Gather microbenchmarks of the card: the port of
tools/microbench_gather.py, with its sections.

  a  serial dependent gather, plain PyTorch index_select chains, vs row
     width and index count (the TPU tool's XLA gather); whole-card rate
  b  G3: per-row async copies of whole rows from HBM through a ring of
     nbuf slots in each CTA of 32 rows, one issuing thread a CTA, summing
     element 0 (P5)
  c  G4: chained gathers idx = (idx + table[idx]) & (S-1) from a table in
     shared memory (S = 2^14) or in the L2 (2^18, 2^20) (P6); the port adds
     S = 2^28 (1 GiB, the size of the render kernel's LUT), a table past
     the L2, with 8192 chains (latency) and 131072 (throughput)
  d  one-hot gather as a bf16 product, plain PyTorch

Usage: python -m rt_octree_tpu_torch.tools.microbench_gather [a|b|c|d|all]
(default: all).  Needs a CUDA card; every kernel is checked against its
plain version first, and a failure raises and exits non-zero.  Sections b,
c and d draw their inputs with np.random.default_rng(0) in the TPU tool's
order, so b and c see its exact inputs; section a makes its tables (up to
16 GiB) on the card from a seeded generator.  Times are CUDA events after a
warm-up; a kernel's time is its device time with the host's queuing hidden
(``device_ms``).  "marginal" is the time of one more round: the difference
of two round counts over their difference, which takes out the launch and
the staging.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import probes as P
from ..utils.timer import cuda_ms, device_ms, l2_flusher
from . import log, on, require, require_card

S_ROWS = 1 << 22  # sections a and b: table rows
RING_ROUNDS = 4
VMEM_CONFIGS = ((1 << 14, 8192), (1 << 18, 8192), (1 << 20, 8192),
                (1 << 18, 131072))
PAST_L2_CONFIGS = ((1 << 28, 8192), (1 << 28, 131072))
CHAIN_ROUNDS, CHAIN_ROUNDS_LONG = 16, 16 + 1024  # the marginal per round


def bench_xla_serial_gather(dev):
    log("== A. serial dependent gather (plain PyTorch index_select) ==")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    S = S_ROWS
    for width in (2, 16, 128, 256, 512, 1024):
        table = torch.randint(1, 1000, (S, width), generator=gen,
                              dtype=torch.int32, device=dev)
        for n_idx in (8192, 32768, 131072, 655360):
            idx0 = torch.randint(0, S, (n_idx,), generator=gen,
                                 dtype=torch.int32, device=dev)
            reps = 10 if n_idx <= 131072 else 4

            def chain(steps, table=table, idx0=idx0):
                cur = idx0
                for _ in range(steps):
                    cur = (cur + table.index_select(0, cur)[:, 0]) & (S - 1)
                return cur
            t8 = cuda_ms(lambda: chain(8), reps, 2)
            t72 = cuda_ms(lambda: chain(72), reps, 2)
            per_round = (t72 - t8) / 64
            log(f"  rows={width * 4:5d}B n_idx={n_idx:6d}: "
                f"{per_round:7.4f} ms/round "
                f"({n_idx / per_round / 1e3:7.1f} M rows/s, "
                f"{n_idx * width * 4 / per_round * 1e3 / 2 ** 30:6.1f} "
                f"GiB/s)")
        del table


def dma_configs(dev):
    """(width, n, nbuf, table, idx) of section b, drawn as the TPU tool
    draws them."""
    rng = np.random.default_rng(0)
    for width in (2, 128):
        table = on(dev, rng.integers(1, 1000, (S_ROWS, width),
                                     dtype=np.int32))
        for n_idx in (1024, 8192):
            idx = on(dev, rng.integers(0, S_ROWS, (n_idx,), dtype=np.int32))
            for nbuf in (8, 32):
                yield width, n_idx, nbuf, table, idx
        del table


def bench_pallas_dma(dev):
    log("== B. per-row async-copy gather from HBM (G3 rings, a CTA a "
        "chunk) ==")
    flush = l2_flusher(dev)
    for width, n, nbuf, table, idx in dma_configs(dev):
        run = lambda r: P.row_ring_rounds(idx, table, nbuf, r)  # noqa: E731
        require(torch.equal(run(RING_ROUNDS), P.row_ring_rounds_plain(
            idx, table, nbuf, RING_ROUNDS)), f"b rows={width * 4}B n={n}")
        t = device_ms(lambda: run(RING_ROUNDS), 5, 2) / RING_ROUNDS
        cold = cuda_ms(lambda: run(1), 5, 1, flush=flush)
        log(f"  rows={width * 4:5d}B n={n:5d} nbuf={nbuf:3d} "
            f"({len(P.ring_chunks(n))} CTAs): {t:8.4f} "
            f"ms/round ({t / n * 1e6:7.1f} ns/row); one round from a cold "
            f"L2 {cold:8.4f} ms ({cold / n * 1e6:7.1f} ns/row)")


def vmem_configs(dev):
    """(S, n, table, idx0) of section c, drawn as the TPU tool draws them,
    then the port's tables past the L2."""
    rng = np.random.default_rng(0)
    for S, n_idx in VMEM_CONFIGS + PAST_L2_CONFIGS:
        table = on(dev, rng.integers(1, 1000, (S,), dtype=np.int32))
        idx0 = on(dev, rng.integers(0, S, (n_idx,), dtype=np.int32))
        yield S, n_idx, table, idx0


def bench_pallas_vmem_gather(dev):
    log("== C. chained table gather (G4; shared memory, L2, HBM) ==")
    for S, n, table, idx0 in vmem_configs(dev):
        run = lambda r: P.flat_gather_chain(idx0, table, r)  # noqa: E731
        require(torch.equal(run(CHAIN_ROUNDS), P.flat_gather_chain_plain(
            idx0, table, CHAIN_ROUNDS)), f"c S={S} n={n}")
        t = device_ms(lambda: run(CHAIN_ROUNDS), 10, 2)
        t_long = device_ms(lambda: run(CHAIN_ROUNDS_LONG), 10, 2)
        per_round = t / CHAIN_ROUNDS
        marginal_ns = (t_long - t) / (CHAIN_ROUNDS_LONG - CHAIN_ROUNDS) * 1e6
        log(f"  S={S:9d} ({S * 4 / 2 ** 20:6.1f}MB) n={n:6d}: "
            f"{per_round:8.5f} ms/round ({n / per_round / 1e3:8.1f} M/s); "
            f"marginal {marginal_ns:7.1f} ns/round ({CHAIN_ROUNDS} vs "
            f"{CHAIN_ROUNDS_LONG} rounds)")


def bench_onehot_gather(dev):
    log("== D. one-hot gather as a bf16 product (plain PyTorch) ==")
    rng = np.random.default_rng(0)
    for S, n_idx, W in ((4096, 65536, 8), (16384, 65536, 8)):
        table = on(dev, rng.standard_normal((S, W)).astype(np.float32))
        idx = on(dev, rng.integers(0, S, (n_idx,), dtype=np.int32))
        cols = torch.arange(S, device=dev)

        def fn(table=table, idx=idx, cols=cols):
            onehot = (idx.long()[:, None] == cols[None, :]).to(torch.bfloat16)
            return torch.matmul(onehot, table.to(torch.bfloat16)).float()
        # a product with one 1 per row picks the bf16 row exactly
        if not torch.equal(fn(), table.to(torch.bfloat16)[idx.long()].float()):
            raise RuntimeError(f"d S={S}: the one-hot product is not the "
                               "gathered row")
        t = cuda_ms(fn, 5, 2)
        log(f"  S={S:6d} n={n_idx:6d} W={W}: {t:8.4f} ms "
            f"({n_idx / t / 1e3:8.1f} M rows/s)")


SECTIONS = {"a": bench_xla_serial_gather, "b": bench_pallas_dma,
            "c": bench_pallas_vmem_gather, "d": bench_onehot_gather}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m rt_octree_tpu_torch.tools.microbench_gather",
        description="Gather microbenchmarks of the card (port of "
                    "tools/microbench_gather.py).")
    ap.add_argument("which", nargs="?", default="all",
                    choices=list(SECTIONS) + ["all"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = require_card("microbench_gather")
    for name, section in SECTIONS.items():
        if args.which in ("all", name):
            section(dev)
    log("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
