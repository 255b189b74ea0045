"""Microbenchmarks of the card that bound the render kernel's march: the
port of tools/tpu_probe.py, with its probe names.

  basic         G1: o = 2x + 1, the toolchain check (P1)
  vgather       G2: per-lane gather out[i,l] = tab[idx[i,l], l] (P2)
  vgather_loop  G2: 32 chained per-lane gathers, the march's dependency
                shape, from a table staged in shared memory, each
                4-column block read once a cluster of 2 CTAs (P3)
  dma           G3: 4096 dynamic-index 512 B row copies, summed, from a
                512 MiB table (P4): a CTA a chunk of 32 rows, each through
                a ring of 2 bulk-copy slots
  xgather       plain PyTorch: chains of dependent index_select vs index
                count and row width (the TPU tool's XLA gather)
  loop          plain PyTorch: a loop that syncs the host every round
                (while any(active)) vs a fixed number of rounds

Usage: python -m rt_octree_tpu_torch.tools.gpu_probe [probe ...]  (default:
all).  Needs a CUDA card.  Every kernel is checked against its plain
version first; a probe that fails raises and the tool exits non-zero.
Inputs are drawn with numpy from fixed seeds.  Times are CUDA events after
a warm-up; a kernel's time is its device time with the host's queuing
hidden (``device_ms``), and "cold" times flush the L2 before each call.
"marginal" is the time of one more round: the difference of two round
counts over their difference, which takes out the launch and the staging.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops import probes as P
from ..utils.timer import cuda_ms, device_ms, l2_flusher
from . import log, on, require, require_card

VG_T, VG_R = 4096, 1024            # vgather: table rows, result rows
VL_T, VL_R, VL_K = 8192, 2048, 32  # vgather_loop: table, result rows, rounds
VL_K_LONG = VL_K + 1024           # second round count for the marginal
DMA_N, DMA_W, DMA_M = 4096, 128, 1 << 20  # dma: rows copied, width, table rows
# f32 sum of 4096 terms (G3's chunk order) against a float64 sum
DMA_RTOL = 1e-5


def basic_input(dev) -> torch.Tensor:
    return torch.arange(8 * 128, dtype=torch.float32,
                        device=dev).reshape(8, 128)


def vgather_inputs(dev):
    rng = np.random.default_rng(0)
    tab = rng.random((VG_T, 128), dtype=np.float32)
    idx = rng.integers(0, VG_T, (VG_R, 128), dtype=np.int32)
    return on(dev, tab), on(dev, idx)


def vgather_loop_inputs(dev):
    rng = np.random.default_rng(0)
    tab = rng.integers(0, 3, (VL_T, 128), dtype=np.int32)
    idx = rng.integers(0, VL_T, (VL_R, 128), dtype=np.int32)
    return on(dev, tab), on(dev, idx)


def dma_inputs(dev):
    rng = np.random.default_rng(0)
    tab = rng.random((DMA_M, DMA_W), dtype=np.float32)
    idx = rng.integers(0, DMA_M, (DMA_N,), dtype=np.int32)
    return on(dev, idx), on(dev, tab)


def dma_rel_err(out: torch.Tensor, idx: torch.Tensor,
                tab: torch.Tensor) -> float:
    """max |out - sum| / max |sum| against the float64 sum of the rows."""
    ref = tab.index_select(0, idx.long()).double().sum(0)
    return float((out[0].double() - ref).abs().max() / ref.abs().max())


def probe_basic(dev):
    x = basic_input(dev)
    ok = torch.equal(P.probe_affine(x), P.probe_affine_plain(x))
    log(f"[basic] G1 on {dev}: ok={ok}")
    require(ok, "basic")


def probe_vgather(dev):
    tab, idx = vgather_inputs(dev)
    ok = torch.equal(P.lane_gather(tab, idx), P.lane_gather_plain(tab, idx))
    require(ok, "vgather")
    ms = device_ms(lambda: P.lane_gather(tab, idx), 10, 2)
    n = VG_R * 128
    log(f"[vgather] ok={ok} {n} elems in {ms:.4f} ms -> "
        f"{n / ms / 1e3:.0f} M elems/s")


def probe_vgather_loop(dev):
    tab, idx = vgather_loop_inputs(dev)
    ok = torch.equal(P.lane_gather_chain(tab, idx, VL_K),
                     P.lane_gather_chain_plain(tab, idx, VL_K))
    require(ok, "vgather_loop")
    ms = device_ms(lambda: P.lane_gather_chain(tab, idx, VL_K), 10, 2)
    ms_long = device_ms(lambda: P.lane_gather_chain(tab, idx, VL_K_LONG), 10,
                        2)
    marginal_ns = (ms_long - ms) / (VL_K_LONG - VL_K) * 1e6
    log(f"[vgather_loop] ok={ok} K={VL_K} chained rounds of {VL_R}x128: "
        f"{ms:.4f} ms total, {ms / VL_K * 1e3:.2f} us/round, "
        f"{VL_R * 128 * VL_K / ms / 1e3:.0f} M elems/s; marginal "
        f"{marginal_ns:.1f} ns/round ({VL_K} vs {VL_K_LONG} rounds)")


def probe_dma(dev):
    idx, tab = dma_inputs(dev)
    rel = dma_rel_err(P.row_sum_ring(idx, tab), idx, tab)
    ok = rel <= DMA_RTOL
    if not ok:
        raise RuntimeError(f"dma: relative error {rel:.3g} against the "
                           f"float64 sum exceeds {DMA_RTOL}")
    run = lambda: P.row_sum_ring(idx, tab)  # noqa: E731
    cold = cuda_ms(run, 5, 1, flush=l2_flusher(dev))
    warm = device_ms(run, 5, 1)
    log(f"[dma] ok={ok} (rel err {rel:.2e}) {DMA_N} row copies "
        f"({DMA_W * 4}B rows, {len(P.ring_chunks(DMA_N))} CTAs of a 2-slot "
        f"ring): cold L2 {cold:.4f} ms -> "
        f"{DMA_N / cold / 1e3:.2f} M rows/s, {cold / DMA_N * 1e6:.0f} "
        f"ns/row; warm L2 {warm:.4f} ms, {warm / DMA_N * 1e6:.0f} ns/row")


def probe_xgather(dev):
    """Dependent index_select chains vs index count and row width."""
    M, K = 1 << 20, 16
    rng = np.random.default_rng(0)
    tabs = {w: on(dev, rng.integers(1, 5, (M, w), dtype=np.int32))
            for w in (2, 16, 128)}
    for n_idx in (1024, 16384, 131072, 655360):
        idx = on(dev, rng.integers(0, M, (n_idx,), dtype=np.int32))
        for width, tab in tabs.items():
            def chain(tab=tab):
                cur = idx
                for _ in range(K):
                    row = tab.index_select(0, cur)
                    cur = torch.remainder(cur + row[:, 0] + 7, M)
                return cur
            per_round = cuda_ms(chain, 5, 2) / K
            log(f"[xgather] n={n_idx:7d} width={width:3d} "
                f"({width * 4:4d}B): {per_round:7.4f} ms/round, "
                f"{n_idx / per_round / 1e3:7.1f} M rows/s")


def probe_loop(dev):
    """A round loop that asks the host whether any index is alive (the
    plain render's while active.any()) vs a fixed number of rounds."""
    M, K = 1 << 20, 64
    rng = np.random.default_rng(0)
    tab = on(dev, rng.integers(1, 5, (M, 2), dtype=np.int32))
    for n_idx in (4096, 65536):
        idx0 = on(dev, rng.integers(0, M, (n_idx,), dtype=np.int32))

        def step(cur):
            return torch.remainder(cur + tab.index_select(0, cur)[:, 0] + 7,
                                   M)

        def f_while():
            k, cur = 0, idx0
            while k < K and bool((cur >= 0).any()):
                k, cur = k + 1, step(cur)
            return cur

        def f_scan():
            cur = idx0
            for _ in range(K):
                cur = step(cur)
            return cur

        if not torch.equal(f_while(), f_scan()):
            raise RuntimeError("loop: the two loops disagree")
        dt_w = cuda_ms(f_while, 5, 2)
        dt_s = cuda_ms(f_scan, 5, 2)
        log(f"[loop] n={n_idx}: while={dt_w / K:.4f} ms/round, "
            f"scan={dt_s / K:.4f} ms/round")


PROBES = {
    "basic": probe_basic,
    "vgather": probe_vgather,
    "vgather_loop": probe_vgather_loop,
    "dma": probe_dma,
    "xgather": probe_xgather,
    "loop": probe_loop,
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m rt_octree_tpu_torch.tools.gpu_probe",
        description="Microbenchmarks of the card (port of "
                    "tools/tpu_probe.py).")
    ap.add_argument("probes", nargs="*", metavar="probe",
                    help=f"any of {', '.join(PROBES)} (default: all)")
    args = ap.parse_args(argv)
    unknown = [p for p in args.probes if p not in PROBES]
    if unknown:
        ap.error(f"unknown probe(s) {unknown}; choose from {list(PROBES)}")
    args.probes = args.probes or list(PROBES)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = require_card("gpu_probe")
    for name in args.probes:
        t0 = time.time()
        PROBES[name](dev)
        log(f"[{name}] done in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
