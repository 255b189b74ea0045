"""Three-phase frame timer (render / net / filter) on CUDA events, and
CUDA-event timing of single calls (``cuda_ms``, ``device_ms``,
``device_medians``).

Reference: RenderContext::Timer (render_context.hpp:122-213): event pairs
around the render kernel, the network forward and the filter kernel,
reported as per-phase mean ms + FPS.  Counterpart of
rt_octree_tpu/utils/timer.py with the same report format.

On a CUDA device every phase is bracketed by two ``torch.cuda.Event``s on
the current stream; elapsed times are read (after one synchronize) when the
means are asked for, so timing adds no host sync between phases.  On the
CPU the phases are timed with the host clock.
"""

from __future__ import annotations

import statistics
import time

import torch

# The SM clock's ceiling on an H100 (1.98 GHz); a sleep sized with it lasts
# at least as long as asked at any lower clock.
_SLEEP_CYCLES_PER_S = 2.0e9

T_RENDER, T_NET, T_FILTER = 0, 1, 2
_NAMES = ("render", "net", "filter")


class PhaseTimer:
    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        self.sum = [0.0, 0.0, 0.0]  # seconds
        self.cnt = 0
        self._pending = []  # (phase, start event, end event)

    def phase(self, idx: int):
        return _PhaseCtx(self, idx)

    def frame_done(self):
        self.cnt += 1

    def _fold_events(self):
        if self._pending:
            torch.cuda.synchronize(self.device)
            for idx, start, end in self._pending:
                self.sum[idx] += start.elapsed_time(end) / 1000.0
            self._pending = []

    def means_ms(self):
        self._fold_events()
        c = max(self.cnt, 1)
        return [s * 1000.0 / c for s in self.sum]

    def report(self) -> str:
        m = self.means_ms()
        total = sum(m)
        fps = 1000.0 / total if total > 0 else float("inf")
        lines = [f"[Timer] frames: {self.cnt}"]
        for name, v in zip(_NAMES, m):
            lines.append(f"[Timer]   {name:>6s}: {v:9.3f} ms")
        lines.append(f"[Timer]   total : {total:9.3f} ms  ({fps:.2f} FPS)")
        return "\n".join(lines)


class _PhaseCtx:
    def __init__(self, timer: PhaseTimer, idx: int):
        self.timer = timer
        self.idx = idx

    def __enter__(self):
        if self.timer.device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.timer.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.timer._pending.append((self.idx, self._start, end))
        else:
            self.timer.sum[self.idx] += time.perf_counter() - self._t0
        return False


def cuda_ms(fn, reps: int, warmup: int = 1, flush=None) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls by CUDA events, after
    ``warmup`` untimed calls.  Without ``flush`` the calls run back to back
    between one pair of events.  With it, ``flush()`` runs before each call
    outside its own pair of events, so that every call starts cold."""
    for _ in range(warmup):
        fn()
    if flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    pairs = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def device_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device ms of ``reps`` back-to-back ``fn()`` calls without the
    host's cost of queuing them: the timed calls are queued behind a sleep
    kernel that lasts longer than queuing them took untimed, so the card
    runs them without waiting for the host.  For kernels shorter than their
    wrapper's host time, where ``cuda_ms`` measures the host.  A call that
    waits for the card still pays its wait."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    queue_s = time.perf_counter() - t0  # queuing and running: a bound
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((1.5 * queue_s + 1e-3) * _SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_medians(fns: dict, reps: int, warmup: int = 1) -> dict:
    """name -> median device ms of ``fns[name]()`` over ``reps`` calls,
    the functions called in turns, each call between its own pair of CUDA
    events.  As in ``device_ms``, the host's queuing is not timed: each
    call is queued behind a sleep kernel that lasts longer than one
    untimed call of that function took to queue and run."""
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    sleep = {}
    for k, fn in fns.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        queue_s = time.perf_counter() - t0  # queuing and running: a bound
        sleep[k] = int((1.5 * queue_s + 1e-4) * _SLEEP_CYCLES_PER_S)
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(sleep[k])
            start.record()
            fn()
            end.record()
            times[k].append((start, end))
    torch.cuda.synchronize()
    return {k: statistics.median(s.elapsed_time(e) for s, e in v)
            for k, v in times.items()}


def l2_flusher(device, nbytes: int = 256 << 20):
    """A callable that writes ``nbytes`` on ``device``, more than the 50 MB
    L2 of an H100 holds, so that the next kernel finds the L2 cold."""
    buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return lambda: buf.fill_(1)
