"""Three-phase frame timer (render / net / filter) on CUDA events.

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

import time

import torch

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
