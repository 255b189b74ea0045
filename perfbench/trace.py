"""The traced run's record: device operations from ``torch.profiler``, the
benchmark's own host stamps of each frame, and what set-up measured.

The profiler traces the card's operations over the whole window.  Its
clock is tied to the host's by a marker kernel launched at a known host
time before the window.  The device's busy time is the union of its
operations' intervals inside the window; an idle gap is named by the
benchmark's host span open at its middle (``wait`` for frame i - in
flight, ``render``, ``advance_rng``, or ``loop``: the stamps, the event
record, the sample) and by the operation that ends it.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Optional

import numpy as np
import torch

SPANS = ("wait", "render", "advance_rng", "loop")


def short(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)::", "")
    n = re.split(r"[<(]", n, maxsplit=1)[0].strip().split("::")[-1]
    return (n or name)[:40]


def _kineto_device_events(prof):
    """[(name, start_ns, end_ns)] of the device's operations."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), int(s), int(s + d)))
    return out


class Tracer:
    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        self.cuda = device.type == "cuda"
        act = ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU
        self.prof = profile(activities=[act])
        self.device = device
        self.marker_host = None

    def start(self) -> None:
        self.prof.start()
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.marker_host = time.perf_counter()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize(self.device)

    def stop(self) -> list:
        """The device's operations, sorted by start: [(name, start s, end
        s)] on the host's clock."""
        self.prof.stop()
        if not self.cuda:
            return []
        ev = sorted(_kineto_device_events(self.prof), key=lambda e: e[1])
        if not ev:
            raise RuntimeError("the profiler recorded no device operation")
        m0 = ev[0][1]  # the marker: the first operation after a sync
        h = self.marker_host
        return [(n, h + (s - m0) * 1e-9, h + (e - m0) * 1e-9)
                for n, s, e in ev[1:]]


@dataclasses.dataclass
class Record:
    """What the per-layer readers read (``perfbench/metrics/*.py``)."""

    device: bool  # False: not a card's run; device metrics read nothing
    frames: int
    frame_ms: float  # this run's window, by its events
    window_s: float  # the traced window on the device's timeline
    busy_s: float
    host_ms_frame: float  # mean of render + advance_rng, ms
    load_s: float
    ops: dict  # full operation name -> device seconds in the window
    bounds: dict  # stage -> least seconds a frame (count)

    def kernel_ms(self, *names) -> Optional[float]:
        """Device ms a frame of the operations whose short name is one of
        ``names``; None when no such operation ran."""
        t = [s for n, s in self.ops.items() if short(n) in names]
        if not self.device or not t:
            return None
        return 1e3 * sum(t) / self.frames

    def bound_ms(self, stage: str) -> Optional[float]:
        b = self.bounds.get(stage)
        return None if b is None or not self.device else 1e3 * b


def summarize(ops: list, host: np.ndarray, start_host: float):
    """(ops by name, busy s, window s, device ops breakdown, idle gaps by
    host span) of the operations after the window's start; the window
    ends with the last of them."""
    inside = [o for o in ops if o[2] > start_host]
    by_name = {}
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - max(s, start_host))
    end = max([start_host] + [o[2] for o in inside])
    busy, gaps, cur_s, cur_e, prev_end = 0.0, [], None, None, start_host
    for n, s, e in inside:
        s = max(s, start_host)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > prev_end:
                gaps.append((prev_end, s, n))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_end = max(prev_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    # each frame's four stamps open the spans SPANS in turn
    stamps = host.reshape(-1)
    idle = {}
    for g0, g1, n in gaps:
        k = int(np.searchsorted(stamps, 0.5 * (g0 + g1), side="right")) - 1
        span = SPANS[k % 4] if k >= 0 else "start"
        key = f"{span}>{short(n)}"
        idle[key] = idle.get(key, 0.0) + (g1 - g0)
    merged = {}
    for n, t in by_name.items():
        merged[short(n)] = merged.get(short(n), 0.0) + t
    device_ops = sorted(merged.items(), key=lambda x: -x[1])[:10]
    idle_gaps = sorted(idle.items(), key=lambda x: -x[1])[:10]
    return (by_name, busy, end - start_host,
            [[n, t] for n, t in device_ops], [[n, t] for n, t in idle_gaps])
