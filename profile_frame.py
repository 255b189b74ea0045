#!/usr/bin/env python3
"""Where the headline frame's time goes on one GPU (torch.profiler).

Run from the repository root:  python3 profile_frame.py [--frames 20]

Builds the headline configuration of chip_smoke.py (depth-9 SH9 shell
tree, level-9 LUT with skip distances, 800x800, SPP 6, denoise on with
benchmarks/quality/trained.gnet), renders pose r_0 ``--frames`` times under
torch.profiler and prints:
  - each device kernel's time per frame, from the trace's kernel events;
  - device busy time per frame: the union of all kernel, memcpy and memset
    intervals, so that nothing is counted twice;
  - the idle share: 1 - busy / span, where span runs from the first device
    event's start to the last one's end;
  - the host's wall time per frame (the profiler slows the host, so the
    idle share is an upper bound on the unprofiled run's);
  - K1's time on each of the 8 quality poses by CUDA events, and the peak
    device memory.
The last line is the summary as one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_intervals(trace_path: str):
    """(name, start_us, end_us) of every device event in a Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from rt_octree_tpu.io import synthetic
    from rt_octree_tpu_torch.render import renderer as R

    tree = synthetic.make_synthetic_tree("shell", depth=9, basis_dim=9)
    r, ps = cs.make_headline_renderer(tree)
    pose = ps.poses[0]
    n = args.frames
    for _ in range(10):
        r.render(pose, want_aux=False)
        r.advance_rng()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            r.render(pose, want_aux=False)
            r.advance_rng()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    os.makedirs(cs.WORK, exist_ok=True)
    trace = os.path.join(cs.WORK, "profile_frame_trace.json")
    prof.export_chrome_trace(trace)
    iv = device_intervals(trace)
    if not iv:
        print("profile_frame: the trace holds no device events",
              file=sys.stderr)
        return 1

    per_kernel = collections.defaultdict(float)
    for name, s, e in iv:
        per_kernel[name] += (e - s) / 1e3 / n
    print(f"{'device ms/frame':>16}  kernel")
    for name, v in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        print(f"{v:16.4f}  {name[:100]}")
    busy_ms = busy_us(iv) / 1e3 / n
    span_ms = (max(e for _, _, e in iv) - min(s for _, s, _ in iv)) / 1e3 / n
    idle = 1.0 - busy_ms / span_ms

    pose_ms = []
    for p in ps.poses[:8]:
        tf = r._transform(p)
        pose_ms.append(cs.cuda_ms(lambda: R.render_noisy(
            r.tree, tf, r.rng.state, r.rng.inc, width=800, height=800,
            fx=r.fx, fy=r.fy, opt=r.options, want_aux=False), 20, 3))
    print("K1 ms on the 8 quality poses: "
          + ", ".join(f"{v:.4f}" for v in pose_ms))
    print(json.dumps({
        "frames": n, "device_events_per_frame": len(iv) / n,
        "busy_ms_per_frame": busy_ms, "span_ms_per_frame": span_ms,
        "idle_share": idle, "host_wall_ms_per_frame": wall_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
