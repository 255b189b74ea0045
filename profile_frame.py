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

    python3 profile_frame.py --render_scale S [--frames 20]

profiles the fast-mode frame instead (same output size and tree; K1
marches at round(800 S) square, K4 upsamples, then K7 (the net) and K2 at
800x800), with the fast net of that scale (fast.gnet at 0.5,
fast_s0.4.gnet at 0.4, as chip_smoke.py's gates; fast.gnet otherwise);
K1's per-pose times are then at the inner size.

    python3 profile_frame.py --k3 [--frames 5]

profiles kernel K3 on the same tree instead: each of its kernels' device
ms per entry call, for the LUT build and for the skip distances (the LUT
restored before each call, outside the entry); the last line is one JSON
object.
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


def kernel_ms(fn, reps: int, trace: str) -> dict:
    """Device ms of each kernel (and copy) per call of ``fn``, from a
    torch.profiler trace of ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    per = collections.defaultdict(float)
    for name, s, e in device_intervals(trace):
        short = name.replace("void ", "").replace("(anonymous namespace)::",
                                                  "")
        per[short.split("(")[0][:80]] += (e - s) / 1e3 / reps
    return dict(per)


def profile_k3(tree, reps: int, work: str) -> int:
    from rt_octree_tpu_torch.ops import traversal as T
    chs = T.upload_tree(tree, lut_levels=0, device="cuda").chs
    res = 512
    lut = T.build_lut(chs, 2, 9)
    buf = lut.clone()
    trace = os.path.join(work, "profile_k3_trace.json")
    out = {}
    for label, fn in (
            ("build", lambda: T.build_lut(chs, 2, 9)),
            ("skip", lambda: (
                buf.copy_(lut), T.add_skip_distances(buf, res, 12)))):
        out[label] = kernel_ms(fn, reps, trace)
        print(f"{label}:")
        for name, v in sorted(out[label].items(), key=lambda kv: -kv[1]):
            print(f"{v:12.4f} ms  {name}")
    print(json.dumps({"k3_kernel_ms_per_call": out}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--k3", action="store_true",
                    help="profile kernel K3 (LUT build, skip distances)")
    ap.add_argument("--render_scale", type=float, default=1.0,
                    help="profile the fast-mode frame at this scale")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from rt_octree_tpu_torch.io import synthetic
    from rt_octree_tpu_torch.render import renderer as R

    tree = synthetic.make_synthetic_tree("shell", depth=9, basis_dim=9)
    os.makedirs(cs.WORK, exist_ok=True)
    if args.k3:
        return profile_k3(tree, args.frames, cs.WORK)
    r, ps = cs.make_headline_renderer(tree)
    if args.render_scale != 1.0:
        gnet = cs.GATES_FAST.get(args.render_scale, ("fast.gnet",))[0]
        r = R.Renderer(r.tree, 800, 800, r.fx, r.fy,
                       options=cs.headline_options(),
                       render_scale=args.render_scale)
        r.set_denoiser(os.path.join(cs.KIT, gnet))
        print(f"fast mode: render_scale {args.render_scale}, march "
              f"{r.inner_width}x{r.inner_height}, {gnet}")
    iw, ih = r.inner_width, r.inner_height
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
            r.tree, tf, r.rng.state, r.rng.inc, width=iw, height=ih,
            fx=r.fx * (iw / 800), fy=r.fy * (ih / 800), opt=r.options,
            want_aux=False), 20, 3))
    print(f"K1 ms ({iw}x{ih}) on the 8 quality poses: "
          + ", ".join(f"{v:.4f}" for v in pose_ms))
    print(json.dumps({
        "frames": n, "render_scale": args.render_scale,
        "march": f"{iw}x{ih}", "device_events_per_frame": len(iv) / n,
        "busy_ms_per_frame": busy_ms, "span_ms_per_frame": span_ms,
        "idle_share": idle, "host_wall_ms_per_frame": wall_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
