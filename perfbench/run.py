"""The benchmark of rt_octree_tpu_torch on one card: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout.  The run finds the card (none, or fewer than
the cell asks for: exit 2, no result), builds what is not built yet of the
port's kernels (in the checkout's build/rt_octree_tpu_torch), reads the
cell's tree (made once per checkout under perfbench/.cache), sets up the
port's Renderer, warms up on the cell's own frames and measures a closed
loop of one viewer for ``--seconds``.  Then it checks a sample of the
window's frames against the reference and prints, as its last line, one
JSON object: correct, attempted, failed, metrics, device (and, traced,
breakdown), then ``check``, each compared number beside its limit, which
also ends standard error.

``--trace 0`` reports the cell's end-to-end metrics: ``frame_ms`` (the
window's device time over its frames, by an event after each frame),
``frame_p95_ms`` (the 95th percentile of the frame-to-frame intervals) and
``setup_s`` (this process's start to the window's start).  ``--trace 1``
traces the window with torch.profiler and reports the cell's per-layer
metrics, each read by ``perfbench/metrics/<name>.py``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout's root, not this directory, whose module names (trace, ...)
# would hide the standard library's
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") not in (HERE, ROOT)]

# whole top-level module names that may not be loaded when the result is
# printed: JAX and the JAX package (the port's name only starts with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "rt_octree_tpu")
MAX_LINE = 1900  # characters of the result line
# PyTorch's build caches, fixed inside the checkout (the port builds its
# kernels into the checkout's build/ itself)
SETUP_CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
                "TRITON_CACHE_DIR": "triton"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def fit(line: dict) -> str:
    """The JSON line, the breakdown's smallest entries dropped while it is
    longer than MAX_LINE."""
    while True:
        s = json.dumps(line)
        bd = line.get("breakdown")
        if len(s) <= MAX_LINE or not bd or not any(bd.values()):
            return s
        key = max(bd, key=lambda k: len(bd[k]))
        bd[key] = bd[key][:-1]


def main(argv=None, root: str = ROOT, device=None) -> int:
    """One run; returns the exit code.  ``device``: run on this device
    without looking for a card (the harness's own tests, on the CPU)."""
    args = parse(argv)
    for var, sub in SETUP_CACHES.items():
        os.environ.setdefault(var, os.path.join(root, "perfbench", ".cache",
                                                sub))
    from perfbench import spec
    cell = spec.cell(args.workload, root)
    import numpy as np
    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s), "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    from perfbench import check, scene, system, trace, traffic
    cfg, mix = cell.config, cell.traffic
    traced = bool(args.trace)

    # ---- set-up: everything up to the window's first frame
    steps = {"imports": time.perf_counter() - T0}

    def step(name):
        steps[name] = time.perf_counter() - T0 - sum(steps.values())

    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        step("cuda_context")
        system.build_libraries()
        step("build")
    npz = scene.tree_path(cfg, root)
    net = scene.net_path(cfg, mix["net"], root) if mix["denoise"] else None
    orbit = traffic.orbit(mix, float(cfg["orbit_radius"]), args.seed)
    step("assets_and_orbit")
    dt, load_s = system.load(npz, cfg, device)
    step("load")
    r = system.renderer(dt, cfg, mix, net, orbit.pcg32_offset)
    step("renderer")
    warm = traffic.WARMUP_FRAMES
    host_s = system.frames(r, orbit, 0, warm, device)
    step("warmup")
    clock = system.Clock(device)
    pool = system.stamps(clock, int(1.3 * args.seconds / host_s) + 256,
                         device)
    step("stamps")
    print(f"perfbench setup_steps_s {json.dumps(steps)}", file=sys.stderr)
    keep = system.Keep(check.CHECK_FRAMES, args.seed)
    tracer = trace.Tracer(device) if traced else None
    if tracer:
        tracer.start()

    # ---- the window
    w = system.window(r, orbit, warm, args.seconds,
                      int(mix["in_flight"]), keep, clock, pool, device,
                      traced)
    setup_s = w.start_host - T0
    ops = tracer.stop() if tracer else []
    # the process's peak: the load's scratch, the tree and the window
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)

    # ---- the check: the program's state freed, the reference's own load
    kept = w.kept
    del r, dt, pool, keep
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    per_frame, works = [], []
    t_check = time.perf_counter()
    with torch.inference_mode():
        ref = check.Reference.load(npz, net, cfg, mix, device)
        for i in sorted(kept):
            n = warm + i
            res = ref.render(orbit.pose(n), orbit.pcg32_offset + n)
            per_frame.append(check.compare(kept[i], res.img))
            del res
        t_count = time.perf_counter()
        if traced:
            # the rooflines' work, on poses that are the same for every seed
            for pose, f in traffic.counted(mix, float(cfg["orbit_radius"])):
                works.append(ref.work(ref.render(pose, f)))
    print(f"perfbench check_s {t_count - t_check:.3f} count_s "
          f"{time.perf_counter() - t_count:.3f}", file=sys.stderr)
    numbers = check.worst(per_frame)
    correct, judged = check.verdict(numbers, cell.limits)

    # ---- the result
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": w.frames, "failed": 0}
    if not traced:
        values = {"frame_ms": w.frame_ms,
                  "frame_p95_ms": float(np.percentile(w.intervals_ms, 95)),
                  "setup_s": setup_s}
        line["metrics"] = {m["name"]: {"value": values[m["name"]],
                                       "unit": m["unit"]}
                           for m in cell.end_to_end if m["name"] in values}
        line["device"] = dev
    else:
        by_name, busy, span, dev_ops, gaps = trace.summarize(
            ops, w.host, w.start_host)
        stages = {k for wk in works for k in wk}
        bounds = {k: sum(wk[k].bound_s() for wk in works) / len(works)
                  for k in stages}
        host_ms = float(1e3 * (w.host[:, 3] - w.host[:, 1]).mean())
        rec = trace.Record(device=device.type == "cuda", frames=w.frames,
                           frame_ms=w.frame_ms, window_s=span, busy_s=busy,
                           host_ms_frame=host_ms, load_s=load_s,
                           ops=by_name, bounds=bounds)
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"], root)(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        line["metrics"] = metrics
        line["device"] = dict(dev, busy_s=busy, window_s=span)
        line["breakdown"] = {"device_ops": dev_ops, "idle_gaps": gaps}
    line["card"] = power_limit() if device.type == "cuda" else "cpu"
    line["check"] = dict(judged, frames=len(per_frame))

    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded {', '.join(bad)}: the run may not load "
              "JAX or the JAX package", file=sys.stderr)
        return 3
    for k, (v, lim) in judged.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(fit(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
