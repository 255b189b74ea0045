"""A copy of the benchmark with tiny cells that the CPU runs: the
configuration ``tiny_shell`` (the shell at depth 5, 64x64) under each
committed traffic mix."""

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SIZE, DEPTH = 64, 5
# the tiny cells' limits, set as the cells' are: the program's plain path
# at 64x64 on the CPU read at most (mean_abs, p999_abs, max_abs) 2.8e-5,
# 1.5e-3, 3.0e-3 (orbit), 1.0e-4, 4.8e-3, 6.7e-3 (fast05), 1.4e-10, 6.0e-8,
# 1.2e-7 (classic) over seeds 1000-1011; the control at least 8.4e-4,
# 1.7e-2, 2.5e-2 / 1.6e-3, 3.7e-2, 4.5e-2 / 4.0e-4, 8.8e-3, 1.3e-2 over
# seeds 1-3
LIMITS = {"orbit": {"mean_abs": 1.5e-4, "p999_abs": 5e-3, "max_abs": 9e-3},
          "fast05": {"mean_abs": 4e-4, "p999_abs": 1.4e-2,
                     "max_abs": 1.8e-2},
          "classic": {"mean_abs": 1e-6, "p999_abs": 1e-4, "max_abs": 1e-4}}
MIXES = tuple(LIMITS)


def make(root: str) -> None:
    """The benchmark's files copied to ``root`` plus the tiny cells
    ``tiny.<mix>`` (new files and new entries only)."""
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "nerf_synthetic_shell.json")) as f:
        cfg = json.load(f)
    scale = SIZE / cfg["width"]
    cfg.update(name="tiny_shell", width=SIZE, height=SIZE,
               fx=cfg["fx"] * scale, fy=cfg["fy"] * scale, lut_levels=DEPTH,
               tree=dict(cfg["tree"], depth=DEPTH, nodes=None))
    _dump(root, "perfbench/configs/tiny_shell.json", cfg)
    bench["configs"].append({"name": "tiny_shell", "source": "test",
                             "file": "perfbench/configs/tiny_shell.json",
                             "reduced": [], "why": "test"})
    for mix in MIXES:
        with open(os.path.join(ROOT, "perfbench", "traffic",
                               mix + ".json")) as f:
            m = json.load(f)
        _dump(root, f"perfbench/traffic/tiny_{mix}.json", m)
        _dump(root, f"perfbench/limits/tiny.{mix}.json", LIMITS[mix])
        bench["workloads"].append({"name": f"tiny.{mix}",
                                   "config": "tiny_shell",
                                   "traffic": f"tiny_{mix}", "chips": 1,
                                   "why": "test"})
        for metric in bench["per_layer"]:
            if f"shell800.{mix}" in metric.get("workloads", ()):
                metric["workloads"].append(f"tiny.{mix}")
    _dump(root, "BENCHMARK.json", bench)


def _dump(root: str, rel: str, obj) -> None:
    with open(os.path.join(root, rel), "w") as f:
        json.dump(obj, f, indent=1)
