"""The benchmark's definition, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; everything that
belongs to one configuration, traffic mix, per-layer metric or cell is a
file of its own under ``perfbench/``:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): scene,
  tree, frame, camera, nets;
- ``traffic/<mix>.json``: rung, estimator, SPP, denoise, net, step limit,
  orbit, frames in flight (what every mix shares is fixed in
  ``traffic.py`` and ``check.py``);
- ``metrics/<metric>.py``: ``read(record)`` of a per-layer metric;
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct``.

A new cell, mix or metric is a new file and a new entry; no file changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list  # the metric entries this cell reports untraced
    per_layer: list  # ... and traced


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def cell(name: str, root: str = ROOT, bench: dict = None) -> Cell:
    bench = bench or load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=_json(root, conf["file"]), traffic_name=w["traffic"],
        traffic=_json(root, os.path.join("perfbench", "traffic",
                                         w["traffic"] + ".json")),
        limits=_json(root, os.path.join("perfbench", "limits",
                                        name + ".json")),
        end_to_end=e2e, per_layer=layer)


def reader(metric: str, root: str = ROOT):
    """``read`` of ``perfbench/metrics/<metric>.py``."""
    path = os.path.join(root, "perfbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
