"""A configuration's assets: its tree, made once per checkout, and its
nets, checked against the sha256 the configuration gives."""

from __future__ import annotations

import hashlib
import os
import sys
import time

from . import generator

CACHE = os.path.join("perfbench", ".cache", "trees")


def tree_path(cfg: dict, root: str) -> str:
    """The configuration's tree npz, generated by the frozen generator and
    written under the checkout's ``perfbench/.cache/trees/`` if absent
    (the first run of a configuration in a checkout)."""
    t = cfg["tree"]
    path = os.path.join(root, CACHE, f"{cfg['name']}.npz")
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    tree = generator.make_synthetic_tree(t["kind"], depth=int(t["depth"]),
                                         basis_dim=int(t["basis_dim"]))
    if t.get("nodes") is not None and tree["capacity"] != t["nodes"]:
        raise RuntimeError(f"{cfg['name']}: generated {tree['capacity']} "
                           f"nodes, the configuration says {t['nodes']}")
    partial = path[:-len(".npz")] + ".partial.npz"
    generator.save_npz(tree, partial)
    os.replace(partial, path)
    print(f"perfbench: made {path}: {tree['capacity']} nodes, depth "
          f"{tree['max_depth']}, {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return path


def net_path(cfg: dict, role: str, root: str) -> str:
    """The checked path of the configuration's net ``role``."""
    net = cfg["nets"][role]
    path = os.path.join(root, net["file"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != net["sha256"]:
        raise RuntimeError(f"{path}: sha256 {digest}, the configuration "
                           f"says {net['sha256']}")
    return path
