"""Measurement tools of the port, run on one CUDA card:

    python -m rt_octree_tpu_torch.tools.gpu_probe [probe ...]
    python -m rt_octree_tpu_torch.tools.microbench_gather [a|b|c|d|all]

Counterparts of tools/tpu_probe.py and tools/microbench_gather.py.  They
have no CPU mode: without a card they exit non-zero before measuring.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def require_card(tool: str) -> torch.device:
    """The first CUDA device, after printing its name and power limit as
    nvidia-smi reports them; SystemExit (non-zero) without a card."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device; this tool measures the "
                         "card and has no CPU mode")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {smi} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")
    return torch.device("cuda", 0)


def log(msg: str) -> None:
    print(msg, flush=True)


def on(device, array: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"{what}: the kernel disagrees with its plain "
                           "version")
