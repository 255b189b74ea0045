"""Tools of the port.

The kit tools build and score denoiser quality kits (the blender layout
that train/dataset.py reads); counterparts of the JAX package's tools of
the same names.  They run on the card by default, and ``--device cpu``
runs the plain versions:

    python -m rt_octree_tpu_torch.tools.make_quality_dataset --out DIR \
        [--scene shell|solid|tt|blobs] [--gt_only] [--n_train 16]
    python -m rt_octree_tpu_torch.tools.make_fast_kit --out DIR \
        [--scene blobs --lod 8] [--fast_scale 0.5] [--gt_kit KIT]
    python -m rt_octree_tpu_torch.tools.eval_gnet_kit KIT NET.gnet [...]
    python -m rt_octree_tpu_torch.tools.set_gnet_meta NET.gnet key=value

The measurement tools, counterparts of tools/tpu_probe.py and
tools/microbench_gather.py, have no CPU mode: without a card they exit
non-zero before measuring.

    python -m rt_octree_tpu_torch.tools.gpu_probe [probe ...]
    python -m rt_octree_tpu_torch.tools.microbench_gather [a|b|c|d|all]
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
