"""Training CLI argument handling (the port's copy of
rt_octree_tpu/train/config.py, NumPy-free argparse).

Reference: denoiser/main.py:63-125 (flag set and defaults) and the shipped
config files denoiser/configs/*.txt.  ``--config`` files in the same
``key = value`` format are parsed natively and applied as defaults
(explicit CLI flags win).  The flags and defaults are the JAX package's,
plus ``--device`` (default ``cuda``): the port trains on the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def parse_config_file(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = (s.strip() for s in line.split("=", 1))
            out[k] = v
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("rtoctree-train")
    p.add_argument("--config", type=str, default=None,
                   help="config file path (key = value lines)")
    p.add_argument("--task", type=str,
                   choices=["train", "test", "compact"], help="task type")
    p.add_argument("--logs_root", type=str, default="../logs/")
    p.add_argument("--exp_name", type=str)
    p.add_argument("--data_dir", type=str,
                   default="../data/nerf_synthetic/lego")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, cuda:N, or cpu for the plain "
                        "versions of the kernels)")

    # dataset options
    p.add_argument("--dataset_type", type=str, default="blender",
                   help="options: llff / blender / tt")
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--preload", action="store_true",
                   help="stack the train split on the device once and "
                        "index batches there")
    p.add_argument("--nx", type=int, default=1)
    p.add_argument("--ny", type=int, default=1)

    # logging options
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--i_print", type=int, default=1)
    p.add_argument("--i_save", type=int, default=100)
    p.add_argument("--i_test", type=int, default=100)
    p.add_argument("--save_image", action="store_true")

    # training options
    p.add_argument("--in_channels", type=int, default=8)
    p.add_argument("--mid_channels", type=int, default=8)
    p.add_argument("--num_layers", type=int, default=8)
    p.add_argument("--num_branches", type=int, default=3)
    p.add_argument("--kernel_levels", type=int, default=8)
    p.add_argument("--identity_level", action="store_true",
                   help="shift filter supports to (0..L-1): level 0 is an "
                        "exact per-pixel passthrough (ops/filtering.py)")
    p.add_argument("--loss_fn", type=str, default="smape")
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--epochs", type=int, default=30000)
    p.add_argument("--batch_size", type=int, default=16)
    return p


_BOOL_FLAGS = {"preload", "use_wandb", "save_image", "identity_level"}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = build_parser()
    args, _ = parser.parse_known_args(argv)
    if args.config:
        file_vals = parse_config_file(args.config)
        defaults = {}
        for k, v in file_vals.items():
            if k in _BOOL_FLAGS:
                defaults[k] = v.lower() in ("1", "true", "yes")
            else:
                defaults[k] = v
        parser.set_defaults(**defaults)
    args = parser.parse_args(argv)
    # argparse keeps file-provided strings for typed options; re-coerce
    for action in parser._actions:
        if action.dest in vars(args) and action.type is not None:
            v = getattr(args, action.dest)
            if isinstance(v, str):
                setattr(args, action.dest, action.type(v))
    if args.task != "train":
        args.use_wandb = False
    args.work_dir = os.path.join(args.logs_root, args.exp_name or "default")
    return args
