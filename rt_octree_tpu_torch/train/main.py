"""Denoiser training entry point: ``python -m
rt_octree_tpu_torch.train.main`` or ``rtoctree train`` (apps/cli.py).

Reference: denoiser/main.py:16-60.  Tasks: train / test / compact, on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from .config import parse_args
from .dataset import DatasetConfig, make_dataset
from .logger import BaseLogger, WandbLogger
from .runner import Runner, seed_everything


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    seed_everything(0)

    logger = WandbLogger(args) if args.use_wandb else BaseLogger(args)

    if args.task == "compact":
        runner = Runner(args, logger=logger)
        runner.compact(load_ckpt=True)
        return 0

    dataset = make_dataset(DatasetConfig(
        data_dir=args.data_dir, dataset_type=args.dataset_type,
        spp=args.spp, nx=args.nx, ny=args.ny,
        in_channels=args.in_channels, task=args.task))
    logger.print("Dataset loaded.")

    runner = Runner(args, dataset=dataset, logger=logger)
    if args.task == "train":
        runner.train()
    elif args.task == "test":
        runner.test()
    else:
        raise NotImplementedError(f"Invalid task type: {args.task}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
