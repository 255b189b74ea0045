"""Training loggers (the port's copy of rt_octree_tpu/train/logger.py,
with io/png.write_png where the JAX package uses imageio).

Reference: denoiser/logger/base_logger.py, wandb_logger.py.
BaseLogger: args.json dump, stdout prints, JSON-line metric log, PNG image
dumps.  WandbLogger activates only if wandb is importable, or with a stub
module handed in (the tests' hook).
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from ..io.png import write_png


class BaseLogger:
    def __init__(self, args: Any):
        work_dir = getattr(args, "work_dir")
        os.makedirs(work_dir, exist_ok=True)
        self.work_dir = work_dir
        with open(os.path.join(work_dir, "args.json"), "w") as f:
            json.dump({k: v for k, v in vars(args).items()
                       if not k.startswith("_")}, f, indent=2, default=str)
        self._log_path = os.path.join(work_dir, "log.jsonl")

    def print(self, s: str, **kwargs) -> None:
        print(f"===== {s}", flush=True, **kwargs)

    def log(self, logs_dict: dict) -> None:
        line = json.dumps(logs_dict)
        self.print(line)
        with open(self._log_path, "a") as f:
            f.write(line + "\n")

    def log_image(self, image, path: str, name: str, idx: int,
                  logs_dict: dict) -> None:
        """image: [1, H, W, C] float in [0,1]."""
        img = np.asarray(image)[0]
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        os.makedirs(path, exist_ok=True)
        write_png(os.path.join(path, f"{name}_{idx}.png"), img)


class WandbLogger(BaseLogger):
    def __init__(self, args: Any, wandb_module=None):
        if wandb_module is None:
            try:
                import wandb as wandb_module  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "wandb is not installed in this environment; "
                    "run without --use_wandb") from e
        self.wandb = wandb_module
        self.wandb.init(project=args.exp_name)
        args.wandb_name = self.wandb.run.name
        args.work_dir = os.path.join(args.work_dir, args.wandb_name)
        super().__init__(args)
        self.wandb.log(vars(args))

    def log(self, logs_dict: dict) -> None:
        super().log(logs_dict)
        self.wandb.log(logs_dict)

    def log_image(self, image, path: str, name: str, idx: int,
                  logs_dict: dict, upload: bool = False) -> None:
        super().log_image(image, path, name, idx, logs_dict)
        if upload:
            img = (np.clip(np.asarray(image)[0], 0, 1) * 255).astype(np.uint8)
            self.wandb.log({
                f"image/{name}": self.wandb.Image(
                    img, caption=os.path.basename(path)),
                **logs_dict})
