"""Training / eval / export runner for the GuidanceNet denoiser
(rt_octree_tpu/train/runner.py twin).

Reference: denoiser/runner.py.  Protocol preserved:
  * Adam (b1=0.9, b2=0.999, eps=1e-8) with L2 weight decay 5e-4 added to
    the gradient before the moments (``torch.optim.Adam(weight_decay=...)``,
    which is optax's add_decayed_weights -> scale_by_adam), the lr taken
    per step from the update count n as
    lr * 0.1 ** min((n // steps_per_epoch) / (epochs + 1), 1)
    (runner.py:19-22; the JAX package's _lr_sched, :88-93); a resumed run
    continues the count (the optimizer's own step count);
  * epoch loop; periodic test every ``i_test``; every ``i_save`` a compact
    export ``ts_<epoch:06d>.gnet`` plus a training checkpoint; resume from
    the highest-numbered checkpoint (utils.py:13-28);
  * test runs the *compacted* model at batch 1 (runner.py:126-160): its
    bf16 activation and kernel K2, the renderer's denoise path, and
    reports loss + PSNR/SSIM (+LPIPS when weights are available).

The training step is the full GuidanceNet in bf16 (f32 parameters), the
batched guided filter (kernels K5 forward and K6 backward on the card,
ops/filtering.py), the loss, autograd and Adam.  Checkpoints are the
port's own format, not the JAX package's msgpack: ``checkpoint_<n>.pt``,
a ``torch.save`` of {"epoch": next epoch, "model": the GuidanceNet state
dict, "optimizer": the Adam state dict}.  The inference artifact is the
``.gnet`` compact export, byte-compatible with the JAX package's.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

from ..models.guidance_net import (
    GuidanceNet, GuidanceNetConfig, compact_and_export, init_params,
    params_from_numpy, params_to_numpy)
from ..ops.filtering import guided_filter, guided_filter_batch
from .metrics import LPIPSMetric, PSNRMetric, SSIMMetric, get_loss_fn

CKPT_RE = re.compile(r"^checkpoint_(\d+)\.pt$")


def find_latest_checkpoint(work_dir: str) -> Optional[str]:
    """Highest-numbered checkpoint_<n>.pt (utils.py:13-28)."""
    best, best_n = None, -1
    if os.path.isdir(work_dir):
        for fname in os.listdir(work_dir):
            m = CKPT_RE.match(fname)
            if m and int(m.group(1)) > best_n:
                best_n = int(m.group(1))
                best = os.path.join(work_dir, fname)
    return best


class Runner:
    def __init__(self, args: Any, dataset=None, logger=None):
        self.args = args
        self.dataset = dataset
        self.logger = logger
        self.device = torch.device(getattr(args, "device", "cuda"))
        self.loss_fn = get_loss_fn(args.loss_fn)
        self.net_cfg = GuidanceNetConfig(
            in_channels=args.in_channels, mid_channels=args.mid_channels,
            num_layers=args.num_layers, num_branches=args.num_branches,
            kernel_levels=args.kernel_levels,
            identity_level=bool(getattr(args, "identity_level", False)))
        self.supports = self.net_cfg.supports()
        self.model = GuidanceNet(self.net_cfg).to(self.device)
        # Flax's default init, drawn from a generator seeded 0
        self.set_params(init_params(self.net_cfg,
                                    torch.Generator().manual_seed(0)))
        self.epoch = 0
        if args.task in ("train", "test"):
            self.metrics = [PSNRMetric(), SSIMMetric(), LPIPSMetric()]
        self.optimizer = None
        self._steps_per_epoch = 1

    # ---- parameters ------------------------------------------------------

    def set_params(self, params: dict) -> None:
        """Load Flax-layout params (NumPy) into the model."""
        self.model.load_state_dict(params_from_numpy(self.net_cfg, params))

    def params(self) -> dict:
        """The model's params in the Flax layout (NumPy f32)."""
        return params_to_numpy(self.net_cfg, self.model.state_dict())

    # ---- optimizer -------------------------------------------------------

    def lr_at_epoch(self, epoch: int) -> float:
        e = self.args.epochs
        return self.args.lr * 0.1 ** min((epoch - 1) / (e + 1), 1.0)

    def lr_at_count(self, count: int) -> float:
        """The per-epoch decay as a step schedule: the lr of the update
        that follows ``count`` updates."""
        spe = max(self._steps_per_epoch, 1)
        frac = min((count // spe) / (self.args.epochs + 1), 1.0)
        return self.args.lr * 0.1 ** frac

    def make_optimizer(self) -> torch.optim.Adam:
        return torch.optim.Adam(self.model.parameters(), lr=self.args.lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=5e-4)

    def update_count(self) -> int:
        """Updates made so far: Adam's step count (it survives a resume)."""
        state = self.optimizer.state.get(next(self.model.parameters()), {})
        return int(state.get("step", 0))

    def optimizer_step(self) -> None:
        """One Adam update from the gradients in ``.grad``, at the lr of
        the current update count."""
        lr = self.lr_at_count(self.update_count())
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()

    # ---- the training step -----------------------------------------------

    def loss_of(self, aux, img_in, img_gt) -> torch.Tensor:
        """aux [B, 8, h, w], img_in [B, h, w, 4], img_gt [B, h, w, >=3]."""
        weight, guidance = self.model(aux.permute(0, 2, 3, 1))
        out = guided_filter_batch(weight, guidance, img_in, self.supports)
        return self.loss_fn(out[..., :3], img_gt[..., :3])

    def train_step(self, aux, img_in, img_gt) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_of(aux, img_in, img_gt)
        loss.backward()
        self.optimizer_step()
        return loss.detach()

    # ---- checkpointing ---------------------------------------------------

    def save_checkpoint(self, epoch: int) -> str:
        path = os.path.join(self.args.work_dir,
                            f"checkpoint_{epoch:06d}.pt")
        torch.save({"epoch": epoch + 1, "model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict()}, path)
        return path

    def _read_checkpoint(self, path: str) -> dict:
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(ckpt["model"])
        return ckpt

    def load_checkpoint(self):
        """(first epoch to run, checkpoint path or None)."""
        path = find_latest_checkpoint(self.args.work_dir)
        if path is None:
            return 1, None
        ckpt = self._read_checkpoint(path)
        self.optimizer.load_state_dict(ckpt["optimizer"])
        return int(ckpt["epoch"]), path

    # ---- tasks -----------------------------------------------------------

    def train(self, params: Optional[dict] = None) -> None:
        """``params``: Flax-layout params to start from (default: the
        init made at construction)."""
        args = self.args
        if params is not None:
            self.set_params(params)
        self._steps_per_epoch = self.dataset.num_batches(
            "train", args.batch_size)
        self.optimizer = self.make_optimizer()

        start, ckpt_path = self.load_checkpoint()
        if ckpt_path:
            self.logger.print(f"Load checkpoint from {ckpt_path}")
        else:
            self.logger.print("No checkpoint found")

        for epoch in range(start, args.epochs + 1):
            self.epoch = epoch
            self.train_one_epoch()
            if (epoch > start and epoch < args.epochs and
                    epoch % args.i_test == 0):
                self.logger.print(f"Testing at epoch {epoch}...")
                self.test(load_ckpt=False, save_dirname=f"test_{epoch:06d}")

        self.logger.print("Test after training")
        self.test(load_ckpt=False)

    def _train_batches(self):
        """The epoch's batches on the device, in the order of the epoch's
        seed."""
        args, dev = self.args, self.device
        if getattr(args, "preload", False):
            aux_all, in_all, gt_all = self.dataset.device_split("train", dev)
            for idx in self.dataset.iter_batch_indices(
                    "train", args.batch_size, shuffle=True, seed=self.epoch):
                i = torch.from_numpy(idx).to(dev)
                yield aux_all[i], in_all[i], gt_all[i]
        else:
            for batch in self.dataset.iter_batches(
                    "train", args.batch_size, shuffle=True, seed=self.epoch):
                yield tuple(torch.from_numpy(a).to(dev) for a in batch)

    def train_one_epoch(self) -> None:
        args = self.args
        self.model.train()
        # the loss sums on the device; one read per epoch
        loss_sum, n = torch.zeros((), device=self.device), 0
        for aux, img_in, img_gt in self._train_batches():
            loss_sum += self.train_step(aux, img_in, img_gt)
            n += 1
        avg_loss = float(loss_sum) if n else 0.0

        if self.epoch % args.i_print == 0:
            self.logger.log({
                "epoch": self.epoch,
                "train/loss": avg_loss / max(n, 1),
                "train/lr": self.lr_at_epoch(self.epoch),
            })

        if self.epoch % args.i_save == 0:
            self.compact(filename=f"ts_{self.epoch:06d}.gnet")
            path = self.save_checkpoint(self.epoch)
            self.logger.print(f"Save checkpoint at {path}")

    def test(self, load_ckpt: bool = True, save_dirname: str = "test"):
        if load_ckpt:
            path = find_latest_checkpoint(self.args.work_dir)
            if path is None:
                self.logger.print("No checkpoint found.")
                return
            self.logger.print(f"Load checkpoint from {path}")
            self._read_checkpoint(path)
        self.test_one_epoch(save_dirname)

    @torch.inference_mode()
    def test_one_epoch(self, save_dirname: str) -> None:
        args, dev = self.args, self.device
        save_dir = os.path.join(args.work_dir, save_dirname)
        compact_model, _ = self.compact(filename="")

        for m in self.metrics:
            m.reset()
        avg_loss, n = 0.0, 0
        for idx, (aux, img_in, img_gt) in enumerate(self.dataset.iter_batches(
                "test", 1)):
            aux_t = torch.from_numpy(aux).to(dev)
            gt = torch.from_numpy(img_gt[..., :3]).to(dev)
            # K7 on the card (reads the permuted aux through its strides)
            act = compact_model.activation(aux_t.permute(0, 2, 3, 1))
            out = guided_filter(act, torch.from_numpy(img_in[0]).to(dev),
                                self.supports)[None]
            avg_loss += float(self.loss_fn(out[..., :3], gt))
            n += 1
            for m in self.metrics:
                if m.available():
                    m.measure(out[..., :3], gt)
            if args.save_image:
                self.logger.log_image(out.cpu().numpy(), save_dir, "r", idx,
                                      {"epoch": self.epoch})

        logs = {"epoch": self.epoch, "test/loss": avg_loss / max(n, 1)}
        for m in self.metrics:
            if m.available():
                logs[f"test/{m.name()}"] = m.result()
            else:
                logs[f"test/{m.name()}"] = "unavailable (no local weights)"
        self.logger.log(logs)

    def compact(self, load_ckpt: bool = False,
                filename: str = "ts_latest.gnet"):
        """Fold to the single-conv inference model and export .gnet
        (runner.py:162-175); with ``load_ckpt`` from the latest checkpoint
        (the init when there is none).  Returns (GuidanceNetCompact on the
        device, folded Flax-layout params)."""
        args = self.args
        if load_ckpt:
            path = find_latest_checkpoint(args.work_dir)
            if path is not None:
                self.logger.print(f"Load checkpoint from {path}")
                self._read_checkpoint(path)
        out_path = (os.path.join(args.work_dir, filename) if filename else "")
        return compact_and_export(self.net_cfg, self.params(), out_path,
                                  device=self.device)


def seed_everything(seed: int) -> None:
    """np/python/torch seeding (utils.py:6-11)."""
    import random
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
