"""Losses and quality metrics for denoiser training, in torch
(rt_octree_tpu/train/metrics.py twin).

Reference: denoiser/metrics.py.  SMAPE/MSE/Huber losses; PSNR/SSIM/LPIPS
metric accumulators over [B, H, W, C] float images in [0, 1] (torch
tensors, or numpy arrays, which are taken as CPU tensors).

  * SSIM: pytorch_msssim's defaults (11x11 gaussian window, sigma=1.5,
    K1=0.01, K2=0.03, data_range=1), valid windows, as the JAX package's;
    the separable blur is a depthwise ``F.conv2d`` (the JAX package leaves
    it to XLA outside any kernel).
  * LPIPS: needs pretrained AlexNet features, which are not downloaded
    here.  ``LPIPSMetric`` computes the linear-calibrated deep-feature
    distance when a weights file is supplied (``RT_OCTREE_LPIPS_WEIGHTS``
    env or explicit path, the .npz of train/lpips.py); otherwise it
    reports unavailability instead of a number.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


# ---------------------------------------------------------------------------
# losses (metrics.py:7-33)
# ---------------------------------------------------------------------------

def smape_loss(preds, truths):
    return torch.mean(torch.abs(preds - truths) /
                      (torch.abs(preds) + torch.abs(truths) + 1e-5))


def mse_loss(preds, truths):
    return torch.mean((preds - truths) ** 2)


def huber_loss(preds, truths, delta: float = 1.0):
    err = preds - truths
    abs_err = torch.abs(err)
    quad = torch.clamp(abs_err, max=delta)
    return torch.mean(0.5 * quad ** 2 + delta * (abs_err - quad))


def get_loss_fn(name: str) -> Callable:
    fns = {"smape": smape_loss, "mse": mse_loss, "huber": huber_loss}
    if name in fns:
        return fns[name]
    if name.startswith("lpips"):
        raise NotImplementedError(
            "LPIPS as a *training loss* needs pretrained feature weights; "
            "provide them via LPIPSMetric and use smape/mse/huber to train.")
    raise NotImplementedError(f"Invalid loss function: {name}")


# ---------------------------------------------------------------------------
# PSNR / SSIM
# ---------------------------------------------------------------------------

def psnr(preds, truths) -> float:
    mse = torch.mean((_t(preds) - _t(truths)) ** 2)
    return float(-10.0 * torch.log10(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return torch.from_numpy(g.astype(np.float32))


def ssim(preds, truths, data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM over batch and channels; inputs [B, H, W, C] (valid
    windows of the separable 11x11 gaussian, sigma 1.5)."""
    preds, truths = _t(preds).float(), _t(truths).float()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    C = preds.shape[-1]
    win = _gaussian_window().to(preds.device)
    wy = win.view(1, 1, -1, 1).expand(C, 1, -1, 1)
    wx = win.view(1, 1, 1, -1).expand(C, 1, 1, -1)

    def blur(img):  # [B, H, W, C] -> valid blur, [B, C, h, w]
        x = img.permute(0, 3, 1, 2)
        return F.conv2d(F.conv2d(x, wy, groups=C), wx, groups=C)

    mu_x, mu_y = blur(preds), blur(truths)
    var_x = blur(preds * preds) - mu_x ** 2
    var_y = blur(truths * truths) - mu_y ** 2
    cov = blur(preds * truths) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * cov + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2)
    return torch.mean(num / den)


# ---------------------------------------------------------------------------
# metric accumulators (metrics.py:35-89)
# ---------------------------------------------------------------------------

class Metric:
    def __init__(self):
        self.sum = 0.0
        self.cnt = 0

    def name(self) -> str:
        raise NotImplementedError

    def fn(self, preds, truths) -> float:
        raise NotImplementedError

    def reset(self):
        self.sum = 0.0
        self.cnt = 0

    def available(self) -> bool:
        return True

    def measure(self, preds, truths):
        self.sum += self.fn(preds, truths)
        self.cnt += 1

    def result(self) -> float:
        return self.sum / max(self.cnt, 1)


class PSNRMetric(Metric):
    def name(self):
        return "psnr"

    def fn(self, preds, truths):
        return psnr(preds, truths)


class SSIMMetric(Metric):
    def __init__(self, data_range: float = 1.0):
        super().__init__()
        self.data_range = data_range

    def name(self):
        return "ssim"

    def fn(self, preds, truths):
        return float(ssim(preds, truths, data_range=self.data_range))


class LPIPSMetric(Metric):
    """AlexNet-feature LPIPS when weights are available locally."""

    def __init__(self, weights_path: Optional[str] = None):
        super().__init__()
        self.weights_path = weights_path or os.environ.get(
            "RT_OCTREE_LPIPS_WEIGHTS", "")
        self._net = None
        if self.weights_path and os.path.isfile(self.weights_path):
            from .lpips import LPIPS
            self._net = LPIPS(self.weights_path)

    def name(self):
        return "lpips"

    def available(self):
        return self._net is not None

    def fn(self, preds, truths):
        if self._net is None:
            raise RuntimeError(
                "LPIPS weights unavailable; set RT_OCTREE_LPIPS_WEIGHTS")
        return float(self._net(preds, truths))


def stdfilt(img, kernel_size: int) -> torch.Tensor:
    """Windowed standard deviation (metrics.py:92-97), img [B, H, W, C]:
    the mean and mean square over the SAME-padded window, each divided by
    the window's in-image count."""
    x = _t(img).permute(0, 3, 1, 2)
    lo = (kernel_size - 1) // 2
    pad = (lo, kernel_size - 1 - lo, lo, kernel_size - 1 - lo)
    ones = torch.ones_like(x[:, :1])

    def box(t):
        return F.avg_pool2d(F.pad(t, pad), kernel_size, stride=1,
                            divisor_override=1)

    n = box(ones)
    mean = box(x) / n
    mean_sq = box(x ** 2) / n
    out = torch.sqrt(torch.clamp(mean_sq - mean ** 2, min=0.0))
    return out.permute(0, 2, 3, 1)
