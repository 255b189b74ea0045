"""LPIPS (AlexNet backbone) in torch, loading weights from a local .npz
(rt_octree_tpu/train/lpips.py twin).

The reference uses the `lpips` pip package with downloaded pretrained
weights (denoiser/metrics.py:81-89).  Nothing is downloaded here, so the
metric activates only when a weights file is present.

Expected .npz keys (all float32), the JAX package's contract:
  conv{0..4}_w  HWIO kernels of the 5 AlexNet feature convs
                (11x11x3x64, 5x5x64x192, 3x3x192x384, 3x3x384x256,
                 3x3x256x256)
  conv{0..4}_b  biases
  lin{0..4}     per-channel calibration weights (64, 192, 384, 256, 256)

tools/convert_lpips.py writes it from the torchvision/lpips checkpoints on
machines that have them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_STRIDES = (4, 1, 1, 1, 1)
_PADS = (2, 2, 1, 1, 1)
_POOL_AFTER = (True, True, False, False, False)


class LPIPS:
    def __init__(self, weights_path: str, device="cpu"):
        w = np.load(weights_path)
        self.params = {}
        for k in w.files:
            v = torch.from_numpy(np.asarray(w[k], np.float32))
            if k.endswith("_w"):  # HWIO -> OIHW
                v = v.permute(3, 2, 0, 1).contiguous()
            self.params[k] = v.to(device)
        self.device = torch.device(device)

    def _features(self, x: torch.Tensor) -> list:
        feats = []
        for i in range(5):
            x = F.relu(F.conv2d(x, self.params[f"conv{i}_w"],
                                self.params[f"conv{i}_b"],
                                stride=_STRIDES[i], padding=_PADS[i]))
            feats.append(x)
            if _POOL_AFTER[i]:
                x = F.max_pool2d(x, 3, stride=2)
        return feats

    @torch.no_grad()
    def __call__(self, preds, truths) -> torch.Tensor:
        """preds/truths [B, H, W, 3] in [0, 1] -> the mean distance."""
        shift = torch.from_numpy(_SHIFT).to(self.device)[None, :, None, None]
        scale = torch.from_numpy(_SCALE).to(self.device)[None, :, None, None]

        def prep(img):
            x = img if isinstance(img, torch.Tensor) else \
                torch.from_numpy(np.asarray(img))
            x = x.to(self.device, torch.float32)
            x = x[..., :3].permute(0, 3, 1, 2)
            return ((2.0 * x - 1.0) - shift) / scale

        total = 0.0
        for i, (xa, xb) in enumerate(zip(self._features(prep(preds)),
                                         self._features(prep(truths)))):
            na = xa / (torch.linalg.vector_norm(xa, dim=1, keepdim=True)
                       + 1e-10)
            nb = xb / (torch.linalg.vector_norm(xb, dim=1, keepdim=True)
                       + 1e-10)
            d = (na - nb) ** 2
            lin = self.params[f"lin{i}"][None, :, None, None]
            total = total + torch.mean(torch.sum(d * lin, dim=1))
        return total
