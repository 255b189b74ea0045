"""Evaluate .gnet nets on a quality kit's test split (the counterpart of
tools/eval_gnet_kit.py).

For each test pose of a kit with both a GT PNG and a buffer
(``transforms_test.json``, ``test/<name>.png``,
``spp_6/test/buf_<name>.bin``) it computes the whole-image PSNR, the
object PSNR (pixels whose noisy alpha is > 0) and the SSIM
(train/metrics.ssim) of (a) the noisy frame, the buffer's composited rgba
``aux[:4]``, and (b) each net's output: the compact GuidanceNet on the
buffer (kernel K7 on the card) and the guided filter (kernel K2) at the
net's supports, on that noisy frame.  The buffers already carry the noisy
render, so no march runs.  It prints the JAX tool's lines, one a net:

    noisy: psnr=... psnr_obj=... ssim=...
    NET.gnet: psnr=... psnr_obj=... ssim=...

    python -m rt_octree_tpu_torch.tools.eval_gnet_kit KIT NET.gnet \\
        [NET.gnet ...] [--device cuda]

``main(argv)`` returns the means as {"noisy" or net path: {"psnr",
"psnr_obj", "ssim", "poses"}}.  ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..io.png import read_png
from ..models.guidance_net import load_model
from ..ops.filtering import guided_filter
from ..train.metrics import ssim as ssim_fn
from .make_quality_dataset import SPP


def metrics(pred_rgb: np.ndarray, gt_rgb: np.ndarray, alpha: np.ndarray,
            device) -> tuple:
    """(PSNR, object PSNR, SSIM) of f32 [H, W, 3] frames in [0, 1]; the
    object is where ``alpha`` > 0."""
    se = (pred_rgb - gt_rgb) ** 2
    mask = (alpha > 0.0).astype(np.float32)[..., None]
    mse = float(np.mean(se))
    mse_obj = float(np.sum(se * mask) / max(np.sum(mask) * 3.0, 1.0))
    s = float(ssim_fn(torch.from_numpy(pred_rgb).to(device)[None],
                      torch.from_numpy(gt_rgb).to(device)[None]))
    return (-10.0 * np.log10(max(mse, 1e-12)),
            -10.0 * np.log10(max(mse_obj, 1e-12)), s)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("eval_gnet_kit")
    p.add_argument("kit", help="kit directory")
    p.add_argument("nets", nargs="+", help=".gnet artifacts")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    with open(os.path.join(args.kit, "transforms_test.json")) as f:
        frames = json.load(f)["frames"]

    loaded = []
    for p in args.nets:
        net, meta = load_model(p, dev)
        cfg = net.config
        loaded.append((p, cfg, net))
        print(f"net {p}: identity_level={cfg.identity_level} meta={meta}")

    acc = {"noisy": []}
    for p, *_ in loaded:
        acc[p] = []
    for fr in frames:
        name = os.path.basename(fr["file_path"])
        gt_path = os.path.join(args.kit, "test", f"{name}.png")
        buf_path = os.path.join(args.kit, f"spp_{SPP}", "test",
                                f"buf_{name}.bin")
        if not (os.path.exists(gt_path) and os.path.exists(buf_path)):
            print(f"skip {name} (missing gt or buf)")
            continue
        gt = read_png(gt_path)[..., :3].astype(np.float32) / 255.0
        H, W = gt.shape[:2]
        aux = np.fromfile(buf_path, np.float32).reshape(8, H, W)
        noisy = aux[:4].transpose(1, 2, 0)
        alpha = aux[3]
        acc["noisy"].append(metrics(np.ascontiguousarray(noisy[..., :3]),
                                    gt, alpha, dev))
        aux_t = torch.from_numpy(aux).to(dev)
        noisy_t = aux_t[:4].permute(1, 2, 0).contiguous()
        for p, cfg, net in loaded:
            with torch.inference_mode():
                act = net.activation(aux_t.permute(1, 2, 0)[None])
                out = guided_filter(act, noisy_t, supports=cfg.supports())
            acc[p].append(metrics(out[..., :3].cpu().numpy(), gt, alpha,
                                  dev))
        print(f"[{name}] done", flush=True)

    means = {}
    for k, v in acc.items():
        m = np.mean(np.asarray(v), axis=0)
        print(f"{k}: psnr={m[0]:.3f} psnr_obj={m[1]:.3f} ssim={m[2]:.5f}")
        means[k] = {"psnr": float(m[0]), "psnr_obj": float(m[1]),
                    "ssim": float(m[2]), "poses": len(v)}
    return means


if __name__ == "__main__":
    main()
