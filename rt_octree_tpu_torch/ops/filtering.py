"""Multi-level guided softmax filter (kernel K2) and its plain version.

Counterpart of rt_octree_tpu/ops/filtering.py; the reference kernel is
denoiser/extension/filtering.cu:108-228.  Per level l with support s
(window 2s+1) every pixel takes the softmax-weighted average of the noisy
rgb over its window, with logits from each neighbour's guidance value
stabilised by the window max; levels are blended by ``weight_map``.  A
support-0 level is an exact passthrough of the pixel, and alpha is 1.

``guided_filter`` dispatches on the tensors' device: the plain version
(``guided_filter_plain``, the exact path of the JAX module) for CPU
tensors, kernel K2 (csrc/filter.cu) for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..native import build as native

MAX_LEVELS = 8  # csrc/filter.cu:kMaxLevels


def resolve_supports(L: int, supports) -> tuple:
    if supports is None:
        return tuple(range(1, L + 1))
    supports = tuple(int(s) for s in supports)
    if len(supports) != L or any(s < 0 for s in supports):
        raise ValueError(
            f"supports {supports} must list one non-negative support per "
            f"level (L={L})")
    return supports


def _level_exact(rgb: torch.Tensor, g: torch.Tensor, s: int) -> torch.Tensor:
    """One level: [H, W, 3] rgb, [H, W] guidance -> filtered [H, W, 3]
    (filtering.py:_level_exact)."""
    H, W, _ = rgb.shape
    K = 2 * s + 1
    gp = F.pad(g, (s, s, s, s), value=float("-inf"))
    gmax = F.max_pool2d(gp[None, None], K, stride=1)[0, 0]
    ip = F.pad(rgb, (0, 0, s, s, s, s))
    num = torch.zeros_like(rgb)
    den = torch.zeros((H, W), dtype=rgb.dtype, device=rgb.device)
    for dy in range(K):
        for dx in range(K):
            k = torch.exp(gp[dy:dy + H, dx:dx + W] - gmax)
            den = den + k
            num = num + ip[dy:dy + H, dx:dx + W] * k[..., None]
    return num / den[..., None]


def guided_filter_plain(weight_map: torch.Tensor, guidance_map: torch.Tensor,
                        img_in: torch.Tensor, supports=None) -> torch.Tensor:
    """weight_map, guidance_map: [L, H, W]; img_in: [H, W, >=3].
    Returns [H, W, 4] with alpha == 1."""
    L = weight_map.shape[0]
    supports = resolve_supports(L, supports)
    rgb = img_in[..., :3]
    out = torch.zeros_like(rgb)
    for l, s in enumerate(supports):
        f = rgb if s == 0 else _level_exact(rgb, guidance_map[l], s)
        out = out + weight_map[l][..., None] * f
    alpha = torch.ones(out.shape[:-1] + (1,), dtype=out.dtype,
                       device=out.device)
    return torch.cat([out, alpha], dim=-1)


def guided_filter(weight_map: torch.Tensor, guidance_map: torch.Tensor,
                  img_in: torch.Tensor, supports=None) -> torch.Tensor:
    """Kernel K2 wrapper: plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (contiguous f32 [L,H,W], [L,H,W], [H,W,C>=3])."""
    if img_in.device.type == "cpu":
        return guided_filter_plain(weight_map, guidance_map, img_in,
                                   supports)
    L, H, W = weight_map.shape
    supports = resolve_supports(L, supports)
    for name, t, shape in (("weight_map", weight_map, (L, H, W)),
                           ("guidance_map", guidance_map, (L, H, W)),
                           ("img_in", img_in, (H, W, img_in.shape[-1]))):
        if (t.device.type != "cuda" or t.device != img_in.device
                or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"guided_filter: {name} must be a contiguous "
                             f"f32 CUDA tensor of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if img_in.shape[-1] < 3 or not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"guided_filter: need >= 3 channels and 1..."
                         f"{MAX_LEVELS} levels, got {img_in.shape[-1]}, {L}")
    out = torch.empty((H, W, 4), dtype=torch.float32, device=img_in.device)
    sup = (ctypes.c_int * L)(*supports)
    fn = native.entry("rt_guided_filter")
    with torch.cuda.device(img_in.device):
        rc = fn(weight_map.data_ptr(), guidance_map.data_ptr(),
                img_in.data_ptr(), img_in.shape[-1], out.data_ptr(), L,
                ctypes.cast(sup, ctypes.c_void_p), H, W,
                native.stream_ptr(img_in.device))
        native.count_launch("guided_filter")
    native.check(rc, "guided_filter_kernel")
    return out
