"""Multi-level guided softmax filter (kernel K2) and its plain version.

Counterpart of rt_octree_tpu/ops/filtering.py; the reference kernel is
denoiser/extension/filtering.cu:108-228.  Per level l with support s
(window 2s+1) every pixel takes the softmax-weighted average of the noisy
rgb over its window, with logits from each neighbour's guidance value
stabilised by the window max; levels are blended by ``weight_map``.  A
support-0 level is an exact passthrough of the pixel, and alpha is 1.

Kernel K2 (csrc/filter.cu) takes the GuidanceNet's last activation
``x [1, 2L, H, W]`` (bf16, any strides) and splits it itself: the level
weights are ``softmax(x[:, :L])`` and the guidance is ``x[:, L:]``, both in
f32.  ``guided_filter`` dispatches on the device: ``guided_filter_act_plain``
(that split, then ``guided_filter_plain``, the exact path of the JAX
module) for CPU tensors, the kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..native import build as native

MAX_LEVELS = 8  # csrc/filter.cu:kMaxLevels
MAX_SUPPORT = 8  # csrc/filter.cu:kMaxSupport (the ladder 1..L at L = 8)


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


def split_activation(act: torch.Tensor):
    """The net's last activation [1, 2L, H, W] -> (weight, guidance)
    [L, H, W] f32: the softmax over the first L channels and the last L
    channels (GuidanceNetCompact.forward's split)."""
    L = act.shape[1] // 2
    x = act.float()
    return torch.softmax(x[:, :L], 1)[0], x[0, L:]


def guided_filter_act_plain(act: torch.Tensor, img_in: torch.Tensor,
                            supports=None) -> torch.Tensor:
    """Plain version of kernel K2: ``split_activation`` then
    ``guided_filter_plain``."""
    weight, guidance = split_activation(act)
    return guided_filter_plain(weight, guidance, img_in, supports)


def guided_filter(act: torch.Tensor, img_in: torch.Tensor,
                  supports=None) -> torch.Tensor:
    """Kernel K2 wrapper: the net's last activation ``act`` [1, 2L, H, W]
    and the noisy image ``img_in`` [H, W, 4] -> [H, W, 4] with alpha 1.
    CPU tensors take ``guided_filter_act_plain``; on a CUDA device ``act``
    is bf16 in any strides (read in place) and ``img_in`` contiguous f32."""
    if img_in.device.type == "cpu":
        return guided_filter_act_plain(act, img_in, supports)
    if act.dim() != 4 or act.shape[0] != 1 or act.shape[1] % 2:
        raise ValueError(f"guided_filter: act must be [1, 2L, H, W], got "
                         f"{tuple(act.shape)}")
    L, H, W = act.shape[1] // 2, act.shape[2], act.shape[3]
    supports = resolve_supports(L, supports)
    if (act.device.type != "cuda" or act.device != img_in.device
            or act.dtype != torch.bfloat16):
        raise ValueError(f"guided_filter: act must be a bf16 CUDA tensor on "
                         f"{img_in.device}, got {act.dtype} on {act.device}")
    if (img_in.device.type != "cuda" or img_in.dtype != torch.float32
            or tuple(img_in.shape) != (H, W, 4)
            or not img_in.is_contiguous()):
        raise ValueError(f"guided_filter: img_in must be a contiguous f32 "
                         f"CUDA tensor of shape {(H, W, 4)}, got "
                         f"{img_in.dtype} {tuple(img_in.shape)} on "
                         f"{img_in.device}")
    if not 1 <= L <= MAX_LEVELS or max(supports) > MAX_SUPPORT:
        raise ValueError(f"guided_filter: the kernel takes 1..{MAX_LEVELS} "
                         f"levels of support <= {MAX_SUPPORT}, got "
                         f"{supports}")
    out = torch.empty((H, W, 4), dtype=torch.float32, device=img_in.device)
    sup = (ctypes.c_int * L)(*supports)
    _, sc, sh, sw = act.stride()
    fn = native.entry("rt_guided_filter")
    with torch.cuda.device(img_in.device):
        rc = fn(act.data_ptr(), sc, sh, sw, img_in.data_ptr(),
                out.data_ptr(), L, ctypes.cast(sup, ctypes.c_void_p), H, W,
                native.stream_ptr(img_in.device))
        native.count_launch("guided_filter")
    native.check(rc, "guided_filter_kernel")
    return out
