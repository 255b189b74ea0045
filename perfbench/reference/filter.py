"""The multi-level guided softmax filter and the joint bilinear upsample.

Filter (denoiser/extension/filtering.cu:108-228): the activation's first L
channels, softmaxed over L, weigh the levels; level l of half-width s
replaces each pixel's rgb by the softmax-weighted mean over its
(2s+1)^2 window, the weights exp(g_q - max g) of the neighbours' guidance
g; a level of half-width 0 keeps the pixel.  Alpha comes out 1.

Upsample (fast mode): output pixel i samples the source at
(i + 0.5) * in / out - 0.5, the two taps clamped at the edge, as
jax.image.resize's bilinear rule.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32


def _level(rgb: torch.Tensor, g: torch.Tensor, s: int) -> torch.Tensor:
    H, W = g.shape
    K = 2 * s + 1
    gp = F.pad(g[None], (s, s, s, s), value=float("-inf"))[0]
    gmax = F.max_pool2d(gp[None, None].float(), K, stride=1)[0, 0]
    gmax = gmax.to(g.dtype)
    ip = F.pad(rgb, (0, 0, s, s, s, s))
    num = torch.zeros_like(rgb)
    den = torch.zeros_like(g)
    for dy in range(K):
        for dx in range(K):
            k = torch.exp(gp[dy:dy + H, dx:dx + W] - gmax)
            den = den + k
            num = num + ip[dy:dy + H, dx:dx + W] * k[..., None]
    return num / den[..., None]


def guided_filter(act: torch.Tensor, img: torch.Tensor, supports,
                  low: bool = False) -> torch.Tensor:
    """act [1, 2L, H, W], img [H, W, >=3] -> [H, W, 4] f32, alpha 1;
    ``low`` computes in bfloat16."""
    dtype = torch.bfloat16 if low else F32
    L = act.shape[1] // 2
    x = act[0].to(dtype)
    weight = torch.softmax(x[:L], dim=0)
    guidance = x[L:]
    rgb = img[..., :3].to(dtype)
    out = torch.zeros_like(rgb)
    for lev, s in enumerate(supports):
        f = rgb if s == 0 else _level(rgb, guidance[lev], s)
        out = out + weight[lev][..., None] * f
    out = out.float()
    return torch.cat([out, torch.ones_like(out[..., :1])], dim=-1)


def _taps(n_in: int, n_out: int, device):
    step = float(np.float32(n_in) / np.float32(n_out))
    s = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5)
         * step - 0.5).to(F32)
    f = torch.floor(s)
    i0 = f.to(torch.int64)
    return i0.clamp(0, n_in - 1), (i0 + 1).clamp(0, n_in - 1), s - f


def upsample(aux_nhwc: torch.Tensor, height: int, width: int,
             low: bool = False):
    """The inner frame's aux [h, w, 8] -> (img [H, W, 4] with alpha 1,
    aux [H, W, 8]): the rgba resized, its squares taken after."""
    dtype = torch.bfloat16 if low else F32
    x = aux_nhwc[..., :4].to(dtype)
    y0, y1, wy = _taps(x.shape[0], height, x.device)
    x0, x1, wx = _taps(x.shape[1], width, x.device)
    wx = wx.to(dtype)[None, :, None]
    wy = wy.to(dtype)[:, None, None]
    r0, r1 = x[y0], x[y1]
    top = (1.0 - wx) * r0[:, x0] + wx * r0[:, x1]
    bot = (1.0 - wx) * r1[:, x0] + wx * r1[:, x1]
    v = (1.0 - wy) * top + wy * bot
    img = torch.cat([v[..., :3], torch.ones_like(v[..., 3:])], dim=-1)
    return img.float(), torch.cat([v, v * v], dim=-1).float()
