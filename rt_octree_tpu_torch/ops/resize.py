"""Fast mode's two resizes: the bilinear joint upsample (kernel K4) and the
nearest downsample of a mesh pass, with their plain versions.

Counterpart of the fast-mode branch of rt_octree_tpu/render/renderer.py
(_render_frame_impl, :1283-1305; the split-phase _fast_upsample_jit,
:1509-1517), which calls ``jax.image.resize``.

Bilinear (JAX's "bilinear" when upsampling; its antialias widens the
kernel only when shrinking): output pixel i samples the source coordinate
``(i + 0.5) * in / out - 0.5``, rounded to f32 once (XLA computes it with
a fused multiply-add; rounding the product first moves it by up to an
ulp of the coordinate, 1.4e-5 in the image at 320 -> 800), with the two
taps clamped at the edge and f32 lerps.  ``upsample_bilinear_plain``
writes that rule out, in the kernel's order of operations, instead of
calling ``F.interpolate``.

Nearest: ``jax.image.resize(..., "nearest")`` picks source index
``floor((i + 0.5) * in / out)`` in f32.  Torch's ``"nearest"`` floors
``i * in / out`` and picks other pixels; ``nearest_indices`` reproduces
JAX's rule exactly, rounding as XLA does (ROADMAP trap C.1).

``fast_upsample`` is the K4 wrapper: K1's inner-size ``aux_nhwc`` in, the
full-size image and aux out.  The squares in the aux are taken after the
upsample, as ``aux_from_composite`` takes them from the upsampled
composited rows; they are never the upsampled squares.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..native import build as native

F32 = torch.float32


def _src_taps(n_in: int, n_out: int, device):
    """Per output index: the two clamped source taps and the weight of the
    second, from ``(i + 0.5) * step - 0.5`` with step = f32(in / out),
    rounded to f32 once, as one fused multiply-add rounds it (XLA fuses
    it; the kernel calls fmaf).  In float64 the product and the difference
    are exact, so the one cast to f32 is that rounding."""
    step = float(np.float32(n_in) / np.float32(n_out))
    s = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5)
         * step - 0.5).to(F32)
    f = torch.floor(s)
    i0 = f.to(torch.int64)
    return (i0.clamp(0, n_in - 1), (i0 + 1).clamp(0, n_in - 1), s - f)


def upsample_bilinear_plain(x: torch.Tensor, height: int,
                            width: int) -> torch.Tensor:
    """x [h, w, C] f32 -> [height, width, C]: lerp along x on the two
    source rows, then along y, each as ``(1 - w) * a + w * b``."""
    h, w = x.shape[:2]
    y0, y1, wy = _src_taps(h, height, x.device)
    x0, x1, wx = _src_taps(w, width, x.device)
    wx = wx[None, :, None]
    wy = wy[:, None, None]
    r0, r1 = x[y0], x[y1]
    top = (1.0 - wx) * r0[:, x0] + wx * r0[:, x1]
    bot = (1.0 - wx) * r1[:, x0] + wx * r1[:, x1]
    return (1.0 - wy) * top + wy * bot


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """The source index of each output index under
    ``jax.image.resize(..., "nearest")``: floor((i + 0.5) * in / out) as
    XLA evaluates it in f32, its constants folded into one factor
    f32(in * f32(1 / out)).  (Rounding each step as written instead picks
    other pixels, e.g. 160 of 800 from 320 source pixels.)"""
    f = np.float32
    factor = f(n_in) * (f(1) / f(n_out))
    return np.floor((np.arange(n_out, dtype=f) + f(0.5)) * factor).astype(
        np.int64)


def downsample_nearest(x: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
    """x [h, w, ...] -> [height, width, ...] by ``nearest_indices``."""
    h, w = x.shape[:2]
    yi = torch.from_numpy(nearest_indices(h, height)).to(x.device)
    xi = torch.from_numpy(nearest_indices(w, width)).to(x.device)
    return x[yi][:, xi]


def fast_upsample_plain(aux_nhwc: torch.Tensor, height: int, width: int,
                        want_aux: bool = True):
    """Plain version of kernel K4: (img [H, W, 4], aux_nhwc [H, W, 8],
    aux_chw [8, H, W] or None) from the inner aux [h, w, 8]."""
    v = upsample_bilinear_plain(aux_nhwc[..., :4], height, width)
    img = torch.cat([v[..., :3], torch.ones_like(v[..., 3:])], dim=-1)
    aux = torch.cat([v, v * v], dim=-1)
    aux_chw = aux.permute(2, 0, 1).contiguous() if want_aux else None
    return img, aux, aux_chw


def fast_upsample(aux_nhwc: torch.Tensor, height: int, width: int,
                  want_aux: bool = True):
    """Kernel K4 wrapper: the inner frame's aux [h, w, 8] (rgba, rgba^2,
    as K1 writes it) -> (img [H, W, 4] with alpha 1, aux_nhwc [H, W, 8],
    aux_chw [8, H, W] or None), bilinear on the rgba.  CPU tensors take
    ``fast_upsample_plain``; on a CUDA device the kernel runs."""
    if aux_nhwc.device.type == "cpu":
        return fast_upsample_plain(aux_nhwc, height, width, want_aux)
    if (aux_nhwc.device.type != "cuda" or aux_nhwc.dtype != F32
            or aux_nhwc.dim() != 3 or aux_nhwc.shape[2] != 8
            or not aux_nhwc.is_contiguous()):
        raise ValueError("fast_upsample: aux_nhwc must be a contiguous f32 "
                         f"CUDA tensor [h, w, 8], got {aux_nhwc.dtype} "
                         f"{tuple(aux_nhwc.shape)} on {aux_nhwc.device}")
    if height < 1 or width < 1:
        raise ValueError(f"fast_upsample: output {width}x{height}")
    h, w = aux_nhwc.shape[:2]
    dev = aux_nhwc.device
    img = torch.empty((height, width, 4), dtype=F32, device=dev)
    aux = torch.empty((height, width, 8), dtype=F32, device=dev)
    aux_chw: Optional[torch.Tensor] = (
        torch.empty((8, height, width), dtype=F32, device=dev)
        if want_aux else None)
    # the source steps in f32, as _src_taps takes them
    sy = float(np.float32(h) / np.float32(height))
    sx = float(np.float32(w) / np.float32(width))
    fn = native.entry("rt_upsample")
    with torch.cuda.device(dev):
        rc = fn(aux_nhwc.data_ptr(), h, w, sy, sx, img.data_ptr(),
                aux.data_ptr(), aux_chw.data_ptr() if want_aux else None,
                height, width, native.stream_ptr(dev))
        native.count_launch("upsample")
    native.check(rc, "upsample_kernel")
    return img, aux, aux_chw

