"""One frame of the reference: the march (at the inner size in fast mode),
the joint upsample, the net and the filter, as the frame's settings say."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import filter as flt
from . import march, net, pcg32


@dataclasses.dataclass(frozen=True)
class FrameSpec:
    """What a frame computes (the benchmark fills it from a configuration
    and a traffic mix)."""

    width: int
    height: int
    fx: float
    fy: float
    estimator: str  # "rt" or "classic"
    spp: int
    step_size: float
    sigma_thresh: float
    stop_thresh: float
    background: float
    max_steps: int
    render_scale: float = 1.0

    def inner(self) -> tuple:
        """The march's size (Python's round, half to even)."""
        if self.render_scale >= 1.0:
            return self.width, self.height
        return (max(1, round(self.width * self.render_scale)),
                max(1, round(self.height * self.render_scale)))


@dataclasses.dataclass
class FrameResult:
    img: torch.Tensor  # [H, W, 4] f32, the frame as shown
    counts: march.Counts  # what the march shaded
    inner: tuple  # (width, height) of the march


def render(tree: march.Tree, pose, frame: int, spec: FrameSpec,
           blocks: Optional[list], sup: Optional[tuple],
           low: bool = False, geom: torch.dtype = torch.float32
           ) -> FrameResult:
    """The frame ``frame`` (its PCG32 stream: the per-frame generator after
    that many frames) from camera-to-world ``pose`` [3, 4].  ``blocks``:
    the denoiser's, or None for no denoising.  ``geom``: the dtype of the
    march's rays, positions and optical depths."""
    dev = tree.data.device
    iw, ih = spec.inner()
    tf = torch.as_tensor(pose, dtype=torch.float32).reshape(3, 4).to(dev,
                                                                     geom)
    dirs, cens = march.camera_rays(tf, iw, ih, spec.fx * (iw / spec.width),
                                   spec.fy * (ih / spec.height))
    if spec.estimator == "classic":
        out, counts = march.march_classic(
            tree, dirs, dirs, cens, spec.step_size, spec.sigma_thresh,
            spec.stop_thresh, spec.max_steps, low)
    else:
        state, inc = pcg32.frame_state(frame)
        u = pcg32.uniforms(state, inc, iw * ih * spec.spp, dev)
        dst = pcg32.sorted_thresholds(u.reshape(iw * ih, spec.spp))
        ptr, cnt, counts = march.march_rt(tree, dirs, cens, dst,
                                          spec.step_size, spec.sigma_thresh,
                                          spec.max_steps)
        out = march.shade_rt(tree, dirs, ptr, cnt, low)
    img, aux = march.composite(out, iw, ih, spec.background, low)
    if (iw, ih) != (spec.width, spec.height):
        img, aux = flt.upsample(aux, spec.height, spec.width, low)
    if blocks is not None:
        act = net.forward(aux, blocks, low)
        img = flt.guided_filter(act, img, sup, low)
    return FrameResult(img=img, counts=counts, inner=(iw, ih))
