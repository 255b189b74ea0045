"""Whether the timed path's frames are right, and what they needed.

After the window, with the program's state freed, the reference renders
each of the CHECK_FRAMES kept frames (drawn from the seed) again from the same pose and PCG32 frame and the numbers
below are taken over the rgb of the whole image; a run is correct when,
on every frame, each number that the cell's ``limits/<cell>.json`` names
is within its limit and no pixel of the program's is non-finite:

- ``mean_abs``: the mean absolute difference;
- ``p999_abs``: its 99.9th percentile;
- ``max_abs``: its largest value.

Every cell's limits name all three.

The reference march also counts a frame's work for the rooflines
(``perfbench/count``), on the poses ``traffic.counted`` fixes.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import count
from .reference import frame as ref_frame
from .reference import march as ref_march
from .reference import net as ref_net
from .reference import npz as ref_npz

NUMBERS = ("mean_abs", "p999_abs", "max_abs")
CHECK_FRAMES = 3  # window frames checked a run, the same for every mix


def compare(prog: torch.Tensor, ref: torch.Tensor) -> dict:
    """The numbers of one frame, and its non-finite pixels' count."""
    p = prog[..., :3].float()
    nonfinite = int((~torch.isfinite(p)).sum())
    d = (torch.nan_to_num(p, nan=1e30, posinf=1e30, neginf=1e30)
         - ref[..., :3].to(p.device)).abs().flatten()
    k = max(1, math.ceil(0.999 * d.numel()))
    return {"mean_abs": float(d.double().mean()),
            "p999_abs": float(torch.kthvalue(d.cpu(), k).values),
            "max_abs": float(d.max()), "nonfinite": nonfinite}


def spec_of(cfg: dict, mix: dict) -> ref_frame.FrameSpec:
    return ref_frame.FrameSpec(
        width=int(cfg["width"]), height=int(cfg["height"]),
        fx=float(cfg["fx"]), fy=float(cfg["fy"]),
        estimator=mix["estimator"], spp=int(mix["spp"]),
        step_size=float(cfg["step_size"]),
        sigma_thresh=float(cfg["sigma_thresh"]),
        stop_thresh=float(cfg["stop_thresh"]),
        background=float(cfg["background"]),
        max_steps=int(mix["max_steps"]),
        render_scale=float(mix["render_scale"]))


@dataclasses.dataclass
class Reference:
    """The reference's own reading of a cell's scene."""

    tree: ref_march.Tree
    spec: ref_frame.FrameSpec
    header: dict  # the net's, or None without denoising
    blocks: list
    supports: tuple

    @staticmethod
    def load(npz: str, net_path, cfg: dict, mix: dict, device):
        tree = ref_march.to_device(ref_npz.read_tree(npz), device)
        header = blocks = sup = None
        if mix["denoise"]:
            header, blocks = ref_net.read_gnet(net_path)
            sup = ref_net.supports(header)
        return Reference(tree, spec_of(cfg, mix), header, blocks, sup)

    def render(self, pose, frame: int, low: bool = False):
        return ref_frame.render(self.tree, pose, frame, self.spec,
                                self.blocks, self.supports, low)

    def work(self, res: ref_frame.FrameResult) -> dict:
        """Each stage's Work and the frame's, from one reference frame."""
        t, s = self.tree, self.spec
        iw, ih = res.inner
        c = res.counts
        dd = t.data.shape[1]
        out = {("classic" if s.estimator == "classic" else "k1"):
               count.march(iw * ih, c.shaded, c.rays_shaded, c.rows,
                           t.basis_dim, dd)}
        march_w = next(iter(out.values()))
        n = s.width * s.height
        up = count.upsample(n) if (iw, ih) != (s.width, s.height) else None
        net_w = flt_w = None
        weights = 0
        if self.header is not None:
            L = self.header["kernel_levels"]
            chans = [(int(k.shape[1]), int(k.shape[0]))
                     for k, _ in self.blocks]
            net_w = out["k7"] = count.net(chans, n)
            flt_w = out["k2"] = count.guided_filter(L, self.supports, n)
            weights = count.net_weight_bytes(chans)
        if up is not None:
            out["k4"] = up
        out["frame"] = count.frame(march_w, 2 * dd * c.rows, n, net_w,
                                   weights, flt_w, up)
        return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, the judged numbers as {name: [value, limit]})."""
    judged = {k: [numbers[k], float(limits[k])] for k in NUMBERS}
    judged["nonfinite"] = [numbers["nonfinite"], 0]
    ok = all(v <= lim for v, lim in judged.values())
    return ok, judged


def worst(per_frame: list) -> dict:
    """Each number's worst value over the checked frames."""
    return {k: max(f[k] for f in per_frame) for k in per_frame[0]}
