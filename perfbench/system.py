"""The system under test: the port's ``Renderer`` on one card, driven as a
viewer drives it.

Set-up loads the extensions from the port's build directory, reads the
tree npz through the port's load path and uploads it (K3 builds the jump
table and skip distances), attaches the denoiser and warms up on the
cell's own frames.  The window is a closed loop of one viewer: before
frame i is submitted the host waits for frame i - ``in_flight`` to finish;
a frame is one ``Renderer.render(pose, want_aux=False)`` and one
``advance_rng()``, and ends at the image on the device.  An event is
recorded after each frame.  A sample of the window's images, drawn from
the seed, is kept (the references the program returned; no copy).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional

import numpy as np
import torch

from rt_octree_tpu_torch.core.options import RenderOptions
from rt_octree_tpu_torch.io import n3tree
from rt_octree_tpu_torch.native import build as native
from rt_octree_tpu_torch.ops.traversal import upload_tree
from rt_octree_tpu_torch.render.renderer import Renderer

# the port's kernel libraries a frame can use
LIBRARIES = ("render", "upsample", "filter", "lut", "net")


class Clock:
    """Stamps on the device's timeline: CUDA events on a card; on the CPU
    (the harness's own tests) the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def stamp(self):
        if self.cuda:
            return torch.cuda.Event(enable_timing=True)
        return [0.0]

    def record(self, s) -> None:
        if self.cuda:
            s.record()
        else:
            s[0] = time.perf_counter()

    def wait(self, s) -> None:
        if self.cuda:
            s.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b[0] - a[0]) * 1e3


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Keep:
    """A uniform sample of ``k`` window frames (reservoir sampling from
    the seed): {window index: image}."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items = {}

    def offer(self, i: int, img) -> None:
        if i < self.k:
            self.items[i] = img
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            del self.items[sorted(self.items)[j]]
            self.items[i] = img


def options(cfg: dict, mix: dict) -> RenderOptions:
    return RenderOptions(
        spp=int(mix["spp"]), denoise=bool(mix["denoise"]),
        estimator=mix["estimator"], step_size=float(cfg["step_size"]),
        sigma_thresh=float(cfg["sigma_thresh"]),
        stop_thresh=float(cfg["stop_thresh"]),
        background_brightness=float(cfg["background"]))


def build_libraries() -> None:
    """Compile what is not built yet (only a checkout's first run)."""
    native.build(list(LIBRARIES))


def load(npz: str, cfg: dict, device: torch.device):
    """(device tree, load seconds): the npz read and the upload with K3,
    between two synchronizations."""
    sync(device)
    t0 = time.perf_counter()
    host = n3tree.load(npz)
    dt = upload_tree(host, lut_levels=int(cfg["lut_levels"]), device=device,
                     skip_cap=int(cfg["skip_cap"]))
    sync(device)
    return dt, time.perf_counter() - t0


def renderer(dt, cfg: dict, mix: dict, net, pcg32_offset: int) -> Renderer:
    r = Renderer(dt, int(cfg["width"]), int(cfg["height"]), float(cfg["fx"]),
                 float(cfg["fy"]), options=options(cfg, mix),
                 max_steps=int(mix["max_steps"]),
                 render_scale=float(mix["render_scale"]))
    if net is not None:
        r.set_denoiser(net)
    r.rng.advance(pcg32_offset << 32)
    return r


def frames(r: Renderer, orbit, first: int, count: int, device) -> float:
    """``count`` frames from frame ``first``, then a synchronization;
    returns the host seconds a frame took."""
    sync(device)
    t0 = time.perf_counter()
    for n in range(first, first + count):
        r.render(orbit.pose(n), want_aux=False)
        r.advance_rng()
    sync(device)
    return (time.perf_counter() - t0) / max(count, 1)


def stamps(clock: Clock, n: int, device) -> list:
    """``n`` timing stamps, each recorded once so that the window's
    records create nothing."""
    pool = [clock.stamp() for _ in range(n)]
    for s in pool:
        clock.record(s)
    sync(device)
    return pool


@dataclasses.dataclass
class Window:
    frames: int
    frame_ms: float  # elapsed(window start, last frame's stamp) / frames
    intervals_ms: np.ndarray  # [frames]: start -> frame 0, then frame to frame
    kept: dict  # window index -> the frame's image
    host: Optional[np.ndarray]  # traced: [frames, 4] perf_counter stamps
    start_host: float  # perf_counter when the window's start was recorded


def window(r: Renderer, orbit, first: int, seconds: float, in_flight: int,
           keep: Keep, clock: Clock, pool: list, device,
           traced: bool = False) -> Window:
    """Frames from frame ``first`` until ``seconds`` of the host's clock
    have passed.  ``traced`` also stamps each frame on the host: before
    the wait for frame i - in_flight, before ``render``, after it and
    after ``advance_rng``."""
    render, advance, pose = r.render, r.advance_rng, orbit.pose
    rec = [] if traced else None
    start = clock.stamp()
    t_start = time.perf_counter()
    clock.record(start)
    t_end = t_start + seconds
    i = 0
    while True:
        a = time.perf_counter()
        if i >= in_flight:
            clock.wait(pool[i - in_flight])
        b = time.perf_counter()
        if b >= t_end:
            break
        img = render(pose(first + i), want_aux=False)[0]
        c = time.perf_counter()
        advance()
        if i == len(pool):
            pool.append(clock.stamp())
        clock.record(pool[i])
        keep.offer(i, img)
        if traced:
            rec.append((a, b, c, time.perf_counter()))
        i += 1
    sync(device)
    if i == 0:
        raise RuntimeError("the window completed no frame")
    iv = np.empty(i)
    iv[0] = clock.ms(start, pool[0])
    for j in range(1, i):
        iv[j] = clock.ms(pool[j - 1], pool[j])
    return Window(frames=i, frame_ms=clock.ms(start, pool[i - 1]) / i,
                  intervals_ms=iv, kept=dict(keep.items),
                  host=np.asarray(rec) if traced else None,
                  start_host=t_start)
