"""Denoiser training datasets: renderer aux dumps + ground-truth images
(the port's copy of rt_octree_tpu/train/dataset.py, with io/png.read_png
where the JAX package uses imageio).

Reference: denoiser/dataset.py.  Consumes the `buf_<name>.bin` float32
[8,H,W] aux buffers written by the headless renderer (`--write_buffer`,
main_headless.cpp:512-523) paired with dataset GT PNGs; training images
are sliced into nx x ny chunks with a >=20% non-empty validity filter.

Data lives in host numpy; ``device_split`` stacks a split on a torch
device once (preload), or batches are copied on demand.  An epoch is a
seeded permutation, ``np.random.default_rng(seed=epoch).shuffle`` as in
the JAX package -- the semantics of a torch DataLoader with shuffle=True,
num_workers=0.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, List, Optional

import numpy as np

from ..io.png import read_png


def _imread(path: str) -> np.ndarray:
    return read_png(path)


@dataclasses.dataclass
class SplitData:
    aux: List[np.ndarray]  # each [C, h, w] float32
    img_in: List[np.ndarray]  # each [h, w, 4] float32
    img_gt: List[np.ndarray]  # each [h, w, 3/4] float32


def preprocess(aux_buffer: np.ndarray, img_gt: np.ndarray):
    """uint8 GT -> float, white-background compositing, img_in from the
    first 4 aux channels (dataset.py:71-86)."""
    img_gt = img_gt.astype(np.float32) / 255.0
    img_in = np.ascontiguousarray(
        aux_buffer[:4].transpose(1, 2, 0))  # [H, W, 4]
    if img_gt.shape[-1] == 4:
        alpha = img_gt[..., -1:]
        img_gt = img_gt.copy()
        img_gt[..., :3] = img_gt[..., :3] * alpha + 1.0 * (1.0 - alpha)
    return aux_buffer, img_in, img_gt


def valid_chunk(img_gt_chunk: np.ndarray, has_alpha: bool,
                tolerance: float = 0.8) -> bool:
    """>= 20% non-empty pixels (dataset.py:96-105)."""
    if has_alpha:
        alpha = img_gt_chunk[..., -1]
        pct = np.sum(alpha == 0) / alpha.size
    else:
        rgb = img_gt_chunk[..., :3]
        pct = np.sum(rgb == 1.0) / rgb.size
    return pct < tolerance


def slice_imgs(nx: int, ny: int, aux, img_in, img_gt):
    """nx x ny spatial slicing with validity filter (dataset.py:88-124)."""
    H, W = aux.shape[1], aux.shape[2]
    dh, dw = H // ny, W // nx
    has_alpha = img_gt.shape[-1] == 4
    outs = ([], [], [])
    for h in range(0, H, dh):
        for w in range(0, W, dw):
            gt_c = img_gt[h:h + dh, w:w + dw]
            if not valid_chunk(gt_c, has_alpha):
                continue
            outs[0].append(aux[..., h:h + dh, w:w + dw])
            outs[1].append(img_in[h:h + dh, w:w + dw])
            outs[2].append(gt_c)
    return outs


@dataclasses.dataclass
class DatasetConfig:
    data_dir: str
    dataset_type: str = "blender"  # blender | tt | llff
    spp: int = 6
    nx: int = 10
    ny: int = 10
    in_channels: int = 8
    task: str = "train"


class DenoiserDataset:
    """Base: loads splits into SplitData; subclasses list (buf, gt) pairs."""

    def __init__(self, cfg: DatasetConfig):
        self.cfg = cfg
        self.splits: dict[str, SplitData] = {}
        for s in ["train", "test"]:
            # the reference skips "val" entirely (dataset.py:147-149)
            if cfg.task == "test" and s != "test":
                continue
            self.splits[s] = self._load_split(s)

    # subclass hook -> list of (buf_path, gt_path, (H, W))
    def pairs(self, split: str) -> List[tuple]:
        raise NotImplementedError

    def _load_split(self, split: str) -> SplitData:
        cfg = self.cfg
        aux_l, in_l, gt_l = [], [], []
        for buf_path, gt_path, (H, W) in self.pairs(split):
            gt = _imread(gt_path)
            # canonical resolutions are (H, W) per dataset class; trust the
            # GT image so scaled renders also load
            H, W = gt.shape[0], gt.shape[1]
            aux = np.fromfile(buf_path, dtype=np.float32).reshape(8, H, W)
            aux, img_in, img_gt = preprocess(aux, gt)
            aux = aux[:cfg.in_channels]
            if split == "train":
                a, i, g = slice_imgs(cfg.nx, cfg.ny, aux, img_in, img_gt)
            else:
                a, i, g = [aux], [img_in], [img_gt]
            aux_l.extend(a)
            in_l.extend(i)
            gt_l.extend(g)
        return SplitData(aux_l, in_l, gt_l)

    def num_batches(self, split: str, batch_size: int) -> int:
        n = len(self.splits[split].aux)
        return -(-n // batch_size)

    def device_split(self, split: str, device):
        """Stack a split into torch tensors on ``device`` (preload=true):
        one copy per run instead of one per step.  Train slices are
        uniform [C,h,w] so they stack."""
        import torch
        if not hasattr(self, "_device_cache"):
            self._device_cache = {}
        key = (split, str(device))
        if key not in self._device_cache:
            data = self.splits[split]
            self._device_cache[key] = tuple(
                torch.from_numpy(np.stack(arrs)).to(device)
                for arrs in (data.aux, data.img_in, data.img_gt))
        return self._device_cache[key]

    def iter_batch_indices(self, split: str, batch_size: int,
                           shuffle: bool = False, seed: int = 0):
        """Index batches for the device_split path (same order semantics
        as iter_batches)."""
        n = len(self.splits[split].aux)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, n, batch_size):
            yield order[i:i + batch_size]

    def iter_batches(self, split: str, batch_size: int,
                     shuffle: bool = False,
                     seed: int = 0) -> Iterator[tuple]:
        """Yields (aux [B,C,h,w], img_in [B,h,w,4], img_gt [B,h,w,3/4])."""
        data = self.splits[split]
        n = len(data.aux)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, n, batch_size):
            idx = order[i:i + batch_size]
            yield (np.stack([data.aux[j] for j in idx]),
                   np.stack([data.img_in[j] for j in idx]),
                   np.stack([data.img_gt[j] for j in idx]))


class BlenderDataset(DenoiserDataset):
    """NeRF-Synthetic 800x800 (dataset.py:137-185)."""

    RES = (800, 800)

    def pairs(self, split):
        cfg = self.cfg
        with open(os.path.join(cfg.data_dir,
                               f"transforms_{split}.json")) as f:
            meta = json.load(f)
        out = []
        for frame in meta["frames"]:
            name = os.path.basename(frame["file_path"])
            out.append((
                os.path.join(cfg.data_dir, f"spp_{cfg.spp}", split,
                             f"buf_{name}.bin"),
                os.path.join(cfg.data_dir, split, f"{name}.png"),
                self.RES))
        return out


class TanksAndTemplesDataset(DenoiserDataset):
    """1920x1080; images named 0_* (train) / 1_* (test)
    (dataset.py:187-239)."""

    RES = (1080, 1920)

    def pairs(self, split):
        cfg = self.cfg
        files = sorted(os.listdir(os.path.join(cfg.data_dir, "rgb")))
        prefix = "0_" if split == "train" else "1_"
        out = []
        for fname in files:
            if not fname.startswith(prefix):
                continue
            name = fname.split(".")[0]
            out.append((
                os.path.join(cfg.data_dir, f"spp_{cfg.spp}",
                             f"buf_{name}.bin"),
                os.path.join(cfg.data_dir, "rgb", f"{name}.png"),
                self.RES))
        return out


class LLFFDataset(DenoiserDataset):
    """1008x756 factor-4, llffhold=8 split (dataset.py:242-300)."""

    RES = (756, 1008)
    FACTOR = 4
    LLFFHOLD = 8

    def pairs(self, split):
        cfg = self.cfg
        img_dirname = (f"images_{self.FACTOR}" if self.FACTOR > 1
                       else "images")
        files = sorted(os.listdir(os.path.join(cfg.data_dir, img_dirname)))
        i_test = set(range(0, len(files), self.LLFFHOLD))
        idx = (sorted(i_test) if split == "test"
               else [i for i in range(len(files)) if i not in i_test])
        out = []
        for i in idx:
            name = files[i].split(".")[0]
            out.append((
                os.path.join(cfg.data_dir, f"spp_{cfg.spp}",
                             f"buf_{name}.bin"),
                os.path.join(cfg.data_dir, img_dirname, files[i]),
                self.RES))
        return out


def make_dataset(cfg: DatasetConfig) -> DenoiserDataset:
    cls = {"blender": BlenderDataset, "tt": TanksAndTemplesDataset,
           "llff": LLFFDataset}.get(cfg.dataset_type)
    if cls is None:
        raise NotImplementedError(
            f"Invalid dataset type: {cfg.dataset_type}.")
    return cls(cfg)
