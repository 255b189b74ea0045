"""Compact GuidanceNet in PyTorch (rt_octree_tpu/models/guidance_net.py twin).

Reference: denoiser/network.py:123-168.  The inference model is one folded
3x3 conv per RepVGG block with relu6, computed in bf16 like the Flax model
(guidance_net.py:117-136), cast to f32; the first L output channels are
softmaxed into the level ``weight`` map and the last L are the raw
``guidance`` logits.

The convs run through ``torch.nn.functional.conv2d`` (cuDNN on the card):
the JAX package leaves them to XLA outside any kernel of its own.  The bias
is added after the conv, in the compute type, where Flax adds it.

``load_compact`` reads the committed ``.gnet`` artifacts (``GNET0001``
header, JSON meta, flax msgpack blob) without flax or msgpack;
``params_from_numpy`` turns the Flax HWIO kernels into torch OIHW.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..io.gnet_msgpack import unpackb

_MAGIC = b"GNET0001"


@dataclasses.dataclass(frozen=True)
class GuidanceNetConfig:
    in_channels: int = 8
    mid_channels: int = 32
    num_layers: int = 2
    num_branches: int = 5
    kernel_levels: int = 4
    # level supports (0..L-1) instead of (1..L): level 0 is an exact
    # per-pixel passthrough (ops/filtering.py module doc)
    identity_level: bool = False

    def supports(self) -> tuple:
        L = self.kernel_levels
        return tuple(range(0, L)) if self.identity_level else \
            tuple(range(1, L + 1))

    def layer_channels(self) -> list:
        """(cin, cout) per folded block (network.py:95-102)."""
        chans = []
        for i in range(self.num_layers - 1):
            chans.append((self.mid_channels if i > 0 else self.in_channels,
                          self.mid_channels))
        last_in = self.mid_channels if self.num_layers > 1 else \
            self.in_channels
        chans.append((last_in, self.kernel_levels * 2))
        return chans


class GuidanceNetCompact(nn.Module):
    """aux [B, H, W, 8] -> (weight [B, L, H, W] softmaxed over L,
    guidance [B, L, H, W]), both f32."""

    def __init__(self, config: GuidanceNetConfig,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, padding=1)
            for cin, cout in config.layer_channels())

    def forward(self, aux_nhwc: torch.Tensor):
        x = aux_nhwc.permute(0, 3, 1, 2).to(self.dtype)
        for conv in self.convs:
            x = F.conv2d(x, conv.weight.to(self.dtype), padding=1)
            x = F.relu6(x + conv.bias.to(self.dtype)[None, :, None, None])
        x = x.float()
        L = self.config.kernel_levels
        return torch.softmax(x[:, :L], dim=1), x[:, L:]


def params_from_numpy(cfg: GuidanceNetConfig, params: dict) -> dict:
    """Flax compact params {block_i: {kernel HWIO, bias}} -> a state dict of
    GuidanceNetCompact (OIHW kernels)."""
    sd = {}
    for i, (cin, cout) in enumerate(cfg.layer_channels()):
        k = np.asarray(params[f"block_{i}"]["kernel"], np.float32)
        b = np.asarray(params[f"block_{i}"]["bias"], np.float32)
        if k.shape != (3, 3, cin, cout) or b.shape != (cout,):
            raise ValueError(f"block_{i}: kernel {k.shape} / bias {b.shape} "
                             f"do not match ({cin} -> {cout})")
        sd[f"convs.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        sd[f"convs.{i}.bias"] = torch.from_numpy(b.copy())
    return sd


def build_compact(cfg: GuidanceNetConfig, params: dict, device,
                  dtype: torch.dtype = torch.bfloat16) -> GuidanceNetCompact:
    """GuidanceNetCompact on ``device`` with Flax-layout ``params``."""
    model = GuidanceNetCompact(cfg, dtype=dtype)
    model.load_state_dict(params_from_numpy(cfg, params))
    return model.to(device).eval()


def load_compact(path: str, with_meta: bool = False):
    """Returns (cfg, params) with params in the Flax layout as numpy
    arrays, or (cfg, params, meta) when ``with_meta`` (meta = {} if
    absent)."""
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise ValueError(f"{path}: not a .gnet artifact")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode())
        blob = f.read()
    cfg = GuidanceNetConfig(
        in_channels=header["in_channels"],
        mid_channels=header["mid_channels"],
        num_layers=header["num_layers"],
        num_branches=header["num_branches"],
        kernel_levels=header["kernel_levels"],
        identity_level=bool(header.get("identity_level", False)))
    params = unpackb(blob)
    for i, (cin, cout) in enumerate(cfg.layer_channels()):
        block = params.get(f"block_{i}", {})
        if (np.shape(block.get("kernel")) != (3, 3, cin, cout)
                or np.shape(block.get("bias")) != (cout,)):
            raise ValueError(f"{path}: block_{i} does not match the header")
    if with_meta:
        return cfg, params, header.get("meta", {})
    return cfg, params


def load_model(path: str, device, dtype: torch.dtype = torch.bfloat16):
    """(model, meta) from a ``.gnet`` artifact."""
    cfg, params, meta = load_compact(path, with_meta=True)
    return build_compact(cfg, params, device, dtype), meta
