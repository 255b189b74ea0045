"""GuidanceNet in PyTorch (rt_octree_tpu/models/guidance_net.py twin).

Reference: denoiser/network.py:49-209.  ``GuidanceNet`` is the trainable
model: each RepVGG block sums ``num_branches`` 3x3 convs, as many 1x1
convs and, where cin == cout, the identity, then takes relu6
(guidance_net.py:70-114).  Its parameters are f32 and it computes in bf16
as the Flax model does: every branch output is rounded to bf16, its bias
added in bf16, and the branches are summed one by one in bf16 in Flax's
order, with explicit bf16 tensors (autocast would round elsewhere).  The
branches of one kind run as one convolution over their concatenated
kernels: each output channel is still its own branch's conv, rounded once.
``init_params`` draws Flax's default init (lecun_normal: a truncated
normal in [-2, 2] sigma, sigma = sqrt(1 / fan_in) / 0.8796..., zero
biases) from a ``torch.Generator``; it cannot reproduce JAX's PRNG, so
the tests carry JAX's init across with ``params_from_numpy``.

``compact_params`` folds each block into one 3x3 conv (network.py:123-168)
in NumPy, on the Flax layout, in the JAX package's order, so the fold is
bit-equal to it; ``save_compact`` writes the ``.gnet`` artifact byte for
byte as the JAX package's does.

The inference model is one folded
3x3 conv per RepVGG block with relu6, computed in bf16 like the Flax model
(guidance_net.py:117-136).  ``activation`` returns the last block's output
[B, 2L, H, W] in the compute dtype, which the renderer hands to kernel K2
as it is (ops/filtering.py); ``forward`` casts it to f32 and splits it as
the Flax model does: the first L channels softmaxed into the level
``weight`` map, the last L the raw ``guidance`` logits.

The convs run through ``torch.nn.functional.conv2d`` (cuDNN on the card):
the JAX package leaves them to XLA outside any kernel of its own.  The bias
is added after the conv, in the compute type, where Flax adds it.

``load_compact`` reads the committed ``.gnet`` artifacts (``GNET0001``
header, JSON meta, flax msgpack blob) without flax or msgpack;
``params_from_numpy`` turns the Flax HWIO kernels into torch OIHW, for the
compact and the full net, and ``params_to_numpy`` goes back.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..io.gnet_msgpack import packb, unpackb

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


def _split_forward(x: torch.Tensor, L: int):
    """The last block's output [B, 2L, H, W] -> (weight softmaxed over the
    first L channels, guidance = the last L), both f32."""
    x = x.float()
    return torch.softmax(x[:, :L], dim=1), x[:, L:]


class RepVGGBlock(nn.Module):
    """num_branches x (3x3 conv) + num_branches x (1x1 conv) + identity
    (cin == cout), then relu6 (network.py:49-75)."""

    def __init__(self, cin: int, cout: int, num_branches: int):
        super().__init__()
        self.cin, self.cout = cin, cout
        self.conv3 = nn.ModuleList(nn.Conv2d(cin, cout, 3, padding=1)
                                   for _ in range(num_branches))
        self.conv1 = nn.ModuleList(nn.Conv2d(cin, cout, 1)
                                   for _ in range(num_branches))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, c = x.dtype, self.cout
        ys = []
        for convs, pad in ((self.conv3, 1), (self.conv1, 0)):
            w = torch.cat([m.weight for m in convs]).to(dt)
            b = torch.cat([m.bias for m in convs]).to(dt)
            y = F.conv2d(x, w, padding=pad) + b[None, :, None, None]
            ys += [y[:, i * c:(i + 1) * c] for i in range(len(convs))]
        h = ys[0]
        for y in ys[1:]:
            h = h + y
        if self.cin == self.cout:
            h = h + x
        return F.relu6(h)


class GuidanceNet(nn.Module):
    """The trainable model: aux [B, H, W, 8] -> (weight [B, L, H, W]
    softmaxed over L, guidance [B, L, H, W]), both f32 (network.py:
    104-118)."""

    def __init__(self, config: GuidanceNetConfig,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.blocks = nn.ModuleList(
            RepVGGBlock(cin, cout, config.num_branches)
            for cin, cout in config.layer_channels())

    def forward(self, aux_nhwc: torch.Tensor):
        x = aux_nhwc.permute(0, 3, 1, 2).to(self.dtype)
        for block in self.blocks:
            x = block(x)
        return _split_forward(x, self.config.kernel_levels)


def init_params(cfg: GuidanceNetConfig,
                generator: torch.Generator) -> dict:
    """Flax's default init in the Flax layout (NumPy f32): lecun_normal
    kernels (fan_in = kh * kw * cin) and zero biases."""
    def kernel(kh, cin, cout):
        std = float(np.sqrt(1.0 / (kh * kh * cin)) / .87962566103423978)
        t = torch.empty((kh, kh, cin, cout), dtype=torch.float32)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (t * std).numpy()

    params = {}
    for i, (cin, cout) in enumerate(cfg.layer_channels()):
        block = {}
        for kind, kh in (("conv3", 3), ("conv1", 1)):
            for b in range(cfg.num_branches):
                block[f"{kind}_{b}"] = {"kernel": kernel(kh, cin, cout),
                                        "bias": np.zeros(cout, np.float32)}
        params[f"block_{i}"] = block
    return params


def compact_params(cfg: GuidanceNetConfig, params: dict) -> dict:
    """Fold each RepVGG block's branches into one 3x3 conv (Flax layout,
    HWIO): the 3x3 kernels, the 1x1 kernels embedded at the centre, and
    where cin == cout the identity as kernel[1, 1, o % cin, o] += 1 (the
    channel wrap of network.py:142-146).  NumPy f32 sums in the JAX
    package's order (guidance_net.py:146-170), so bit-equal to it."""
    out = {}
    for i, (cin, cout) in enumerate(cfg.layer_channels()):
        block = params[f"block_{i}"]
        kernel = np.zeros((3, 3, cin, cout), np.float32)
        bias = np.zeros((cout,), np.float32)
        for b in range(cfg.num_branches):
            kernel += np.asarray(block[f"conv3_{b}"]["kernel"], np.float32)
            bias += np.asarray(block[f"conv3_{b}"]["bias"], np.float32)
        for b in range(cfg.num_branches):
            k1 = np.asarray(block[f"conv1_{b}"]["kernel"], np.float32)
            kernel[1, 1] += k1[0, 0]
            bias += np.asarray(block[f"conv1_{b}"]["bias"], np.float32)
        if cin == cout:
            for o in range(cout):
                kernel[1, 1, o % cin, o] += 1.0
        out[f"block_{i}"] = {"kernel": kernel, "bias": bias}
    return out


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

    def activation(self, aux_nhwc: torch.Tensor) -> torch.Tensor:
        """aux [B, H, W, 8] -> the last block's output [B, 2L, H, W] in the
        compute dtype (strides as the convolutions leave them)."""
        x = aux_nhwc.permute(0, 3, 1, 2).to(self.dtype)
        for conv in self.convs:
            x = F.conv2d(x, conv.weight.to(self.dtype), padding=1)
            x = F.relu6(x + conv.bias.to(self.dtype)[None, :, None, None])
        return x

    def forward(self, aux_nhwc: torch.Tensor):
        return _split_forward(self.activation(aux_nhwc),
                              self.config.kernel_levels)


def _conv_names(cfg: GuidanceNetConfig, i: int, compact: bool):
    """(Flax path under block_i, state-dict prefix, kernel size) of each
    conv of block i, in Flax's creation order."""
    if compact:
        return [((), f"convs.{i}", 3)]
    return [((f"{kind}_{b}",), f"blocks.{i}.{kind}.{b}", kh)
            for kind, kh in (("conv3", 3), ("conv1", 1))
            for b in range(cfg.num_branches)]


def params_from_numpy(cfg: GuidanceNetConfig, params: dict) -> dict:
    """Flax params -> a state dict (OIHW kernels): the compact tree
    {block_i: {kernel, bias}} gives GuidanceNetCompact's, the full tree
    {block_i: {conv3_b | conv1_b: {kernel, bias}}} GuidanceNet's."""
    compact = "kernel" in params["block_0"]
    sd = {}
    for i, (cin, cout) in enumerate(cfg.layer_channels()):
        for path, prefix, kh in _conv_names(cfg, i, compact):
            leaf = params[f"block_{i}"]
            for key in path:
                leaf = leaf[key]
            k = np.asarray(leaf["kernel"], np.float32)
            b = np.asarray(leaf["bias"], np.float32)
            if k.shape != (kh, kh, cin, cout) or b.shape != (cout,):
                raise ValueError(
                    f"block_{i}{''.join('/' + p for p in path)}: kernel "
                    f"{k.shape} / bias {b.shape} do not match "
                    f"({kh}x{kh}, {cin} -> {cout})")
            sd[f"{prefix}.weight"] = torch.from_numpy(
                np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
            sd[f"{prefix}.bias"] = torch.from_numpy(b.copy())
    return sd


def params_to_numpy(cfg: GuidanceNetConfig, state_dict: dict) -> dict:
    """The reverse of ``params_from_numpy``: a state dict of GuidanceNet
    (or GuidanceNetCompact) -> the Flax tree of NumPy f32 HWIO kernels and
    biases, in Flax's key order."""
    compact = "convs.0.weight" in state_dict
    out = {}
    for i, _ in enumerate(cfg.layer_channels()):
        block = {}
        for path, prefix, _kh in _conv_names(cfg, i, compact):
            w = state_dict[f"{prefix}.weight"].detach().float().cpu()
            leaf = {"kernel": np.ascontiguousarray(
                        w.numpy().transpose(2, 3, 1, 0)),
                    "bias": state_dict[f"{prefix}.bias"].detach().float()
                    .cpu().numpy().copy()}
            if path:
                block[path[0]] = leaf
            else:
                block = leaf
        out[f"block_{i}"] = block
    return out


def build_compact(cfg: GuidanceNetConfig, params: dict, device,
                  dtype: torch.dtype = torch.bfloat16) -> GuidanceNetCompact:
    """GuidanceNetCompact on ``device`` with Flax-layout ``params``."""
    model = GuidanceNetCompact(cfg, dtype=dtype)
    model.load_state_dict(params_from_numpy(cfg, params))
    return model.to(device).eval()


def save_compact(path: str, cfg: GuidanceNetConfig, folded_params: dict,
                 meta=None) -> None:
    """Write a ``.gnet`` artifact: magic, the JSON header (the JAX
    package's keys in its order; ``meta`` carries per-artifact advice such
    as ``denoise_recommended``) and the folded Flax-layout params as flax's
    msgpack (guidance_net.py:197-224)."""
    hdr = {
        "format": "guidance-net-compact",
        "in_channels": cfg.in_channels,
        "mid_channels": cfg.mid_channels,
        "num_layers": cfg.num_layers,
        "num_branches": cfg.num_branches,
        "kernel_levels": cfg.kernel_levels,
        "identity_level": cfg.identity_level,
        "layout": "NHWC/HWIO",
        "contract": "input [B,8,H,W] f32 -> (weight [B,L,H,W] softmaxed, "
                    "guidance [B,L,H,W]) f32",
    }
    if meta:
        hdr["meta"] = dict(meta)
    header = json.dumps(hdr).encode()
    blob = packb({name: {k: np.ascontiguousarray(v, np.float32)
                         for k, v in block.items()}
                  for name, block in folded_params.items()})
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(blob)


def compact_and_export(cfg: GuidanceNetConfig, params: dict, path: str = "",
                       device="cpu"):
    """Fold the Flax-layout ``params`` and (with ``path``) save them;
    returns (GuidanceNetCompact on ``device``, folded params)
    (guidance_net.py:256-262)."""
    folded = compact_params(cfg, params)
    if path:
        save_compact(path, cfg, folded)
    return build_compact(cfg, folded, device), folded


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
