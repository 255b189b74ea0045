"""The compact GuidanceNet's forward as kernel K7 (csrc/net.cu).

Counterpart of rt_octree_tpu/models/guidance_net.py:GuidanceNetCompact
(:117-136): per folded block a 3x3 "SAME" conv in bf16 with f32
accumulation, the output rounded to bf16, the bias added in bf16, relu6.
K7 computes a net of one or two blocks in one launch, from the f32 aux
[B, H, W, cin] (read through its strides and rounded to bf16 as it is
loaded) to the last block's activation [B, H, W, cout] in bf16, channels
last; a deeper net runs as a chain of one-block launches.

``pack_layer`` packs a block's HWIO kernel and bias once into K7's layout:
the implicit GEMM's K index is ``tap * CP + ci`` (tap = 3 ky + kx, the
input channels padded to CP = 8, 16, 32 or 64), padded to a multiple of
16; the output channels are padded to 8, 16, 32 or 64 (n-tiles of 8); the
weights are stored as mma.m16n8k16 B fragments, ``w[ks, nt, lane, j] =
W[ks * 16 + 2 (lane % 4) + (j % 2) + 8 (j // 2), nt * 8 + lane // 4]``,
so that each lane reads its fragment as one 8-byte load.  Padded weights
and biases are 0, so padded output channels are relu6(0) = 0.

``guidance_net`` is K7's wrapper, for CUDA tensors only; its plain
version is ``models.guidance_net.compact_activation_plain``, and
``GuidanceNetCompact.activation`` picks one by the input's device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..native import build as native

MAX_CHANNELS = 64  # csrc/net.cu: CP and the padded output channels <= 64


def padded_channels(c: int) -> int:
    """The smallest of 8, 16, 32, 64 that holds ``c`` channels."""
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"guidance_net: K7 takes 1..{MAX_CHANNELS} channels "
                         f"a block, got {c}")
    p = 8
    while p < c:
        p *= 2
    return p


@dataclasses.dataclass
class PackedLayer:
    """One folded block in K7's layout: ``w`` bf16 [KS, NT, 32, 4] (B
    fragments), ``b`` bf16 [NT * 8]; ``cin`` / ``cout`` the block's own
    channels, ``cp`` the padded input channels."""
    w: torch.Tensor
    b: torch.Tensor
    cin: int
    cout: int
    cp: int

    @property
    def nt(self) -> int:
        return self.b.numel() // 8

    def to(self, device) -> "PackedLayer":
        return dataclasses.replace(self, w=self.w.to(device),
                                   b=self.b.to(device))


def pack_layer(kernel: torch.Tensor, bias: torch.Tensor) -> PackedLayer:
    """A block's f32 kernel [3, 3, cin, cout] (Flax's HWIO) and bias
    [cout] -> its PackedLayer on the kernel's device (module doc)."""
    kernel = torch.as_tensor(kernel, dtype=torch.float32)
    bias = torch.as_tensor(bias, dtype=torch.float32, device=kernel.device)
    if kernel.dim() != 4 or kernel.shape[:2] != (3, 3) or \
            bias.shape != kernel.shape[3:]:
        raise ValueError(f"pack_layer: kernel [3, 3, cin, cout] and bias "
                         f"[cout], got {tuple(kernel.shape)} and "
                         f"{tuple(bias.shape)}")
    cin, cout = kernel.shape[2], kernel.shape[3]
    cp, npad = padded_channels(cin), padded_channels(cout)
    ks = (9 * cp + 15) // 16
    dev = kernel.device
    wk = torch.zeros((ks * 16, npad), dtype=torch.bfloat16, device=dev)
    wk[:9 * cp].view(9, cp, npad)[:, :cin, :cout] = \
        kernel.reshape(9, cin, cout).to(torch.bfloat16)
    lane = torch.arange(32, device=dev)
    j = torch.arange(4, device=dev)
    rows = (torch.arange(ks, device=dev)[:, None, None, None] * 16
            + (lane % 4 * 2)[None, None, :, None]
            + (j % 2 + j // 2 * 8)[None, None, None, :])
    cols = (torch.arange(npad // 8, device=dev)[None, :, None, None] * 8
            + (lane // 4)[None, None, :, None])
    b = torch.zeros(npad, dtype=torch.bfloat16, device=dev)
    b[:cout] = bias.to(torch.bfloat16)
    return PackedLayer(wk[rows, cols].contiguous(), b, cin, cout, cp)


def _launch(x, f32_in, cin, blocks, out, stream):
    """One K7 launch of ``blocks`` (one or two) from x to out."""
    B, H, W = x.shape[:3]
    sb, sh, sw, sc = x.stride() if f32_in else (0, 0, 0, 0)
    first, last = blocks[0], blocks[-1]
    rc = native.entry("rt_guidance_net")(
        x.data_ptr(), sb, sh, sw, sc, int(f32_in), cin, len(blocks),
        first.w.data_ptr(), first.b.data_ptr(), first.cp.bit_length() - 1,
        first.nt, last.w.data_ptr(), last.b.data_ptr(),
        last.cp.bit_length() - 1, last.nt, out.data_ptr(), out.shape[-1],
        out.shape[-1], B, H, W, stream)
    native.count_launch("guidance_net")
    native.check(rc, "guidance_net_kernel")


def guidance_net(aux_nhwc: torch.Tensor, layers) -> torch.Tensor:
    """Kernel K7 wrapper: the f32 aux [B, H, W, cin] on a CUDA device (any
    strides) through the packed blocks ``layers`` -> the last block's
    activation [B, H, W, cout] bf16, contiguous.  One launch for one or two
    blocks, one a block beyond."""
    layers = list(layers)
    if aux_nhwc.device.type != "cuda" or aux_nhwc.dtype != torch.float32 \
            or aux_nhwc.dim() != 4:
        raise ValueError(f"guidance_net: aux must be an f32 CUDA tensor "
                         f"[B, H, W, C], got {aux_nhwc.dtype} "
                         f"{tuple(aux_nhwc.shape)} on {aux_nhwc.device}")
    B, H, W, C = aux_nhwc.shape
    if not layers or C != layers[0].cin or any(
            a.cout != b.cin for a, b in zip(layers, layers[1:])):
        chans = [(layer.cin, layer.cout) for layer in layers]
        raise ValueError(f"guidance_net: blocks {chans} do not chain from "
                         f"{C} input channels")
    if not 1 <= B <= 65535 or H < 1 or W < 1:
        raise ValueError(f"guidance_net: K7 takes a batch of 1..65535 "
                         f"non-empty images, got {tuple(aux_nhwc.shape)}")
    if any(layer.w.device != aux_nhwc.device or
           layer.w.dtype != torch.bfloat16 for layer in layers):
        raise ValueError(f"guidance_net: the packed blocks must be bf16 on "
                         f"{aux_nhwc.device} (GuidanceNetCompact.pack)")
    dev = aux_nhwc.device
    with torch.cuda.device(dev):
        stream = native.stream_ptr(dev)
        if len(layers) <= 2:
            out = torch.empty((B, H, W, layers[-1].cout),
                              dtype=torch.bfloat16, device=dev)
            _launch(aux_nhwc, True, C, layers, out, stream)
            return out
        # the chain: each intermediate keeps its padded channels (0)
        x, f32_in, cin = aux_nhwc, True, C
        for i, layer in enumerate(layers):
            width = layer.cout if i == len(layers) - 1 else layer.nt * 8
            out = torch.empty((B, H, W, width), dtype=torch.bfloat16,
                              device=dev)
            _launch(x, f32_in, cin, [layer], out, stream)
            x, f32_in, cin = out, False, width
        return out
