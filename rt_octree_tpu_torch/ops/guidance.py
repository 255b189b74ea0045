"""The compact GuidanceNet's forward as kernel K7 (csrc/net.cu).

Counterpart of rt_octree_tpu/models/guidance_net.py:GuidanceNetCompact
(:117-136): per folded block a 3x3 "SAME" conv in bf16 with f32
accumulation, the output rounded to bf16, the bias added in bf16, relu6.
K7 computes a net of one or two blocks in one launch, from the f32 aux
[B, H, W, cin] (read through its strides and rounded to bf16 as it is
loaded) to the last block's activation [B, H, W, cout] in bf16, channels
last; a deeper net runs as a chain of one-block launches.

``pack_layer`` packs a block's HWIO kernel and bias once into K7's two
layouts, both mma.m16n8k16 B fragments in the mma's lane order, so that
each lane reads its fragment as one 8-byte load (``j`` the fragment's
element, ``r(lane, j) = 2 (lane % 4) + (j % 2) + 8 (j // 2)`` its row in a
k-step of 16, ``lane // 4`` its column in an n-tile of 8):

- ``w``, block 0's implicit GEMM (K-major): its K index is ``tap * CP +
  ci`` (tap = 3 ky + kx, the input channels padded to CP = 8, 16, 32 or
  64), padded to a multiple of 16; ``w[ks, nt, lane, j] = W[ks * 16 +
  r(lane, j), nt * 8 + lane // 4]``;
- ``wt``, the last block's product with all nine taps (tap-major): K is
  the input channels padded to max(CP, 16), one matrix a tap;
  ``wt[nt, ks, tap, lane, j] = W_tap[ks * 16 + r(lane, j), nt * 8 +
  lane // 4]``.

The output channels are padded to 8, 16, 32 or 64 (n-tiles of 8).  Padded
weights and biases are 0, so padded output channels are relu6(0) = 0.

A net with a block of more than 64 input or output channels (a wide net:
a ``--mid_channels`` above 64, or more than 32 levels) takes K7's wide
instances (launch name ``guidance_net_wide``), which read the tap-major
pack ``wt`` of a wide block, its channels padded to a multiple of 16
(``padded_channels``).  ``net_plan`` chooses on the host:

- ``"fused"``: one or two blocks of at most 64 channels, one launch;
- ``"fused_wide"``: a two-block wide net from at most 8 channels whose
  weights and 64 x 8 tile's intermediate fit 227 KB (``fused_wide_smem``;
  the 8 -> 96 -> 24 net of ``--mid_channels 96 --kernel_levels 12``), one
  launch of the fused wide instance;
- ``"chain"``: any other net, one launch a block (``chain_block``): the
  per-block plan for a wide block, a fused instance's one-block launch for
  the others.  The per-block plan has two instances, both a persistent
  grid over 64 x 8 tiles with the block's B fragments resident: one for
  the first block from the f32 aux (at most ``WIDE_F32_CHANNELS``
  channels, staged by one tensor copy a tile, one m16n8k8 a tap), and a
  ring for a block from the chain's bf16 intermediate (its output n-tiles
  split over neighbouring blocks of the grid, each tile's 16-channel
  k-step slices streamed in by a producer warp's tensor copies); a wider
  f32 input is rounded to bf16 first and takes the ring.  Both sum each
  output as the fused wide instance does (the k-steps in turn, the nine
  taps in order, 16 channels a product), so the two plans agree bit for
  bit.

``guidance_net`` is K7's wrapper, for CUDA tensors only; its plain
version is ``models.guidance_net.compact_activation_plain``, and
``GuidanceNetCompact.activation`` picks one by the input's device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..native import build as native

MAX_CHANNELS = 64  # csrc/net.cu: the fused instances' channels a block
SMEM_MAX = 232448  # csrc/net.cu:kSmemMax, 227 KB a block
# csrc/net.cu: the wide instances' output tile, and the n-tiles a warp of
# the fused wide instance holds in block 0
WIDE_TILE_W, WIDE_TILE_H = 64, 8
WIDE_NB0 = 4
# csrc/net.cu: the per-block plan's first-block instance takes an f32 input
# of at most 8 channels (the aux); a wider f32 input is rounded to bf16 and
# goes through its ring instance
WIDE_F32_CHANNELS = 8


def padded_channels(c: int) -> int:
    """The channels K7 pads ``c`` to: the smallest of 8, 16, 32, 64 that
    holds them, and above 64 (the wide instances) a multiple of 16."""
    if c < 1:
        raise ValueError(f"guidance_net: a block of {c} channels")
    if c > MAX_CHANNELS:
        return -(-c // 16) * 16
    p = 8
    while p < c:
        p *= 2
    return p


def is_wide(layer: "PackedLayer") -> bool:
    """A block that the fused instances do not take (more than 64 input or
    output channels): its net runs on K7's wide instances (``net_plan``)."""
    return layer.cin > MAX_CHANNELS or layer.cout > MAX_CHANNELS


def _wide_nb(nt: int) -> int:
    """csrc/net.cu:wide_nb: the n-tiles the fused wide instance's block 1
    takes at a time."""
    return 2 if nt <= 2 else 3 if nt == 3 else 4


def fused_wide_smem(layers) -> int | None:
    """The shared-memory bytes K7's fused wide instance takes for this net
    (csrc/net.cu:fused_wide_smem), or None when it is not a two-block wide
    net from at most 8 channels: the barrier and the f32 staging of a 68 x
    12 region, block 0's output over the 66 x 10 region (a plane of 16
    bytes a pixel for each 8 of its channels, its n-tiles rounded up to
    groups of WIDE_NB0), and both blocks' B fragments, 9 taps a k-step
    (block 0's one k-step of 8 channels, 128 bytes a fragment; block 1's
    256, its n-tiles rounded up to groups of ``_wide_nb``)."""
    layers = list(layers)
    if len(layers) != 2 or not any(map(is_wide, layers)) or \
            layers[0].cp != 8:
        return None
    npix = (WIDE_TILE_W + 2) * (WIDE_TILE_H + 2)
    plane = -(-npix // 16) * 16 * 16 + 16
    ng0 = -(-layers[0].nt // WIDE_NB0)
    nt1 = -(-layers[1].cout // 8)
    nb1 = _wide_nb(nt1)
    ks1 = layers[1].wt.shape[1]
    return (128 + (WIDE_TILE_H + 4) * (WIDE_TILE_W + 4) * 8 * 4
            + ng0 * WIDE_NB0 * plane + ng0 * 9 * WIDE_NB0 * 128
            + -(-nt1 // nb1) * ks1 * 9 * nb1 * 256)


def net_plan(layers) -> str:
    """How K7 runs the packed blocks (module doc): "fused", "fused_wide"
    or "chain"."""
    layers = list(layers)
    if len(layers) <= 2 and not any(map(is_wide, layers)):
        return "fused"
    smem = fused_wide_smem(layers)
    return "fused_wide" if smem is not None and smem <= SMEM_MAX \
        else "chain"


@dataclasses.dataclass
class PackedLayer:
    """One folded block in K7's layouts (module doc): ``w`` bf16 [KS, NT,
    32, 4] and ``wt`` bf16 [NT, max(CP, 16) / 16, 9, 32, 4] (B fragments),
    ``b`` bf16 [NT * 8]; ``cin`` / ``cout`` the block's own channels, ``cp``
    the padded input channels."""
    w: torch.Tensor
    wt: torch.Tensor
    b: torch.Tensor
    cin: int
    cout: int
    cp: int

    @property
    def nt(self) -> int:
        return self.b.numel() // 8

    def to(self, device) -> "PackedLayer":
        return dataclasses.replace(self, w=self.w.to(device),
                                   wt=self.wt.to(device),
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
    r = (lane % 4 * 2)[:, None] + (j % 2 + j // 2 * 8)[None, :]  # [32, 4]
    col = (lane // 4)[:, None]
    nts = torch.arange(npad // 8, device=dev)
    rows = torch.arange(ks, device=dev)[:, None, None, None] * 16 + r
    cols = nts[None, :, None, None] * 8 + col
    # the last block's taps, K = the channels padded to at least 16
    kst = max(cp, 16) // 16
    wtap = torch.zeros((9, kst * 16, npad), dtype=torch.bfloat16, device=dev)
    wtap[:, :cin, :cout] = kernel.reshape(9, cin, cout).to(torch.bfloat16)
    trows = torch.arange(kst, device=dev)[None, :, None, None, None] * 16 + r
    tcols = nts[:, None, None, None, None] * 8 + col
    taps = torch.arange(9, device=dev)[None, None, :, None, None]
    wt = wtap[taps, trows, tcols]
    b = torch.zeros(npad, dtype=torch.bfloat16, device=dev)
    b[:cout] = bias.to(torch.bfloat16)
    return PackedLayer(wk[rows, cols].contiguous(), wt.contiguous(), b, cin,
                       cout, cp)


STAT_PHASES = ("staging", "block0", "block1", "store")


def _launch(x, f32_in, cin, blocks, out, stream, stats=None):
    """One K7 launch of ``blocks`` (one or two) from x to out; ``stats``
    (int64 [rows, 5], zeroed) selects the statistics instance."""
    B, H, W = x.shape[:3]
    sb, sh, sw, sc = x.stride() if f32_in else (0, 0, 0, 0)
    first, last = blocks[0], blocks[-1]
    rc = native.entry("rt_guidance_net")(
        x.data_ptr(), sb, sh, sw, sc, int(f32_in), cin, len(blocks),
        first.w.data_ptr(), first.b.data_ptr(), first.cp.bit_length() - 1,
        first.nt, last.wt.data_ptr(), last.b.data_ptr(),
        last.cp.bit_length() - 1, last.nt, out.data_ptr(), out.shape[-1],
        out.shape[-1], B, H, W, 0 if stats is None else stats.data_ptr(),
        stream)
    native.count_launch("guidance_net")
    native.check(rc, "guidance_net_kernel")


def _launch_fused_wide(x, layers, out, stream):
    """One launch of K7's fused wide instance: both blocks from the f32 x
    to out."""
    B, H, W, C = x.shape
    first, last = layers
    rc = native.entry("rt_guidance_wide_fused")(
        x.data_ptr(), *x.stride(), C, first.wt.data_ptr(), first.b.data_ptr(),
        first.nt, last.wt.data_ptr(), last.b.data_ptr(), last.nt,
        last.wt.shape[1], out.data_ptr(), out.shape[-1], out.shape[-1], B, H,
        W, stream)
    native.count_launch("guidance_net_wide")
    native.check(rc, "guidance_wide2_kernel")


def _launch_wide(x, f32_in, cin, layer, out, stream):
    """One launch of K7's per-block plan: ``layer`` from x to out (an f32 x
    of at most WIDE_F32_CHANNELS channels, else a contiguous bf16 one)."""
    B, H, W = x.shape[:3]
    sb, sh, sw, sc = x.stride() if f32_in else (0, 0, 0, 0)
    rc = native.entry("rt_guidance_wide")(
        x.data_ptr(), sb, sh, sw, sc, int(f32_in), cin, layer.wt.data_ptr(),
        layer.b.data_ptr(), layer.wt.shape[1], layer.nt, out.data_ptr(),
        out.shape[-1], out.shape[-1], B, H, W, stream)
    native.count_launch("guidance_net_wide")
    native.check(rc, "guidance_wide_kernel")


def guidance_net(aux_nhwc: torch.Tensor, layers) -> torch.Tensor:
    """Kernel K7 wrapper: the f32 aux [B, H, W, cin] on a CUDA device (any
    strides) through the packed blocks ``layers`` -> the last block's
    activation [B, H, W, cout] bf16, contiguous.  One launch for one or two
    blocks of at most 64 channels and for the fused wide instance's nets,
    else one a block (``net_plan``)."""
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
    if layers[-1].cout % 2:
        raise ValueError(f"guidance_net: K7 stores channel pairs, the last "
                         f"block has {layers[-1].cout} channels")
    if not 1 <= B <= 65535 or H < 1 or W < 1:
        raise ValueError(f"guidance_net: K7 takes a batch of 1..65535 "
                         f"non-empty images, got {tuple(aux_nhwc.shape)}")
    if any(layer.w.device != aux_nhwc.device or
           layer.w.dtype != torch.bfloat16 for layer in layers):
        raise ValueError(f"guidance_net: the packed blocks must be bf16 on "
                         f"{aux_nhwc.device} (GuidanceNetCompact.pack)")
    dev = aux_nhwc.device
    plan = net_plan(layers)
    with torch.cuda.device(dev):
        stream = native.stream_ptr(dev)
        if plan != "chain":
            out = torch.empty((B, H, W, layers[-1].cout),
                              dtype=torch.bfloat16, device=dev)
            if plan == "fused":
                _launch(aux_nhwc, True, C, layers, out, stream)
            else:
                _launch_fused_wide(aux_nhwc, layers, out, stream)
            return out
    # the chain: each intermediate keeps its padded channels (0)
    x = aux_nhwc
    for i, layer in enumerate(layers):
        x = chain_block(x, layer, layer.cout if i == len(layers) - 1
                        else layer.nt * 8)
    return x


def chain_block(x: torch.Tensor, layer: PackedLayer,
                width: int) -> torch.Tensor:
    """One launch of K7's chain: ``layer`` from x, the f32 aux [B, H, W,
    cin] (any strides) or the chain's bf16 intermediate [B, H, W, C]
    (contiguous, C the block before's padded channels, the padding 0), to
    a bf16 [B, H, W, width], ``width`` even, from ``layer.cout`` to
    ``layer.nt * 8`` (the padding 0); the per-block plan for a wide
    block."""
    B, H, W, C = x.shape
    f32_in = x.dtype == torch.float32
    if x.device.type != "cuda" or not (f32_in or (
            x.dtype == torch.bfloat16 and x.is_contiguous())):
        raise ValueError(f"chain_block: x must be an f32 or a contiguous "
                         f"bf16 CUDA tensor, got {x.dtype} on {x.device}")
    if not layer.cin <= C <= layer.cp or width % 2 or not (
            layer.cout <= width <= layer.nt * 8):
        raise ValueError(f"chain_block: a block {layer.cin} -> "
                         f"{layer.cout} from {C} channels to {width}; K7 "
                         "stores channel pairs")
    out = torch.empty((B, H, W, width), dtype=torch.bfloat16,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = native.stream_ptr(x.device)
        if not is_wide(layer):
            _launch(x, f32_in, C, [layer], out, stream)
            return out
        if f32_in and C > WIDE_F32_CHANNELS:
            # the ring's bf16 input: the rounding the first block's
            # instance does as it stages, channels padded to 8 with 0
            x = torch.nn.functional.pad(x.to(torch.bfloat16),
                                        (0, -C % 8)).contiguous()
            f32_in, C = False, x.shape[-1]
        _launch_wide(x, f32_in, C, layer, out, stream)
    return out


def guidance_net_stats(aux_nhwc: torch.Tensor, layers) -> dict:
    """K7's statistics instance on a net of two blocks (8 -> 32 -> 8, the
    committed nets' shape): one launch, and per block the clock64() cycles
    of each phase (STAT_PHASES) and its tiles.  Returns the blocks that ran,
    the tiles, per phase the cycles a tile (summed over blocks / tiles) and
    its share, and the largest block's cycles; the activation is
    discarded."""
    layers = list(layers)
    B, H, W, C = aux_nhwc.shape
    if len(layers) != 2 or aux_nhwc.device.type != "cuda":
        raise ValueError("guidance_net_stats: a two-block net on a CUDA "
                         "tensor")
    dev = aux_nhwc.device
    rows = B * -(-H // 2) * -(-W // 14)  # more than K7's tiles
    st = torch.zeros((rows, len(STAT_PHASES) + 1), dtype=torch.int64,
                     device=dev)
    with torch.cuda.device(dev):
        out = torch.empty((B, H, W, layers[-1].cout), dtype=torch.bfloat16,
                          device=dev)
        _launch(aux_nhwc, True, C, layers, out, native.stream_ptr(dev), st)
    st = st[st[:, -1] > 0].double().cpu()
    tiles = float(st[:, -1].sum())
    cyc = st[:, :-1].sum(0)
    return {"blocks": int(st.shape[0]), "tiles": int(tiles),
            "cycles_per_tile": {k: float(c) / tiles
                                for k, c in zip(STAT_PHASES, cyc)},
            "share": {k: float(c / cyc.sum())
                      for k, c in zip(STAT_PHASES, cyc)},
            "largest_block_cycles": float(st[:, :-1].sum(1).max())}
