// K7: the compact GuidanceNet's forward (the denoiser's net), straight from
// K1's (or K4's) f32 aux to the last block's bf16 activation.
//
// Replaces rt_octree_tpu/models/guidance_net.py:GuidanceNetCompact.__call__
// (:117-136, XLA), called from _denoise (render/renderer.py:1241-1249) and
// _net_forward_jit (:1495-1501).  Per pixel, in Flax's order:
//   x0 = bf16_rn(aux);
//   per block i: y = bf16_rn(sum over the 3x3 taps and cin of x * W_i),
//                accumulated in f32; y = bf16_rn(y + bf16(b_i));
//                x_{i+1} = min(max(y, 0), 6)   (relu6, exact in bf16);
// with zero padding ("SAME") at every block: a neighbour outside the image
// is 0 at the block's input, never the block evaluated out there.  The
// conv output is rounded before the bias is added (two roundings, as Flax
// does); every rounding is round-to-nearest-even; no fast math.
//
// Bound on this card at 8 -> 32 -> 8 (every committed .gnet): 48 B a pixel
// must move (the f32 aux read, the bf16 activation written; 30.7 MB at
// 800x800, 9.2 us at 3.35 TB/s) against 9,216 operations a pixel on the
// bf16 tensor cores (6.0 us at 989 TFLOP/s): bytes, if the 32-channel
// intermediate never reaches device memory.  On mma.sync the tensor cores
// take an m16n8k16 every 6 cycles a sub-partition (ptxas's own stall
// count): this design's 2.76 a pixel (2.25 without its halo and padding)
// take about 11 us at 800x800.  What a kernel pays on top is on chip: the
// shared-memory reads of the A and B fragments, the epilogues' bf16
// rounding, the staging, and the latency of each.
//
// Design: a persistent grid (one block of 8 warps an SM, each block
// walking the tiles blockIdx.x, + gridDim.x, ...).  An output tile is
// 56 x 16 pixels (4 column strips of 14, see 3.).  Per tile:
//   1. staging: the tile's f32 input with a 2-pixel halo (60 x 20 x 8
//      channels) was copied into a staging buffer by one tensor copy (TMA,
//      cp.async.bulk.tensor, zero-filled outside the image and in the
//      padded channels, completing on an mbarrier) while the previous
//      tile computed; it is rounded to bf16 into the input buffer, and the
//      next tile's copy is issued at once.  (Inputs the tensor copy does
//      not take, an f32 one with strided channels or a chain's bf16 one,
//      go by cp.async from every thread.)
//   2. block 0 on the tile plus a 1-pixel halo (58 x 18, 1.17 pixels a
//      pixel of output) into shared memory, 0 where the halo leaves the
//      image (block 1's zero padding): an implicit GEMM on
//      mma.sync.m16n8k16 (bf16 in, f32 accumulate), M = 16 pixels, N = 8
//      output channels an n-tile, K = tap * CP + ci (tap = 3 ky + kx, the
//      input channels padded to CP), padded to a multiple of 16 with zero
//      weights.  Each k-step's A fragment is one ldmatrix.x4; a warp runs
//      chunks c and c + 8 against each B fragment; bias and relu6 in bf16
//      pairs, stored by stmatrix.
//   3. block 1 (the last block) as one product of each input pixel with
//      all nine taps, Z = X . [W_tap0 ... W_tap8] (9 n-tiles of 8 per A
//      fragment), each input row's A fragments loaded once.  A warp owns a
//      16-pixel column strip of block 0's output and half of its rows; it
//      runs 4 output rows at once (4 chains), each in one f32 accumulator:
//      the kx = 0 partials at the input pixels, moved one pixel (one row of
//      the C fragment, by __shfl_sync) onto the output pixels, the kx = 1
//      partials added there, moved one pixel on, the kx = 2 partials added,
//      and the sum moved back one pixel.  A strip's two edge pixels have no
//      neighbour in the fragment, so a strip of 16 writes 14 outputs and
//      strips overlap by 2.
// The weights go on chip once a block, into registers: block 0's B
// fragments when they fit 20 (KS0 x NT0 = 5 x 4 at 8 -> 32 -> 8), else
// block 0 reads them through the cache on every k-step; the last block's
// for one n-tile (KSL x 9 = 18 at 8 -> 32 -> 8), loaded once a block when
// the last block has one n-tile, else reloaded through the cache for each
// n-tile of each tile.  Biases into registers.
//
// Shared-memory bytes a pixel of output at 8 -> 32 -> 8 (the first
// version's in brackets).  Read: block 1's A fragments 91 (576: the 3x3
// window of 32 bf16 channels read nine times), block 0's A fragments 189
// (210), the staging's rounding 43; no B fragment (about 400 through L1
// before).  Written: the tensor copy 43, the bf16 input 21, block 0's
// output 75.  Plus 12 shuffles a row of 14 pixels.  The sum order of
// block 1 (kx, then ky, then 16 channels) differs from the first
// version's (tap-major, as block 0's), so a rare rounding lands elsewhere.
//
// Layout in shared memory: a pixel's channels in groups of 8 (16 bytes,
// one ldmatrix row), group cg of pixel q at 16 * (q * G + (cg ^ swz(q)))
// with G groups a pixel and swz(q) = (q >> (3 - log2 G)) & (G - 1), so that
// the 8 rows of an ldmatrix matrix (8 consecutive pixels) fall in distinct
// banks.  The last block reads 16 channels a k-step, so its input keeps at
// least 2 groups (channels 8-15 zero at 8 channels).  Shapes: 1 or 2
// blocks in one launch, input channels 1-64 (padded to 8, 16, 32 or 64),
// 2-64 output channels; a deeper net runs as a chain of one-block launches
// whose bf16 intermediates keep their padded channels (0).  Wider blocks
// get fewer tile rows (16, 8 or 4) to fit 227 KB of shared memory.  A net
// with a block of more than 64 input or output channels takes K7's wide
// instances (after rt_guidance_net).
//
// Statistics instance (kStats, compiled out of the frame's instances; the
// 8 -> 32 -> 8 shape): per block the clock64() cycles of staging (the wait
// for the copy, the bf16 rounding and the next copy's issue), block 0,
// block 1 and its stores (warp 0's), and the tiles the block computed.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStrips = 4;                // column strips of the last block
constexpr int kBands = kWarps / kStrips;  // row bands a strip is split into
constexpr int kOut = 14;                  // output columns a strip writes
constexpr int kTileW = kStrips * kOut;    // output tile width
constexpr int kSmemMax = 232448;          // 227 KB a block
constexpr int kStatWords = 5;

struct Params {
  const void* in;  // f32 [B, H, W, cin] through strides, or bf16 [B, H, W, CP]
  long long sb, sh, sw, sc;  // element strides of the f32 input
  int cin;
  bool tma;  // f32 input staged by a tensor copy (channels contiguous)
  const uint2* w0;  // block 0 of a two-block launch: [ks][nt][32] x 4 bf16
  const __nv_bfloat16* b0;
  const uint2* wl;  // the last block: [nt][ks][9 taps][32] x 4 bf16
  const __nv_bfloat16* bl;
  int ntl;             // the last block's n-tiles
  __nv_bfloat16* out;  // [B, H, W, ostride]
  int ostride, cout;   // channels a pixel in out, channels written
  int batch, height, width;
  long long* stats;  // statistics instance: [blocks][kStatWords], else null
};

constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }

// Sizes of one instance: F32_IN (else bf16 input), NL blocks, CP0 input
// channels (padded), NT0 block 0's n-tiles when NL == 2.
template <bool F32_IN, int NL, int CP0, int NT0>
struct Cfg {
  static constexpr int CPL = NL == 2 ? 8 * NT0 : CP0;  // last block's input
  static constexpr int LGL = log2i((CPL < 16 ? 16 : CPL) / 8);
  static constexpr int KSL = (1 << LGL) / 2;  // its k-steps of 16 channels
  static constexpr int LG0 = NL == 2 ? log2i(CP0 / 8) : LGL;  // xin layout
  static constexpr int KS0 = (9 * CP0 + 15) / 16;
  // block 0's B fragments in registers when they fit 20 fragments, else
  // read through the cache
  static constexpr bool kW0Regs = NL == 2 && KS0 * NT0 <= 20;
  static constexpr int ESZ = F32_IN ? 4 : 2;
  static constexpr int TW = kTileW;
  static constexpr int WI = kTileW + 2 * NL, WM = kTileW + 2;
  static constexpr int bytes(int th) {
    return 128 + (th + 2 * NL) * WI * (CP0 * ESZ + (16 << LG0)) +
           (NL == 2 ? ((th + 2) * WM + 15) / 16 * 16 * (16 << LGL) : 0);
  }
  static constexpr int TH = bytes(16) <= kSmemMax  ? 16
                            : bytes(8) <= kSmemMax ? 8
                                                   : 4;
  static constexpr int RB = TH / kBands;  // output rows a warp walks
  static constexpr int HI = TH + 2 * NL;
  static constexpr int STAGE = HI * WI * CP0 * ESZ;
  static constexpr int XIN = HI * WI * (16 << LG0);
  static constexpr int SMEM = bytes(TH);
  static_assert(SMEM <= kSmemMax, "K7 instance does not fit shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of channel group cg of pixel q, 2^LG groups a pixel (note)
template <int LG>
__device__ __forceinline__ uint32_t act_off(int q, int cg) {
  const int sw = LG == 0 ? 0 : (q >> (3 - LG)) & ((1 << LG) - 1);
  return static_cast<uint32_t>(((q << LG) + (cg ^ sw)) * 16);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// d += a . b on 8 channels: mma.m16n8k8 (A rows g, g + 8 and channels 2t,
// 2t + 1 in a0, a1; B channels 2t, 2t + 1 of column g in b)
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n" ::"r"(
          addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3));
}

// bf16_rn(bf16_rn(y) + b) for a bf16 bias b, then relu6 (NaN passes, as
// jnp.maximum's), on two channels: the bf16 add is exact-then-rounded, as
// Flax's f32 add then bf16 rounding is (f32 holds 24 >= 2 * 8 + 2 bits, so
// the double rounding is innocuous)
__device__ __forceinline__ uint32_t bias_relu6(float y0, float y1,
                                               __nv_bfloat162 b) {
  const uint32_t kZero = 0u, kSix = 0x40c040c0u;  // bf16 pairs (0, 0), (6, 6)
  const __nv_bfloat162 zero = *reinterpret_cast<const __nv_bfloat162*>(&kZero);
  const __nv_bfloat162 six = *reinterpret_cast<const __nv_bfloat162*>(&kSix);
  const __nv_bfloat162 z = __hmin2_nan(
      __hmax2_nan(__hadd2(__floats2bfloat162_rn(y0, y1), b), zero), six);
  return *reinterpret_cast<const uint32_t*>(&z);
}

__device__ __forceinline__ __nv_bfloat162 load_bias(const __nv_bfloat16* b,
                                                    int n) {
  return *reinterpret_cast<const __nv_bfloat162*>(b + n);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// tile t -> (image, first output row, first output column)
template <class C>
__device__ __forceinline__ void tile_origin(const Params& p, int t, int& bz,
                                            int& ty, int& tx) {
  const int tiles_x = (p.width + C::TW - 1) / C::TW;
  const int tiles_y = (p.height + C::TH - 1) / C::TH;
  bz = t / (tiles_x * tiles_y);
  const int r = t - bz * tiles_x * tiles_y;
  ty = (r / tiles_x) * C::TH;
  tx = (r % tiles_x) * C::TW;
}

// 1. issue the copies of tile t's input region (HI x WI pixels, CP0
// channels, as they are) into the staging buffer, zero outside: one tensor
// copy by one thread (completing on the barrier ``bar``), else cp.async by
// every thread
template <class C, bool F32_IN, int NL, int CP0>
__device__ __forceinline__ void stage_async(const CUtensorMap& tmap,
                                            const Params& p, int t,
                                            uint32_t stage, uint32_t bar) {
  int bz, ty, tx;
  tile_origin<C>(p, t, bz, ty, tx);
  const int y0 = ty - NL, x0 = tx - NL, H = p.height, W = p.width;
  if (F32_IN && p.tma) {
    if (threadIdx.x == kThreads - 1) {  // the warp with the least of block 0
      // the staging buffer's last reads (generic proxy) before the copy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(C::STAGE)
          : "memory");
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
              stage),
          "l"(reinterpret_cast<uint64_t>(&tmap)), "r"(0), "r"(x0), "r"(y0),
          "r"(bz), "r"(bar)
          : "memory");
    }
    return;
  }
  if (F32_IN) {  // through the strides, 4 bytes a copy
    const float* in = static_cast<const float*>(p.in) + bz * p.sb;
    for (int i = threadIdx.x; i < C::HI * C::WI * CP0; i += kThreads) {
      const int c = i % CP0, pix = i / CP0;
      const int y = y0 + pix / C::WI, x = x0 + pix % C::WI;
      const bool ok = c < p.cin && y >= 0 && y < H && x >= 0 && x < W;
      cp_async4(stage + i * 4,
                ok ? in + y * p.sh + x * p.sw + c * p.sc : in, ok ? 4 : 0);
    }
  } else {
    constexpr int V = CP0 / 8;  // 16-byte groups a pixel
    const uint4* in = static_cast<const uint4*>(p.in) +
                      static_cast<long long>(bz) * H * W * V;
    for (int i = threadIdx.x; i < C::HI * C::WI * V; i += kThreads) {
      const int v = i % V, pix = i / V;
      const int y = y0 + pix / C::WI, x = x0 + pix % C::WI;
      const bool ok = y >= 0 && y < H && x >= 0 && x < W;
      cp_async16(stage + i * 16,
                 ok ? in + (static_cast<long long>(y) * W + x) * V + v : in,
                 ok ? 16 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for the staged tile: the barrier's phase ``parity`` (tensor copy),
// else this thread's cp.async groups
__device__ __forceinline__ void stage_wait(bool tma, uint32_t bar,
                                           uint32_t parity) {
  if (!tma) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    return;
  }
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// 1. the staged region rounded to bf16 into xin's layout (groups past CP0
// are 0)
template <class C, bool F32_IN, int CP0>
__device__ __forceinline__ void convert(const unsigned char* stage,
                                        unsigned char* xin) {
  constexpr int G = 1 << C::LG0;
  for (int i = threadIdx.x; i < C::HI * C::WI * G; i += kThreads) {
    const int cg = i % G, q = i / G;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (cg * 8 < CP0) {
      if (F32_IN) {
        const float4* s =
            reinterpret_cast<const float4*>(stage + (q * CP0 + cg * 8) * 4);
        const float4 a = s[0], b = s[1];
        v = make_uint4(bf16x2_bits(a.x, a.y), bf16x2_bits(a.z, a.w),
                       bf16x2_bits(b.x, b.y), bf16x2_bits(b.z, b.w));
      } else {
        v = *reinterpret_cast<const uint4*>(stage + (q * CP0 + cg * 8) * 2);
      }
    }
    *reinterpret_cast<uint4*>(xin + act_off<C::LG0>(q, cg)) = v;
  }
}

// one k-step of block 0 on a warp's one or two chunks (A rows at pixels
// q0[r] of xin, the tap and channel group of this lane's k half)
template <class C, int CP0, int NT0>
__device__ __forceinline__ void first_kstep(int ks, int khalf, uint32_t xin,
                                            const int (&q0)[2], bool two,
                                            const uint2 (&b)[NT0],
                                            float (&acc)[2][NT0][4]) {
  const int k0 = ks * 16 + khalf;
  const int tap = min(k0 / CP0, 8);  // K padding: its weights are 0
  const int ky = tap / 3, kx = tap - 3 * ky, cg = (k0 % CP0) / 8;
  uint32_t a[2][4];
  ldmatrix_x4(a[0], xin + act_off<C::LG0>(q0[0] + ky * C::WI + kx, cg));
  if (two)
    ldmatrix_x4(a[1], xin + act_off<C::LG0>(q0[1] + ky * C::WI + kx, cg));
#pragma unroll
  for (int nt = 0; nt < NT0; ++nt) {
    mma_bf16(acc[0][nt], a[0], b[nt]);
    if (two) mma_bf16(acc[1][nt], a[1], b[nt]);
  }
}

// 2. block 0 on the region around the tile (TH + 2 x WM pixels) from xin into
// xmid, zero outside the image
template <class C, int CP0, int NT0>
__device__ __forceinline__ void first_block(
    const Params& p,
    const uint2 (&wr)[C::kW0Regs ? C::KS0 : 1][C::kW0Regs ? NT0 : 1],
    uint32_t xin, uint32_t xmid, int ty, int tx, int warp, int lane) {
  constexpr int NPIX = (C::TH + 2) * C::WM, NCH = (NPIX + 15) / 16;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int row = (lane & 7) + (lane & 8), khalf = (lane >> 4) * 8;
  __nv_bfloat162 bias[NT0];
#pragma unroll
  for (int nt = 0; nt < NT0; ++nt) bias[nt] = load_bias(p.b0, nt * 8 + t2);
  // chunks c and c + kWarps together: the odd chunk at the end is a pass of
  // one chunk
  for (int c0 = warp; c0 < NCH; c0 += 2 * kWarps) {
    const bool two = c0 + kWarps < NCH;
    float acc[2][NT0][4];
    int q0[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int nt = 0; nt < NT0; ++nt)
        acc[r][nt][0] = acc[r][nt][1] = acc[r][nt][2] = acc[r][nt][3] = 0.f;
      const int m = min((c0 + r * kWarps) * 16 + row, NPIX - 1);  // past: any
      q0[r] = (m / C::WM) * C::WI + m % C::WM;
    }
    if constexpr (C::kW0Regs) {
#pragma unroll
      for (int ks = 0; ks < C::KS0; ++ks)
        first_kstep<C, CP0, NT0>(ks, khalf, xin, q0, two, wr[ks], acc);
    } else {
#pragma unroll 2
      for (int ks = 0; ks < C::KS0; ++ks) {
        uint2 b[NT0];
#pragma unroll
        for (int nt = 0; nt < NT0; ++nt)
          b[nt] = __ldg(p.w0 + (ks * NT0 + nt) * 32 + lane);
        first_kstep<C, CP0, NT0>(ks, khalf, xin, q0, two, b, acc);
      }
    }
    // relu6(conv + bias) in bf16, 0 outside the image, stored as 8x8
    // matrices (pixels x 8 channels): lane l gives the row address of
    // matrix l / 8, rows g and g + 8 of n-tile nt are its registers
    constexpr int NP = NT0 < 2 ? 2 : NT0;  // n-tiles stored, 8-15 zero at 1
    const int mrow = (lane & 7) + 8 * ((lane >> 3) & 1), mnt = lane >> 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !two) break;
      uint32_t v[2][NP];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (c0 + r * kWarps) * 16 + g + 8 * half;
        const int y = ty - 1 + m / C::WM, x = tx - 1 + m % C::WM;
        const bool inside = m < NPIX && y >= 0 && y < p.height && x >= 0 &&
                            x < p.width;
#pragma unroll
        for (int nt = 0; nt < NP; ++nt) {
          const uint32_t val =
              nt < NT0 ? bias_relu6(acc[r][nt < NT0 ? nt : 0][2 * half],
                                    acc[r][nt < NT0 ? nt : 0][2 * half + 1],
                                    bias[nt < NT0 ? nt : 0])
                       : 0u;
          v[half][nt] = inside ? val : 0u;
        }
      }
      const int m = (c0 + r * kWarps) * 16 + mrow;  // past NPIX: the padding
#pragma unroll
      for (int np = 0; np < NP; np += 2)
        stmatrix_x4(xmid + act_off<C::LGL>(m, np + mnt), v[0][np], v[1][np],
                    v[0][np + 1], v[1][np + 1]);
    }
  }
}

// the last block's B fragments of n-tile nt, [ks][tap]
template <class C>
__device__ __forceinline__ void load_last(const Params& p, int nt, int lane,
                                          uint2 (&wr)[C::KSL][9]) {
#pragma unroll
  for (int ks = 0; ks < C::KSL; ++ks)
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      wr[ks][tap] = __ldg(p.wl + ((nt * C::KSL + ks) * 9 + tap) * 32 + lane);
}

// a C fragment moved by one pixel (one row of M): row r takes row r - 1
// (kUp) or r + 1.  Lane g holds rows g and g + 8, so a row's neighbour is in
// lane g - 1 or g + 1, wrapping across the halves at g = 0 and g = 7; the
// row that would come from outside the fragment takes another row
template <bool kUp>
__device__ __forceinline__ void shift_rows(float (&c)[4], int g, int lane) {
  const int src = kUp ? (lane + 28) & 31 : (lane + 4) & 31;
  float s[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = __shfl_sync(0xffffffffu, c[e], src);
  if (kUp) {
    c[0] = s[0];
    c[1] = s[1];
    c[2] = g ? s[2] : s[0];
    c[3] = g ? s[3] : s[1];
  } else {
    c[0] = g < 7 ? s[0] : s[2];
    c[1] = g < 7 ? s[1] : s[3];
    c[2] = s[2];
    c[3] = s[3];
  }
}

// 3. the last block on the tile from src (TH + 2 x WM pixels) to out (note).
// Output row o of the band sums its nine taps in one f32 accumulator, kx
// outer, then ky, then the k-steps: the kx = 0 partials at the input
// pixels, moved up one pixel; the kx = 1 partials added at the output
// pixels, moved up one pixel again; the kx = 2 partials added, and the sum
// moved down one pixel: each tap's partial reaches its output pixel in the
// same accumulator.  P output rows run together (P chains), from the
// P + 2 input rows' A fragments, each loaded once.
template <class C, bool kStats>
__device__ __forceinline__ void last_block(const Params& p,
                                           uint2 (&wr)[C::KSL][9],
                                           uint32_t src, int bz, int ty,
                                           int tx, int warp, int lane,
                                           long long& store_clk) {
  constexpr int P = C::RB <= 4 ? C::RB : C::RB / 2;
  static_assert(C::RB % P == 0, "whole groups of rows");
  const int strip = warp % kStrips, band = warp / kStrips;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int row = (lane & 7) + (lane & 8), khalf = lane >> 4;
  __nv_bfloat16* out =
      p.out + static_cast<long long>(bz) * p.height * p.width * p.ostride;
  // this lane's two output pixels, rows g and g + 8 of the strip (its rows
  // 0 and 15 have no output)
  const int x_lo = tx + strip * kOut + g - 1, x_hi = x_lo + 8;
  const bool lo_ok = g >= 1 && x_lo < p.width;
  const bool hi_ok = g <= 6 && x_hi < p.width;
  for (int nt = 0; nt < p.ntl; ++nt) {
    if (p.ntl > 1) load_last<C>(p, nt, lane, wr);  // else loaded once
    const int n = nt * 8 + t2;
    const __nv_bfloat162 bias = load_bias(p.bl, n);
    uint32_t a[P + 2][C::KSL][4];  // the group's input rows
#pragma unroll
    for (int grp = 0; grp < C::RB / P; ++grp) {
      const int i0 = grp * P;  // its first output row = first input row
#pragma unroll
      for (int j = 0; j < P + 2; ++j) {
        if (grp > 0 && j < 2) {  // the previous group's last two rows
#pragma unroll
          for (int ks = 0; ks < C::KSL; ++ks)
#pragma unroll
            for (int e = 0; e < 4; ++e) a[j][ks][e] = a[P + j][ks][e];
          continue;
        }
        const int q = (band * C::RB + i0 + j) * C::WM + strip * kOut + row;
#pragma unroll
        for (int ks = 0; ks < C::KSL; ++ks)
          ldmatrix_x4(a[j][ks], src + act_off<C::LGL>(q, 2 * ks + khalf));
      }
      float c[P][4];
#pragma unroll
      for (int j = 0; j < P; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int ks = 0; ks < C::KSL; ++ks)
#pragma unroll
            for (int j = 0; j < P; ++j)
              mma_bf16(c[j], a[j + ky][ks], wr[ks][ky * 3 + kx]);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          if (kx < 2)
            shift_rows<true>(c[j], g, lane);
          else
            shift_rows<false>(c[j], g, lane);
        }
      }
      long long t0 = 0;
      if (kStats) t0 = clock64();
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int y = ty + band * C::RB + i0 + j;
        if (y >= p.height || n >= p.cout) continue;  // cout even: n + 1 too
        __nv_bfloat16* o =
            out + static_cast<long long>(y) * p.width * p.ostride + n;
        if (lo_ok)
          *reinterpret_cast<uint32_t*>(o + x_lo * p.ostride) =
              bias_relu6(c[j][0], c[j][1], bias);
        if (hi_ok)
          *reinterpret_cast<uint32_t*>(o + x_hi * p.ostride) =
              bias_relu6(c[j][2], c[j][3], bias);
      }
      if (kStats) store_clk += clock64() - t0;
    }
  }
}

template <bool F32_IN, int NL, int CP0, int NT0, bool kStats>
__global__ void __launch_bounds__(kThreads, 1)
    guidance_net_kernel(const __grid_constant__ CUtensorMap tmap,
                        const Params p) {
  using C = Cfg<F32_IN, NL, CP0, NT0>;
  // [barrier | staging | xin | xmid]
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bar = smem_addr(smem);
  unsigned char* stage_p = smem + 128;  // the tensor copy's 128-byte rule
  unsigned char* xin = stage_p + C::STAGE;
  unsigned char* xmid = xin + C::XIN;
  const uint32_t stage = smem_addr(stage_p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntiles = p.batch * ((p.height + C::TH - 1) / C::TH) *
                     ((p.width + kTileW - 1) / kTileW);
  const int first = blockIdx.x, step = gridDim.x;

  if (F32_IN && p.tma && threadIdx.x == kThreads - 1) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t parity = 0;
  if (first < ntiles)
    stage_async<C, F32_IN, NL, CP0>(tmap, p, first, stage, bar);
  // the weights, once a block, into registers: block 0's when they fit 20
  // fragments (else first_block reads them through the cache), the last
  // block's first n-tile
  uint2 wr0[C::kW0Regs ? C::KS0 : 1][C::kW0Regs ? NT0 : 1];
  if constexpr (C::kW0Regs) {
#pragma unroll
    for (int ks = 0; ks < C::KS0; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT0; ++nt)
        wr0[ks][nt] = __ldg(p.w0 + (ks * NT0 + nt) * 32 + lane);
  }
  uint2 wrl[C::KSL][9];
  load_last<C>(p, 0, lane, wrl);

  long long clk[4] = {0, 0, 0, 0}, t0 = 0, store_clk = 0;
  int tiles = 0;
  for (int t = first; t < ntiles; t += step) {
    if (kStats) t0 = clock64();
    stage_wait(F32_IN && p.tma, bar, parity);
    parity ^= 1u;
    __syncthreads();  // tile t staged; the previous tile's reads are done
    convert<C, F32_IN, CP0>(stage_p, xin);
    __syncthreads();  // xin ready, the staging buffer free
    if (t + step < ntiles)
      stage_async<C, F32_IN, NL, CP0>(tmap, p, t + step, stage, bar);
    if (kStats) {
      const long long t1 = clock64();
      clk[0] += t1 - t0;
      t0 = t1;
    }
    int bz, ty, tx;
    tile_origin<C>(p, t, bz, ty, tx);
    if constexpr (NL == 2) {
      first_block<C, CP0, NT0>(p, wr0, smem_addr(xin), smem_addr(xmid), ty,
                               tx, warp, lane);
      __syncthreads();
      if (kStats) {
        const long long t1 = clock64();
        clk[1] += t1 - t0;
        t0 = t1;
      }
    }
    const long long s0 = store_clk;
    last_block<C, kStats>(p, wrl, smem_addr(NL == 2 ? xmid : xin), bz, ty,
                          tx, warp, lane, store_clk);
    if (kStats) {
      __syncthreads();
      const long long t1 = clock64();
      clk[2] += t1 - t0 - (store_clk - s0);
      clk[3] += store_clk - s0;
      ++tiles;
    }
  }
  if (kStats && threadIdx.x == 0) {
    long long* st = p.stats + static_cast<long long>(blockIdx.x) * kStatWords;
    for (int i = 0; i < 4; ++i) st[i] = clk[i];
    st[4] = tiles;
  }
}

// a tensor map of a 4-d tensor [B, H, W, C] (C contiguous; byte strides of
// W, H and B) for boxes of box[0..3], zero-filled outside;
// cuTensorMapEncodeTiled through the runtime's driver entry point
int encode_map(CUtensorMapDataType type, const void* base,
               const cuuint64_t (&dims)[4], const cuuint64_t (&strides)[3],
               const cuuint32_t (&box)[4], CUtensorMapSwizzle swizzle,
               CUtensorMap* map) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || !fn)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the tensor map of the f32 input [B, H, W, cin] (element strides sb, sh,
// sw, channels contiguous) for boxes of CP0 x WI x HI x 1
int encode_input(const Params& p, int cp0, int wi, int hi, CUtensorMap* map) {
  const cuuint64_t dims[4] = {(cuuint64_t)p.cin, (cuuint64_t)p.width,
                              (cuuint64_t)p.height, (cuuint64_t)p.batch};
  const cuuint64_t strides[3] = {(cuuint64_t)p.sw * 4, (cuuint64_t)p.sh * 4,
                                 (cuuint64_t)p.sb * 4};
  const cuuint32_t box[4] = {(cuuint32_t)cp0, (cuuint32_t)wi, (cuuint32_t)hi,
                             1};
  return encode_map(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.in, dims, strides,
                    box, CU_TENSOR_MAP_SWIZZLE_NONE, map);
}

template <bool F32_IN, int NL, int CP0, int NT0, bool kStats>
int launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<F32_IN, NL, CP0, NT0>;
  auto kernel = guidance_net_kernel<F32_IN, NL, CP0, NT0, kStats>;
  // the shared-memory attribute, and the blocks an SM holds, once a device
  static int per_sm[64] = {}, sms[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    int n = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                        C::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    per_sm[dev] = n;
  }
  const long long ntiles = static_cast<long long>(p.batch) *
                           ((p.height + C::TH - 1) / C::TH) *
                           ((p.width + kTileW - 1) / kTileW);
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long slots = static_cast<long long>(sms[dev]) * per_sm[dev];
  const int grid = static_cast<int>(ntiles < slots ? ntiles : slots);
  CUtensorMap map{};
  if (F32_IN && p.tma) {
    const int rc = encode_input(p, CP0, C::WI, C::HI, &map);
    if (rc) return rc;
  }
  kernel<<<grid, kThreads, C::SMEM, stream>>>(map, p);
  return (int)cudaGetLastError();
}

// the template instance for the input's channels (and block 0's n-tiles)
int dispatch(const Params& p, bool f32_in, int layers, int cpl0, int nt0,
             cudaStream_t s) {
  if (p.stats)  // the statistics instance: the committed nets' shape
    return layers == 2 && cpl0 == 3 && nt0 == 4
               ? launch<true, 2, 8, 4, true>(p, s)
               : (int)cudaErrorInvalidValue;
#define RT_NET_CASE(CPL, CP)                                       \
  case CPL:                                                        \
    if (layers == 1)                                               \
      return f32_in ? launch<true, 1, CP, 1, false>(p, s)          \
                    : launch<false, 1, CP, 1, false>(p, s);        \
    switch (nt0) {                                                 \
      case 1: return launch<true, 2, CP, 1, false>(p, s);          \
      case 2: return launch<true, 2, CP, 2, false>(p, s);          \
      case 4: return launch<true, 2, CP, 4, false>(p, s);          \
      case 8: return launch<true, 2, CP, 8, false>(p, s);          \
    }                                                              \
    break;
  switch (cpl0) {
    RT_NET_CASE(3, 8)
    RT_NET_CASE(4, 16)
    RT_NET_CASE(5, 32)
    RT_NET_CASE(6, 64)
  }
#undef RT_NET_CASE
  return (int)cudaErrorInvalidValue;
}

bool layer_ok(int cpl, int nt) {
  return cpl >= 3 && cpl <= 6 && (nt == 1 || nt == 2 || nt == 4 || nt == 8);
}

// ---------------------------------------------------------------------------
// K7's wide instances (launch name "guidance_net_wide"): a net with a block
// of more than 64 input or output channels (a --mid_channels above 64, or
// more than 32 kernel levels).  They replace
// rt_octree_tpu/models/guidance_net.py:GuidanceNetCompact.__call__ (:117-136)
// for such nets, with the header's numerics: each output one f32 sum over the
// nine taps and every input channel, rounded to bf16, the bf16 bias added
// with a second rounding, relu6; zero padding at every block's input.
//
// Bound on this card at 8 -> 96 -> 24 (the wide path's net,
// --mid_channels 96 --kernel_levels 12): 55,296 operations a pixel on the
// bf16 tensor cores (0.0358 ms at 800x800 and 989 TFLOP/s) against 80 B a
// pixel that must move (0.0153 ms): operations, if the 96-channel
// intermediate never reaches device memory (its round trip alone, 384 B a
// pixel, would take 0.073 ms).
//
// Both instances share an output tile of 64 x 8 pixels and one product,
// ``conv_rows``: eight warps, each owning a strip of 16 output columns and
// kXRows = 4 output rows, for NB n-tiles of 8 output channels at a time.
// The block's input is staged in shared memory as bf16 over the tile and a
// 1-pixel halo (66 x 10 pixels), one plane a group of 8 channels (16 bytes a
// pixel, so the 8 rows of an ldmatrix matrix are 128 consecutive bytes: no
// bank conflict), 0 outside the image.  For each k-step of 16 channels the
// warp loads the 9 x NB B fragments of the nine taps from shared memory
// once and walks the kXRows + 2 input rows of its strip: each row's A
// fragment at each kx (one ldmatrix.x4) feeds mma.m16n8k16 for every output
// row it is a tap of (row - ky) and every n-tile, so an A fragment feeds up
// to 3 NB products and a B fragment kXRows.  An output sums the k-steps in
// turn, the nine taps in order within each, 16 channels a product, so that
// both instances give the same bf16 activation bit for bit.
//
//  - The fused wide instance (guidance_wide2_kernel): a two-block net from
//    at most 8 input channels whose weights and intermediate fit 227 KB
//    (ops/guidance.fused_wide_smem; 210,752 bytes at 8 -> 96 -> 24), both
//    blocks in one launch.  A persistent grid (one block of 8 warps an SM
//    walking the tiles); both blocks' B fragments go into shared memory
//    once a block, padded with zero n-tiles to whole groups; the f32 aux of
//    a tile (68 x 12 x 8 channels, a 2-pixel halo) comes in by one tensor
//    copy (TMA, or cp.async for strided channels), the next tile's issued
//    as soon as block 0 has read this one's, so it lands while block 1
//    computes.  Block 0 on the 66 x 10 region: a warp holds the B fragments
//    of kXNB0 = 4 n-tiles in registers while it walks the region's m-tiles,
//    one mma.m16n8k8 a tap on the pixel's 8 channels, read from the f32
//    staging and rounded to bf16: the per-block plan's one-tap k-step of
//    16 channels, 8 of them 0, in half the tensor work and bit for bit (the
//    5 k-steps of a K packed over the 8 real channels would add other
//    groups of products and move the activation's roundings); its output
//    (bias, relu6, 0 outside the image) is stored by stmatrix into the bf16
//    planes that conv_rows reads as block 1's input.  The intermediate
//    never leaves the SM.
//  - The per-block plan: one block a launch, for chains the fused
//    instance cannot take (3 blocks, or weights past 227 KB: 8 -> 128 ->
//    128 -> 8, 8 -> 256 -> 64), their bf16 intermediates keeping their
//    padded channels (0).  Bound at 8 -> 128 -> 128 -> 8, 800x800: the
//    128 -> 128 block by operations (294,912 a pixel, 0.191 ms), the first
//    and last blocks by bytes (288 and 272 a pixel, 0.055 and 0.052 ms).
//    Both instances run a persistent grid over the 64 x 8 tiles, with the
//    B fragments in shared memory once a block.
//    The first block (guidance_wide_first_kernel, an f32 input of at most
//    8 channels): the fused wide instance's staging (one tensor copy of a
//    tile's region, issued while the tile before computes), rounded once
//    into a bf16 plane, and one mma.m16n8k8 a tap on the 8 real channels
//    for each group of kXFirstNB n-tiles.  Both instances stage a warp's
//    output in shared memory in the box layout of the output's tensor map
//    and write it by tensor stores (the first block's 64 channels a store,
//    whole 128-byte lines of each pixel; store_tile).
//    A block from the bf16 intermediate (guidance_wide_kernel): its output
//    n-tiles are split into ``parts`` groups of NB (1, 2, 4 or 8), each
//    group's B fragments resident in its own blocks of the grid (at 128
//    -> 128: 2 parts of 147,456 bytes; a tile's two parts run on
//    neighbouring blocks at the same time, so its input is read from
//    memory once and from L2 twice).  Thread 0 streams each tile's k-step
//    slices (16 channels of the 66 x 10 region, 21,120 bytes, one tensor
//    copy with the 32-byte swizzle that keeps ldmatrix free of bank
//    conflicts) through a ring of 2-8 slices, a full and an empty mbarrier
//    each, so that every channel of a tile lands once and the next tile's
//    slices land while this one computes.  At 4 and 8 n-tiles the product
//    is wgmma.m64nNk16: a warpgroup's 64 rows are a band's output row of
//    64 pixels (each warp's A fragment loaded by ldmatrix at the tap's
//    shifted pixel, as conv_rows does), B a tap's K-major tile resident in
//    shared memory, its nine taps issued in order for each output row; at
//    1 and 2 n-tiles (the last block of a net) it is conv_rows' mma.sync.
//    Each output is summed in conv_rows' order (the k-steps in turn, the
//    nine taps in order, 16 channels a product): wgmma's k16 products give
//    mma.sync's bits, so the fused wide instance and both products agree
//    bit for bit (checked on the card).
// ---------------------------------------------------------------------------
constexpr int kXTileW = 64, kXTileH = 8;  // the wide instances' output tile
constexpr int kXRows = 4;                 // output rows a warp owns
constexpr int kXStrips = kXTileW / 16;    // strips of 16 columns
static_assert(kXStrips * (kXTileH / kXRows) == kWarps, "a warp a strip band");
constexpr int kXWM = kXTileW + 2, kXHM = kXTileH + 2;  // the 1-pixel halo
constexpr int kXNPix = kXWM * kXHM;                    // 660
constexpr int kXNPixM = (kXNPix + 15) / 16 * 16;       // whole m-tiles
// bytes of a plane of 8 channels; the extra 16 bytes put the planes of one
// pixel in distinct banks when a warp stages several of them
constexpr int kXPlane = kXNPixM * 16 + 16;
constexpr int kXNB0 = 4;   // block 0's n-tiles a warp holds (fused instance)

// the fused wide instance's input staging (stage_async): 8 f32 channels
// with a 2-pixel halo
struct WideCfg {
  static constexpr int TW = kXTileW, TH = kXTileH;
  static constexpr int WI = TW + 4, HI = TH + 4;
  static constexpr int STAGE = HI * WI * 8 * 4;
};

// Shared-memory bytes of the fused wide instance: barrier, staging, ng0 *
// kXNB0 planes of the intermediate, block 0's B fragments (9 taps, the 8
// channels of an m16n8k8: 128 bytes each) and block 1's (256 bytes each;
// ops/guidance.fused_wide_smem computes the same).
constexpr int fused_wide_smem(int ng0, int ng1, int nb1, int ks1) {
  return 128 + WideCfg::STAGE + ng0 * kXNB0 * kXPlane +
         ng0 * 9 * kXNB0 * 128 + ng1 * ks1 * 9 * nb1 * 256;
}
static_assert(fused_wide_smem(3, 1, 3, 6) == 210752, "8 -> 96 -> 24");

// The fused wide instance's block 1 on the staged planes at src: this
// warp's kXRows output rows of its strip, NB n-tiles, ks_n k-steps from
// plane 0; ws: the B fragments [ks][tap][nb][lane] (note).  Each output
// sums k-step by k-step, the taps in order (input row i = j + ky, then kx),
// 16 channels a product.
template <int NB>
__device__ __forceinline__ void conv_rows(uint32_t src, int ks_n,
                                          const uint2* ws, int strip,
                                          int band, int lane,
                                          float (&acc)[kXRows][NB][4]) {
  const int row = (lane & 7) + (lane & 8), khalf = lane >> 4;
  const uint32_t base = src + khalf * kXPlane +
                        ((band * kXRows) * kXWM + strip * 16 + row) * 16;
#pragma unroll 1
  for (int ks = 0; ks < ks_n; ++ks) {
    uint2 b[9][NB];
    const uint2* wk = ws + ks * 9 * NB * 32 + lane;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) b[tap][nb] = wk[(tap * NB + nb) * 32];
#pragma unroll
    for (int i = 0; i < kXRows + 2; ++i) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        uint32_t a[4];
        ldmatrix_x4(a, base + 2 * ks * kXPlane + (i * kXWM + kx) * 16);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int j = i - ky;  // the output row this input row is a tap of
          if (j < 0 || j >= kXRows) continue;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            mma_bf16(acc[j][nb], a, b[3 * ky + kx][nb]);
        }
      }
    }
  }
}

// conv_rows' accumulators of n-tiles nt0.. : bias, relu6, the pairs of
// channels below p.cout stored in out (rows g and g + 8 of a C fragment are
// output columns g and g + 8 of the strip)
template <int NB>
__device__ __forceinline__ void store_rows(const Params& p,
                                           const __nv_bfloat16* bias,
                                           int nt0, float (&acc)[kXRows][NB][4],
                                           int bz, int ty, int tx, int strip,
                                           int band, int lane) {
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int x_lo = tx + strip * 16 + g, x_hi = x_lo + 8;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int n = (nt0 + nb) * 8 + t2;
    if (n >= p.cout) continue;  // cout even: n + 1 too
    const __nv_bfloat162 b = load_bias(bias, n);
#pragma unroll
    for (int j = 0; j < kXRows; ++j) {
      const int y = ty + band * kXRows + j;
      if (y >= p.height) continue;
      __nv_bfloat16* o =
          p.out + ((static_cast<long long>(bz) * p.height + y) * p.width) *
                      p.ostride + n;
      if (x_lo < p.width)
        *reinterpret_cast<uint32_t*>(o + x_lo * p.ostride) =
            bias_relu6(acc[j][nb][0], acc[j][nb][1], b);
      if (x_hi < p.width)
        *reinterpret_cast<uint32_t*>(o + x_hi * p.ostride) =
            bias_relu6(acc[j][nb][2], acc[j][nb][3], b);
    }
  }
}

struct FusedWideParams {
  Params p;  // the f32 input and its strides, the output, the frame
  const uint2* w0;  // block 0's tap-major pack [nt0][1][9][32]
  const __nv_bfloat16* b0;
  int nt0, ng0;  // its n-tiles, and their groups of kXNB0
  const uint2* w1;  // block 1's tap-major pack [nt1][ks1][9][32]
  const __nv_bfloat16* b1;
  int nt1, ks1, ng1;  // its n-tiles, k-steps, groups of NB1
};

// The fused wide instance's block 0 on the tile's region (66 x 10 pixels)
// from the staged f32 input into the planes at xmid, 0 outside the image;
// w0s: the B fragments [group][tap][nb][lane].  One product a tap, the
// taps in order, on the 8 channels rounded to bf16 (mma.m16n8k8: the
// per-block plan's k-step of 16 channels whose last 8 are 0 sums the same
// products, checked bit for bit on the card).  A warp walks
// the (group, m-tile) units warp, warp + 8, ..., group-major, and reloads
// its B fragments only when the group changes.
__device__ __forceinline__ void wide_block0(const FusedWideParams& q,
                                            const uint32_t* w0s,
                                            const float* stage,
                                            uint32_t xmid, int ty, int tx,
                                            int warp, int lane) {
  constexpr int MT = kXNPixM / 16;
  const int g = lane >> 2, t = lane & 3, t2 = 2 * t;
  const int mrow = (lane & 7) + 8 * ((lane >> 3) & 1), mnt = lane >> 4;
  const uint32_t kZero = 0u;
  int cur = -1;
  uint32_t b[9][kXNB0];  // the B fragments' channels 0..7 (8..15 are 0)
  __nv_bfloat162 bias[kXNB0];
  for (int u = warp; u < q.ng0 * MT; u += kWarps) {
    const int grp = u / MT, m0 = (u - grp * MT) * 16;
    if (grp != cur) {
      cur = grp;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int nb = 0; nb < kXNB0; ++nb)
          b[tap][nb] = w0s[((grp * 9 + tap) * kXNB0 + nb) * 32 + lane];
#pragma unroll
      for (int nb = 0; nb < kXNB0; ++nb) {
        const int n = (grp * kXNB0 + nb) * 8 + t2;
        bias[nb] = n < q.nt0 * 8
                       ? load_bias(q.b0, n)
                       : *reinterpret_cast<const __nv_bfloat162*>(&kZero);
      }
    }
    float acc[kXNB0][4];
#pragma unroll
    for (int nb = 0; nb < kXNB0; ++nb)
      acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
    // this lane's rows g and g + 8 of the m-tile (past the region: any)
    int q0[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = min(m0 + g + 8 * h, kXNPix - 1);
      q0[h] = (m / kXWM) * WideCfg::WI + m % kXWM;
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap - 3 * ky;
      uint32_t a[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = *reinterpret_cast<const float2*>(
            stage + (q0[h] + ky * WideCfg::WI + kx) * 8 + t2);
        a[h] = bf16x2_bits(v.x, v.y);
      }
#pragma unroll
      for (int nb = 0; nb < kXNB0; ++nb)
        mma_bf16_k8(acc[nb], a[0], a[1], b[tap][nb]);
    }
    uint32_t v[2][kXNB0];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int mm = m0 + g + 8 * half;
      const int y = ty - 1 + mm / kXWM, x = tx - 1 + mm % kXWM;
      const bool inside = mm < kXNPix && y >= 0 && y < q.p.height &&
                          x >= 0 && x < q.p.width;
#pragma unroll
      for (int nb = 0; nb < kXNB0; ++nb)
        v[half][nb] = inside ? bias_relu6(acc[nb][2 * half],
                                          acc[nb][2 * half + 1], bias[nb])
                             : 0u;
    }
#pragma unroll
    for (int np = 0; np < kXNB0; np += 2)
      stmatrix_x4(xmid + (grp * kXNB0 + np + mnt) * kXPlane +
                      (m0 + mrow) * 16,
                  v[0][np], v[1][np], v[0][np + 1], v[1][np + 1]);
  }
}

template <int NB1>
__global__ void __launch_bounds__(kThreads, 1)
    guidance_wide2_kernel(const __grid_constant__ CUtensorMap tmap,
                          const __grid_constant__ FusedWideParams q) {
  using C = WideCfg;
  const Params& p = q.p;
  // [barrier | staging | xmid planes | w0s | w1s]
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bar = smem_addr(smem);
  unsigned char* stage_p = smem + 128;
  unsigned char* xmid = stage_p + C::STAGE;
  uint32_t* w0s =
      reinterpret_cast<uint32_t*>(xmid + q.ng0 * kXNB0 * kXPlane);
  uint2* w1s = reinterpret_cast<uint2*>(w0s + q.ng0 * 9 * kXNB0 * 32);
  const uint32_t stage = smem_addr(stage_p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strip = warp % kXStrips, band = warp / kXStrips;
  const int ntiles = p.batch * ((p.height + C::TH - 1) / C::TH) *
                     ((p.width + C::TW - 1) / C::TW);
  const int first = blockIdx.x, step = gridDim.x;

  if (p.tma && threadIdx.x == kThreads - 1) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (first < ntiles) stage_async<C, true, 2, 8>(tmap, p, first, stage, bar);
  // both blocks' B fragments, once a block, [group][ks][tap][nb][lane]
  // (block 0: one k-step, channels 0..7), n-tiles past the packs' 0
  for (int i = threadIdx.x; i < q.ng0 * 9 * kXNB0 * 32; i += kThreads) {
    const int f = i / 32, nb = f % kXNB0, tap = f / kXNB0 % 9;
    const int nt = f / (kXNB0 * 9) * kXNB0 + nb;
    w0s[i] = nt < q.nt0 ? __ldg(q.w0 + (nt * 9 + tap) * 32 + i % 32).x : 0u;
  }
  for (int i = threadIdx.x; i < q.ng1 * q.ks1 * 9 * NB1 * 32;
       i += kThreads) {
    const int f = i / 32, nb = f % NB1, tap = f / NB1 % 9;
    const int ks = f / (NB1 * 9) % q.ks1, nt = f / (NB1 * 9 * q.ks1) * NB1 + nb;
    w1s[i] = nt < q.nt1 ? __ldg(q.w1 + ((nt * q.ks1 + ks) * 9 + tap) * 32 +
                                i % 32)
                        : make_uint2(0u, 0u);
  }
  uint32_t parity = 0;
  for (int t = first; t < ntiles; t += step) {
    stage_wait(p.tma, bar, parity);
    parity ^= 1u;
    __syncthreads();  // tile t staged, the weights too; the last reads done
    int bz, ty, tx;
    tile_origin<C>(p, t, bz, ty, tx);
    wide_block0(q, w0s, reinterpret_cast<const float*>(stage_p),
                smem_addr(xmid), ty, tx, warp, lane);
    __syncthreads();  // block 0's output staged, the staging buffer free
    if (t + step < ntiles)
      stage_async<C, true, 2, 8>(tmap, p, t + step, stage, bar);
    for (int ng = 0; ng < q.ng1; ++ng) {
      float acc[kXRows][NB1][4];
#pragma unroll
      for (int j = 0; j < kXRows; ++j)
#pragma unroll
        for (int nb = 0; nb < NB1; ++nb)
          acc[j][nb][0] = acc[j][nb][1] = acc[j][nb][2] = acc[j][nb][3] = 0.f;
      conv_rows<NB1>(smem_addr(xmid), q.ks1, w1s + ng * q.ks1 * 9 * NB1 * 32,
                     strip, band, lane, acc);
      store_rows<NB1>(p, q.b1, ng * NB1, acc, bz, ty, tx, strip, band, lane);
    }
  }
}

struct WideParams {
  Params o;  // the input (in, strides, cin, tma), the output and the frame
  const uint2* wt;  // [nt][ks][9 taps][32] x 4 bf16 (pack_layer's ``wt``)
  const __nv_bfloat16* b;
  int ks, nt;  // k-steps of 16 input channels, n-tiles of 8 outputs
  int parts;   // bf16 input: the blocks a tile is split over (NB n-tiles each)
  int stages;  // bf16 input: the k-step slices in the ring
  bool vec;  // the output by 16-byte stores (cout, ostride multiples of 8)
};

// The per-block plan's output: a warp's kXRows x 16 pixels, staged in
// shared memory a group of at most 4 n-tiles at a time (16 bytes a pixel
// and n-tile, act_off's swizzle, which is the tensor copy's swizzle for
// rows of 16 to 128 bytes: stmatrix free of bank conflicts), then written
// by one tensor store of the warp's box (lane 0, cp.async.bulk.tensor; the
// map clips the image's edges and cout)
template <int NB>
struct WideOut {
  static constexpr int R = NB < 4 ? NB : 4;  // n-tiles a round
  static constexpr int LG = log2i(R);
  static constexpr int WARP_BYTES = kXRows * 16 * R * 16;
  static constexpr int BYTES = kWarps * WARP_BYTES;
};

// wait until this warp's last tensor store has read its staging
__device__ __forceinline__ void warp_store_wait(int lane) {
  if (lane == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  __syncwarp();
}

// this warp's staging at stg, written by the warp, out by one tensor store
// of the box at (channel c0, x0, y0, image bz)
__device__ __forceinline__ void warp_tensor_store(const CUtensorMap& omap,
                                                  uint32_t stg, int c0,
                                                  int x0, int y0, int bz,
                                                  int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) {
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, "
        "%3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(&omap)),
        "r"(c0), "r"(x0), "r"(y0), "r"(bz), "r"(stg)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// n-tiles r0.. (R of them) of conv_rows' accumulators, bias and relu6
// added (bias from n-tile nt0 + r0), into the staging at stg, n-tile r of
// the round at chunk c0 + r of a pixel of 2^LG chunks, by stmatrix
template <int NB, int R, int LG>
__device__ __forceinline__ void stage_round(const Params& p,
                                            const __nv_bfloat16* bias,
                                            int nt0, int r0, int c0,
                                            float (&acc)[kXRows][NB][4],
                                            uint32_t stg, int lane) {
  const int t2 = (lane & 3) * 2;
  const int mrow = (lane & 7) + 8 * ((lane >> 3) & 1), mnt = lane >> 4;
  __nv_bfloat162 bs[R];
#pragma unroll
  for (int nb = 0; nb < R; ++nb) {
    const int n = (nt0 + r0 + nb) * 8 + t2;
    const uint32_t kZero = 0u;
    bs[nb] = n < p.cout ? load_bias(bias, n)
                        : *reinterpret_cast<const __nv_bfloat162*>(&kZero);
  }
#pragma unroll
  for (int j = 0; j < kXRows; ++j) {
    uint32_t v[2][R];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nb = 0; nb < R; ++nb)
        v[h][nb] = bias_relu6(acc[j][r0 + nb][2 * h],
                              acc[j][r0 + nb][2 * h + 1], bs[nb]);
    if constexpr (R == 1) {
      asm volatile(
          "stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1,%2};\n" ::"r"(
              stg + act_off<LG>(j * 16 + (lane & 15), c0)),
          "r"(v[0][0]), "r"(v[1][0]));
    } else {
#pragma unroll
      for (int np = 0; np < R; np += 2)
        stmatrix_x4(stg + act_off<LG>(j * 16 + mrow, c0 + np + mnt),
                    v[0][np], v[1][np], v[0][np + 1], v[1][np + 1]);
    }
  }
}

// conv_rows' accumulators of n-tiles nt0.. : bias, relu6, the channels
// below p.cout written to out, a round of WideOut<NB>::R n-tiles at a time
// through this warp's staging stg and a tensor store (omap: boxes of 8 R
// channels x 16 x kXRows pixels).  An output whose channels or stride are
// not multiples of 8 takes store_rows.
template <int NB>
__device__ __forceinline__ void store_tile(const CUtensorMap& omap,
                                           const Params& p, bool vec,
                                           const __nv_bfloat16* bias,
                                           int nt0,
                                           float (&acc)[kXRows][NB][4],
                                           uint32_t stg, int bz, int ty,
                                           int tx, int strip, int band,
                                           int lane) {
  using O = WideOut<NB>;
  if (!vec) {
    store_rows<NB>(p, bias, nt0, acc, bz, ty, tx, strip, band, lane);
    return;
  }
#pragma unroll
  for (int r0 = 0; r0 < NB; r0 += O::R) {
    warp_store_wait(lane);
    stage_round<NB, O::R, O::LG>(p, bias, nt0, r0, 0, acc, stg, lane);
    warp_tensor_store(omap, stg, (nt0 + r0) * 8, tx + strip * 16,
                      ty + band * kXRows, bz, lane);
  }
}

// The per-block plan's first block: its f32 input of at most 8 channels
// with a 1-pixel halo (66 x 10 pixels), staged as the fused wide instance
// stages its input (stage_async: a tensor copy, or cp.async for strided
// channels)
struct WideFirstCfg {
  static constexpr int TW = kXTileW, TH = kXTileH;
  static constexpr int WI = TW + 2, HI = TH + 2;
  static constexpr int STAGE = HI * WI * 8 * 4;
};
static_assert(WideFirstCfg::WI == kXWM && WideFirstCfg::HI == kXHM,
              "the staged region is the planes' region");
constexpr int kXFirstNB = 4;  // n-tiles a warp takes at a time (first block)

// The first block's output goes out by tensor stores: a warp's kXRows x
// 16 pixels staged 64 channels (a slab: two groups of kXFirstNB n-tiles)
// at a time in the box layout of the output's tensor map, 128 bytes a
// pixel with the 128-byte swizzle (act_off<3>), and written by one tensor
// store of its lane 0: whole 128-byte lines of each pixel.
constexpr int kXSlab = kXRows * 16 * 128;  // bytes of a warp's slab

// shared-memory bytes of the first block's instance for nt n-tiles: the
// alignment's slack, the warps' slabs, barrier, staging, the bf16 plane,
// the B fragments (9 taps, 8 channels: 128 bytes each) of nt rounded up
// to groups of kXFirstNB
constexpr int wide_first_smem(int nt) {
  return 1024 + kWarps * kXSlab + 128 + WideFirstCfg::STAGE + kXPlane +
         (nt + kXFirstNB - 1) / kXFirstNB * 9 * kXFirstNB * 128;
}

// group g's n-tiles of acc (bias, relu6) into this warp's slab at slab
// (channels (g % 2) 32.. of each pixel), then, at the slab's second group
// or the last one, the slab's tensor store at channel 64 (g / 2) of the
// warp's pixels
template <int NB>
__device__ __forceinline__ void slab_group(const CUtensorMap& omap,
                                           const Params& p,
                                           const __nv_bfloat16* bias, int g,
                                           bool last,
                                           float (&acc)[kXRows][NB][4],
                                           uint32_t slab, int bz, int y0,
                                           int x0, int lane) {
  static_assert(2 * NB * 8 == 64, "two groups a slab of 64 channels");
  if (g % 2 == 0) warp_store_wait(lane);  // the slab's last store read it
  stage_round<NB, NB, 3>(p, bias, g * NB, 0, (g % 2) * NB, acc, slab, lane);
  if (g % 2 == 1 || last)
    warp_tensor_store(omap, slab, g / 2 * 64, x0, y0, bz, lane);
}

// This warp's kXRows output rows of its strip for NB n-tiles of an input of
// at most 8 channels, from the bf16 plane at src; ws: the B fragments'
// channels 0..7, [tap][nb][lane].  One mma.m16n8k8 a tap: a k-step of 16
// channels whose last 8 are 0 sums the same products, in the same order
// (input row i = j + ky, then kx), as wide_block0 does.
template <int NB>
__device__ __forceinline__ void conv_first(uint32_t src, const uint32_t* ws,
                                           int strip, int band, int lane,
                                           float (&acc)[kXRows][NB][4]) {
  uint32_t b[9][NB];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      b[tap][nb] = ws[(tap * NB + nb) * 32 + lane];
  const uint32_t base =
      src + ((band * kXRows) * kXWM + strip * 16 + (lane & 15)) * 16;
#pragma unroll
  for (int i = 0; i < kXRows + 2; ++i) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      uint32_t a0, a1;  // rows g and g + 8, channels 2t, 2t + 1
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
          : "=r"(a0), "=r"(a1)
          : "r"(base + (i * kXWM + kx) * 16));
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int j = i - ky;
        if (j < 0 || j >= kXRows) continue;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mma_bf16_k8(acc[j][nb], a0, a1, b[3 * ky + kx][nb]);
      }
    }
  }
}


// The per-block plan's block from an f32 input of at most 8 channels (the
// aux): a persistent grid walking the 64 x 8 tiles; the B fragments in
// shared memory once a block; a tile's region staged by one copy issued
// while the tile before computes, rounded once into a bf16 plane; every
// n-tile group computed from that plane.
template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
    guidance_wide_first_kernel(const __grid_constant__ CUtensorMap tmap,
                               const __grid_constant__ CUtensorMap omap,
                               const __grid_constant__ WideParams q) {
  using C = WideFirstCfg;
  const Params& p = q.o;
  // [slack | slabs | barrier | staging | plane | ws: [group][tap][nb][lane]]
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t pad = (1024u - (smem_addr(smem) & 1023u)) & 1023u;
  unsigned char* slabs = smem + pad;
  const uint32_t bar = smem_addr(slabs + kWarps * kXSlab);
  unsigned char* stage_p = slabs + kWarps * kXSlab + 128;
  unsigned char* plane = stage_p + C::STAGE;
  uint32_t* ws = reinterpret_cast<uint32_t*>(plane + kXPlane);
  const uint32_t stage = smem_addr(stage_p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strip = warp % kXStrips, band = warp / kXStrips;
  // this warp's slab (a store_rows output stages nothing)
  const uint32_t slab = smem_addr(slabs) + warp * kXSlab;
  const int groups = (q.nt + NB - 1) / NB;
  const int ntiles = p.batch * ((p.height + C::TH - 1) / C::TH) *
                     ((p.width + C::TW - 1) / C::TW);
  const int first = blockIdx.x, step = gridDim.x;
  if (p.tma && threadIdx.x == kThreads - 1) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the B fragments' channels 0..7 once a block (ks == 1), n-tiles past
  // the pack's 0
  for (int i = threadIdx.x; i < groups * 9 * NB * 32; i += kThreads) {
    const int f = i / 32, nb = f % NB, tap = f / NB % 9;
    const int nt = f / (NB * 9) * NB + nb;
    ws[i] = nt < q.nt ? __ldg(q.wt + (nt * 9 + tap) * 32 + i % 32).x : 0u;
  }
  __syncthreads();
  if (first < ntiles) stage_async<C, true, 1, 8>(tmap, p, first, stage, bar);
  uint32_t parity = 0;
  for (int t = first; t < ntiles; t += step) {
    stage_wait(p.tma, bar, parity);
    parity ^= 1u;
    __syncthreads();  // tile t staged; the previous tile's plane reads done
    for (int i = threadIdx.x; i < kXNPix; i += kThreads) {
      const float4* v = reinterpret_cast<const float4*>(stage_p + i * 32);
      const float4 lo = v[0], hi = v[1];
      *reinterpret_cast<uint4*>(plane + i * 16) = make_uint4(
          bf16x2_bits(lo.x, lo.y), bf16x2_bits(lo.z, lo.w),
          bf16x2_bits(hi.x, hi.y), bf16x2_bits(hi.z, hi.w));
    }
    __syncthreads();  // the plane ready, the staging buffer free
    if (t + step < ntiles)
      stage_async<C, true, 1, 8>(tmap, p, t + step, stage, bar);
    int bz, ty, tx;
    tile_origin<C>(p, t, bz, ty, tx);
    for (int g = 0; g < groups; ++g) {
      float acc[kXRows][NB][4];
#pragma unroll
      for (int j = 0; j < kXRows; ++j)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          acc[j][nb][0] = acc[j][nb][1] = acc[j][nb][2] = acc[j][nb][3] = 0.f;
      conv_first<NB>(smem_addr(plane), ws + g * 9 * NB * 32, strip, band,
                     lane, acc);
      if (q.vec)
        slab_group<NB>(omap, p, q.b, g, g == groups - 1, acc, slab, bz,
                       ty + band * kXRows, tx + strip * 16, lane);
      else
        store_rows<NB>(p, q.b, g * NB, acc, bz, ty, tx, strip, band, lane);
    }
  }
  // the slabs' last stores done before the block leaves
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The per-block plan's ring (a block from the chain's bf16 intermediate):
// a slice is the channels of KSL k-steps (16 each) over a tile's 66 x 10
// region, 32 KSL bytes a pixel as the tensor copy lays them out with its
// 32 KSL-byte swizzle (the 16-byte piece h of pixel q at 32 KSL q + 16 (h
// ^ bits of q)), each slice 1024-byte aligned.  A block of 1 or 2 output
// n-tiles (bound by its input's bytes) takes slices of two k-steps, whose
// 64-byte rows halve the rows a tensor copy walks; the others one.
template <int NB>
struct Ring {
  static constexpr int KSL = NB <= 2 ? 2 : 1;  // k-steps a slice
  static constexpr int SLICE = kXNPix * 32 * KSL;  // 21,120 or 42,240
  static constexpr int STRIDE = (SLICE + 1023) / 1024 * 1024;
};
constexpr int kXMaxStages = 8;
// wgmma's B tiles: K-major core matrices of 8 n x 8 k (16 bytes a row),
// the one of k 8..15 kXKCore bytes past that of k 0..7 (the descriptor's
// leading offset), the next 8 n kXNCore bytes on (its stride offset)
constexpr int kXKCore = 128, kXNCore = 256;

// shared-memory bytes of the ring's instance: the alignment's slack, the
// slices, the B fragments of NB n-tiles over ks k-steps (256 bytes each),
// the output's staging, two barriers a slice
constexpr int wide_ring_smem(int ks, int nb, int stages) {
  return 1024 + stages * (nb <= 2 ? Ring<1>::STRIDE : Ring<8>::STRIDE) +
         ks * 9 * nb * 256 + kWarps * kXRows * 16 * (nb < 4 ? nb : 4) * 16 +
         stages * 16;
}

// the byte address of the 16-byte piece h of pixel q in a slice of KSL
// k-steps (the tensor copy's swizzle: bits 4.. of the address flip with
// bits 7..)
template <int KSL>
__device__ __forceinline__ uint32_t slice_addr(uint32_t slice, int q, int h) {
  const uint32_t a = slice + q * 32 * KSL + h * 16;
  return a ^ ((a >> 3) & (KSL == 1 ? 16u : 48u));
}

// One k-step of this warp's kXRows output rows of its strip for NB (1 or
// 2) n-tiles on mma.sync, from the pieces h0.. of the slice at src; wk:
// the k-step's B fragments [nb][tap][lane].  Each output adds the nine taps in order
// (input row i = j + ky, then kx), 16 channels a product, as conv_rows
// does; the nine taps' fragments stay in registers and each A fragment
// feeds every output row it is a tap of.
template <int NB>
__device__ __forceinline__ void conv_slice(uint32_t src, int h0,
                                           const uint2* wk, int strip,
                                           int band, int lane,
                                           float (&acc)[kXRows][NB][4]) {
  const int row = (lane & 7) + (lane & 8), khalf = lane >> 4;
  const int q0 = (band * kXRows) * kXWM + strip * 16 + row;
  uint2 b[9][NB];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      b[tap][nb] = wk[(nb * 9 + tap) * 32 + lane];
#pragma unroll
  for (int i = 0; i < kXRows + 2; ++i) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      uint32_t a[4];
      ldmatrix_x4(a, slice_addr<Ring<NB>::KSL>(src, q0 + i * kXWM + kx,
                                               h0 + khalf));
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int j = i - ky;
        if (j < 0 || j >= kXRows) continue;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mma_bf16(acc[j][nb], a, b[3 * ky + kx][nb]);
      }
    }
  }
}

// wgmma.m64n(8 NB)k16, f32 += bf16 x bf16, A from registers (the warp's
// 16 rows of the 64, as mma.m16n8k16's A fragment), B from shared memory
// (K-major core matrices, desc); d: the warp's C fragments of NB n-tiles
template <int NB>
__device__ __forceinline__ void wgmma_rs(float (&d)[NB][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<4>(float (&d)[4][4],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// the wgmma descriptor of a B tile at shared address addr (no swizzle)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>(kXKCore >> 4) << 16 |
         static_cast<uint64_t>(kXNCore >> 4) << 32;
}

// conv_slice's k-step on wgmma: this warpgroup's 64 pixels of each of its
// kXRows output rows (a warp a strip of 16) times the k-step's B tiles at
// wk (a tap's 16 k x 8 NB n in K-major core matrices, NB * 256 bytes).
// Each output adds the nine taps in order, 16 channels a product, as
// conv_slice does; the warpgroup waits for its products before the A
// fragments are reloaded.
template <int NB>
__device__ __forceinline__ void conv_slice_wgmma(uint32_t src, uint32_t wk,
                                                 int strip, int band,
                                                 int lane,
                                                 float (&acc)[kXRows][NB][4]) {
  const int row = (lane & 7) + (lane & 8), khalf = lane >> 4;
  const int q0 = (band * kXRows) * kXWM + strip * 16 + row;
  uint32_t a[kXRows + 2][3][4];
#pragma unroll
  for (int i = 0; i < kXRows + 2; ++i)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
      ldmatrix_x4(a[i][kx], slice_addr<1>(src, q0 + i * kXWM + kx, khalf));
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < kXRows; ++j)
      wgmma_rs<NB>(acc[j], a[j + tap / 3][tap % 3],
                   wgmma_desc(wk + tap * NB * 256));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// the ring's slice number u (tile first + (u / spt) step, slice u % spt
// of the spt a tile) into its slot at dst: one tensor copy, completing on
// the slot's full barrier
template <int NB>
__device__ __forceinline__ void issue_slice(const CUtensorMap& tmap,
                                            const WideParams& q, int spt,
                                            int first, int step, int u,
                                            uint32_t dst, uint32_t full) {
  int bz, ty, tx;
  tile_origin<WideFirstCfg>(q.o, first + u / spt * step, bz, ty, tx);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(full),
      "r"(Ring<NB>::SLICE)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&tmap)),
      "r"(u % spt * 16 * Ring<NB>::KSL), "r"(tx - 1), "r"(ty - 1), "r"(bz),
      "r"(full)
      : "memory");
}

// The per-block plan's block from the chain's bf16 intermediate (note): a
// persistent grid in which block b computes the n-tiles [NB part, NB part
// + NB) of part = b % parts for the tiles b / parts, + gridDim / parts,
// ...; its B fragments in shared memory once a block; the tiles' k-step
// slices streamed by tensor copies through a ring of ``stages`` slices (a
// full and an empty barrier each), thread 0 refilling each slot as soon
// as every warp is done with it; the product on wgmma (a warpgroup a band
// of kXRows rows) at 4 and 8 n-tiles, on mma.sync at 1 and 2.
template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
    guidance_wide_kernel(const __grid_constant__ CUtensorMap tmap,
                         const __grid_constant__ CUtensorMap omap,
                         const __grid_constant__ WideParams q) {
  const Params& p = q.o;
  // [slack | slices | the output's staging | ws: the B fragments |
  //  full[stages] | empty[stages]]
  extern __shared__ __align__(128) unsigned char smem[];
  using O = WideOut<NB>;
  using RG = Ring<NB>;
  constexpr bool kWgmma = NB >= 4;  // the product on wgmma
  const uint32_t raw = smem_addr(smem);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t slices = raw + pad;
  const uint32_t outs = slices + q.stages * RG::STRIDE;
  uint2* ws = reinterpret_cast<uint2*>(smem + pad + q.stages * RG::STRIDE +
                                       O::BYTES);
  const int nfrag = q.ks * 9 * NB;
  const uint32_t full = outs + O::BYTES + nfrag * 256;
  const uint32_t empty = full + q.stages * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strip = warp % kXStrips, band = warp / kXStrips;
  const uint32_t stg = outs + warp * O::WARP_BYTES;
  const int part = blockIdx.x % q.parts;
  const int first = blockIdx.x / q.parts, step = gridDim.x / q.parts;
  const int ntiles = p.batch * ((p.height + kXTileH - 1) / kXTileH) *
                     ((p.width + kXTileW - 1) / kXTileW);
  // the slices this block streams: spt a tile
  const int spt = (q.ks + RG::KSL - 1) / RG::KSL;
  const int nslices = (ntiles - first + step - 1) / step * spt;
  if (threadIdx.x == 0) {
    for (int s = 0; s < q.stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(full +
                                                                    8 * s));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       empty + 8 * s),
                   "r"(kWarps));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int u = 0; u < q.stages && u < nslices; ++u)
      issue_slice<NB>(tmap, q, spt, first, step, u,
                      slices + u * RG::STRIDE, full + 8 * u);
  }
  // this part's B fragments once a block, n-tiles past the pack's 0: for
  // mma.sync [ks][nb][tap][lane]; for wgmma a tile a (ks, tap) of K-major
  // core matrices, n-tile nb's at nb * kXNCore, its k 8..15 at + kXKCore
  for (int i = threadIdx.x; i < nfrag * 32; i += kThreads) {
    const int f = i / 32, tap = f % 9, nb = f / 9 % NB, ks = f / (NB * 9);
    const int nt = part * NB + nb;
    const uint2 v = nt < q.nt ? __ldg(q.wt + ((nt * q.ks + ks) * 9 + tap) *
                                                 32 + i % 32)
                              : make_uint2(0u, 0u);
    if (kWgmma) {
      uint32_t* tile = reinterpret_cast<uint32_t*>(
          reinterpret_cast<unsigned char*>(ws) + (ks * 9 + tap) * NB * 256 +
          nb * kXNCore + (i % 32 / 4) * 16 + (i % 4) * 4);
      tile[0] = v.x;             // k 2t, 2t + 1
      tile[kXKCore / 4] = v.y;   // k 2t + 8, 2t + 9
    } else {
      ws[i] = v;
    }
  }
  __syncthreads();
  int u = 0;  // the slice being computed
  for (int t = first; t < ntiles; t += step) {
    int bz, ty, tx;
    tile_origin<WideFirstCfg>(p, t, bz, ty, tx);
    float acc[kXRows][NB][4];
#pragma unroll
    for (int j = 0; j < kXRows; ++j)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        acc[j][nb][0] = acc[j][nb][1] = acc[j][nb][2] = acc[j][nb][3] = 0.f;
    for (int sj = 0; sj < spt; ++sj, ++u) {
      const int s = u % q.stages;
      const uint32_t ph = (u / q.stages) & 1u;
      // slice u - 1's slot, once every warp is done with it, takes slice
      // u - 1 + stages
      if (threadIdx.x == 0 && u > 0 && u - 1 + q.stages < nslices) {
        const int s1 = (u - 1) % q.stages;
        bar_wait(empty + 8 * s1, ((u - 1) / q.stages) & 1u);
        issue_slice<NB>(tmap, q, spt, first, step, u - 1 + q.stages,
                        slices + s1 * RG::STRIDE, full + 8 * s1);
      }
      __syncwarp();
      bar_wait(full + 8 * s, ph);  // slice u has landed
      if constexpr (kWgmma) {
        conv_slice_wgmma<NB>(slices + s * RG::STRIDE,
                             smem_addr(ws) + sj * 9 * NB * 256, strip, band,
                             lane, acc);
      } else {
#pragma unroll
        for (int kk = 0; kk < RG::KSL; ++kk) {
          const int ks = sj * RG::KSL + kk;
          if (ks < q.ks)
            conv_slice<NB>(slices + s * RG::STRIDE, 2 * kk,
                           ws + ks * 9 * NB * 32, strip, band, lane, acc);
        }
      }
      __syncwarp();
      if (lane == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                         empty + 8 * s)
                     : "memory");
    }
    store_tile<NB>(omap, p, q.vec, q.b, part * NB, acc, stg, bz, ty, tx,
                   strip, band, lane);
  }
  // the last tensor stores done before the block leaves
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the n-tiles the fused wide instance's block 1 takes at a time, of nt
int wide_nb(int nt) { return nt <= 2 ? 2 : nt == 3 ? 3 : 4; }

// Allow `bytes` of dynamic shared memory (once a device and instance).
template <class Kernel>
int allow_smem(Kernel kernel, int bytes, int (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    done[dev] = 1;
  }
  return 0;
}

// the SMs of the current device (once a device)
int device_sms(int& sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!cached[dev]) {
    e = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  sms = cached[dev];
  return 0;
}

template <int NB1>
int launch_wide2(const FusedWideParams& q, int smem, cudaStream_t stream) {
  auto kernel = guidance_wide2_kernel<NB1>;
  static int done[64] = {};
  int sms = 0;
  int rc = allow_smem(kernel, smem, done);
  if (!rc) rc = device_sms(sms);
  if (rc) return rc;
  const Params& p = q.p;
  const long long ntiles = static_cast<long long>(p.batch) *
                           ((p.height + kXTileH - 1) / kXTileH) *
                           ((p.width + kXTileW - 1) / kXTileW);
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = static_cast<int>(ntiles < sms ? ntiles : sms);
  CUtensorMap map{};
  if (p.tma) {
    rc = encode_input(p, 8, WideCfg::WI, WideCfg::HI, &map);
    if (rc) return rc;
  }
  kernel<<<grid, kThreads, smem, stream>>>(map, q);
  return (int)cudaGetLastError();
}


// the tensor map of the per-block plan's output [B, H, W, cout] (pixel
// stride ostride) for a warp's boxes of ch channels x 16 x kXRows pixels,
// with the swizzle of ch * 2-byte rows (act_off's)
int encode_output(const Params& p, int ch, CUtensorMap* map) {
  const cuuint64_t dims[4] = {(cuuint64_t)p.cout, (cuuint64_t)p.width,
                              (cuuint64_t)p.height, (cuuint64_t)p.batch};
  const cuuint64_t strides[3] = {
      (cuuint64_t)p.ostride * 2, (cuuint64_t)p.ostride * 2 * p.width,
      (cuuint64_t)p.ostride * 2 * p.width * p.height};
  const cuuint32_t box[4] = {(cuuint32_t)ch, 16, kXRows, 1};
  const CUtensorMapSwizzle swizzle =
      ch == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : ch == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
      : ch == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                 : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encode_map(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.out, dims, strides,
                    box, swizzle, map);
}

template <int NB>
int launch_wide_first(const WideParams& q, cudaStream_t stream) {
  auto kernel = guidance_wide_first_kernel<NB>;
  static int done[64] = {};
  const int smem = wide_first_smem(q.nt);
  int sms = 0;
  int rc = allow_smem(kernel, smem, done);
  if (!rc) rc = device_sms(sms);
  if (rc) return rc;
  const Params& p = q.o;
  const long long ntiles = static_cast<long long>(p.batch) *
                           ((p.height + kXTileH - 1) / kXTileH) *
                           ((p.width + kXTileW - 1) / kXTileW);
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap map{}, omap{};
  if (p.tma) {
    rc = encode_input(p, 8, WideFirstCfg::WI, WideFirstCfg::HI, &map);
    if (rc) return rc;
  }
  if (q.vec) {
    rc = encode_output(p, 64, &omap);
    if (rc) return rc;
  }
  const int grid = static_cast<int>(ntiles < sms ? ntiles : sms);
  kernel<<<grid, kThreads, smem, stream>>>(map, omap, q);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_wide(const WideParams& q, cudaStream_t stream) {
  auto kernel = guidance_wide_kernel<NB>;
  static int done[64] = {};
  const int smem = wide_ring_smem(q.ks, NB, q.stages);
  int sms = 0;
  int rc = allow_smem(kernel, smem, done);
  if (!rc) rc = device_sms(sms);
  if (rc) return rc;
  const Params& p = q.o;
  const long long ntiles = static_cast<long long>(p.batch) *
                           ((p.height + kXTileH - 1) / kXTileH) *
                           ((p.width + kXTileW - 1) / kXTileW);
  if (ntiles * q.parts > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the bf16 input [B, H, W, cin], boxes of one k-step's 16 channels over
  // the 66 x 10 region
  const cuuint64_t dims[4] = {(cuuint64_t)p.cin, (cuuint64_t)p.width,
                              (cuuint64_t)p.height, (cuuint64_t)p.batch};
  const cuuint64_t strides[3] = {
      (cuuint64_t)p.cin * 2, (cuuint64_t)p.cin * 2 * p.width,
      (cuuint64_t)p.cin * 2 * p.width * p.height};
  const cuuint32_t box[4] = {16 * Ring<NB>::KSL, kXWM, kXHM, 1};
  CUtensorMap map{}, omap{};
  rc = encode_map(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.in, dims, strides, box,
                  Ring<NB>::KSL == 1 ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : CU_TENSOR_MAP_SWIZZLE_64B,
                  &map);
  if (!rc && q.vec) rc = encode_output(p, 8 * WideOut<NB>::R, &omap);
  if (rc) return rc;
  // a tile's parts run side by side on neighbouring blocks
  const long long per = sms / q.parts > 0 ? sms / q.parts : 1;
  const int grid = static_cast<int>((ntiles < per ? ntiles : per) * q.parts);
  kernel<<<grid, kThreads, smem, stream>>>(map, omap, q);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of K7: ``layers`` (1 or 2) blocks from ``in`` to ``out``.
// in: f32 [B, H, W, cin] through the element strides (sb, sh, sw, sc) when
// f32_in, else bf16 [B, H, W, 1 << cpl0] contiguous (a previous launch's
// out).  Block 0: its K-major packed weights w0 and bias b0 (pack_layer's
// ``w`` and ``b``; read only with two blocks), input channels padded to
// 1 << cpl0 (8 to 64), nt0 n-tiles of 8 output channels.  The last block
// (block 1, or block 0 itself when layers == 1): its tap-major packed
// weights w1 (pack_layer's ``wt``) and bias b1, input channels 1 << cpl1
// (8 * nt0 with two blocks), nt1 n-tiles.  out: bf16 [B, H, W, ostride],
// channels 0..cout-1 written (cout and ostride even, cout at most
// nt1 * 8).  A non-null ``stats`` (int64 [blocks][5] with a row for each
// of up to min(132, 56 x 16 tiles) blocks) selects the statistics
// instance, which takes 8 -> 32 -> 8 only.
RT_API int rt_guidance_net(const void* in, long long sb, long long sh,
                           long long sw, long long sc, int f32_in, int cin,
                           int layers, const void* w0, const void* b0,
                           int cpl0, int nt0, const void* w1, const void* b1,
                           int cpl1, int nt1, void* out, int ostride,
                           int cout, int batch, int height, int width,
                           void* stats, void* stream) {
  if ((layers != 1 && layers != 2) || !layer_ok(cpl0, nt0) ||
      !layer_ok(cpl1, nt1) ||
      (layers == 2 && (!f32_in || (1 << cpl1) != nt0 * 8)) ||
      (layers == 1 && (cpl1 != cpl0 || nt1 != nt0)) || cin < 1 ||
      cin > (1 << cpl0) || (!f32_in && cin != (1 << cpl0)) || cout < 2 ||
      cout % 2 || cout > nt1 * 8 || ostride < cout || ostride % 2 ||
      batch < 1 || batch > 65535 || height < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.in = in;
  p.sb = sb;
  p.sh = sh;
  p.sw = sw;
  p.sc = sc;
  p.cin = cin;
  // the tensor copy takes 16-byte aligned rows of 16-byte multiples (and
  // strides below 2^40 bytes: cuTensorMapEncodeTiled refuses others)
  p.tma = f32_in && sc == 1 && cin % 4 == 0 && sw % 4 == 0 && sh % 4 == 0 &&
          sb % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  p.w0 = static_cast<const uint2*>(w0);
  p.b0 = static_cast<const __nv_bfloat16*>(b0);
  p.wl = static_cast<const uint2*>(w1);
  p.bl = static_cast<const __nv_bfloat16*>(b1);
  p.ntl = nt1;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ostride = ostride;
  p.cout = cout;
  p.batch = batch;
  p.height = height;
  p.width = width;
  p.stats = static_cast<long long*>(stats);
  return dispatch(p, f32_in != 0, layers, cpl0, nt0,
                  static_cast<cudaStream_t>(stream));
}

// Shared-memory bytes of the fused wide instance for a block 0 of nt0
// n-tiles and a block 1 of ks1 k-steps writing cout channels (what
// ops/guidance.fused_wide_smem computes); the instance takes the net when
// they are at most 232,448.
RT_API int rt_guidance_wide_fused_smem(int nt0, int ks1, int cout) {
  const int nt1 = (cout + 7) / 8, nb1 = wide_nb(nt1);
  return fused_wide_smem((nt0 + kXNB0 - 1) / kXNB0, (nt1 + nb1 - 1) / nb1,
                         nb1, ks1);
}

// One launch of the fused wide instance: a two-block net from ``in``, f32
// [B, H, W, cin] through the element strides (sb, sh, sw, sc), cin <= 8,
// to ``out``.  Block 0: its K-major pack w0 (input channels padded to 8)
// and bias b0, nt0 n-tiles; block 1: its tap-major pack w1 (ks1 k-steps of
// 16 channels, 2 ks1 <= the n-tiles block 0 stores) and bias b1, nt1
// n-tiles.  out: bf16 [B, H, W, ostride], channels 0..cout-1 written (cout
// and ostride even, cout at most nt1 * 8).
RT_API int rt_guidance_wide_fused(const void* in, long long sb, long long sh,
                                  long long sw, long long sc, int cin,
                                  const void* w0, const void* b0, int nt0,
                                  const void* w1, const void* b1, int nt1,
                                  int ks1, void* out, int ostride, int cout,
                                  int batch, int height, int width,
                                  void* stream) {
  if (cin < 1 || cin > 8 || nt0 < 1 || nt1 < 1 || ks1 < 1 || cout < 2 ||
      cout % 2 || cout > nt1 * 8 || ostride < cout || ostride % 2 ||
      batch < 1 || height < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  FusedWideParams q;
  q.nt0 = nt0;
  q.ng0 = (nt0 + kXNB0 - 1) / kXNB0;
  if (2 * ks1 > q.ng0 * kXNB0) return (int)cudaErrorInvalidValue;
  const int nb1 = wide_nb((cout + 7) / 8);
  q.ng1 = ((cout + 7) / 8 + nb1 - 1) / nb1;
  q.nt1 = nt1;
  q.ks1 = ks1;
  const int smem = fused_wide_smem(q.ng0, q.ng1, nb1, ks1);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  q.w0 = static_cast<const uint2*>(w0);
  q.b0 = static_cast<const __nv_bfloat16*>(b0);
  q.w1 = static_cast<const uint2*>(w1);
  q.b1 = static_cast<const __nv_bfloat16*>(b1);
  Params& p = q.p;
  p = Params{};
  p.in = in;
  p.sb = sb;
  p.sh = sh;
  p.sw = sw;
  p.sc = sc;
  p.cin = cin;
  p.tma = sc == 1 && cin % 4 == 0 && sw % 4 == 0 && sh % 4 == 0 &&
          sb % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ostride = ostride;
  p.cout = cout;
  p.batch = batch;
  p.height = height;
  p.width = width;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nb1) {
    case 2: return launch_wide2<2>(q, smem, s);
    case 3: return launch_wide2<3>(q, smem, s);
    default: return launch_wide2<4>(q, smem, s);
  }
}

// One launch of the per-block plan: one block from ``in`` to ``out``.  in:
// f32 [B, H, W, cin] through the element strides (sb, sh, sw, sc) with cin
// at most 8 when f32_in (the aux), else bf16 [B, H, W, cin] contiguous with
// cin a multiple of 8 (a previous launch's out, its padded channels 0).
// wt, b: the block's tap-major packed weights (pack_layer's ``wt``: ks
// k-steps of 16 input channels, at least cin of them; ks == 1 for an f32
// input) and bias (nt * 8 values).  out: bf16 [B, H, W, ostride], channels
// 0..cout-1 written (cout and ostride even, cout at most nt * 8).
RT_API int rt_guidance_wide(const void* in, long long sb, long long sh,
                            long long sw, long long sc, int f32_in, int cin,
                            const void* wt, const void* b, int ks, int nt,
                            void* out, int ostride, int cout, int batch,
                            int height, int width, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0;
  if (ks < 1 || nt < 1 || cin < 1 || cin > ks * 16 ||
      (f32_in && (cin > 8 || ks != 1)) || (!f32_in && (cin % 8 || !aligned)) ||
      cout < 2 || cout % 2 || cout > nt * 8 || ostride < cout ||
      ostride % 2 || batch < 1 || batch > 65535 || height < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  WideParams q;
  q.o = Params{};
  Params& p = q.o;
  p.in = in;
  p.sb = sb;
  p.sh = sh;
  p.sw = sw;
  p.sc = sc;
  p.cin = cin;
  // the first block's tensor copy: channels contiguous, 16-byte rows
  p.tma = f32_in && sc == 1 && cin % 4 == 0 && sw % 4 == 0 && sh % 4 == 0 &&
          sb % 4 == 0 && aligned;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ostride = ostride;
  p.cout = cout;
  p.batch = batch;
  p.height = height;
  p.width = width;
  q.wt = static_cast<const uint2*>(wt);
  q.b = static_cast<const __nv_bfloat16*>(b);
  q.ks = ks;
  q.nt = nt;
  q.parts = 1;
  q.stages = 0;
  q.vec = cout % 8 == 0 && ostride % 8 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32_in) {
    if (wide_first_smem(nt) > kSmemMax) return (int)cudaErrorInvalidValue;
    return launch_wide_first<kXFirstNB>(q, s);
  }
  // the widest n-tile group (1, 2, 4, 8) that the output needs and whose B
  // fragments leave room for two slices (the widest group's shared A
  // fragments beat a deeper ring)
  int nb = nt <= 1 ? 1 : nt <= 2 ? 2 : nt <= 4 ? 4 : 8;
  while (nb > 1 && wide_ring_smem(ks, nb, 2) > kSmemMax) nb /= 2;
  if (wide_ring_smem(ks, nb, 2) > kSmemMax) return (int)cudaErrorInvalidValue;
  q.parts = (nt + nb - 1) / nb;
  q.stages = 2;
  while (q.stages < kXMaxStages &&
         wide_ring_smem(ks, nb, q.stages + 1) <= kSmemMax)
    ++q.stages;
  switch (nb) {
    case 1: return launch_wide<1>(q, s);
    case 2: return launch_wide<2>(q, s);
    case 4: return launch_wide<4>(q, s);
    default: return launch_wide<8>(q, s);
  }
}
