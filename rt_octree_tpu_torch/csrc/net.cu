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
// intermediate never reaches device memory.  Design: one launch for a
// two-block net.  A block of 8 warps owns a 16x16 tile of output pixels:
//   1. it stages the input tile with a 2-pixel halo in shared memory,
//      rounded to bf16 as it is read (through the input's strides; as
//      float4 where the channels are contiguous), zero outside the image
//      and in the padded channels;
//   2. it computes block 0 on the tile plus a 1-pixel halo (18x18, 27 %
//      recomputed) into shared memory, writing 0 where the halo leaves the
//      image (block 1's zero padding);
//   3. it computes block 1 on the tile and writes its channels.
// Both products are implicit GEMMs on mma.sync.m16n8k16 (bf16 in, f32
// accumulate): M = 16 pixels, N = 8 output channels an n-tile, K = the
// 3x3 taps x the input channels padded to CP (8, 16, 32 or 64), tap-major,
// padded to a multiple of 16 with zero weights.  Each k-step's A fragment
// is one ldmatrix.x4: an 8-wide k half is 8 channels of one tap, 16
// contiguous bytes of one pixel in shared memory (pixels CP + 8 channels
// apart for CP > 8, so the 8 rows of a matrix fall in distinct banks).  The
// B fragments are packed once on the host in the mma's own lane order
// (ops/guidance.py:pack_layer) and read as one 8-byte load a lane, through
// the read-only cache, once for the two 16-pixel chunks that a warp
// computes together (the biases once a block, into registers).  One or
// two blocks run in one launch; a deeper net
// runs as a chain of one-block launches whose bf16 intermediates keep
// their padded channels (0) so that the next launch reads whole 16-byte
// groups.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kTile = 16;  // output tile: kTile x kTile pixels
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 2;  // pixel chunks a warp computes at once

struct Layer {
  const uint2* w;           // [ks][nt][32 lanes] x 4 bf16 (pack_layer)
  const __nv_bfloat16* b;   // [nt * 8]
  int cpl;                  // log2 of the padded input channels CP
  int ks;                   // k-steps: ceil(9 * CP / 16)
};

struct Params {
  const void* in;  // f32 [B, H, W, cin] through strides, or bf16 [B, H, W, CP]
  long long sb, sh, sw, sc;  // element strides of the f32 input
  int cin;
  bool vec4;  // f32 input read as float4: channels contiguous, aligned
  Layer l0, l1;
  __nv_bfloat16* out;  // [B, H, W, ostride]
  int ostride, cout;   // channels a pixel in out, channels written
  int height, width;
};

// bf16 elements between two pixels of a staged tile (module note)
__host__ __device__ __forceinline__ int pixel_stride(int cp) {
  return cp == 8 ? 8 : cp + 8;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// bf16_rn(bf16_rn(y) + b) for a bf16 bias b, then relu6 (NaN passes, as
// jnp.maximum's)
__device__ __forceinline__ float bias_relu6(float y, float b) {
  const float z = __bfloat162float(__float2bfloat16_rn(
      __fadd_rn(__bfloat162float(__float2bfloat16_rn(y)), b)));
  return z < 0.f ? 0.f : (z > 6.f ? 6.f : z);
}

// One block's conv on up to kChunks chunks of 16 destination pixels, chunk
// c = ``first + c * kWarps`` for c < nvalid, of a region ``dst_w`` pixels
// wide and ``n_dst`` pixels in all, reading the staged source region
// (``dst_w + 2`` wide, a 1-pixel halo around it): acc[c][nt] is the mma's
// C fragment of chunk c, n-tile nt.  Each B fragment is loaded once for
// the warp's chunks.
template <int NT>
__device__ __forceinline__ void conv_chunks(const __nv_bfloat16* src,
                                            int dst_w, int n_dst, int first,
                                            int nvalid, const Layer& l,
                                            int lane,
                                            float (&acc)[kChunks][NT][4]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[c][nt][0] = acc[c][nt][1] = acc[c][nt][2] = acc[c][nt][3] = 0.f;
  // ldmatrix: lane l gives the row of matrix l / 8: pixels 0-7 / 8-15
  // (bit 3), k half 0 / 1 (bit 4)
  const int m = (lane & 7) + (lane & 8);
  const int src_w = dst_w + 2, ps = pixel_stride(1 << l.cpl);
  uint32_t base[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    // past the end: any pixel (not written)
    const int p = min((first + c * kWarps) * 16 + m, n_dst - 1);
    base[c] = static_cast<uint32_t>(__cvta_generic_to_shared(
        src + ((p / dst_w) * src_w + p % dst_w) * ps));
  }
  const int cmask = (1 << l.cpl) - 1;
  const uint2* w = l.w + lane;
#pragma unroll 2
  for (int ks = 0; ks < l.ks; ++ks) {
    const int k0 = ks * 16 + (lane & 16) / 2;
    const int tap = min(k0 >> l.cpl, 8);  // K padding: its weights are 0
    const int ky = tap / 3, kx = tap - 3 * ky;
    const uint32_t off = ((ky * src_w + kx) * ps + (k0 & cmask)) * 2;
    uint32_t a[kChunks][4];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (c < nvalid) ldmatrix_x4(a[c], base[c] + off);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b = __ldg(w + (ks * NT + nt) * 32);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        if (c < nvalid) mma_bf16(acc[c][nt], a[c], b);
    }
  }
}

// this lane's bias pairs (C fragment columns t2, t2 + 1 of each n-tile)
template <int NT>
__device__ __forceinline__ void load_bias(const __nv_bfloat16* b, int t2,
                                          float2 (&out)[NT]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    out[nt] = make_float2(__bfloat162float(b[nt * 8 + t2]),
                          __bfloat162float(b[nt * 8 + t2 + 1]));
}

template <bool F32_IN, int NL, int NT0, int NT1>
__global__ void __launch_bounds__(kThreads)
    guidance_net_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int IW = kTile + 2 * NL;  // staged input tile, square
  constexpr int MW = kTile + 2;       // block 0's region when NL == 2
  const int cp0 = 1 << p.l0.cpl, ps0 = pixel_stride(cp0);
  __nv_bfloat16* xin = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xmid = xin + IW * IW * ps0;
  const int bz = blockIdx.z;
  const int ty = blockIdx.y * kTile, tx = blockIdx.x * kTile;
  const int H = p.height, W = p.width;

  // 1. the input tile with an NL-pixel halo, bf16, zero outside
  if (F32_IN && p.vec4) {
    const float* in = static_cast<const float*>(p.in) + bz * p.sb;
    const int V = cp0 / 4;  // groups of 4 channels a pixel
    for (int i = threadIdx.x; i < IW * IW * V; i += kThreads) {
      const int c = (i % V) * 4, pix = i / V;
      const int y = ty - NL + pix / IW, x = tx - NL + pix % IW;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < p.cin && y >= 0 && y < H && x >= 0 && x < W)
        v = *reinterpret_cast<const float4*>(in + y * p.sh + x * p.sw + c);
      __nv_bfloat162* d =
          reinterpret_cast<__nv_bfloat162*>(xin + pix * ps0 + c);
      d[0] = __floats2bfloat162_rn(v.x, v.y);
      d[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  } else if (F32_IN) {
    const float* in = static_cast<const float*>(p.in) + bz * p.sb;
    for (int i = threadIdx.x; i < IW * IW * cp0; i += kThreads) {
      const int c = i & (cp0 - 1), pix = i >> p.l0.cpl;
      const int y = ty - NL + pix / IW, x = tx - NL + pix % IW;
      float v = 0.f;
      if (c < p.cin && y >= 0 && y < H && x >= 0 && x < W)
        v = in[y * p.sh + x * p.sw + c * p.sc];
      xin[pix * ps0 + c] = __float2bfloat16_rn(v);
    }
  } else {
    const int V = cp0 / 8;  // 16-byte groups a pixel
    const uint4* in = static_cast<const uint4*>(p.in) +
                      static_cast<long long>(bz) * H * W * V;
    for (int i = threadIdx.x; i < IW * IW * V; i += kThreads) {
      const int v = i % V, pix = i / V;
      const int y = ty - NL + pix / IW, x = tx - NL + pix % IW;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (y >= 0 && y < H && x >= 0 && x < W)
        val = in[(static_cast<long long>(y) * W + x) * V + v];
      *reinterpret_cast<uint4*>(xin + pix * ps0 + v * 8) = val;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t2 = (lane % 4) * 2;  // C fragment: row, column

  // 2. block 0 on the tile and a 1-pixel halo, into shared memory
  if (NL == 2) {
    constexpr int n1 = (MW * MW + 15) / 16;  // chunks
    const int ps1 = pixel_stride(1 << p.l1.cpl);
    float2 bias[NT0];
    load_bias<NT0>(p.l0.b, t2, bias);
    for (int first = warp; first < n1; first += kChunks * kWarps) {
      const int nvalid = min(kChunks, (n1 - first + kWarps - 1) / kWarps);
      float acc[kChunks][NT0][4];
      conv_chunks<NT0>(xin, MW, MW * MW, first, nvalid, p.l0, lane, acc);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (c >= nvalid) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pix = (first + c * kWarps) * 16 + g + 8 * half;
          if (pix >= MW * MW) continue;
          const int r = pix / MW, col = pix % MW;
          const int y = ty - 1 + r, x = tx - 1 + col;
          const bool inside = y >= 0 && y < H && x >= 0 && x < W;
#pragma unroll
          for (int nt = 0; nt < NT0; ++nt) {
            __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
            if (inside)
              v = __floats2bfloat162_rn(
                  bias_relu6(acc[c][nt][2 * half], bias[nt].x),
                  bias_relu6(acc[c][nt][2 * half + 1], bias[nt].y));
            *reinterpret_cast<__nv_bfloat162*>(xmid + pix * ps1 + nt * 8 +
                                               t2) = v;
          }
        }
      }
    }
    __syncthreads();
  }

  // 3. the last block on the tile, written to out
  constexpr int NTL = NL == 2 ? NT1 : NT0;
  constexpr int n2 = kTile * kTile / 16;  // chunks, kChunks a warp
  static_assert(n2 == kChunks * kWarps, "one pass over the tile");
  const Layer last = NL == 2 ? p.l1 : p.l0;
  const __nv_bfloat16* src = NL == 2 ? xmid : xin;
  __nv_bfloat16* out = p.out + static_cast<long long>(bz) * H * W * p.ostride;
  float2 bias[NTL];
  load_bias<NTL>(last.b, t2, bias);
  float acc[kChunks][NTL][4];
  conv_chunks<NTL>(src, kTile, kTile * kTile, warp, kChunks, last, lane, acc);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pix = (warp + c * kWarps) * 16 + g + 8 * half;
      const int y = ty + pix / kTile, x = tx + pix % kTile;
      if (y >= H || x >= W) continue;
      __nv_bfloat16* o = out + (static_cast<long long>(y) * W + x) *
                                   p.ostride;
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        const int n = nt * 8 + t2;
        if (n >= p.cout) continue;  // cout is even: n + 1 < cout too
        *reinterpret_cast<__nv_bfloat162*>(o + n) = __floats2bfloat162_rn(
            bias_relu6(acc[c][nt][2 * half], bias[nt].x),
            bias_relu6(acc[c][nt][2 * half + 1], bias[nt].y));
      }
    }
  }
}

template <bool F32_IN, int NL, int NT0, int NT1>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int IW = kTile + 2 * NL, MW = kTile + 2;
  const int bytes =
      (IW * IW * pixel_stride(1 << p.l0.cpl) +
       (NL == 2 ? MW * MW * pixel_stride(1 << p.l1.cpl) : 0)) * 2;
  auto kernel = guidance_net_kernel<F32_IN, NL, NT0, NT1>;
  if (bytes > 48 * 1024) {  // at most 104,832 bytes (CP 64 at both blocks)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((p.width + kTile - 1) / kTile,
                  (p.height + kTile - 1) / kTile, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NT0>
int launch_pair(const Params& p, int nt1, int batch, cudaStream_t s) {
  switch (nt1) {
    case 1: return launch<true, 2, NT0, 1>(p, batch, s);
    case 2: return launch<true, 2, NT0, 2>(p, batch, s);
    case 4: return launch<true, 2, NT0, 4>(p, batch, s);
    case 8: return launch<true, 2, NT0, 8>(p, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}

// the template instance for the n-tiles of block 0 (and block 1)
int dispatch(const Params& p, bool f32_in, int layers, int nt0, int nt1,
             int batch, cudaStream_t s) {
#define RT_NET_CASE(NT)                                           \
  case NT:                                                        \
    if (layers == 2) return launch_pair<NT>(p, nt1, batch, s);    \
    if (f32_in) return launch<true, 1, NT, 1>(p, batch, s);       \
    return launch<false, 1, NT, 1>(p, batch, s);
  switch (nt0) {
    RT_NET_CASE(1)
    RT_NET_CASE(2)
    RT_NET_CASE(4)
    RT_NET_CASE(8)
  }
#undef RT_NET_CASE
  return (int)cudaErrorInvalidValue;
}

bool layer_ok(int cpl, int nt) {
  return cpl >= 3 && cpl <= 6 && (nt == 1 || nt == 2 || nt == 4 || nt == 8);
}

}  // namespace

// One launch of K7: ``layers`` (1 or 2) blocks from ``in`` to ``out``.
// in: f32 [B, H, W, cin] through the element strides (sb, sh, sw, sc) when
// f32_in, else bf16 [B, H, W, 1 << cpl0] contiguous (a previous launch's
// out).  Block i: packed weights w_i, bias b_i (pack_layer), input
// channels padded to 1 << cpl_i (8 to 64), nt_i n-tiles of 8 output
// channels; a second block's input is the first's output
// (1 << cpl1 == 8 * nt0).  out:
// bf16 [B, H, W, ostride], channels 0..cout-1 written (cout and ostride
// even, cout at most the last block's nt * 8).
RT_API int rt_guidance_net(const void* in, long long sb, long long sh,
                           long long sw, long long sc, int f32_in, int cin,
                           int layers, const void* w0, const void* b0,
                           int cpl0, int nt0, const void* w1, const void* b1,
                           int cpl1, int nt1, void* out, int ostride,
                           int cout, int batch, int height, int width,
                           void* stream) {
  const int nt_last = layers == 2 ? nt1 : nt0;
  if ((layers != 1 && layers != 2) || !layer_ok(cpl0, nt0) ||
      (layers == 2 && (!f32_in || !layer_ok(cpl1, nt1) ||
                       (1 << cpl1) != nt0 * 8)) ||
      cin < 1 || cin > (1 << cpl0) || (!f32_in && cin != (1 << cpl0)) ||
      cout < 2 || cout % 2 || cout > nt_last * 8 || ostride < cout ||
      ostride % 2 ||
      batch < 1 || batch > 65535 || height < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.in = in;
  p.sb = sb;
  p.sh = sh;
  p.sw = sw;
  p.sc = sc;
  p.cin = cin;
  p.vec4 = f32_in && sc == 1 && cin % 4 == 0 && sw % 4 == 0 &&
           sh % 4 == 0 && sb % 4 == 0 &&
           reinterpret_cast<uintptr_t>(in) % 16 == 0;
  p.l0 = {static_cast<const uint2*>(w0),
          static_cast<const __nv_bfloat16*>(b0), cpl0,
          (9 * (1 << cpl0) + 15) / 16};
  const int cpl_1 = layers == 2 ? cpl1 : 3;  // unused with one block
  p.l1 = {static_cast<const uint2*>(w1),
          static_cast<const __nv_bfloat16*>(b1), cpl_1,
          (9 * (1 << cpl_1) + 15) / 16};
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ostride = ostride;
  p.cout = cout;
  p.height = height;
  p.width = width;
  return dispatch(p, f32_in != 0, layers, nt0, nt1, batch,
                  static_cast<cudaStream_t>(stream));
}
