// K2: the multi-level guided softmax filter (the denoiser's reconstruction),
// fed straight from the GuidanceNet's last activation; K5 and K6: the same
// filter batched for training, and its backward (after K2's entry below).
//
// Replaces rt_octree_tpu/ops/filtering.py:guided_filter (:153-185) with its
// exact path _filter_all_exact/_level_exact/_window_max (:50-77, :128-133),
// and the split of the net's output (models/guidance_net.py:138-143); the
// reference kernel is filtering.cu:108-228.
//
// Input: the net's last bf16 activation x [1, 2L, H, W], read through its
// strides (K7 hands it over channels last; nothing is copied).  Prologue, per pixel: the level weights w = softmax(x[:L]) in
// f32; the guidance g[l] = x[L + l] cast to f32.  Then for each level l with
// support s (window 2s+1):
//   gmax = max of g[l] over the in-image window,
//   f    = sum_q exp(g_q - gmax) rgb_q / sum_q exp(g_q - gmax),
//   out += w[l] * f;
// a support-0 level is the pixel itself (the 1x1 softmax is the identity),
// and output alpha is 1.  The per-window max keeps every window's dominant
// logit at exp(0), so no global-range guard is needed (the JAX fast path's
// FAST_SAFE_RANGE fallback, filtering.py:169-183, has no counterpart here).
//
// Bound on this card: the inputs and the output once (the activation at
// 2 B, rgb and out at 16 B a pixel: 30.7 MB at 800x800 with L=4) and one
// expf per window tap (9+25+49 taps a pixel at supports 0..3).  Design: a
// block owns a 32x8 output tile, one pixel a thread.  It stages the tile
// plus a halo of max(s) pixels in shared memory once as float4 (rgb in
// .xyz); each level writes its guidance into .w, so one 16-byte load feeds
// a tap.  The window max is separable (rows, then columns; max is exact in
// any order), and the sums run over shared memory in the dy-outer /
// dx-inner order of the plain version, unrolled for each support 1..8 (a
// template per support; the reference ladder 1..L reaches 8 at L = 8).  Taps outside the image hold
// guidance -inf and rgb 0, so they add exp(-inf) = 0.  Without fast math:
// expf, IEEE division.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSupport = 8;  // the reference ladder 1..L at L = 8
constexpr int kTileW = 32, kTileH = 8;

struct Supports {
  int s[kMaxLevels];
};

// One level of support S, after its guidance is staged in tile[].w: the
// row pass of the window max into rmax, then (pixels inside the image) the
// column pass and the exp-weighted sums, unrolled over the window.  Writes
// the filtered rgb, the window max and the denominator (K2 drops the last
// two).
template <int S>
__device__ __forceinline__ void filter_level(const float4* tile, float* rmax,
                                             int R, int TW, int tx, int ty,
                                             bool inside, float& f0,
                                             float& f1, float& f2,
                                             float& m_out, float& den_out) {
  for (int i = ty * kTileW + tx; i < (kTileH + 2 * S) * kTileW;
       i += kTileW * kTileH) {
    const int r = R - S + i / kTileW, c = i % kTileW;
    const float4* row = tile + r * TW + R + c;
    float m = -INFINITY;
#pragma unroll
    for (int dx = -S; dx <= S; ++dx) m = fmaxf(m, row[dx].w);
    rmax[r * kTileW + c] = m;
  }
  __syncthreads();
  if (!inside) return;
  float gmax = -INFINITY;
#pragma unroll
  for (int dy = -S; dy <= S; ++dy)
    gmax = fmaxf(gmax, rmax[(ty + R + dy) * kTileW + tx]);
  float n0 = 0.f, n1 = 0.f, n2 = 0.f, den = 0.f;
  const float4* centre = tile + (ty + R) * TW + tx + R;
#pragma unroll
  for (int dy = -S; dy <= S; ++dy) {
    const float4* row = centre + dy * TW;
#pragma unroll
    for (int dx = -S; dx <= S; ++dx) {
      const float4 q = row[dx];
      const float k = expf(q.w - gmax);
      den = den + k;
      n0 = n0 + q.x * k;
      n1 = n1 + q.y * k;
      n2 = n2 + q.z * k;
    }
  }
  f0 = n0 / den;
  f1 = n1 / den;
  f2 = n2 / den;
  m_out = gmax;
  den_out = den;
}

// A level's filter_level<S> for S = 1..8, chosen at run time.
__device__ __forceinline__ void filter_level_s(int s, const float4* tile,
                                               float* rmax, int R, int TW,
                                               int tx, int ty, bool inside,
                                               float& f0, float& f1,
                                               float& f2, float& m,
                                               float& den) {
  switch (s) {
    case 1: filter_level<1>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2, m, den); break;
    case 2: filter_level<2>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2, m, den); break;
    case 3: filter_level<3>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2, m, den); break;
    case 4: filter_level<4>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2, m, den); break;
    case 5: filter_level<5>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2, m, den); break;
    case 6: filter_level<6>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2, m, den); break;
    case 7: filter_level<7>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2, m, den); break;
    default: filter_level<8>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2, m, den); break;
  }
}

// Four blocks an SM: the unrolled windows would otherwise take 128
// registers a thread and leave two.
__global__ void __launch_bounds__(kTileW* kTileH, 4) guided_filter_kernel(
    const __nv_bfloat16* __restrict__ act, long long sc, long long sh,
    long long sw, const float4* __restrict__ img, float4* __restrict__ out,
    int levels, Supports sup, int R, int H, int W) {
  extern __shared__ float4 tile[];  // [TH][TW]: rgb, the level's guidance in .w
  const int TW = kTileW + 2 * R, TH = kTileH + 2 * R;
  float* rmax = reinterpret_cast<float*>(tile + TH * TW);  // [TH][kTileW]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;

  // ---- rgb of the tile and its halo ----
  for (int r = ty; r < TH; r += kTileH) {
    const int gy = y0 - R + r;
    for (int c = tx; c < TW; c += kTileW) {
      const int gx = x0 - R + c;
      tile[r * TW + c] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                             ? img[(long long)gy * W + gx]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // ---- prologue: softmax over the L weight channels (max, then sum) ----
  const __nv_bfloat16* px = act + (long long)y * sh + (long long)x * sw;
  float wmax = -INFINITY, wsum = 0.f;
  if (inside) {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l)
      if (l < levels) wmax = fmaxf(wmax, __bfloat162float(px[l * sc]));
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l)
      if (l < levels) wsum = wsum + expf(__bfloat162float(px[l * sc]) - wmax);
  }

  float o0 = 0.f, o1 = 0.f, o2 = 0.f;
  for (int l = 0; l < levels; ++l) {
    const int s = sup.s[l];
    __syncthreads();  // rgb staged; the previous level's reads are done
    float f0 = 0.f, f1 = 0.f, f2 = 0.f;
    if (s == 0) {
      const float4 q = tile[(ty + R) * TW + tx + R];
      f0 = q.x;
      f1 = q.y;
      f2 = q.z;
    } else {
      const __nv_bfloat16* g = act + (levels + l) * sc;
      for (int r = ty; r < TH; r += kTileH) {
        const int gy = y0 - R + r;
        for (int c = tx; c < TW; c += kTileW) {
          const int gx = x0 - R + c;
          tile[r * TW + c].w = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                                   ? __bfloat162float(g[gy * sh + gx * sw])
                                   : -INFINITY;
        }
      }
      __syncthreads();
      float m, den;
      filter_level_s(s, tile, rmax, R, TW, tx, ty, inside, f0, f1, f2, m,
                     den);
    }
    if (!inside) continue;
    const float wl = expf(__bfloat162float(px[l * sc]) - wmax) / wsum;
    o0 = o0 + wl * f0;
    o1 = o1 + wl * f1;
    o2 = o2 + wl * f2;
  }
  if (inside) out[(long long)y * W + x] = make_float4(o0, o1, o2, 1.f);
}

}  // namespace

// act: bf16 [1, 2L, H, W] at element strides (sc, sh, sw) of its channel,
// row and column; img: f32 [H, W, 4]; out: f32 [H, W, 4]; supports: host
// array of L ints (L <= 8).
RT_API int rt_guided_filter(const void* act, long long sc, long long sh,
                            long long sw, const void* img, void* out,
                            int levels, const int* supports, int height,
                            int width, void* stream) {
  if (levels < 1 || levels > kMaxLevels || height < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  Supports sup{};
  int R = 0;
  for (int l = 0; l < levels; ++l) {
    if (supports[l] < 0 || supports[l] > kMaxSupport)
      return (int)cudaErrorInvalidValue;
    sup.s[l] = supports[l];
    R = supports[l] > R ? supports[l] : R;
  }
  // at most (8 + 16) x (32 + 16) x 16 + 24 x 32 x 4 = 21504 bytes
  const int bytes = (kTileH + 2 * R) * (kTileW + 2 * R) * 16 +
                    (kTileH + 2 * R) * kTileW * 4;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (height + kTileH - 1) / kTileH);
  guided_filter_kernel<<<grid, block, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)act, sc, sh, sw, (const float4*)img,
      (float4*)out, levels, sup, R, height, width);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide instances of K2, K5 and K6 for the nets the unrolled instances do
// not take: more than 8 levels (up to kWideMaxLevels), a support above 8 (up
// to kWideMaxSupport), and for K5 / K6 batches whose B or B x L passes
// 65535.  The supports ride in a kWideMaxLevels array; shared memory grows
// with the halo R (the largest support): above 48 KB the kernel is allowed
// more first.  K2's wide instance is at the end of this file (it computes
// the fast form, with K5's numerics); K5's and K6's are after theirs.
// ---------------------------------------------------------------------------

namespace {

constexpr int kWideMaxLevels = 64;
constexpr int kWideMaxSupport = 32;
constexpr int kSmemOptin = 232448;  // 227 KB a block

struct WideSupports {
  int s[kWideMaxLevels];
};

// The supports into `sup` and their largest as the halo R; false if a
// count or a support is out of the wide instances' range.
bool wide_supports(int levels, const int* supports, WideSupports& sup,
                   int& R) {
  if (levels < 1 || levels > kWideMaxLevels) return false;
  sup = WideSupports{};
  R = 0;
  for (int l = 0; l < levels; ++l) {
    if (supports[l] < 0 || supports[l] > kWideMaxSupport) return false;
    sup.s[l] = supports[l];
    R = supports[l] > R ? supports[l] : R;
  }
  return true;
}

// Allow `bytes` of dynamic shared memory where they pass the 48 KB default.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes > kSmemOptin) return cudaErrorInvalidValue;
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

}  // namespace

// ---------------------------------------------------------------------------
// K5 and K6: the batched filter of the training step and its backward.
//
// They replace rt_octree_tpu/ops/filtering.py:guided_filter_batch (:188,
// jax.vmap of guided_filter) on the path the JAX training step runs, the
// fast one (:135-148, :169-183: one stabiliser, separable shifted-add box
// sums, a runtime guard of FAST_SAFE_RANGE nats that falls back to the
// per-window form), and its autodiff backward with the stabiliser under
// stop_gradient (:139-140); the reference's analytic backward is
// filtering.cu:230-301.  Both forms give the same function.
//
// K5 (guided_filter_batch_kernel): weight and guidance f32 [B, L, H, W],
// read through their element strides with rows contiguous (the net's
// channel slices in place), img f32 [B, H, W, 4] -> out [B, H, W, 4]
// (alpha 1), the level weights given (no softmax).  Per level of support
// s > 0 it also writes what the backward needs: fm [B, L, H, W, 4] =
// (f_r, f_g, f_b, m) and den [B, L, H, W] = D, the softmax denominator
// taken against the stabiliser m (support-0 levels write none).  K6 reads
// only exp(g_q - m_p) / D_p, which does not depend on the choice of m.
//
// K6 (guided_filter_batch_bwd_kernel): G = dL/dout [B, H, W, 4] (rgb read)
// ->  dL/dw_lp = G_p . f_lp  and, with a_p = w_lp / D_p, u_p = a_p G_p and
// v_p = a_p G_p . f_lp,
//   dL/dg_q = sum_{p in N(q)} exp(g_q - m_p) (u_p . x_q - v_p),
// 0 on support-0 levels.  q in N(p) <=> p in N(q) (both windows clipped
// to the image), so each pixel gathers over its own window: no atomics,
// and the sum's order is fixed.
//
// Design.  A block of 160 threads owns a 40x16 output tile (an 80-pixel
// slice is two tiles across, five down): in K5 for every level in turn
// (the output blends them), in K6 for one level (the levels' gradients
// are independent, so the card interleaves them); a thread owns a run of
// 4 outputs down one column.  Per level of support s the
// staged region is the tile and a halo of s, clipped to the image, and one
// block-wide reduction gives its largest and smallest value.
//  - K5: c = the largest guidance.  While the staged guidance spans less
//    than 60 nats (kGuardRange, the JAX package's FAST_SAFE_RANGE: every
//    window's dominant term stays >= exp(-60)), e = exp(g - c) is taken
//    once per staged pixel and the window sums of (e rgb, e) are 2s+1
//    shifted adds along rows, then down columns (no running difference,
//    which cancels); m = c.  Else the tile takes the guard, the per-window
//    form: m = the window max (separable), one expf a tap.
//  - K6: c' = the smallest saved m over the region.  While the saved m
//    span less than 60 nats, dL/dg_q = exp(g_q - c') (x_q . U_q - V_q),
//    with U, V the same separable sums of E_p (u_p, v_p), E_p =
//    exp(c' - m_p) <= 1 taken as the row pass reads them; g_q <= m_p for
//    p in N(q), so the factor stays below exp(60).  Else the per-tap
//    gather.
//  - Register blocking: in the row pass a thread makes 8 outputs of a row
//    from 8 + 2s staged pixels, in the column pass 4 outputs of a column
//    from 4 + 2s row sums, each output a fresh sum in tap order.  The
//    staged arrays' rows have an odd pitch, so lanes that walk down rows
//    hit distinct banks.  K5 stages the next level's guidance and weight
//    by cp.async behind this level's sums (two buffers).  A tile and
//    level that takes the guard adds one to an optional counter.
//  - Each kernel has an instance for supports up to 4 (the training
//    ladder) and one up to 8; the entry picks by the largest support, so
//    the common instance carries no code (or registers) for wide windows.
//
// Bound on this card: bytes.  K5 reads weight, guidance (8 B a pixel and
// level) and img (16 B), writes out (16 B) and fm, den (20 B a pixel and
// level); K6 reads G, img (32 B), weight, guidance, fm, den (28 B a pixel
// and level) and writes two gradients (8 B a pixel and level).  Without
// fast math: expf, IEEE division.
// ---------------------------------------------------------------------------

namespace {

constexpr int kBatchTileW = 40, kBatchTileH = 16;  // ops/filtering.py
constexpr int kRowRun = 8, kColRun = 4;  // outputs a thread sums a pass
constexpr int kBThreads = kBatchTileW * kBatchTileH / kColRun;  // 160
constexpr int kBWarps = kBThreads / 32;
constexpr int kHP = kBatchTileW + 1;  // row-sum pitch (odd)
constexpr float kGuardRange = 60.f;
static_assert(kBatchTileW % kRowRun == 0 && kBatchTileH % kColRun == 0,
              "tile");
static_assert((kBatchTileH + 2 * kMaxSupport) * (kBatchTileW / kRowRun) <=
                  kBThreads,
              "the row pass takes one round");

struct Strides {  // element strides of batch, level and row (columns: 1)
  long long b, l, h;
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

// The block's largest mx and smallest mn, in every thread (one
// __syncthreads; red holds 2 * kBWarps floats).
__device__ __forceinline__ void block_max_min(float& mx, float& mn,
                                              float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = mx;
    red[kBWarps + warp] = mn;
  }
  __syncthreads();
  mx = red[0];
  mn = red[kBWarps];
#pragma unroll
  for (int w = 1; w < kBWarps; ++w) {
    mx = fmaxf(mx, red[w]);
    mn = fminf(mn, red[kBWarps + w]);
  }
}

// acc[o] = x[o] + x[o + 1] + ... + x[o + 2S], in that order, for o < N, as
// the N + 2S inputs x[i] = load(i) arrive one by one.
template <int N, int S, class Load>
__device__ __forceinline__ void run_sums(float4 (&acc)[N], Load load) {
#pragma unroll
  for (int i = 0; i < N + 2 * S; ++i) {
    const float4 x = load(i);
#pragma unroll
    for (int o = 0; o < N; ++o) {
      if (o == i)
        acc[o] = x;
      else if (o < i && i <= o + 2 * S)
        acc[o] = add4(acc[o], x);
    }
  }
}

// The separable window sums of a level of support S whose staged values
// are x(region index) = load(region index): the row pass into hs, then
// this thread's column run.  org is the region's (0, 0) in the staged
// arrays of pitch P.
template <int S, class Load>
__device__ __forceinline__ void window_sums(float4* hs, int org, int P,
                                            float4 (&acc)[kColRun],
                                            Load load) {
  constexpr int RW = kBatchTileH + 2 * S;
  const int tid = threadIdx.x;
  if (tid < RW * (kBatchTileW / kRowRun)) {
    const int r = tid % RW, c0 = tid / RW * kRowRun;
    const int base = org + r * P + c0;
    float4 h[kRowRun];
    run_sums<kRowRun, S>(h, [&](int i) { return load(base + i); });
#pragma unroll
    for (int o = 0; o < kRowRun; ++o) hs[r * kHP + c0 + o] = h[o];
  }
  __syncthreads();
  const int col = tid % kBatchTileW, run = tid / kBatchTileW;
  run_sums<kColRun, S>(
      acc, [&](int i) { return hs[(run * kColRun + i) * kHP + col]; });
}

// One K5 level of support S: its guidance staged in gs (halo R, pitch P,
// -inf outside the image), rgb in rgbs.  This thread's column run of
// filtered rgb f, stabiliser m and denominator d; true if the tile took
// the guard.
template <int S>
__device__ __forceinline__ bool k5_level(const float4* rgbs, const float* gs,
                                         float4* hs, float* red, int R, int P,
                                         float3 (&f)[kColRun],
                                         float (&m)[kColRun],
                                         float (&d)[kColRun]) {
  constexpr int RW = kBatchTileH + 2 * S, CW = kBatchTileW + 2 * S;
  const int tid = threadIdx.x, org = (R - S) * P + (R - S);
  float mx = -INFINITY, mn = INFINITY;
  for (int i = tid; i < RW * CW; i += kBThreads) {
    const float v = gs[org + i / CW * P + i % CW];
    mx = fmaxf(mx, v);
    if (v > -INFINITY) mn = fminf(mn, v);
  }
  block_max_min(mx, mn, red);
  const int col = tid % kBatchTileW, run = tid / kBatchTileW;
  if (mx - mn < kGuardRange) {
    float4 acc[kColRun];
    window_sums<S>(hs, org, P, acc, [&](int j) {
      const float e = expf(gs[j] - mx);
      const float4 q = rgbs[j];
      return make_float4(e * q.x, e * q.y, e * q.z, e);
    });
#pragma unroll
    for (int o = 0; o < kColRun; ++o) {
      f[o] = make_float3(acc[o].x / acc[o].w, acc[o].y / acc[o].w,
                         acc[o].z / acc[o].w);
      m[o] = mx;
      d[o] = acc[o].w;
    }
    return false;
  }
  // the guard: row maxima into hm [RW][tile width], then per output the
  // column max and the window's taps in dy-outer, dx-inner order
  float* hm = reinterpret_cast<float*>(hs);
  for (int i = tid; i < RW * kBatchTileW; i += kBThreads) {
    const float* row = gs + org + i / kBatchTileW * P + i % kBatchTileW;
    float v = row[0];
#pragma unroll
    for (int dx = 1; dx <= 2 * S; ++dx) v = fmaxf(v, row[dx]);
    hm[i] = v;
  }
  __syncthreads();
#pragma unroll
  for (int o = 0; o < kColRun; ++o) {
    const int row = run * kColRun + o;
    float mm = hm[row * kBatchTileW + col];
#pragma unroll
    for (int dy = 1; dy <= 2 * S; ++dy)
      mm = fmaxf(mm, hm[(row + dy) * kBatchTileW + col]);
    float n0 = 0.f, n1 = 0.f, n2 = 0.f, den = 0.f;
#pragma unroll 1
    for (int dy = 0; dy <= 2 * S; ++dy) {
      const int base = org + (row + dy) * P + col;
#pragma unroll
      for (int dx = 0; dx <= 2 * S; ++dx) {
        const float k = expf(gs[base + dx] - mm);
        const float4 q = rgbs[base + dx];
        den = den + k;
        n0 = n0 + q.x * k;
        n1 = n1 + q.y * k;
        n2 = n2 + q.z * k;
      }
    }
    f[o] = make_float3(n0 / den, n1 / den, n2 / den);
    m[o] = mm;
    d[o] = den;
  }
  return true;
}

template <int kMaxS>
__global__ void __launch_bounds__(kBThreads, 3) guided_filter_batch_kernel(
    const float* __restrict__ weight, Strides ws,
    const float* __restrict__ guidance, Strides gst,
    const float4* __restrict__ img, float4* __restrict__ out,
    float4* __restrict__ fm, float* __restrict__ den, int* __restrict__ guards,
    int levels, Supports sup, int R, int H, int W) {
  extern __shared__ float4 smem[];
  constexpr int kTile = kBatchTileW * kBatchTileH;
  const int P = kBatchTileW + 2 * R + 1, RH = kBatchTileH + 2 * R;
  float4* rgbs = smem;             // [RH][P]: rgb of the tile and halo R
  float4* hs = rgbs + RH * P;      // [RH][kHP]: row sums
  float* wbuf = reinterpret_cast<float*>(hs + RH * kHP);  // [2][tile]
  float* gbuf = wbuf + 2 * kTile;  // [2][RH][P]: guidance
  __shared__ float red[2 * kBWarps];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kBatchTileW, y0 = blockIdx.y * kBatchTileH;
  const long long HW = (long long)H * W, b = blockIdx.z;
  img += b * HW;
  out += b * HW;
  fm += b * levels * HW;
  den += b * levels * HW;
  weight += b * ws.b;
  guidance += b * gst.b;

  // rgb of the tile and its halo R, zero outside the image (group 0);
  // a warp a row, lanes along it
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < RH; r += kBWarps) {
    const int gy = y0 - R + r;
    for (int c = lane; c < kBatchTileW + 2 * R; c += 32) {
      const int gx = x0 - R + c;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(smem_addr(rgbs + r * P + c),
                 ok ? img + (long long)gy * W + gx : img, ok ? 16 : 0);
    }
  }
  // level l's weight over the tile and guidance over its region into
  // buffer l % 2 (guidance -inf outside the image); a cp.async group a
  // level
  auto stage = [&](int l) {
    if (l < levels) {
      float* wdst = wbuf + (l & 1) * kTile;
      const float* wsrc = weight + l * ws.l;
      for (int r = warp; r < kBatchTileH; r += kBWarps)
        for (int c = lane; c < kBatchTileW; c += 32)
          if (y0 + r < H && x0 + c < W)
            cp_async4(smem_addr(wdst + r * kBatchTileW + c),
                      wsrc + (y0 + r) * ws.h + x0 + c);
    }
    if (l < levels && sup.s[l] > 0) {
      const int s = sup.s[l], rw = kBatchTileH + 2 * s,
                cw = kBatchTileW + 2 * s;
      float* dst = gbuf + (l & 1) * RH * P + (R - s) * P + (R - s);
      const float* src = guidance + l * gst.l;
      for (int r = warp; r < rw; r += kBWarps) {
        const int gy = y0 - s + r;
        for (int c = lane; c < cw; c += 32) {
          const int gx = x0 - s + c;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W)
            cp_async4(smem_addr(dst + r * P + c), src + gy * gst.h + gx);
          else
            dst[r * P + c] = -INFINITY;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(0);
  stage(1);

  const int col = tid % kBatchTileW, run = tid / kBatchTileW;
  const int x = x0 + col, yr = y0 + run * kColRun;
  float3 o[kColRun];
#pragma unroll
  for (int k = 0; k < kColRun; ++k) o[k] = make_float3(0.f, 0.f, 0.f);
  for (int l = 0; l < levels; ++l) {
    const int s = sup.s[l];
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // level l's weight and guidance (and the rgb) staged
    float3 f[kColRun];
    float m[kColRun], d[kColRun];
    if (s == 0) {
#pragma unroll
      for (int k = 0; k < kColRun; ++k) {
        const float4 q = rgbs[(R + run * kColRun + k) * P + R + col];
        f[k] = make_float3(q.x, q.y, q.z);
      }
    } else {
      const float* gs = gbuf + (l & 1) * RH * P;
      bool guard = false;
#define RT_K5_LEVEL(S) \
  guard = k5_level<S>(rgbs, gs, hs, red, R, P, f, m, d); break
      switch (s) {
        case 1: RT_K5_LEVEL(1);
        case 2: RT_K5_LEVEL(2);
        case 3: RT_K5_LEVEL(3);
        case 4: RT_K5_LEVEL(4);
        default:
          if constexpr (kMaxS > 4) {
            switch (s) {
              case 5: RT_K5_LEVEL(5);
              case 6: RT_K5_LEVEL(6);
              case 7: RT_K5_LEVEL(7);
              default: RT_K5_LEVEL(8);
            }
          }
      }
#undef RT_K5_LEVEL
      if (guard && tid == 0 && guards != nullptr) atomicAdd(guards, 1);
    }
    const float* wl = wbuf + (l & 1) * kTile + run * kColRun * kBatchTileW;
    if (x < W) {
#pragma unroll
      for (int k = 0; k < kColRun; ++k) {
        const int y = yr + k;
        if (y >= H) break;
        const long long pix = (long long)y * W + x;
        if (s > 0) {
          fm[l * HW + pix] = make_float4(f[k].x, f[k].y, f[k].z, m[k]);
          den[l * HW + pix] = d[k];
        }
        const float w = wl[k * kBatchTileW + col];
        o[k].x = o[k].x + w * f[k].x;
        o[k].y = o[k].y + w * f[k].y;
        o[k].z = o[k].z + w * f[k].z;
      }
    }
    __syncthreads();  // this level's reads of its buffers and hs are done
    stage(l + 2);
  }
  if (x < W) {
#pragma unroll
    for (int k = 0; k < kColRun; ++k) {
      const int y = yr + k;
      if (y >= H) break;
      out[(long long)y * W + x] = make_float4(o[k].x, o[k].y, o[k].z, 1.f);
    }
  }
}

// One K6 level of support S: (u_p, v_p) into uvs and m_p into ms over
// the level's region (0 and +inf outside the image), and dL/dw on the
// tile; then this thread's column run of dL/dg.  grad is offset to the
// image; fm, den, gw to the image and level; weight to the image and level
// (row stride wh); xq, gq: this thread's outputs' rgb and guidance.  True
// if the tile took the guard.
template <int S>
__device__ __forceinline__ bool k6_level(
    const float4* __restrict__ grad, const float4* __restrict__ fm,
    const float* __restrict__ den, const float* __restrict__ weight,
    long long wh, float* __restrict__ gw, float4* uvs, float* ms, float4* hs,
    float* red, int R, int P, int x0, int y0, int H, int W,
    const float3 (&xq)[kColRun], const float (&gq)[kColRun],
    float (&dg)[kColRun]) {
  constexpr int RW = kBatchTileH + 2 * S, CW = kBatchTileW + 2 * S;
  const int tid = threadIdx.x, org = (R - S) * P + (R - S);
  float mx = -INFINITY, mn = INFINITY;
#pragma unroll 4
  for (int i = tid; i < RW * CW; i += kBThreads) {
    const int r = i / CW, c = i % CW, gy = y0 - S + r, gx = x0 - S + c;
    float4 uv = make_float4(0.f, 0.f, 0.f, 0.f);
    float m = INFINITY;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const long long p = (long long)gy * W + gx;
      const float4 G = grad[p], f = fm[p];
      const float a = weight[gy * wh + gx] / den[p];
      const float gf = G.x * f.x + G.y * f.y + G.z * f.z;
      uv = make_float4(G.x * a, G.y * a, G.z * a, a * gf);
      m = f.w;
      mx = fmaxf(mx, m);
      mn = fminf(mn, m);
      if (r >= S && r < S + kBatchTileH && c >= S && c < S + kBatchTileW)
        gw[p] = gf;
    }
    uvs[org + r * P + c] = uv;
    ms[org + r * P + c] = m;
  }
  block_max_min(mx, mn, red);  // its __syncthreads publishes the staging
  const int col = tid % kBatchTileW, run = tid / kBatchTileW;
  if (mx - mn < kGuardRange) {
    float4 acc[kColRun];
    window_sums<S>(hs, org, P, acc, [&](int j) {
      const float e = expf(mn - ms[j]);
      const float4 q = uvs[j];
      return make_float4(q.x * e, q.y * e, q.z * e, q.w * e);
    });
#pragma unroll
    for (int k = 0; k < kColRun; ++k)
      dg[k] = expf(gq[k] - mn) * (xq[k].x * acc[k].x + xq[k].y * acc[k].y +
                                  xq[k].z * acc[k].z - acc[k].w);
    return false;
  }
  // the guard: the gather over each output's window, dy-outer, dx-inner
#pragma unroll
  for (int k = 0; k < kColRun; ++k) {
    float acc = 0.f;
#pragma unroll 1
    for (int dy = 0; dy <= 2 * S; ++dy) {
      const int base = org + (run * kColRun + k + dy) * P + col;
#pragma unroll
      for (int dx = 0; dx <= 2 * S; ++dx) {
        const float4 q = uvs[base + dx];
        const float e = expf(gq[k] - ms[base + dx]);
        const float ux = q.x * xq[k].x + q.y * xq[k].y + q.z * xq[k].z;
        acc = acc + e * (ux - q.w);
      }
    }
    dg[k] = acc;
  }
  return true;
}

// K6: a block a tile, image and level (the levels' gradients are
// independent, so the card interleaves them instead of one block walking
// them in turn).
template <int kMaxS>
__global__ void __launch_bounds__(kBThreads, 3)
    guided_filter_batch_bwd_kernel(
        const float4* __restrict__ grad, const float* __restrict__ weight,
        Strides ws, const float* __restrict__ guidance, Strides gst,
        const float4* __restrict__ img, const float4* __restrict__ fm,
        const float* __restrict__ den, float* __restrict__ gw,
        float* __restrict__ gg, int* __restrict__ guards, int levels,
        Supports sup, int R, int H, int W) {
  extern __shared__ float4 smem[];
  const int P = kBatchTileW + 2 * R + 1, RH = kBatchTileH + 2 * R;
  float4* uvs = smem;              // [RH][P]: (u_p rgb, v_p)
  float4* hs = uvs + RH * P;       // [RH][kHP]: row sums
  float* ms = reinterpret_cast<float*>(hs + RH * kHP);  // [RH][P]: m_p
  __shared__ float red[2 * kBWarps];
  const int tid = threadIdx.x, l = blockIdx.z % levels, s = sup.s[l];
  const int x0 = blockIdx.x * kBatchTileW, y0 = blockIdx.y * kBatchTileH;
  const long long HW = (long long)H * W, b = blockIdx.z / levels;
  const long long lo = (b * levels + l) * HW;
  grad += b * HW;
  img += b * HW;
  fm += lo;
  den += lo;
  gw += lo;
  gg += lo;
  weight += b * ws.b + l * ws.l;
  guidance += b * gst.b + l * gst.l;

  const int col = tid % kBatchTileW, run = tid / kBatchTileW;
  const int x = x0 + col, yr = y0 + run * kColRun;
  float3 xq[kColRun];
  float gq[kColRun];
#pragma unroll
  for (int k = 0; k < kColRun; ++k) {
    const bool in = x < W && yr + k < H;
    const float4 q = in ? img[(long long)(yr + k) * W + x]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    xq[k] = make_float3(q.x, q.y, q.z);
    gq[k] = in && s > 0 ? guidance[(yr + k) * gst.h + x] : 0.f;
  }
  if (s == 0) {  // f = x: dL/dw = G . x, no guidance gradient
    if (x < W) {
#pragma unroll
      for (int k = 0; k < kColRun; ++k) {
        const int y = yr + k;
        if (y >= H) break;
        const long long pix = (long long)y * W + x;
        const float4 G = grad[pix];
        gw[pix] = G.x * xq[k].x + G.y * xq[k].y + G.z * xq[k].z;
        gg[pix] = 0.f;
      }
    }
    return;
  }
  float dg[kColRun];
  bool guard = false;
#define RT_K6_LEVEL(S)                                                       \
  guard = k6_level<S>(grad, fm, den, weight, ws.h, gw, uvs, ms, hs, red, R, \
                      P, x0, y0, H, W, xq, gq, dg);                         \
  break
  switch (s) {
    case 1: RT_K6_LEVEL(1);
    case 2: RT_K6_LEVEL(2);
    case 3: RT_K6_LEVEL(3);
    case 4: RT_K6_LEVEL(4);
    default:
      if constexpr (kMaxS > 4) {
        switch (s) {
          case 5: RT_K6_LEVEL(5);
          case 6: RT_K6_LEVEL(6);
          case 7: RT_K6_LEVEL(7);
          default: RT_K6_LEVEL(8);
        }
      }
  }
#undef RT_K6_LEVEL
  if (guard && tid == 0 && guards != nullptr) atomicAdd(guards, 1);
  if (x < W) {
#pragma unroll
    for (int k = 0; k < kColRun; ++k) {
      const int y = yr + k;
      if (y >= H) break;
      gg[(long long)y * W + x] = dg[k];
    }
  }
}

// The supports of a batched call into `sup`, and their largest as the halo
// R; false if a count or a support is out of the kernels' range.
bool batch_supports(int batch, int levels, const int* supports, int height,
                    int width, Supports& sup, int& R) {
  if (batch < 1 || batch > 65535 || levels < 1 || levels > kMaxLevels ||
      height < 1 || width < 1)
    return false;
  sup = Supports{};
  R = 0;
  for (int l = 0; l < levels; ++l) {
    if (supports[l] < 0 || supports[l] > kMaxSupport) return false;
    sup.s[l] = supports[l];
    R = supports[l] > R ? supports[l] : R;
  }
  return true;
}

// Dynamic shared memory at halo R: K5 two float4 arrays (rgb, row sums),
// two guidance buffers of the region and two weight tiles; K6 two float4
// arrays (u and v, row sums) and the region's m.  At most 69,888 bytes
// (K5, R = 8); above the 48 KB default the kernel is allowed more first.
template <class Kernel>
int batch_smem(Kernel kernel, int R, bool bwd, cudaError_t& err) {
  const int P = kBatchTileW + 2 * R + 1, RH = kBatchTileH + 2 * R;
  const int tile = kBatchTileW * kBatchTileH;
  const int bytes = bwd ? RH * P * 20 + RH * kHP * 16
                        : RH * P * 24 + RH * kHP * 16 + tile * 8;
  // the reduction's static 2 * kBWarps floats count against the default too
  err = bytes + 2 * kBWarps * 4 > 48 * 1024
            ? cudaFuncSetAttribute(
                  kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
            : cudaSuccess;
  return bytes;
}

dim3 batch_grid(int slices, int height, int width) {
  return dim3((width + kBatchTileW - 1) / kBatchTileW,
              (height + kBatchTileH - 1) / kBatchTileH, slices);
}

}  // namespace

// weight, guidance: f32 [B, L, H, W] at element strides (batch, level,
// row) with contiguous rows; img, out: f32 [B, H, W, 4] (img 16-byte
// aligned); fm: f32 [B, L, H, W, 4]; den: f32 [B, L, H, W]; guards: null
// or an int the kernel adds its guard tiles to; supports: host array of L
// ints.
RT_API int rt_guided_filter_batch(const void* weight, long long wsb,
                                  long long wsl, long long wsh,
                                  const void* guidance, long long gsb,
                                  long long gsl, long long gsh,
                                  const void* img, void* out, void* fm,
                                  void* den, void* guards, int batch,
                                  int levels, const int* supports, int height,
                                  int width, void* stream) {
  Supports sup;
  int R;
  if (!batch_supports(batch, levels, supports, height, width, sup, R))
    return (int)cudaErrorInvalidValue;
  // the instance for supports up to 4 (the training ladder) carries no
  // code for larger windows
  auto kernel = R <= 4 ? guided_filter_batch_kernel<4>
                       : guided_filter_batch_kernel<kMaxSupport>;
  cudaError_t err;
  const int bytes = batch_smem(kernel, R, false, err);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch_grid(batch, height, width), kBThreads, bytes,
           (cudaStream_t)stream>>>(
      (const float*)weight, Strides{wsb, wsl, wsh}, (const float*)guidance,
      Strides{gsb, gsl, gsh}, (const float4*)img, (float4*)out, (float4*)fm,
      (float*)den, (int*)guards, levels, sup, R, height, width);
  return (int)cudaGetLastError();
}

// grad: f32 [B, H, W, 4]; weight, guidance as K5's; img: f32 [B, H, W, 4];
// fm, den as K5 wrote them; gw, gg: f32 [B, L, H, W]; guards as K5's.
RT_API int rt_guided_filter_batch_bwd(
    const void* grad, const void* weight, long long wsb, long long wsl,
    long long wsh, const void* guidance, long long gsb, long long gsl,
    long long gsh, const void* img, const void* fm, const void* den,
    void* gw, void* gg, void* guards, int batch, int levels,
    const int* supports, int height, int width, void* stream) {
  Supports sup;
  int R;
  if (!batch_supports(batch, levels, supports, height, width, sup, R) ||
      (long long)batch * levels > 65535)
    return (int)cudaErrorInvalidValue;
  auto kernel = R <= 4 ? guided_filter_batch_bwd_kernel<4>
                       : guided_filter_batch_bwd_kernel<kMaxSupport>;
  cudaError_t err;
  const int bytes = batch_smem(kernel, R, true, err);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch_grid(batch * levels, height, width), kBThreads, bytes,
           (cudaStream_t)stream>>>(
      (const float4*)grad, (const float*)weight, Strides{wsb, wsl, wsh},
      (const float*)guidance, Strides{gsb, gsl, gsh}, (const float4*)img,
      (const float4*)fm, (const float*)den, (float*)gw, (float*)gg,
      (int*)guards, levels, sup, R, height, width);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5's and K6's wide instances (launch names "guided_filter_batch_wide" and
// "guided_filter_batch_bwd_wide"): the unrolled instances' tile algorithm
// at a runtime support (up to kWideMaxSupport) and 1..kWideMaxLevels
// levels.  The row pass loops over the region's rows (at support 32 they are
// 80 x 5 runs for 160 threads); each run's sums keep run_sums' order.  The
// grid is one dimension over (slice, tile row, tile column), so B and B x L
// have no 65535 cap.
//
// K5's wide instance (guided_filter_batch_wide_kernel) walks a tile's
// levels in order, as the unrolled one does, and sums each output's terms
// in run_sums' order.  It is far from its bytes bound: at the training
// batch (32 x 80 x 80, L = 12, ladder 1..12, R = 12) a block runs 12
// levels of staging, a range reduction, a row pass over up to 40 x 64
// region pixels and a column pass, each ended by a barrier, at 320 blocks
// (its statistics instance splits a block's cycles by phase).  Its
// design:
//  - e = exp(g - c) is taken once per staged pixel after the level's range
//    reduction, in place of the guidance (the row pass forms (e rgb, e)
//    from it and the rgb planes as it reads them: 3 multiplies a read, no
//    expf);
//  - the window sums at a runtime support add without runtime predicates
//    (run_sums_wide: the head and the tail of a run unrolled, its middle a
//    loop in which every output adds);
//  - a row-pass task sums 10 outputs, so that a region of 40 rows (support
//    12) takes one round of the block's 160 threads;
//  - rgb lives in three f32 planes (not float4) and each level's guidance
//    takes one buffer, so that the training batch's block takes 72,960
//    bytes and three blocks fit an SM (15 warps, the 320 blocks in one
//    wave); the next level's weight and guidance are staged as soon as the
//    row pass has read this level's e (behind the column pass).
//
// K6's wide instance (guided_filter_batch_bwd_wide_kernel) takes a block a
// tile, image and level (3,840 blocks at the training batch), stages (u_p,
// v_p) and m_p over the level's region, reduces m's range and sums each
// output's window terms in run_sums' order, with K5 wide's remedies:
//  - e_p = exp(mn - m_p) is taken once per staged pixel, in place into its
//    (u_p, v_p), so the row pass reads scaled values with no expf;
//  - the window sums add without runtime predicates (run_sums_any), a
//    row-pass task of kWideRowRun outputs;
//  - m_p shares the row sums' buffer until e, so that the block takes
//    67,840 bytes at R = 12 and three blocks fit an SM.
// The guard keeps its per-window form on unscaled (u_p, v_p) and m_p.
// ---------------------------------------------------------------------------

namespace {

// run_sums at a runtime support S with 2S >= N - 1, without a runtime
// predicate: inputs 0..N-1 start and extend the sums (acc[i] = x_i,
// acc[o < i] += x_i), inputs N..2S add to every sum, and inputs 2S + t
// (t = 1..N-1) to the sums o >= t that still run; each sum in run_sums'
// order.
template <int N, class Load>
__device__ __forceinline__ void run_sums_wide(float4 (&acc)[N], int S,
                                              Load load) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 x = load(i);
#pragma unroll
    for (int o = 0; o < N; ++o) {
      if (o == i)
        acc[o] = x;
      else if (o < i)
        acc[o] = add4(acc[o], x);
    }
  }
  for (int i = N; i <= 2 * S; ++i) {
    const float4 x = load(i);
#pragma unroll
    for (int o = 0; o < N; ++o) acc[o] = add4(acc[o], x);
  }
#pragma unroll
  for (int t = 1; t < N; ++t) {
    const float4 x = load(2 * S + t);
#pragma unroll
    for (int o = t; o < N; ++o) acc[o] = add4(acc[o], x);
  }
}

// run_sums at any runtime support S >= 1: run_sums_wide, or the unrolled
// run_sums where 2S < N - 1 (S <= 4 in a row pass of 10, S = 1 in a
// column pass of 4).
template <int N, class Load>
__device__ __forceinline__ void run_sums_any(float4 (&acc)[N], int S,
                                             Load load) {
  static_assert(N <= 10, "the unrolled supports reach 2S >= N - 1");
  if (2 * S >= N - 1) {
    run_sums_wide<N>(acc, S, load);
  } else if (S == 1) {
    run_sums<N, 1>(acc, load);
  } else if (S == 2) {
    run_sums<N, 2>(acc, load);
  } else if (S == 3) {
    run_sums<N, 3>(acc, load);
  } else {
    run_sums<N, 4>(acc, load);
  }
}

// K5 wide's row pass: a task sums 10 outputs of a row, so that the 40 x 4
// tasks of a 40-row region (support 12) take one round of 160 threads.
constexpr int kWideRowRun = 10;
static_assert(kBatchTileW % kWideRowRun == 0, "tile");

// K5 wide's staged tile: rgb planes and a level's guidance of the tile and
// its halo R at pitch P, the row sums and the level's weight.
struct K5WideSmem {
  const float* rgb[3];  // [RH][P] each: r, g, b (0 outside the image)
  float* gs;            // [RH][P]: the level's guidance, then its e
  float4* hs;           // [RH][kHP]: row sums
  const float* w;       // [tile]: the level's weight
};

// K5 wide's statistics instance (kStats): thread 0's clock64() cycles of
// each phase a block, summed over its levels: the rgb planes (with level
// 0's staging issued), the wait for a level's staging, the range
// reduction, e, the row pass, the issue of the next level's staging, the
// column pass with the level's stores, and the guarded levels'
// per-window form.  Each phase ends at a barrier, so they add up to the
// block's time.
constexpr int kK5Stats = 8;
enum K5Phase : int {
  kK5Rgb, kK5Wait, kK5Range, kK5E, kK5RowPass, kK5Issue, kK5ColumnPass,
  kK5Guard
};
template <bool kStats>
__device__ __forceinline__ void k5_mark(long long* clk, int k,
                                        long long& t0) {
  if constexpr (kStats) {
    if (threadIdx.x == 0) {
      const long long t1 = clock64();
      clk[k] += t1 - t0;
      t0 = t1;
    }
  }
}

// One K5 wide level of support S over the staged tile: this thread's
// column run of filtered rgb f, stabiliser m and denominator d; true if the
// tile took the guard.  On the fast path free_g() runs once the row pass
// has read the level's e (its buffer may take the next level's guidance).
template <bool kStats, class FreeG>
__device__ __forceinline__ bool k5_level_wide(int S, const K5WideSmem& t,
                                              float* red, int R, int P,
                                              float3 (&f)[kColRun],
                                              float (&m)[kColRun],
                                              float (&d)[kColRun],
                                              FreeG free_g, long long* clk,
                                              long long& t0) {
  const int RW = kBatchTileH + 2 * S, CW = kBatchTileW + 2 * S;
  const int tid = threadIdx.x, org = (R - S) * P + (R - S);
  float* gs = t.gs;
  float mx = -INFINITY, mn = INFINITY;
  for (int i = tid; i < RW * CW; i += kBThreads) {
    const float v = gs[org + i / CW * P + i % CW];
    mx = fmaxf(mx, v);
    if (v > -INFINITY) mn = fminf(mn, v);
  }
  block_max_min(mx, mn, red);
  k5_mark<kStats>(clk, kK5Range, t0);
  const int col = tid % kBatchTileW, run = tid / kBatchTileW;
  const float *rr = t.rgb[0], *rg = t.rgb[1], *rb = t.rgb[2];
  if (mx - mn < kGuardRange) {
    // e = exp(g - c) in place, once a staged pixel (block_max_min's
    // barrier follows every thread's reads of g)
    for (int i = tid; i < RW * CW; i += kBThreads) {
      float* q = gs + org + i / CW * P + i % CW;
      *q = expf(*q - mx);
    }
    __syncthreads();
    k5_mark<kStats>(clk, kK5E, t0);
    const auto x = [&](int j) {
      const float e = gs[j];
      return make_float4(e * rr[j], e * rg[j], e * rb[j], e);
    };
    for (int task = tid; task < RW * (kBatchTileW / kWideRowRun);
         task += kBThreads) {
      const int r = task % RW, c0 = task / RW * kWideRowRun;
      const int base = org + r * P + c0;
      float4 h[kWideRowRun];
      run_sums_any<kWideRowRun>(h, S, [&](int i) { return x(base + i); });
#pragma unroll
      for (int o = 0; o < kWideRowRun; ++o) t.hs[r * kHP + c0 + o] = h[o];
    }
    __syncthreads();
    k5_mark<kStats>(clk, kK5RowPass, t0);
    free_g();
    k5_mark<kStats>(clk, kK5Issue, t0);
    float4 acc[kColRun];
    run_sums_any<kColRun>(acc, S, [&](int i) {
      return t.hs[(run * kColRun + i) * kHP + col];
    });
#pragma unroll
    for (int o = 0; o < kColRun; ++o) {
      f[o] = make_float3(acc[o].x / acc[o].w, acc[o].y / acc[o].w,
                         acc[o].z / acc[o].w);
      m[o] = mx;
      d[o] = acc[o].w;
    }
    return false;
  }
  // the guard: the per-window form (k5_level's)
  float* hm = reinterpret_cast<float*>(t.hs);
  for (int i = tid; i < RW * kBatchTileW; i += kBThreads) {
    const float* row = gs + org + i / kBatchTileW * P + i % kBatchTileW;
    float v = row[0];
    for (int dx = 1; dx <= 2 * S; ++dx) v = fmaxf(v, row[dx]);
    hm[i] = v;
  }
  __syncthreads();
#pragma unroll
  for (int o = 0; o < kColRun; ++o) {
    const int row = run * kColRun + o;
    float mm = hm[row * kBatchTileW + col];
    for (int dy = 1; dy <= 2 * S; ++dy)
      mm = fmaxf(mm, hm[(row + dy) * kBatchTileW + col]);
    float n0 = 0.f, n1 = 0.f, n2 = 0.f, den = 0.f;
    for (int dy = 0; dy <= 2 * S; ++dy) {
      const int base = org + (row + dy) * P + col;
#pragma unroll 4
      for (int dx = 0; dx <= 2 * S; ++dx) {
        const float k = expf(gs[base + dx] - mm);
        den = den + k;
        n0 = n0 + rr[base + dx] * k;
        n1 = n1 + rg[base + dx] * k;
        n2 = n2 + rb[base + dx] * k;
      }
    }
    f[o] = make_float3(n0 / den, n1 / den, n2 / den);
    m[o] = mm;
    d[o] = den;
  }
  return true;
}

// block b of a one-dimensional grid over (slice, tile row, tile column) ->
// the slice and the tile's origin
__device__ __forceinline__ void wide_tile(int H, int W, long long& slice,
                                          int& x0, int& y0) {
  const int tiles_x = (W + kBatchTileW - 1) / kBatchTileW;
  const int tiles_y = (H + kBatchTileH - 1) / kBatchTileH;
  const long long per = (long long)tiles_x * tiles_y;
  slice = blockIdx.x / per;
  const int r = (int)(blockIdx.x - slice * per);
  x0 = (r % tiles_x) * kBatchTileW;
  y0 = (r / tiles_x) * kBatchTileH;
}

// K5's wide instance: a block a tile of one image, its levels in order.
// One guidance buffer: level l + 1's weight and guidance are staged as
// soon as level l's row pass has read its e (at once on a support-0
// level, after the level on a guarded one).  The weight has two buffers.
// kStats: the statistics instance (stats, int64 [blocks][kK5Stats]).
template <bool kStats>
__global__ void __launch_bounds__(kBThreads, 3)
    guided_filter_batch_wide_kernel(
        const float* __restrict__ weight, Strides ws,
        const float* __restrict__ guidance, Strides gst,
        const float4* __restrict__ img, float4* __restrict__ out,
        float4* __restrict__ fm, float* __restrict__ den,
        int* __restrict__ guards, int levels, WideSupports sup, int R, int H,
        int W, long long* __restrict__ stats) {
  extern __shared__ float4 smem[];
  constexpr int kTile = kBatchTileW * kBatchTileH;
  const int P = kBatchTileW + 2 * R + 1, RH = kBatchTileH + 2 * R;
  float4* hs = smem;                                     // [RH][kHP]
  float* rgb = reinterpret_cast<float*>(hs + RH * kHP);  // [3][RH][P]
  float* gs = rgb + 3 * RH * P;                          // [RH][P]
  float* wbuf = gs + RH * P;                             // [2][tile]
  __shared__ float red[2 * kBWarps];
  __shared__ long long clk[kStats ? kK5Stats : 1];
  const int tid = threadIdx.x;
  long long t0 = 0;
  if constexpr (kStats) {
    if (tid == 0) {
      for (int k = 0; k < kK5Stats; ++k) clk[k] = 0;
      t0 = clock64();
    }
  }
  long long b;
  int x0, y0;
  wide_tile(H, W, b, x0, y0);
  const long long HW = (long long)H * W;
  img += b * HW;
  out += b * HW;
  fm += b * levels * HW;
  den += b * levels * HW;
  weight += b * ws.b;
  guidance += b * gst.b;

  // level l's weight over the tile into buffer l % 2 and its guidance over
  // its region (-inf outside the image); a cp.async group a level
  const int warp = tid >> 5, lane = tid & 31;
  auto stage = [&](int l) {
    if (l < levels) {
      float* wdst = wbuf + (l & 1) * kTile;
      const float* wsrc = weight + l * ws.l;
      for (int r = warp; r < kBatchTileH; r += kBWarps)
        for (int c = lane; c < kBatchTileW; c += 32)
          if (y0 + r < H && x0 + c < W)
            cp_async4(smem_addr(wdst + r * kBatchTileW + c),
                      wsrc + (y0 + r) * ws.h + x0 + c);
    }
    if (l < levels && sup.s[l] > 0) {
      const int s = sup.s[l], rw = kBatchTileH + 2 * s,
                cw = kBatchTileW + 2 * s;
      float* dst = gs + (R - s) * P + (R - s);
      const float* src = guidance + l * gst.l;
      for (int r = warp; r < rw; r += kBWarps) {
        const int gy = y0 - s + r;
        for (int c = lane; c < cw; c += 32) {
          const int gx = x0 - s + c;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W)
            cp_async4(smem_addr(dst + r * P + c), src + gy * gst.h + gx);
          else
            dst[r * P + c] = -INFINITY;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(0);
  // rgb of the tile and its halo R into the three planes, 0 outside the
  // image; a warp a row, lanes along it
  for (int r = warp; r < RH; r += kBWarps) {
    const int gy = y0 - R + r;
    for (int c = lane; c < kBatchTileW + 2 * R; c += 32) {
      const int gx = x0 - R + c;
      const float4 q = gy >= 0 && gy < H && gx >= 0 && gx < W
                           ? __ldg(img + (long long)gy * W + gx)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      rgb[r * P + c] = q.x;
      rgb[(RH + r) * P + c] = q.y;
      rgb[(2 * RH + r) * P + c] = q.z;
    }
  }
  k5_mark<kStats>(clk, kK5Rgb, t0);

  const int col = tid % kBatchTileW, run = tid / kBatchTileW;
  const int x = x0 + col, yr = y0 + run * kColRun;
  float3 o[kColRun];
#pragma unroll
  for (int k = 0; k < kColRun; ++k) o[k] = make_float3(0.f, 0.f, 0.f);
  for (int l = 0; l < levels; ++l) {
    const int s = sup.s[l];
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // level l's weight and guidance (and the rgb) staged
    k5_mark<kStats>(clk, kK5Wait, t0);
    const K5WideSmem t{{rgb, rgb + RH * P, rgb + 2 * RH * P}, gs, hs,
                       wbuf + (l & 1) * kTile};
    // the next level's staging starts once this level's guidance is read
    bool next = false;
    const auto free_g = [&] {
      if (!next) stage(l + 1);
      next = true;
    };
    float3 f[kColRun];
    float m[kColRun], d[kColRun];
    bool guard = false;
    if (s == 0) {
      free_g();
      k5_mark<kStats>(clk, kK5Issue, t0);
#pragma unroll
      for (int k = 0; k < kColRun; ++k) {
        const int j = (R + run * kColRun + k) * P + R + col;
        f[k] = make_float3(t.rgb[0][j], t.rgb[1][j], t.rgb[2][j]);
      }
    } else {
      guard = k5_level_wide<kStats>(s, t, red, R, P, f, m, d, free_g, clk,
                                    t0);
      if (guard && tid == 0 && guards != nullptr) atomicAdd(guards, 1);
    }
    const float* wl = t.w + run * kColRun * kBatchTileW;
    if (x < W) {
#pragma unroll
      for (int k = 0; k < kColRun; ++k) {
        const int y = yr + k;
        if (y >= H) break;
        const long long pix = (long long)y * W + x;
        if (s > 0) {
          fm[l * HW + pix] = make_float4(f[k].x, f[k].y, f[k].z, m[k]);
          den[l * HW + pix] = d[k];
        }
        const float w = wl[k * kBatchTileW + col];
        o[k].x = o[k].x + w * f[k].x;
        o[k].y = o[k].y + w * f[k].y;
        o[k].z = o[k].z + w * f[k].z;
      }
    }
    __syncthreads();  // this level's reads of its buffers and hs are done
    k5_mark<kStats>(clk, guard ? kK5Guard : kK5ColumnPass, t0);
    free_g();  // a guarded level's next staging starts here
    k5_mark<kStats>(clk, kK5Issue, t0);
  }
  if (x < W) {
#pragma unroll
    for (int k = 0; k < kColRun; ++k) {
      const int y = yr + k;
      if (y >= H) break;
      out[(long long)y * W + x] = make_float4(o[k].x, o[k].y, o[k].z, 1.f);
    }
  }
  if constexpr (kStats) {
    if (tid == 0)
      for (int k = 0; k < kK5Stats; ++k)
        stats[blockIdx.x * kK5Stats + k] = clk[k];
  }
}

// K6 wide's statistics instance (kStats): thread 0's clock64() cycles of
// each phase a block: the staging of (u_p, v_p) and m_p (with the tile's
// rgb and guidance and the stores of dL/dw; a support-0 level whole), the
// range reduction, e, the row pass, the column pass with the stores of
// dL/dg, and a guarded level's per-window form with its stores.  The
// phases from the range on end at a barrier or at the block's end, so
// they add up to the block's time.
constexpr int kK6Stats = 6;
enum K6Phase : int {
  kK6Stage, kK6Range, kK6E, kK6RowPass, kK6ColumnPass, kK6Guard
};

// One K6 wide level of support S >= 1: (u_p, v_p) into uvs and m_p into ms
// over the level's region (0 and +inf outside the image), and dL/dw on the
// tile; then this thread's column run of dL/dg.  On the fast path each
// staged (u_p, v_p) is scaled in place by e_p = exp(mn - m_p), once, and
// the window sums read the scaled values (ms aliases the row sums, which
// the row pass writes after e).  grad is offset to the image; fm, den, gw
// to the image and level; weight to the image and level (row stride wh);
// xq, gq: this thread's outputs' rgb and guidance.  True if the tile took
// the guard.
template <bool kStats>
__device__ __forceinline__ bool k6_level_wide(
    int S, const float4* __restrict__ grad, const float4* __restrict__ fm,
    const float* __restrict__ den, const float* __restrict__ weight,
    long long wh, float* __restrict__ gw, float4* uvs, float* ms, float4* hs,
    float* red, int R, int P, int x0, int y0, int H, int W,
    const float3 (&xq)[kColRun], const float (&gq)[kColRun],
    float (&dg)[kColRun], long long* clk, long long& t0) {
  const int RW = kBatchTileH + 2 * S, CW = kBatchTileW + 2 * S;
  const int tid = threadIdx.x, org = (R - S) * P + (R - S);
  float mx = -INFINITY, mn = INFINITY;
#pragma unroll 4
  for (int i = tid; i < RW * CW; i += kBThreads) {
    const int r = i / CW, c = i % CW, gy = y0 - S + r, gx = x0 - S + c;
    float4 uv = make_float4(0.f, 0.f, 0.f, 0.f);
    float m = INFINITY;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const long long p = (long long)gy * W + gx;
      const float4 G = grad[p], f = fm[p];
      const float a = weight[gy * wh + gx] / den[p];
      const float gf = G.x * f.x + G.y * f.y + G.z * f.z;
      uv = make_float4(G.x * a, G.y * a, G.z * a, a * gf);
      m = f.w;
      mx = fmaxf(mx, m);
      mn = fminf(mn, m);
      if (r >= S && r < S + kBatchTileH && c >= S && c < S + kBatchTileW)
        gw[p] = gf;
    }
    uvs[org + r * P + c] = uv;
    ms[org + r * P + c] = m;
  }
  k5_mark<kStats>(clk, kK6Stage, t0);
  block_max_min(mx, mn, red);  // its __syncthreads publishes the staging
  k5_mark<kStats>(clk, kK6Range, t0);
  const int col = tid % kBatchTileW, run = tid / kBatchTileW;
  if (mx - mn < kGuardRange) {
    // e = exp(mn - m) once a staged pixel, into its (u, v)
    for (int i = tid; i < RW * CW; i += kBThreads) {
      const int j = org + i / CW * P + i % CW;
      const float e = expf(mn - ms[j]);
      const float4 q = uvs[j];
      uvs[j] = make_float4(q.x * e, q.y * e, q.z * e, q.w * e);
    }
    __syncthreads();  // ms is read: the row sums may take its place
    k5_mark<kStats>(clk, kK6E, t0);
    for (int task = tid; task < RW * (kBatchTileW / kWideRowRun);
         task += kBThreads) {
      const int r = task % RW, c0 = task / RW * kWideRowRun;
      const int base = org + r * P + c0;
      float4 h[kWideRowRun];
      run_sums_any<kWideRowRun>(h, S, [&](int i) { return uvs[base + i]; });
#pragma unroll
      for (int o = 0; o < kWideRowRun; ++o) hs[r * kHP + c0 + o] = h[o];
    }
    __syncthreads();
    k5_mark<kStats>(clk, kK6RowPass, t0);
    float4 acc[kColRun];
    run_sums_any<kColRun>(acc, S, [&](int i) {
      return hs[(run * kColRun + i) * kHP + col];
    });
#pragma unroll
    for (int k = 0; k < kColRun; ++k)
      dg[k] = expf(gq[k] - mn) * (xq[k].x * acc[k].x + xq[k].y * acc[k].y +
                                  xq[k].z * acc[k].z - acc[k].w);
    return false;
  }
  // the guard: the gather over each output's window, dy-outer, dx-inner
#pragma unroll
  for (int k = 0; k < kColRun; ++k) {
    float acc = 0.f;
    for (int dy = 0; dy <= 2 * S; ++dy) {
      const int base = org + (run * kColRun + k + dy) * P + col;
#pragma unroll 4
      for (int dx = 0; dx <= 2 * S; ++dx) {
        const float4 q = uvs[base + dx];
        const float e = expf(gq[k] - ms[base + dx]);
        const float ux = q.x * xq[k].x + q.y * xq[k].y + q.z * xq[k].z;
        acc = acc + e * (ux - q.w);
      }
    }
    dg[k] = acc;
  }
  return true;
}

// K6's wide instance: a block a tile, image and level, the slice b * L + l
// from the one-dimensional grid.  kStats: the statistics instance (stats,
// int64 [blocks][kK6Stats]).
template <bool kStats>
__global__ void __launch_bounds__(kBThreads, 3)
    guided_filter_batch_bwd_wide_kernel(
        const float4* __restrict__ grad, const float* __restrict__ weight,
        Strides ws, const float* __restrict__ guidance, Strides gst,
        const float4* __restrict__ img, const float4* __restrict__ fm,
        const float* __restrict__ den, float* __restrict__ gw,
        float* __restrict__ gg, int* __restrict__ guards, int levels,
        WideSupports sup, int R, int H, int W, long long* __restrict__ stats) {
  extern __shared__ float4 smem[];
  const int P = kBatchTileW + 2 * R + 1, RH = kBatchTileH + 2 * R;
  float4* uvs = smem;         // [RH][P]: (u_p rgb, v_p), then times e_p
  float4* hs = uvs + RH * P;  // [RH][kHP]: row sums
  float* ms = reinterpret_cast<float*>(hs);  // [RH][P]: m_p, until e
  __shared__ float red[2 * kBWarps];
  __shared__ long long clk[kStats ? kK6Stats : 1];
  long long t0 = 0;
  if constexpr (kStats) {
    if (threadIdx.x == 0) {
      for (int k = 0; k < kK6Stats; ++k) clk[k] = 0;
      t0 = clock64();
    }
  }
  long long slice;
  int x0, y0;
  wide_tile(H, W, slice, x0, y0);
  const int tid = threadIdx.x, l = (int)(slice % levels), s = sup.s[l];
  const long long HW = (long long)H * W, b = slice / levels;
  const long long lo = slice * HW;
  grad += b * HW;
  img += b * HW;
  fm += lo;
  den += lo;
  gw += lo;
  gg += lo;
  weight += b * ws.b + l * ws.l;
  guidance += b * gst.b + l * gst.l;

  const int col = tid % kBatchTileW, run = tid / kBatchTileW;
  const int x = x0 + col, yr = y0 + run * kColRun;
  float3 xq[kColRun];
  float gq[kColRun];
#pragma unroll
  for (int k = 0; k < kColRun; ++k) {
    const bool in = x < W && yr + k < H;
    const float4 q = in ? img[(long long)(yr + k) * W + x]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    xq[k] = make_float3(q.x, q.y, q.z);
    gq[k] = in && s > 0 ? guidance[(yr + k) * gst.h + x] : 0.f;
  }
  bool guard = false;
  if (s == 0) {  // f = x: dL/dw = G . x, no guidance gradient
    if (x < W) {
#pragma unroll
      for (int k = 0; k < kColRun; ++k) {
        const int y = yr + k;
        if (y >= H) break;
        const long long pix = (long long)y * W + x;
        const float4 G = grad[pix];
        gw[pix] = G.x * xq[k].x + G.y * xq[k].y + G.z * xq[k].z;
        gg[pix] = 0.f;
      }
    }
    k5_mark<kStats>(clk, kK6Stage, t0);
  } else {
    float dg[kColRun];
    guard = k6_level_wide<kStats>(s, grad, fm, den, weight, ws.h, gw, uvs,
                                  ms, hs, red, R, P, x0, y0, H, W, xq, gq,
                                  dg, clk, t0);
    if (guard && tid == 0 && guards != nullptr) atomicAdd(guards, 1);
    if (x < W) {
#pragma unroll
      for (int k = 0; k < kColRun; ++k) {
        const int y = yr + k;
        if (y >= H) break;
        gg[(long long)y * W + x] = dg[k];
      }
    }
    k5_mark<kStats>(clk, guard ? kK6Guard : kK6ColumnPass, t0);
  }
  if constexpr (kStats) {
    if (tid == 0)
      for (int k = 0; k < kK6Stats; ++k)
        stats[blockIdx.x * kK6Stats + k] = clk[k];
  }
}

// The one-dimensional grid of a wide launch over `slices` images (K5) or
// image levels (K6); 0 if it passes the grid's 2^31 - 1 blocks.
unsigned wide_blocks(long long slices, int height, int width) {
  const long long n = slices * ((width + kBatchTileW - 1) / kBatchTileW) *
                      ((height + kBatchTileH - 1) / kBatchTileH);
  return n > 0x7fffffffLL ? 0u : (unsigned)n;
}

// K5 wide's dynamic shared memory at halo R: row sums, three rgb planes,
// one guidance region and two weight tiles (72,960 bytes at R = 12,
// 192,000 at R = 32).
int k5_wide_smem(int R) {
  const int P = kBatchTileW + 2 * R + 1, RH = kBatchTileH + 2 * R;
  return RH * kHP * 16 + 4 * RH * P * 4 + 2 * kBatchTileW * kBatchTileH * 4;
}

// K6 wide's dynamic shared memory at halo R: (u, v) over the region and
// the row sums, which m_p shares until e (67,840 bytes at R = 12: three
// blocks an SM).
int k6_wide_smem(int R) {
  const int P = kBatchTileW + 2 * R + 1, RH = kBatchTileH + 2 * R;
  return RH * P * 16 + RH * kHP * 16;
}

}  // namespace

// K5's wide instance: rt_guided_filter_batch's arguments at 1..64 levels of
// support 0..32 and any batch.  A non-null ``stats`` (int64
// [blocks][kK5Stats], a row a block of the one-dimensional grid over
// (slice, tile row, tile column)) selects the statistics instance.
RT_API int rt_guided_filter_batch_wide(
    const void* weight, long long wsb, long long wsl, long long wsh,
    const void* guidance, long long gsb, long long gsl, long long gsh,
    const void* img, void* out, void* fm, void* den, void* guards, int batch,
    int levels, const int* supports, int height, int width, void* stats,
    void* stream) {
  WideSupports sup;
  int R;
  if (!wide_supports(levels, supports, sup, R) || batch < 1 || height < 1 ||
      width < 1)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = wide_blocks(batch, height, width);
  if (!blocks) return (int)cudaErrorInvalidValue;
  const auto kernel = stats ? guided_filter_batch_wide_kernel<true>
                            : guided_filter_batch_wide_kernel<false>;
  const int bytes = k5_wide_smem(R);
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kBThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)weight, Strides{wsb, wsl, wsh}, (const float*)guidance,
      Strides{gsb, gsl, gsh}, (const float4*)img, (float4*)out, (float4*)fm,
      (float*)den, (int*)guards, levels, sup, R, height, width,
      (long long*)stats);
  return (int)cudaGetLastError();
}

// K6's wide instance: rt_guided_filter_batch_bwd's arguments at 1..64
// levels of support 0..32 and any B x L.  A non-null ``stats`` (int64
// [blocks][kK6Stats], a row a block of the one-dimensional grid over
// (slice, tile row, tile column)) selects the statistics instance.
RT_API int rt_guided_filter_batch_bwd_wide(
    const void* grad, const void* weight, long long wsb, long long wsl,
    long long wsh, const void* guidance, long long gsb, long long gsl,
    long long gsh, const void* img, const void* fm, const void* den,
    void* gw, void* gg, void* guards, int batch, int levels,
    const int* supports, int height, int width, void* stats, void* stream) {
  WideSupports sup;
  int R;
  if (!wide_supports(levels, supports, sup, R) || batch < 1 || height < 1 ||
      width < 1)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      wide_blocks((long long)batch * levels, height, width);
  if (!blocks) return (int)cudaErrorInvalidValue;
  const auto kernel = stats ? guided_filter_batch_bwd_wide_kernel<true>
                            : guided_filter_batch_bwd_wide_kernel<false>;
  const int bytes = k6_wide_smem(R);
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kBThreads, bytes, (cudaStream_t)stream>>>(
      (const float4*)grad, (const float*)weight, Strides{wsb, wsl, wsh},
      (const float*)guidance, Strides{gsb, gsl, gsh}, (const float4*)img,
      (const float4*)fm, (const float*)den, (float*)gw, (float*)gg,
      (int*)guards, levels, sup, R, height, width, (long long*)stats);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2's wide instance (guided_filter_wide_kernel, launch name
// "guided_filter_wide"): rt_guided_filter's function at 1..kWideMaxLevels
// levels of support 0..kWideMaxSupport (the nets past the unrolled
// instance's 8 levels or support 8: a 12-level net's ladder 1..12).  It
// replaces rt_octree_tpu/ops/filtering.py:guided_filter (:153-185) as JAX's
// frame calls it (exact=False, render/renderer.py:1248): the fast form, with
// K5's numerics.  Per (tile, level of support s > 0) the stabiliser c is the
// largest guidance over the tile and its halo of s (clipped to the image).
// While that region's guidance spans less than kGuardRange nats (the JAX
// package's FAST_SAFE_RANGE, filtering.py:114), e = exp(g - c) is taken once
// per staged pixel, the window sums of (e rgb, e) are 2s+1 shifted adds
// along rows, then down columns, each output a fresh sum in tap order (no
// running difference, which cancels: filtering.py:80-89), and f = sum(e rgb)
// / sum(e).  Else the tile and level take the guard: the per-window form
// (the window max as stabiliser, one expf a tap, dy-outer, dx-inner), and
// add one to an optional counter.  The level weights are K2's prologue: the
// softmax over the first L channels, read through the activation's strides.
//
// Bound on this card at L = 12, the ladder 1..12, 800x800: bytes, 76 B a
// pixel (the 2L bf16 channels, rgb and the output once: 0.0145 ms), against
// sum_s (16 s + 8) + 10 L = 1,464 f32 operations a pixel (0.0140 ms at 67
// TFLOP/s); the per-window form costs 9 operations a window tap, 2,924 taps
// a pixel at supports 1..12.
//
// Design for K2's shape (one image, 2L channels, the ladder's halo R = 12):
// a block of 256 threads owns a 32 x 32 output tile (16 x 8 past R = 16)
// and stages once, for all levels, the rgb of the tile and its halo R as
// float4 (cp.async), the guidance of every level as bf16 planes and the
// tile's weight logits, from a pixel's 16-byte pieces loaded back to back
// when the activation is channels last as K7 hands it over (element by
// element otherwise; where L planes do not fit 227 KB, each level's
// guidance is staged on its own and the logits are read in place).  Every
// level's range comes from one pass before the levels.  Per level, two
// barriers: (e rgb, e) into one float4 array; the row pass (a thread 8
// outputs of a region row, from 8 + 2s staged pixels) into the row sums;
// the column pass (a thread 4 outputs of a column, from 4 + 2s row sums).
// The loops over a region take four pixels an iteration, so that their
// loads overlap.  The tap loops are unrolled (tap_sums): inputs 0..N-1 open
// the N outputs, 2s+1..2s+N-1 close them, the inputs between add to every
// output; a window narrower than N takes run_sums<N, S>.  The staged
// arrays' rows have an odd pitch, so lanes that walk down rows hit distinct
// banks.  Without fast math: expf, IEEE division.  Statistics instance
// (kStats, 32 x 32 tiles): thread 0's clock64() cycles of each phase a tile
// (w2_mark).
// ---------------------------------------------------------------------------

namespace {

constexpr int kW2Threads = 256, kW2Warps = kW2Threads / 32;
constexpr int kW2Run = 8;       // row-pass outputs a thread
constexpr int kW2SmallR = 16;   // the largest halo of the 32 x 32 tile

// acc[o] = x[o] + x[o + 1] + ... + x[o + 2s], in that order, for o < N, as
// run_sums, at a runtime support s: unrolled but for the run of inputs
// that adds to every output.
template <int N, class Load>
__device__ __forceinline__ void tap_sums(float4 (&acc)[N], int s, Load load) {
  static_assert(N == 4 || N == 8, "N");
  if (2 * s + 1 < N) {  // a window narrower than the run
    if (s == 1) {
      run_sums<N, 1>(acc, load);
    } else if constexpr (N == 8) {
      if (s == 2)
        run_sums<N, 2>(acc, load);
      else
        run_sums<N, 3>(acc, load);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {  // each input opens output i
    const float4 x = load(i);
#pragma unroll
    for (int o = 0; o < N; ++o) {
      if (o == i)
        acc[o] = x;
      else if (o < i)
        acc[o] = add4(acc[o], x);
    }
  }
#pragma unroll 4
  for (int i = N; i <= 2 * s; ++i) {
    const float4 x = load(i);
#pragma unroll
    for (int o = 0; o < N; ++o) acc[o] = add4(acc[o], x);
  }
#pragma unroll
  for (int j = 1; j < N; ++j) {  // input 2s + j closes output j - 1
    const float4 x = load(2 * s + j);
#pragma unroll
    for (int o = 0; o < N; ++o)
      if (o >= j) acc[o] = add4(acc[o], x);
  }
}

// f(rr, cc, ok) on this thread's pixels of a region of RWs x CWs, four at
// a time (independent, so their loads overlap), i = tid, tid + 256, ...
// walked without a division (CWs <= 256)
template <class F>
__device__ __forceinline__ void w2_region(int RWs, int CWs, F f) {
  const int n = RWs * CWs, step_r = kW2Threads / CWs;
  const int step_c = kW2Threads - step_r * CWs;
  int r = threadIdx.x / CWs, c = threadIdx.x - r * CWs;
  for (int i = threadIdx.x; i < n; i += 4 * kW2Threads) {
    int rr[4], cc[4];
    bool ok[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rr[k] = r;
      cc[k] = c;
      ok[k] = i + k * kW2Threads < n;
      c += step_c;
      r += step_r;
      if (c >= CWs) {
        c -= CWs;
        ++r;
      }
    }
    f(rr, cc, ok);
  }
}

// This thread's largest and smallest guidance (-inf excluded) over the
// region of a level of support s (the tile and a halo of s) in the staged
// layout g (rows of RW, halo R), reduced over its warp.
template <int TW, int TH>
__device__ __forceinline__ void w2_scan(int s, int R, int RW,
                                        const __nv_bfloat16* g, float& mx,
                                        float& mn) {
  const int org = R - s;
  float m4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float n4[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
  w2_region(TH + 2 * s, TW + 2 * s, [&](const int (&rr)[4],
                                        const int (&cc)[4],
                                        const bool (&ok)[4]) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = ok[k] ? __bfloat162float(g[(org + rr[k]) * RW + org + cc[k]])
                   : -INFINITY;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      m4[k] = fmaxf(m4[k], v[k]);
      if (v[k] > -INFINITY) n4[k] = fminf(n4[k], v[k]);
    }
  });
  mx = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
  mn = fminf(fminf(n4[0], n4[1]), fminf(n4[2], n4[3]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  }
}

// The statistics instance's clock: thread 0 adds the cycles since the last
// mark to clk[k] (kW2Stats phases: staging, ranges, prologue, (e rgb, e),
// row sums, column sums, every level whole).
constexpr int kW2Stats = 7;
template <bool kStats>
__device__ __forceinline__ void w2_mark(long long (&clk)[kW2Stats], int k,
                                        long long& t0) {
  if constexpr (kStats) {
    if (threadIdx.x == 0) {
      const long long t1 = clock64();
      clk[k] += t1 - t0;
      t0 = t1;
    }
  }
}

// One level of support s > 0 whose region spans less than kGuardRange
// nats, c its largest guidance: (e rgb, e) over the region into eb, the row
// sums into hs, then this thread's column run (active: it has one) of
// filtered rgb f.  Two __syncthreads.
template <int TW, int TH, bool kStats>
__device__ __forceinline__ void w2_fast(int s, float c, int R, int RW, int P,
                                        const float4* rgbs, float4* eb,
                                        float4* hs, const __nv_bfloat16* g,
                                        int col, int run, bool active,
                                        float3 (&f)[kColRun],
                                        long long (&clk)[kW2Stats]) {
  long long t0 = kStats ? clock64() : 0;
  constexpr int HP = TW + 1;  // the row sums' pitch (odd)
  const int tid = threadIdx.x, RWs = TH + 2 * s, CWs = TW + 2 * s;
  const int org = R - s;  // the level's region in the staged arrays
  w2_region(RWs, CWs, [&](const int (&rr)[4], const int (&cc)[4],
                          const bool (&ok)[4]) {
    float gv[4];
    float4 q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = (org + rr[k]) * P + org + cc[k];
      gv[k] = ok[k] ? __bfloat162float(g[(org + rr[k]) * RW + org + cc[k]])
                    : 0.f;
      q[k] = ok[k] ? rgbs[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float e = expf(gv[k] - c);
      if (ok[k])
        eb[(org + rr[k]) * P + org + cc[k]] =
            make_float4(e * q[k].x, e * q[k].y, e * q[k].z, e);
    }
  });
  __syncthreads();
  w2_mark<kStats>(clk, 3, t0);
  // the row pass: region row rr, outputs c0..c0+7 (one round: the entry
  // keeps RWs * TW / 8 within the block)
  const int rr = tid % RWs, c0 = tid / RWs * kW2Run;
  if (tid < RWs * (TW / kW2Run)) {
    float4 h[kW2Run];
    tap_sums<kW2Run>(h, s, [&](int i) {
      return eb[(org + rr) * P + org + c0 + i];
    });
#pragma unroll
    for (int o = 0; o < kW2Run; ++o) hs[rr * HP + c0 + o] = h[o];
  }
  __syncthreads();
  w2_mark<kStats>(clk, 4, t0);
  if (!active) return;
  float4 acc[kColRun];
  tap_sums<kColRun>(acc, s, [&](int i) {
    return hs[(run * kColRun + i) * HP + col];
  });
#pragma unroll
  for (int k = 0; k < kColRun; ++k)
    f[k] = make_float3(acc[k].x / acc[k].w, acc[k].y / acc[k].w,
                       acc[k].z / acc[k].w);
  w2_mark<kStats>(clk, 5, t0);
}

// One level of support s > 0 that takes the guard: row maxima [RWs][TW]
// over hs, then per output the column max and the window's taps, dy-outer,
// dx-inner.  Two __syncthreads.
template <int TW, int TH>
__device__ __forceinline__ void w2_guarded(int s, int R, int RW, int P,
                                           const float4* rgbs, float4* hs,
                                           const __nv_bfloat16* g, int col,
                                           int run, bool active,
                                           float3 (&f)[kColRun]) {
  const int tid = threadIdx.x, RWs = TH + 2 * s, org = R - s;
  float* hm = reinterpret_cast<float*>(hs);
  __syncthreads();  // the previous level's reads of hs are done
  for (int i = tid; i < RWs * TW; i += kW2Threads) {
    const __nv_bfloat16* row = g + (org + i / TW) * RW + org + i % TW;
    float v = __bfloat162float(row[0]);
    for (int dx = 1; dx <= 2 * s; ++dx)
      v = fmaxf(v, __bfloat162float(row[dx]));
    hm[i] = v;
  }
  __syncthreads();
  if (!active) return;
#pragma unroll
  for (int k = 0; k < kColRun; ++k) {
    const int t = run * kColRun + k;  // the output's row in the tile
    float mm = hm[t * TW + col];
    for (int dy = 1; dy <= 2 * s; ++dy)
      mm = fmaxf(mm, hm[(t + dy) * TW + col]);
    float n0 = 0.f, n1 = 0.f, n2 = 0.f, den = 0.f;
    for (int dy = 0; dy <= 2 * s; ++dy) {
      const int r = org + t + dy, c = org + col;
#pragma unroll 4
      for (int dx = 0; dx <= 2 * s; ++dx) {
        const float kq = expf(__bfloat162float(g[r * RW + c + dx]) - mm);
        const float4 q = rgbs[r * P + c + dx];
        den = den + kq;
        n0 = n0 + q.x * kq;
        n1 = n1 + q.y * kq;
        n2 = n2 + q.z * kq;
      }
    }
    f[k] = make_float3(n0 / den, n1 / den, n2 / den);
  }
}

// the static shared memory of guided_filter_wide_kernel (bytes)
constexpr int kW2Static = (2 * kW2Warps + 2 * kWideMaxLevels) * 4;

template <int TW, int TH, bool kStats>
__global__ void __launch_bounds__(kW2Threads, 1) guided_filter_wide_kernel(
    const __nv_bfloat16* __restrict__ act, long long sc, long long sh,
    long long sw, const float4* __restrict__ img, float4* __restrict__ out,
    int* __restrict__ guards, int levels, WideSupports sup, int R,
    bool all_levels, bool vec, int H, int W, long long* __restrict__ stats) {
  constexpr int HP = TW + 1, NT = TW * TH;
  extern __shared__ float4 smem[];
  const int RH = TH + 2 * R, RW = TW + 2 * R, P = RW + 1, npix = RH * RW;
  float4* rgbs = smem;         // [RH][P]: rgb of the tile and halo R
  float4* eb = rgbs + RH * P;  // [RH][P]: a level's (e rgb, e)
  float4* hs = eb + RH * P;    // [RH][HP]: its row sums
  // all levels: [L][NT] the weight logits of the tile; [L][RH][RW] the
  // guidance (else one level's)
  __nv_bfloat16* wlog = reinterpret_cast<__nv_bfloat16*>(hs + RH * HP);
  __nv_bfloat16* gs = wlog + (all_levels ? levels * NT : 0);
  __shared__ float red[2 * kW2Warps];
  __shared__ float2 range[kWideMaxLevels];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const __nv_bfloat16 kNegInf = __float2bfloat16(-INFINITY);
  long long clk[kW2Stats] = {}, t0 = kStats ? clock64() : 0;

  // rgb of the tile and its halo R, 0 outside the image
  for (int i = tid; i < npix; i += kW2Threads) {
    const int r = i / RW, c = i - r * RW, gy = y0 - R + r, gx = x0 - R + c;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async16(smem_addr(rgbs + r * P + c),
               ok ? img + (long long)gy * W + gx : img, ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (all_levels && vec) {
    // channels last: a pixel's 16-byte pieces back to back (the lanes'
    // first piece brings the sectors the others read from L1), two pixels
    // a thread at a time; the halo needs only the pieces that hold a
    // guidance channel (L..2L-1)
    const int np = (2 * levels - 1) / 8 + 1, p0 = levels / 8;
    for (int q0 = tid; q0 < npix; q0 += 2 * kW2Threads) {
      int q[2], r[2], c[2];
      bool ok[2], in_tile[2];
      const uint4* src[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        q[h] = q0 + h * kW2Threads;
        r[h] = q[h] / RW;
        c[h] = q[h] - r[h] * RW;
        const int gy = y0 - R + r[h], gx = x0 - R + c[h];
        in_tile[h] = r[h] >= R && r[h] < R + TH && c[h] >= R && c[h] < R + TW;
        ok[h] = q[h] < npix && gy >= 0 && gy < H && gx >= 0 && gx < W;
        src[h] = reinterpret_cast<const uint4*>(act + gy * sh + gx * sw);
      }
      for (int pc0 = 0; pc0 < np; pc0 += 4) {
        uint4 u[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int pc = pc0 + k;
            u[h][k] = ok[h] && pc < np && (pc >= p0 || in_tile[h])
                          ? __ldg(src[h] + pc)
                          : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (q[h] >= npix) continue;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int pc = pc0 + k;
            if (pc >= np || (pc < p0 && !in_tile[h])) continue;
            const __nv_bfloat16* v =
                reinterpret_cast<const __nv_bfloat16*>(&u[h][k]);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int ch = pc * 8 + e;
              if (ch < levels) {
                if (in_tile[h])
                  wlog[ch * NT + (r[h] - R) * TW + c[h] - R] = v[e];
              } else if (ch < 2 * levels) {
                gs[(ch - levels) * npix + q[h]] = ok[h] ? v[e] : kNegInf;
              }
            }
          }
        }
      }
    }
  } else if (all_levels) {
    for (int i = tid; i < levels * npix; i += kW2Threads) {
      const int l = i / npix, q = i - l * npix;
      const int r = q / RW, c = q - r * RW, gy = y0 - R + r, gx = x0 - R + c;
      gs[i] = gy >= 0 && gy < H && gx >= 0 && gx < W
                  ? act[(levels + l) * sc + gy * sh + gx * sw]
                  : kNegInf;
    }
    for (int i = tid; i < levels * NT; i += kW2Threads) {
      const int l = i / NT, t = i - l * NT, y = y0 + t / TW, x = x0 + t % TW;
      wlog[i] = y < H && x < W ? act[l * sc + y * sh + x * sw]
                               : __float2bfloat16(0.f);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  w2_mark<kStats>(clk, 0, t0);

  // every level's range at once (all levels staged): a warp's partials
  // over eb, then the block's
  if (all_levels) {
    float* part = reinterpret_cast<float*>(eb);
    for (int l = 0; l < levels; ++l) {
      if (sup.s[l] == 0) continue;
      float mx, mn;
      w2_scan<TW, TH>(sup.s[l], R, RW, gs + l * npix, mx, mn);
      if (lane == 0) {
        part[(l * kW2Warps + warp) * 2] = mx;
        part[(l * kW2Warps + warp) * 2 + 1] = mn;
      }
    }
    __syncthreads();
    if (tid < levels && sup.s[tid] > 0) {
      float mx = part[tid * kW2Warps * 2], mn = part[tid * kW2Warps * 2 + 1];
      for (int w = 1; w < kW2Warps; ++w) {
        mx = fmaxf(mx, part[(tid * kW2Warps + w) * 2]);
        mn = fminf(mn, part[(tid * kW2Warps + w) * 2 + 1]);
      }
      range[tid] = make_float2(mx, mn);
    }
    __syncthreads();
  }
  w2_mark<kStats>(clk, 1, t0);

  // the prologue: the softmax over the L weight channels of this thread's
  // outputs (max, then sum)
  const int col = tid % TW, run = tid / TW;
  const bool active = run * kColRun < TH;
  const int x = x0 + col;
  auto logit = [&](int l, int k) {
    const int t = (run * kColRun + k) * TW + col;
    return __bfloat162float(
        all_levels ? wlog[l * NT + t]
                   : act[l * sc + (y0 + t / TW) * sh + x * sw]);
  };
  float wmax[kColRun], wsum[kColRun];
#pragma unroll
  for (int k = 0; k < kColRun; ++k) {
    const int y = y0 + run * kColRun + k;
    wmax[k] = -INFINITY;
    wsum[k] = 0.f;
    if (!active || y >= H || x >= W) continue;
    for (int l = 0; l < levels; ++l) wmax[k] = fmaxf(wmax[k], logit(l, k));
    for (int l = 0; l < levels; ++l)
      wsum[k] = wsum[k] + expf(logit(l, k) - wmax[k]);
  }

  float3 o[kColRun];
#pragma unroll
  for (int k = 0; k < kColRun; ++k) o[k] = make_float3(0.f, 0.f, 0.f);
  w2_mark<kStats>(clk, 2, t0);
  for (int l = 0; l < levels; ++l) {
    const int s = sup.s[l];
    float3 f[kColRun];
    if (s == 0) {
#pragma unroll
      for (int k = 0; k < kColRun; ++k) {
        const float4 q =
            rgbs[(R + (active ? run * kColRun : 0) + k) * P + R + col];
        f[k] = make_float3(q.x, q.y, q.z);
      }
    } else {
      const __nv_bfloat16* g = gs + (all_levels ? l * npix : 0);
      float2 rg;
      if (all_levels) {
        rg = range[l];
      } else {  // this level's guidance over its region alone, and its range
        __syncthreads();  // the previous level's reads are done
        const int rw = TH + 2 * s, cw = TW + 2 * s;
        for (int i = tid; i < rw * cw; i += kW2Threads) {
          const int r = R - s + i / cw, c = R - s + i % cw;
          const int gy = y0 - R + r, gx = x0 - R + c;
          gs[r * RW + c] = gy >= 0 && gy < H && gx >= 0 && gx < W
                               ? act[(levels + l) * sc + gy * sh + gx * sw]
                               : kNegInf;
        }
        __syncthreads();
        w2_scan<TW, TH>(s, R, RW, g, rg.x, rg.y);
        if (lane == 0) {
          red[warp] = rg.x;
          red[kW2Warps + warp] = rg.y;
        }
        __syncthreads();
        rg = make_float2(red[0], red[kW2Warps]);
        for (int w = 1; w < kW2Warps; ++w)
          rg = make_float2(fmaxf(rg.x, red[w]), fminf(rg.y, red[kW2Warps + w]));
      }
      if (rg.x - rg.y < kGuardRange) {
        w2_fast<TW, TH, kStats>(s, rg.x, R, RW, P, rgbs, eb, hs, g, col, run,
                                active, f, clk);
      } else {
        w2_guarded<TW, TH>(s, R, RW, P, rgbs, hs, g, col, run, active, f);
        if (tid == 0 && guards != nullptr) atomicAdd(guards, 1);
      }
    }
#pragma unroll
    for (int k = 0; k < kColRun; ++k) {
      const int y = y0 + run * kColRun + k;
      if (!active || y >= H || x >= W) continue;
      const float wl = expf(logit(l, k) - wmax[k]) / wsum[k];
      o[k].x = o[k].x + wl * f[k].x;
      o[k].y = o[k].y + wl * f[k].y;
      o[k].z = o[k].z + wl * f[k].z;
    }
    w2_mark<kStats>(clk, 6, t0);
  }
#pragma unroll
  for (int k = 0; k < kColRun; ++k) {
    const int y = y0 + run * kColRun + k;
    if (active && y < H && x < W)
      out[(long long)y * W + x] = make_float4(o[k].x, o[k].y, o[k].z, 1.f);
  }
  if (kStats && tid == 0) {
    long long* st = stats + (blockIdx.y * gridDim.x + blockIdx.x) * kW2Stats;
    for (int k = 0; k < kW2Stats; ++k) st[k] = clk[k];
  }
}

}  // namespace

// K2's wide instance: rt_guided_filter's arguments at 1..64 levels of
// support 0..32, and guards: null or an int the kernel adds the (tile,
// level) pairs that took the guard to.  A non-null ``stats`` (int64
// [tiles][7], a row a 32x32 tile) selects the statistics instance (supports
// up to 16): thread 0's clock64() cycles of each phase (w2_mark).  Dynamic
// shared memory: rgb and the (e rgb, e) array over the tile and halo R, the
// row sums, and the guidance and weight logits of every level (231,552
// bytes at L = 12, R = 12), else one level's guidance (217,728 at R = 32).
RT_API int rt_guided_filter_wide(const void* act, long long sc, long long sh,
                                 long long sw, const void* img, void* out,
                                 void* guards, int levels,
                                 const int* supports, int height, int width,
                                 void* stats, void* stream) {
  WideSupports sup;
  int R;
  if (!wide_supports(levels, supports, sup, R) || height < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  const bool small = R <= kW2SmallR;
  if (stats && !small) return (int)cudaErrorInvalidValue;
  const int TW = small ? 32 : 16, TH = small ? 32 : 8;
  const int RH = TH + 2 * R, RW = TW + 2 * R;
  // rgb and (e rgb, e) [RH][RW + 1], the row sums [RH][TW + 1]; with every
  // level staged, their guidance [L][RH][RW] and weight logits [L][TH][TW]
  // (bf16), else one level's guidance
  const int base = 2 * RH * (RW + 1) * 16 + RH * (TW + 1) * 16;
  const int all_bytes = base + levels * (RH * RW + TH * TW) * 2;
  const bool all = all_bytes + kW2Static <= kSmemOptin;
  const int bytes = all ? all_bytes : base + RH * RW * 2;
  if (bytes + kW2Static > kSmemOptin) return (int)cudaErrorInvalidValue;
  const bool vec = sc == 1 && sw % 8 == 0 && sh % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(act) % 16 == 0;
  auto kernel = stats   ? guided_filter_wide_kernel<32, 32, true>
                : small ? guided_filter_wide_kernel<32, 32, false>
                        : guided_filter_wide_kernel<16, 8, false>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((width + TW - 1) / TW, (height + TH - 1) / TH);
  kernel<<<grid, kW2Threads, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)act, sc, sh, sw, (const float4*)img,
      (float4*)out, (int*)guards, levels, sup, R, all, vec, height, width,
      (long long*)stats);
  return (int)cudaGetLastError();
}
