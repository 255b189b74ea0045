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
// the filtered rgb, the window max and the denominator (K5 keeps the last
// two for K6; K2 drops them).
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
// K5 and K6: the batched filter of the training step and its backward.
//
// They replace rt_octree_tpu/ops/filtering.py:guided_filter_batch (:188,
// jax.vmap of guided_filter) and its autodiff backward through the window
// max under stop_gradient (:64, :139-140); the reference's analytic backward
// is filtering.cu:230-301.  The JAX training step runs the fast global-max
// path with its runtime guard (:169-183); its gradient equals the exact
// one, and both kernels compute the exact (per-window max) form.
//
// K5 (guided_filter_batch_kernel): weight and guidance f32 [B, L, H, W],
// img f32 [B, H, W, 4] -> out [B, H, W, 4] (alpha 1), as K2 but with the
// level weights given (no softmax) and a batch index in blockIdx.z.  Per
// level of support s > 0 it also writes what the backward needs: fm
// [B, L, H, W, 4] = (f_r, f_g, f_b, m) and den [B, L, H, W] = D, the
// window max and the softmax denominator (support-0 levels write none).
// Saving them (20 B a pixel and level, 16 MB at 32 x 80 x 80, L = 4)
// spares K6 the forward's window sums.
//
// K6 (guided_filter_batch_bwd_kernel): G = dL/dout [B, H, W, 4] (rgb read)
// ->  dL/dw_lp = G_p . f_lp  and, with k_pq = exp(g_q - m_p) and
// a_p = w_lp / D_p,
//   dL/dg_q = sum_{p in N(q)} k_pq (a_p G_p . x_q - a_p G_p . f_lp),
// 0 on support-0 levels.  q in N(p) <=> p in N(q) (both windows clipped
// to the image), so each pixel q gathers over its own window: no atomics,
// and the sum's order is fixed.  A block stages, for its 32x8 tile and a
// halo of max(s), u_p = a_p G_p (rgb) and v_p = a_p G_p . f_lp as one
// float4 and m_p (+inf outside the image, where u = v = 0, so such a tap
// adds exp(-inf) * 0 = 0).  m_p >= g_q for every q in N(p), so k <= 1.
//
// Bound on this card: bytes.  K5 reads weight, guidance (8 B a pixel and
// level) and img (16 B), writes out (16 B) and fm, den (20 B a pixel and
// level); K6 reads G, img (32 B), weight, guidance, fm, den (28 B a pixel
// and level) and writes two gradients (8 B a pixel and level).  The exp
// and FMA work is one expf and ~5 FMAs a window tap.  Both are simple
// first versions: one pixel a thread, halos staged per level, no fast
// math, IEEE division.
// ---------------------------------------------------------------------------

namespace {

__global__ void __launch_bounds__(kTileW* kTileH, 4) guided_filter_batch_kernel(
    const float* __restrict__ weight, const float* __restrict__ guidance,
    const float4* __restrict__ img, float4* __restrict__ out,
    float4* __restrict__ fm, float* __restrict__ den, int levels,
    Supports sup, int R, int H, int W) {
  extern __shared__ float4 tile[];  // [TH][TW]: rgb, the level's guidance in .w
  const int TW = kTileW + 2 * R, TH = kTileH + 2 * R;
  float* rmax = reinterpret_cast<float*>(tile + TH * TW);  // [TH][kTileW]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const long long HW = (long long)H * W, pix = (long long)y * W + x;
  const long long b = blockIdx.z;
  img += b * HW;
  out += b * HW;
  weight += b * levels * HW;
  guidance += b * levels * HW;
  fm += b * levels * HW;
  den += b * levels * HW;

  for (int r = ty; r < TH; r += kTileH) {
    const int gy = y0 - R + r;
    for (int c = tx; c < TW; c += kTileW) {
      const int gx = x0 - R + c;
      tile[r * TW + c] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                             ? img[(long long)gy * W + gx]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  float o0 = 0.f, o1 = 0.f, o2 = 0.f;
  for (int l = 0; l < levels; ++l) {
    const int s = sup.s[l];
    const long long lo = l * HW;
    __syncthreads();  // rgb staged; the previous level's reads are done
    float f0 = 0.f, f1 = 0.f, f2 = 0.f;
    if (s == 0) {
      const float4 q = tile[(ty + R) * TW + tx + R];
      f0 = q.x;
      f1 = q.y;
      f2 = q.z;
    } else {
      const float* g = guidance + lo;
      for (int r = ty; r < TH; r += kTileH) {
        const int gy = y0 - R + r;
        for (int c = tx; c < TW; c += kTileW) {
          const int gx = x0 - R + c;
          tile[r * TW + c].w = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                                   ? g[(long long)gy * W + gx]
                                   : -INFINITY;
        }
      }
      __syncthreads();
      float m = 0.f, d = 0.f;
      filter_level_s(s, tile, rmax, R, TW, tx, ty, inside, f0, f1, f2, m, d);
      if (inside) {
        fm[lo + pix] = make_float4(f0, f1, f2, m);
        den[lo + pix] = d;
      }
    }
    if (!inside) continue;
    const float wl = weight[lo + pix];
    o0 = o0 + wl * f0;
    o1 = o1 + wl * f1;
    o2 = o2 + wl * f2;
  }
  if (inside) out[pix] = make_float4(o0, o1, o2, 1.f);
}

// dL/dg_q for one level of support S: the gather over q's window of the
// staged (u_p, v_p) and m_p, in the plain version's dy-outer order.
template <int S>
__device__ __forceinline__ float guidance_grad(const float4* uv,
                                               const float* mt, int R,
                                               int TW, int tx, int ty,
                                               float gq, float x0, float x1,
                                               float x2) {
  const int centre = (ty + R) * TW + tx + R;
  float acc = 0.f;
#pragma unroll
  for (int dy = -S; dy <= S; ++dy) {
#pragma unroll
    for (int dx = -S; dx <= S; ++dx) {
      const float4 q = uv[centre + dy * TW + dx];
      const float k = expf(gq - mt[centre + dy * TW + dx]);
      const float ux = q.x * x0 + q.y * x1 + q.z * x2;
      acc = acc + k * (ux - q.w);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kTileW* kTileH, 4)
    guided_filter_batch_bwd_kernel(
        const float4* __restrict__ grad, const float* __restrict__ weight,
        const float* __restrict__ guidance, const float4* __restrict__ img,
        const float4* __restrict__ fm, const float* __restrict__ den,
        float* __restrict__ gw, float* __restrict__ gg, int levels,
        Supports sup, int R, int H, int W) {
  extern __shared__ float4 uv[];  // [TH][TW]: (u_p rgb, v_p)
  const int TW = kTileW + 2 * R, TH = kTileH + 2 * R;
  float* mt = reinterpret_cast<float*>(uv + TH * TW);  // [TH][TW]: m_p
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const long long HW = (long long)H * W, pix = (long long)y * W + x;
  const long long b = blockIdx.z;
  grad += b * HW;
  img += b * HW;
  weight += b * levels * HW;
  guidance += b * levels * HW;
  fm += b * levels * HW;
  den += b * levels * HW;
  gw += b * levels * HW;
  gg += b * levels * HW;

  float4 Gq = make_float4(0.f, 0.f, 0.f, 0.f), xq = Gq;
  if (inside) {
    Gq = grad[pix];
    xq = img[pix];
  }
  for (int l = 0; l < levels; ++l) {
    const int s = sup.s[l];
    const long long lo = l * HW;
    if (inside) {
      const float4 f = s == 0 ? xq : fm[lo + pix];
      gw[lo + pix] = Gq.x * f.x + Gq.y * f.y + Gq.z * f.z;
      if (s == 0) gg[lo + pix] = 0.f;
    }
    if (s == 0) continue;
    __syncthreads();  // the previous level's reads are done
    for (int r = ty; r < TH; r += kTileH) {
      const int gy = y0 - R + r;
      for (int c = tx; c < TW; c += kTileW) {
        const int gx = x0 - R + c;
        float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
        float m = INFINITY;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
          const long long p = (long long)gy * W + gx;
          const float4 G = grad[p];
          const float4 f = fm[lo + p];
          const float a = weight[lo + p] / den[lo + p];
          const float gf = G.x * f.x + G.y * f.y + G.z * f.z;
          u = make_float4(G.x * a, G.y * a, G.z * a, a * gf);
          m = f.w;
        }
        uv[r * TW + c] = u;
        mt[r * TW + c] = m;
      }
    }
    __syncthreads();
    if (!inside) continue;
    const float gq = guidance[lo + pix];
    float acc;
    switch (s) {
      case 1: acc = guidance_grad<1>(uv, mt, R, TW, tx, ty, gq, xq.x, xq.y, xq.z); break;
      case 2: acc = guidance_grad<2>(uv, mt, R, TW, tx, ty, gq, xq.x, xq.y, xq.z); break;
      case 3: acc = guidance_grad<3>(uv, mt, R, TW, tx, ty, gq, xq.x, xq.y, xq.z); break;
      case 4: acc = guidance_grad<4>(uv, mt, R, TW, tx, ty, gq, xq.x, xq.y, xq.z); break;
      case 5: acc = guidance_grad<5>(uv, mt, R, TW, tx, ty, gq, xq.x, xq.y, xq.z); break;
      case 6: acc = guidance_grad<6>(uv, mt, R, TW, tx, ty, gq, xq.x, xq.y, xq.z); break;
      case 7: acc = guidance_grad<7>(uv, mt, R, TW, tx, ty, gq, xq.x, xq.y, xq.z); break;
      default: acc = guidance_grad<8>(uv, mt, R, TW, tx, ty, gq, xq.x, xq.y, xq.z); break;
    }
    gg[lo + pix] = acc;
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

}  // namespace

// weight, guidance: f32 [B, L, H, W]; img, out: f32 [B, H, W, 4]; fm: f32
// [B, L, H, W, 4]; den: f32 [B, L, H, W]; supports: host array of L ints.
RT_API int rt_guided_filter_batch(const void* weight, const void* guidance,
                                  const void* img, void* out, void* fm,
                                  void* den, int batch, int levels,
                                  const int* supports, int height, int width,
                                  void* stream) {
  Supports sup;
  int R;
  if (!batch_supports(batch, levels, supports, height, width, sup, R))
    return (int)cudaErrorInvalidValue;
  const int bytes = (kTileH + 2 * R) * (kTileW + 2 * R) * 16 +
                    (kTileH + 2 * R) * kTileW * 4;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (height + kTileH - 1) / kTileH, batch);
  guided_filter_batch_kernel<<<grid, block, bytes, (cudaStream_t)stream>>>(
      (const float*)weight, (const float*)guidance, (const float4*)img,
      (float4*)out, (float4*)fm, (float*)den, levels, sup, R, height, width);
  return (int)cudaGetLastError();
}

// grad: f32 [B, H, W, 4]; weight, guidance, den, gw, gg: f32 [B, L, H, W];
// img: f32 [B, H, W, 4]; fm: f32 [B, L, H, W, 4] as K5 wrote it.
RT_API int rt_guided_filter_batch_bwd(const void* grad, const void* weight,
                                      const void* guidance, const void* img,
                                      const void* fm, const void* den,
                                      void* gw, void* gg, int batch,
                                      int levels, const int* supports,
                                      int height, int width, void* stream) {
  Supports sup;
  int R;
  if (!batch_supports(batch, levels, supports, height, width, sup, R))
    return (int)cudaErrorInvalidValue;
  // at most (8 + 16) x (32 + 16) x 20 = 23040 bytes
  const int bytes = (kTileH + 2 * R) * (kTileW + 2 * R) * 20;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (height + kTileH - 1) / kTileH, batch);
  guided_filter_batch_bwd_kernel<<<grid, block, bytes,
                                   (cudaStream_t)stream>>>(
      (const float4*)grad, (const float*)weight, (const float*)guidance,
      (const float4*)img, (const float4*)fm, (const float*)den, (float*)gw,
      (float*)gg, levels, sup, R, height, width);
  return (int)cudaGetLastError();
}
