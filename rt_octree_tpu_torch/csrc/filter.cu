// K2: the multi-level guided softmax filter (the denoiser's reconstruction),
// fed straight from the GuidanceNet's last activation.
//
// Replaces rt_octree_tpu/ops/filtering.py:guided_filter (:153-185) with its
// exact path _filter_all_exact/_level_exact/_window_max (:50-77, :128-133),
// and the split of the net's output (models/guidance_net.py:138-143); the
// reference kernel is filtering.cu:108-228.
//
// Input: the net's last bf16 activation x [1, 2L, H, W], read through its
// strides (cuDNN may hand it back in channels-last strides; nothing is
// copied).  Prologue, per pixel: the level weights w = softmax(x[:L]) in
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
// column pass and the exp-weighted sums, unrolled over the window.
template <int S>
__device__ __forceinline__ void filter_level(const float4* tile, float* rmax,
                                             int R, int TW, int tx, int ty,
                                             bool inside, float& f0,
                                             float& f1, float& f2) {
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
      switch (s) {
        case 1: filter_level<1>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2); break;
        case 2: filter_level<2>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2); break;
        case 3: filter_level<3>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2); break;
        case 4: filter_level<4>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2); break;
        case 5: filter_level<5>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2); break;
        case 6: filter_level<6>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2); break;
        case 7: filter_level<7>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2); break;
        default: filter_level<8>(tile, rmax, R, TW, tx, ty, inside, f0, f1, f2); break;
      }
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
