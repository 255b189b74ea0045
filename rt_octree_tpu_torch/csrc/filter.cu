// K2: the multi-level guided softmax filter (the denoiser's reconstruction).
//
// Replaces rt_octree_tpu/ops/filtering.py:guided_filter (:153-185) with its
// exact path _filter_all_exact/_level_exact/_window_max (:50-77, :128-133);
// the reference kernel is filtering.cu:108-228.
//
// One thread per pixel.  For each level l with support s (window 2s+1):
//   gmax = max of guidance[l] over the in-image window (-inf outside),
//   f    = sum_q exp(g_q - gmax) rgb_q / sum_q exp(g_q - gmax),
//   out += weight[l] * f;
// a support-0 level is the pixel itself (the 1x1 softmax is the identity),
// and output alpha is 1.  The per-window max keeps every window's dominant
// logit at exp(0), so no global-range guard is needed (the JAX fast path's
// FAST_SAFE_RANGE fallback, filtering.py:169-183, has no counterpart here).
//
// Bound on this card: at 800x800 with supports (0,1,2,3) a pixel reads
// 9+25+49 guidance taps twice (max, then sum) and 83 rgb taps, all from
// L1/L2 (neighbouring threads share taps); one expf per tap.  The device
// memory traffic is only the inputs and the output once (~30 MB), so the
// kernel is bound by L1 load throughput and the expf rate.  A shared-memory
// tile per block is later work.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;

struct Supports {
  int s[kMaxLevels];
};

__global__ void guided_filter_kernel(const float* __restrict__ weight,
                                     const float* __restrict__ guidance,
                                     const float* __restrict__ img,
                                     int channels, float* __restrict__ out,
                                     int levels, Supports sup, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long HW = (long long)H * W;
  const long long p = (long long)y * W + x;
  float o0 = 0.f, o1 = 0.f, o2 = 0.f;
  for (int l = 0; l < levels; ++l) {
    const int s = sup.s[l];
    const float wl = weight[l * HW + p];
    float f0, f1, f2;
    if (s == 0) {
      f0 = img[p * channels];
      f1 = img[p * channels + 1];
      f2 = img[p * channels + 2];
    } else {
      const float* G = guidance + l * HW;
      float gmax = -INFINITY;
      for (int dy = -s; dy <= s; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= H) continue;
        for (int dx = -s; dx <= s; ++dx) {
          const int xx = x + dx;
          if (xx < 0 || xx >= W) continue;
          gmax = fmaxf(gmax, G[(long long)yy * W + xx]);
        }
      }
      float n0 = 0.f, n1 = 0.f, n2 = 0.f, den = 0.f;
      for (int dy = -s; dy <= s; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= H) continue;
        for (int dx = -s; dx <= s; ++dx) {
          const int xx = x + dx;
          if (xx < 0 || xx >= W) continue;
          const long long q = (long long)yy * W + xx;
          const float k = expf(G[q] - gmax);
          den = den + k;
          n0 = n0 + img[q * channels] * k;
          n1 = n1 + img[q * channels + 1] * k;
          n2 = n2 + img[q * channels + 2] * k;
        }
      }
      f0 = n0 / den;
      f1 = n1 / den;
      f2 = n2 / den;
    }
    o0 = o0 + wl * f0;
    o1 = o1 + wl * f1;
    o2 = o2 + wl * f2;
  }
  out[p * 4] = o0;
  out[p * 4 + 1] = o1;
  out[p * 4 + 2] = o2;
  out[p * 4 + 3] = 1.f;
}

}  // namespace

// weight, guidance: [L, H, W] f32; img: [H, W, channels >= 3] f32;
// out: [H, W, 4] f32; supports: host array of L ints (L <= 8).
RT_API int rt_guided_filter(const void* weight, const void* guidance,
                            const void* img, int channels, void* out,
                            int levels, const int* supports, int height,
                            int width, void* stream) {
  if (levels < 1 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Supports sup{};
  for (int l = 0; l < levels; ++l) sup.s[l] = supports[l];
  const dim3 block(16, 16);
  const dim3 grid((width + 15) / 16, (height + 15) / 16);
  guided_filter_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)weight, (const float*)guidance, (const float*)img,
      channels, (float*)out, levels, sup, height, width);
  return (int)cudaGetLastError();
}
