// K4: fast mode's joint upsample of the inner frame.
//
// Replaces, from rt_octree_tpu/render/renderer.py: the two
// jax.image.resize(..., "bilinear") calls of _render_frame_impl
// (:1302-1305) on the image and the composited rows, with
// aux_from_composite (:1312-1315) on the result; in the split-phase path
// _fast_upsample_jit (:1509-1517).
//
// Input: K1's inner-size aux_nhwc [h, w, 8] (rgba, rgba^2; 32 B a pixel),
// of which only the rgba half is read, as one float4 per tap.  Output
// pixel (x, y) samples the source coordinate (i + 0.5) * (in / out) - 0.5
// on each axis (JAX's bilinear when upsampling; one fmaf, so rounded
// once), clamps the two taps at
// the edge, and lerps along x on both source rows, then along y, each as
// (1 - w) * a + w * b.  It writes img [H, W, 4] as (rgb, 1), aux_nhwc
// [H, W, 8] as (v, v * v), and, when asked, aux_chw [8, H, W]: the squares
// are taken after the upsample, as aux_from_composite takes them.
//
// Bound on this card: bytes.  16 B read per inner pixel (each read by
// about (out / in)^2 threads, so from L1/L2 after the first) and 48 B
// written per output pixel, 80 B with aux_chw; the arithmetic is a dozen
// flops a channel.  Design: one thread per output pixel in row order, so
// a warp's float4 stores cover 512 contiguous bytes of img and 1 KB of
// aux_nhwc; aux_chw's eight planes get coalesced 4-byte stores.  Built
// with -fmad=false (only the explicit fmaf fuses) so that the plain
// version (ops/resize.py) repeats the kernel's rounding.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float w) {
  const float u = 1.0f - w;
  return make_float4(u * a.x + w * b.x, u * a.y + w * b.y, u * a.z + w * b.z,
                     u * a.w + w * b.w);
}

// Source taps and the second tap's weight along one axis.
__device__ __forceinline__ void taps(int i, float step, int n_in, int& i0,
                                     int& i1, float& w) {
  // one rounding, as XLA's fused multiply-add (ops/resize.py:_src_taps)
  const float s = fmaf((float)i + 0.5f, step, -0.5f);
  const float f = floorf(s);
  w = s - f;
  i0 = min(max((int)f, 0), n_in - 1);
  i1 = min(max((int)f + 1, 0), n_in - 1);
}

__global__ void __launch_bounds__(kThreads) upsample_kernel(
    const float4* __restrict__ src, int h, int w, float sy, float sx,
    float4* __restrict__ img, float4* __restrict__ aux_nhwc,
    float* __restrict__ aux_chw, int H, int W) {
  const long long HW = (long long)H * W;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= HW) return;
  const int x = (int)(i % W), y = (int)(i / W);
  int y0, y1, x0, x1;
  float wy, wx;
  taps(y, sy, h, y0, y1, wy);
  taps(x, sx, w, x0, x1, wx);
  // the rgba half of each 32-byte source pixel
  const float4 a = __ldg(src + 2 * ((long long)y0 * w + x0));
  const float4 b = __ldg(src + 2 * ((long long)y0 * w + x1));
  const float4 c = __ldg(src + 2 * ((long long)y1 * w + x0));
  const float4 d = __ldg(src + 2 * ((long long)y1 * w + x1));
  const float4 v = lerp4(lerp4(a, b, wx), lerp4(c, d, wx), wy);
  const float4 sq = make_float4(v.x * v.x, v.y * v.y, v.z * v.z, v.w * v.w);
  img[i] = make_float4(v.x, v.y, v.z, 1.0f);
  aux_nhwc[2 * i] = v;
  aux_nhwc[2 * i + 1] = sq;
  if (aux_chw) {
    aux_chw[i] = v.x;
    aux_chw[HW + i] = v.y;
    aux_chw[2 * HW + i] = v.z;
    aux_chw[3 * HW + i] = v.w;
    aux_chw[4 * HW + i] = sq.x;
    aux_chw[5 * HW + i] = sq.y;
    aux_chw[6 * HW + i] = sq.z;
    aux_chw[7 * HW + i] = sq.w;
  }
}

}  // namespace

// src: [h, w, 8] f32; sy = f32(h) / f32(H), sx = f32(w) / f32(W); aux_chw
// may be null.  One launch.
RT_API int rt_upsample(const void* src, int h, int w, float sy, float sx,
                       void* img, void* aux_nhwc, void* aux_chw, int H, int W,
                       void* stream) {
  if (h <= 0 || w <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const long long HW = (long long)H * W;
  upsample_kernel<<<(unsigned)((HW + kThreads - 1) / kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>(
      static_cast<const float4*>(src), h, w, sy, sx,
      static_cast<float4*>(img), static_cast<float4*>(aux_nhwc),
      static_cast<float*>(aux_chw), H, W);
  return (int)cudaGetLastError();
}
