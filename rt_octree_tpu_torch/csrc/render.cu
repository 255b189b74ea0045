// K1: the fused per-pixel regular-tracking frame (one thread per pixel).
//
// Replaces, from rt_octree_tpu/render/renderer.py: device_camera_rays,
// rodrigues_jnp and maybe_world2ndc (:74-129); make_sorted_dst (:1138-1142)
// over utils/rng.py:pcg32_uniforms_range (:205-251); _init_march
// (:591-619); the leaf-step march _march_body/_query_step/_step_update
// (:200-268) with ops/traversal.py:tree_query_full (:449-526); the
// distinct-leaf shade _shade_rows (:757-779) with ops/sh.py; composite and
// aux_from_composite (:1207-1231).  Reference shape: volrend.cu:84-213 and
// rt_core.cuh:195-332.
//
// Bound on this card: the latency of dependent gathers.  Every leaf step
// makes one random 8-byte LUT read (plus chs reads for cells still internal
// at the LUT level) whose address depends on the previous step, and the
// slowest rays of the headline frame take ~200 steps while most end within
// ~16, so warps idle on the ray-length tail.  The arithmetic per step is a
// few dozen flops.  Design: one thread keeps the whole march state, the
// sorted thresholds and the SPP (leaf, count) records in registers (loops
// over slots are unrolled so the arrays never go to local memory for
// SPP <= 16), so device memory sees only the gathers, one f16 row per
// distinct hit leaf and the pixel's writes; 128-thread blocks keep many
// warps resident to hide the gather latency.  No wavefront compaction.
//
// Numerics: built with -fmad=false and without fast math.  The JAX
// expression order is kept (delta_t * delta_scale * sigma; invdir =
// 1/(d + 1e-9); the bbox +-1e-6 with tmin >= 0 and tmax <= 1e4) so that t,
// the optical depth and the DDA round as in the reference march; skip
// distances ride as f32 denormal bit patterns 1..255 in the LUT sigma lane
// and are read as integer bits.
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr uint64_t kPcgMult = 0x5851F42D4C957F2DULL;
constexpr int kMaxBasis = 25;

// Mirrored field for field by rt_octree_tpu_torch/render/renderer.py
// (_RenderParams): 8-byte members first, so the layout has no padding.
struct RenderParams {
  const float* transform;  // [3, 4] c2w, row-major
  const int2* chs;         // [M, 2] (child skip, sigma bits)
  const __half* data;      // [M, data_dim]
  const int2* lut;         // [res^3, 2] packed (depth << 27 | ptr, bits)
  const float* offset;     // [3]
  const float* scale;      // [3]
  const float* extra;      // SG / ASG basis parameters
  float* img;              // [H, W, 4]
  float* aux_nhwc;         // [H, W, 8]
  float* aux_chw;          // [8, H, W] or null
  float* uniforms;         // [H * W, spp] raw PCG32 uniforms, or null
  unsigned long long rng_state;
  unsigned long long rng_inc;
  float fx, fy;
  float step_size, sigma_thresh, background;
  float bbox[6];
  float rot[3];
  float ndc_ax, ndc_ay;  // -(2 focal / width), -(2 focal / height)
  int width, height, spp, max_steps;
  int N, lut_levels, max_depth, skip_cap;
  int basis_dim, data_dim, fmt, basis_lo, basis_hi, use_ndc;
};

// ---- PCG32 (renderer/3rdparty/pcg32.h; utils/rng.py:Pcg32) ----

__device__ __forceinline__ uint32_t pcg_next(uint64_t& state, uint64_t inc) {
  const uint64_t old = state;
  state = old * kPcgMult + inc;
  const uint32_t xorshifted = (uint32_t)(((old >> 18u) ^ old) >> 27u);
  const uint32_t rot = (uint32_t)(old >> 59u);
  return (xorshifted >> rot) | (xorshifted << ((0u - rot) & 31u));
}

__device__ __forceinline__ float pcg_next_float(uint64_t& state,
                                                uint64_t inc) {
  const uint32_t u = (pcg_next(state, inc) >> 9) | 0x3F800000u;
  return __uint_as_float(u) - 1.0f;
}

// Jump ahead by delta steps (Brown, arbitrary-stride advance).
__device__ uint64_t pcg_advance(uint64_t state, uint64_t inc,
                                uint64_t delta) {
  uint64_t cur_mult = kPcgMult, cur_plus = inc, acc_mult = 1, acc_plus = 0;
  while (delta > 0) {
    if (delta & 1) {
      acc_mult *= cur_mult;
      acc_plus = acc_plus * cur_mult + cur_plus;
    }
    cur_plus = (cur_mult + 1) * cur_plus;
    cur_mult *= cur_mult;
    delta >>= 1;
  }
  return acc_mult * state + acc_plus;
}

// ---- basis functions (ops/sh.py; lumisphere.hpp:8-91) ----

__device__ void eval_sh(int bd, float x, float y, float z, float* out) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  out[0] = 0.28209479177387814f;
  if (bd >= 4) {
    out[1] = -0.4886025119029199f * y;
    out[2] = 0.4886025119029199f * z;
    out[3] = -0.4886025119029199f * x;
  }
  if (bd >= 9) {
    out[4] = 1.0925484305920792f * xy;
    out[5] = -1.0925484305920792f * yz;
    out[6] = 0.31539156525252005f * (2.0f * zz - xx - yy);
    out[7] = -1.0925484305920792f * xz;
    out[8] = 0.5462742152960396f * (xx - yy);
  }
  if (bd >= 16) {
    out[9] = -0.5900435899266435f * y * (3.f * xx - yy);
    out[10] = 2.890611442640554f * xy * z;
    out[11] = -0.4570457994644658f * y * (4.f * zz - xx - yy);
    out[12] = 0.3731763325901154f * z * (2.f * zz - 3.f * xx - 3.f * yy);
    out[13] = -0.4570457994644658f * x * (4.f * zz - xx - yy);
    out[14] = 1.445305721320277f * z * (xx - yy);
    out[15] = -0.5900435899266435f * x * (xx - 3.f * yy);
  }
  if (bd >= 25) {
    out[16] = 2.5033429417967046f * xy * (xx - yy);
    out[17] = -1.7701307697799304f * yz * (3.f * xx - yy);
    out[18] = 0.9461746957575601f * xy * (7.f * zz - 1.0f);
    out[19] = -0.6690465435572892f * yz * (7.f * zz - 3.0f);
    out[20] = 0.10578554691520431f * (zz * (35.f * zz - 30.f) + 3.f);
    out[21] = -0.6690465435572892f * xz * (7.f * zz - 3.f);
    out[22] = 0.47308734787878004f * (xx - yy) * (7.f * zz - 1.0f);
    out[23] = -1.7701307697799304f * xz * (xx - 3.f * yy);
    out[24] = 0.6258357354491761f *
              (xx * (xx - 3.f * yy) - yy * (3.f * xx - yy));
  }
}

// fmt: BasisFormat value (1 SH, 2 SG, 3 ASG); masked by [lo, hi].
__device__ void eval_basis(const RenderParams& p, float x, float y, float z,
                           float* out) {
  const int bd = p.basis_dim;
  const float fbd = (float)bd;
  if (p.fmt == 1) {
    eval_sh(bd, x, y, z, out);
  } else if (p.fmt == 2) {
    for (int b = 0; b < bd; ++b) {
      const float* q = p.extra + 4 * b;
      const float dot = x * q[1] + y * q[2] + z * q[3];
      out[b] = expf(q[0] * (dot - 1.0f)) / fbd;
    }
  } else if (p.fmt == 3) {
    for (int b = 0; b < bd; ++b) {
      const float* q = p.extra + 11 * b;
      const float S = x * q[8] + y * q[9] + z * q[10];
      const float dx = x * q[2] + y * q[3] + z * q[4];
      const float dy = x * q[5] + y * q[6] + z * q[7];
      out[b] = S * expf(-q[0] * dx * dx - q[1] * dy * dy) / fbd;
    }
  } else {
    for (int b = 0; b < bd; ++b) out[b] = 0.f;
  }
  for (int b = 0; b < bd; ++b)
    if (b < p.basis_lo || b > p.basis_hi) out[b] = 0.f;
}

// ---- tree query (ops/traversal.py:tree_query_full) ----

struct Leaf {
  int ptr;
  float cube;
  int bits;  // f32 sigma bits; skip distance 1..255 in empty LUT cells
};

// posc: the position clipped to [0, 1 - 1e-6]^3.
__device__ __forceinline__ Leaf query_leaf(const RenderParams& p,
                                           const float posc[3]) {
  const int N = p.N;
  const float fN = (float)N;
  const int N3 = N * N * N;
  Leaf leaf{0, 0.f, 0};
  bool done = false;
  int node = 0;
  float xyz[3];
  float cur_cube;
  int levels_left;
  if (p.lut_levels > 0) {
    const int res = rt::ipow(N, p.lut_levels);
    const float fres = (float)res;
    int c[3];
    for (int i = 0; i < 3; ++i) {
      const float sc = posc[i] * fres;
      const float fl = floorf(sc);
      c[i] = min(max((int)fl, 0), res - 1);
      xyz[i] = sc - fl;
    }
    const long long flat = ((long long)c[0] * res + c[1]) * res + c[2];
    const int2 row = p.lut[flat];
    const int depth = (int)(((uint32_t)row.x >> rt::kLutPtrBits) & 31u);
    const int ptr = (int)((uint32_t)row.x & rt::kLutPtrMask);
    leaf.bits = row.y;
    if (depth < rt::kLutDepthSentinel) {
      done = true;
      leaf.ptr = ptr;
      float cube = 1.f;
      for (int i = 0; i < depth; ++i) cube *= fN;
      leaf.cube = cube;
    } else {
      node = ptr;
    }
    cur_cube = 1.f;
    for (int i = 0; i <= p.lut_levels; ++i) cur_cube *= fN;
    levels_left = p.max_depth - p.lut_levels;
  } else {
    for (int i = 0; i < 3; ++i) xyz[i] = posc[i];
    cur_cube = fN;
    levels_left = p.max_depth;
  }
  for (int l = 0; l < levels_left && !done; ++l) {
    float d[3];
    for (int i = 0; i < 3; ++i) {
      const float v = xyz[i] * fN;
      d[i] = floorf(v);
      xyz[i] = v - d[i];
    }
    const int index = (int)((d[0] * fN + d[1]) * fN + d[2]);
    const int sub = node * N3 + index;
    const int2 row = p.chs[sub];
    if (row.x == 0) {
      done = true;
      leaf.ptr = sub;
      leaf.cube = cur_cube;
      leaf.bits = row.y;
    } else {
      node += row.x;
    }
    cur_cube *= fN;
  }
  return leaf;
}

template <int SPP>
__global__ void __launch_bounds__(128) render_kernel(const RenderParams p) {
  const int W = p.width, H = p.height;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= W * H) return;
  const int px = idx % W, py = idx / W;
  const float* T = p.transform;

  // ---- camera ray (device_camera_rays: integer pixel coords) ----
  const float xs = ((float)px - 0.5f * (float)W) / p.fx;
  const float ys = -(((float)py - 0.5f * (float)H) / p.fy);
  const float zs = -1.0f;
  float dir[3];
  for (int i = 0; i < 3; ++i)
    dir[i] = xs * T[i * 4] + ys * T[i * 4 + 1] + zs * T[i * 4 + 2];
  {
    const float nrm = sqrtf(dir[0] * dir[0] + dir[1] * dir[1] +
                            dir[2] * dir[2]);
    for (int i = 0; i < 3; ++i) dir[i] = dir[i] / nrm;
  }
  float cen[3] = {T[3], T[7], T[11]};

  // ---- view direction (rodrigues_jnp) ----
  float vdir[3] = {dir[0], dir[1], dir[2]};
  {
    const float* a = p.rot;
    const float angle = sqrtf(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
    if (!(angle < 1e-6f)) {
      const float safe = fmaxf(angle, 1e-12f);
      const float k[3] = {a[0] / safe, a[1] / safe, a[2] / safe};
      const float ca = cosf(angle), sa = sinf(angle);
      const float cr[3] = {k[1] * dir[2] - k[2] * dir[1],
                           k[2] * dir[0] - k[0] * dir[2],
                           k[0] * dir[1] - k[1] * dir[0]};
      const float dot = dir[0] * k[0] + dir[1] * k[1] + dir[2] * k[2];
      for (int i = 0; i < 3; ++i)
        vdir[i] = dir[i] * ca + cr[i] * sa + k[i] * dot * (1.0f - ca);
    }
  }

  // ---- LLFF NDC warp (maybe_world2ndc) ----
  if (p.use_ndc) {
    const float t = -(1.0f + cen[2]) / dir[2];
    for (int i = 0; i < 3; ++i) cen[i] = cen[i] + t * dir[i];
    float nd[3] = {p.ndc_ax * (dir[0] / dir[2] - cen[0] / cen[2]),
                   p.ndc_ay * (dir[1] / dir[2] - cen[1] / cen[2]),
                   -2.0f / cen[2]};
    const float nc[3] = {p.ndc_ax * (cen[0] / cen[2]),
                         p.ndc_ay * (cen[1] / cen[2]),
                         1.0f + 2.0f / cen[2]};
    const float nrm = sqrtf(nd[0] * nd[0] + nd[1] * nd[1] + nd[2] * nd[2]);
    for (int i = 0; i < 3; ++i) {
      dir[i] = nd[i] / nrm;
      cen[i] = nc[i];
    }
  }

  // ---- sorted free-flight thresholds (pcg32 at idx*spp + j) ----
  float dst[SPP];
  {
    uint64_t state = pcg_advance(p.rng_state, p.rng_inc,
                                 (uint64_t)idx * (uint64_t)SPP);
#pragma unroll
    for (int j = 0; j < SPP; ++j) {
      const float u = pcg_next_float(state, p.rng_inc);
      if (p.uniforms) p.uniforms[(long long)idx * SPP + j] = u;
      dst[j] = -log1pf(-u);
    }
#pragma unroll
    for (int j = 1; j < SPP; ++j) {  // insertion sort, unrolled
#pragma unroll
      for (int k = j; k > 0; --k) {
        const float lo = fminf(dst[k - 1], dst[k]);
        const float hi = fmaxf(dst[k - 1], dst[k]);
        dst[k - 1] = lo;
        dst[k] = hi;
      }
    }
  }

  // ---- march setup (_init_march, _dda_world) ----
  float cen_t[3], d_t[3], invdir[3];
  for (int i = 0; i < 3; ++i) {
    cen_t[i] = p.offset[i] + p.scale[i] * cen[i];
    d_t[i] = dir[i] * p.scale[i];
  }
  const float delta_scale =
      1.0f / sqrtf(d_t[0] * d_t[0] + d_t[1] * d_t[1] + d_t[2] * d_t[2]);
  for (int i = 0; i < 3; ++i) {
    d_t[i] = d_t[i] * delta_scale;
    invdir[i] = 1.0f / (d_t[i] + 1e-9f);
  }
  float tmin = 0.0f, tmax = 1e4f;
  {
    float mn = -INFINITY, mx = INFINITY;
    for (int i = 0; i < 3; ++i) {
      const float t1 = (p.bbox[i] + 1e-6f - cen_t[i]) * invdir[i];
      const float t2 = (p.bbox[i + 3] - 1e-6f - cen_t[i]) * invdir[i];
      mn = fmaxf(mn, fminf(t1, t2));
      mx = fminf(mx, fmaxf(t1, t2));
    }
    tmin = fmaxf(0.0f, mn);
    tmax = fminf(1e4f, mx);
  }
  tmax = fminf(tmax, 1e9f / delta_scale);
  bool active = (tmax >= 0.0f) && (tmin <= tmax);

  // ---- the leaf-step march (_query_step + _step_update) ----
  const float clip_hi = (float)(1.0 - 1e-6);
  const float skip_res = (float)rt::ipow(p.N, p.lut_levels);
  float t = tmin, src = 0.0f;
  int sppc = 0, shn = 0;
  int rec_ptr[SPP], rec_cnt[SPP];
#pragma unroll
  for (int k = 0; k < SPP; ++k) rec_ptr[k] = rec_cnt[k] = 0;

  for (int step = 0; step < p.max_steps && active; ++step) {
    float posc[3];
    for (int i = 0; i < 3; ++i)
      posc[i] = fminf(fmaxf(cen_t[i] + t * d_t[i], 0.0f), clip_hi);
    const Leaf leaf = query_leaf(p, posc);
    float t_unit = 1e4f;
    for (int i = 0; i < 3; ++i) {
      float local = posc[i] * leaf.cube;
      local = local - floorf(local);
      const float t1 = -local * invdir[i];
      const float t2 = t1 + invdir[i];
      t_unit = fminf(t_unit, fmaxf(t1, t2));
    }
    float t_sub = t_unit / leaf.cube;
    if (p.skip_cap > 0) {
      const int dist_i = (leaf.bits > 0 && leaf.bits <= 255) ? leaf.bits : 1;
      if (dist_i > 1) {
        const float dist = (float)dist_i;
        float t_box = INFINITY;
        for (int i = 0; i < 3; ++i) {
          const float cell = floorf(posc[i] * skip_res);
          const float lo = (cell - (dist - 1.0f)) / skip_res;
          const float hi = (cell + dist) / skip_res;
          t_box = fminf(t_box, fmaxf((lo - posc[i]) * invdir[i],
                                     (hi - posc[i]) * invdir[i]));
        }
        t_sub = fmaxf(t_sub, t_box);
      }
    }

    const float sigma = __int_as_float(leaf.bits);
    const float delta_t = t_sub + p.step_size;
    const bool has_sigma = sigma > p.sigma_thresh;
    const float delta = has_sigma ? delta_t * delta_scale * sigma : 0.0f;
    const float s_new = src + delta;
    int n_leq = 0;
#pragma unroll
    for (int k = 0; k < SPP; ++k) n_leq += dst[k] <= s_new ? 1 : 0;
    const int c = max(n_leq - sppc, 0);
    if (has_sigma && c > 0) {
#pragma unroll
      for (int k = 0; k < SPP; ++k) {
        if (k == shn) {
          rec_ptr[k] = leaf.ptr;
          rec_cnt[k] = c;
        }
      }
      shn += 1;
      sppc += c;
    }
    if (has_sigma) src = s_new;
    t = t + delta_t;
    active = (t < tmax) && (sppc < SPP);
  }

  // ---- shade the distinct hit leaves (_shade_rows) ----
  float rgb[3] = {0.f, 0.f, 0.f};
  float wsum = 0.f;
  if (shn > 0) {
    float basis[kMaxBasis];
    const int bd = p.basis_dim;
    if (bd >= 0) eval_basis(p, vdir[0], vdir[1], vdir[2], basis);
#pragma unroll
    for (int k = 0; k < SPP; ++k) {
      if (k < shn) {
        const __half* row = p.data + (long long)rec_ptr[k] * p.data_dim;
        const float w = (float)rec_cnt[k];
        for (int ch = 0; ch < 3; ++ch) {
          float v;
          if (bd >= 0) {
            float logit = 0.f;
            for (int b = 0; b < bd; ++b)
              logit = logit + __half2float(row[ch * bd + b]) * basis[b];
            v = 1.0f / (1.0f + expf(-logit));
          } else {
            v = __half2float(row[ch]);
          }
          rgb[ch] = rgb[ch] + v * w;
        }
        wsum = wsum + w;
      }
    }
  }
  const float fspp = (float)SPP;
  const float alpha = wsum / fspp;

  // ---- composite + aux (composite, aux_from_composite) ----
  const float nalpha = 1.0f - alpha;
  float outc[4];
  for (int ch = 0; ch < 3; ++ch)
    outc[ch] = rgb[ch] / fspp + p.background * nalpha;
  outc[3] = alpha;
  const long long HW = (long long)W * H;
  float* im = p.img + (long long)idx * 4;
  im[0] = outc[0];
  im[1] = outc[1];
  im[2] = outc[2];
  im[3] = 1.0f;
  float* an = p.aux_nhwc + (long long)idx * 8;
  for (int ch = 0; ch < 4; ++ch) {
    an[ch] = outc[ch];
    an[ch + 4] = outc[ch] * outc[ch];
  }
  if (p.aux_chw) {
    for (int ch = 0; ch < 4; ++ch) {
      p.aux_chw[ch * HW + idx] = outc[ch];
      p.aux_chw[(ch + 4) * HW + idx] = outc[ch] * outc[ch];
    }
  }
}

template <int SPP>
int launch(const RenderParams& p, cudaStream_t stream) {
  const int n = p.width * p.height;
  const int threads = 128;
  render_kernel<SPP><<<(n + threads - 1) / threads, threads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// One frame; spp must be one of 1, 2, 3, 4, 6, 8, 16, 32 (volrend.cu:266-278).
RT_API int rt_render(const RenderParams* params, void* stream) {
  const RenderParams p = *params;
  cudaStream_t s = (cudaStream_t)stream;
  switch (p.spp) {
    case 1: return launch<1>(p, s);
    case 2: return launch<2>(p, s);
    case 3: return launch<3>(p, s);
    case 4: return launch<4>(p, s);
    case 6: return launch<6>(p, s);
    case 8: return launch<8>(p, s);
    case 16: return launch<16>(p, s);
    case 32: return launch<32>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// sizeof(RenderParams), checked by the Python binding against its mirror.
RT_API int rt_render_params_size() { return (int)sizeof(RenderParams); }
