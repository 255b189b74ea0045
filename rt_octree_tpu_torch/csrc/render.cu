// K1: the fused per-pixel regular-tracking frame.
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
// at the LUT level) whose address depends on the previous step; the
// arithmetic per step is a few dozen flops.  A warp runs as long as its
// longest ray, and ray lengths have a long tail (headline frame: half the
// rays miss the tree and take no step, the 99th percentile takes 69, the
// longest 174), so the lanes of a warp idle on its slowest ray.  Design:
// one thread per pixel, each warp an 8x4 pixel tile (a block of 4 warps is
// 32x4 pixels).  Neighbouring rays take similar step counts and read
// neighbouring LUT cells, so a warp idles less than on a row of 32 pixels
// (lane efficiency 0.76 against 0.58 on the headline frame, chip_smoke.py's
// statistics line).  A ray's whole state (sorted thresholds, records, t,
// optical depth) lives in registers: loops over slots are unrolled so the
// arrays never go to local memory.  The LUT and chs are read through the
// read-only path as int2, a leaf's f16 row as 8-byte words, and the
// pixel's img and aux_nhwc as one and two float4 stores.
//
// (A persistent-warp schedule that refills idle lanes from a global ray
// counter, Aila and Laine, HPG 2009, ran 3x slower here: its lanes shade
// and set up rays out of step with each other, so a warp pays the
// shading's dependent loads once per ray instead of once per tile, while
// the tiles leave only a quarter of the lane time idle.  L2 prefetches of
// the guessed next LUT cell and of each recorded data row made the frame
// slower, not faster: the LUT cells a warp reads are mostly in the L2
// already, and the extra address arithmetic sits on the step's chain.)
//
// The tiles decide only which thread marches which ray: a ray's arithmetic
// and its PCG32 position (idx * SPP, idx = y * W + x) are those of a
// row-order launch, so its outputs are bit for bit the same.
//
// Row band (row0, rows): the grid covers the tiles of frame rows [row0,
// row0 + rows) only.  A pixel keeps its frame row y, so its ray, its NDC
// warp and its PCG32 position are the full frame's; it is written at
// (y - row0) * W + x of [rows, W, ...] outputs.  row0 = 0, rows = H is the
// whole frame.  The multi-device frame (parallel/mesh.py) marches one band
// a rank.
//
// Numerics: built with -fmad=false and without fast math.  The JAX
// expression order is kept (delta_t * delta_scale * sigma; invdir =
// 1/(d + 1e-9); the bbox +-1e-6 with tmin >= 0 and tmax <= 1e4) so that t,
// the optical depth and the DDA round as in the reference march; skip
// distances ride as f32 denormal bit patterns 1..255 in the LUT sigma lane
// and are read as integer bits.
//
// Statistics variant (kStats, compiled out of the frame's instantiation):
// per pixel the leaf steps and chs descents, and bitmaps of every LUT cell,
// chs row and data row the frame reads (atomicOr), from which the caller
// counts the distinct bytes the frame needs.
//
// Mesh inputs (mesh_color [R, 3], mesh_depth [R], both null or both set; a
// rasterized mesh pass, render/raster.py): the ray's tmax becomes
// min(tmax, min(mesh_depth, 1e9) / delta_scale) (_init_march, :600-607,
// with the 1e9 clamp of _render_noisy, :1176-1177) and the pixel's mesh
// colour replaces the background in the composite (composite, :1207-1218).
// With null pointers every operation is the one without a mesh: 1e9 is
// the clamp's own value.
//
// Classic variant (render_classic_kernel, launch name "render_classic"):
// the counterpart of trace_rays_classic (:1060-1131; shaders/rt.frag
// :222-327).  No PCG32 is drawn; the masked basis is evaluated once per
// ray, and every leaf step with sigma > sigma_thresh shades its leaf:
// att = min(expf(-delta_t * delta_scale * sigma), 1), rgb += light * (1 -
// att) * leaf rgb, light *= att; once light < stop_thresh, rgb /= 1 -
// light, light = 0 and the ray stops.  The output is [rgb, 1 - light]
// into the same composite and aux.  The JAX loop tests its step limit every
// 2 steps (unroll=2, :1117-1125), so a ray stops after max_steps rounded up
// to even; the kernel does the same.  Its bound is the same dependent LUT
// chain as the rt march, with a shade (a data row and 6 bd + 16 flops) on
// every step that meets density.  Two things keep the shade off that
// chain.  The kernel is instantiated on the tree's row layout (SH at
// basis_dim 1, 4, 9, 16, 25, raw rgb, and one SG / ASG instance unrolled
// over kMaxBasis), so the basis stays in registers and a row's loads are
// all issued at once.  And the march runs one step ahead of the shade: a
// step's weight, light, stop test and next t need only its sigma, so the
// row of step i is loaded while step i + 1's LUT read is in flight and
// summed after it, in step order (render_classic_kernel).
//
// Wide rows (kWide, kBdWide, kBdWideChunked; launch names with "_wide"):
// SG and ASG trees of a basis_dim above kMaxBasis, which the JAX package
// renders too.  Their instances of K1 (frame and ray mode at every SPP)
// know every shaded row once the march ends: finish_ray prefetches all
// their lines into L2, evaluates the ray's masked basis once into shared
// memory, [b][thread], as the chunked classic instance does (the whole
// basis up to kWideFullBasis values, else a prefix of kWideCapPrefix and
// the tail row by row), and reads each row as the 16-byte pieces that
// cover it (ChunkedRow::channels), in the order of b.  render_classic's
// wide instance (frame and ray mode, up to kWideSmemMaxBasis) evaluates
// the ray's masked basis once into shared memory, [b][thread], and copies
// each shaded row a step ahead into a shared slot of its thread by
// cp.async (ClassicRow<kBdWide>); above kWideSmemMaxBasis the chunked
// instance (kBdWideChunked, launch names with "_wide_chunked") evaluates
// the ray's masked basis once into shared memory too, up to a prefix of
// kChunkedMaxPrefix values, keeps no row slot (so that four blocks share
// an SM at basis_dim 96) and reads each shaded row as 16-byte pieces,
// its lines prefetched into L2 a step ahead (ClassicRow<kBdWideChunked>).
// Both compute the same f32 operations in the same order, so their
// outputs are equal bit for bit.  None has a statistics variant; every
// other instance is as it was.
//
// Ray mode (kRays; C entry rt_render_rays, launch names "render_rays" and
// "render_classic_rays"): the counterparts of trace_rays (:540-588) and
// trace_rays_classic over a caller's ray batch.  One thread a ray, a warp
// for 32 consecutive rays of the caller's order, 64-bit indices.  A ray's
// dir, cen and vdir are read as given (already NDC-warped and rotated; not
// normalised: delta_scale = 1 / |dir * scale| and the basis takes vdir as
// it is), its world depth ray_tmax as given (no 1e9 clamp; 1e9 without
// one), its sorted thresholds from ray_dst (no PCG32); vdir and the
// thresholds only once init_march finds that the ray enters the box (a
// miss writes 0 from its dir, cen and depth).  The march set-up
// (init_march), the leaf step and the shade are the frame's; the output is
// [rgb, alpha] before the background into ray_out, with no composite and no
// aux.  The classic ray mode takes its step limit as the wrapper rounds it
// (ceil(max_steps / unroll) * unroll).  No statistics variant.  A ray's
// arithmetic does not depend on its place, so its output is the same bit
// for bit in any order of the batch.  The order sets the time (the
// headline's 640,000 rays: 0.2775 ms in row order, 0.7436 in a seeded
// permutation).  A pass that sorted the batch by a Morton key of its box
// entries before the march (a key kernel and a two-pass radix sort, five
// launches, 0.056 ms) cut the permuted batch to 0.363 ms, but made the
// row-order camera batches that every caller sends 15 % slower (0.319
// ms): the march gained 0.015 ms there.  It is not kept (PERF.md).
#include <cuda_fp16.h>

#include <climits>
#include <cstring>

#include "common.cuh"

namespace {

constexpr uint64_t kPcgMult = 0x5851F42D4C957F2DULL;
constexpr int kMaxBasis = 25;
constexpr int kThreads = 128;
constexpr int kTileW = 8, kTileH = 4;  // one warp's pixel tile

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
  int* stat_steps;         // [H * W] leaf steps, or null (not a stats run)
  int* stat_descents;      // [H * W] chs reads
  unsigned* lut_bits;      // [ceil(res^3 / 32)] LUT cells read
  unsigned* chs_bits;      // [ceil(M / 32)] chs rows read
  unsigned* data_bits;     // [ceil(M / 32)] data rows shaded
  int* stat_shaded;        // [H * W] shaded leaf steps (classic stats run)
  const float* mesh_color; // [H * W, 3] or null (no mesh pass)
  const float* mesh_depth; // [H * W] ray distance, +inf where no mesh
  const float* ray_dirs;   // ray mode: [n_rays, 3] world dirs (NDC-warped)
  const float* ray_vdirs;  // [n_rays, 3] view dirs of the basis
  const float* ray_cens;   // [n_rays, 3] world origins (NDC-warped)
  const float* ray_dst;    // [n_rays, spp] sorted thresholds (rt only)
  const float* ray_tmax;   // [n_rays] world depth, or null (1e9)
  float* ray_out;          // [n_rays, 4] premultiplied rgb, alpha
  unsigned long long rng_state;
  unsigned long long rng_inc;
  long long n_rays;        // ray mode's batch; 0 for a frame
  float fx, fy;
  float step_size, sigma_thresh, background, stop_thresh;
  float bbox[6];
  float rot[3];
  float rot_cos, rot_sin;  // of |rot|, rounded from double by the wrapper
  float ndc_ax, ndc_ay;  // -(2 focal / width), -(2 focal / height)
  int width, height, spp, max_steps;
  int N, lut_levels, max_depth, skip_cap;
  int basis_dim, data_dim, fmt, basis_lo, basis_hi, use_ndc;
  int classic;  // 0: render_kernel; else a ClassicLayout
  int row0, rows;  // the band of frame rows marched: [row0, row0 + rows)
};

__device__ __forceinline__ void mark(unsigned* bits, long long i) {
  atomicOr(bits + (i >> 5), 1u << (unsigned)(i & 31));
}

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

__device__ __forceinline__ void eval_sh(int bd, float x, float y, float z,
                                        float* out) {
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

// posc: the position clipped to [0, 1 - 1e-6]^3; res = N^lut_levels.
template <bool kStats>
__device__ __forceinline__ Leaf query_leaf(const RenderParams& p, int res,
                                           const float posc[3],
                                           int& descents) {
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
    const float fres = (float)res;
    int c[3];
    for (int i = 0; i < 3; ++i) {
      const float sc = posc[i] * fres;
      const float fl = floorf(sc);
      c[i] = min(max((int)fl, 0), res - 1);
      xyz[i] = sc - fl;
    }
    const long long flat = ((long long)c[0] * res + c[1]) * res + c[2];
    const int2 row = __ldg(p.lut + flat);
    if (kStats) mark(p.lut_bits, flat);
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
    const int2 row = __ldg(p.chs + sub);
    if (kStats) {
      mark(p.chs_bits, sub);
      ++descents;
    }
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

// ---- one ray: setup, leaf step, shade + writes ----

// What every estimator keeps of a ray.
struct RayGeom {
  int idx;  // pixel y * W + x
  float vdir[3];
  float cen_t[3], d_t[3], invdir[3];
  float delta_scale, t, tmax;
  int steps, descents;
  bool active;
};

// The regular tracker's ray: sorted thresholds and distinct-leaf records.
template <int SPP>
struct Ray : RayGeom {
  float src;
  int sppc, shn;
  float dst[SPP];
  int rec_ptr[SPP], rec_cnt[SPP];
};

// March setup of the world ray (dir, cen) (_init_march, _dda_world):
// tree-space origin and unit direction, delta_scale = 1 / |dir * scale|,
// the bbox interval, and the world depth bg_depth() (the mesh pass's or a
// caller's; 1e9 without one) as a ray parameter (rt_core.cuh:208).  Shared
// by the frame and the ray mode.
template <typename Depth>
__device__ __forceinline__ void init_march(const RenderParams& p,
                                           const float dir[3],
                                           const float cen[3],
                                           Depth bg_depth, RayGeom& r) {
  for (int i = 0; i < 3; ++i) {
    r.cen_t[i] = p.offset[i] + p.scale[i] * cen[i];
    r.d_t[i] = dir[i] * p.scale[i];
  }
  r.delta_scale = 1.0f / sqrtf(r.d_t[0] * r.d_t[0] + r.d_t[1] * r.d_t[1] +
                               r.d_t[2] * r.d_t[2]);
  for (int i = 0; i < 3; ++i) {
    r.d_t[i] = r.d_t[i] * r.delta_scale;
    r.invdir[i] = 1.0f / (r.d_t[i] + 1e-9f);
  }
  float tmin = 0.0f, tmax = 1e4f;
  {
    float mn = -INFINITY, mx = INFINITY;
    for (int i = 0; i < 3; ++i) {
      const float t1 = (p.bbox[i] + 1e-6f - r.cen_t[i]) * r.invdir[i];
      const float t2 = (p.bbox[i + 3] - 1e-6f - r.cen_t[i]) * r.invdir[i];
      mn = fmaxf(mn, fminf(t1, t2));
      mx = fminf(mx, fmaxf(t1, t2));
    }
    tmin = fmaxf(0.0f, mn);
    tmax = fminf(1e4f, mx);
  }
  r.tmax = fminf(tmax, bg_depth() / r.delta_scale);
  r.active = (r.tmax >= 0.0f) && (tmin <= r.tmax);
  r.t = tmin;
  r.steps = r.descents = 0;
}

// Camera ray, view direction, NDC warp and march setup of pixel (px, py).
// kHostTrig takes the rotation's cosine and sine from the wrapper instead
// of cosf / sinf, whose reduction of a huge angle needs a stack frame.
template <bool kHostTrig = false>
__device__ __forceinline__ void setup_geom(const RenderParams& p, int px,
                                           int py, RayGeom& r) {
  const int W = p.width, H = p.height;
  const int idx = py * W + px;
  r.idx = idx;
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
  for (int i = 0; i < 3; ++i) r.vdir[i] = dir[i];
  {
    const float* a = p.rot;
    const float angle = sqrtf(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
    if (!(angle < 1e-6f)) {
      const float safe = fmaxf(angle, 1e-12f);
      const float k[3] = {a[0] / safe, a[1] / safe, a[2] / safe};
      const float ca = kHostTrig ? p.rot_cos : cosf(angle);
      const float sa = kHostTrig ? p.rot_sin : sinf(angle);
      const float cr[3] = {k[1] * dir[2] - k[2] * dir[1],
                           k[2] * dir[0] - k[0] * dir[2],
                           k[0] * dir[1] - k[1] * dir[0]};
      const float dot = dir[0] * k[0] + dir[1] * k[1] + dir[2] * k[2];
      for (int i = 0; i < 3; ++i)
        r.vdir[i] = dir[i] * ca + cr[i] * sa + k[i] * dot * (1.0f - ca);
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

  // world depth of the mesh, clamped to 1e9 as _render_noisy does
  init_march(p, dir, cen, [&] {
    return p.mesh_depth ? fminf(p.mesh_depth[idx], 1e9f) : 1e9f;
  }, r);
}

// Ray mode: the caller's ray i as given (trace_rays takes NDC-warped rays
// and rotated view dirs): no rotation, no warp, neither vector normalised;
// its world depth ray_tmax[i] unclamped (trace_rays has no clamp), 1e9
// without one.
// The view dir is read only for a ray that enters the box.
__device__ __forceinline__ void setup_geom_ray(const RenderParams& p,
                                               long long i, RayGeom& r) {
  float dir[3], cen[3];
  for (int k = 0; k < 3; ++k) {
    dir[k] = p.ray_dirs[3 * i + k];
    cen[k] = p.ray_cens[3 * i + k];
  }
  r.idx = 0;
  init_march(p, dir, cen, [&] { return p.ray_tmax ? p.ray_tmax[i] : 1e9f; },
             r);
  for (int k = 0; k < 3; ++k)
    r.vdir[k] = r.active ? p.ray_vdirs[3 * i + k] : 0.f;
}

// kHostTrig: as setup_geom's (the wide instances take the wrapper's cosine
// and sine, so that no instance at SPP <= 8 needs a stack frame).
template <int SPP, bool kHostTrig = false>
__device__ __forceinline__ void setup_ray(const RenderParams& p, int px,
                                          int py, Ray<SPP>& r) {
  setup_geom<kHostTrig>(p, px, py, r);
  const int idx = r.idx;
  // ---- sorted free-flight thresholds (pcg32 at idx*spp + j) ----
  {
    uint64_t state = pcg_advance(p.rng_state, p.rng_inc,
                                 (uint64_t)idx * (uint64_t)SPP);
#pragma unroll
    for (int j = 0; j < SPP; ++j) {
      const float u = pcg_next_float(state, p.rng_inc);
      if (p.uniforms)
        p.uniforms[((long long)idx - (long long)p.row0 * p.width) * SPP + j] =
            u;
      r.dst[j] = -log1pf(-u);
    }
#pragma unroll
    for (int j = 1; j < SPP; ++j) {  // insertion sort, unrolled
#pragma unroll
      for (int k = j; k > 0; --k) {
        const float lo = fminf(r.dst[k - 1], r.dst[k]);
        const float hi = fmaxf(r.dst[k - 1], r.dst[k]);
        r.dst[k - 1] = lo;
        r.dst[k] = hi;
      }
    }
  }
  r.src = 0.0f;
  r.sppc = r.shn = 0;
#pragma unroll
  for (int k = 0; k < SPP; ++k) r.rec_ptr[k] = r.rec_cnt[k] = 0;
}

// Ray mode: the caller's ray i with its sorted thresholds ray_dst[i] as
// given (trace_rays; SPP is dst.shape[1]), read only for a ray that enters
// the box (a ray that does not takes no step).
template <int SPP>
__device__ __forceinline__ void setup_ray_of(const RenderParams& p,
                                             long long i, Ray<SPP>& r) {
  setup_geom_ray(p, i, r);
#pragma unroll
  for (int j = 0; j < SPP; ++j)
    r.dst[j] = r.active ? p.ray_dst[i * SPP + j] : 0.f;
  r.src = 0.0f;
  r.sppc = r.shn = 0;
#pragma unroll
  for (int k = 0; k < SPP; ++k) r.rec_ptr[k] = r.rec_cnt[k] = 0;
}

// The leaf at the ray's t and the distance to its exit, widened by the
// empty-space skip (_query_step); res = N^lut_levels.
template <bool kStats>
__device__ __forceinline__ float query_step(const RenderParams& p, int res,
                                            RayGeom& r, Leaf& leaf) {
  const float clip_hi = (float)(1.0 - 1e-6);
  float posc[3];
  for (int i = 0; i < 3; ++i)
    posc[i] = fminf(fmaxf(r.cen_t[i] + r.t * r.d_t[i], 0.0f), clip_hi);
  leaf = query_leaf<kStats>(p, res, posc, r.descents);
  float t_unit = 1e4f;
  for (int i = 0; i < 3; ++i) {
    float local = posc[i] * leaf.cube;
    local = local - floorf(local);
    const float t1 = -local * r.invdir[i];
    const float t2 = t1 + r.invdir[i];
    t_unit = fminf(t_unit, fmaxf(t1, t2));
  }
  float t_sub = t_unit / leaf.cube;
  if (p.skip_cap > 0) {
    const int dist_i = (leaf.bits > 0 && leaf.bits <= 255) ? leaf.bits : 1;
    if (dist_i > 1) {
      const float skip_res = (float)res;
      const float dist = (float)dist_i;
      float t_box = INFINITY;
      for (int i = 0; i < 3; ++i) {
        const float cell = floorf(posc[i] * skip_res);
        const float lo = (cell - (dist - 1.0f)) / skip_res;
        const float hi = (cell + dist) / skip_res;
        t_box = fminf(t_box, fmaxf((lo - posc[i]) * r.invdir[i],
                                   (hi - posc[i]) * r.invdir[i]));
      }
      t_sub = fmaxf(t_sub, t_box);
    }
  }
  return t_sub;
}

// One leaf step of the regular tracker (_query_step + _step_update).
template <int SPP, bool kStats>
__device__ __forceinline__ void march_step(const RenderParams& p, int res,
                                           Ray<SPP>& r) {
  Leaf leaf;
  const float t_sub = query_step<kStats>(p, res, r, leaf);
  const float sigma = __int_as_float(leaf.bits);
  const float delta_t = t_sub + p.step_size;
  const bool has_sigma = sigma > p.sigma_thresh;
  const float delta = has_sigma ? delta_t * r.delta_scale * sigma : 0.0f;
  const float s_new = r.src + delta;
  int n_leq = 0;
#pragma unroll
  for (int k = 0; k < SPP; ++k) n_leq += r.dst[k] <= s_new ? 1 : 0;
  const int c = max(n_leq - r.sppc, 0);
  if (has_sigma && c > 0) {
#pragma unroll
    for (int k = 0; k < SPP; ++k) {
      if (k == r.shn) {
        r.rec_ptr[k] = leaf.ptr;
        r.rec_cnt[k] = c;
      }
    }
    r.shn += 1;
    r.sppc += c;
  }
  if (has_sigma) r.src = s_new;
  r.t = r.t + delta_t;
  r.active = (r.t < r.tmax) && (r.sppc < SPP);
  r.steps += 1;
}

// The 3 logits (or, for RGBA rows, the raw rgb) of one leaf: the dot of
// each channel's bd coefficients with the basis, in the order of b.  The
// row is read as the aligned 8-byte words that cover it, four halfs a load
// (rows are 8-byte aligned when data_dim % 4 == 0, as at SH9; otherwise the
// first word also holds the end of the previous row, which is skipped).
__device__ __forceinline__ void leaf_channels(const RenderParams& p, int ptr,
                                              const float* basis,
                                              float out[3]) {
  const int bd = p.basis_dim;
  const int n = bd >= 0 ? 3 * bd : 3;
  const uintptr_t a =
      reinterpret_cast<uintptr_t>(p.data + (long long)ptr * p.data_dim);
  const uint2* words = reinterpret_cast<const uint2*>(a & ~uintptr_t{7});
  out[0] = out[1] = out[2] = 0.f;
  int ch = 0, b = 0;
  for (int j = -(int)((a & 7) >> 1); j < n; j += 4) {
    const uint2 w = __ldg(words++);
    __half2 h01, h23;
    memcpy(&h01, &w.x, sizeof(h01));
    memcpy(&h23, &w.y, sizeof(h23));
    const float2 f01 = __half22float2(h01), f23 = __half22float2(h23);
    const float f[4] = {f01.x, f01.y, f23.x, f23.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j + e;
      if (c < 0 || c >= n) continue;
      if (bd < 0) {  // RGBA: c < 3
        if (c == 0) {
          out[0] = f[e];
        } else if (c == 1) {
          out[1] = f[e];
        } else {
          out[2] = f[e];
        }
        continue;
      }
      const float term = f[e] * basis[b];
      if (ch == 0) {
        out[0] = out[0] + term;
      } else if (ch == 1) {
        out[1] = out[1] + term;
      } else {
        out[2] = out[2] + term;
      }
      if (++b == bd) {
        b = 0;
        ++ch;
      }
    }
  }
}

// The rgb of one leaf seen from the ray's basis: sigmoid of each channel's
// dot for SH/SG/ASG, the raw rgb for RGBA (_leaf_rgb).
__device__ __forceinline__ void leaf_rgb(const RenderParams& p, int ptr,
                                         const float* basis, float out[3]) {
  leaf_channels(p, ptr, basis, out);
  if (p.basis_dim >= 0)
    for (int ch = 0; ch < 3; ++ch) out[ch] = 1.0f / (1.0f + expf(-out[ch]));
}

// ---- rows of a basis_dim above kMaxBasis (SG / ASG; the wide instances) ----

constexpr int kBasisChunk = 8;  // basis values a wide row holds at a time
// the largest basis_dim of render_classic's shared-memory wide instance
// (render/renderer.py:CLASSIC_WIDE_MAX_BASIS; 53,248 bytes a block at 40):
// its row slot, a step ahead, wins while rows are short, and the chunked
// instance, no slot and more blocks an SM, past it (chip_smoke.py
// --wide-sweep, both instances from basis_dim 32 to 192 on copies with
// another switch: the shared one ahead at 32 and 40, behind from 48)
constexpr int kWideSmemMaxBasis = 40;

// Basis value b of the view direction v, masked by basis_minmax: the
// expression of eval_basis (and classic_basis) for that b alone.
__device__ __forceinline__ float basis_at(const RenderParams& p,
                                          const float v[3], int b) {
  if (b < p.basis_lo || b > p.basis_hi) return 0.f;
  const float fbd = (float)p.basis_dim;
  if (p.fmt == 2) {
    const float* q = p.extra + 4 * b;
    const float dot = v[0] * q[1] + v[1] * q[2] + v[2] * q[3];
    return expf(q[0] * (dot - 1.0f)) / fbd;
  }
  if (p.fmt == 3) {
    const float* q = p.extra + 11 * b;
    const float S = v[0] * q[8] + v[1] * q[9] + v[2] * q[10];
    const float dx = v[0] * q[2] + v[1] * q[3] + v[2] * q[4];
    const float dy = v[0] * q[5] + v[1] * q[6] + v[2] * q[7];
    return S * expf(-q[0] * dx * dx - q[1] * dy * dy) / fbd;
  }
  return 0.f;  // a format without a basis (RGBA rows with a basis_dim)
}

// Composite (prem: premultiplied rgb) over the background or the pixel's
// mesh colour and write img, aux_nhwc and aux_chw (composite,
// aux_from_composite).
template <bool kStats>
__device__ __forceinline__ void write_pixel(const RenderParams& p,
                                            const RayGeom& r,
                                            const float prem[3],
                                            float alpha) {
  const int idx = r.idx;
  // the pixel's place in the band's outputs
  const long long out = (long long)idx - (long long)p.row0 * p.width;
  const float nalpha = 1.0f - alpha;
  float o[4];
  for (int ch = 0; ch < 3; ++ch) {
    const float behind =
        p.mesh_color ? p.mesh_color[3 * (long long)idx + ch] : p.background;
    o[ch] = prem[ch] + behind * nalpha;
  }
  o[3] = alpha;
  reinterpret_cast<float4*>(p.img)[out] = make_float4(o[0], o[1], o[2], 1.0f);
  float4* an = reinterpret_cast<float4*>(p.aux_nhwc) + 2 * out;
  an[0] = make_float4(o[0], o[1], o[2], o[3]);
  an[1] = make_float4(o[0] * o[0], o[1] * o[1], o[2] * o[2], o[3] * o[3]);
  if (p.aux_chw) {
    const long long HW = (long long)p.width * p.rows;
    for (int ch = 0; ch < 4; ++ch) {
      p.aux_chw[ch * HW + out] = o[ch];
      p.aux_chw[(ch + 4) * HW + out] = o[ch] * o[ch];
    }
  }
  if (kStats) {
    p.stat_steps[out] = r.steps;
    p.stat_descents[out] = r.descents;
  }
}

// ---- the classic estimator (trace_rays_classic) ----

// The row layouts the classic kernel is instantiated on (p.classic, chosen
// by render/renderer.py:classic_layout): SH rows of a fixed basis_dim, raw
// rgb rows, one instance for SG / ASG rows (or a format without a basis)
// of any basis_dim <= kMaxBasis, and two for those above it: wide up to
// kWideSmemMaxBasis, wide_chunked past it.
enum ClassicLayout : int {
  kClassicSh1 = 1, kClassicSh4, kClassicSh9, kClassicSh16, kClassicSh25,
  kClassicRgba, kClassicAny, kClassicWide, kClassicWideChunked
};
// the kBd of the four layouts that are not SH
constexpr int kBdRgba = -1, kBdAny = 0, kBdWide = -2, kBdWideChunked = -3;

// The wide instance's 16-byte pieces of a row: 3 bd halfs that start up to
// 7 halfs into the first piece.
__host__ __device__ constexpr int wide_row_pieces(int bd) {
  return (3 * bd + 7 + 7) / 8;
}

// The wide instance's dynamic shared memory: a thread's basis (bd floats)
// and its row slot, for each of the block's threads.
constexpr int wide_classic_smem(int bd) {
  return kThreads * (4 * bd + 16 * wide_row_pieces(bd));
}

// The masked basis of the view direction v, in registers: eval_sh at a
// compile-time bd for SH; for kBdAny, eval_basis's expressions for every
// b < kMaxBasis, unrolled, with the guard b < basis_dim.
// The wide layouts keep their basis in shared memory
// (ClassicRow<kBdWide>::set_basis, ClassicRow<kBdWideChunked>::set_basis)
// and take no call.
template <int kBd>
__device__ __forceinline__ void classic_basis(const RenderParams& p,
                                              const float v[3],
                                              float basis[kMaxBasis]) {
  if constexpr (kBd > 0) {
    eval_sh(kBd, v[0], v[1], v[2], basis);
  } else {
    const int bd = p.basis_dim;
    const float fbd = (float)bd;
#pragma unroll
    for (int b = 0; b < kMaxBasis; ++b) {
      float out = 0.f;
      if (b < bd && p.fmt == 2) {
        const float* q = p.extra + 4 * b;
        const float dot = v[0] * q[1] + v[1] * q[2] + v[2] * q[3];
        out = expf(q[0] * (dot - 1.0f)) / fbd;
      } else if (b < bd && p.fmt == 3) {
        const float* q = p.extra + 11 * b;
        const float S = v[0] * q[8] + v[1] * q[9] + v[2] * q[10];
        const float dx = v[0] * q[2] + v[1] * q[3] + v[2] * q[4];
        const float dy = v[0] * q[5] + v[1] * q[6] + v[2] * q[7];
        out = S * expf(-q[0] * dx * dx - q[1] * dy * dy) / fbd;
      }
      basis[b] = out;
    }
  }
  constexpr int n = kBd > 0 ? kBd : kMaxBasis;
#pragma unroll
  for (int b = 0; b < n; ++b)
    if (b < p.basis_lo || b > p.basis_hi) basis[b] = 0.f;
}

// One shaded leaf's row: issue() starts its loads into registers and
// channels() sums them a step later, so that the row's latency runs beside
// the next step's query.  Fixed layouts (SH at kBd, raw rgb): the aligned
// 8-byte words that cover the row's kN halfs, all issued before any is
// used (7 at SH9, 19 at SH25); a row that does not start on 8 bytes
// (data_dim % 4 != 0, as at SH4 and SH16) takes up to one word more and is
// realigned in registers by byte permutes.
template <int kBd>
struct ClassicRow {
  static constexpr int kN = kBd > 0 ? 3 * kBd : 3;
  static constexpr int kWords = (kN + 3 + 3) / 4;  // the row may start 3 in
  static constexpr int kPairs = (kN + 1) / 2;      // halfs 2j and 2j + 1
  uint2 w[kWords];
  int skew;  // the row's first half within its first word, 0..3

  __device__ __forceinline__ void issue(const RenderParams& p, int ptr) {
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(p.data + (long long)ptr * p.data_dim);
    const uint2* words = reinterpret_cast<const uint2*>(a & ~uintptr_t{7});
    skew = (int)((a & 7) >> 1);
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      w[k] = 4 * k < skew + kN ? __ldg(words + k) : make_uint2(0u, 0u);
  }

  // 32-bit word i of the loaded words (i known at compile time)
  __device__ __forceinline__ uint32_t word32(int i) const {
    return i >= 2 * kWords ? 0u : (i & 1) ? w[i >> 1].y : w[i >> 1].x;
  }

  // The 3 logits (raw rgb for kBdRgba): each channel's dot with the basis
  // in the order of b, from 0 (leaf_channels' order).
  __device__ __forceinline__ void channels(const RenderParams&,
                                           const float* basis,
                                           float out[3]) const {
    uint32_t u[kPairs];
    if (skew == 0) {
#pragma unroll
      for (int j = 0; j < kPairs; ++j) u[j] = word32(j);
    } else {
      const bool up = skew & 2, odd = skew & 1;
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const uint32_t lo = up ? word32(j + 1) : word32(j);
        const uint32_t hi = up ? word32(j + 2) : word32(j + 1);
        u[j] = odd ? __byte_perm(lo, hi, 0x5432) : lo;
      }
    }
    out[0] = out[1] = out[2] = 0.f;
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      __half2 h;
      memcpy(&h, &u[c >> 1], sizeof(h));
      const float f = (c & 1) ? __high2float(h) : __low2float(h);
      if constexpr (kBd < 0) {
        out[c] = f;
      } else {
        out[c / kBd] = out[c / kBd] + f * basis[c % kBd];
      }
    }
  }
};

// SG / ASG rows of a runtime basis_dim: one 2-byte load per coefficient,
// unrolled over kMaxBasis with the guard b < basis_dim, all issued before
// any is used.
template <>
struct ClassicRow<kBdAny> {
  unsigned short e[3][kMaxBasis];

  __device__ __forceinline__ void issue(const RenderParams& p, int ptr) {
    const int bd = p.basis_dim;
    const unsigned short* row =
        reinterpret_cast<const unsigned short*>(p.data) +
        (long long)ptr * p.data_dim;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
#pragma unroll
      for (int b = 0; b < kMaxBasis; ++b)
        e[ch][b] = b < bd ? __ldg(row + ch * bd + b) : (unsigned short)0;
  }

  __device__ __forceinline__ void channels(const RenderParams& p,
                                           const float* basis,
                                           float out[3]) const {
    const int bd = p.basis_dim;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      out[ch] = 0.f;
#pragma unroll
      for (int b = 0; b < kMaxBasis; ++b)
        if (b < bd)
          out[ch] = out[ch] + __half2float(__ushort_as_half(e[ch][b])) *
                                  basis[b];
    }
  }
};

// acc plus halfs e in [lo, hi) of the 16-byte piece w, each times the
// basis value b0 + e at basis[(b0 + e) * kThreads], in the order of e
__device__ __forceinline__ float piece_dot(uint4 w, int lo, int hi,
                                           const float* basis, int b0,
                                           float acc) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (e >= lo && e < hi) {
      __half2 hh;
      memcpy(&hh, &u[e >> 1], sizeof(hh));
      const float f = (e & 1) ? __high2float(hh) : __low2float(hh);
      acc = acc + f * basis[(b0 + e) * kThreads];
    }
  }
  return acc;
}

// SG / ASG rows of a basis_dim above kMaxBasis, up to kWideSmemMaxBasis.
// The ray's masked basis (basis_at's expression for each b) is evaluated
// once into this thread's column of a [bd][kThreads] shared array, so that
// the lanes of a warp read distinct banks.  issue() copies the aligned
// 16-byte pieces that cover the row's 3 bd halfs (2-byte aligned: the row
// starts `skew` halfs into its first piece) by cp.async into this thread's
// slot, [piece][kThreads] (a warp's pieces side by side, so that the
// 16-byte copies and reads take the fewest wavefronts); channels() waits
// for them a step later and sums each channel in the order of b from the
// shared basis: K1 wide's f32 operations (finish_ray), without a basis
// evaluation or a load from the device's memory on the march's chain.
template <>
struct ClassicRow<kBdWide> {
  float* basis;      // this thread's basis value b at basis[b * kThreads]
  const uint4* slot;  // this thread's piece k at slot[k * kThreads]
  int skew;          // the row's first half within its first piece, 0..7

  __device__ __forceinline__ void init(const RenderParams& p, float* smem) {
    basis = smem + threadIdx.x;
    slot = reinterpret_cast<const uint4*>(smem + kThreads * p.basis_dim) +
           threadIdx.x;
  }

  __device__ __forceinline__ void set_basis(const RenderParams& p,
                                            const float v[3]) {
    for (int b = 0; b < p.basis_dim; ++b)
      basis[b * kThreads] = basis_at(p, v, b);
  }

  __device__ __forceinline__ void issue(const RenderParams& p, int ptr) {
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(p.data + (long long)ptr * p.data_dim);
    const char* src = reinterpret_cast<const char*>(a & ~uintptr_t{15});
    skew = (int)((a & 15) >> 1);
    const int n = (skew + 3 * p.basis_dim + 7) >> 3;
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(slot));
    for (int k = 0; k < n; ++k)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                       dst + k * kThreads * 16),
                   "l"(src + 16 * k)
                   : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // Each channel's halfs [h0, h1): its first piece and its last in part,
  // the pieces between whole.
  __device__ __forceinline__ void channels(const RenderParams& p,
                                           const float*, float out[3]) const {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    const int bd = p.basis_dim;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int h0 = skew + ch * bd, h1 = h0 + bd;
      const int k0 = h0 >> 3, k1 = (h1 - 1) >> 3;
      float acc = piece_dot(slot[k0 * kThreads], h0 - 8 * k0,
                            min(h1 - 8 * k0, 8), basis, 8 * k0 - h0, 0.f);
      for (int k = k0 + 1; k < k1; ++k)
        acc = piece_dot(slot[k * kThreads], 0, 8, basis, 8 * k - h0, acc);
      if (k1 > k0)
        acc = piece_dot(slot[k1 * kThreads], 0, h1 - 8 * k1, basis,
                        8 * k1 - h0, acc);
      out[ch] = acc;
    }
  }
};

// The largest prefix of the basis the chunked instance holds in shared
// memory (a row past it evaluates its tail chunk by chunk from the view
// direction, which then takes 3 more values a thread): 112,128 bytes a
// block with the view direction, so that two blocks share an SM.
constexpr int kChunkedMaxPrefix = 216;

// The prefix of a basis of bd values: all of it up to kFull values (and
// up to kCap), else kCap values.
template <int kFull = kChunkedMaxPrefix, int kCap = kFull>
__host__ __device__ constexpr int chunked_prefix(int bd) {
  return bd <= kFull || bd <= kCap ? bd : kCap;
}

// The chunked instance's dynamic shared memory: a thread's basis prefix,
// and its view direction past the prefix, for each of the block's threads.
template <int kFull = kChunkedMaxPrefix, int kCap = kFull>
constexpr int chunked_classic_smem(int bd) {
  return kThreads * 4 *
         (chunked_prefix<kFull, kCap>(bd) +
          (chunked_prefix<kFull, kCap>(bd) < bd ? 3 : 0));
}

// SG / ASG rows of a basis_dim above kWideSmemMaxBasis.  The ray's masked
// basis (basis_at's expression for each b) is evaluated once into this
// thread's column of a [b][kThreads] shared array, up to kChunkedMaxPrefix
// values, and there is no row slot, so that blocks stay small (48 KB at
// basis_dim 96: four blocks an SM).  issue() keeps the row and prefetches
// its lines into L2, so that they move while the next step's LUT query
// runs (an L1 prefetch timed the same, none 13-17 % slower, the first four
// pieces held in registers or copied by cp.async into a slot of the
// thread slower: chip_smoke.py --wide-sweep on copies).  channels() reads
// the aligned 16-byte pieces that cover the row's 3 bd halfs a step later
// (2-byte aligned: the row starts `skew` halfs into its first piece) and
// sums each channel in the order of b from the shared basis, then the
// tail past the prefix, its basis evaluated kBasisChunk values at a time
// from the view direction: basis_at's f32 operations in the order of b,
// as K1 wide's shade (finish_ray) sums them.  The row's address is worked
// out again in channels(), so that the march carries one register for it
// (with the address, the view direction and the pieces kept across the
// step, ptxas spilled).  kFull, kCap: the prefix (chunked_prefix; K1
// wide's shade takes its own, ChunkedRow<kWideFullBasis, kWideCapPrefix>).
template <int kFull, int kCap>
struct ChunkedRow {
  float* basis;  // this thread's basis value b at basis[b * kThreads]; past
                 // the prefix, its view direction at basis[(nb + i) * ...]
  int ptr;       // the row

  __device__ __forceinline__ void init(const RenderParams&, float* smem) {
    basis = smem + threadIdx.x;
  }

  __device__ __forceinline__ void set_basis(const RenderParams& p,
                                            const float v[3]) {
    const int bd = p.basis_dim, nb = chunked_prefix<kFull, kCap>(bd);
    for (int b = 0; b < nb; ++b) basis[b * kThreads] = basis_at(p, v, b);
    if (nb < bd)
      for (int i = 0; i < 3; ++i) basis[(nb + i) * kThreads] = v[i];
  }

  __device__ __forceinline__ void issue(const RenderParams& p, int row) {
    ptr = row;
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(p.data + (long long)row * p.data_dim);
    const uintptr_t end = a + 6 * (uintptr_t)p.basis_dim;
    for (uintptr_t line = a & ~uintptr_t{127}; line < end; line += 128)
      asm volatile("prefetch.L2 [%0];\n" ::"l"(line));
  }

  // Each channel's prefix halfs [h0, h1): its first piece and its last in
  // part, the pieces between whole; then the tail.
  __device__ __forceinline__ void channels(const RenderParams& p,
                                           const float*, float out[3]) const {
    const int bd = p.basis_dim, nb = chunked_prefix<kFull, kCap>(bd);
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(p.data + (long long)ptr * p.data_dim);
    const uint4* src = reinterpret_cast<const uint4*>(a & ~uintptr_t{15});
    const int skew = (int)((a & 15) >> 1);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int h0 = skew + ch * bd, h1 = h0 + nb;
      const int k0 = h0 >> 3, k1 = (h1 - 1) >> 3;
      float acc = piece_dot(__ldg(src + k0), h0 - 8 * k0,
                            min(h1 - 8 * k0, 8), basis, 8 * k0 - h0, 0.f);
#pragma unroll 4
      for (int k = k0 + 1; k < k1; ++k)
        acc = piece_dot(__ldg(src + k), 0, 8, basis, 8 * k - h0, acc);
      if (k1 > k0)
        acc = piece_dot(__ldg(src + k1), 0, h1 - 8 * k1, basis, 8 * k1 - h0,
                        acc);
      out[ch] = acc;
    }
    if (nb == bd) return;
    const float v[3] = {basis[nb * kThreads], basis[(nb + 1) * kThreads],
                        basis[(nb + 2) * kThreads]};
    const unsigned short* row =
        reinterpret_cast<const unsigned short*>(p.data) +
        (long long)ptr * p.data_dim;
    for (int b0 = nb; b0 < bd; b0 += kBasisChunk) {
      float bc[kBasisChunk];
#pragma unroll
      for (int j = 0; j < kBasisChunk; ++j)
        bc[j] = b0 + j < bd ? basis_at(p, v, b0 + j) : 0.f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
#pragma unroll
        for (int j = 0; j < kBasisChunk; ++j)
          if (b0 + j < bd)
            out[ch] = out[ch] + __half2float(__ushort_as_half(
                                    __ldg(row + ch * bd + b0 + j))) *
                                    bc[j];
    }
  }
};

template <>
struct ClassicRow<kBdWideChunked>
    : ChunkedRow<kChunkedMaxPrefix, kChunkedMaxPrefix> {};

// K1 wide's shade (finish_ray) holds a basis of up to kWideFullBasis values
// in shared memory, and of a longer one the first kWideCapPrefix values
// (the tail as ChunkedRow's).  K1's frame at SPP 6 on depth-7 SG shells,
// 800x800 (chip_smoke.py --wide-sweep on copies with each rule, NVIDIA
// H100 80GB HBM3): the whole basis against a prefix of 32 takes 0.2060
// against 0.2225 ms at basis_dim 96, 0.2506 against 0.2506 at 128, 0.3386
// against 0.2795 at 160, 0.4169 against 0.3723 at 232: past 128 the whole
// basis leaves three blocks an SM or fewer and a small L1 for the march's
// gathers, and a prefix of 32 (six blocks) wins; a prefix of 96 (four)
// loses to both there.
constexpr int kWideFullBasis = 128;
constexpr int kWideCapPrefix = 32;

// Shade the distinct hit leaves (_shade_rows) and hand the premultiplied
// rgb and alpha to write (the frame: composite and write the pixel).
// kWide: rows of a basis_dim above kMaxBasis.  The march has recorded every
// shaded row by now, so their lines are all prefetched into L2 first; the
// ray's masked basis is then evaluated once into this thread's column of
// the block's shared [b][kThreads] array (ChunkedRow: the prefix of
// kWideFullBasis and kWideCapPrefix, the tail from the view direction)
// while those lines move, and each row is summed from its 16-byte pieces, each
// channel in the order of b from 0 (basis_at's values, as a shade that
// evaluates the basis row by row sums them, and as the classic wide
// instances do).  The rows are taken one at a time by index (k < shn,
// selected from the unrolled record slots), so that one copy of the row
// sum serves every SPP.  The same basis held in registers, kBasisChunk
// values at a time for groups of 4 rows, was 5 % slower on the SG32 frame
// (chip_smoke.py --ray-pairs against a copy) and left stack frames.
template <int SPP, bool kStats, bool kWide, typename Write>
__device__ __forceinline__ void finish_ray(const RenderParams& p,
                                           const Ray<SPP>& r, Write write) {
  float rgb[3] = {0.f, 0.f, 0.f};
  float wsum = 0.f;
  if (r.shn > 0) {
    if constexpr (kWide) {
      extern __shared__ float4 wide_smem[];
      ChunkedRow<kWideFullBasis, kWideCapPrefix> row;
      row.init(p, reinterpret_cast<float*>(wide_smem));
#pragma unroll
      for (int k = 0; k < SPP; ++k)
        if (k < r.shn) row.issue(p, r.rec_ptr[k]);
      row.set_basis(p, r.vdir);
      for (int k = 0; k < r.shn; ++k) {
        int ptr = 0, cnt = 0;
#pragma unroll
        for (int j = 0; j < SPP; ++j) {
          if (j == k) {
            ptr = r.rec_ptr[j];
            cnt = r.rec_cnt[j];
          }
        }
        row.ptr = ptr;
        float v[3];
        row.channels(p, nullptr, v);
        for (int ch = 0; ch < 3; ++ch) v[ch] = 1.0f / (1.0f + expf(-v[ch]));
        const float w = (float)cnt;
        for (int ch = 0; ch < 3; ++ch) rgb[ch] = rgb[ch] + v[ch] * w;
        wsum = wsum + w;
      }
    } else {
      float basis[kMaxBasis];
      if (p.basis_dim >= 0)
        eval_basis(p, r.vdir[0], r.vdir[1], r.vdir[2], basis);
#pragma unroll
      for (int k = 0; k < SPP; ++k) {
        if (k < r.shn) {
          if (kStats) mark(p.data_bits, r.rec_ptr[k]);
          float v[3];
          leaf_rgb(p, r.rec_ptr[k], basis, v);
          const float w = (float)r.rec_cnt[k];
          for (int ch = 0; ch < 3; ++ch) rgb[ch] = rgb[ch] + v[ch] * w;
          wsum = wsum + w;
        }
      }
    }
  }
  const float fspp = (float)SPP;
  const float prem[3] = {rgb[0] / fspp, rgb[1] / fspp, rgb[2] / fspp};
  write(prem, wsum / fspp);
}

// Ray mode's output: premultiplied rgb and alpha before the background.
__device__ __forceinline__ void write_ray(const RenderParams& p, long long i,
                                          const float prem[3], float alpha) {
  reinterpret_cast<float4*>(p.ray_out)[i] =
      make_float4(prem[0], prem[1], prem[2], alpha);
}

// The march runs one step ahead of the shade.  A leaf step needs only the
// leaf's sigma for its weight light * (1 - att), the new light, the stop
// test and the next t, so the loop issues the row loads of step i, queries
// step i + 1 (whose LUT read waits beside those loads), and only then sums
// step i's row into rgb: rgb += weight_i * sigmoid(row_i . basis) in step
// order, then rgb /= 1 - light after the stop step's own addition, light =
// 0 after a stop; the same f32 operations in the same order as a shade in
// place.  kRays: the ray mode, a thread per caller's ray.  One body serves
// both modes on purpose: with the march factored into a function, ptxas
// allocates the frame's SH9 instance another register count.
template <int kBd, bool kStats, bool kRays>
__global__ void __launch_bounds__(kThreads) render_classic_kernel(
    const RenderParams p) {
  const int tiles_x = (p.width + kTileW - 1) / kTileW;
  const int tile = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int px = (tile % tiles_x) * kTileW + lane % kTileW;
  const int py = p.row0 + (tile / tiles_x) * kTileH + lane / kTileW;
  const long long ray = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (kRays ? ray >= p.n_rays
            : px >= p.width || py >= p.row0 + p.rows)  // the ragged edge
    return;
  const int res = rt::ipow(p.N, p.lut_levels);
  RayGeom r;
  if constexpr (kRays) {
    setup_geom_ray(p, ray, r);
  } else {
    setup_geom<true>(p, px, py, r);
  }
  float basis[kMaxBasis];
  ClassicRow<kBd> row;  // the previous step's row while pend
  if constexpr (kBd == kBdWide || kBd == kBdWideChunked) {
    extern __shared__ float4 wide_smem[];
    row.init(p, reinterpret_cast<float*>(wide_smem));
    if (r.active) row.set_basis(p, r.vdir);
  } else if (kBd != kBdRgba && r.active) {
    classic_basis<kBd>(p, r.vdir, basis);
  }
  float light = 1.0f;
  float rgb[3] = {0.f, 0.f, 0.f};
  // the JAX loop tests max_steps every 2 steps (the frame); the ray
  // mode's wrapper rounds its limit up to its own unroll
  const int max_steps = kRays ? p.max_steps : p.max_steps + (p.max_steps & 1);
  bool pend = false, pend_stop = false;
  float pend_w = 0.f, pend_norm = 1.f;
  int shaded = 0;
  for (;;) {
    const bool live = r.active && r.steps < max_steps;
    bool sh = false, stop = false;
    int ptr = 0;
    float w = 0.f, norm = 1.f;
    if (live) {  // the march: step i + 1
      Leaf leaf;
      const float t_sub = query_step<kStats>(p, res, r, leaf);
      const float sigma = __int_as_float(leaf.bits);
      const float delta_t = t_sub + p.step_size;
      if (sigma > p.sigma_thresh) {
        const float att = fminf(expf(-delta_t * r.delta_scale * sigma), 1.0f);
        w = light * (1.0f - att);
        const float light_new = light * att;
        stop = light_new < p.stop_thresh;
        if (stop) {
          norm = 1.0f - light_new;
          light = 0.0f;
        } else {
          light = light_new;
        }
        sh = true;
        ptr = leaf.ptr;
      }
      r.t = r.t + delta_t;
      r.active = !stop && (r.t < r.tmax);
      r.steps += 1;
    }
    if (pend) {  // the shade: step i
      float v[3];
      row.channels(p, basis, v);
      if (kBd != kBdRgba)
        for (int ch = 0; ch < 3; ++ch) v[ch] = 1.0f / (1.0f + expf(-v[ch]));
      for (int ch = 0; ch < 3; ++ch) rgb[ch] = rgb[ch] + pend_w * v[ch];
      if (pend_stop)
        for (int ch = 0; ch < 3; ++ch) rgb[ch] = rgb[ch] / pend_norm;
    }
    if (!live) break;
    pend = sh;
    if (sh) {
      if (kStats) {
        mark(p.data_bits, ptr);
        ++shaded;
      }
      row.issue(p, ptr);
      pend_w = w;
      pend_stop = stop;
      pend_norm = norm;
    }
  }
  if constexpr (kRays) {
    write_ray(p, ray, rgb, 1.0f - light);
  } else {
    write_pixel<kStats>(p, r, rgb, 1.0f - light);
    if (kStats) p.stat_shaded[r.idx - p.row0 * p.width] = shaded;
  }
}

// ---- the frame: one thread per pixel, one 8x4 tile per warp; the ray
// mode (kRays): one thread per ray, a warp per 32 rays of the caller's
// order ----

template <int SPP, bool kStats, bool kRays, bool kWide>
__device__ __forceinline__ void render_body(const RenderParams& p) {
  if constexpr (kRays) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= p.n_rays) return;
    const int res = rt::ipow(p.N, p.lut_levels);
    Ray<SPP> r;
    setup_ray_of<SPP>(p, i, r);
    while (r.active && r.steps < p.max_steps) march_step<SPP, false>(p, res, r);
    finish_ray<SPP, false, kWide>(p, r, [&](const float* prem, float alpha) {
      write_ray(p, i, prem, alpha);
    });
  } else {
    const int tiles_x = (p.width + kTileW - 1) / kTileW;
    const int tile = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
    const int lane = threadIdx.x & 31;
    const int px = (tile % tiles_x) * kTileW + lane % kTileW;
    const int py = p.row0 + (tile / tiles_x) * kTileH + lane / kTileW;
    if (px >= p.width || py >= p.row0 + p.rows) return;  // the ragged edge
    const int res = rt::ipow(p.N, p.lut_levels);
    Ray<SPP> r;
    setup_ray<SPP, kWide>(p, px, py, r);
    while (r.active && r.steps < p.max_steps)
      march_step<SPP, kStats>(p, res, r);
    finish_ray<SPP, kStats, kWide>(p, r,
                                   [&](const float* prem, float alpha) {
                                     write_pixel<kStats>(p, r, prem, alpha);
                                   });
  }
}

template <int SPP, bool kStats, bool kRays>
__global__ void __launch_bounds__(kThreads) render_kernel(
    const RenderParams p) {
  render_body<SPP, kStats, kRays, false>(p);
}

// K1's wide instances (kWide), with a floor of kWideMinBlocks blocks an
// SM at SPP <= 8: without it ptxas keeps 56-72 registers and spills 4-8
// bytes around the shade's division in the tail of a row past the shared
// prefix (ChunkedRow::channels); with it, 72-80 registers and no stack
// frame (a copy of csrc/render.cu compiled with minimum
// blocks 4, 6 and 8: 8 spilled again at SPP 4-8).
constexpr int kWideMinBlocks = 6;

template <int SPP, bool kRays>
__global__ void __launch_bounds__(kThreads, SPP <= 8 ? kWideMinBlocks : 1)
    render_wide_kernel(const RenderParams p) {
  render_body<SPP, false, kRays, true>(p);
}

// Blocks of a launch: a warp per 8x4 tile of the band's rows, or in ray
// mode a thread per ray.
template <bool kRays>
int blocks_of(const RenderParams& p) {
  if (kRays) return (int)((p.n_rays + kThreads - 1) / kThreads);
  const long long tiles = (long long)((p.width + kTileW - 1) / kTileW) *
                          ((p.rows + kTileH - 1) / kTileH);
  const int warps_per_block = kThreads / 32;
  return (int)((tiles + warps_per_block - 1) / warps_per_block);
}

// kWide: the block's shared basis (finish_ray), as the chunked classic
// instance's.
template <int SPP, bool kStats, bool kRays, bool kWide = false>
int launch(const RenderParams& p, cudaStream_t stream) {
  const auto kernel = [] {
    if constexpr (kWide) {
      return render_wide_kernel<SPP, kRays>;
    } else {
      return render_kernel<SPP, kStats, kRays>;
    }
  }();
  const int smem = kWide ? chunked_classic_smem<kWideFullBasis,
                                                kWideCapPrefix>(p.basis_dim)
                         : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks_of<kRays>(p), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int kBd, bool kStats, bool kRays>
int launch_classic(const RenderParams& p, cudaStream_t stream) {
  const auto kernel = render_classic_kernel<kBd, kStats, kRays>;
  int smem = 0;
  if constexpr (kBd == kBdWide || kBd == kBdWideChunked) {
    smem = kBd == kBdWide ? wide_classic_smem(p.basis_dim)
                          : chunked_classic_smem(p.basis_dim);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  kernel<<<blocks_of<kRays>(p), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The instance of p.classic, if the tree's format and basis_dim fit it.
template <bool kStats, bool kRays>
int launch_layout(const RenderParams& p, cudaStream_t s) {
  const int bd = p.basis_dim;
  const bool sh = p.fmt == 1;
  switch (p.classic) {
    case kClassicSh1:
      if (sh && bd == 1) return launch_classic<1, kStats, kRays>(p, s);
      break;
    case kClassicSh4:
      if (sh && bd == 4) return launch_classic<4, kStats, kRays>(p, s);
      break;
    case kClassicSh9:
      if (sh && bd == 9) return launch_classic<9, kStats, kRays>(p, s);
      break;
    case kClassicSh16:
      if (sh && bd == 16) return launch_classic<16, kStats, kRays>(p, s);
      break;
    case kClassicSh25:
      if (sh && bd == 25) return launch_classic<25, kStats, kRays>(p, s);
      break;
    case kClassicRgba:
      if (bd < 0) return launch_classic<kBdRgba, kStats, kRays>(p, s);
      break;
    case kClassicAny:
      if (!sh && bd >= 0 && bd <= kMaxBasis)
        return launch_classic<kBdAny, kStats, kRays>(p, s);
      break;
    case kClassicWide:  // no statistics instance
      if constexpr (!kStats) {
        if (!sh && bd > kMaxBasis && bd <= kWideSmemMaxBasis)
          return launch_classic<kBdWide, false, kRays>(p, s);
      }
      break;
    case kClassicWideChunked:  // no statistics instance
      if constexpr (!kStats) {
        if (!sh && bd > kWideSmemMaxBasis)
          return launch_classic<kBdWideChunked, false, kRays>(p, s);
      }
      break;
  }
  return (int)cudaErrorInvalidValue;
}

// The wide instances of K1 (SG / ASG rows of a basis_dim above kMaxBasis):
// no statistics instance.
template <bool kRays>
int launch_wide(const RenderParams& p, cudaStream_t s) {
  if (p.fmt == 1) return (int)cudaErrorInvalidValue;  // SH stops at 25
  switch (p.spp) {
    case 1: return launch<1, false, kRays, true>(p, s);
    case 2: return launch<2, false, kRays, true>(p, s);
    case 3: return launch<3, false, kRays, true>(p, s);
    case 4: return launch<4, false, kRays, true>(p, s);
    case 6: return launch<6, false, kRays, true>(p, s);
    case 8: return launch<8, false, kRays, true>(p, s);
    case 16: return launch<16, false, kRays, true>(p, s);
    case 32: return launch<32, false, kRays, true>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kStats, bool kRays>
int launch_spp(const RenderParams& p, cudaStream_t s) {
  if (p.classic) return launch_layout<kStats, kRays>(p, s);  // spp not used
  if (p.basis_dim > kMaxBasis) {
    if constexpr (kStats) {
      return (int)cudaErrorInvalidValue;
    } else {
      return launch_wide<kRays>(p, s);
    }
  }
  switch (p.spp) {
    case 1: return launch<1, kStats, kRays>(p, s);
    case 2: return launch<2, kStats, kRays>(p, s);
    case 3: return launch<3, kStats, kRays>(p, s);
    case 4: return launch<4, kStats, kRays>(p, s);
    case 6: return launch<6, kStats, kRays>(p, s);
    case 8: return launch<8, kStats, kRays>(p, s);
    case 16: return launch<16, kStats, kRays>(p, s);
    case 32: return launch<32, kStats, kRays>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One frame, or the band of its rows [row0, row0 + rows); spp must be one of
// 1, 2, 3, 4, 6, 8, 16, 32 (volrend.cu:266-278) unless classic names a
// ClassicLayout that fits the tree.  A non-null stat_steps selects the
// statistics variant.
RT_API int rt_render(const RenderParams* params, void* stream) {
  const RenderParams p = *params;
  if (p.width <= 0 || p.height <= 0 || p.row0 < 0 || p.rows <= 0 ||
      p.row0 + p.rows > p.height || p.n_rays != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return p.stat_steps ? launch_spp<true, false>(p, s)
                      : launch_spp<false, false>(p, s);
}

// Ray mode (trace_rays, trace_rays_classic): the n_rays rays of ray_dirs,
// ray_vdirs, ray_cens (and for the regular tracker the sorted thresholds
// ray_dst, spp of them a ray) into ray_out; ray_tmax may be null.  Takes
// no statistics, no mesh pass and no frame outputs; max_steps is the step
// limit as given.
RT_API int rt_render_rays(const RenderParams* params, void* stream) {
  const RenderParams p = *params;
  if (p.n_rays < 1 || p.n_rays > (long long)INT_MAX * kThreads ||
      !p.ray_dirs || !p.ray_vdirs || !p.ray_cens || !p.ray_out ||
      (!p.classic && !p.ray_dst) || p.stat_steps || p.mesh_color ||
      p.mesh_depth || p.img || p.aux_nhwc || p.aux_chw || p.uniforms)
    return (int)cudaErrorInvalidValue;
  return launch_spp<false, true>(p, (cudaStream_t)stream);
}

// sizeof(RenderParams), checked by the Python binding against its mirror.
RT_API int rt_render_params_size() { return (int)sizeof(RenderParams); }
