// K3: the dense jump-LUT build and its empty-space skip distances.
//
// Replaces rt_octree_tpu/ops/traversal.py:_device_lut_build (:100-142) and
// _add_skip_distances (:172-200).
//
// lut_build_kernel: one thread per cell of the res^3 grid descends from
// the root through the (child skip, sigma bits) rows for at most `levels`
// levels and writes (depth << 27 | ptr, sigma bits), or (31 << 27 | node, 0)
// for a cell still internal at the LUT level.
// skip_min_kernel: one round of the 3x3x3 min-window + 1 over a uint8
// distance grid; `cap` ping-pong rounds give the Chebyshev distance (capped)
// to the nearest occupied cell, which skip_fold_kernel writes into the
// sigma lane of empty cells as the integer bits 1..cap.
//
// Bound on this card: device-memory traffic.  At depth 9 the grid holds
// 512^3 = 134M cells: the build writes the 1.07 GB LUT once and makes
// `levels` dependent 8-byte reads per cell (the top levels of the chs table
// stay in L2, so the reads are mostly cache hits); each skip round reads
// 27 neighbours from a 134 MB uint8 grid.  Design: the distance scratch is
// uint8 (8x less traffic than the i32 grid of the JAX version), threads walk
// the grid z-fastest so that neighbouring threads touch neighbouring bytes,
// and the 27 taps are served by L1/L2.  No shared-memory tiling yet.
//
// Built without fast math: the occupancy test and the fold read the sigma
// lane as integer bits, never as a float, so denormal skip distances and
// sigma bit patterns pass through untouched.
#include "common.cuh"

namespace {

__global__ void lut_build_kernel(const int2* __restrict__ chs,
                                 int2* __restrict__ lut, int N, int levels,
                                 int res, long long n_cells) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= n_cells) return;
  const int z = (int)(idx % res);
  const int y = (int)((idx / res) % res);
  const int x = (int)(idx / ((long long)res * res));
  const int N3 = N * N * N;
  int node = 0;
  int div = rt::ipow(N, levels - 1);
  for (int lev = 0; lev < levels; ++lev) {
    const int ci = (((x / div) % N) * N + (y / div) % N) * N + (z / div) % N;
    const int sub = node * N3 + ci;
    const int2 row = chs[sub];
    if (row.x == 0) {
      const uint32_t packed =
          ((uint32_t)(lev + 1) << rt::kLutPtrBits) | (uint32_t)sub;
      lut[idx] = make_int2((int)packed, row.y);
      return;
    }
    node += row.x;
    div /= N;
  }
  const uint32_t packed =
      ((uint32_t)rt::kLutDepthSentinel << rt::kLutPtrBits) | (uint32_t)node;
  lut[idx] = make_int2((int)packed, 0);
}

__global__ void skip_init_kernel(const int2* __restrict__ lut,
                                 uint8_t* __restrict__ dist, long long n,
                                 int inf) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  dist[i] = lut[i].y != 0 ? 0 : (uint8_t)inf;
}

__global__ void skip_min_kernel(const uint8_t* __restrict__ src,
                                uint8_t* __restrict__ dst, int res) {
  const long long n = (long long)res * res * res;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int z = (int)(i % res);
  const int y = (int)((i / res) % res);
  const int x = (int)(i / ((long long)res * res));
  int m = src[i];
  for (int dx = -1; dx <= 1; ++dx) {
    const int xx = x + dx;
    if (xx < 0 || xx >= res) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= res) continue;
      const long long row = ((long long)xx * res + yy) * res;
      for (int dz = -1; dz <= 1; ++dz) {
        const int zz = z + dz;
        if (zz < 0 || zz >= res || (dx == 0 && dy == 0 && dz == 0)) continue;
        m = min(m, src[row + zz] + 1);
      }
    }
  }
  dst[i] = (uint8_t)m;
}

__global__ void skip_fold_kernel(int2* __restrict__ lut,
                                 const uint8_t* __restrict__ dist,
                                 long long n, int cap) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (lut[i].y == 0) lut[i].y = min((int)dist[i], cap);
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// chs: [M, 2] i32 (child skip, sigma bits); lut: [res^3, 2] i32 output.
RT_API int rt_lut_build(const void* chs, void* lut, int N, int levels,
                        void* stream) {
  const int res = rt::ipow(N, levels);
  const long long n = (long long)res * res * res;
  const int threads = 256;
  lut_build_kernel<<<blocks_for(n, threads), threads, 0,
                     (cudaStream_t)stream>>>(
      (const int2*)chs, (int2*)lut, N, levels, res, n);
  return (int)cudaGetLastError();
}

// lut: [res^3, 2] i32, updated in place; scratch0/1: res^3 bytes each.
RT_API int rt_skip_distances(void* lut, void* scratch0, void* scratch1,
                             int res, int cap, void* stream) {
  const long long n = (long long)res * res * res;
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  uint8_t* a = (uint8_t*)scratch0;
  uint8_t* b = (uint8_t*)scratch1;
  skip_init_kernel<<<blocks_for(n, threads), threads, 0, s>>>(
      (const int2*)lut, a, n, cap + 1);
  for (int r = 0; r < cap; ++r) {
    skip_min_kernel<<<blocks_for(n, threads), threads, 0, s>>>(a, b, res);
    uint8_t* t = a;
    a = b;
    b = t;
  }
  skip_fold_kernel<<<blocks_for(n, threads), threads, 0, s>>>(
      (int2*)lut, a, n, cap);
  return (int)cudaGetLastError();
}
