// K3: the dense jump-LUT build and its empty-space skip distances.
//
// Replaces rt_octree_tpu/ops/traversal.py:_device_lut_build (:100-142) and
// _add_skip_distances (:172-200).  Both are bound by device memory on this
// card: at depth 9 the LUT is 512^3 int2 cells, 1.07 GB.
//
// LUT build (rt_lut_build).  Every cell of the res^3 grid descends from the
// root through the (child skip, sigma bits) rows of chs for `levels` levels
// and gets (depth << 27 | ptr, sigma bits), or (31 << 27 | node, 0) when it
// is still internal at the LUT level (on a partial LUT of a deep tree,
// (31 << 27 | node, mark): the caller's non-zero marker, so that the skip
// distances count the cell as occupied).  The cells of one subcube share the
// top of that descent, so the build goes down kStep = 3 levels a launch:
// lut_step_kernel turns the table at level l, whose internal cells already
// hold their node pointer, into the table at level l + 3.  Each cell reads
// its coarse cell once (the 8^3 cells under it read the same entry, an L1
// broadcast), copies it if the coarse cell is a leaf, and otherwise
// descends at most 3 levels itself.  The coarse tables (levels L-3, L-6,
// ...; 2.1 MB at L = 9) stay in the 50 MB L2.  One thread per cell in flat
// order, so a warp stores 256 contiguous bytes.  N = 2 takes shifts and
// masks; any other N runs the same kernel with divisions (kN = 0).
//
// Skip distances (rt_skip_distances).  The capped Chebyshev (L-inf)
// distance to the nearest occupied cell (sigma bits != 0) inside the grid,
// min(dist, cap), goes into the sigma lane of every empty cell.  L-inf
// distance separates by axis: from g0 = 0 at occupied cells and cap + 1
// elsewhere,
//     g_k(p) = min over |j| <= cap of max(|j|, g_{k-1}(p + j e_k))
// (taps outside the grid skipped) along z, then y, then x equals the
// reference's `cap` rounds of the 3x3x3 min-window.  Three launches:
//  - skip_rows_kernel, pass 1 along z (the contiguous axis): one warp per
//    row ballots the row's sigma lanes into occupancy bits in shared
//    memory; each lane then writes 16 cells of uint8 g1 at once, their
//    nearest set bit on either side found by a scan across the 16 (for
//    cap < 32, from two 64-bit windows over the neighbouring words).
//    Reading a 16 MB occupancy bitset written by the build instead of the
//    LUT would save about 0.3 ms on an H100, under a thousandth of a tree
//    load: not worth a second path.
//  - skip_axis_kernel<., false>, pass 2 along y, and <., true>, pass 3
//    along x: a block holds a tile of 256 z-contiguous cells by 64 rows plus
//    a cap halo on both sides in shared memory (16-byte loads), and each
//    thread takes the 2 cap + 1 taps for 16 cells at once as eight u16x2
//    words (min/max.u16x2, native on sm_90).  Pass 3 writes min(g3, cap)
//    straight into the sigma lane of the empty cells (g3 == 0 exactly at
//    the occupied ones) through shared memory, so that a warp's stores are
//    contiguous: there is no separate fold pass.
// The traffic is the LUT's sigma lane written once (pass 3; a
// partial-sector write, so the card reads those sectors too), four passes
// over a 134 MB uint8 grid, and the LUT read once (pass 1; its sigma lanes
// fill every sector).  Indices are 32-bit within a row; rows and planes
// are 64-bit offsets.
//
// Built without fast math and with -fmad=false: the occupancy test and the
// fold read the sigma lane as integer bits, never as a float, so denormal
// skip distances and sigma bit patterns pass through untouched.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr uint32_t kInternalRoot = (uint32_t)rt::kLutDepthSentinel
                                   << rt::kLutPtrBits;  // internal, node 0

// ---------------------------------------------------------------------------
// LUT build
// ---------------------------------------------------------------------------

constexpr int kStep = 3;  // levels a build launch descends
constexpr int kBuildThreads = 256;
constexpr int kMaxSteps = 32;

struct BuildStep {
  int lev0;  // level of the coarse table (0: the root)
  int k;     // levels this launch descends
};

// The build's launches: the first takes the remainder (1..kStep levels),
// every later one kStep.  levels <= 0 is one launch that writes the root.
int build_steps(int levels, BuildStep* s) {
  if (levels <= 0) {
    s[0] = {0, 0};
    return 1;
  }
  const int n = (levels + kStep - 1) / kStep;
  const int k0 = levels - kStep * (n - 1);
  for (int i = 0; i < n; ++i)
    s[i] = {i == 0 ? 0 : k0 + kStep * (i - 1), i == 0 ? k0 : kStep};
  return n;
}

inline long long cube(long long r) { return r * r * r; }

// The entry of cell i of the table at level lev0 + k (res^3 cells) from
// the coarse table at level lev0 (res / N^k per side; nullptr: the root).
template <int kN>
__device__ __forceinline__ int2 cell_entry(const int2* __restrict__ chs,
                                           const int2* __restrict__ coarse,
                                           unsigned long long i, int n_rt,
                                           int lev0, int k, int res,
                                           int log2_res, int mark) {
  const int N = kN ? kN : n_rt;
  int x, y, z;
  if (kN == 2) {
    const unsigned m = (unsigned)res - 1u;
    z = (int)((unsigned)i & m);
    y = (int)((unsigned)(i >> log2_res) & m);
    x = (int)(i >> (2 * log2_res));
  } else {
    const unsigned long long row = i / (unsigned)res;
    z = (int)(i - row * res);
    x = (int)(row / (unsigned)res);
    y = (int)(row - (unsigned long long)x * res);
  }
  int2 e = make_int2((int)kInternalRoot, 0);
  if (coarse != nullptr) {
    int cx, cy, cz, rc;
    if (kN == 2) {
      cx = x >> k;
      cy = y >> k;
      cz = z >> k;
      rc = res >> k;
    } else {
      const int div = rt::ipow(N, k);
      cx = x / div;
      cy = y / div;
      cz = z / div;
      rc = res / div;
    }
    e = __ldg(coarse + ((long long)cx * rc + cy) * rc + cz);
    if (((uint32_t)e.x >> rt::kLutPtrBits) !=
        (uint32_t)rt::kLutDepthSentinel)
      return e;  // a leaf above this launch's levels
  }
  int node = (int)((uint32_t)e.x & rt::kLutPtrMask);
  const int N3 = N * N * N;
  for (int j = 0; j < k; ++j) {
    int ci;
    if (kN == 2) {
      const int s = k - 1 - j;
      ci = (((x >> s) & 1) << 2) | (((y >> s) & 1) << 1) | ((z >> s) & 1);
    } else {
      const int div = rt::ipow(N, k - 1 - j);
      ci = (((x / div) % N) * N + (y / div) % N) * N + (z / div) % N;
    }
    const int sub = node * N3 + ci;
    const int2 row = __ldg(chs + sub);
    if (row.x == 0) {
      const uint32_t packed =
          ((uint32_t)(lev0 + j + 1) << rt::kLutPtrBits) | (uint32_t)sub;
      return make_int2((int)packed, row.y);
    }
    node += row.x;
  }
  return make_int2((int)(kInternalRoot | (uint32_t)node), mark);
}

// out: the table at level lev0 + k; mark: the sigma lane of its internal
// cells (a coarse table's internal cells are read for their node only)
template <int kN>
__global__ void __launch_bounds__(kBuildThreads)
    lut_step_kernel(const int2* __restrict__ chs,
                    const int2* __restrict__ coarse, int2* __restrict__ out,
                    int n_rt, int lev0, int k, int res, int log2_res,
                    unsigned long long n_cells, int mark) {
  const unsigned long long i =
      (unsigned long long)blockIdx.x * kBuildThreads + threadIdx.x;
  if (i < n_cells)
    out[i] = cell_entry<kN>(chs, coarse, i, n_rt, lev0, k, res, log2_res,
                            mark);
}

// ---------------------------------------------------------------------------
// skip distances
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 8;       // pass 1: rows (warps) a block
constexpr int kTileZ = 16;         // passes 2-3: threads across z, 16 cells each
constexpr int kTileRows = 16;      // threads along the pass's axis
constexpr int kRowsPerThread = 4;  // outputs a thread along the axis
constexpr int kTileA = kTileRows * kRowsPerThread;
constexpr int kTileCells = kTileZ * 16;  // z-contiguous cells of a tile
constexpr int kAxisThreads = kTileZ * kTileRows;

// Distance from bit b of word s to the nearest set bit of the row bitset
// w[0..words), or a value above cap when there is none within cap.
__device__ __forceinline__ int nearest_occupied(const uint32_t* w, int words,
                                                int s, int b, int cap) {
  int best = cap + 1;
  const uint32_t here = w[s];
  const uint32_t left = here & (0xffffffffu >> (31 - b));  // bits 0..b
  if (left != 0u) {
    best = b - (31 - __clz(left));
  } else {
    for (int k = 1, d = b + 1; d <= cap && s - k >= 0; ++k, d += 32) {
      const uint32_t v = w[s - k];
      if (v != 0u) {
        best = d + __clz(v);
        break;
      }
    }
  }
  const uint32_t right = here & (0xffffffffu << b);  // bits b..31
  if (right != 0u) {
    best = min(best, __ffs(right) - 1 - b);
  } else {
    for (int k = 1, d = 32 - b; d < best && s + k < words; ++k, d += 32) {
      const uint32_t v = w[s + k];
      if (v != 0u) {
        best = min(best, d + __ffs(v) - 1);
        break;
      }
    }
  }
  return best;
}

// g1 of the 16 cells from bit b0 (0 or 16) of word s on: for cap < 32 the
// words s-1, s, s+1 hold every bit within reach.  Two 64-bit windows give
// the distance to the left of the first cell and to the right of the
// last; a scan each way carries them across the chunk.
__device__ __forceinline__ uint4 nearest16(const uint32_t* w, int words,
                                           int s, int b0, int cap) {
  const uint64_t prev = s > 0 ? w[s - 1] : 0u;
  const uint64_t next = s + 1 < words ? w[s + 1] : 0u;
  const uint64_t here = w[s];
  const uint32_t bits = (uint32_t)(here >> b0);  // the chunk's cells at 0..15
  int left[16], right[16];
  left[0] = __clzll(((here << 32) | prev) << (31 - b0));  // 64 if none
  right[15] = __clzll(__brevll(((next << 32) | here) >> (b0 + 15)));
#pragma unroll
  for (int j = 1; j < 16; ++j)
    left[j] = (bits >> j) & 1u ? 0 : left[j - 1] + 1;
#pragma unroll
  for (int j = 14; j >= 0; --j)
    right[j] = (bits >> j) & 1u ? 0 : right[j + 1] + 1;
  uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    out[j >> 2] |= (uint32_t)min(min(left[j], right[j]), cap + 1)
                   << (8 * (j & 3));
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// Pass 1: g1 = min(distance along z to the nearest occupied cell, cap + 1),
// the occupancy from the LUT's sigma lanes.  Lane c writes the 16 cells
// from 16 c on (then 16 (c + 32), ...).
__global__ void __launch_bounds__(kRowWarps * 32)
    skip_rows_kernel(const int2* __restrict__ lut, uint8_t* __restrict__ g1,
                     int res, int cap, long long n_rows) {
  extern __shared__ uint32_t row_bits[];  // [kRowWarps][words]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = (res + 31) >> 5;
  const long long row = (long long)blockIdx.x * kRowWarps + warp;
  if (row >= n_rows) return;  // whole warps only
  uint32_t* w = row_bits + warp * words;
  const int* sig = reinterpret_cast<const int*>(lut + row * res) + 1;
#pragma unroll 4
  for (int s = 0; s < words; ++s) {
    const int z = (s << 5) | lane;
    const bool on = z < res && __ldg(sig + 2 * z) != 0;
    const uint32_t bits = __ballot_sync(0xffffffffu, on);
    if (lane == 0) w[s] = bits;
  }
  __syncwarp();
  uint8_t* out = g1 + row * res;
  for (int z0 = lane * 16; z0 < res; z0 += 32 * 16) {
    uint4 g;
    if (cap < 32) {
      g = nearest16(w, words, z0 >> 5, z0 & 31, cap);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      for (int j = 0; j < 16 && z0 + j < res; ++j)
        v[j >> 2] |= (uint32_t)min(nearest_occupied(w, words, (z0 + j) >> 5,
                                                    (z0 + j) & 31, cap),
                                   cap + 1)
                     << (8 * (j & 3));
      g = make_uint4(v[0], v[1], v[2], v[3]);
    }
    if (res % 16 == 0) {
      *reinterpret_cast<uint4*>(out + z0) = g;
    } else {
      const uint32_t v[4] = {g.x, g.y, g.z, g.w};
      for (int j = 0; j < 16 && z0 + j < res; ++j)
        out[z0 + j] = (uint8_t)(v[j >> 2] >> (8 * (j & 3)));
    }
  }
}

__device__ __forceinline__ uint32_t min_u16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// 16 uint8 cells -> eight u16x2 words (cells 2h, 2h+1 in word h), and back.
__device__ __forceinline__ void widen(uint4 v, uint32_t* h) {
  h[0] = __byte_perm(v.x, 0u, 0x4140);
  h[1] = __byte_perm(v.x, 0u, 0x4342);
  h[2] = __byte_perm(v.y, 0u, 0x4140);
  h[3] = __byte_perm(v.y, 0u, 0x4342);
  h[4] = __byte_perm(v.z, 0u, 0x4140);
  h[5] = __byte_perm(v.z, 0u, 0x4342);
  h[6] = __byte_perm(v.w, 0u, 0x4140);
  h[7] = __byte_perm(v.w, 0u, 0x4342);
}

__device__ __forceinline__ uint4 narrow(const uint32_t* h) {
  return make_uint4(__byte_perm(h[0], h[1], 0x6420),
                    __byte_perm(h[2], h[3], 0x6420),
                    __byte_perm(h[4], h[5], 0x6420),
                    __byte_perm(h[6], h[7], 0x6420));
}

// best = min(best, max(tap, dd)) for 16 cells; dd = d in both halves
__device__ __forceinline__ void take_tap(uint32_t* best, uint4 tap,
                                         uint32_t dd) {
  uint32_t t[8];
  widen(tap, t);
#pragma unroll
  for (int h = 0; h < 8; ++h)
    best[h] = min_u16x2(best[h], max_u16x2(t[h], dd));
}

// the two taps at distance d: best = min(best, max(min(u, v), dd))
__device__ __forceinline__ void take_taps(uint32_t* best, uint4 u, uint4 v,
                                          uint32_t dd) {
  uint32_t tu[8], tv[8];
  widen(u, tu);
  widen(v, tv);
#pragma unroll
  for (int h = 0; h < 8; ++h)
    best[h] = min_u16x2(best[h], max_u16x2(min_u16x2(tu[h], tv[h]), dd));
}

// 16 cells from z0 on, the ones at or past res read as 0 (never output).
template <bool kVec>
__device__ __forceinline__ uint4 load16(const uint8_t* p, int left) {
  if (kVec) return left > 0 ? __ldg(reinterpret_cast<const uint4*>(p))
                            : make_uint4(0u, 0u, 0u, 0u);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int b = 0; b < 16 && b < left; ++b)
    w[b >> 2] |= (uint32_t)p[b] << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Passes 2 and 3: g_out(p) = min over |j| <= cap of max(|j|, g_in(p + j e))
// along the axis whose cells lie row_stride apart, within planes
// plane_stride apart; z (stride 1) is the tile's other side.  kVec: res is
// a multiple of 16 (16-byte loads and stores).  kFold: write min(g, cap)
// into the sigma lane of the cells with g > 0 instead of writing g.
template <bool kVec, bool kFold>
__global__ void __launch_bounds__(kAxisThreads)
    skip_axis_kernel(const uint8_t* __restrict__ src,
                     uint8_t* __restrict__ dst, int2* __restrict__ lut,
                     int res, int cap, long long row_stride,
                     long long plane_stride) {
  // [tile_rows][kTileZ] input rows, then (kFold) [kTileA][kTileZ] outputs
  extern __shared__ uint4 tile[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int z0 = (blockIdx.x * kTileZ + tx) * 16;
  const int a0 = blockIdx.y * kTileA;
  const long long plane = (long long)blockIdx.z * plane_stride;
  const int lo = max(0, a0 - cap), hi = min(res, a0 + kTileA + cap);
  const int rows = hi - lo;
  for (int r = ty; r < rows; r += kTileRows)
    tile[r * kTileZ + tx] = load16<kVec>(
        src + plane + (long long)(lo + r) * row_stride + z0, res - z0);
  __syncthreads();

  uint4* outs = tile + min(res, kTileA + 2 * cap) * kTileZ;
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int ra = ty + q * kTileRows;
    const int a = a0 + ra;
    uint4 g = make_uint4(0u, 0u, 0u, 0u);
    if (a < res) {
      const int r = a - lo;
      uint32_t best[8];
      widen(tile[r * kTileZ + tx], best);
      const int dl = min(cap, r), dr = min(cap, rows - 1 - r);
      const int both = min(dl, dr);
      int d = 1;
      for (; d <= both; ++d)
        take_taps(best, tile[(r - d) * kTileZ + tx],
                  tile[(r + d) * kTileZ + tx], (uint32_t)d * 0x00010001u);
      for (int e = d; e <= dl; ++e)
        take_tap(best, tile[(r - e) * kTileZ + tx], (uint32_t)e * 0x00010001u);
      for (int e = d; e <= dr; ++e)
        take_tap(best, tile[(r + e) * kTileZ + tx], (uint32_t)e * 0x00010001u);
      g = narrow(best);
    }
    if (kFold) {
      outs[ra * kTileZ + tx] = g;
    } else if (a < res && z0 < res) {
      uint8_t* p = dst + plane + (long long)a * row_stride + z0;
      if (kVec) {
        *reinterpret_cast<uint4*>(p) = g;
      } else {
        const uint32_t w[4] = {g.x, g.y, g.z, g.w};
        for (int b = 0; b < 16 && z0 + b < res; ++b)
          p[b] = (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
      }
    }
  }
  if (kFold) {
    __syncthreads();
    const uint8_t* ob = reinterpret_cast<const uint8_t*>(outs);
    const int zb = blockIdx.x * kTileCells;
    for (int e = ty * kTileZ + tx; e < kTileA * kTileCells;
         e += kAxisThreads) {
      const int a = a0 + e / kTileCells, z = zb + e % kTileCells;
      const int v = ob[e];
      if (a < res && z < res && v != 0)
        lut[plane + (long long)a * row_stride + z].y = min(v, cap);
    }
  }
}

template <bool kVec, bool kFold>
cudaError_t launch_axis(const uint8_t* src, uint8_t* dst, int2* lut, int res,
                        int cap, long long row_stride, long long plane_stride,
                        cudaStream_t s) {
  const size_t smem = (size_t)(std::min(res, kTileA + 2 * cap) +
                               (kFold ? kTileA : 0)) *
                      kTileZ * sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      skip_axis_kernel<kVec, kFold>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((res + kTileCells - 1) / kTileCells,
                  (res + kTileA - 1) / kTileA, res);
  skip_axis_kernel<kVec, kFold><<<grid, dim3(kTileZ, kTileRows), smem, s>>>(
      src, dst, lut, res, cap, row_stride, plane_stride);
  return cudaGetLastError();
}

}  // namespace

// Cells of int2 scratch that rt_lut_build needs for its coarse tables.
RT_API int rt_lut_build_scratch(int N, int levels, long long* cells) {
  BuildStep steps[kMaxSteps];
  const int n = build_steps(levels, steps);
  long long total = 0;
  for (int i = 0; i + 1 < n; ++i)
    total += cube(rt::ipow(N, steps[i].lev0 + steps[i].k));
  *cells = total;
  return 0;
}

// chs: [M, 2] i32 (child skip, sigma bits); lut: [res^3, 2] i32 output;
// scratch: rt_lut_build_scratch cells of int2; internal_mark: the sigma
// lane of the LUT's internal cells (0, or a marker outside the skip
// distances' 1..255).  *launches: kernels launched.
RT_API int rt_lut_build(const void* chs, void* lut, void* scratch, int N,
                        int levels, int internal_mark, int* launches,
                        void* stream) {
  BuildStep steps[kMaxSteps];
  const int n = build_steps(levels, steps);
  *launches = 0;
  const int2* coarse = nullptr;
  int2* next = (int2*)scratch;
  for (int i = 0; i < n; ++i) {
    const int lev = steps[i].lev0 + steps[i].k;
    const int res = rt::ipow(N, lev);
    const unsigned long long cells = (unsigned long long)cube(res);
    const bool last = i + 1 == n;
    int2* out = last ? (int2*)lut : next;
    const int mark = last ? internal_mark : 0;
    const unsigned blocks =
        (unsigned)((cells + kBuildThreads - 1) / kBuildThreads);
    if (N == 2)
      lut_step_kernel<2><<<blocks, kBuildThreads, 0, (cudaStream_t)stream>>>(
          (const int2*)chs, coarse, out, N, steps[i].lev0, steps[i].k, res,
          lev, cells, mark);
    else
      lut_step_kernel<0><<<blocks, kBuildThreads, 0, (cudaStream_t)stream>>>(
          (const int2*)chs, coarse, out, N, steps[i].lev0, steps[i].k, res,
          lev, cells, mark);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
    coarse = out;
    next = out + cells;
  }
  return 0;
}

// lut: [res^3, 2] i32, updated in place; g1, g2: res^3 bytes each; cap in
// 1..253.  *launches: kernels launched.
RT_API int rt_skip_distances(void* lut, void* g1, void* g2, int res, int cap,
                             int* launches, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  *launches = 0;
  const long long n_rows = (long long)res * res;
  const size_t row_smem = (size_t)kRowWarps * ((res + 31) / 32) * 4;
  skip_rows_kernel<<<(unsigned)((n_rows + kRowWarps - 1) / kRowWarps),
                     kRowWarps * 32, row_smem, s>>>(
      (const int2*)lut, (uint8_t*)g1, res, cap, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  // pass 2 along y (rows res apart) in each x plane, pass 3 along x (rows
  // res^2 apart) in each y plane, folded into the LUT
  const bool vec = res % 16 == 0;
  err = vec ? launch_axis<true, false>((const uint8_t*)g1, (uint8_t*)g2,
                                       nullptr, res, cap, res, n_rows, s)
            : launch_axis<false, false>((const uint8_t*)g1, (uint8_t*)g2,
                                        nullptr, res, cap, res, n_rows, s);
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  err = vec ? launch_axis<true, true>((const uint8_t*)g2, nullptr,
                                      (int2*)lut, res, cap, n_rows, res, s)
            : launch_axis<false, true>((const uint8_t*)g2, nullptr,
                                       (int2*)lut, res, cap, n_rows, res, s);
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}
