// G1-G4: the probe kernels of the measurement tools, one C entry per Pallas
// function of the TPU tools they replace:
//
//   rt_probe_affine       G1  tools/tpu_probe.py:46          probe_basic.f (P1)
//   rt_lane_gather        G2  tools/tpu_probe.py:69          probe_vgather.f (P2)
//   rt_lane_gather_chain  G2  tools/tpu_probe.py:104         probe_vgather_loop.f (P3)
//   rt_row_sum_ring       G3  tools/tpu_probe.py:158         probe_dma.f (P4)
//   rt_row_ring_rounds    G3  tools/microbench_gather.py:132 bench_pallas_dma.make (P5)
//   rt_flat_gather_chain  G4  tools/microbench_gather.py:183 bench_pallas_vmem_gather (P6)
//
// They measure what bounds the render kernel K1: the latency of a chain of
// dependent gathers (one lookup feeds the next index) by where the table
// lives, and the rate at which rows are fetched by dynamic index with k
// copies in flight.  Each kernel's note says what bounds it on this card.
// An index outside its table traps (the launch fails at the next
// synchronize), as an out-of-range index_select does on the card.
#include <type_traits>

#include "common.cuh"

namespace {

// Dynamic shared memory one block may opt into on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;
// Largest flat table G4 stages in shared memory: two blocks still fit on
// one SM.  Larger tables are read through L1/L2 (or HBM past the L2).
constexpr int kFlatSmemBytes = 96 * 1024;
constexpr int kLaneThreads = 1024;
constexpr int kFlatThreads = 256;

// jnp.remainder / torch.remainder for m > 0: the result takes the sign of m.
__device__ __forceinline__ int floor_mod(int v, int m) {
  const int r = v % m;
  return r < 0 ? r + m : r;
}

// ---------------------------------------------------------------------------
// G1 (P1): o = 2x + 1, the toolchain check.  Bound by launch overhead at the
// tool's 8x128; a grid-stride loop for any size.  The product and the sum
// are rounded separately, as the two PyTorch ops of the plain version are
// (x * 2 is exact, so a fused multiply-add would agree too).
// ---------------------------------------------------------------------------
__global__ void affine_kernel(const float* __restrict__ x,
                              float* __restrict__ out, int n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = __fadd_rn(__fmul_rn(x[i], 2.f), 1.f);
}

// ---------------------------------------------------------------------------
// G2 (P2, P3): per-lane gather out[i, l] = tab[idx[i, l], l] over a
// [rows_tab, width] table; with Chain, `rounds` dependent rounds
// cur = (cur + tab[cur, l] + 1) mod rows_tab (int32 wrap-around, as JAX).
//
// The TPU probes held the whole table in VMEM (2 and 4 MiB).  A single
// gather (P2) reads the table where it is, one output element per thread
// in row-major order: the tool's 2 MiB table stays in the 50 MB L2, and
// staging it would cost more than the one read it serves; it is bound by
// the 32 random rows a warp touches per load.  A chain (P3) gives a block
// `cols` adjacent columns and 1024 / cols rows of the output; the block
// first stages its columns in shared memory, transposed so that each
// column is contiguous (one P3 column is 32 KB; cols = 4 uses 128 KB), and
// then every round is a shared-memory load.  The chain is bound by that
// load's latency, which 32 warps per SM hide only partly; the staging is
// a fixed cost per block that the tools' marginal per-round figure takes
// out.
// ---------------------------------------------------------------------------
template <bool Chain, typename T>
__global__ void __launch_bounds__(kLaneThreads)
    lane_gather_kernel(const T* __restrict__ tab, const int* __restrict__ idx,
                       T* __restrict__ out, int rows_tab, int width,
                       int rows_out, int cols, int rounds) {
  static_assert(!Chain || std::is_same<T, int>::value,
                "a chain carries int32 indices");
  if constexpr (!Chain) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= (long long)rows_out * width) return;
    const int cur = idx[p];
    if ((unsigned)cur >= (unsigned)rows_tab) __trap();
    out[p] = __ldg(tab + (long long)cur * width + p % width);
  } else {
    extern __shared__ __align__(16) unsigned char lane_smem[];
    int* staged = reinterpret_cast<int*>(lane_smem);  // [cols][rows_tab]
    const int c0 = blockIdx.x * cols;
    for (int e = threadIdx.x; e < cols * rows_tab; e += blockDim.x) {
      const int t = e / cols, c = e - t * cols;
      staged[c * rows_tab + t] = tab[(long long)t * width + c0 + c];
    }
    __syncthreads();
    const int c = threadIdx.x % cols;
    const int i = blockIdx.y * (blockDim.x / cols) + threadIdx.x / cols;
    if (i >= rows_out) return;
    const long long p = (long long)i * width + c0 + c;
    int cur = idx[p];
    if ((unsigned)cur >= (unsigned)rows_tab) __trap();
    const int* column = staged + c * rows_tab;
    for (int k = 0; k < rounds; ++k)
      cur = floor_mod((int)((unsigned)cur + (unsigned)column[cur] + 1u),
                      rows_tab);
    out[p] = cur;
  }
}

// ---------------------------------------------------------------------------
// G3 (P4, P5): rows table[idx[i]] (width 4-byte words each) copied by
// dynamic index into a ring of Nbuf row slots in shared memory, `rounds`
// passes over idx.  WholeRow (P4): every column summed in f32 into
// out[width] (width <= 128).  Otherwise (P5): element 0 of every row
// summed as uint32 (JAX's int32 addition wraps), out[0].
//
// The Pallas probes run grid=(1,) on a TPU v5e, whose one TensorCore makes
// their single DMA issuer the whole chip.  Here the whole card issues: idx
// is cut into chunks of kRingChunk rows, one CTA a chunk (P4's 4096 rows
// are 128 CTAs, P5's 8192 are 256), several CTAs to an SM (a ring of 32
// slots of 512 B is 16 KB).  A CTA first stages its chunk's indices in
// shared memory, as the Pallas probes' scalar prefetch does, and traps on
// one outside the table.  Then lane 0 of warp 0 issues row after row into
// slot k % Nbuf: one cp.async.bulk completing on the slot's full mbarrier,
// armed with arrive.expect_tx for the row's bytes.  Warp 1 waits on the
// slot's phase (try_wait.parity) and reads the row (P5: a group of steps
// at once, a lane a step).  The steps go in groups of ring_group(Nbuf):
// warp 1 frees a group's slots with one arrival on the empty mbarrier of
// its last slot, and the issuer waits on that barrier before it fills the
// group's slots again.  The whole row moves even when only element 0 is
// summed.  A row that is not a multiple of 16 bytes (or a table not
// aligned to 16) cannot go by bulk copy: the issuer copies it by cp.async
// of 8 or 4 bytes, completing on the same barrier by
// cp.async.mbarrier.arrive.noinc (at 8-byte rows, 15 % less time than a
// bulk copy of the aligned 16-byte span that holds the row).
//
// The chunk plan depends on n alone, so P4's f32 result is the same on any
// card: each CTA sums its chunk in the order of i, from 0, into
// partials[chunk][width], and the last CTA to finish (a threadfence and a
// counter) adds the partials in chunk order, from 0.  P5's CTAs sum their
// `rounds` passes as uint32 and add that with one atomicAdd each, exact in
// any order, and the last CTA writes the total.  The last CTA sets the
// counter pair back to zero for the next launch.
//
// Bound on an H100 (chip_smoke.py --probe-times, rows warm in the L2): a
// call costs ~7.4 us with no row at all (launch, the indices, the last
// CTA's finish).  A round trip of a 2-slot ring is ~0.37 us, so P4's 16
// trips a CTA take ~6 us and its last CTA's chunk-order sum ~4 us.  From 8
// slots up a CTA issues about one row every 100 ns, which bounds P5: a
// second issuing warp, a barrier a group of slots or a suspend hint in
// the waits do not move it, and half the rows a CTA (twice the CTAs an
// SM) halves it.
// ---------------------------------------------------------------------------
constexpr int kRingChunk = 32;        // rows a CTA takes
constexpr int kRingThreads = 64;      // warp 0 issues, warp 1 reads
constexpr int kRowSumMaxWidth = 128;  // P4: 4 columns a lane of warp 1
static_assert(kRowSumMaxWidth <= 2 * kRingThreads,
              "the last CTA adds two columns a thread");

// A CTA's shared memory: full[Nbuf] and empty[Nbuf] mbarriers, the
// chunk's indices, then the ring, Nbuf slots of the row rounded up to 16
// bytes.
__host__ __device__ constexpr long long ring_smem_bytes(long long row_bytes,
                                                        int nbuf) {
  return 16LL * nbuf + 4 * kRingChunk + nbuf * ((row_bytes + 15) / 16 * 16);
}

// The ring's steps go in groups of G: the reader frees a group's slots
// with one arrival on the empty barrier of its last slot, and the issuer
// waits on that one barrier before it fills the group's slots again.
__host__ __device__ constexpr int ring_group(int nbuf) {
  return nbuf >= 8 ? nbuf / 4 : 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One row from src into the slot at dst, completing on its full barrier:
// a bulk copy (bulk: a multiple of 16 bytes from a 16-byte aligned
// address), else cp.async pieces of 8 or 4 bytes.
__device__ __forceinline__ void issue_row(uint32_t dst, uint32_t full,
                                          const unsigned char* src,
                                          int row_bytes, bool bulk,
                                          int piece) {
  if (bulk) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            full),
        "r"(row_bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(src), "r"(row_bytes), "r"(full)
        : "memory");
    return;
  }
  for (int o = 0; o < row_bytes; o += piece) {
    if (piece == 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst + o),
                   "l"(src + o)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst + o),
                   "l"(src + o)
                   : "memory");
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   full)
               : "memory");
}

// counter: [CTAs finished, P5's running sum], zero between launches.
template <bool WholeRow, int Nbuf>
__global__ void __launch_bounds__(kRingThreads)
    row_ring_kernel(const int* __restrict__ idx, int n,
                    const unsigned char* __restrict__ table, int rows,
                    int width, int piece, int rounds, void* __restrict__ out,
                    float* __restrict__ partials,
                    unsigned* __restrict__ counter) {
  constexpr int G = ring_group(Nbuf);
  extern __shared__ __align__(128) unsigned char ring_smem[];
  const int row_bytes = width * 4;
  const bool bulk =
      row_bytes % 16 == 0 && ((unsigned long long)table & 15) == 0;
  const uint32_t full = smem_addr(ring_smem);
  const uint32_t empty = full + 8 * Nbuf;
  int* sidx = reinterpret_cast<int*>(ring_smem + 16 * Nbuf);
  unsigned char* ring = ring_smem + 16 * Nbuf + 4 * kRingChunk;
  const int slot = (row_bytes + 15) / 16 * 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * kRingChunk;
  const int cnt = min(kRingChunk, n - c0);
  for (int j = threadIdx.x; j < cnt; j += kRingThreads) {
    const int r = idx[c0 + j];
    if ((unsigned)r >= (unsigned)rows) __trap();
    sidx[j] = r;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < Nbuf; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(full +
                                                                    8 * s));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(empty +
                                                                    8 * s));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int total = cnt * rounds;  // ring steps: rounds passes of the chunk
  float acc[kRowSumMaxWidth / 32] = {};
  uint32_t sum0 = 0;
  if (warp == 0) {
    if (lane == 0) {
      int r = sidx[0];
      for (int k = 0, j = 0; k < total; ++k) {
        const int s = k % Nbuf;
        // step k's group reuses the slots of the group Nbuf steps back
        if (k >= Nbuf && k % G == 0)
          bar_wait(empty + 8 * ((k + G - 1) % Nbuf),
                   ((k + G - 1) / Nbuf - 1) & 1);
        if (++j == cnt) j = 0;
        const int next = sidx[j];  // the next row's index, loaded ahead
        issue_row(smem_addr(ring + s * slot), full + 8 * s,
                  table + (long long)r * row_bytes, row_bytes, bulk, piece);
        r = next;
      }
    }
  } else if constexpr (WholeRow) {
    for (int k = 0; k < total; ++k) {
      const int s = k % Nbuf;
      bar_wait(full + 8 * s, (k / Nbuf) & 1);
      const float* v = reinterpret_cast<const float*>(ring + s * slot);
#pragma unroll
      for (int q = 0; q < kRowSumMaxWidth / 32; ++q)
        if (lane + 32 * q < width) acc[q] = acc[q] + v[lane + 32 * q];
      __syncwarp();
      if (lane == 0 && k % G == G - 1) bar_arrive(empty + 8 * s);
    }
#pragma unroll
    for (int q = 0; q < kRowSumMaxWidth / 32; ++q)
      if (lane + 32 * q < width)
        partials[(long long)blockIdx.x * width + lane + 32 * q] = acc[q];
  } else {
    // a group's G steps at once, lane l taking its step l
    for (int k0 = 0; k0 < total; k0 += G) {
      const int k = k0 + lane;
      if (lane < G && k < total) {
        const int s = k % Nbuf;
        bar_wait(full + 8 * s, (k / Nbuf) & 1);
        sum0 += *reinterpret_cast<const uint32_t*>(ring + s * slot);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty + 8 * ((k0 + G - 1) % Nbuf));
    }
    sum0 = __reduce_add_sync(0xffffffffu, sum0);
    if (lane == 0) atomicAdd(counter + 1, sum0);
  }
  __threadfence();
  __syncthreads();
  // the ring is done with sidx: sidx[0] says whether this CTA is the last
  if (threadIdx.x == 0) sidx[0] = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!sidx[0]) return;
  __threadfence();
  if constexpr (WholeRow) {
    // the partials in chunk order, columns t and t + kRingThreads of
    // thread t, 16 chunks' loads from the L2 in flight at a time
    constexpr int kBatch = 16;
    const int chunks = gridDim.x;
    const int col = threadIdx.x;
    float tot[2] = {0.f, 0.f};
    for (int c = 0; c < chunks; c += kBatch) {
      float v[2][kBatch];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          v[h][q] = c + q < chunks && col + kRingThreads * h < width
                        ? __ldcg(partials + (long long)(c + q) * width +
                                 col + kRingThreads * h)
                        : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (c + q < chunks) tot[h] = tot[h] + v[h][q];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (col + kRingThreads * h < width)
        reinterpret_cast<float*>(out)[col + kRingThreads * h] = tot[h];
  } else if (threadIdx.x == 0) {
    *reinterpret_cast<int*>(out) = (int)atomicExch(counter + 1, 0u);
  }
  if (threadIdx.x == 0) counter[0] = 0;
}

// ---------------------------------------------------------------------------
// G4 (P6): `rounds` dependent rounds idx = (idx + table[idx]) & (size - 1)
// over a flat int32 table, size a power of two, one thread per index.
// A table of at most 96 KB (the tool's 2^14 entries) is staged in shared
// memory per block, so a round is one shared-memory load; a larger one
// (2^18 and 2^20: 1 and 4 MB) is read where it lies, in the 50 MB L2 once
// warm, or in HBM past it.  Bound by the latency of one load per round:
// each thread's loads are serial, and only the other warps overlap them.
// ---------------------------------------------------------------------------
template <bool Smem>
__global__ void __launch_bounds__(kFlatThreads)
    flat_gather_chain_kernel(const int* __restrict__ idx, int n,
                             const int* __restrict__ table, int size,
                             int rounds, int* __restrict__ out) {
  extern __shared__ int flat_smem[];
  const int* tab = table;
  if constexpr (Smem) {
    for (int e = threadIdx.x; e < size; e += blockDim.x)
      flat_smem[e] = table[e];
    __syncthreads();
    tab = flat_smem;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned cur = (unsigned)idx[i];
  if (cur >= (unsigned)size) __trap();
  const unsigned mask = (unsigned)size - 1u;
  for (int k = 0; k < rounds; ++k) {
    int v;
    if constexpr (Smem)
      v = tab[cur];
    else
      v = __ldg(tab + cur);
    cur = (cur + (unsigned)v) & mask;
  }
  out[i] = (int)cur;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <bool Chain, typename T>
int launch_lane_gather(const void* tab, const void* idx, void* out,
                       int rows_tab, int width, int rows_out, int rounds,
                       void* stream) {
  if (rows_out < 1 || width < 1) return (int)cudaErrorInvalidValue;
  auto kernel = lane_gather_kernel<Chain, T>;
  if (!Chain) {
    const long long total = (long long)rows_out * width;
    kernel<<<(unsigned)((total + kLaneThreads - 1) / kLaneThreads),
             kLaneThreads, 0, (cudaStream_t)stream>>>(
        (const T*)tab, (const int*)idx, (T*)out, rows_tab, width, rows_out,
        1, 0);
    return (int)cudaGetLastError();
  }
  if ((long long)rows_tab * sizeof(T) > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  int cols = 1;
  for (int c = 4; c > 1 && cols == 1; c /= 2)
    if (width % c == 0 && (long long)c * rows_tab * sizeof(T) <= kMaxSmemBytes)
      cols = c;
  const int smem = cols * rows_tab * (int)sizeof(T);
  const int rows_per_block = kLaneThreads / cols;
  const dim3 grid(width / cols,
                  (rows_out + rows_per_block - 1) / rows_per_block);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kLaneThreads, smem, (cudaStream_t)stream>>>(
      (const T*)tab, (const int*)idx, (T*)out, rows_tab, width, rows_out,
      cols, rounds);
  return (int)cudaGetLastError();
}

template <bool WholeRow, int Nbuf>
int launch_row_ring(const void* idx, int n, const void* table, int rows,
                    int width, int rounds, void* out, void* partials,
                    void* counter, void* stream) {
  const long long row_bytes = 4LL * width;
  const long long smem = ring_smem_bytes(row_bytes, Nbuf);
  if (width < 1 || n < 1 || rows < 1 || rounds < 0 ||
      smem > kMaxSmemBytes || (WholeRow && width > kRowSumMaxWidth))
    return (int)cudaErrorInvalidValue;
  const unsigned long long base = (unsigned long long)table;
  // cp.async's piece for a row that does not go by bulk copy
  const int piece = (row_bytes % 8 == 0 && base % 8 == 0) ? 8 : 4;
  auto kernel = row_ring_kernel<WholeRow, Nbuf>;
  cudaError_t err = allow_smem(kernel, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + kRingChunk - 1) / kRingChunk, kRingThreads, (int)smem,
           (cudaStream_t)stream>>>(
      (const int*)idx, n, (const unsigned char*)table, rows, width, piece,
      rounds, out, (float*)partials, (unsigned*)counter);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [n] f32.
RT_API int rt_probe_affine(const void* x, void* out, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
  affine_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float*)x,
                                                          (float*)out, n);
  return (int)cudaGetLastError();
}

// tab: [rows_tab, width] f32; idx, out: [rows_out, width] i32 / f32.
RT_API int rt_lane_gather(const void* tab, const void* idx, void* out,
                          int rows_tab, int width, int rows_out,
                          void* stream) {
  return launch_lane_gather<false, float>(tab, idx, out, rows_tab, width,
                                          rows_out, 0, stream);
}

// tab: [rows_tab, width] i32 (a column must fit in 227 KB of shared
// memory); idx, out: [rows_out, width] i32.
RT_API int rt_lane_gather_chain(const void* tab, const void* idx, void* out,
                                int rows_tab, int width, int rows_out,
                                int rounds, void* stream) {
  return launch_lane_gather<true, int>(tab, idx, out, rows_tab, width,
                                       rows_out, rounds, stream);
}

// idx: [n] i32; tab: [rows, width <= 128] f32; out: [width] f32;
// partials: [ceil(n / 32), width] f32 scratch; counter: [2] u32, zero.
// Ring depth 2.
RT_API int rt_row_sum_ring(const void* idx, int n, const void* tab, int rows,
                           int width, void* out, void* partials,
                           void* counter, void* stream) {
  return launch_row_ring<true, 2>(idx, n, tab, rows, width, 1, out, partials,
                                  counter, stream);
}

// idx: [n] i32; table: [rows, width] i32; out: [1] i32; counter: [2] u32,
// zero; nbuf in {2, 4, 8, 16, 32}.
RT_API int rt_row_ring_rounds(const void* idx, int n, const void* table,
                              int rows, int width, int nbuf, int rounds,
                              void* out, void* counter, void* stream) {
  switch (nbuf) {
    case 2:
      return launch_row_ring<false, 2>(idx, n, table, rows, width, rounds,
                                       out, nullptr, counter, stream);
    case 4:
      return launch_row_ring<false, 4>(idx, n, table, rows, width, rounds,
                                       out, nullptr, counter, stream);
    case 8:
      return launch_row_ring<false, 8>(idx, n, table, rows, width, rounds,
                                       out, nullptr, counter, stream);
    case 16:
      return launch_row_ring<false, 16>(idx, n, table, rows, width, rounds,
                                        out, nullptr, counter, stream);
    case 32:
      return launch_row_ring<false, 32>(idx, n, table, rows, width, rounds,
                                        out, nullptr, counter, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// idx, out: [n] i32; table: [size] i32, size a power of two.
RT_API int rt_flat_gather_chain(const void* idx, int n, const void* table,
                                int size, int rounds, void* out,
                                void* stream) {
  if (n < 1 || size < 1 || (size & (size - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kFlatThreads - 1) / kFlatThreads;
  const long long bytes = (long long)size * 4;
  if (bytes <= kFlatSmemBytes) {
    auto kernel = flat_gather_chain_kernel<true>;
    cudaError_t err = allow_smem(kernel, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kFlatThreads, (int)bytes, (cudaStream_t)stream>>>(
        (const int*)idx, n, (const int*)table, size, rounds, (int*)out);
  } else {
    flat_gather_chain_kernel<false>
        <<<blocks, kFlatThreads, 0, (cudaStream_t)stream>>>(
            (const int*)idx, n, (const int*)table, size, rounds, (int*)out);
  }
  return (int)cudaGetLastError();
}
