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
// dynamic index into a ring of Nbuf row slots in shared memory, Nbuf copies
// in flight, `rounds` passes over idx.  WholeRow (P4): every column summed
// in f32, in the order of i, into out[width] (width <= 128).  Otherwise
// (P5): element 0 of every row summed as uint32 (JAX's int32 addition
// wraps), out[0].
//
// One block of one warp: the TPU probe's single issuer, so the result is
// that issuer's sum whatever the card, and a float sum keeps the probe's
// order.  The warp first copies idx into shared memory, as the Pallas
// probes' scalar prefetch into SMEM does (read from global memory inside
// the loop instead, an index cost 50-60 ns more per row on an H100).  Each
// lane copies its own 16-, 8- or 4-byte chunks of every row with cp.async
// (cp.async.bulk would need 16-byte multiples, and P5's width-2 rows are
// 8 bytes) and reads back only what it copied, so after
// cp.async.wait_group no barrier is needed; P4's sums stay in registers.
// The whole row moves even when only element 0 is summed.  One commit
// group per ring step, empty past the last row, so wait_group<Nbuf-1>
// always means "the oldest row is in".
//
// Bound on an H100 by the warp's own path per row, not by memory: the
// issue, commit and wait of one row take ~90 ns whether or not the row is
// read, at Nbuf 8 and 32 alike, for a 512 KB table and a 2 GiB one, warm
// or cold, so rings deeper than 8 buy nothing.  One warp cannot come near
// the card's bandwidth, which is what the probe measures.
// ---------------------------------------------------------------------------
constexpr int kRingLaneChunks = 4;  // WholeRow: row_bytes <= 32 * 4 * chunk

__device__ __forceinline__ void copy_chunk(unsigned char* dst,
                                           const unsigned char* src,
                                           int chunk) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (chunk == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else if (chunk == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

template <bool WholeRow, int Nbuf>
__global__ void __launch_bounds__(32)
    row_ring_kernel(const int* __restrict__ idx, int n,
                    const unsigned char* __restrict__ table, int rows,
                    int width, int chunk, int rounds, void* __restrict__ out) {
  // ring [Nbuf][row_bytes], then idx [n]
  extern __shared__ __align__(16) unsigned char ring[];
  const int lane = threadIdx.x;
  const int row_bytes = width * 4;
  int* sidx = reinterpret_cast<int*>(ring + Nbuf * row_bytes);
  for (int j = lane; j < n; j += 32) {
    const int r = idx[j];
    if ((unsigned)r >= (unsigned)rows) __trap();
    sidx[j] = r;
  }
  __syncwarp();
  const int words = chunk / 4;
  float acc[kRingLaneChunks * 4] = {};  // WholeRow: this lane's columns
  uint32_t sum0 = 0;

  auto issue = [&](int slot, int i) {
    if (i < n) {
      const unsigned char* src = table + (size_t)sidx[i] * row_bytes;
      unsigned char* dst = ring + slot * row_bytes;
      for (int o = lane * chunk; o < row_bytes; o += 32 * chunk)
        copy_chunk(dst + o, src + o, chunk);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  for (int rd = 0; rd < rounds; ++rd) {
    for (int s = 0; s < Nbuf; ++s) issue(s, s);
    for (int i = 0; i < n; ++i) {
      const int slot = i % Nbuf;
      asm volatile("cp.async.wait_group %0;\n" ::"n"(Nbuf - 1) : "memory");
      const unsigned char* row = ring + slot * row_bytes;
      if (WholeRow) {
        const float* v = reinterpret_cast<const float*>(row);
#pragma unroll
        for (int c = 0; c < kRingLaneChunks; ++c) {
          const int o = (lane + 32 * c) * chunk;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (o < row_bytes && q < words)
              acc[c * 4 + q] = acc[c * 4 + q] + v[o / 4 + q];
        }
      } else if (lane == 0) {
        sum0 += *reinterpret_cast<const uint32_t*>(row);
      }
      issue(slot, i + Nbuf);
    }
  }
  if (WholeRow) {
    float* o_ = reinterpret_cast<float*>(out);
#pragma unroll
    for (int c = 0; c < kRingLaneChunks; ++c) {
      const int o = (lane + 32 * c) * chunk;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (o < row_bytes && q < words) o_[o / 4 + q] = acc[c * 4 + q];
    }
  } else if (lane == 0) {
    *reinterpret_cast<int*>(out) = (int)sum0;
  }
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
                    int width, int rounds, void* out, void* stream) {
  const int row_bytes = width * 4;
  const long long smem = (long long)Nbuf * row_bytes + (long long)n * 4;
  if (width < 1 || n < 1 || smem > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const unsigned long long base = (unsigned long long)table;
  const int chunk = (row_bytes % 16 == 0 && base % 16 == 0) ? 16
                    : (row_bytes % 8 == 0 && base % 8 == 0)  ? 8
                                                             : 4;
  if (WholeRow && row_bytes > 32 * kRingLaneChunks * chunk)
    return (int)cudaErrorInvalidValue;
  auto kernel = row_ring_kernel<WholeRow, Nbuf>;
  cudaError_t err = allow_smem(kernel, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, 32, (int)smem, (cudaStream_t)stream>>>(
      (const int*)idx, n, (const unsigned char*)table, rows, width, chunk,
      rounds, out);
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

// idx: [n] i32; tab: [rows, width <= 128] f32; out: [width] f32.  Ring
// depth 2; (2 * width + n) * 4 bytes of shared memory.
RT_API int rt_row_sum_ring(const void* idx, int n, const void* tab, int rows,
                           int width, void* out, void* stream) {
  return launch_row_ring<true, 2>(idx, n, tab, rows, width, 1, out, stream);
}

// idx: [n] i32; table: [rows, width] i32; out: [1] i32;
// nbuf in {2, 4, 8, 16, 32}; (nbuf * width + n) * 4 bytes of shared memory.
RT_API int rt_row_ring_rounds(const void* idx, int n, const void* table,
                              int rows, int width, int nbuf, int rounds,
                              void* out, void* stream) {
  switch (nbuf) {
    case 2:
      return launch_row_ring<false, 2>(idx, n, table, rows, width, rounds,
                                       out, stream);
    case 4:
      return launch_row_ring<false, 4>(idx, n, table, rows, width, rounds,
                                       out, stream);
    case 8:
      return launch_row_ring<false, 8>(idx, n, table, rows, width, rounds,
                                       out, stream);
    case 16:
      return launch_row_ring<false, 16>(idx, n, table, rows, width, rounds,
                                        out, stream);
    case 32:
      return launch_row_ring<false, 32>(idx, n, table, rows, width, rounds,
                                        out, stream);
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
