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
// synchronize), as an out-of-range index_select does on the card.  The
// plans of G2 and G4 (columns a thread, cluster sizes, CTAs, threads) come
// from the wrapper (ops/probes.py), depend on the shapes alone, and are
// checked here.
#include <type_traits>

#include "common.cuh"

namespace {

// Dynamic shared memory one block may opt into on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;
constexpr int kLaneThreads = 1024;
constexpr int kCardSms = 132;  // the H100's SMs: G1's and G2's CTAs fill them

// ---------------------------------------------------------------------------
// G1 (P1): o = 2x + 1, the toolchain check.  At the tool's 8x128 it moves 8
// KB, so a launch's own cost on the device (the floor that chip_smoke.py
// --probe-times measures as an empty kernel) bounds it, not the bytes: one
// CTA of kAffineThreads, a float4 a thread where x and out are 16-byte
// aligned, the rest (the n % 4 tail, or all of an unaligned view) a float a
// thread.  Past a CTA's work the CTAs grow up to kAffineCtasPerSm a SM, in a
// 32-bit grid-stride loop (n < 2^31, so no index wraps).  On the H100 the
// tool's call takes ~0.22 us above the floor, one round trip of its load
// (4 CTAs of scalar loads took ~0.37).  The product and the sum are
// rounded separately, as the two PyTorch ops of the plain version are (x *
// 2 is exact, so a fused multiply-add would agree too).
// ---------------------------------------------------------------------------
constexpr int kAffineThreads = 256;
constexpr int kAffineCtasPerSm = 8;  // 2048 threads an SM

__device__ __forceinline__ float affine(float v) {
  return __fadd_rn(__fmul_rn(v, 2.f), 1.f);
}

__global__ void __launch_bounds__(kAffineThreads)
    affine_kernel(const float* __restrict__ x, float* __restrict__ out,
                  unsigned n, unsigned n4) {
  const unsigned first = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned v = first; v < n4; v += stride) {
    float4 a = reinterpret_cast<const float4*>(x)[v];
    a.x = affine(a.x);
    a.y = affine(a.y);
    a.z = affine(a.z);
    a.w = affine(a.w);
    reinterpret_cast<float4*>(out)[v] = a;
  }
  for (unsigned e = 4 * n4 + first; e < n; e += stride) out[e] = affine(x[e]);
}

// ---------------------------------------------------------------------------
// G2 (P2): per-lane gather out[i, l] = tab[idx[i, l], l] over a
// [rows_tab, width] f32 table.  The TPU probe held the whole table in VMEM
// (2 MiB).  Here the gather reads the table where it lies: the tool's table
// stays in the 50 MB L2.  Each gathered 4-byte value takes a whole 32-byte
// L2 sector (a warp's lanes hit random rows), so the tool's 131,072 lookups
// are 4 MiB of sectors, and the L2's sector rate (~3.9 TB/s for scattered
// 4-byte loads, PERF.md) with the launch floor bounds the call.  A column's
// 1024 lookups over 4096 rows read each table element ~0.25 times, so
// staging the table in shared memory (full sectors need 8-column blocks of
// 128 KiB, one SM taking in one in ~8 us) costs more than the whole call.
//
// A thread takes a piece of C = kGatherCols adjacent columns of one output
// row where the width allows and idx and out are 16-byte aligned (the
// table's alignment does not matter: its loads are 4 bytes): one 16-byte
// idx load, C independent gathers in flight, one 16-byte store; else a
// column (C = 1), the same code.  A thread finds its first (row, piece) by
// one 32-bit division and steps by the grid's stride, split into rows and
// pieces on the host: no 64-bit remainder.  The plan (ops/probes.
// gather_plan) spreads the pieces over all kCardSms SMs, CTAs of up to 256
// threads: the tool's 32,768 pieces are 132 CTAs of 249 threads.  The
// tool's call takes ~1.6 us above the floor on the H100, as an element a
// thread on 128 SMs with a 64-bit remainder did: the idx load, then the
// sectors (~1.05 us of them at ~4 TB/s), bind it (PERF.md).
// ---------------------------------------------------------------------------
constexpr int kGatherCols = 4;

struct GatherArgs {
  int rows_tab, width, rows_out;
  int pieces;        // a row's pieces of C columns
  int drow, dpiece;  // the grid's stride: rows, and pieces past them
};

template <int C>
__global__ void __launch_bounds__(kLaneThreads)
    lane_gather_kernel(const float* __restrict__ tab,
                       const int* __restrict__ idx, float* __restrict__ out,
                       const GatherArgs a) {
  static_assert(C == 1 || C == 4, "a column a thread, or a 16-byte piece");
  using IdxVec = typename std::conditional<C == 4, int4, int>::type;
  using OutVec = typename std::conditional<C == 4, float4, float>::type;
  const unsigned first = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned row = first / (unsigned)a.pieces;
  unsigned piece = first - row * (unsigned)a.pieces;
  while (row < (unsigned)a.rows_out) {
    const long long e = (long long)row * a.width + piece * C;
    const IdxVec iv = *reinterpret_cast<const IdxVec*>(idx + e);
    const int* cur = reinterpret_cast<const int*>(&iv);
#pragma unroll
    for (int j = 0; j < C; ++j)
      if ((unsigned)cur[j] >= (unsigned)a.rows_tab) __trap();
    const float* col = tab + piece * C;
    OutVec ov;
    float* v = reinterpret_cast<float*>(&ov);
#pragma unroll
    for (int j = 0; j < C; ++j)
      v[j] = __ldg(col + (long long)cur[j] * a.width + j);
    *reinterpret_cast<OutVec*>(out + e) = ov;
    row += a.drow;
    piece += a.dpiece;
    if (piece >= (unsigned)a.pieces) {
      piece -= a.pieces;
      ++row;
    }
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
// Thread-block clusters: a CTA's rank, the cluster barrier, and stores into
// another CTA's shared memory (distributed shared memory).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of the cluster arrives, its shared-memory writes released
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

// and waits for all the others, their writes acquired
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the address of this CTA's shared-memory byte `addr` in CTA `rank`
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(out)
      : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_store(uint32_t addr, int v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// ---------------------------------------------------------------------------
// G2 chain (P3): `rounds` dependent rounds per lane,
// cur = (cur + tab[cur, l] + 1) mod rows_tab, over a [rows_tab, width] int32
// table (the sum wraps as int32 does, and the remainder takes the sign of
// rows_tab, as jnp.remainder).
//
// The TPU probe held the 4 MiB table in VMEM.  Here the columns go in
// blocks of `cols` (4, else 2 or 1 where the width or a column's rows ask
// for it), and every CTA that runs chains on a block holds the block whole
// in its shared memory, in [t][cols] order (P3: 8192 rows x 16 B = 128 KiB,
// one CTA an SM).  A block's output rows are cut into parts of `share`
// rows, a CTA a part: the tool's 2048 rows are 4 parts, 32 x 4 = 128 CTAs
// in one wave over 132 SMs, 2048 chains a CTA, two a thread interleaved
// (one a thread measured within 1.5 %).  The parts go in clusters of
// `cluster` CTAs that read their block from the L2 once between them: the
// cluster's threads read the block once, a 16-byte row piece a load where
// the table is 16-byte aligned (4 bytes otherwise), and store each piece
// into every CTA of the cluster (st.shared::cluster), between two cluster
// barriers.
// A sweep of plans on the H100 (its times are in PERF.md) set the plan.
// Clusters of 4 CTAs of 128 KiB do not all fit on the card at once, and
// the second wave doubles the rounds' time, so clusters are 2.  At P3 the
// stores take 16.3 us; multicast tensor copies (TMA) of the block took
// 18.0 and each CTA copying its own block 17.6: whoever sends them, an SM
// takes in its block's 8192 rows one 16-byte piece at a time, ~8 us of the
// call.
//
// A round is one shared-memory load and the reduction: a mask when rows_tab
// is a power of two, else the sum moved to [0, 2^32) divided by a
// multiply-high with a reciprocal made on the host (Granlund and
// Montgomery's unsigned division by an invariant integer) and corrected by
// 2^31 mod rows_tab.  The rounds are bound by bank conflicts: a warp's 32
// random rows fall ~3.5 deep on the banks, ~106 ns a round at 2048 chains
// an SM.
// ---------------------------------------------------------------------------
constexpr int kChainMaxCluster = 8;  // CTAs that stage one column block
constexpr int kChainPerThread = 2;   // chains a thread, interleaved

struct ChainArgs {
  int rows_tab, width, rows_out, cols, share, rounds, cluster;
  int vec;              // the block's rows are 16-byte aligned pieces
  uint32_t magic, c31;  // rows_tab's reciprocal; 2^31 mod rows_tab
  int sh1, sh2;         // the reciprocal's shifts
};

// jnp.remainder((int)s, rows_tab) of the wrapped int32 sum s
template <bool Pow2>
__device__ __forceinline__ int chain_mod(uint32_t s, const ChainArgs& a) {
  if constexpr (Pow2) {
    return (int)(s & (uint32_t)(a.rows_tab - 1));
  } else {
    const uint32_t u = s ^ 0x80000000u;  // s + 2^31, in [0, 2^32)
    const uint32_t t = __umulhi(a.magic, u);
    const uint32_t q = (t + ((u - t) >> a.sh1)) >> a.sh2;  // u / rows_tab
    const int r = (int)(u - q * (uint32_t)a.rows_tab) - (int)a.c31;
    return r < 0 ? r + a.rows_tab : r;
  }
}

template <bool Pow2>
__global__ void __launch_bounds__(kLaneThreads)
    lane_chain_kernel(const int* __restrict__ tab,
                      const int* __restrict__ idx, int* __restrict__ out,
                      const ChainArgs a) {
  extern __shared__ __align__(128) unsigned char chain_smem[];
  const int* staged = reinterpret_cast<const int*>(chain_smem);  // [t][cols]
  const uint32_t base = smem_addr(chain_smem);
  const int parts = gridDim.x / (a.width / a.cols);
  const int c0 = (int)blockIdx.x / parts * a.cols;
  const int r0 = min((int)blockIdx.x % parts * a.share, a.rows_out);
  const int chains = (min(r0 + a.share, a.rows_out) - r0) * a.cols;
  const int shift = __ffs(a.cols) - 1;
  const uint32_t rank = cluster_rank();
  const int* src = tab + c0;  // row t of the block at src + t * width
  cluster_sync();  // every CTA of the cluster runs before it is stored into
  if (a.vec) {
    for (int t = rank * blockDim.x + threadIdx.x; t < a.rows_tab;
         t += a.cluster * blockDim.x) {
      const int4 v =
          __ldg(reinterpret_cast<const int4*>(src + (long long)t * a.width));
      for (int r = 0; r < a.cluster; ++r)
        asm volatile(
            "st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                cluster_map(base + t * 16, r)),
            "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
            : "memory");
    }
  } else {
    for (int e = rank * blockDim.x + threadIdx.x; e < a.rows_tab * a.cols;
         e += a.cluster * blockDim.x) {
      const int v = src[(long long)(e >> shift) * a.width + (e & (a.cols - 1))];
      for (int r = 0; r < a.cluster; ++r)
        cluster_store(cluster_map(base + e * 4, r), v);
    }
  }
  // the CTA's chains, columns fastest: chain g + j * blockDim.x + thread
  constexpr int K = kChainPerThread;
  int cur[K], col[K];
  long long pos[K];
  auto load = [&](int g) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int ch = g + j * (int)blockDim.x + (int)threadIdx.x;
      col[j] = ch & (a.cols - 1);
      pos[j] = ch < chains
                   ? (long long)(r0 + (ch >> shift)) * a.width + c0 + col[j]
                   : -1;
      cur[j] = pos[j] >= 0 ? idx[pos[j]] : 0;
      if ((unsigned)cur[j] >= (unsigned)a.rows_tab) __trap();
    }
  };
  load(0);  // read while the block lands
  cluster_sync();  // every CTA's stores are visible
  for (int g = 0; g < chains; g += K * blockDim.x) {
    if (g > 0) load(g);
    for (int k = 0; k < a.rounds; ++k) {
      int v[K];
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = staged[(cur[j] << shift) + col[j]];
#pragma unroll
      for (int j = 0; j < K; ++j)
        cur[j] = chain_mod<Pow2>((uint32_t)cur[j] + (uint32_t)v[j] + 1u, a);
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (pos[j] >= 0) out[pos[j]] = cur[j];
  }
}

// ---------------------------------------------------------------------------
// G4 (P6): `rounds` dependent rounds idx = (idx + table[idx]) & (size - 1)
// over a flat int32 table, size a power of two, a chain a thread, on one of
// two paths (ops/probes.flat_plan):
//  - local: a table that fits a CTA's shared memory (up to 2^15 entries)
//    staged whole in each CTA by one bulk copy (cp.async.bulk completing on
//    an mbarrier; 4-byte loads for a view off 16 bytes), 256 threads a CTA,
//    more past 32 CTAs, since each CTA pays the staging;
//  - global: a larger table read where it lies (__ldg), 256 threads a CTA:
//    in the L2 up to 50 MB, in HBM past it.
// A sweep of plans on the H100 (its times are in PERF.md) set them.  At the
// timed 1 MiB table and 131,072 chains each 4-byte load of the global path
// takes a whole 32-byte L2 sector, ~0.87 us a round for 4 MiB of sectors:
// the L2's rate binds it.  The table spread over a cluster's shared memory
// (a slice a CTA, rounds by mapa and ld.shared::cluster) took 2.2-2.6 us a
// round there, 2.5x slower, and lost at every size the sweep tried; the
// local path beats the global one wherever the table fits.
// ---------------------------------------------------------------------------
template <bool Local>
__global__ void __launch_bounds__(kLaneThreads)
    flat_gather_chain_kernel(const int* __restrict__ idx, int n,
                             const int* __restrict__ table, int size,
                             int rounds, int* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char flat_smem[];
  const uint32_t bar = smem_addr(flat_smem);
  int* local = reinterpret_cast<int*>(flat_smem + 16);  // [size] int32
  bool bulk = false;
  if constexpr (Local) {
    bulk = size % 4 == 0 && ((unsigned long long)table & 15) == 0;
    if (bulk) {
      if (threadIdx.x == 0) bar_init(bar);
      __syncthreads();  // the barrier is set before anyone waits on it
      if (threadIdx.x == 0) {
        bar_expect(bar, size * 4);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(bar + 16),
            "l"(table), "r"(size * 4), "r"(bar)
            : "memory");
      }
    } else {
      for (int e = threadIdx.x; e < size; e += blockDim.x) local[e] = table[e];
    }
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned cur = i < n ? (unsigned)idx[i] : 0u;
  if (cur >= (unsigned)size) __trap();
  if constexpr (Local) {
    if (bulk)
      bar_wait(bar, 0);
    else
      __syncthreads();
  }
  const unsigned mask = (unsigned)size - 1u;
  for (int k = 0; k < rounds; ++k) {
    int v;
    if constexpr (Local)
      v = local[cur];
    else
      v = __ldg(table + cur);
    cur = (cur + (unsigned)v) & mask;
  }
  if (i < n) out[i] = (int)cur;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// A launch of `grid` CTAs of `threads` in clusters of `cluster` (1: none).
// A refused launch returns its error (and clears it).
template <typename... Params, typename... Args>
int launch_ex(void (*kernel)(Params...), long long grid, int threads,
              int smem, int cluster, void* stream, Args... args) {
  cudaError_t e = allow_smem(kernel, smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// Granlund and Montgomery's reciprocal of d (1 <= d < 2^31) for unsigned
// 32-bit division: u / d = (t + ((u - t) >> sh1)) >> sh2, t = umulhi(magic,
// u); and 2^31 mod d.
void chain_reciprocal(uint32_t d, ChainArgs& a) {
  int l = 0;
  while ((1ull << l) < d) ++l;  // ceil(log2 d)
  a.magic = (uint32_t)(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  a.sh1 = l < 1 ? l : 1;
  a.sh2 = l > 1 ? l - 1 : 0;
  a.c31 = (uint32_t)((1ull << 31) % d);
}

int launch_lane_chain(const void* tab, const void* idx, void* out,
                      int rows_tab, int width, int rows_out, int rounds,
                      int cols, int share, int threads, int cluster,
                      void* stream) {
  if (rows_tab < 1 || width < 1 || rows_out < 1 || rounds < 0 ||
      share < 1 || (cols != 1 && cols != 2 && cols != 4) || width % cols ||
      threads < 32 || threads > kLaneThreads || threads % 32 ||
      cluster < 1 || cluster > kChainMaxCluster || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  ChainArgs a = {};
  a.rows_tab = rows_tab;
  a.width = width;
  a.rows_out = rows_out;
  a.cols = cols;
  a.share = share;
  a.rounds = rounds;
  a.cluster = cluster;
  a.vec = cols == 4 && ((unsigned long long)tab & 15) == 0;
  chain_reciprocal((uint32_t)rows_tab, a);
  const long long smem = (long long)rows_tab * cols * 4;
  const long long parts =
      ((rows_out + share - 1LL) / share + cluster - 1) / cluster * cluster;
  const long long grid = parts * (width / cols);
  if (smem > kMaxSmemBytes || grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const int*, const int*, int*, ChainArgs);
  const Kernel kernel = (rows_tab & (rows_tab - 1)) == 0
                            ? lane_chain_kernel<true>
                            : lane_chain_kernel<false>;
  return launch_ex(kernel, grid, threads, (int)smem, cluster, stream,
                   (const int*)tab, (const int*)idx, (int*)out, a);
}

int launch_flat(const void* idx, int n, const void* table, int size,
                int rounds, void* out, int local, int threads,
                void* stream) {
  if (n < 1 || size < 1 || (size & (size - 1)) || rounds < 0 ||
      threads < 32 || threads > kLaneThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  const long long smem = local ? 16 + 4LL * size : 0;
  const long long grid = (n + threads - 1LL) / threads;
  if (smem > kMaxSmemBytes || grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const int*, int, const int*, int, int, int*);
  const Kernel kernel =
      local ? flat_gather_chain_kernel<true> : flat_gather_chain_kernel<false>;
  return launch_ex(kernel, grid, threads, (int)smem, 1, stream,
                   (const int*)idx, n, (const int*)table, size, rounds,
                   (int*)out);
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
  const bool vec =
      (((unsigned long long)x | (unsigned long long)out) & 15) == 0;
  const unsigned n4 = vec ? n / 4 : 0;
  const long long work = n4 > n - 4LL * n4 ? n4 : n - 4LL * n4;
  long long ctas = (work + kAffineThreads - 1) / kAffineThreads;
  if (ctas > kCardSms * kAffineCtasPerSm) ctas = kCardSms * kAffineCtasPerSm;
  affine_kernel<<<(unsigned)ctas, kAffineThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (unsigned)n, n4);
  return (int)cudaGetLastError();
}

// tab: [rows_tab, width] f32; idx, out: [rows_out, width] i32 / f32.  The
// plan (ops/probes.gather_plan): `cols` columns a thread (kGatherCols, or 1
// where the width is not a multiple), `threads` a CTA, `ctas` CTAs.  A view
// of idx or out off 16 bytes takes a column a thread on the same CTAs.
RT_API int rt_lane_gather(const void* tab, const void* idx, void* out,
                          int rows_tab, int width, int rows_out, int cols,
                          int threads, int ctas, void* stream) {
  if (rows_tab < 1 || width < 1 || rows_out < 1 ||
      (cols != 1 && cols != kGatherCols) || width % cols || threads < 1 ||
      threads > kLaneThreads || ctas < 1 ||
      (long long)ctas * threads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool vec = cols == kGatherCols &&
                   (((unsigned long long)idx | (unsigned long long)out) &
                    15) == 0;
  const int c = vec ? kGatherCols : 1;
  GatherArgs a = {};
  a.rows_tab = rows_tab;
  a.width = width;
  a.rows_out = rows_out;
  a.pieces = width / c;
  const long long stride = (long long)ctas * threads;
  a.drow = (int)(stride / a.pieces);
  a.dpiece = (int)(stride - (long long)a.drow * a.pieces);
  using Kernel = void (*)(const float*, const int*, float*, GatherArgs);
  const Kernel kernel =
      vec ? lane_gather_kernel<kGatherCols> : lane_gather_kernel<1>;
  kernel<<<ctas, threads, 0, (cudaStream_t)stream>>>(
      (const float*)tab, (const int*)idx, (float*)out, a);
  return (int)cudaGetLastError();
}

// tab: [rows_tab, width] i32; idx, out: [rows_out, width] i32.  The plan
// (ops/probes.chain_plan): column blocks of `cols`, `share` output rows a
// CTA, `threads` a CTA with kChainPerThread chains each, in clusters of
// `cluster` CTAs that stage a block into each other's shared memory.
RT_API int rt_lane_gather_chain(const void* tab, const void* idx, void* out,
                                int rows_tab, int width, int rows_out,
                                int rounds, int cols, int share, int threads,
                                int cluster, void* stream) {
  return launch_lane_chain(tab, idx, out, rows_tab, width, rows_out, rounds,
                           cols, share, threads, cluster, stream);
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

// idx, out: [n] i32; table: [size] i32, size a power of two.  The plan
// (ops/probes.flat_plan): the table staged in each CTA's shared memory if
// `local`, else read where it lies; `threads` a CTA, a chain a thread.
RT_API int rt_flat_gather_chain(const void* idx, int n, const void* table,
                                int size, int rounds, void* out, int local,
                                int threads, void* stream) {
  return launch_flat(idx, n, table, size, rounds, out, local, threads,
                     stream);
}
