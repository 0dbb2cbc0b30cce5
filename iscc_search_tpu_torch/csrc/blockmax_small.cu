// Phase 1 of the exact NPHD scan for small batches (Q of about 4-128) on
// Hopper's int8 tensor cores: per-128-row block maxima of each query's score
// over one code-length partition, with each row's bits unpacked in registers
// straight into the MMA's A operand.
//
// Replaces, for small batches, what the Pallas TPU kernels _scan_kernel_bitplane
// (128/256-bit partitions) and _scan_kernel_unpacked_perm (64/192-bit) of
// iscc_search_tpu/ops/pallas_scan.py compute, reached through pallas_blockmax.
// It computes the function of blockmax.cu bit for bit, from the same compact
// packed partition (cap, lanes): exact int32 ±1 dots over each query's
// common-prefix lanes, an invalid row contributes dot - 65536, the maximum m
// of a 128-row block becomes __fmaf_rn((float)m, q_scale, 0.5f).
//
// Why a third phase-1 kernel: blockmax.cu issues `lanes` XOR/AND/POPC per
// (query, row) pair, and POPC issues at 16 per clock per SM, so its time
// grows with Q from the byte bound at Q=1; the wgmma kernel of
// blockmax_mma.cu pays ~1,500 clocks per 128-row block for barriers, staging
// the unpacked rows in shared memory and its flush, which keeps it flat at
// Q <= 128. Between them, Q of about 8-128 read 15-41% of the bound.
//
// Design (ops/small_layout.py mirrors the maps below; tests/
// test_torch_small_layout.py runs this flow lane by lane in numpy):
//   - Rows are the M side of mma.sync.m16n8k32.s8 and queries its N side:
//     a chunk of up to 128 queries is NT n-tiles of 8 (NT from the batch,
//     padded with zero queries), and a warp owns whole 128-row blocks (eight
//     16-row m-tiles), so a block's maximum never leaves the warp: registers
//     over the m-tiles, then __shfl_xor_sync over the 8 row groups of the C
//     fragment. No barrier per block.
//   - The 32 bits of one packed word are one MMA k-step, in an order that
//     makes an A register of lane (g, t) one AND: k = 4t + j is bit 2t + 8j
//     and k = 16 + 4t + j is bit 2t + 1 + 8j (PTX's m16n8k32 s8 A map:
//     registers 0 / 1 hold k 4t .. 4t + 3, 2 / 3 k 16 + 4t ..), so the
//     registers are word & (0x01010101 << 2t) and
//     (word >> 1) & (0x01010101 << 2t): bytes 0 or 2^2t, three integer
//     instructions per row word and lane. The queries' B bytes are ±2^(6-2t)
//     (zero past min_lanes), so every product is 64 * x * q with x the 0/1
//     row bit and q the ±1 query bit, and
//       dot_pm1 = 2 * sum_k q_k x_k - sum_k q_k = C / 32 - S,
//     S = sum_k q_k one int per query: exact in int32, and the block maximum
//     of dot_pm1 is the maximum of C over 32 minus S. The B fragments are
//     built once per thread block into shared memory, in fragment order
//     (one 8-byte load per lane and MMA pair, conflict-free). A k-step never
//     crosses a word, so the prefix mask, which covers whole words, stays
//     exact.
//   - From 33 queries (8 n-tiles) on, the same A registers feed wgmma in its
//     RS form (m64nNk32, N = 64, 96 or 128: A from the registers of the
//     warpgroup's four warps, 16 rows each, in the m16n8k32 fragment; B, the
//     queries, from shared memory as K-major core matrices), which runs at
//     twice mma.sync's rate. Each warp still owns its blocks: the rows of a
//     wgmma are four warps' m-tiles of four different blocks, and a warp's
//     part of the accumulator is its own rows. The warps of a thread block
//     take the same number of steps (a warp past its share repeats its last
//     block and writes nothing), so every branch around a wgmma is the same
//     for the whole block and ptxas does not serialize them; the next
//     m-tile's A registers are unpacked while a step's wgmmas run.
//   - Validity costs the MMAs nothing: an invalid row's words are read from
//     the block's first valid row instead (a row twice does not change the
//     maximum); a block without a valid row keeps its rows and the penalty
//     comes off its maximum.
//   - Rows stream asynchronously: each warp keeps its own ring of kRing
//     block-sized stages in flight with cp.async.bulk (TMA's 1-D copy of the
//     block's 512 * lanes contiguous bytes and its 128 validity bytes),
//     completing on an mbarrier per stage; the warp's lane 0 asks for block
//     j + kRing as soon as the warp is done with block j's stage. (One
//     producer thread for all warps caps the stream at ~340 clocks per
//     block per SM, whatever the width: PERF.md, section 6.)
//     The four lanes of a quad read the same row words: broadcast loads.
//   - Persistent grid: as many thread blocks of eight warps as fit on the
//     SMs (two per SM up to 64 queries), each warp a contiguous share of the
//     blocks (shares differ by at most one block). A batch above 128 queries
//     is 128-query chunks along grid.y.
//   - Output: each warp gathers eight consecutive blocks' maxima per query in
//     shared memory and writes them as whole 32-byte sectors of the
//     (nq, nblocks) output.
//
// What bounds it on an H100 (experiments/exp_small_ablate.py times it with
// parts cut out; PERF.md, section 6): not the bytes, which the per-warp TMA
// rings stream at ~90% of the memory rate; the compute. Up to 32 queries the
// integer instructions of the unpack and the mma.sync chains (about 60% of
// the byte bound); from 33 queries on the wgmma steps, each a chain of
// `lanes` dependent wgmmas per m-tile, at about half the int8 peak.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// Timing cuts (experiments/exp_small_ablate.py): ISCC_SMALL_ABLATE, defined
// only in a build of that script's own, is a mask of parts to leave out so
// that what is left can be timed. 0, the library's build, leaves nothing
// out; any other value computes something else than block maxima.
#ifndef ISCC_SMALL_ABLATE
#define ISCC_SMALL_ABLATE 0
#endif
constexpr bool kCutCompute = ISCC_SMALL_ABLATE & 1;  // no unpack, MMA or maxima: the stages are only waited for
constexpr bool kCutValid = ISCC_SMALL_ABLATE & 2;    // the validity bytes are not copied
constexpr bool kCutFlush = ISCC_SMALL_ABLATE & 4;    // the gathered maxima are never written
constexpr bool kCutStream = ISCC_SMALL_ABLATE & 8;   // no copy is made or waited for: compute on the ring as it is

constexpr int kBlockRows = 128;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQueries = 128;                      // queries per chunk: 16 n-tiles of 8
constexpr int kOutBlocks = 8;                         // blocks gathered per 32-byte output sector
constexpr int kOutStride = kOutBlocks + 1;            // floats per query in the gather: odd, so writers' banks differ
constexpr int kInvalidPenalty = 65536;
constexpr uint32_t kByteBits = 0x01010101u;
constexpr int kWgmmaTiles = 8;  // from this many n-tiles (33 queries) on, wgmma; below, mma.sync

// Block-sized stages in each warp's ring: about 8 KB per warp, two to eight
// stages.
template <int LANES>
__host__ __device__ constexpr int ring_stages() {
  return 16 / LANES < 2 ? 2 : (16 / LANES > 8 ? 8 : 16 / LANES);
}

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// Thread blocks per SM: two up to 64 queries (eight warps per scheduler to
// hide the latencies of loads and MMA chains), else one (registers).
template <int NT>
__host__ __device__ constexpr int ctas_per_sm() { return NT <= 8 ? 2 : 1; }

// Dynamic shared memory: the stages' barriers, the stages' rows and validity
// bytes, the chunk's query fragments, its query sums and scales, and each
// warp's gather of maxima.
template <int LANES, int NT>
struct Smem {
  static constexpr int kRing = ring_stages<LANES>();
  static constexpr int kStages = kWarps * kRing;
  static constexpr int kRowBytes = kBlockRows * LANES * 4;
  static constexpr int kQueries = NT * 8;
  static constexpr int kRows = align128(kStages * 8);
  static constexpr int kValid = kRows + kStages * kRowBytes;
  static constexpr int kFrag = kValid + kStages * kBlockRows;
  static constexpr int kSum = kFrag + LANES * NT * 32 * 8;
  static constexpr int kScale = kSum + kQueries * 4;
  static constexpr int kGather = kScale + kQueries * 4;
  static constexpr int kBytes = kGather + kWarps * kQueries * kOutStride * 4;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA's 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Four bytes of +2^e or -2^e (e <= 6) from four bytes of 1 or 0:
// 2^(e+1) * b - 2^e per byte, each byte apart (__vsub4 borrows across no
// byte), so -2^e comes out as its two's complement.
__device__ __forceinline__ uint32_t signed_bytes(uint32_t bits01, int e) {
  return __vsub4(bits01 << (e + 1), kByteBits << e);
}

// d (16 x 8 int32) = a (16 x 32 s8) x b (32 x 8 s8) + c, in PTX's
// m16n8k32 s8 fragments (lane 4 g + t): A registers 0 / 1 hold k 4t .. 4t +
// 3 of rows g / g + 8, 2 / 3 k 16 + 4t ..; B registers 0 / 1 the same k of
// column g; C registers 0 / 1 row g, columns 2t and 2t + 1, 2 / 3 row g + 8.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint2 b, const int (&c)[4]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y), "r"(c[0]), "r"(c[1]), "r"(c[2]),
        "r"(c[3]));
}

// wgmma (the RS form, from 32 rows up per batch): D (64 x 8 NT int32) +=
// A (64 x 32 s8, registers: 16 rows of each warp of the warpgroup, the
// m16n8k32 A fragment) x B (8 NT x 32 s8, shared memory, K-major core
// matrices)^T, for NT of 8, 12 and 16.
template <int NT>
struct Wgmma;
#define ISCC_SMALL_ACC8(d, i)                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])
#define ISCC_SMALL_ACC32(d) ISCC_SMALL_ACC8(d, 0), ISCC_SMALL_ACC8(d, 8), ISCC_SMALL_ACC8(d, 16), ISCC_SMALL_ACC8(d, 24)
#define ISCC_SMALL_ACC48(d) ISCC_SMALL_ACC32(d), ISCC_SMALL_ACC8(d, 32), ISCC_SMALL_ACC8(d, 40)
#define ISCC_SMALL_ACC64(d) ISCC_SMALL_ACC48(d), ISCC_SMALL_ACC8(d, 48), ISCC_SMALL_ACC8(d, 56)

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n"
        "}\n"
        : ISCC_SMALL_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
  // Keeps the compiler from reading or moving the accumulators across the
  // wait that completes their wgmmas.
  static __device__ __forceinline__ void fence(int (&d)[32]) { asm volatile("" : ISCC_SMALL_ACC32(d)::"memory"); }
};

template <>
struct Wgmma<12> {
  static __device__ __forceinline__ void mma(int (&d)[48], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p;\n"
        "}\n"
        : ISCC_SMALL_ACC48(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
  // Keeps the compiler from reading or moving the accumulators across the
  // wait that completes their wgmmas.
  static __device__ __forceinline__ void fence(int (&d)[48]) { asm volatile("" : ISCC_SMALL_ACC48(d)::"memory"); }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(int (&d)[64], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n"
        "}\n"
        : ISCC_SMALL_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
  // Keeps the compiler from reading or moving the accumulators across the
  // wait that completes their wgmmas.
  static __device__ __forceinline__ void fence(int (&d)[64]) { asm volatile("" : ISCC_SMALL_ACC64(d)::"memory"); }
};

// The 64-bit shared-memory matrix descriptor of wgmma, no-swizzle layout:
// start address, leading (k-chunk) and stride (8-row group) byte offsets,
// each in 16-byte units (ops/wgmma_layout.py).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// One row's LANES words from shared memory, in the widest loads they allow.
template <int LANES>
__device__ __forceinline__ void load_row(const uint32_t* row, uint32_t (&w)[LANES]) {
  if constexpr (LANES % 4 == 0) {
#pragma unroll
    for (int i = 0; i < LANES; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + i);
      w[i] = v.x, w[i + 1] = v.y, w[i + 2] = v.z, w[i + 3] = v.w;
    }
  } else if constexpr (LANES % 2 == 0) {
#pragma unroll
    for (int i = 0; i < LANES; i += 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + i);
      w[i] = v.x, w[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < LANES; ++i) w[i] = row[i];
  }
}

// The first block of warp `w` of thread block `cta` (w may be kWarps: the
// end of the share): a contiguous split of all blocks over all warps of the
// grid.
__device__ __forceinline__ int share_begin(int cta, int w, int ctas, int nblocks) {
  return (int)(((int64_t)cta * kWarps + w) * nblocks / ((int64_t)ctas * kWarps));
}

template <int LANES, int NT>
__global__ void __launch_bounds__(kThreads, ctas_per_sm<NT>())
blockmax_small_kernel(const int32_t* __restrict__ q, int q_stride, const int32_t* __restrict__ min_lanes,
                      const float* __restrict__ q_scale, int nq, const uint32_t* __restrict__ db,
                      const uint8_t* __restrict__ valid, int nblocks, float* __restrict__ out) {
  using S = Smem<LANES, NT>;
  constexpr int kRing = S::kRing;
  constexpr int kQueries = S::kQueries;
  constexpr bool kWgmma = NT >= kWgmmaTiles;
  // Two sets of A registers where the registers allow it (one thread block
  // per SM, or few lanes).
  constexpr bool kUnpackAhead = ctas_per_sm<NT>() == 1 || LANES <= 4;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint2* frag = reinterpret_cast<const uint2*>(smem + S::kFrag);
  const int* qsum = reinterpret_cast<const int*>(smem + S::kSum);
  const float* qscale = reinterpret_cast<const float*>(smem + S::kScale);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.y * kQueries;  // this chunk's first query
  const int nc = min(kQueries, nq - q0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) mbar_init(base + 8u * s, 1);  // lane 0's arrive, plus the copies' bytes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The chunk's B operand: for query qi and k-step ks, the four bytes of
  // k-positions 4t..4t+3 (h = 0) or 16+4t..16+4t+3 (h = 1) are ±2^(6-2t)
  // from bits 2t + h + 8j of word ks; zero past min_lanes and past the
  // chunk's queries. mma.sync reads them in fragment order (uint2 (ks * NT
  // + n) * 32 + lane: h = 0, 1 of lane (g, t)'s query 8n + g); wgmma from
  // K-major core matrices: k-chunk 2 ks + h is a panel of the 8 NT queries,
  // 16 bytes each, eight to a 128-byte core matrix (ops/small_layout.py).
  uint32_t* b_w = reinterpret_cast<uint32_t*>(smem + S::kFrag);
  for (int i = threadIdx.x; i < LANES * NT * 8 * 8; i += kThreads) {
    const int k4 = i & 7, qi = (i >> 3) % kQueries, ks = (i >> 3) / kQueries;
    const int lt = k4 & 3, h = k4 >> 2;
    uint32_t b = 0u;
    if (qi < nc && ks < min(max(min_lanes[q0 + qi], 0), LANES)) {
      const uint32_t w = (uint32_t)q[(int64_t)(q0 + qi) * q_stride + ks];
      b = signed_bytes((w >> (2 * lt + h)) & kByteBits, 6 - 2 * lt);
    }
    const int at = kWgmma ? (2 * ks + h) * kQueries * 4 + (qi >> 3) * 32 + (qi & 7) * 4 + lt
                          : ((ks * NT + (qi >> 3)) * 32 + (qi & 7) * 4 + lt) * 2 + h;
    b_w[at] = b;
  }
  if (kWgmma) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
  // sum_k q_k over the prefix (set bits - clear bits) and the scale, per query.
  for (int i = threadIdx.x; i < kQueries; i += kThreads) {
    int sum = 0;
    float scale = 0.f;
    if (i < nc) {
      const int ml = min(max(min_lanes[q0 + i], 0), LANES);
      for (int ks = 0; ks < ml; ++ks) sum += 2 * __popc((uint32_t)q[(int64_t)(q0 + i) * q_stride + ks]) - 32;
      scale = q_scale[q0 + i];
    }
    reinterpret_cast<int*>(smem + S::kSum)[i] = sum;
    reinterpret_cast<float*>(smem + S::kScale)[i] = scale;
  }
  __syncthreads();

  // This warp's share of blocks, one after another, each from stage j % kRing
  // of the warp's ring.
  const int b_first = share_begin(blockIdx.x, warp, gridDim.x, nblocks);
  const int b_end = share_begin(blockIdx.x, warp + 1, gridDim.x, nblocks);
  auto stage_of = [&](int j) { return warp * kRing + j % kRing; };
  auto ask = [&](int j) {  // lane 0: block b_first + j into its stage
    if (kCutStream) return;
    const int s = stage_of(j);
    const int64_t block = b_first + j;
    mbar_expect_tx(base + 8u * s, S::kRowBytes + (kCutValid ? 0 : kBlockRows));
    bulk_copy(base + S::kRows + s * S::kRowBytes, db + block * kBlockRows * LANES, S::kRowBytes, base + 8u * s);
    if (!kCutValid) bulk_copy(base + S::kValid + s * kBlockRows, valid + block * kBlockRows, kBlockRows, base + 8u * s);
  };
  if (lane == 0) {
    for (int j = 0; j < kRing && b_first + j < b_end; ++j) ask(j);
  }
  const uint32_t bits = kByteBits << 2 * t;  // this lane's bit of each byte: 2t (and 2t + 1 after a shift)
  // Few queries: the B fragments stay in registers for the whole kernel, and
  // four m-tiles go per step (more MMA chains in flight); else two m-tiles
  // per step, fragments from shared memory.
  constexpr bool kFragInRegs = NT * LANES <= 16;
  constexpr int kMtiles = NT <= 2 && LANES <= 4 ? 4 : 2;
  uint2 breg[LANES][NT];
  if constexpr (kFragInRegs) {
#pragma unroll
    for (int ks = 0; ks < LANES; ++ks) {
#pragma unroll
      for (int n = 0; n < NT; ++n) breg[ks][n] = frag[(ks * NT + n) * 32 + lane];
    }
  }
  float* gather = reinterpret_cast<float*>(smem + S::kGather) + warp * kQueries * kOutStride;
  // wgmma is one instruction of a warpgroup's four warps: with it, every
  // warp takes the most steps any warp of the thread block has (shares
  // differ by one at most; a number the compiler sees to be the same for all
  // the block's threads, as a branch around a wgmma must be, or the wgmmas
  // are serialized); a warp past its share recomputes its last block, or
  // garbage if it has none, and writes nothing.
  const int count = b_end - b_first;
  int steps = count;
  if constexpr (kWgmma) {
    steps = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      steps = max(steps, share_begin(blockIdx.x, w + 1, gridDim.x, nblocks) -
                             share_begin(blockIdx.x, w, gridDim.x, nblocks));
    }
  }
  const uint32_t b_addr = base + S::kFrag;
  constexpr uint32_t kLbo = kQueries * 16;  // bytes between the B operand's k-chunks
  for (int j = 0; j < steps; ++j) {
    const bool real = j < count;
    const int jj = real ? j : max(count - 1, 0);
    const int block = b_first + jj;
    const int s = stage_of(jj);
    if (!kCutStream && real) mbar_wait(base + 8u * s, (uint32_t)(j / kRing) & 1u);
    const uint32_t* rows = reinterpret_cast<const uint32_t*>(smem + S::kRows + s * S::kRowBytes);
    const uint8_t* vb = smem + S::kValid + s * kBlockRows;

    // The block's first valid row (four validity bytes per lane, a ballot).
    const uint32_t vword = *reinterpret_cast<const uint32_t*>(vb + 4 * lane);
    const uint32_t with_valid = __ballot_sync(0xffffffffu, vword != 0u);
    const bool none_valid = with_valid == 0u;
    const int first_lane = none_valid ? 0 : __ffs(with_valid) - 1;
    const uint32_t first_word = __shfl_sync(0xffffffffu, vword, first_lane);
    const int first_valid = none_valid ? 0 : 4 * first_lane + (__ffs(first_word) - 1) / 8;

    // mx[n][h]: the maximum of C (64 x the 0/1-by-±1 sum) over this lane's
    // rows (row groups g and g + 8 of every m-tile) for query 8n + 2t + h.
    int mx[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) mx[n][0] = mx[n][1] = INT_MIN;
    if constexpr (kWgmma) {
      // One 16-row m-tile of each warp per step of the warpgroup: the k-steps'
      // wgmmas into one accumulator, awaited before the maxima read it; where
      // registers allow, the next m-tile's A registers are unpacked while
      // they run.
      auto unpack = [&](int m, uint32_t (&a)[LANES][4]) {
        const int r0 = 16 * m + g, r1 = r0 + 8;
        const int s0 = (none_valid || vb[r0]) ? r0 : first_valid;
        const int s1 = (none_valid || vb[r1]) ? r1 : first_valid;
        uint32_t w0[LANES], w1[LANES];
        load_row<LANES>(rows + s0 * LANES, w0);
        load_row<LANES>(rows + s1 * LANES, w1);
#pragma unroll
        for (int ks = 0; ks < LANES; ++ks) {
          a[ks][0] = w0[ks] & bits;
          a[ks][1] = w1[ks] & bits;
          a[ks][2] = (w0[ks] >> 1) & bits;
          a[ks][3] = (w1[ks] >> 1) & bits;
        }
      };
      auto step = [&](int m, uint32_t (&a)[LANES][4], uint32_t (&a_next)[LANES][4], bool ahead) {
        int acc[NT * 4];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < LANES; ++ks) {
          Wgmma<NT>::mma(acc, a[ks], smem_desc(b_addr + 2 * ks * kLbo, kLbo, 128), ks > 0);
        }
        wgmma_commit();
        if (ahead && m + 1 < kBlockRows / 16) unpack(m + 1, a_next);
        wgmma_wait0();
        Wgmma<NT>::fence(acc);
        // The wgmmas read A from these registers until the wait: nothing
        // may take them over before it.
#pragma unroll
        for (int ks = 0; ks < LANES; ++ks) {
          asm volatile("" : "+r"(a[ks][0]), "+r"(a[ks][1]), "+r"(a[ks][2]), "+r"(a[ks][3])::"memory");
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mx[n][0] = max(mx[n][0], max(acc[4 * n], acc[4 * n + 2]));
          mx[n][1] = max(mx[n][1], max(acc[4 * n + 1], acc[4 * n + 3]));
        }
      };
      uint32_t a0[LANES][4], a1[LANES][4];
      if constexpr (kUnpackAhead) {
        if (!kCutCompute) unpack(0, a0);
#pragma unroll 1
        for (int m = 0; m < (kCutCompute ? 0 : kBlockRows / 16); m += 2) {
          step(m, a0, a1, true);
          step(m + 1, a1, a0, true);
        }
      } else {
#pragma unroll 1
        for (int m = 0; m < (kCutCompute ? 0 : kBlockRows / 16); ++m) {
          unpack(m, a0);
          step(m, a0, a0, false);
        }
      }
    } else {
#pragma unroll 1
      for (int p = 0; p < (kCutCompute ? 0 : kBlockRows / 16 / kMtiles); ++p) {  // kMtiles 16-row m-tiles per step
        uint32_t a[kMtiles][LANES][4];
#pragma unroll
        for (int mt = 0; mt < kMtiles; ++mt) {
          const int r0 = 16 * (kMtiles * p + mt) + g, r1 = r0 + 8;
          const int s0 = (none_valid || vb[r0]) ? r0 : first_valid;
          const int s1 = (none_valid || vb[r1]) ? r1 : first_valid;
          uint32_t w0[LANES], w1[LANES];
          load_row<LANES>(rows + s0 * LANES, w0);
          load_row<LANES>(rows + s1 * LANES, w1);
#pragma unroll
          for (int ks = 0; ks < LANES; ++ks) {
            a[mt][ks][0] = w0[ks] & bits;
            a[mt][ks][1] = w1[ks] & bits;
            a[mt][ks][2] = (w0[ks] >> 1) & bits;
            a[mt][ks][3] = (w1[ks] >> 1) & bits;
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          int c[kMtiles][4] = {};
#pragma unroll
          for (int ks = 0; ks < LANES; ++ks) {
            uint2 b;
            if constexpr (kFragInRegs) {
              b = breg[ks][n];
            } else {
              b = frag[(ks * NT + n) * 32 + lane];
            }
#pragma unroll
            for (int mt = 0; mt < kMtiles; ++mt) mma_s8(c[mt], a[mt][ks], b, c[mt]);
          }
#pragma unroll
          for (int mt = 0; mt < kMtiles; ++mt) {
            mx[n][0] = max(mx[n][0], max(c[mt][0], c[mt][2]));
            mx[n][1] = max(mx[n][1], max(c[mt][1], c[mt][3]));
          }
        }
      }
    }

    // The maxima over the 8 row groups, then the scores of queries 8n + 2t
    // + h by the lanes of row group 0, into slot block % 8 of the gather.
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v = mx[n][h];
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 4));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 8));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 16));
        mx[n][h] = v;
      }
    }
    // Every lane is done with the stage (the maxima above wait for all its
    // loads): lane 0 asks for the block that comes into it next.
    __syncwarp();
    if (!real) continue;
    if (lane == 0 && b_first + j + kRing < b_end) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      ask(j + kRing);
    }
    const int slot = block % kOutBlocks;
    if (g == 0) {
      const int penalty = none_valid ? kInvalidPenalty : 0;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qi = 8 * n + 2 * t + h;
          const int m = (mx[n][h] >> 5) - qsum[qi] - penalty;
          gather[qi * kOutStride + slot] = __fmaf_rn((float)m, qscale[qi], 0.5f);
        }
      }
    }
    if (!kCutFlush && (slot == kOutBlocks - 1 || block + 1 == b_end)) {
      // Blocks [sector + lo, block] leave: eight lanes write one query's
      // eight maxima, a whole sector where the query's row starts on one.
      __syncwarp();
      const int sector = block - slot;
      const int lo = max(b_first, sector) - sector;
      float* dst = out + (int64_t)q0 * nblocks + sector;
      for (int i = lane; i < nc * kOutBlocks; i += 32) {
        const int qi = i / kOutBlocks, k = i % kOutBlocks;
        if (k >= lo && k <= slot) dst[(int64_t)qi * nblocks + k] = gather[qi * kOutStride + k];
      }
      __syncwarp();
    }
  }
}

template <int LANES, int NT>
int launch_nt(const int32_t* q, int q_stride, const int32_t* min_lanes, const float* q_scale, int nq,
              const uint32_t* db, const uint8_t* valid, int nblocks, float* out, cudaStream_t stream) {
  using S = Smem<LANES, NT>;
  auto kernel = blockmax_small_kernel<LANES, NT>;
  int device = 0, sm_count = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(min(ctas_per_sm<NT>() * sm_count, (nblocks + kWarps - 1) / kWarps),
                  (nq + S::kQueries - 1) / S::kQueries);
  kernel<<<grid, kThreads, S::kBytes, stream>>>(q, q_stride, min_lanes, q_scale, nq, db, valid, nblocks, out);
  return (int)cudaGetLastError();
}

// NT, the n-tiles of a chunk: the batch's, rounded up to 1, 2, 4, 8, 12 or
// 16 (a batch above 128 queries goes in chunks of 128).
template <int LANES>
int launch_lanes(const int32_t* q, int q_stride, const int32_t* min_lanes, const float* q_scale, int nq,
                 const uint32_t* db, const uint8_t* valid, int nblocks, float* out, cudaStream_t stream) {
  const int tiles = (min(nq, kMaxQueries) + 7) / 8;
#define ISCC_SMALL_NT(N) \
  if (tiles <= N) return launch_nt<LANES, N>(q, q_stride, min_lanes, q_scale, nq, db, valid, nblocks, out, stream);
  ISCC_SMALL_NT(1)
  ISCC_SMALL_NT(2)
  ISCC_SMALL_NT(4)
  ISCC_SMALL_NT(8)
  ISCC_SMALL_NT(12)
#undef ISCC_SMALL_NT
  return launch_nt<LANES, 16>(q, q_stride, min_lanes, q_scale, nq, db, valid, nblocks, out, stream);
}

}  // namespace

// out (nq, nblocks) f32 <- block maxima of the (cap = 128 * nblocks, lanes)
// packed partition db (16-byte aligned, as valid) against the (nq, q_stride)
// packed queries q, as iscc_blockmax. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int iscc_blockmax_small(const void* q, int q_stride, const void* min_lanes, const void* q_scale, int nq,
                                   const void* db, const void* valid, int nblocks, int lanes, void* out,
                                   void* stream) {
  if (nq <= 0 || nblocks <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(db) % 16 || reinterpret_cast<uintptr_t>(valid) % 16) {
    return (int)cudaErrorMisalignedAddress;
  }
  const auto* qp = static_cast<const int32_t*>(q);
  const auto* ml = static_cast<const int32_t*>(min_lanes);
  const auto* qs = static_cast<const float*>(q_scale);
  const auto* dbp = static_cast<const uint32_t*>(db);
  const auto* vp = static_cast<const uint8_t*>(valid);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define ISCC_SMALL_CASE(L) \
  case L: return launch_lanes<L>(qp, q_stride, ml, qs, nq, dbp, vp, nblocks, op, s);
  switch (lanes) {
    ISCC_SMALL_CASE(1)
    ISCC_SMALL_CASE(2)
    ISCC_SMALL_CASE(3)
    ISCC_SMALL_CASE(4)
    ISCC_SMALL_CASE(5)
    ISCC_SMALL_CASE(6)
    ISCC_SMALL_CASE(7)
    ISCC_SMALL_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ISCC_SMALL_CASE
}
