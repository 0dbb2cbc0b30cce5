// Phase 1 of the NPHD scan from bit-plane twins on Hopper's int8 tensor
// cores: 0/1 int8 planes of 256-bit rows dotted with the ±1/0 int8 queries,
// dot_pm1 = 2 * dot01 - sum(q).
//
// Replaces two Pallas TPU kernels of benchmarks/ with one kernel, templated
// on the twin's element width W and on the epilogue:
//   - exp_bitplane_int8.py _kernel_variant (:53; make_variant :105,
//     pallas_call :118), all of its modes: entry iscc_blockmax_bitplane
//     reads the bit_transpose_packed twin (W = 32) with the script's bf16
//     epilogue, x = bf16(bf16(2 * dot01 - qsum) + pen_bf16), block max,
//     __fmaf_rn(m, qs, 0.5);
//   - exp_bitplane_u8.py _kernel (:123; blockmax_subword_impl :152,
//     pallas_call :167): entry iscc_blockmax_subword reads the build_twin
//     sub-word twins (W = 8 or 16) with the script's int32 epilogue,
//     x = dot01 + pen_i32, block max m, then __fmaf_rn((float)(2m - qsum),
//     qs, 0.5), equal to blockmax.cu for 0 / -32768 penalties.
// The penalty row is in the twin's dot-column order (bitplane_penalty_perm
// / penalty_perm of ops/bitplane.py); the output is in original block
// order.
//
// Layout (ops/bitplane.py): per 4096-row group, element (256 b + u, j) of
// the (32 / W * 256, 128) view holds at bit s bit u of original row
// j0 * 128 + r, r = s * (128 / W) + 4 b + j1 (j = 32 j1 + j0). So block j0
// of a group is view columns j0, 32 + j0, 64 + j0, 96 + j0 of the group's
// view rows. With s' = s * (32 / W) + b, r = 4 s' + j1 at every W, and the
// penalty of row r sits at (r >> 2) * 128 + (r & 3) * 32 + j0 of the group.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// experiments/bitplane_layout.py mirrors this flow in numpy.
//
// Shape: one persistent launch per chunk of up to 256 queries, of
// min(slices, SMs) thread blocks of five warpgroups: a producer and four
// consumers. The queries wait in shared memory as wgmma's A operand
// (K-major core matrices, as in blockmax_variants.cu), loaded once per
// thread block. The unit of work is a slice: consecutive blocks j0 of one
// group, the twin's columns of those j0 in each band j1 over the group's
// view rows, which TMA lands as one 4-d box (j0, j1, u, b; j0 innermost)
// on an mbarrier. TMA wants 16 bytes or more innermost, so a slice is 8
// blocks at W = 32 and 16 (32 KiB, two in flight) and 16 blocks at W = 8
// (64 KiB, one in flight: two do not fit beside the queries). Each thread
// block takes a contiguous share of slices; every twin byte leaves device
// memory once per launch.
//   - The producer warpgroup holds four blocks of a slice in registers at a
//     time: per band b and each of its eight K bytes, the 16, 8 or 4 bytes
//     of those blocks (W = 32, 16, 8), 32 registers at every W. A thread
//     owns band j1 = lane % 4 and eight K bytes; below W = 32 K byte k holds
//     bit u = k ^ ((k >> 3) & 1) (the queries are permuted alike), which
//     spreads a warp's loads over twice the banks. Each warp plans two
//     blocks of every 8 (below) into a table in shared memory, which a
//     barrier of the warpgroup publishes. Each four loaded words of one
//     band and word position (K bytes k .. k + 3) become P_n = byte n of
//     each by eight PRMTs, in place; the word of row 4 s' + j1 at those K
//     bytes is (P_n >> m) & 0x01010101 (n, m from s' and the block's place
//     in its word), two operations, into one of two row tiles (128 rows x
//     256 int8, two atoms in wgmma's 128-byte swizzle): one 8-byte store per
//     row, a half-warp filling every bank once. It signals the tile's full
//     mbarrier after fence.proxy.async. Once the slice's last hold is read,
//     a proxy fence and a barrier free it for the next TMA (without the
//     fence, TMA's writes overtake the reads); at W = 8 the refill lands
//     while the last four blocks are stored.
//   - The penalty, once per block: y = 2 dot01 - qsum lies in [-256, 256],
//     and both epilogues are non-decreasing in y, so where every penalty of
//     the block is (finite and) either the largest, pmax, or at most pmax -
//     512, a dominated row can never hold the maximum. The planning warp
//     reads the block's penalties (lane l the rows 4l .. 4l + 3, a slice
//     ahead) and finds pmax, the rule, the dominated rows of each band and
//     the first row at pmax with shuffles and ballots, two blocks' chains
//     interleaved. After a block's rows are stored, each thread stores its
//     band's dominated rows again as copies of that row (its words shuffled
//     in from the lane of the same K bytes whose band holds it). Such a
//     block takes the fast path: the integer maximum of the accumulators
//     (Hopper's three-way integer maximum), then one element per query. Any
//     other block keeps its rows and takes the per-element path: bf16, the
//     maximum of the f32 sums y + p rounded to bf16 once (rounding is
//     monotone); int32, the maximum of dot01 + p.
//   - Each consumer warpgroup takes one 64-query tile of every block
//     (m64n128k32 s8, eight k-steps), waits, runs the epilogue, and frees the
//     row tile on its empty mbarrier. They issue their wgmmas in turns round
//     a ring (hardware barriers), so that the tensor cores take the tiles in
//     turns and each epilogue runs under the other warpgroups' wgmmas. The
//     maxima of 8 consecutive blocks are one 32-byte sector per query,
//     gathered in shared memory and written by the warp that computed them.
//
// What bounds it on an H100: 5.5e11 int8 MACs at N = 8,388,608, Q = 256
// (1.1e12 operations, 0.56 ms at the int8 peak) against 268 MB of twin
// (0.080 ms): the operations, at every W. Shared memory serves wgmma's
// operands (6 KiB per m64n128k32, 96 bytes a clock at the int8 rate) and
// the producer's loads and 32 KiB of row stores per block beside them. What
// holds it back (PERF.md section 6, experiments/exp_bitplane_ablate.py
// --width): the wgmma loop alone runs near the int8 peak and the turns hide
// most of the epilogue; the staging and un-transpose beside the wgmmas cost
// the rest.
namespace planes {

// Timing cuts (experiments/exp_bitplane_ablate.py): ISCC_BITPLANE_ABLATE,
// defined only in a build of that script's own, is a mask of parts to leave
// out so that what is left can be timed. 0, the library's build, leaves
// nothing out; any other value computes something else.
#ifndef ISCC_BITPLANE_ABLATE
#define ISCC_BITPLANE_ABLATE 0
#endif
constexpr bool kCutWgmma = ISCC_BITPLANE_ABLATE & 1;        // no wgmma is issued
constexpr bool kCutEpilogue = ISCC_BITPLANE_ABLATE & 2;     // no epilogue, no flush (one accumulator kept live)
constexpr bool kCutStaging = ISCC_BITPLANE_ABLATE & 4;      // the first slice lands, and serves every slice
constexpr bool kCutUntranspose = ISCC_BITPLANE_ABLATE & 8;  // no slice is read, no row tile written
constexpr bool kForceGeneral = ISCC_BITPLANE_ABLATE & 16;   // every block takes the per-element path

constexpr int kBlockRows = 128;    // rows per block maximum, wgmma's N
constexpr int kBits = 256;         // bits of a row, int8 values of a query
constexpr int kGroupBlocks = 32;   // blocks j0 of a 4,096-row group
constexpr int kBands = 4;          // column bands j1 of a block
constexpr int kHoldBlocks = 4;     // blocks a producer thread holds in registers at a time
constexpr int kFlushBlocks = 8;    // blocks per flush of the gather: one 32-byte sector per query
constexpr int kTileQueries = 64;   // wgmma's M
constexpr int kChunkQueries = 256;  // queries per launch: one 64-query tile per consumer warpgroup
constexpr int kProducerThreads = 128;
constexpr int kConsumerGroups = kChunkQueries / kTileQueries;
constexpr int kConsumerThreads = kConsumerGroups * 128;
constexpr int kThreads = kProducerThreads + kConsumerThreads;
constexpr int kOutStride = kFlushBlocks + 1;  // floats per query in the gather: odd, so writers' banks differ
constexpr int kSbo = 128;          // bytes between 8-query groups of the query tile: one core matrix
constexpr int kS8Chunks = kBits / 16;
// The row tile: two swizzle atoms of 128 rows x 128 bytes (K bytes 0-127,
// then 128-255) in wgmma's 128-byte swizzle: byte k of row r lies at
// (k / 128) * kS8Atom + r * 128 + ((k / 16 % 8) ^ (r % 8)) * 16 + k % 16.
constexpr int kSwizzleBytes = 128;
constexpr int kS8Atom = kBlockRows * kSwizzleBytes;
constexpr int kS8TileBytes = kBits / kSwizzleBytes * kS8Atom;
constexpr int kS8Sbo = 8 * kSwizzleBytes;
constexpr uint32_t kPlaneMask = 0x01010101u;
constexpr int kDominance = 512;  // 2 x the largest |y|: a row this far below pmax never holds a maximum
// int32 d (|d| < 2^22) as f32: the bits of d + 0x4B400000 are 1.5 * 2^23 + d.
constexpr int kIntMagic = 0x4B400000;
constexpr float kIntMagicValue = 12582912.f;
constexpr unsigned kFull = 0xffffffffu;

// What changes with the element width W (32, 16 or 8 bits).
template <int W>
struct Width {
  static constexpr int kPlaneBands = 32 / W;  // bands b of a group's view rows
  static constexpr int kWordBlocks = 32 / W;  // blocks j0 in one 32-bit word of a view row
  // Consecutive blocks j0 per slice: TMA's box needs 16 bytes or more of them.
  static constexpr int kSliceBlocks = W == 8 ? 16 : 8;
  static constexpr int kSliceBufs = W == 8 ? 1 : 2;  // slices in flight
  static constexpr int kRowBytes = kSliceBlocks * W / 8;  // one (b, u, j1) of a slice
  static constexpr int kSliceBytes = kPlaneBands * kBits * kBands * kRowBytes;
  static constexpr int kHoldWords = W / 8;  // 32-bit words per band and K byte of a hold
  static constexpr int kHolds = kSliceBlocks / kHoldBlocks;
  static constexpr bool kPairSwap = W < 32;  // K byte k holds bit u = k ^ ((k >> 3) & 1)
};

// The epilogues: kernel 10's reads bf16 penalties (two blocks of a row in a
// 32-bit word) and keeps f32 values; kernel 11's reads int32 penalties (two
// blocks in a uint2) and keeps int32 values.
struct EpiBf16 {
  using Pen = uint16_t;
  using Pair = uint32_t;
  using Value = float;
};
struct EpiInt32 {
  using Pen = int32_t;
  using Pair = uint2;
  using Value = int;
};

// The blocks the epilogue finished, and those of them on the fast path,
// summed over launches until iscc_blockmax_bitplane_paths reads and clears
// them: one consumer thread counts its thread block's blocks in registers
// and adds them once, as it ends.
__device__ unsigned long long g_path_blocks[2];

// ---------------------------------------------------- wgmma, TMA, barriers
// (as in blockmax_variants.cu)

#define ISCC_BP_ACC8(d, i) \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), \
      "+r"(d[i + 7])
#define ISCC_BP_ACC64(d)                                                                                  \
  ISCC_BP_ACC8(d, 0), ISCC_BP_ACC8(d, 8), ISCC_BP_ACC8(d, 16), ISCC_BP_ACC8(d, 24), ISCC_BP_ACC8(d, 32), \
      ISCC_BP_ACC8(d, 40), ISCC_BP_ACC8(d, 48), ISCC_BP_ACC8(d, 56)

// The 64-bit shared-memory matrix descriptor of wgmma, no-swizzle layout:
// start address, leading (k-chunk) and stride (8-row group) byte offsets,
// each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
// The same of a K-major tile in the 128-byte swizzle (layout type 1 in bits
// 62-63): 8-row groups kS8Sbo apart; a k-step advances the start address.
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t addr) {
  return smem_desc(addr, 16, kS8Sbo) | (1ull << 62);
}

// D (64 x 128 int32) = or += A (64 x 32 int8) x B (128 x 32 int8)^T.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : ISCC_BP_ACC64(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Keeps the compiler from reading or moving the accumulators across the
// wait that completes their wgmmas.
__device__ __forceinline__ void fence_acc(int (&d)[64]) { asm volatile("" : ISCC_BP_ACC64(d)::"memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Generic-proxy writes to shared memory (st.shared) before wgmma's reads of them.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// The producer warpgroup's barrier: its 128 threads, on hardware barrier 1.
__device__ __forceinline__ void producer_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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
// TMA's copy of one box of the 4-d tensor `map` at (x, y, z, v) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap& map, int x, int y, int z, int v,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, "
      "%5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(x), "r"(y), "r"(z), "r"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// ------------------------------------------------------------ arithmetic

__device__ __forceinline__ float round_bf16(float x) {
  return __uint_as_float((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x)) << 16);
}

// Exact f32 of an int32 |d| < 2^22 without I2F (a quarter-rate conversion).
__device__ __forceinline__ float exact_float(int d) { return __int_as_float(d + kIntMagic) - kIntMagicValue; }

__device__ __forceinline__ int quad_max(int v) {
  v = max(v, __shfl_xor_sync(kFull, v, 1));
  return max(v, __shfl_xor_sync(kFull, v, 2));
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

// The epilogues' penalties: half h of a pair, the larger of two values, and
// the rule (at pmax, or at least kDominance below it).
__device__ __forceinline__ float pen_value(uint32_t pair, int h) {
  return __uint_as_float(h ? pair & 0xFFFF0000u : pair << 16);
}
__device__ __forceinline__ int pen_value(uint2 pair, int h) { return (int)(h ? pair.y : pair.x); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }
__device__ __forceinline__ bool ruled(float p, float m) {
  return isfinite(p) && (p == m || p <= m - (float)kDominance);
}
__device__ __forceinline__ bool ruled(int p, int m) { return p == m || p <= m - kDominance; }
__device__ __forceinline__ void store4(float* dst, const float (&v)[kBands]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(int* dst, const int (&v)[kBands]) {
  *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
}

// The 4 x 4 byte transpose: p[b] holds byte b of e0, e1, e2, e3 in its
// bytes 0-3 (pairs of bytes, then pairs of halves).
__device__ __forceinline__ void transpose4(uint32_t e0, uint32_t e1, uint32_t e2, uint32_t e3, uint32_t (&p)[4]) {
  const uint32_t t0 = __byte_perm(e0, e1, 0x5140), t1 = __byte_perm(e0, e1, 0x7362);
  const uint32_t t2 = __byte_perm(e2, e3, 0x5140), t3 = __byte_perm(e2, e3, 0x7362);
  p[0] = __byte_perm(t0, t2, 0x5410);
  p[1] = __byte_perm(t0, t2, 0x7632);
  p[2] = __byte_perm(t1, t3, 0x5410);
  p[3] = __byte_perm(t1, t3, 0x7632);
}

// ------------------------------------------------------------ the producer

template <class Epi>
struct Args {
  const int8_t* q;       // this launch's queries, (nq, 256) int8
  const float* qs;       // their scales
  int nq;
  const typename Epi::Pen* pen;  // (nrows,) penalties in the twin's dot-column order
  int nslices;
  int nblocks;
  float* out;            // this launch's first output row; rows nblocks floats apart
};

// A block's plan in shared memory: written by the producer warp that found
// it, read by every producer thread (its band's mask) and by the consumers.
template <class V>
struct BlockPlan {
  V pmax;
  int fast;
  int substitute;     // fast, and some row is dominated
  int first_top;      // the block's first row at pmax
  uint32_t dom[kBands];  // bit s' of dom[j1]: row 4 s' + j1 is replaced (fast blocks only)
};

// A thread's hold: per band b and K byte u0 + i, the words of the hold's
// four blocks; after transpose_hold, e[b][4 g + n][v] holds byte n of the
// words of K bytes u0 + 4 g .. u0 + 4 g + 3.
template <int W>
using Hold = uint32_t[Width<W>::kPlaneBands][8][Width<W>::kHoldWords];

// The slice's twin box into shared memory (issued by one thread).
template <int W>
__device__ __forceinline__ void fetch_slice(const CUtensorMap& map, int slice, uint8_t* dst, uint32_t bar) {
  using L = Width<W>;
  constexpr int kGroupSlices = kGroupBlocks / L::kSliceBlocks;
  mbar_expect_tx(bar, L::kSliceBytes);
  tma_box(smem_addr(dst), map, slice % kGroupSlices * L::kSliceBlocks, 0, 0, slice / kGroupSlices * L::kPlaneBands,
          bar);
}

// The penalties producer warp w plans in a slice: pair p is blocks 8 p + 2 w
// (low half) and 8 p + 2 w + 1 (high half), rows 4 lane + j (band j) in
// pw[p][j].
template <int W, class Epi>
__device__ __forceinline__ void load_pens(const typename Epi::Pen* pen, int slice, int w, int lane,
                                          typename Epi::Pair (&pw)[Width<W>::kSliceBlocks / 8][kBands]) {
  using L = Width<W>;
  constexpr int kGroupSlices = kGroupBlocks / L::kSliceBlocks;
  const typename Epi::Pen* src = pen + (int64_t)(slice / kGroupSlices) * kGroupBlocks * kBlockRows + lane * 128 +
                                 slice % kGroupSlices * L::kSliceBlocks + 2 * w;
#pragma unroll
  for (int p = 0; p < L::kSliceBlocks / 8; ++p) {
#pragma unroll
    for (int j = 0; j < kBands; ++j) pw[p][j] = __ldg(reinterpret_cast<const typename Epi::Pair*>(src + 8 * p + j * 32));
  }
}

// One warp's two blocks planned together (their shuffle chains interleave):
// pmax, the rule, the dominated rows per band (ballots: lane l holds rows
// 4 l .. 4 l + 3) and the first row at pmax, into `tab`; the raw penalties
// of a block that is not fast into its slot of `pens`.
template <class Epi>
__device__ __forceinline__ void plan_pair(const typename Epi::Pair (&pw)[kBands], int lane,
                                          BlockPlan<typename Epi::Value>* tab, typename Epi::Value* pens) {
  using V = typename Epi::Value;
  V pen[2][kBands], m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < kBands; ++j) pen[h][j] = pen_value(pw[j], h);
    m[h] = vmax(vmax(pen[h][0], pen[h][1]), vmax(pen[h][2], pen[h][3]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) m[h] = vmax(m[h], __shfl_xor_sync(kFull, m[h], off));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bool ok = true;
    uint32_t below = 0u;
#pragma unroll
    for (int j = 0; j < kBands; ++j) {
      ok = ok && ruled(pen[h][j], m[h]);
      below |= (uint32_t)(pen[h][j] != m[h]) << j;
    }
    const bool fast = !kForceGeneral && __all_sync(kFull, ok);
    uint32_t dom[kBands];
#pragma unroll
    for (int j = 0; j < kBands; ++j) dom[j] = fast ? __ballot_sync(kFull, (below >> j) & 1u) : 0u;
    const uint32_t top_lanes = __ballot_sync(kFull, below != 0xFu);
    const int lane0 = max(__ffs(top_lanes) - 1, 0);
    const uint32_t below0 = __shfl_sync(kFull, below, lane0);
    if (lane == 0) {
      BlockPlan<V> bp;
      bp.pmax = m[h];
      bp.fast = fast;
      bp.substitute = (dom[0] | dom[1] | dom[2] | dom[3]) != 0u;
      bp.first_top = 4 * lane0 + max(__ffs(~below0 & 0xFu) - 1, 0);
#pragma unroll
      for (int j = 0; j < kBands; ++j) bp.dom[j] = dom[j];
      tab[h] = bp;
    }
    if (!fast) store4(pens + h * kBlockRows + 4 * lane, pen[h]);
  }
}

__device__ __forceinline__ void load_words(const uint8_t* src, uint32_t (&e)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  e[0] = v.x, e[1] = v.y, e[2] = v.z, e[3] = v.w;
}
__device__ __forceinline__ void load_words(const uint8_t* src, uint32_t (&e)[2]) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  e[0] = v.x, e[1] = v.y;
}
__device__ __forceinline__ void load_words(const uint8_t* src, uint32_t (&e)[1]) {
  e[0] = *reinterpret_cast<const uint32_t*>(src);
}

// Hold h of the thread's elements of a slice (blocks 4 h .. 4 h + 3): per
// band b and K byte u0 + i, one load (16, 8 or 4 bytes) of view row
// 256 b + (u0 + i, or u0 + (i ^ 1) where `swap`); then each four words of
// one band and word position transposed in place (eight PRMTs).
template <int W>
__device__ __forceinline__ void load_hold(const uint8_t* src, int swap, int h, Hold<W>& e) {
  using L = Width<W>;
  constexpr int kStep = kBands * L::kRowBytes;  // one u
  const uint8_t* even = src + swap * kStep + h * kHoldBlocks * W / 8;
  const uint8_t* odd = src - swap * kStep + h * kHoldBlocks * W / 8;
#pragma unroll
  for (int b = 0; b < L::kPlaneBands; ++b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) load_words((i & 1 ? odd : even) + (b * kBits + i) * kStep, e[b][i]);
  }
#pragma unroll
  for (int b = 0; b < L::kPlaneBands; ++b) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int v = 0; v < L::kHoldWords; ++v) {
        uint32_t p[4];
        transpose4(e[b][4 * g][v], e[b][4 * g + 1][v], e[b][4 * g + 2][v], e[b][4 * g + 3][v], p);
#pragma unroll
        for (int n = 0; n < 4; ++n) e[b][4 * g + n][v] = p[n];
      }
    }
  }
}

// The 0/1 bytes of row 4 s' + j1 of hold block c at the thread's K bytes
// 4 g .. 4 g + 3: bit s = s' / bands of band b = s' % bands, which is bit
// c % bands * W + s of the hold's word c / bands. Row s' lies in one of
// four registers, number b * W / 8 + s / 8 (sp is known only at run time
// for the first top row: a chain of selects, as no array may be indexed at
// run time without going to local memory).
template <int W>
__device__ __forceinline__ uint32_t plane_word(const Hold<W>& e, int c, int g, int sp) {
  using L = Width<W>;
  constexpr int kBytes = W / 8;
  const int cw = c % L::kWordBlocks, v = c / L::kWordBlocks;
  const int s = sp / L::kPlaneBands;
  const int sel = sp % L::kPlaneBands * kBytes + (s >> 3);
  const uint32_t r0 = e[0 / kBytes][4 * g + cw * kBytes + 0 % kBytes][v];
  const uint32_t r1 = e[1 / kBytes][4 * g + cw * kBytes + 1 % kBytes][v];
  const uint32_t r2 = e[2 / kBytes][4 * g + cw * kBytes + 2 % kBytes][v];
  const uint32_t r3 = e[3 / kBytes][4 * g + cw * kBytes + 3 % kBytes][v];
  const uint32_t word = sel == 0 ? r0 : sel == 1 ? r1 : sel == 2 ? r2 : r3;
  return (word >> ((cw * W + s) & 7)) & kPlaneMask;
}

// Block c of the hold into a row tile, the dominated rows replaced by the
// first top row.
template <int W, class V>
__device__ __forceinline__ void untranspose(const Hold<W>& e, int c, const BlockPlan<V>* bp, int j1, int u0,
                                            int lane, uint8_t* tile) {
  // Row r = 4 s' + j1 at K bytes u0 .. u0 + 7: atom u0 / 128, piece u0 / 16 % 8
  // swizzled by r % 8 = 4 (s' % 2) + j1, half (u0 / 8) % 2.
  const int piece = (u0 >> 4) & 7;
  uint8_t* row0 = tile + (u0 >> 7) * kS8Atom + j1 * kSwizzleBytes + (u0 & 8);
  const int swz[2] = {(piece ^ j1) << 4, (piece ^ (4 + j1)) << 4};
#pragma unroll
  for (int sp = 0; sp < 32; ++sp) {
    *reinterpret_cast<uint2*>(row0 + sp * 4 * kSwizzleBytes + swz[sp & 1]) =
        make_uint2(plane_word<W>(e, c, 0, sp), plane_word<W>(e, c, 1, sp));
  }
  if (bp->substitute) {
    // The dominated rows of this band, written again by the same thread:
    // the top row's words, shuffled in from the lane of the same K bytes
    // whose band holds that row.
    const int first_top = bp->first_top;
    const int sp_top = first_top >> 2;
    const int src = (lane & ~3) | (first_top & 3);
    const uint2 top = make_uint2(__shfl_sync(kFull, plane_word<W>(e, c, 0, sp_top), src),
                                 __shfl_sync(kFull, plane_word<W>(e, c, 1, sp_top), src));
    for (uint32_t dom = bp->dom[j1]; dom; dom &= dom - 1u) {
      const int sp = __ffs(dom) - 1;
      *reinterpret_cast<uint2*>(row0 + sp * 4 * kSwizzleBytes + (((piece ^ (4 * (sp & 1) + j1))) << 4)) = top;
    }
  }
}

template <int W, class Epi>
__device__ void produce(const Args<Epi>& a, const CUtensorMap& map, int first, int end, uint8_t* s_rows,
                        const uint8_t* s_slice, BlockPlan<typename Epi::Value>* s_tab,
                        typename Epi::Value* s_tpen, uint32_t slice_full, uint32_t full, uint32_t empty) {
  using L = Width<W>;
  constexpr int kPairs = L::kSliceBlocks / 8;  // block pairs per producer warp and slice
  const int p = threadIdx.x;
  const int w = p >> 5, lane = p & 31;
  // Band j1 and K bytes u0 .. u0 + 7 of this thread (bitplane_layout.producer_thread).
  const int j1 = lane & 3;
  const int u0 = 128 * (w >> 1) + 16 * (4 * ((lane >> 3) & 1) + 2 * (w & 1) + ((lane >> 4) & 1)) + 8 * ((lane >> 2) & 1);
  const int swap = L::kPairSwap ? (u0 >> 3) & 1 : 0;
  const int count = end - first;
  typename Epi::Pair pw[kPairs][kBands], pw_next[kPairs][kBands];
  load_pens<W, Epi>(a.pen, first, w, lane, pw);
  for (int n = 0; n < count; ++n) {
    if (n + 1 < count) load_pens<W, Epi>(a.pen, first + n + 1, w, lane, pw_next);
    const int sbuf = kCutStaging ? 0 : n % L::kSliceBufs;
    const uint8_t* src = s_slice + sbuf * L::kSliceBytes + (u0 * kBands + j1) * L::kRowBytes;
    Hold<W> e;
    if (!kCutUntranspose) {
      if (!kCutStaging || n == 0) mbar_wait(slice_full + 8 * sbuf, (n / L::kSliceBufs) & 1);
      load_hold<W>(src, swap, 0, e);
    }
    // The slice's plans (table n % 2: the consumers are past slice n - 2),
    // seen by the whole warpgroup.
    BlockPlan<typename Epi::Value>* tab = s_tab + (n & 1) * L::kSliceBlocks;
#pragma unroll
    for (int pp = 0; pp < kPairs; ++pp) {
      plan_pair<Epi>(pw[pp], lane, tab + 8 * pp + 2 * w,
                     s_tpen + ((n & 1) * L::kSliceBlocks + 8 * pp + 2 * w) * kBlockRows);
    }
    producer_sync();
    for (int h = 0; h < L::kHolds; ++h) {
      if (h > 0 && !kCutUntranspose) load_hold<W>(src, swap, h, e);
      if (h == L::kHolds - 1 && !kCutUntranspose && !kCutStaging && n + L::kSliceBufs < count) {
        // The warpgroup has read the slice: its buffer takes the slice
        // kSliceBufs on. The fence orders this thread's reads (generic
        // proxy) before the TMA's writes (async proxy), which else may
        // overtake them.
        fence_proxy_async();
        producer_sync();
        if (p == 0) {
          fetch_slice<W>(map, first + n + L::kSliceBufs, const_cast<uint8_t*>(s_slice) + sbuf * L::kSliceBytes,
                         slice_full + 8 * sbuf);
        }
      }
#pragma unroll
      for (int c = 0; c < kHoldBlocks; ++c) {
        const int i = n * L::kSliceBlocks + kHoldBlocks * h + c;  // the thread block's block sequence
        const int b = i & 1;
        if (i >= 2) mbar_wait(empty + 8 * b, ((i >> 1) + 1) & 1);
        if (!kCutUntranspose) {
          untranspose<W>(e, c, tab + kHoldBlocks * h + c, j1, u0, lane, s_rows + b * kS8TileBytes);
        }
        fence_proxy_async();
        mbar_arrive(full + 8 * b);
      }
    }
#pragma unroll
    for (int pp = 0; pp < kPairs; ++pp) {
#pragma unroll
      for (int j = 0; j < kBands; ++j) pw[pp][j] = pw_next[pp][j];
    }
  }
}

// ------------------------------------------------------------ the consumers

// Thread (warp w of its warpgroup, lane 4g + t) holds, for n-tile j,
// acc[4j], acc[4j + 1] = query 16w + g, rows 8j + 2t, 8j + 2t + 1, and
// acc[4j + 2], acc[4j + 3] = query 16w + g + 8 (ops/wgmma_layout.py).
__device__ __forceinline__ int tile_query(int first) {
  return first + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
}

// The largest dot of each of the thread's two queries over the tile:
// Hopper's three-way integer maximum (DPX), two chains per query, then the
// four lanes of a C row.
__device__ __forceinline__ void tile_max(const int (&acc)[64], int& ma, int& mb) {
  int a0 = max(acc[0], acc[1]), a1 = max(acc[4], acc[5]), b0 = max(acc[2], acc[3]), b1 = max(acc[6], acc[7]);
#pragma unroll
  for (int j = 2; j < 16; j += 2) {
    a0 = __vimax3_s32(a0, acc[4 * j], acc[4 * j + 1]);
    b0 = __vimax3_s32(b0, acc[4 * j + 2], acc[4 * j + 3]);
    a1 = __vimax3_s32(a1, acc[4 * j + 4], acc[4 * j + 5]);
    b1 = __vimax3_s32(b1, acc[4 * j + 6], acc[4 * j + 7]);
  }
  ma = quad_max(max(a0, a1));
  mb = quad_max(max(b0, b1));
}

// The block maxima of one finished tile into the block's slot of the
// gather, bf16 epilogue. Fast: the tile holds rows at pmax only, one
// element per query. Else the per-element path with the raw penalties of
// `pen_slot`.
__device__ __forceinline__ void finish(const int (&acc)[64], bool fast, float pmax, const float* pen_slot,
                                       const int (&qsum)[2], const float (&scale)[2], int first, float* slot_out) {
  const int t = threadIdx.x & 3;
  float ea, eb;
  if (fast) {
    int ma, mb;
    tile_max(acc, ma, mb);
    ea = round_bf16(__fadd_rn(round_bf16(exact_float(2 * ma - qsum[0])), pmax));
    eb = round_bf16(__fadd_rn(round_bf16(exact_float(2 * mb - qsum[1])), pmax));
  } else {
    const int ka = kIntMagic - qsum[0], kb = kIntMagic - qsum[1];  // exact_float(2 d - qsum) in one IMAD
    float va = -INFINITY, vb = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 p = *reinterpret_cast<const float2*>(pen_slot + 8 * j + 2 * t);
      va = fmaxf(va, fmaxf(__fadd_rn(__int_as_float(2 * acc[4 * j] + ka) - kIntMagicValue, p.x),
                           __fadd_rn(__int_as_float(2 * acc[4 * j + 1] + ka) - kIntMagicValue, p.y)));
      vb = fmaxf(vb, fmaxf(__fadd_rn(__int_as_float(2 * acc[4 * j + 2] + kb) - kIntMagicValue, p.x),
                           __fadd_rn(__int_as_float(2 * acc[4 * j + 3] + kb) - kIntMagicValue, p.y)));
    }
    ea = round_bf16(quad_max(va));
    eb = round_bf16(quad_max(vb));
  }
  if (t == 0) {
    const int qa = tile_query(first);
    slot_out[qa * kOutStride] = __fmaf_rn(ea, scale[0], 0.5f);
    slot_out[(qa + 8) * kOutStride] = __fmaf_rn(eb, scale[1], 0.5f);
  }
}

// The same, int32 epilogue: m = the largest dot01 + pen, exact in integers
// (fast: the largest dot + pmax), then (float)(2 m - qsum).
__device__ __forceinline__ void finish(const int (&acc)[64], bool fast, int pmax, const int* pen_slot,
                                       const int (&qsum)[2], const float (&scale)[2], int first, float* slot_out) {
  const int t = threadIdx.x & 3;
  int ma, mb;
  if (fast) {
    tile_max(acc, ma, mb);
    ma += pmax;
    mb += pmax;
  } else {
    int va = INT_MIN, vb = INT_MIN;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int2 p = *reinterpret_cast<const int2*>(pen_slot + 8 * j + 2 * t);
      va = __vimax3_s32(va, acc[4 * j] + p.x, acc[4 * j + 1] + p.y);
      vb = __vimax3_s32(vb, acc[4 * j + 2] + p.x, acc[4 * j + 3] + p.y);
    }
    ma = quad_max(va);
    mb = quad_max(vb);
  }
  if (t == 0) {
    const int qa = tile_query(first);
    slot_out[qa * kOutStride] = __fmaf_rn((float)(2 * ma - qsum[0]), scale[0], 0.5f);
    slot_out[(qa + 8) * kOutStride] = __fmaf_rn((float)(2 * mb - qsum[1]), scale[1], 0.5f);
  }
}

// The gathered maxima of kFlushBlocks blocks leave: the four lanes of a C
// row write its two queries' 8 maxima, one sector per query; lane t = 0
// gathered them, so the warp's own barrier is enough.
__device__ __forceinline__ void flush(const float* s_out, int nq, int nblocks, float* out, int block0, int first) {
  __syncwarp();
  const int t = threadIdx.x & 3;
  const int qa = tile_query(first);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qa + 8 * h;
    if (qi < nq) {
      *reinterpret_cast<float2*>(out + (int64_t)qi * nblocks + block0 + 2 * t) =
          make_float2(s_out[qi * kOutStride + 2 * t], s_out[qi * kOutStride + 2 * t + 1]);
    }
  }
}

// The consumers' turns (hardware barriers 2 + m, warpgroup m and the one
// before it): warpgroup m issues a block's wgmmas after warpgroup m - 1 has
// issued its own (round the ring of the launch's tiles), so that the tensor
// cores take the tiles in turns and each warpgroup's epilogue runs under
// the others' wgmmas.
__device__ __forceinline__ void turn_wait(int member) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(2 + member) : "memory");
}
__device__ __forceinline__ void turn_pass(int next) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 + next) : "memory");
}

template <int W, class Epi>
__device__ void consume(const Args<Epi>& a, int first, int end, const uint8_t* s_rows, const uint8_t* s_q,
                        uint32_t q_lbo, int tiles, const float* s_scale, const int* s_qsum,
                        const BlockPlan<typename Epi::Value>* s_tab, const typename Epi::Value* s_tpen,
                        float* s_out, uint32_t full, uint32_t empty) {
  using L = Width<W>;
  const int member = __shfl_sync(kFull, (threadIdx.x >> 7) - 1, 0);  // this consumer warpgroup: its query tile
  if (member >= tiles) return;  // no queries for this warpgroup in this launch
  const int tile0 = member * kTileQueries;
  const uint64_t desc_a = smem_desc(smem_addr(s_q) + tile0 * 16, q_lbo, kSbo);
  const int qa = tile_query(tile0);
  const float scale[2] = {s_scale[qa], s_scale[qa + 8]};
  const int qsum[2] = {s_qsum[qa], s_qsum[qa + 8]};
  const int next = member + 1 == tiles ? 0 : member + 1;
  int acc[64];
  int sink = 0;  // kCutEpilogue only
  unsigned finished = 0, took_fast = 0;  // this thread block's blocks (g_path_blocks), first consumer thread
  const int blocks = (end - first) * L::kSliceBlocks;
  for (int i = 0; i < blocks; ++i) {
    const int b = i & 1;
    const int slot = ((i / L::kSliceBlocks) & 1) * L::kSliceBlocks + i % L::kSliceBlocks;  // the plan table's
    mbar_wait(full + 8 * b, (i >> 1) & 1);
    const BlockPlan<typename Epi::Value>* bp = s_tab + slot;
    const bool fast = bp->fast;
    const typename Epi::Value pmax = bp->pmax;
    const uint64_t desc_b = smem_desc_sw128(smem_addr(s_rows + b * kS8TileBytes));
    if (tiles > 1 && (member > 0 || i > 0)) turn_wait(member);
    wgmma_fence();
    // A k-step advances both start addresses (the low 14 bits, in 16-byte
    // units, never carry out of the field).
#pragma unroll
    for (int ks = 0; ks < (kCutWgmma ? 0 : kS8Chunks / 2); ++ks) {
      wgmma_s8(acc, desc_a + (uint64_t)(ks * (q_lbo >> 3)), desc_b + (uint64_t)((ks / 4 * kS8Atom + ks % 4 * 32) >> 4),
               ks > 0);
    }
    wgmma_commit();
    if (tiles > 1 && (next > 0 || i + 1 < blocks)) turn_pass(next);
    wgmma_wait0();
    fence_acc(acc);
    if (kCutEpilogue) {
      sink ^= acc[0];
    } else {
      finish(acc, fast, pmax, s_tpen + slot * kBlockRows, qsum, scale, tile0, s_out + i % kFlushBlocks);
    }
    mbar_arrive(empty + 8 * b);  // the row tile, and the plan and penalties once the slice is done
    if (!kCutEpilogue) {
      if (threadIdx.x == kProducerThreads) {
        ++finished;
        took_fast += fast;
      }
      if (i % kFlushBlocks == kFlushBlocks - 1) {
        flush(s_out, a.nq, a.nblocks, a.out, first * L::kSliceBlocks + i / kFlushBlocks * kFlushBlocks, tile0);
      }
    }
  }
  if (threadIdx.x == kProducerThreads && finished) {
    atomicAdd(&g_path_blocks[0], (unsigned long long)finished);
    atomicAdd(&g_path_blocks[1], (unsigned long long)took_fast);
  }
  if (kCutEpilogue && sink == INT_MIN) a.out[0] = 0.f;
}

// ------------------------------------------------------------ the kernel

// Dynamic shared memory: two row tiles, the slices in flight, the query
// tile (qc queries), their scales and sums, two slices' penalty slots and
// plans, the gather, six mbarriers, and 1,024 bytes to align the row tiles
// (the swizzle's atoms start on 1,024 bytes).
template <int W>
__host__ __device__ constexpr int smem_bytes(int qc) {
  using L = Width<W>;
  return 2 * kS8TileBytes + L::kSliceBufs * L::kSliceBytes + kS8Chunks * qc * 16 + qc * 8 +
         2 * L::kSliceBlocks * kBlockRows * 4 + 2 * L::kSliceBlocks * (int)sizeof(BlockPlan<int>) +
         qc * kOutStride * 4 + 6 * 8 + 1024;
}
static_assert(smem_bytes<8>(kChunkQueries) <= 232448 && smem_bytes<16>(kChunkQueries) <= 232448 &&
                  smem_bytes<32>(kChunkQueries) <= 232448,
              "a thread block takes at most 227 KiB of shared memory");

template <int W, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    bitplane_wgmma_kernel(Args<Epi> a, const __grid_constant__ CUtensorMap map) {
  using L = Width<W>;
  using V = typename Epi::Value;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int tiles = (a.nq + kTileQueries - 1) / kTileQueries;  // 1 to 4, one per consumer warpgroup
  const int qc = tiles * kTileQueries;
  const uint32_t q_lbo = qc * 16;
  uint8_t* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  uint8_t* s_rows = base;
  uint8_t* s_slice = base + 2 * kS8TileBytes;
  uint8_t* s_q = s_slice + L::kSliceBufs * L::kSliceBytes;
  float* s_scale = reinterpret_cast<float*>(s_q + kS8Chunks * q_lbo);
  int* s_qsum = reinterpret_cast<int*>(s_scale + qc);
  V* s_tpen = reinterpret_cast<V*>(s_qsum + qc);  // per slice parity and block: 128 penalties
  BlockPlan<V>* s_tab = reinterpret_cast<BlockPlan<V>*>(s_tpen + 2 * L::kSliceBlocks * kBlockRows);
  float* s_out = reinterpret_cast<float*>(s_tab + 2 * L::kSliceBlocks);
  const uint32_t slice_full = smem_addr(s_out + qc * kOutStride);  // then full[2], then empty[2]
  const uint32_t full = slice_full + 16, empty = slice_full + 32;
  const int first = (int)((int64_t)blockIdx.x * a.nslices / gridDim.x);
  const int end = (int)((int64_t)(blockIdx.x + 1) * a.nslices / gridDim.x);
  if (tid == 0) {
    mbar_init(slice_full, 1);  // the arrive of expect_tx, plus the box's bytes
    mbar_init(slice_full + 8, 1);
    mbar_init(full, kProducerThreads);
    mbar_init(full + 8, kProducerThreads);
    mbar_init(empty, tiles * 128);  // the consumer warpgroups with a tile
    mbar_init(empty + 8, tiles * 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (!kCutUntranspose) {
      for (int k = 0; k < (kCutStaging ? 1 : L::kSliceBufs) && first + k < end; ++k) {
        fetch_slice<W>(map, first + k, s_slice + k * L::kSliceBytes, slice_full + 8 * k);
      }
    }
  }
  // The chunk's queries, zero past nq: piece (query qi, k-chunk c), K bytes
  // permuted as the row tiles' (Width::kPairSwap); their scales and sums.
  for (int i = tid; i < qc * kS8Chunks; i += kThreads) {
    const int qi = i % qc, c = i / qc;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (qi < a.nq) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(a.q + (int64_t)qi * kBits + c * 16);
      v = make_uint4(src[0], src[1], src[2], src[3]);
      if (L::kPairSwap) {  // K bytes 8 .. 15 of the piece hold u = k ^ 1
        v.z = __byte_perm(v.z, 0, 0x2301);
        v.w = __byte_perm(v.w, 0, 0x2301);
      }
    }
    *reinterpret_cast<uint4*>(s_q + c * q_lbo + qi * 16) = v;
  }
  for (int i = tid; i < qc; i += kThreads) {
    int sum = 0;
    float scale = 0.f;
    if (i < a.nq) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(a.q + (int64_t)i * kBits);
#pragma unroll 8
      for (int k = 0; k < kBits / 4; ++k) sum = __dp4a((int)src[k], 0x01010101, sum);  // signed bytes
      scale = a.qs[i];
    }
    s_qsum[i] = sum;
    s_scale[i] = scale;
  }
  fence_proxy_async();
  __syncthreads();
  // The warpgroup's role, uniform in the compiler's eyes too.
  if (__shfl_sync(kFull, tid / 128, 0) == 0) {
    produce<W, Epi>(a, map, first, end, s_rows, s_slice, s_tab, s_tpen, slice_full, full, empty);
  } else {
    consume<W, Epi>(a, first, end, s_rows, s_q, q_lbo, tiles, s_scale, s_qsum, s_tab, s_tpen, s_out, full, empty);
  }
}

// cuTensorMapEncodeTiled of the driver, reached through the runtime (the
// library links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int encoder(EncodeTiled* out) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = encode;
  return 0;
}

// The twin as a 4-d tensor (j0, j1, view row u, group x band b) of W-bit
// elements whose box is one slice: kSliceBlocks j0 x 4 j1 x 256 u x bands,
// no swizzle.
template <int W>
int twin_map_of(const void* twin, int nrows, CUtensorMap* map) {
  using L = Width<W>;
  EncodeTiled encode = nullptr;
  const int err = encoder(&encode);
  if (err) return err;
  constexpr cuuint64_t kBytes = W / 8;
  const cuuint64_t dims[4] = {(cuuint64_t)kGroupBlocks, (cuuint64_t)kBands, (cuuint64_t)kBits,
                              (cuuint64_t)nrows / (kGroupBlocks * kBlockRows) * L::kPlaneBands};
  const cuuint64_t strides[3] = {kGroupBlocks * kBytes, kBands * kGroupBlocks * kBytes,
                                 kBits * kBands * kGroupBlocks * kBytes};
  const cuuint32_t box[4] = {(cuuint32_t)L::kSliceBlocks, (cuuint32_t)kBands, (cuuint32_t)kBits,
                             (cuuint32_t)L::kPlaneBands};
  const cuuint32_t element_strides[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = W == 32   ? CU_TENSOR_MAP_DATA_TYPE_UINT32
                                   : W == 16 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                             : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUresult res = encode(map, type, 4, const_cast<void*>(twin), dims, strides, box, element_strides,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int W, class Epi>
int launch(const int8_t* q, const float* qs, int nq, const void* twin, const typename Epi::Pen* pen, int nrows,
           float* out, cudaStream_t s) {
  using L = Width<W>;
  if (nq <= 0 || nrows <= 0) return 0;
  if (nrows % (kGroupBlocks * kBlockRows) || (uintptr_t)twin % 16 || (uintptr_t)pen % 16) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0;
  int sm_count = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map;
  const int map_err = twin_map_of<W>(twin, nrows, &map);
  if (map_err) return map_err;
  err = cudaFuncSetAttribute(bitplane_wgmma_kernel<W, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<W>(kChunkQueries));
  if (err != cudaSuccess) return (int)err;
  const int nblocks = nrows / kBlockRows;
  const int nslices = nblocks / L::kSliceBlocks;
  const dim3 grid(min(nslices, sm_count));
  for (int q0 = 0; q0 < nq; q0 += kChunkQueries) {
    const int chunk = min(nq - q0, kChunkQueries);
    const int qc = (chunk + kTileQueries - 1) / kTileQueries * kTileQueries;
    const Args<Epi> a{q + (int64_t)q0 * kBits, qs + q0, chunk, pen, nslices, nblocks, out + (int64_t)q0 * nblocks};
    bitplane_wgmma_kernel<W, Epi><<<grid, kThreads, smem_bytes<W>(qc), s>>>(a, map);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace planes

}  // namespace

// out (nq, nrows / 128) f32 <- block maxima of the (nrows / 16, 128) u32
// bit_transpose_packed twin (16-byte aligned) of 256-bit rows against the
// (nq, 256) int8 ±1/0 queries q (4-byte aligned), (nq,) f32 scales qs and
// the (nrows,) bf16 penalty (16-byte aligned) in bitplane_penalty_perm
// order; nrows % 4096 == 0. For a NaN penalty the output is undefined (the
// maxima are fmaxf's). Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int iscc_blockmax_bitplane(const void* q, const void* qs, int nq, const void* twin,
                                      const void* pen, int nrows, void* out, void* stream) {
  return planes::launch<32, planes::EpiBf16>(static_cast<const int8_t*>(q), static_cast<const float*>(qs), nq, twin,
                                             static_cast<const uint16_t*>(pen), nrows, static_cast<float*>(out),
                                             static_cast<cudaStream_t>(stream));
}

// counts[0], counts[1] (uint64) <- the blocks whose maxima the
// iscc_blockmax_bitplane and iscc_blockmax_subword launches on the current
// device finished since the last call, and those of them on the fast path;
// then clears them; waits for the stream.
extern "C" int iscc_blockmax_bitplane_paths(void* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  void* dev_counts = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&dev_counts, planes::g_path_blocks);
  if (err == cudaSuccess) err = cudaMemcpyAsync(counts, dev_counts, sizeof(planes::g_path_blocks), cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(dev_counts, 0, sizeof(planes::g_path_blocks), s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return (int)err;
}

// The same from a build_twin sub-word twin of width_bits 8 or 16 (16-byte
// aligned) and an (nrows,) int32 penalty (16-byte aligned) in penalty_perm
// order, with the int32 epilogue; exact for |pen| <= 2^29.
extern "C" int iscc_blockmax_subword(const void* q, const void* qs, int nq, const void* twin,
                                     const void* pen, int nrows, int width_bits, void* out,
                                     void* stream) {
  const auto* q8 = static_cast<const int8_t*>(q);
  const auto* scales = static_cast<const float*>(qs);
  const auto* pen32 = static_cast<const int32_t*>(pen);
  auto* dst = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (width_bits == 8) return planes::launch<8, planes::EpiInt32>(q8, scales, nq, twin, pen32, nrows, dst, s);
  if (width_bits == 16) return planes::launch<16, planes::EpiInt32>(q8, scales, nq, twin, pen32, nrows, dst, s);
  return (int)cudaErrorInvalidValue;
}
