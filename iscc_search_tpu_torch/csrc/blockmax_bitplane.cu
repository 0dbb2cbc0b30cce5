// Phase 1 of the NPHD scan from bit-plane twins on Hopper's int8 tensor
// cores: 0/1 int8 planes of 256-bit rows dotted with the ±1/0 int8 queries,
// dot_pm1 = 2 * dot01 - sum(q).
//
// Replaces two Pallas TPU kernels of benchmarks/:
//   - exp_bitplane_int8.py _kernel_variant (:53; make_variant :105,
//     pallas_call :118), all of its modes: entry iscc_blockmax_bitplane
//     reads the bit_transpose_packed twin (32-bit elements) with the script's
//     bf16 epilogue, x = bf16(bf16(2 * dot01 - qsum) + pen_bf16), block max,
//     __fmaf_rn(m, qs, 0.5) (namespace planes below);
//   - exp_bitplane_u8.py _kernel (:123; blockmax_subword_impl :152,
//     pallas_call :167): entry iscc_blockmax_subword reads the build_twin
//     sub-word twins (8- or 16-bit elements) with the script's int32
//     epilogue, x = dot01 + pen_i32 (0 / -32768), block max m, then
//     __fmaf_rn((float)(2m - qsum), qs, 0.5), equal to blockmax.cu
//     (namespace subword below).
// The penalty row is in the twin's dot-column order (bitplane_penalty_perm
// / penalty_perm of ops/bitplane.py); the output is in original block
// order.
//
// Layout (ops/bitplane.py): per 4096-row group, element (256 b + u, j) of
// the (32 / w * 256, 128) view holds at bit s bit u of original row
// j0 * 128 + r, r = s * (128 / w) + 4 b + j1 (j = 32 j1 + j0). So block j0
// of a group is view columns j0, 32 + j0, 64 + j0, 96 + j0 of the group's
// view rows, and its penalty for row r sits at (r >> 2) * 128 + (r & 3) * 32
// + j0 of the group.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

// ================================================ the sub-word twins (11)
//
// One thread block (four warps) per original 128-row block. It
// un-transposes the block's planes into shared memory as a (128 rows x 256)
// 0/1 int8 tile (a thread takes four consecutive u of one (b, j1) and
// writes one 32-bit word of four bytes per bit s), then runs the mma.sync
// loop of mma_s8.cuh: each warp 16 queries, 16 n-tiles x 8 k-steps. qsum
// comes from the A fragments (__dp4a) and a shuffle over the 4 lanes of a
// row. What bounds it on an H100: 1.1e12 int8 operations at N = 8,388,608,
// Q = 256 (0.56 ms at the int8 peak); it runs far below that (PERF.md).
namespace subword {

using namespace iscc_mma;

constexpr int kGroupBlocks = 32;  // 128-row blocks per 4096-row group

template <int W>
struct Element;
template <>
struct Element<16> { using type = uint16_t; };
template <>
struct Element<8> { using type = uint8_t; };

template <int W>
__global__ void __launch_bounds__(kWarps * 32)
subword_kernel(const int8_t* __restrict__ q, const float* __restrict__ qs, int nq,
               const void* __restrict__ twin, const int32_t* __restrict__ pen, int nblocks,
               float* __restrict__ out) {
  using Elem = typename Element<W>::type;
  constexpr int kBands = 32 / W;
  constexpr int kViewRows = kBands * kBits;  // view rows per group
  __shared__ __align__(16) int8_t s_rows[kBlockRows * kStride];
  __shared__ int s_peni[kBlockRows];

  const int blk = blockIdx.x;
  const int grp = blk / kGroupBlocks;
  const int j0 = blk % kGroupBlocks;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // Un-transpose: task (b, j1, u4) reads elements u = 4 u4 .. 4 u4 + 3 of
  // view column 32 j1 + j0 and writes, per bit s, bytes u of row r(s, b, j1).
  const Elem* base = static_cast<const Elem*>(twin) + (int64_t)grp * kViewRows * 128;
  for (int task = threadIdx.x; task < kBands * 4 * 64; task += blockDim.x) {
    const int u4 = task & 63;
    const int j1 = (task >> 6) & 3;
    const int b = task >> 8;
    const Elem* src = base + (int64_t)(kBits * b + 4 * u4) * 128 + 32 * j1 + j0;
    const uint32_t e0 = src[0], e1 = src[128], e2 = src[256], e3 = src[384];
#pragma unroll
    for (int s = 0; s < W; ++s) {
      const uint32_t word = ((e0 >> s) & 1u) | (((e1 >> s) & 1u) << 8) |
                            (((e2 >> s) & 1u) << 16) | (((e3 >> s) & 1u) << 24);
      const int r = s * (kBlockRows / W) + 4 * b + j1;
      *reinterpret_cast<uint32_t*>(s_rows + r * kStride + 4 * u4) = word;
    }
  }
  for (int r = threadIdx.x; r < kBlockRows; r += blockDim.x) {
    s_peni[r] = pen[(int64_t)grp * kGroupBlocks * kBlockRows + (r >> 2) * 128 + (r & 3) * 32 + j0];
  }
  __syncthreads();

  for (int q0 = warp * kWarpQueries; q0 < nq; q0 += kQueryTile) {
    const int qa = q0 + g;
    const int qb = qa + 8;
    uint32_t a[kSteps][4];
    load_a(q, qa, nq, t, a);
    int sum_a = 0, sum_b = 0;
#pragma unroll
    for (int l = 0; l < kSteps; ++l) {  // signed bytes: the int overload of __dp4a
      sum_a = __dp4a((int)a[l][2], 0x01010101, __dp4a((int)a[l][0], 0x01010101, sum_a));
      sum_b = __dp4a((int)a[l][3], 0x01010101, __dp4a((int)a[l][1], 0x01010101, sum_b));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // qsum: the 4 lanes of a row
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }

    int ibest_a = INT_MIN, ibest_b = INT_MIN;
#pragma unroll 4
    for (int n = 0; n < kNTiles; ++n) {
      int c[4];
      dot_tile(a, s_rows + (8 * n + g) * kStride + 4 * t, c);
      const int r = 8 * n + 2 * t;  // C columns r, r + 1
      const int p0 = s_peni[r], p1 = s_peni[r + 1];
      ibest_a = max(ibest_a, max(c[0] + p0, c[1] + p1));
      ibest_b = max(ibest_b, max(c[2] + p0, c[3] + p1));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ibest_a = max(ibest_a, __shfl_xor_sync(0xffffffffu, ibest_a, off));
      ibest_b = max(ibest_b, __shfl_xor_sync(0xffffffffu, ibest_b, off));
    }
    if (t == 0) {
      if (qa < nq) out[(int64_t)qa * nblocks + blk] = __fmaf_rn((float)(2 * ibest_a - sum_a), qs[qa], 0.5f);
      if (qb < nq) out[(int64_t)qb * nblocks + blk] = __fmaf_rn((float)(2 * ibest_b - sum_b), qs[qb], 0.5f);
    }
  }
}

template <int W>
int launch(const void* q, const void* qs, int nq, const void* twin, const void* pen, int nrows, void* out,
           void* stream) {
  if (nq <= 0 || nrows <= 0) return 0;
  if (nrows % (kGroupBlocks * kBlockRows)) return (int)cudaErrorInvalidValue;
  const int nblocks = nrows / kBlockRows;
  subword_kernel<W><<<nblocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qs), nq, twin, static_cast<const int32_t*>(pen),
      nblocks, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace subword

// ====================================== the bit-transposed twin (kernel 10)
//
// experiments/bitplane_layout.py mirrors this flow in numpy.
//
// Shape: one persistent launch per chunk of up to 256 queries, of
// min(slices, SMs) thread blocks of five warpgroups: a producer and four
// consumers. The queries wait in shared memory as wgmma's A operand
// (K-major core matrices, as in blockmax_variants.cu), loaded once per
// thread block. The unit of work is a slice: 8 consecutive blocks j0 of one
// group, the twin's columns j0 .. j0 + 7 of each band j1 over its 256 view
// rows, 32 KiB that TMA lands as one 3-d box (u, j1, j0; j0 innermost) on an
// mbarrier. Each thread block takes a contiguous share of slices; every twin
// byte leaves device memory once per launch.
//   - The producer warpgroup keeps two slices in flight. Each thread holds
//     half of its 64 elements of a slice in registers at a time (band j1 =
//     lane % 4, eight consecutive u; one 16-byte load per u, a quarter-warp
//     touching each bank at most twice). Each warp plans two of the slice's
//     blocks (below) into a table in shared memory, which a barrier of the
//     warpgroup publishes. Then block after block it un-transposes into one
//     of two row tiles (128 rows x 256 int8, two atoms in wgmma's 128-byte
//     swizzle): four elements e0..e3 of one column become P_b = byte b of
//     each by eight PRMTs, and the word of row 4 s + j1 at K bytes u .. u + 3
//     is (P_{s/8} >> s % 8) & 0x01010101, two operations; one 8-byte store
//     per row, a half-warp filling every bank once. It signals the tile's
//     full mbarrier after fence.proxy.async. Once the second half is read,
//     a proxy fence and a barrier free the slice for the slice after next
//     (without the fence, TMA's writes overtake the reads).
//   - The penalty, once per block: y = 2 dot01 - qsum lies in [-256, 256] and
//     y -> bf16(bf16(y) + p) is non-decreasing, so kernel 8's rule holds:
//     where every penalty of the block is finite and either the largest,
//     pmax, or at most pmax - 512, a dominated row can never hold the
//     maximum. The planning warp reads the block's penalties (lane l the rows
//     4l .. 4l + 3, a slice ahead) and finds pmax, the rule, the dominated
//     rows of each band and the first row at pmax with shuffles and ballots,
//     two blocks' chains interleaved. After a block's rows are stored, each
//     thread stores its band's dominated rows again as copies of that row
//     (its words shuffled in from the lane of the same K bytes whose band
//     holds it). Such a block takes the fast path: the integer maximum of the
//     accumulators (Hopper's three-way integer maximum), then one element
//     per query. Any other block keeps its rows and takes the per-element
//     path: the maximum of the f32 sums y + p, rounded to bf16 once (rounding
//     is monotone).
//   - Each consumer warpgroup takes one 64-query tile of every block
//     (m64n128k32 s8, eight k-steps), waits, runs the epilogue, and frees the
//     row tile on its empty mbarrier. They issue their wgmmas in turns round
//     a ring (hardware barriers), so that the tensor cores take the tiles in
//     turns and each epilogue runs under the other warpgroups' wgmmas. The
//     maxima of a slice's 8 blocks are one 32-byte sector per query,
//     gathered in shared memory and written by the warp that computed them.
//
// What bounds it on an H100: 5.5e11 int8 MACs at N = 8,388,608, Q = 256
// (1.1e12 operations, 0.56 ms at the int8 peak) against 268 MB of twin
// (0.080 ms): the operations. Shared memory serves wgmma's operands (6 KiB
// per m64n128k32, 96 bytes a clock at the int8 rate) and the producer's
// 36 KiB per block beside them. What holds it back (PERF.md section 6,
// experiments/exp_bitplane_ablate.py): the wgmma loop alone runs at ~93% of
// the int8 peak and the turns hide most of the epilogue; the staging and
// un-transpose beside the wgmmas cost the rest.
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
constexpr int kSliceBlocks = 8;    // consecutive j0 per slice
constexpr int kSliceBytes = kBits * kBands * kSliceBlocks * 4;
constexpr int kTileQueries = 64;   // wgmma's M
constexpr int kChunkQueries = 256;  // queries per launch: one 64-query tile per consumer warpgroup
constexpr int kProducerThreads = 128;
constexpr int kConsumerGroups = kChunkQueries / kTileQueries;
constexpr int kConsumerThreads = kConsumerGroups * 128;
constexpr int kThreads = kProducerThreads + kConsumerThreads;
constexpr int kOutStride = kSliceBlocks + 1;  // floats per query in the gather: odd, so writers' banks differ
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
constexpr float kDominance = 512.f;  // 2 x the largest |y|: a row this far below pmax never holds a maximum
// int32 d (|d| < 2^22) as f32: the bits of d + 0x4B400000 are 1.5 * 2^23 + d.
constexpr int kIntMagic = 0x4B400000;
constexpr float kIntMagicValue = 12582912.f;
constexpr unsigned kFull = 0xffffffffu;

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
// TMA's copy of one box of the 3-d tensor `map` at (x, y, z) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap& map, int x, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(x), "r"(y), "r"(z), "r"(bar)
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

// The 0/1 bytes of bit s of the four elements (s known only at run time).
__device__ __forceinline__ uint32_t plane_word(const uint32_t (&p)[4], int s) {
  const int b = s >> 3;
  const uint32_t v = b == 0 ? p[0] : b == 1 ? p[1] : b == 2 ? p[2] : p[3];
  return (v >> (s & 7)) & kPlaneMask;
}

// ------------------------------------------------------------ the producer

struct Args {
  const int8_t* q;       // this launch's queries, (nq, 256) int8
  const float* qs;       // their scales
  int nq;
  const uint16_t* pen;   // (nrows,) bf16 bits, bitplane_penalty_perm order
  int nslices;
  int nblocks;
  float* out;            // this launch's first output row; rows nblocks floats apart
};

// A block's plan in shared memory: written by the producer warp that found
// it, read by every producer thread (its band's mask) and by the consumers.
struct BlockPlan {
  float pmax;
  int fast;
  int substitute;     // fast, and some row is dominated
  int first_top;      // the block's first row at pmax
  uint32_t dom[kBands];  // bit s of dom[j1]: row 4 s + j1 is replaced (fast blocks only)
};

// The slice's twin box into shared memory (issued by one thread).
__device__ __forceinline__ void fetch_slice(const CUtensorMap& map, int slice, uint8_t* dst, uint32_t bar) {
  constexpr int kGroupSlices = kGroupBlocks / kSliceBlocks;
  mbar_expect_tx(bar, kSliceBytes);
  tma_box(smem_addr(dst), map, slice % kGroupSlices * kSliceBlocks, 0, slice / kGroupSlices * kBits, bar);
}

// The penalties producer warp w plans: blocks 2w (low half) and 2w + 1
// (high half) of a slice, rows 4 lane + j (band j) in word j.
__device__ __forceinline__ void load_pens(const uint16_t* pen, int slice, int w, int lane, uint32_t (&pw)[kBands]) {
  constexpr int kGroupSlices = kGroupBlocks / kSliceBlocks;
  const uint16_t* src = pen + (int64_t)(slice / kGroupSlices) * kGroupBlocks * kBlockRows + lane * 128 +
                        slice % kGroupSlices * kSliceBlocks + 2 * w;
#pragma unroll
  for (int j = 0; j < kBands; ++j) pw[j] = __ldg(reinterpret_cast<const uint32_t*>(src + j * 32));
}

// Warp w's two blocks of a slice planned together (their shuffle chains
// interleave): pmax, the rule, the dominated rows per band (ballots: lane s
// holds rows 4 s .. 4 s + 3) and the first row at pmax, into `tab`; the raw
// penalties of a block that is not fast into its slot of `pens`.
__device__ __forceinline__ void plan_pair(const uint32_t (&pw)[kBands], int lane, BlockPlan* tab, float* pens) {
  float pen[2][kBands], m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < kBands; ++j) pen[h][j] = __uint_as_float(h ? pw[j] & 0xFFFF0000u : pw[j] << 16);
    m[h] = fmaxf(fmaxf(pen[h][0], pen[h][1]), fmaxf(pen[h][2], pen[h][3]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) m[h] = fmaxf(m[h], __shfl_xor_sync(kFull, m[h], off));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bool ok = true;
    uint32_t below = 0u;
#pragma unroll
    for (int j = 0; j < kBands; ++j) {
      ok = ok && isfinite(pen[h][j]) && (pen[h][j] == m[h] || pen[h][j] <= m[h] - kDominance);
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
      BlockPlan bp;
      bp.pmax = m[h];
      bp.fast = fast;
      bp.substitute = (dom[0] | dom[1] | dom[2] | dom[3]) != 0u;
      bp.first_top = 4 * lane0 + max(__ffs(~below0 & 0xFu) - 1, 0);
#pragma unroll
      for (int j = 0; j < kBands; ++j) bp.dom[j] = dom[j];
      tab[h] = bp;
    }
    if (!fast) {
      *reinterpret_cast<float4*>(pens + h * kBlockRows + 4 * lane) =
          make_float4(pen[h][0], pen[h][1], pen[h][2], pen[h][3]);
    }
  }
}

// Block c of a half slice in registers (e[i][c]: element u0 + i, band j1)
// into a row tile, the dominated rows replaced by the first top row.
__device__ __forceinline__ void untranspose(const uint32_t (&e)[8][kSliceBlocks / 2], int c, const BlockPlan* bp,
                                            int j1, int u0, int lane, uint8_t* tile) {
  uint32_t p0[4], p1[4];
  transpose4(e[0][c], e[1][c], e[2][c], e[3][c], p0);
  transpose4(e[4][c], e[5][c], e[6][c], e[7][c], p1);
  // Row r = 4 s + j1 at K bytes u0 .. u0 + 7: atom u0 / 128, piece u0 / 16 % 8
  // swizzled by r % 8 = 4 (s % 2) + j1, half (u0 / 8) % 2.
  const int piece = (u0 >> 4) & 7;
  uint8_t* row0 = tile + (u0 >> 7) * kS8Atom + j1 * kSwizzleBytes + (u0 & 8);
  const int swz[2] = {(piece ^ j1) << 4, (piece ^ (4 + j1)) << 4};
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    *reinterpret_cast<uint2*>(row0 + s * 4 * kSwizzleBytes + swz[s & 1]) =
        make_uint2((p0[s >> 3] >> (s & 7)) & kPlaneMask, (p1[s >> 3] >> (s & 7)) & kPlaneMask);
  }
  if (bp->substitute) {
    // The dominated rows of this band, written again by the same thread:
    // the top row's words, shuffled in from the lane of the same K bytes
    // whose band holds that row.
    const int first_top = bp->first_top;
    const int s_top = first_top >> 2;
    const int src = (lane & ~3) | (first_top & 3);
    const uint2 top = make_uint2(__shfl_sync(kFull, plane_word(p0, s_top), src),
                                 __shfl_sync(kFull, plane_word(p1, s_top), src));
    for (uint32_t dom = bp->dom[j1]; dom; dom &= dom - 1u) {
      const int s = __ffs(dom) - 1;
      *reinterpret_cast<uint2*>(row0 + s * 4 * kSwizzleBytes + (((piece ^ (4 * (s & 1) + j1))) << 4)) = top;
    }
  }
}

// Half h of the thread's elements of a slice (blocks 4 h .. 4 h + 3): one
// 16-byte load per u.
__device__ __forceinline__ void load_half(const uint8_t* src, int h, uint32_t (&e)[8][kSliceBlocks / 2]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + i * (kBands * kSliceBlocks * 4) + 16 * h);
    e[i][0] = v.x, e[i][1] = v.y, e[i][2] = v.z, e[i][3] = v.w;
  }
}

__device__ void produce(const Args& a, const CUtensorMap& map, int first, int end, uint8_t* s_rows,
                        const uint8_t* s_slice, BlockPlan* s_tab, float* s_tpen, uint32_t slice_full, uint32_t full,
                        uint32_t empty) {
  const int p = threadIdx.x;
  const int w = p >> 5, lane = p & 31;
  // Band j1 and K bytes u0 .. u0 + 7 of this thread (bitplane_layout.producer_thread).
  const int j1 = lane & 3;
  const int u0 = 128 * (w >> 1) + 16 * (4 * ((lane >> 3) & 1) + 2 * (w & 1) + ((lane >> 4) & 1)) + 8 * ((lane >> 2) & 1);
  const int count = end - first;
  uint32_t pw[kBands], pw_next[kBands];
  load_pens(a.pen, first, w, lane, pw);
  for (int n = 0; n < count; ++n) {
    if (n + 1 < count) load_pens(a.pen, first + n + 1, w, lane, pw_next);
    const int sbuf = kCutStaging ? 0 : n & 1;
    const uint8_t* src = s_slice + sbuf * kSliceBytes + u0 * (kBands * kSliceBlocks * 4) + j1 * (kSliceBlocks * 4);
    uint32_t e[8][kSliceBlocks / 2];  // half a slice: blocks 4 h .. 4 h + 3
    if (!kCutUntranspose) {
      if (!kCutStaging || n == 0) mbar_wait(slice_full + 8 * sbuf, (n >> 1) & 1);
      load_half(src, 0, e);
    }
    // The slice's plans (table n % 2: the consumers are past slice n - 2),
    // seen by the whole warpgroup.
    BlockPlan* tab = s_tab + (n & 1) * kSliceBlocks;
    plan_pair(pw, lane, tab + 2 * w, s_tpen + ((n & 1) * kSliceBlocks + 2 * w) * kBlockRows);
    producer_sync();
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !kCutUntranspose) {
        load_half(src, 1, e);
        if (!kCutStaging && n + 2 < count) {
          // The warpgroup has read the slice: its buffer takes the slice after
          // next. The fence orders this thread's reads (generic proxy) before
          // the TMA's writes (async proxy), which else may overtake them.
          fence_proxy_async();
          producer_sync();
          if (p == 0) {
            fetch_slice(map, first + n + 2, const_cast<uint8_t*>(s_slice) + sbuf * kSliceBytes, slice_full + 8 * sbuf);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kSliceBlocks / 2; ++c) {
        const int i = n * kSliceBlocks + 4 * h + c;  // the thread block's block sequence
        const int b = i & 1;
        if (i >= 2) mbar_wait(empty + 8 * b, ((i >> 1) + 1) & 1);
        if (!kCutUntranspose) untranspose(e, c, tab + 4 * h + c, j1, u0, lane, s_rows + b * kS8TileBytes);
        fence_proxy_async();
        mbar_arrive(full + 8 * b);
      }
    }
#pragma unroll
    for (int j = 0; j < kBands; ++j) pw[j] = pw_next[j];
  }
}

// ------------------------------------------------------------ the consumers

// Thread (warp w of its warpgroup, lane 4g + t) holds, for n-tile j,
// acc[4j], acc[4j + 1] = query 16w + g, rows 8j + 2t, 8j + 2t + 1, and
// acc[4j + 2], acc[4j + 3] = query 16w + g + 8 (ops/wgmma_layout.py).
__device__ __forceinline__ int tile_query(int first) {
  return first + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
}

// The block maxima of one finished tile into the block's slot of the
// gather. Fast: the tile holds rows at pmax only, an integer maximum in two
// chains per query, one element per query. Else the per-element path with
// the raw penalties of `pen_slot`.
__device__ __forceinline__ void finish(const int (&acc)[64], bool fast, float pmax, const float* pen_slot,
                                       const int (&qsum)[2], const float (&scale)[2], int first, float* slot_out) {
  const int t = threadIdx.x & 3;
  float ea, eb;
  if (fast) {
    // Hopper's three-way integer maximum (DPX), two chains per query.
    int a0 = max(acc[0], acc[1]), a1 = max(acc[4], acc[5]), b0 = max(acc[2], acc[3]), b1 = max(acc[6], acc[7]);
#pragma unroll
    for (int j = 2; j < 16; j += 2) {
      a0 = __vimax3_s32(a0, acc[4 * j], acc[4 * j + 1]);
      b0 = __vimax3_s32(b0, acc[4 * j + 2], acc[4 * j + 3]);
      a1 = __vimax3_s32(a1, acc[4 * j + 4], acc[4 * j + 5]);
      b1 = __vimax3_s32(b1, acc[4 * j + 6], acc[4 * j + 7]);
    }
    ea = round_bf16(__fadd_rn(round_bf16(exact_float(2 * quad_max(max(a0, a1)) - qsum[0])), pmax));
    eb = round_bf16(__fadd_rn(round_bf16(exact_float(2 * quad_max(max(b0, b1)) - qsum[1])), pmax));
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

// A slice's gathered maxima leave: the four lanes of a C row write its two
// queries' 8 maxima, one sector per query; lane t = 0 gathered them, so the
// warp's own barrier is enough.
__device__ __forceinline__ void flush(const float* s_out, const Args& a, int block0, int first) {
  __syncwarp();
  const int t = threadIdx.x & 3;
  const int qa = tile_query(first);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qa + 8 * h;
    if (qi < a.nq) {
      *reinterpret_cast<float2*>(a.out + (int64_t)qi * a.nblocks + block0 + 2 * t) =
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

__device__ void consume(const Args& a, int first, int end, const uint8_t* s_rows, const uint8_t* s_q, uint32_t q_lbo,
                        int tiles, const float* s_scale, const int* s_qsum, const BlockPlan* s_tab,
                        const float* s_tpen, float* s_out, uint32_t full, uint32_t empty) {
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
  const int blocks = (end - first) * kSliceBlocks;
  for (int i = 0; i < blocks; ++i) {
    const int b = i & 1;
    const int slot = ((i / kSliceBlocks) & 1) * kSliceBlocks + i % kSliceBlocks;  // the plan table's
    mbar_wait(full + 8 * b, (i >> 1) & 1);
    const BlockPlan* bp = s_tab + slot;
    const bool fast = bp->fast;
    const float pmax = bp->pmax;
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
      finish(acc, fast, pmax, s_tpen + slot * kBlockRows, qsum, scale, tile0, s_out + i % kSliceBlocks);
    }
    mbar_arrive(empty + 8 * b);  // the row tile, and the plan and penalties once the slice is done
    if (!kCutEpilogue) {
      if (threadIdx.x == kProducerThreads) {
        ++finished;
        took_fast += fast;
      }
      if (i % kSliceBlocks == kSliceBlocks - 1) flush(s_out, a, (first + i / kSliceBlocks) * kSliceBlocks, tile0);
    }
  }
  if (threadIdx.x == kProducerThreads && finished) {
    atomicAdd(&g_path_blocks[0], (unsigned long long)finished);
    atomicAdd(&g_path_blocks[1], (unsigned long long)took_fast);
  }
  if (kCutEpilogue && sink == INT_MIN) a.out[0] = 0.f;
}

// ------------------------------------------------------------ the kernel

// Dynamic shared memory: two row tiles, two slices, the query tile (qc
// queries), their scales and sums, two slices' plans and penalty slots, the
// gather, six mbarriers, and 1,024 bytes to align the row tiles (the
// swizzle's atoms start on 1,024 bytes).
__host__ __device__ constexpr int smem_bytes(int qc) {
  return 2 * kS8TileBytes + 2 * kSliceBytes + kS8Chunks * qc * 16 + qc * 8 + 2 * kSliceBlocks * kBlockRows * 4 +
         2 * kSliceBlocks * (int)sizeof(BlockPlan) + qc * kOutStride * 4 + 6 * 8 + 1024;
}

__global__ void __launch_bounds__(kThreads, 1) bitplane_wgmma_kernel(Args a, const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int tiles = (a.nq + kTileQueries - 1) / kTileQueries;  // 1 to 4, one per consumer warpgroup
  const int qc = tiles * kTileQueries;
  const uint32_t q_lbo = qc * 16;
  uint8_t* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  uint8_t* s_rows = base;
  uint8_t* s_slice = base + 2 * kS8TileBytes;
  uint8_t* s_q = s_slice + 2 * kSliceBytes;
  float* s_scale = reinterpret_cast<float*>(s_q + kS8Chunks * q_lbo);
  int* s_qsum = reinterpret_cast<int*>(s_scale + qc);
  float* s_tpen = reinterpret_cast<float*>(s_qsum + qc);  // per slice parity and block: 128 penalties
  BlockPlan* s_tab = reinterpret_cast<BlockPlan*>(s_tpen + 2 * kSliceBlocks * kBlockRows);
  float* s_out = reinterpret_cast<float*>(s_tab + 2 * kSliceBlocks);
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
      fetch_slice(map, first, s_slice, slice_full);
      if (!kCutStaging && first + 1 < end) fetch_slice(map, first + 1, s_slice + kSliceBytes, slice_full + 8);
    }
  }
  // The chunk's queries, zero past nq: piece (query qi, k-chunk c); their
  // scales and sums.
  for (int i = tid; i < qc * kS8Chunks; i += kThreads) {
    const int qi = i % qc, c = i / qc;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (qi < a.nq) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(a.q + (int64_t)qi * kBits + c * 16);
      v = make_uint4(src[0], src[1], src[2], src[3]);
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
    produce(a, map, first, end, s_rows, s_slice, s_tab, s_tpen, slice_full, full, empty);
  } else {
    consume(a, first, end, s_rows, s_q, q_lbo, tiles, s_scale, s_qsum, s_tab, s_tpen, s_out, full, empty);
  }
}

// cuTensorMapEncodeTiled of the driver, reached through the runtime (the
// library links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The (nrows / 16, 128) u32 twin as a 3-d tensor (j0, j1, view row u) whose
// box is one slice: 8 j0 x 4 j1 x 256 u, no swizzle.
int twin_map_of(const void* twin, int nrows, CUtensorMap* map) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)kGroupBlocks, (cuuint64_t)kBands, (cuuint64_t)nrows / 16};
  const cuuint64_t strides[2] = {(cuuint64_t)kGroupBlocks * 4, (cuuint64_t)kBands * kGroupBlocks * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kSliceBlocks, (cuuint32_t)kBands, (cuuint32_t)kBits};
  const cuuint32_t element_strides[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<void*>(twin), dims, strides, box,
                              element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch(const int8_t* q, const float* qs, int nq, const void* twin, const uint16_t* pen, int nrows, float* out,
           cudaStream_t s) {
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
  const int map_err = twin_map_of(twin, nrows, &map);
  if (map_err) return map_err;
  err = cudaFuncSetAttribute(bitplane_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(kChunkQueries));
  if (err != cudaSuccess) return (int)err;
  const int nblocks = nrows / kBlockRows;
  const int nslices = nblocks / kSliceBlocks;
  const dim3 grid(min(nslices, sm_count));
  for (int q0 = 0; q0 < nq; q0 += kChunkQueries) {
    const int chunk = min(nq - q0, kChunkQueries);
    const int qc = (chunk + kTileQueries - 1) / kTileQueries * kTileQueries;
    const Args a{q + (int64_t)q0 * kBits, qs + q0, chunk, pen, nslices, nblocks, out + (int64_t)q0 * nblocks};
    bitplane_wgmma_kernel<<<grid, kThreads, smem_bytes(qc), s>>>(a, map);
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
  return planes::launch(static_cast<const int8_t*>(q), static_cast<const float*>(qs), nq, twin,
                      static_cast<const uint16_t*>(pen), nrows, static_cast<float*>(out),
                      static_cast<cudaStream_t>(stream));
}

// counts[0], counts[1] (uint64) <- the blocks whose maxima the
// iscc_blockmax_bitplane launches on the current device finished since the
// last call, and those of them on the fast path; then clears them; waits
// for the stream.
extern "C" int iscc_blockmax_bitplane_paths(void* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  void* dev_counts = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&dev_counts, planes::g_path_blocks);
  if (err == cudaSuccess) err = cudaMemcpyAsync(counts, dev_counts, sizeof(planes::g_path_blocks), cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(dev_counts, 0, sizeof(planes::g_path_blocks), s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return (int)err;
}

// The same from a build_twin sub-word twin of width_bits 8 or 16 and an
// (nrows,) int32 penalty in penalty_perm order, with the int32 epilogue.
extern "C" int iscc_blockmax_subword(const void* q, const void* qs, int nq, const void* twin,
                                     const void* pen, int nrows, int width_bits, void* out,
                                     void* stream) {
  if (width_bits == 8) return subword::launch<8>(q, qs, nq, twin, pen, nrows, out, stream);
  if (width_bits == 16) return subword::launch<16>(q, qs, nq, twin, pen, nrows, out, stream);
  return (int)cudaErrorInvalidValue;
}
