// The phase-1 epilogue probes of benchmarks/exp_kernels.py on Hopper's
// tensor cores: per-128-row block maxima (and the probes' other reductions)
// of 256-bit ±1 int8 rows against ±1/0 int8 queries, on the persistent
// wgmma pipeline of blockmax_mma.cu's twin entry.
//
// Replaces the Pallas TPU kernel of benchmarks/exp_kernels.py reached
// through make_variant (:203, pallas_call :211): the bodies _kernel_bf16
// (:42), _kernel_trans (:59), _kernel_dotonly (:74), _kernel_consume (:91),
// _kernel_tree (:108), _kernel_tree_trans (:129), _kernel_u8max (:150),
// _kernel_tree2d (:169) and _kernel_bf16dot (:189). One entry,
// iscc_blockmax_variant, takes the epilogue as a template parameter (the
// Epi codes below, EPI_* in experiments/exp_kernels.py):
//   kBf16     fma(m(bf16(dot) + pen)), pen bf16, the sum rounded to bf16;
//   kBf16NoPen  the same without the penalty;
//   kTrans    kBf16, output (N/128, Q);
//   kU8Max    (m(u8(clip((dot >> 1) + 127, 0, 255)) * pen_u8) - 127) * 2;
//   kBf16Dot  the dot on the bf16 tensor cores (f32 accumulate), then
//             fma(m(dot + f32(pen)));
//   kDotOnly / kDotOnlyBf16  the dot of row t*4096 + c, c < 32, per
//             4096-row sub-tile t; every other dot is computed (each wgmma
//             is issued) and not read;
//   kConsume  per sub-tile, the sum of bf16(dot) over its 4096 rows, in
//             each of its 32 columns (bf16(dot) = dot for |dot| <= 256, so
//             an integer sum);
//   kTree2d   per sub-tile and class c < 32, fma(max over rows c + 32i of
//             bf16(dot) + pen).
// m is a max over the 128 rows of a block, fma(m) = __fmaf_rn(m, qs, 0.5),
// the one rounding of the Pallas kernels in interpret mode. db_wrap != 0
// reads db row r % db_wrap for row r (the *_nodma probes: chunk 0 only).
// experiments/variant_layout.py mirrors the flow below in numpy.
//
// Shape: the loop of blockmax_mma.cu's twin entry (blockmax_wgmma_kernel<8,
// false>). The host launches one persistent grid per chunk of up to 256
// queries, which wait in shared memory as wgmma's A operand (K-major core
// matrices, no swizzle). A block's 128 rows are wgmma's N.
//   - int8 epilogues: one thread block per SM of two teams of two
//     warpgroups; each team takes a contiguous half of the thread block's
//     share of blocks and has two row tiles. TMA brings a block's rows into
//     a tile, two boxes of 128 rows x 128 bytes in the 128-byte swizzle that
//     wgmma reads, completing on the tile's mbarrier; the next block's boxes
//     are asked for as soon as the other tile is free, so two blocks are in
//     flight per team. A warpgroup takes every other 64-query tile
//     (m64n128k32 s8, eight k-steps), waits, and runs the epilogue on its
//     64 int32 accumulators.
//   - bf16 epilogues (kBf16Dot, kDotOnlyBf16): the queries in bf16 take
//     128 KiB, so one team per SM; its rows are read into registers a block
//     ahead and converted to bf16 once, on their way into the row tile
//     (m64n128k16 bf16, sixteen k-steps, f32 accumulate).
//   - The penalty, once per block: a dominant-penalty row substitution.
//     Every dot lies in [-256, 256] (±1 rows, ±1/0 queries, 256 bits), and
//     every element the epilogues take a maximum of is non-decreasing in
//     the dot for a fixed penalty p. So a row whose p <= pmax - 512 (pmax
//     the block's largest) can never hold the block's maximum: while the
//     penalties are staged (PenStage, a step ahead), each such row is
//     replaced by the block's first row at pmax: in the tile once TMA has
//     landed it (int8), or as it is read (bf16). Then every row of the
//     tile has p = pmax, the epilogue is a plain integer maximum, and the
//     element is evaluated once per (query, block). A block whose penalties
//     are not so split (within 512 but not equal, or not finite) keeps its
//     rows and takes the per-element path: the maximum of the f32 sums
//     dot + p, rounded to bf16 once (rounding is monotone). For kU8Max the
//     fast path needs every penalty in {0, 1}: a row at 0 gives 0, below
//     any row at 1. kTree2d's classes span blocks, so it always takes the
//     per-element path.
//   - Sub-tile epilogues (kConsume, kTree2d) keep their per-query state in
//     registers across a sub-tile's 32 blocks: shares are cut at sub-tile
//     boundaries. Block maxima of eight consecutive blocks wait in shared
//     memory and leave as whole sectors of the output, written by the warp
//     that gathered them (no team barrier).
//
// What bounds it on an H100: the twin's bytes (2.68 GB at N = 10,485,760,
// 0.80 ms at 3.35 TB/s) against 1.4e12 int8 operations (0.69 ms at the
// int8 peak): memory for the int8 epilogues, the operations for the
// *_nodma probes (4 MB of rows); on the bf16 units the same dots take 1.39
// ms at the bf16 peak. Each part alone comes close to its bound
// (experiments/exp_variant_ablate.py, PERF.md section 6): the TMA staging
// streams near the memory rate, the int8 loop near the int8 peak; the block
// epilogues sit partly between them. cp.async staging (16-byte pieces, one
// block in flight per team: the proxy fence before the wgmmas waits for
// every copy in flight) and TMA boxes of 16 bytes x 128 rows streamed well
// below the memory rate. The bf16 epilogues pay their conversion and
// barriers outside any wgmma: one team has no second team to overlap.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// Timing cuts (experiments/exp_variant_ablate.py): ISCC_VARIANT_ABLATE,
// defined only in a build of that script's own, is a mask of parts to leave
// out so that what is left can be timed. 0, the library's build, leaves
// nothing out; any other value computes something else.
#ifndef ISCC_VARIANT_ABLATE
#define ISCC_VARIANT_ABLATE 0
#endif
constexpr bool kCutWgmma = ISCC_VARIANT_ABLATE & 1;     // no wgmma is issued
constexpr bool kCutEpilogue = ISCC_VARIANT_ABLATE & 2;  // no epilogue, no flush (one accumulator kept live)
constexpr bool kCutStaging = ISCC_VARIANT_ABLATE & 4;   // rows enter the row tile at a team's first block only

constexpr int kBlockRows = 128;    // rows per block maximum, wgmma's N
constexpr int kBits = 256;         // bytes of an int8 row, int8 values of a query
constexpr int kGroupBlocks = 32;   // 4096-row sub-tile of the sub-tile epilogues
constexpr int kClasses = 32;       // kTree2d's stride classes per sub-tile
constexpr int kTileQueries = 64;   // wgmma's M
constexpr int kChunkQueries = 256;  // queries per launch: two 64-query tiles per warpgroup
constexpr int kTeamThreads = 256;  // two warpgroups
constexpr int kSbo = 128;          // bytes between 8-row groups: one core matrix
constexpr int kS8Chunks = kBits / 16;       // 16-byte k-chunks of an int8 row
constexpr int kBf16Chunks = 2 * kS8Chunks;  // of a bf16 row
// The int8 row tile: two swizzle atoms of 128 rows x 128 bytes (K bytes 0-127,
// then 128-255), in wgmma's and TMA's 128-byte swizzle: byte k of row r lies
// at (k / 128) * kS8Atom + r * 128 + ((k / 16 % 8) ^ (r % 8)) * 16 + k % 16.
constexpr int kSwizzleBytes = 128;
constexpr int kS8Atom = kBlockRows * kSwizzleBytes;
constexpr int kS8TileBytes = kBits / kSwizzleBytes * kS8Atom;
constexpr int kS8Sbo = 8 * kSwizzleBytes;  // bytes between 8-row groups of an atom
// Bytes between the k-chunks of the bf16 row tile (no swizzle): a panel of
// 128 rows plus 16 bytes, so that the pieces one thread stores (one chunk
// apart) fall on distinct banks.
constexpr int kBf16Lbo = kBlockRows * 16 + 16;
constexpr int kBf16TileBytes = kBf16Chunks * kBf16Lbo;
constexpr int kOutBlocks = 8;   // blocks gathered per query: one 32-byte sector
constexpr int kOutStride = kOutBlocks + 1;  // floats per query in the gather: odd, so writers' banks differ
constexpr float kDominance = 512.f;  // 2 x the largest |dot|: a row this far below pmax never holds a maximum
// int8 x as f32: the bits 0x4B0000uu (uu = x + 128) are 2^23 + x + 128.
constexpr uint32_t kMagicBits = 0x4B000000u;
constexpr float kMagicOffset = 8388736.f;  // 2^23 + 128
// int32 d (|d| < 2^22) as f32: the bits of d + 0x4B400000 are 1.5 * 2^23 + d.
constexpr int kIntMagic = 0x4B400000;
constexpr float kIntMagicValue = 12582912.f;
constexpr unsigned kFull = 0xffffffffu;

enum Epi {
  kBf16 = 0,
  kBf16NoPen = 1,
  kTrans = 2,
  kU8Max = 3,
  kBf16Dot = 4,
  kDotOnly = 5,
  kDotOnlyBf16 = 6,
  kConsume = 7,
  kTree2d = 8,
};

__host__ __device__ constexpr bool bf16_mma(int epi) { return epi == kBf16Dot || epi == kDotOnlyBf16; }
__host__ __device__ constexpr bool uses_pen(int epi) {
  return epi == kBf16 || epi == kTrans || epi == kU8Max || epi == kBf16Dot || epi == kTree2d;
}
// State across the 32 blocks of a sub-tile: shares are cut at sub-tile boundaries.
__host__ __device__ constexpr bool sub_tile(int epi) { return epi == kConsume || epi == kTree2d; }
// Block maxima gathered in shared memory, written as sectors of the (nq, nblocks) output.
__host__ __device__ constexpr bool gathers(int epi) {
  return epi == kBf16 || epi == kBf16NoPen || epi == kU8Max || epi == kBf16Dot;
}
// A block maximum per (query, block), on the fast or the per-element path (finish_max).
__host__ __device__ constexpr bool finishes_max(int epi) { return gathers(epi) || epi == kTrans; }

// The blocks whose maxima finish_max finished, and those of them it
// finished on the fast path, summed over launches until
// iscc_blockmax_variant_paths reads and clears them: the fast-path share is
// counted where the kernel branches, not predicted from the penalties. One
// thread per team counts its blocks in registers and adds them once, as
// its thread block ends.
__device__ unsigned long long g_path_blocks[2];

__device__ __forceinline__ void add_path_blocks(unsigned finished, unsigned took_fast) {
  if (finished) {
    atomicAdd(&g_path_blocks[0], (unsigned long long)finished);
    atomicAdd(&g_path_blocks[1], (unsigned long long)took_fast);
  }
}

// ---------------------------------------------------- wgmma, TMA, barriers
// (as in blockmax_mma.cu and blockmax_small.cu)

#define ISCC_VAR_ACC8(d, i, c)                                                                   \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define ISCC_VAR_ACC64(d, c)                                                                     \
  ISCC_VAR_ACC8(d, 0, c), ISCC_VAR_ACC8(d, 8, c), ISCC_VAR_ACC8(d, 16, c), ISCC_VAR_ACC8(d, 24, c), \
      ISCC_VAR_ACC8(d, 32, c), ISCC_VAR_ACC8(d, 40, c), ISCC_VAR_ACC8(d, 48, c), ISCC_VAR_ACC8(d, 56, c)
#define ISCC_VAR_REGS                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                       \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "              \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "              \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
#define ISCC_VAR_S32 "+r"
#define ISCC_VAR_F32 "+f"

// The 64-bit shared-memory matrix descriptor of wgmma, no-swizzle layout:
// start address, leading (k-chunk) and stride (8-row group) byte offsets,
// each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
// The same of a K-major tile in the 128-byte swizzle (layout type 1 in bits
// 62-63): 8-row groups kS8Sbo apart, the leading offset unused (a k-step's
// 32 bytes lie inside one 128-byte row); a k-step advances the start address.
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t addr) {
  return smem_desc(addr, 16, kS8Sbo) | (1ull << 62);
}

// D (64 x 128 int32) = or += A (64 x 32 int8) x B (128 x 32 int8)^T.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " ISCC_VAR_REGS "%64, %65, p;\n}\n"
      : ISCC_VAR_ACC64(d, ISCC_VAR_S32)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128 f32) = or += A (64 x 16 bf16) x B (128 x 16 bf16)^T, both K-major.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ISCC_VAR_REGS "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ISCC_VAR_ACC64(d, ISCC_VAR_F32)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Keeps the compiler from reading or moving an accumulator set across the
// wait that completes its wgmmas.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
  asm volatile("" : ISCC_VAR_ACC64(d, ISCC_VAR_S32)::"memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
  asm volatile("" : ISCC_VAR_ACC64(d, ISCC_VAR_F32)::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Generic-proxy writes to shared memory (st.shared) before wgmma's reads of
// them, and TMA's writes, through the async proxy.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// A team's barrier: its 256 threads, on the hardware barrier 1 + team.
__device__ __forceinline__ void team_sync(int team) { asm volatile("bar.sync %0, 256;\n" ::"r"(team + 1) : "memory"); }

// mbarriers and TMA (as in blockmax_small.cu).
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
// TMA's copy of one box of the 2-d tensor `map` at (x, y) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap& map, int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// ------------------------------------------------------------ arithmetic

__device__ __forceinline__ float round_bf16(float x) {
  return __uint_as_float((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x)) << 16);
}

// Exact f32 of an int32 |d| < 2^22 without I2F (a quarter-rate conversion).
__device__ __forceinline__ float exact_float(int d) { return __int_as_float(d + kIntMagic) - kIntMagicValue; }
__device__ __forceinline__ float exact_float(float d) { return d; }

// Four int8 values (one word, the first in byte 0) as four bf16, two per
// word, the first in the low half: each is f32 2^23 + x + 128 less 2^23 +
// 128, exactly x, whose bf16 is the top half of its f32 bits (x has at most
// 8 significant bits).
__device__ __forceinline__ uint2 s8x4_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;  // x + 128 as unsigned bytes
  const float f0 = __uint_as_float(__byte_perm(u, kMagicBits, 0x7440)) - kMagicOffset;
  const float f1 = __uint_as_float(__byte_perm(u, kMagicBits, 0x7441)) - kMagicOffset;
  const float f2 = __uint_as_float(__byte_perm(u, kMagicBits, 0x7442)) - kMagicOffset;
  const float f3 = __uint_as_float(__byte_perm(u, kMagicBits, 0x7443)) - kMagicOffset;
  return make_uint2(__byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),
                    __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));
}

template <int EPI>
__device__ __forceinline__ float pen_value(const void* pen, int64_t row) {
  if (EPI == kU8Max) return (float)static_cast<const uint8_t*>(pen)[row];
  return __uint_as_float((uint32_t) static_cast<const uint16_t*>(pen)[row] << 16);
}

// The per-element path: the f32 sum dot + p, whose maximum is rounded to
// bf16 once (finish_general); kU8Max's element itself.
template <int EPI, typename T>
__device__ __forceinline__ float general(T d, float p) {
  if (EPI == kU8Max) {
    const int y = min(max(((int)d >> 1) + 127, 0), 255);
    return (float)((y * (int)p) & 0xFF);
  }
  return __fadd_rn(exact_float(d), p);
}

// The element of the block max at dot m and penalty p (the fast path: once
// per query and block, m the block's largest dot).
template <int EPI, typename T>
__device__ __forceinline__ float element(T m, float p) {
  if (EPI == kU8Max) return general<EPI>(m, p);
  if (EPI == kBf16NoPen) return exact_float(m);
  if (EPI == kBf16Dot) return __fadd_rn(exact_float(m), p);
  return round_bf16(__fadd_rn(round_bf16(exact_float(m)), p));
}

template <int EPI>
__device__ __forceinline__ float finish_general(float v) {
  return EPI == kBf16Dot || EPI == kU8Max ? v : round_bf16(v);
}

template <int EPI>
__device__ __forceinline__ float finalize(float e, float scale) {
  return EPI == kU8Max ? (e - 127.f) * 2.f : __fmaf_rn(e, scale, 0.5f);
}

// Shares a maximum among the four lanes of a C row.
__device__ __forceinline__ int quad_max(int v) {
  v = max(v, __shfl_xor_sync(kFull, v, 1));
  return max(v, __shfl_xor_sync(kFull, v, 2));
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}
__device__ __forceinline__ int max_of(int a, int b) { return max(a, b); }
__device__ __forceinline__ float max_of(float a, float b) { return fmaxf(a, b); }
// An accumulator as bits: a cut epilogue folds one into a sink, else ptxas
// drops the wgmmas whose results nothing reads.
__device__ __forceinline__ int bits_of(int v) { return v; }
__device__ __forceinline__ int bits_of(float v) { return __float_as_int(v); }

// ------------------------------------------------------------ shares

// A team's blocks: the thread block's contiguous share of all, in units of
// one block (of one sub-tile for the sub-tile epilogues), and the team's
// contiguous part of it. Every team makes the same number of steps, so that
// the loop around the wgmmas is the same for every thread; a step past the
// team's last block repeats the thread block's last block and its epilogue
// is skipped (real()).
struct Share {
  int first;  // the team's first block
  int end;    // one past its last
  int last;   // the thread block's last block
  int steps;
  __device__ __forceinline__ int block_of(int step) const { return min(first + step, last); }
  __device__ __forceinline__ bool real(int step) const { return first + step < end; }
};

__device__ __forceinline__ Share share_of(int nblocks, int unit, int teams, int team) {
  const int units = nblocks / unit;
  const int u0 = (int)((int64_t)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((int64_t)(blockIdx.x + 1) * units / gridDim.x);
  const int team_units = (u1 - u0 + teams - 1) / teams;
  const int t0 = min(u0 + team * team_units, u1);
  const int t1 = min(t0 + team_units, u1);
  return Share{t0 * unit, t1 * unit, u1 * unit - 1, team_units * unit};
}

// ---------------------------------------------- the penalties, once per block

// One warp's view of a block's penalties and the rows that stand in for the
// dominated ones. Every warp of a team reads the block's 128 penalties
// (lane l rows 4l .. 4l + 3), a step before ask() needs them (peek), and
// finds pmax with shuffles and the first row at pmax with a ballot: no
// barrier, and every warp holds the same plan.
template <int EPI>
struct PenStage {
  float ahead[4];   // peek(): the penalties of the block ask() comes to next
  float pen[4];     // those of the block asked for
  uint32_t dom;     // bit i: row 4 lane + i is dominated (fast blocks only)
  int first_top;    // the block's first row at pmax
  bool fast;
  float pmax;

  __device__ __forceinline__ void peek(const void* p, int block, int lane) {
    if constexpr (uses_pen(EPI)) {
      const int64_t row = (int64_t)block * kBlockRows + 4 * lane;
#pragma unroll
      for (int i = 0; i < 4; ++i) ahead[i] = pen_value<EPI>(p, row + i);
    }
  }

  __device__ __forceinline__ void ask() {
    fast = EPI != kTree2d;
    pmax = 0.f;
    dom = 0u;
    first_top = 0;
    if constexpr (uses_pen(EPI)) {
#pragma unroll
      for (int i = 0; i < 4; ++i) pen[i] = ahead[i];
      if constexpr (EPI != kTree2d) plan();
    }
  }

  // pmax, whether the block is fast, its dominated rows and first top row.
  __device__ __forceinline__ void plan() {
    float m = fmaxf(fmaxf(pen[0], pen[1]), fmaxf(pen[2], pen[3]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    bool ok = true;
    uint32_t below = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (EPI == kU8Max) {
        ok = ok && (pen[i] == 0.f || pen[i] == 1.f);
      } else {
        ok = ok && isfinite(pen[i]) && (pen[i] == m || pen[i] <= m - kDominance);
      }
      below |= (uint32_t)(pen[i] != m) << i;
    }
    fast = __all_sync(kFull, ok);
    pmax = m;
    dom = fast ? below : 0u;
    const uint32_t top_lanes = __ballot_sync(kFull, below != 0xFu);
    const int lane0 = max(__ffs(top_lanes) - 1, 0);
    const uint32_t below0 = __shfl_sync(kFull, below, lane0);
    first_top = 4 * lane0 + max(__ffs(~below0 & 0xFu) - 1, 0);
  }

  // The row whose bytes stand at row r of the tile. Called by whole warps.
  __device__ __forceinline__ int source_row(int r) const {
    if constexpr (!uses_pen(EPI) || EPI == kTree2d) {
      return r;
    } else {
      const uint32_t d = __shfl_sync(kFull, dom, r >> 2);
      return (d >> (r & 3)) & 1u ? first_top : r;
    }
  }

  // The raw penalties into a slot of 128 floats, for the per-element path.
  __device__ __forceinline__ void store(float* slot, int lane) const {
    *reinterpret_cast<float4*>(slot + 4 * lane) = make_float4(pen[0], pen[1], pen[2], pen[3]);
  }
};

// --------------------------------------------------------- the epilogues

struct Args {
  const int8_t* q;    // this launch's queries, (nq, 256) int8
  const float* qs;    // their scales
  int nq;
  const int8_t* db;   // (rows, 256) int8 ±1
  const void* pen;    // (rows,) bf16 bits or uint8
  int nblocks;
  int db_wrap;        // 0, or rows of db read again and again
  float* out;         // this launch's first output
  int64_t ld;         // floats between output rows
};

__device__ __forceinline__ int64_t src_row0(const Args& a, int block) {
  const int64_t row0 = (int64_t)block * kBlockRows;
  return a.db_wrap ? row0 % a.db_wrap : row0;
}

// Thread (warp w of its warpgroup, lane 4g + t) holds, for n-tile j,
// acc[4j], acc[4j + 1] = query 16w + g, rows 8j + 2t, 8j + 2t + 1, and
// acc[4j + 2], acc[4j + 3] = query 16w + g + 8 (ops/wgmma_layout.py).
__device__ __forceinline__ int tile_query(int first) {
  return first + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
}

// The block maxima of one finished tile (kBf16, kBf16NoPen, kTrans, kU8Max,
// kBf16Dot). Fast: the tile holds rows at pmax only, a plain maximum in two
// chains per query, one element per query. Else the per-element path with
// the raw penalties of `pen_slot`. Lane t = 0 stores the two queries'
// scores: into the block's slot of the gather, or (kTrans) straight into
// the (nblocks, nq) output.
template <int EPI, typename T>
__device__ __forceinline__ void finish_max(const T (&acc)[64], bool fast, float pmax, const float* pen_slot,
                                           const float* s_scale, int first, float* slot_out, const Args& a,
                                           int block) {
  const int t = threadIdx.x & 3;
  float ea, eb;
  if (fast) {
    T a0 = acc[0], a1 = acc[4], b0 = acc[2], b1 = acc[6];
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      a0 = max_of(a0, max_of(acc[4 * j], acc[4 * j + 1]));
      b0 = max_of(b0, max_of(acc[4 * j + 2], acc[4 * j + 3]));
      a1 = max_of(a1, max_of(acc[4 * j + 4], acc[4 * j + 5]));
      b1 = max_of(b1, max_of(acc[4 * j + 6], acc[4 * j + 7]));
    }
    ea = element<EPI>(quad_max(max_of(a0, a1)), pmax);
    eb = element<EPI>(quad_max(max_of(b0, b1)), pmax);
  } else {
    float va = -INFINITY, vb = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 p = *reinterpret_cast<const float2*>(pen_slot + 8 * j + 2 * t);
      va = fmaxf(va, fmaxf(general<EPI>(acc[4 * j], p.x), general<EPI>(acc[4 * j + 1], p.y)));
      vb = fmaxf(vb, fmaxf(general<EPI>(acc[4 * j + 2], p.x), general<EPI>(acc[4 * j + 3], p.y)));
    }
    ea = finish_general<EPI>(quad_max(va));
    eb = finish_general<EPI>(quad_max(vb));
  }
  if (t == 0) {
    const int qa = tile_query(first);
    const float sa = finalize<EPI>(ea, s_scale[qa]), sb = finalize<EPI>(eb, s_scale[qa + 8]);
    if (EPI == kTrans) {
      if (qa < a.nq) a.out[block * a.ld + qa] = sa;
      if (qa + 8 < a.nq) a.out[block * a.ld + qa + 8] = sb;
    } else {
      slot_out[qa * kOutStride] = sa;
      slot_out[(qa + 8) * kOutStride] = sb;
    }
  }
}

// kDotOnly*: the dots of rows 0-31 of a sub-tile's first block (n-tiles
// 0-3), straight into columns sub * 32 + r.
template <typename T>
__device__ __forceinline__ void store_first_dots(const T (&acc)[64], const Args& a, int block, int first) {
  if (block % kGroupBlocks) return;
  const int t = threadIdx.x & 3;
  const int qa = tile_query(first);
  float* col = a.out + (int64_t)(block / kGroupBlocks) * kClasses + 2 * t;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (qa + 8 * h < a.nq) {
        *reinterpret_cast<float2*>(col + (qa + 8 * h) * a.ld + 8 * j) =
            make_float2(exact_float(acc[4 * j + 2 * h]), exact_float(acc[4 * j + 2 * h + 1]));
      }
    }
  }
}

// kConsume: the thread's dots of its two queries, summed into its state.
__device__ __forceinline__ void add_sums(const int (&acc)[64], int (&sums)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sums[0] += acc[4 * j] + acc[4 * j + 1];
    sums[1] += acc[4 * j + 2] + acc[4 * j + 3];
  }
}

// kTree2d: the thread's classes 8m + 2t + c (rows 8j + 2t + c, m = j % 4)
// of its two queries: the maximum of the f32 sums dot + p, per class.
__device__ __forceinline__ void max_classes(const int (&acc)[64], const float* pen_slot, float (&cls)[2][8]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 p = *reinterpret_cast<const float2*>(pen_slot + 8 * j + 2 * t);
    const int m = j & 3;
    cls[0][2 * m] = fmaxf(cls[0][2 * m], general<kTree2d>(acc[4 * j], p.x));
    cls[0][2 * m + 1] = fmaxf(cls[0][2 * m + 1], general<kTree2d>(acc[4 * j + 1], p.y));
    cls[1][2 * m] = fmaxf(cls[1][2 * m], general<kTree2d>(acc[4 * j + 2], p.x));
    cls[1][2 * m + 1] = fmaxf(cls[1][2 * m + 1], general<kTree2d>(acc[4 * j + 3], p.y));
  }
}

// The end of a sub-tile: kConsume's sums into all 32 columns of the
// sub-tile (lane t its columns 8t .. 8t + 7), kTree2d's class maxima into
// their columns; the state starts anew.
template <int EPI>
__device__ __forceinline__ void flush_sub_tile(int (&sums)[2], float (&cls)[2][8], const float* s_scale,
                                               const Args& a, int block, int first) {
  const int t = threadIdx.x & 3;
  const int qa = tile_query(first);
  float* col = a.out + (int64_t)(block / kGroupBlocks) * kClasses;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qa + 8 * h;
    if (EPI == kConsume) {
      const float s = (float)quad_sum(sums[h]);
      sums[h] = 0;
      if (qi < a.nq) {
        float4* dst = reinterpret_cast<float4*>(col + qi * a.ld + 8 * t);
        dst[0] = make_float4(s, s, s, s);
        dst[1] = make_float4(s, s, s, s);
      }
    } else {
      if (qi < a.nq) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          *reinterpret_cast<float2*>(col + qi * a.ld + 8 * m + 2 * t) =
              make_float2(__fmaf_rn(round_bf16(cls[h][2 * m]), s_scale[qi], 0.5f),
                          __fmaf_rn(round_bf16(cls[h][2 * m + 1]), s_scale[qi], 0.5f));
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) cls[h][c] = -INFINITY;
    }
  }
}

// The gathered maxima of blocks [block - slot + first_slot, block] leave:
// the four lanes of a C row write its two queries' maxima, one sector per
// query; lane t = 0 gathered them, so the warp's own barrier is enough.
__device__ __forceinline__ void flush_gather(const float* s_out, const Args& a, int block, int slot, int first_slot,
                                             int first) {
  __syncwarp();
  const int t = threadIdx.x & 3;
  const int qa = tile_query(first);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qa + 8 * h;
    if (qi >= a.nq) continue;
    float* dst = a.out + qi * a.ld + block - slot;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 2 * t + c;
      if (j >= first_slot && j <= slot) dst[j] = s_out[qi * kOutStride + j];
    }
  }
}

// ------------------------------------------------------------ the kernels

// Dynamic shared memory of the int8 kernel: each team's two row tiles, the
// query tile (qc queries), their scales, each team's two penalty slots, its
// gather and its two mbarriers, and 1,024 bytes to align the row tiles (the
// swizzle's atoms start on 1,024 bytes).
__host__ __device__ constexpr int s8_smem_bytes(int qc) {
  return 2 * 2 * kS8TileBytes + kS8Chunks * qc * 16 + qc * 4 + 2 * 2 * kBlockRows * 4 + 2 * qc * kOutStride * 4 +
         2 * 2 * 8 + 1024;
}
// Of the bf16 kernel: one row tile, the bf16 query tile, scales, two
// penalty slots, the gather.
__host__ __device__ constexpr int bf16_smem_bytes(int qc) {
  return kBf16TileBytes + kBf16Chunks * qc * 16 + qc * 4 + 2 * kBlockRows * 4 + qc * kOutStride * 4;
}

// The rows of `block` into an int8 row tile: one TMA box of 128 bytes x 128
// rows per swizzle atom, both on one mbarrier. Issued by one thread.
__device__ __forceinline__ void fetch_rows(const Args& a, const CUtensorMap& rows_map, int block, uint8_t* tile,
                                           uint32_t bar) {
  const int row0 = (int)src_row0(a, block);
  mbar_expect_tx(bar, kBlockRows * kBits);
  const uint32_t tile_addr = smem_addr(tile);
#pragma unroll
  for (int h = 0; h < kBits / kSwizzleBytes; ++h) {
    tma_box(tile_addr + h * kS8Atom, rows_map, h * kSwizzleBytes, row0, bar);
  }
}

// Byte offset of 16-byte piece c (k-bytes 16c .. 16c + 15) of row r in the
// int8 row tile.
__device__ __forceinline__ int s8_piece(int r, int c) {
  return (c / 8) * kS8Atom + r * kSwizzleBytes + (((c % 8) ^ (r % 8)) * 16);
}

// After the block's rows landed: each dominated row (a fast block's plan,
// `dom` per lane as PenStage holds it) takes the bytes of the block's first
// row at pmax, piece by piece (thread t: pieces t + 256 j, row i / 16,
// chunk i % 16). The top row is never dominated, so nobody writes it.
template <int EPI>
__device__ __forceinline__ void substitute(uint8_t* tile, uint32_t dom, int first_top, int t) {
  if constexpr (uses_pen(EPI) && EPI != kTree2d) {
#pragma unroll
    for (int j = 0; j < kBlockRows * kS8Chunks / kTeamThreads; ++j) {
      const int i = t + j * kTeamThreads;
      const int r = i / kS8Chunks, c = i % kS8Chunks;
      const uint32_t d = __shfl_sync(kFull, dom, r >> 2);
      if ((d >> (r & 3)) & 1u) {
        *reinterpret_cast<uint4*>(tile + s8_piece(r, c)) =
            *reinterpret_cast<const uint4*>(tile + s8_piece(first_top, c));
      }
    }
  }
}

template <int EPI>
__global__ void __launch_bounds__(2 * kTeamThreads, 1)
variant_s8_kernel(Args a, const __grid_constant__ CUtensorMap rows_map) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int team = tid >> 8;
  const int member = (tid >> 7) & 1;  // this warpgroup within its team
  const int t = tid & (kTeamThreads - 1);
  const int lane = tid & 31;
  const int my_tiles = (a.nq + 2 * kTileQueries - 1) / (2 * kTileQueries);  // 1 or 2
  const int qc = my_tiles * 2 * kTileQueries;
  const uint32_t q_lbo = qc * 16;
  uint8_t* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);  // the row tiles' atoms on 1,024 bytes
  uint8_t* s_rows = base + team * 2 * kS8TileBytes;
  uint8_t* s_q = base + 2 * 2 * kS8TileBytes;
  float* s_scale = reinterpret_cast<float*>(s_q + kS8Chunks * q_lbo);
  float* s_pen = s_scale + qc + team * 2 * kBlockRows;
  float* s_out = s_scale + qc + 2 * 2 * kBlockRows + team * qc * kOutStride;
  // Each team's two mbarriers, one per row tile.
  const uint32_t s_bar = smem_addr(s_scale + qc + 2 * 2 * kBlockRows + 2 * qc * kOutStride) + team * 16;
  if (t == 0) {
    mbar_init(s_bar, 1);  // the arrive of expect_tx, plus the boxes' bytes
    mbar_init(s_bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The chunk's queries, zero past nq: piece (query qi, k-chunk c).
  for (int i = tid; i < qc * kS8Chunks; i += 2 * kTeamThreads) {
    const int qi = i % qc, c = i / qc;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (qi < a.nq) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(a.q + (int64_t)qi * kBits + c * 16);
      v = make_uint4(src[0], src[1], src[2], src[3]);
    }
    *reinterpret_cast<uint4*>(s_q + c * q_lbo + qi * 16) = v;
  }
  for (int i = tid; i < qc; i += 2 * kTeamThreads) s_scale[i] = i < a.nq ? a.qs[i] : 0.f;
  fence_proxy_async();
  __syncthreads();

  // From here the two teams run apart, each with its own row tiles,
  // penalty slots, gather and barrier. Every branch around a wgmma depends
  // only on the launch's arguments, and an accumulator is read only when no
  // wgmma of its warpgroup is in flight (else ptxas serializes the wgmmas).
  const Share sh = share_of(a.nblocks, sub_tile(EPI) ? kGroupBlocks : 1, 2, team);
  const uint32_t q_addr = smem_addr(s_q) + member * kTileQueries * 16;
  constexpr uint32_t kTileStep = 2 * kTileQueries * 16;  // this warpgroup's next tile
  PenStage<EPI> stage;
  stage.peek(a.pen, sh.block_of(0), lane);
  stage.ask();
  bool fast = stage.fast;  // the plan of the block whose tiles are next
  float pmax = stage.pmax;
  uint32_t dom = stage.dom;
  int first_top = stage.first_top;
  if (t == 0) fetch_rows(a, rows_map, sh.block_of(0), s_rows, s_bar);
  if (!stage.fast && t < 32) stage.store(s_pen, lane);
  stage.peek(a.pen, sh.block_of(1), lane);
  int sums[2][2] = {{0, 0}, {0, 0}};  // kConsume: per tile and query
  float cls[2][2][8];                 // kTree2d: per tile, query and class
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 8; ++c) cls[k][h][c] = -INFINITY;
  int acc[64];
  int sink = 0;  // kCutEpilogue only
  unsigned finished = 0, took_fast = 0;  // this team's blocks (g_path_blocks), thread t = 0

  for (int step = 0; step < sh.steps; ++step) {
    const int block = sh.block_of(step);
    uint8_t* tile = s_rows + (step & 1) * kS8TileBytes;
    const float* pen_slot = s_pen + (step & 1) * kBlockRows;
    // Every warp of the team is past the last block's wgmmas: the other row
    // tile is free, and the next block's rows go into it, two blocks in
    // flight. Then this block's rows, fetched a step ago, are whole, its
    // dominated rows are replaced, and the team sees the tile (second barrier).
    team_sync(team);
    stage.ask();
    const bool next_fast = stage.fast;
    const float next_pmax = stage.pmax;
    const uint32_t next_dom = stage.dom;
    const int next_first_top = stage.first_top;
    if (t == 0 && !kCutStaging) {
      fetch_rows(a, rows_map, sh.block_of(step + 1), s_rows + (~step & 1) * kS8TileBytes, s_bar + 8 * (~step & 1));
    }
    if (!next_fast && t < 32) stage.store(s_pen + (~step & 1) * kBlockRows, lane);
    stage.peek(a.pen, sh.block_of(step + 2), lane);
    if (!kCutStaging || step == 0) mbar_wait(s_bar + 8 * (step & 1), (step >> 1) & 1);
    substitute<EPI>(tile, dom, first_top, t);
    fence_proxy_async();
    team_sync(team);
    const bool real = sh.real(step);
    const int slot = block % kOutBlocks;
    const uint32_t b_addr = smem_addr(tile);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k < my_tiles) {
        // An opaque copy, so that the descriptors are recomputed at every
        // step: else ptxas keeps the query tiles' sixteen descriptors in
        // registers across the loop, and kTree2d's class state spills.
        uint32_t a_addr;
        asm volatile("mov.b32 %0, %1;\n" : "=r"(a_addr) : "r"(q_addr + k * kTileStep));
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < (kCutWgmma ? 0 : kS8Chunks / 2); ++ks) {
          wgmma_s8(acc, smem_desc(a_addr + 2 * ks * q_lbo, q_lbo, kSbo),
                   smem_desc_sw128(b_addr + ks / 4 * kS8Atom + ks % 4 * 32), ks > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_acc(acc);
        const int first = (member + 2 * k) * kTileQueries;
        if (kCutEpilogue) sink ^= bits_of(acc[0]);
        if (real && !kCutEpilogue) {
          if (EPI == kConsume) {
            add_sums(acc, sums[k]);
          } else if (EPI == kTree2d) {
            max_classes(acc, pen_slot, cls[k]);
          } else if (EPI == kDotOnly) {
            store_first_dots(acc, a, block, first);
          } else {
            finish_max<EPI>(acc, fast, pmax, pen_slot, s_scale, first, s_out + slot, a, block);
          }
        }
      }
    }
    if (finishes_max(EPI) && real && !kCutEpilogue && t == 0) {
      ++finished;
      took_fast += fast;
    }
    if (sub_tile(EPI) && real && !kCutEpilogue && block % kGroupBlocks == kGroupBlocks - 1) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k < my_tiles) flush_sub_tile<EPI>(sums[k], cls[k], s_scale, a, block, (member + 2 * k) * kTileQueries);
      }
    }
    if (gathers(EPI) && real && !kCutEpilogue && (slot == kOutBlocks - 1 || block == sh.end - 1)) {
      const int first_slot = max(slot - (block - sh.first), 0);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k < my_tiles) flush_gather(s_out, a, block, slot, first_slot, (member + 2 * k) * kTileQueries);
      }
    }
    fast = next_fast;
    pmax = next_pmax;
    dom = next_dom;
    first_top = next_first_top;
  }
  // The fetch begun at the last step, unused, lands before the thread block ends.
  if (t == 0 && !kCutStaging) mbar_wait(s_bar + 8 * (sh.steps & 1), (sh.steps >> 1) & 1);
  if (t == 0) add_path_blocks(finished, took_fast);
  if (kCutEpilogue && sink == INT_MIN) a.out[0] = 0.f;
}

// One thread's share of a block's int8 rows, read into registers a block
// ahead (thread t: pieces t + 256 j, row i / 16, 16-byte chunk i % 16).
template <int EPI>
__device__ __forceinline__ void read_rows(const Args& a, int block, const PenStage<EPI>& stage, int t,
                                          uint4 (&rows)[8]) {
  const int8_t* src = a.db + src_row0(a, block) * kBits;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = t + j * kTeamThreads;
    const int r = i / kS8Chunks, c = i % kS8Chunks;
    rows[j] = __ldg(reinterpret_cast<const uint4*>(src + (int64_t)stage.source_row(r) * kBits + c * 16));
  }
}

// 16 int8 values as 16 bf16 into k-chunks c and c + 1 of a row (or query)
// of a K-major bf16 tile.
__device__ __forceinline__ void land_bf16(uint4 v, uint8_t* chunk, int lbo) {
  const uint2 w0 = s8x4_bf16x4(v.x), w1 = s8x4_bf16x4(v.y), w2 = s8x4_bf16x4(v.z), w3 = s8x4_bf16x4(v.w);
  *reinterpret_cast<uint4*>(chunk) = make_uint4(w0.x, w0.y, w1.x, w1.y);
  *reinterpret_cast<uint4*>(chunk + lbo) = make_uint4(w2.x, w2.y, w3.x, w3.y);
}

template <int EPI>
__global__ void __launch_bounds__(kTeamThreads, 1) variant_bf16_kernel(Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int t = threadIdx.x;
  const int member = t >> 7;
  const int lane = t & 31;
  const int my_tiles = (a.nq + 2 * kTileQueries - 1) / (2 * kTileQueries);
  const int qc = my_tiles * 2 * kTileQueries;
  const uint32_t q_lbo = qc * 16;
  uint8_t* s_rows = smem;
  uint8_t* s_q = smem + kBf16TileBytes;
  float* s_scale = reinterpret_cast<float*>(s_q + kBf16Chunks * q_lbo);
  float* s_pen = s_scale + qc;
  float* s_out = s_pen + 2 * kBlockRows;

  // The chunk's queries in bf16: the 16 int8 values of piece (qi, c) are
  // k-chunks 2c and 2c + 1.
  for (int i = t; i < qc * kS8Chunks; i += kTeamThreads) {
    const int qi = i % qc, c = i / qc;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (qi < a.nq) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(a.q + (int64_t)qi * kBits + c * 16);
      v = make_uint4(src[0], src[1], src[2], src[3]);
    }
    land_bf16(v, s_q + 2 * c * q_lbo + qi * 16, q_lbo);
  }
  for (int i = t; i < qc; i += kTeamThreads) s_scale[i] = i < a.nq ? a.qs[i] : 0.f;

  const Share sh = share_of(a.nblocks, 1, 1, 0);
  const uint32_t q_addr = smem_addr(s_q) + member * kTileQueries * 16;
  constexpr uint32_t kTileStep = 2 * kTileQueries * 16;
  const uint32_t b_addr = smem_addr(s_rows);
  PenStage<EPI> stage;
  uint4 rows[8];
  stage.peek(a.pen, sh.block_of(0), lane);
  stage.ask();
  bool fast = stage.fast;
  float pmax = stage.pmax;
  read_rows<EPI>(a, sh.block_of(0), stage, t, rows);
  if (!stage.fast && t < 32) stage.store(s_pen, lane);
  stage.peek(a.pen, sh.block_of(1), lane);
  float acc[64];
  int sink = 0;  // kCutEpilogue only
  unsigned finished = 0, took_fast = 0;  // the blocks of g_path_blocks, thread 0

  for (int step = 0; step < sh.steps; ++step) {
    const int block = sh.block_of(step);
    const float* pen_slot = s_pen + (step & 1) * kBlockRows;
    // Both warpgroups are past the last block's wgmmas; the rows read a
    // step ago land in the tile as bf16 and are whole for all.
    __syncthreads();
    if (!kCutStaging || step == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = t + j * kTeamThreads;
        land_bf16(rows[j], s_rows + 2 * (i % kS8Chunks) * kBf16Lbo + (i / kS8Chunks) * 16, kBf16Lbo);
      }
    }
    fence_proxy_async();
    __syncthreads();
    stage.ask();
    const bool next_fast = stage.fast;
    const float next_pmax = stage.pmax;
    if (!kCutStaging) read_rows<EPI>(a, sh.block_of(step + 1), stage, t, rows);
    if (!next_fast && t < 32) stage.store(s_pen + (~step & 1) * kBlockRows, lane);
    stage.peek(a.pen, sh.block_of(step + 2), lane);
    const bool real = sh.real(step);
    const int slot = block % kOutBlocks;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k < my_tiles) {
        const uint32_t a_addr = q_addr + k * kTileStep;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < (kCutWgmma ? 0 : kBf16Chunks / 2); ++ks) {
          wgmma_bf16(acc, smem_desc(a_addr + 2 * ks * q_lbo, q_lbo, kSbo),
                     smem_desc(b_addr + 2 * ks * kBf16Lbo, kBf16Lbo, kSbo), ks > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_acc(acc);
        const int first = (member + 2 * k) * kTileQueries;
        if (kCutEpilogue) sink ^= bits_of(acc[0]);
        if (real && !kCutEpilogue) {
          if (EPI == kDotOnlyBf16) {
            store_first_dots(acc, a, block, first);
          } else {
            finish_max<EPI>(acc, fast, pmax, pen_slot, s_scale, first, s_out + slot, a, block);
          }
        }
      }
    }
    if (gathers(EPI) && real && !kCutEpilogue && (slot == kOutBlocks - 1 || block == sh.end - 1)) {
      const int first_slot = max(slot - (block - sh.first), 0);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k < my_tiles) flush_gather(s_out, a, block, slot, first_slot, (member + 2 * k) * kTileQueries);
      }
    }
    if (finishes_max(EPI) && real && !kCutEpilogue && t == 0) {
      ++finished;
      took_fast += fast;
    }
    fast = next_fast;
    pmax = next_pmax;
  }
  if (t == 0) add_path_blocks(finished, took_fast);
  if (kCutEpilogue && sink == INT_MIN) a.out[0] = 0.f;
}

// cuTensorMapEncodeTiled of the driver, reached through the runtime (the
// library links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The (nrows, 256) int8 rows as a 2-d tensor of bytes whose box is one
// swizzle atom of a block: 128 bytes x 128 rows, in the 128-byte swizzle.
int rows_map_of(const int8_t* db, int nrows, CUtensorMap* map) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)kBits, (cuuint64_t)nrows};
  const cuuint64_t strides[1] = {(cuuint64_t)kBits};
  const cuuint32_t box[2] = {(cuuint32_t)kSwizzleBytes, (cuuint32_t)kBlockRows};
  const cuuint32_t element_strides[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(db), dims, strides, box,
                              element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int EPI>
int launch_epi(const int8_t* q, const float* qs, int nq, const int8_t* db, const void* pen, int nblocks,
               int db_wrap, float* out, cudaStream_t s) {
  constexpr bool kBf16Units = bf16_mma(EPI);
  int device = 0;
  int sm_count = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap rows_map;
  if constexpr (kBf16Units) {
    err = cudaFuncSetAttribute(variant_bf16_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bf16_smem_bytes(kChunkQueries));
  } else {
    const int map_err = rows_map_of(db, nblocks * kBlockRows, &rows_map);
    if (map_err) return map_err;
    err = cudaFuncSetAttribute(variant_s8_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               s8_smem_bytes(kChunkQueries));
  }
  if (err != cudaSuccess) return (int)err;
  const int units = nblocks / (sub_tile(EPI) ? kGroupBlocks : 1);
  const dim3 grid(min(units, sm_count));
  for (int q0 = 0; q0 < nq; q0 += kChunkQueries) {
    const int chunk = min(nq - q0, kChunkQueries);
    const int qc = (chunk + 2 * kTileQueries - 1) / (2 * kTileQueries) * 2 * kTileQueries;
    const Args a{q + (int64_t)q0 * kBits, qs + q0, chunk, db, pen, nblocks, db_wrap,
                 out + (EPI == kTrans ? (int64_t)q0 : (int64_t)q0 * nblocks),
                 EPI == kTrans ? (int64_t)nq : (int64_t)nblocks};
    if constexpr (kBf16Units) {
      variant_bf16_kernel<EPI><<<grid, kTeamThreads, bf16_smem_bytes(qc), s>>>(a);
    } else {
      variant_s8_kernel<EPI><<<grid, 2 * kTeamThreads, s8_smem_bytes(qc), s>>>(a, rows_map);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// out <- variant epi of the (nq, 256) int8 queries q (4-byte aligned), (nq,)
// f32 scales qs, (nrows, 256) int8 rows db (16-byte aligned) and the
// (nrows,) penalty pen (bf16 bits, or uint8 for kU8Max); out is (nq, nrows /
// 128) f32, or (nrows / 128, nq) for kTrans. nrows % 128 == 0 (% 4096 for
// the sub-tile epilogues); db_wrap = 0, or a multiple of 128: row r reads db
// row r % db_wrap. Exact for ±1 rows and ±1/0 queries (every dot in [-256,
// 256]); for other values, or NaN penalties (a maximum of fmaxf drops a NaN,
// where the plain version's keeps it), the output is undefined. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int iscc_blockmax_variant(int epi, const void* q, const void* qs, int nq, const void* db,
                                     const void* pen, int nrows, int db_wrap, void* out,
                                     void* stream) {
  if (nq <= 0 || nrows <= 0) return 0;
  const bool group = epi >= kDotOnly;
  if (nrows % (kBlockRows * (group ? kGroupBlocks : 1)) || db_wrap < 0 || db_wrap % kBlockRows) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* qsp = static_cast<const float*>(qs);
  const auto* dbp = static_cast<const int8_t*>(db);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int nblocks = nrows / kBlockRows;
#define ISCC_EPI_CASE(E) \
  case E:                \
    return launch_epi<E>(qp, qsp, nq, dbp, pen, nblocks, db_wrap, op, s);
  switch (epi) {
    ISCC_EPI_CASE(kBf16)
    ISCC_EPI_CASE(kBf16NoPen)
    ISCC_EPI_CASE(kTrans)
    ISCC_EPI_CASE(kU8Max)
    ISCC_EPI_CASE(kBf16Dot)
    ISCC_EPI_CASE(kDotOnly)
    ISCC_EPI_CASE(kDotOnlyBf16)
    ISCC_EPI_CASE(kConsume)
    ISCC_EPI_CASE(kTree2d)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ISCC_EPI_CASE
}

// counts[0], counts[1] (uint64) <- g_path_blocks on the current device (the
// blocks whose maxima the launches since the last call finished, and those
// of them on the fast path), then clears them; waits for the stream.
extern "C" int iscc_blockmax_variant_paths(void* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  void* dev_counts = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&dev_counts, g_path_blocks);
  if (err == cudaSuccess) err = cudaMemcpyAsync(counts, dev_counts, sizeof(g_path_blocks), cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(dev_counts, 0, sizeof(g_path_blocks), s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return (int)err;
}
