// Phase 1 of the exact NPHD scan on Hopper's int8 tensor cores: per-128-row
// block maxima of each query's score over one code-length partition, from
// ±1 int8 rows and wgmma.mma_async m64n128k32 s8 x s8 -> s32.
//
// Replaces three Pallas TPU kernels of iscc_search_tpu/ops/pallas_scan.py,
// reached through pallas_blockmax:
//   - _scan_kernel_unpacked (int8 dot over the plain ±1 int8 twin):
//     entry iscc_blockmax_mma_unpacked, rows read from the (cap, nbits) twin;
//   - _scan_kernel_packed and _scan_kernel_packed_perm (packed rows unpacked
//     in the kernel, bf16 dot): entry iscc_blockmax_mma_packed, rows read
//     from the (cap, lanes) packed partition and unpacked to ±1 int8 here.
//     The two TPU kernels differ only by the permute_packed_rows order that
//     Mosaic's (8, 128) tiling needed; this kernel reads rows in order.
// It is the tensor-core candidate for phase 1 (PERF.md, section 7) beside
// the XOR + popc kernel of blockmax.cu, which computes the same function.
//
// Arithmetic, that of blockmax.cu bit for bit: exact int32 ±1 dots (queries
// are zero past their common-prefix lanes, so the dot is min_bits - 2 * the
// prefix Hamming distance), an invalid row contributes dot - 65536, the max
// per 128-row block m becomes __fmaf_rn((float)m, q_scale, 0.5f).
//
// Shape: the queries stay in shared memory and the blocks stream past them.
// One persistent thread block per SM (four warpgroups) unpacks up to 512
// queries once into ±1 int8 (zero past min_lanes and past nq) and takes a
// contiguous share of the 128-row blocks. Its warpgroups form two teams,
// each with its own row tile, barrier and half of the share, so one team
// brings in rows while the other multiplies. A block's rows are wgmma's N,
// 64 queries its M, the code bits its K: one m64n128k32 covers 32 bits, a
// 256-bit block takes eight into 64 int32 accumulators per thread. Both
// operands are K-major in the no-swizzle core-matrix layout (8 rows x 16
// bytes = 128 contiguous bytes; ops/wgmma_layout.py mirrors it): element
// (row r, byte k) lies at (k / 16) * LBO + (r / 8) * 128 + (r % 8) * 16 +
// k % 16, so each 16-byte piece of a row, copied from the twin or unpacked
// from a packed word, goes where the layout wants it at any width.
//   - Tiles. A team's two warpgroups take every other 64-query tile of the
//     team's block. A warpgroup issues a tile's wgmmas, waits for them and
//     takes the maxima, with the other three warpgroups' wgmmas on the
//     tensor cores meanwhile and four warps per scheduler to hide its
//     latencies. (Two tiles in flight per warpgroup need 128 accumulator
//     registers, and ptxas serializes every wgmma when accumulators are read
//     in a loop that carries a wgmma in flight around its back edge, or
//     under a branch it cannot prove uniform: PERF.md, section 6.)
//   - Validity costs the epilogue nothing: on its way into the tile an
//     invalid row is replaced by the block's first valid row (RowStage), so
//     the epilogue is a plain maximum, one three-way max per two values,
//     and the four lanes of a C row finish with __shfl_xor_sync. With the
//     penalty taken per value (an add and a max, or the card's fused
//     VIADDMNMX) the epilogue took three times the integer instructions.
//   - Output. The scores of eight consecutive blocks (four at 256 bits) wait
//     in shared memory and leave as whole sectors of the (nq, nblocks)
//     output: written block by block, each 4-byte score is a request of its
//     own, and those requests alone set the kernel's pace (PERF.md, section 6).
//
// What bounds it on an H100: int8 tensor-core operations (4096 MACs per
// clock per SM, reached only by wgmma). With both operands read from shared
// memory (96 of its 128 bytes per clock at this shape) a wgmma takes ~80
// clocks where the peak allows 64. At 64 and 128 bits a block's fixed work
// (barriers, staging, the flush; ~1,500 clocks) is as long as its wgmmas
// (experiments/exp_wgmma_ablate.py times the kernel with each part cut out).
// The packed entry reads ahead into registers and pays the in-kernel
// unpack. The twin entry reads the twin's bytes, 8x the packed bytes, with
// cp.async: into a second row tile under the tiles of the block before,
// where shared memory has room for one beside the queries (up to 192 bits
// at Q = 512, any width at Q <= 256); else the teams take turns to wait for
// their copies. No TMA or producer warpgroup yet.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// Timing cuts (experiments/exp_wgmma_ablate.py): ISCC_ABLATE, defined only in
// a build of that script's own, is a mask of parts to leave out so that what
// is left can be timed. 0, the library's build, leaves nothing out; any
// other value computes something else than block maxima.
#ifndef ISCC_ABLATE
#define ISCC_ABLATE 0
#endif
constexpr bool kCutWgmma = ISCC_ABLATE & 1;     // no wgmma is issued
constexpr bool kCutEpilogue = ISCC_ABLATE & 2;  // the maxima loop stops after its first step
constexpr bool kCutStaging = ISCC_ABLATE & 4;   // rows enter the row tile at a team's first block only
constexpr bool kCutFlush = ISCC_ABLATE & 8;     // the gathered maxima are never written

constexpr int kBlockRows = 128;    // rows per block-max cell, wgmma's N
constexpr int kTileQueries = 64;   // wgmma's M
constexpr int kTeams = 2;          // pairs of warpgroups, each pair with its own row tile
constexpr int kTeamThreads = 256;
constexpr int kThreads = kTeams * kTeamThreads;
constexpr int kChunkQueries = 512;  // queries resident in shared memory at once
constexpr int kSbo = 128;           // bytes between 8-row groups: one core matrix
// Bytes between the 16-byte k-chunks of the row tile: a panel of 128 rows
// plus 16 bytes, so that the 16-byte pieces of one twin row (one chunk
// apart) fall on distinct banks.
constexpr int kRowsLbo = kBlockRows * 16 + 16;
constexpr int kInvalidPenalty = 65536;
// Consecutive blocks whose maxima a team gathers in shared memory before it
// writes them: eight blocks of a query are one 32-byte sector of the
// output. At 256 bits, and above 128 bits where twin rows want the room for
// a second row tile, shared memory has room for four.
template <int LANES, bool PACKED>
__host__ __device__ constexpr int out_blocks() { return LANES == 8 || (!PACKED && LANES > 4) ? 4 : 8; }
// Floats per query in the gather: odd, so that the writers' banks differ.
template <int LANES, bool PACKED>
__host__ __device__ constexpr int out_stride() { return out_blocks<LANES, PACKED>() + 1; }

#define ISCC_ACC8(d, i)                                                               \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),         \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define ISCC_ACC64(d)                                                                 \
  ISCC_ACC8(d, 0), ISCC_ACC8(d, 8), ISCC_ACC8(d, 16), ISCC_ACC8(d, 24), ISCC_ACC8(d, 32), \
      ISCC_ACC8(d, 40), ISCC_ACC8(d, 48), ISCC_ACC8(d, 56)

// The 64-bit shared-memory matrix descriptor of wgmma, no-swizzle layout
// (type 0 in bits 62-63): start address, leading (k-chunk) and stride
// (8-row group) byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D (64 x 128 int32, 64 registers per thread) = or += A (64 x 32 int8) x
// B (128 x 32 int8)^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : ISCC_ACC64(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Keeps the compiler from reading or moving an accumulator set across the
// wait that completes its wgmmas.
__device__ __forceinline__ void fence_acc(int (&d)[64]) { asm volatile("" : ISCC_ACC64(d)::"memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy writes to shared memory (st.shared, cp.async) before
// wgmma's reads of them through the async proxy.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Four ±1 int8 values (0x01 / 0xFF) from the low 4 bits of `nib`: byte i is
// +1 where bit i is set. The multiply copies the nibble to bits 0, 7, 14 and
// 21 without carries, so bit i lands on bit 8i.
__device__ __forceinline__ uint32_t nibble_pm1(uint32_t nib) {
  const uint32_t spread = (nib * 0x00204081u) & 0x01010101u;
  return (spread * 0xFEu) ^ 0xFFFFFFFFu;
}

// The ±1 int8 values of k-indices 4m..4m+3 of a code word, for a word whose
// bits were reversed (__brev): the codes are MSB-first, so k-index j is bit
// 31 - j of the stored word and bit j of the reversed one.
__device__ __forceinline__ uint32_t pm1_of(uint32_t reversed, int m) {
  return nibble_pm1((reversed >> (4 * m)) & 0xFu);
}

// One packed word as its two 16-byte k-chunks of ±1 int8.
__device__ __forceinline__ void store_word_pm1(uint8_t* chunk0, uint32_t lbo, uint32_t word) {
  const uint32_t r = __brev(word);
  *reinterpret_cast<uint4*>(chunk0) = make_uint4(pm1_of(r, 0), pm1_of(r, 1), pm1_of(r, 2), pm1_of(r, 3));
  *reinterpret_cast<uint4*>(chunk0 + lbo) = make_uint4(pm1_of(r, 4), pm1_of(r, 5), pm1_of(r, 6), pm1_of(r, 7));
}

// A team's barrier: its 256 threads, on the hardware barrier 1 + team.
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(team + 1) : "memory");
}

// The two teams' turns at a copy they must wait for (twin rows without a
// second row tile), on the hardware barriers 3 and 4: team 1 copies while
// team 0 multiplies, and team 0 while team 1 does. Left alone, all teams of
// all SMs fall into step: they copy at once, with the tensor cores idle and
// the memory saturated, then multiply at once, with the memory idle
// (PERF.md, section 6, has the times with and without the turns).
__device__ __forceinline__ void await_copy_turn(int team) {
  asm volatile("bar.sync %0, 512;\n" ::"r"(4 - team) : "memory");  // team 0 waits on 4, team 1 on 3
}
__device__ __forceinline__ void pass_copy_turn(int team) {
  asm volatile("bar.arrive %0, 512;\n" ::"r"(3 + team) : "memory");  // team 0 arrives on 3, team 1 on 4
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Waits until at most N of the thread's committed groups are still copying.
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// One team's way of bringing the rows of a 128-row block into its row tile;
// t is the thread's index in the team.
//
// Validity costs the epilogue nothing: where a block has a valid row, each
// invalid row is replaced, on its way into the tile, by the block's first
// valid row. A row that is there twice does not change the maximum, and the
// maximum over the valid rows is what the penalty leaves (an invalid row's
// dot - 65536 lies below any valid dot). A block without a valid row keeps
// its rows, and the penalty comes off its maximum (none_valid). Every warp
// reads the block's 128 validity bytes, four per lane, and finds the first
// valid row with a ballot; no barrier is needed.
//   - Packed rows: thread t owns row t % 128 and its lanes t / 128, + 2,
//     ...: peek() reads the validity bytes two blocks ahead, ask() reads
//     the row's words (of the row that stands in, for an invalid one) into
//     registers, under the tiles of the block before;
//     land() unpacks them into the tile, so a warp's stores cover
//     contiguous bytes.
//   - Twin rows (32 bytes per lane, too many for registers): ask() only
//     takes the validity bytes; copy() copies the block into a row tile
//     with cp.async, consecutive threads on consecutive 16-byte pieces, as
//     one group. Where shared memory has room for two row tiles per team,
//     the next block's copy runs under this block's tiles; else the team
//     waits for its copy, with the other team's wgmmas to fill the wait.
template <int LANES, bool PACKED>
struct RowStage {
  static constexpr int kChunks = 2 * LANES;
  static constexpr int kBlockBytes = kBlockRows * LANES * (PACKED ? 4 : 32);
  static constexpr int kWords = PACKED ? (LANES + 1) / 2 : 1;
  uint32_t words[kWords];
  uint32_t ahead_word;  // peek(): validity bytes 4 lane .. 4 lane + 3 of the block ask() comes to next
  uint32_t valid_word;  // the same of the block that was asked for
  int first_valid;  // the block's first valid row
  bool none_valid;

  // The row whose bytes stand at row r of the tile: r itself if it is valid
  // or no row is, else the block's first valid row. Called by whole warps.
  __device__ __forceinline__ int source_row(int r) const {
    const uint32_t mine = __shfl_sync(0xffffffffu, valid_word, r >> 2);
    const bool ok = (mine >> (8 * (r & 3))) & 0xFFu;
    return ok || none_valid ? r : first_valid;
  }

  // Reads a block's validity bytes a step before ask() needs them: the
  // ballot there waits for them, and a warp that waits issues nothing else.
  __device__ __forceinline__ void peek(const uint8_t* valid, int block, int t) {
    const uint8_t* v = valid + (int64_t)block * kBlockRows + 4 * (t & 31);
    ahead_word = (uint32_t)v[0] | (uint32_t)v[1] << 8 | (uint32_t)v[2] << 16 | (uint32_t)v[3] << 24;
  }

  // `block` is the block of the last peek().
  __device__ __forceinline__ void ask(const void* db, int block, int t) {
    valid_word = ahead_word;
    const uint32_t valid_lanes = __ballot_sync(0xffffffffu, valid_word != 0u);
    none_valid = valid_lanes == 0u;
    const int first_lane = max(__ffs(valid_lanes) - 1, 0);
    const uint32_t first_word = __shfl_sync(0xffffffffu, valid_word, first_lane);
    first_valid = 4 * first_lane +
                  ((first_word & 0xFFu) ? 0 : (first_word & 0xFF00u) ? 1 : (first_word & 0xFF0000u) ? 2 : 3);
    if (PACKED) {
      const uint32_t* row =
          static_cast<const uint32_t*>(db) + ((int64_t)block * kBlockRows + source_row(t & 127)) * LANES;
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const int l = (t >> 7) + 2 * j;
        words[j] = l < LANES ? __ldg(row + l) : 0u;
      }
    }
  }

  // Packed rows only: the words of the last ask() into the tile.
  __device__ __forceinline__ void land(int t, uint8_t* tile) {
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int l = (t >> 7) + 2 * j;
      if (l < LANES) store_word_pm1(tile + 2 * l * kRowsLbo + (t & 127) * 16, kRowsLbo, words[j]);
    }
  }

  // Twin rows only: `block` (the block of the last ask()) on its way into
  // the tile, as one committed cp.async group.
  __device__ __forceinline__ void copy(const void* db, int block, int t, uint8_t* tile) {
    const uint8_t* rows = static_cast<const uint8_t*>(db) + (int64_t)block * kBlockBytes;
    const uint32_t tile_addr = (uint32_t)__cvta_generic_to_shared(tile);
#pragma unroll
    for (int j = 0; j < kBlockRows * kChunks / kTeamThreads; ++j) {
      const int i = t + j * kTeamThreads;  // the tile's i-th 16-byte piece: row i / kChunks, chunk i % kChunks
      const int r = i / kChunks, c = i % kChunks;
      cp_async16(tile_addr + c * kRowsLbo + r * 16, rows + ((int64_t)source_row(r) * kChunks + c) * 16);
    }
    cp_async_commit();
  }
};

// The wgmmas of one 64-query tile against one row tile, as one group.
template <int LANES>
__device__ __forceinline__ void issue_tile(int (&acc)[64], uint32_t a_addr, uint32_t a_lbo, uint32_t b_addr) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < (kCutWgmma ? 0 : LANES); ++ks) {
    wgmma_m64n128k32(acc, smem_desc(a_addr + 2 * ks * a_lbo, a_lbo, kSbo),
                     smem_desc(b_addr + 2 * ks * kRowsLbo, kRowsLbo, kSbo), ks > 0);
  }
  wgmma_commit();
}

// Shares a maximum among the four lanes of a C row.
__device__ __forceinline__ int row_max(int v) {
  v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return max(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The block maxima of one finished tile. Thread (warp w, lane 4g + t) holds,
// for n-tile j, acc[4j], acc[4j + 1] = query 16w + g, rows 8j + 2t, 8j + 2t
// + 1, and acc[4j + 2], acc[4j + 3] = query 16w + g + 8. The tile holds
// valid rows only, or none (RowStage), so a plain maximum is all there is
// to take: one three-way max per two values, in two chains per query so
// that one does not wait for the one before it; `penalty` is 65536 for a
// block without a valid row, else 0. Lane t = 0 then stores the two
// queries' scores into the block's slot of the gather (`first` is the
// tile's first query within the chunk, `stride` floats per query).
__device__ __forceinline__ void finish_tile(const int (&acc)[64], int penalty, const float* s_scale, int first,
                                            float* slot_out, int stride) {
  int a0 = INT_MIN, a1 = INT_MIN, b0 = INT_MIN, b1 = INT_MIN;
#pragma unroll
  for (int j = 0; j < (kCutEpilogue ? 2 : 16); j += 2) {
    a0 = max(a0, max(acc[4 * j], acc[4 * j + 1]));
    b0 = max(b0, max(acc[4 * j + 2], acc[4 * j + 3]));
    a1 = max(a1, max(acc[4 * j + 4], acc[4 * j + 5]));
    b1 = max(b1, max(acc[4 * j + 6], acc[4 * j + 7]));
  }
  a0 = row_max(max(a0, a1)) - penalty;
  b0 = row_max(max(b0, b1)) - penalty;
  const int lane = threadIdx.x & 31;
  const int qa = first + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  if ((lane & 3) == 0) {
    slot_out[qa * stride] = __fmaf_rn((float)a0, s_scale[qa], 0.5f);
    slot_out[(qa + 8) * stride] = __fmaf_rn((float)b0, s_scale[qa + 8], 0.5f);
  }
}

// Dynamic shared memory: each team's row tiles (one, or two for twin rows
// where they fit), then the query tile (qc queries, qc a multiple of 128),
// the queries' scales and each team's gather of maxima.
template <int LANES>
__host__ __device__ constexpr int rows_bytes() { return 2 * LANES * kRowsLbo; }
template <int LANES, bool PACKED>
constexpr int smem_bytes(int qc, int row_tiles) {
  return kTeams * row_tiles * rows_bytes<LANES>() + 2 * LANES * qc * 16 + qc * 4 +
         kTeams * qc * out_stride<LANES, PACKED>() * 4;
}

template <int LANES, bool PACKED>
__global__ void __launch_bounds__(kThreads, 1)
blockmax_wgmma_kernel(const int32_t* __restrict__ q, int q_stride, const int32_t* __restrict__ min_lanes,
                      const float* __restrict__ q_scale, int nq, const void* __restrict__ db,
                      const uint8_t* __restrict__ valid, int nblocks, int row_tiles, float* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int team = tid >> 8;
  const int member = (tid >> 7) & 1;  // this warpgroup within its team
  const int t = tid & (kTeamThreads - 1);
  uint8_t* s_rows = smem + team * row_tiles * rows_bytes<LANES>();  // this team's row tile, or two
  uint8_t* s_q = smem + kTeams * row_tiles * rows_bytes<LANES>();
  const bool copy_ahead = !PACKED && row_tiles == 2;

  // The thread block's blocks are a contiguous share of all, and each of
  // its two teams takes a contiguous half, so that a team's maxima are
  // neighbours in the output. Both make the same number of steps, so that
  // the loop around the wgmmas is the same for every thread: with an odd
  // share, team 1's last step repeats the share's last block (the same
  // values stored twice).
  const int cta_first = (int)((int64_t)blockIdx.x * nblocks / gridDim.x);
  const int cta_end = (int)((int64_t)(blockIdx.x + 1) * nblocks / gridDim.x);
  const int steps = (cta_end - cta_first + kTeams - 1) / kTeams;
  const int team_first = min(cta_first + team * steps, cta_end - 1);
  auto block_of = [&](int step) { return min(team_first + step, cta_end - 1); };
  constexpr int kOut = out_blocks<LANES, PACKED>();
  constexpr int kOutStride = out_stride<LANES, PACKED>();
  RowStage<LANES, PACKED> stage;

  for (int q0 = 0; q0 < nq; q0 += kChunkQueries) {
    // A team's two warpgroups take tiles member, member + 2, ..., both the
    // same number: with an odd count the last of warpgroup 1 holds zero
    // queries, whose scores go nowhere.
    const int chunk_queries = min(nq - q0, kChunkQueries);
    const int my_tiles = (chunk_queries + 2 * kTileQueries - 1) / (2 * kTileQueries);
    const int qc = my_tiles * 2 * kTileQueries;
    const uint32_t q_lbo = qc * 16;  // bytes between the k-chunks of the query tile
    float* s_scale = reinterpret_cast<float*>(s_q + 2 * LANES * q_lbo);
    float* s_out = s_scale + qc + team * qc * kOutStride;
    __syncthreads();  // the previous chunk's tiles are done with the query tile

    // The chunk's queries as ±1 int8, zero past min_lanes and past nq.
    for (int i = tid; i < qc * LANES; i += kThreads) {
      const int qi = i % qc, l = i / qc;
      uint8_t* dst = s_q + 2 * l * q_lbo + qi * 16;
      const int qq = q0 + qi;
      if (qq < nq && l < min_lanes[qq]) {
        store_word_pm1(dst, q_lbo, (uint32_t)q[(int64_t)qq * q_stride + l]);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dst + q_lbo) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int i = tid; i < qc; i += kThreads) s_scale[i] = q0 + i < nq ? q_scale[q0 + i] : 0.f;
    fence_proxy_async();
    __syncthreads();

    // From here the two teams run apart, each with its own row tile and
    // barrier, and a warpgroup waits for each tile's wgmmas before it takes
    // the tile's maxima: with four warpgroups, three others have the tensor
    // cores meanwhile, and each scheduler has four warps to hide the
    // latency of a warp's chain of maxima. Every branch around a wgmma
    // depends only on the launch's arguments, and an accumulator is read
    // only when no wgmma of its warpgroup is in flight: ptxas serializes
    // wgmmas (a wait after each) under control flow it cannot prove
    // uniform, and when it finds accumulators read in a loop that carries
    // a wgmma in flight around its back edge.
    const uint32_t q_addr = (uint32_t)__cvta_generic_to_shared(s_q) + member * kTileQueries * 16;
    constexpr uint32_t kTileStep = 2 * kTileQueries * 16;  // this warpgroup's next tile
    int acc[64];
    stage.peek(valid, block_of(0), t);
    stage.ask(db, block_of(0), t);
    bool none_valid = stage.none_valid;  // of the block whose tiles are next
    if (copy_ahead) stage.copy(db, block_of(0), t, s_rows);
    stage.peek(valid, block_of(1), t);
    for (int step = 0; step < steps; ++step) {
      const int block = block_of(step);
      const bool staged = !kCutStaging || step == 0;
      uint8_t* tile = s_rows + (copy_ahead ? step & 1 : 0) * rows_bytes<LANES>();
      // Every warp of the team is past the last block's wgmmas and the
      // last flush (first barrier); then this block's rows land and are
      // whole for all (second). Past the last step, ask() and peek() read
      // the last block again, unused.
      team_sync(team);
      if (PACKED) {
        if (staged) stage.land(t, tile);
      } else if (copy_ahead) {
        cp_async_wait<0>();  // this block's copy, begun a step ago
      } else {
        // Team 0 copies first; from then on each team copies while the
        // other multiplies.
        if (team == 1 || step > 0) await_copy_turn(team);
        if (staged) stage.copy(db, block, t, tile);
        cp_async_wait<0>();
        if (team == 0 || step + 1 < steps) pass_copy_turn(team);
      }
      fence_proxy_async();
      team_sync(team);
      stage.ask(db, block_of(step + 1), t);
      const bool next_none_valid = stage.none_valid;
      // The next block's copy begins only now: the fence above would wait
      // for a copy in flight.
      if (copy_ahead && !kCutStaging) stage.copy(db, block_of(step + 1), t, s_rows + (~step & 1) * rows_bytes<LANES>());
      stage.peek(valid, block_of(step + 2), t);
      const int penalty = none_valid ? kInvalidPenalty : 0;
      none_valid = next_none_valid;
      const uint32_t b_addr = (uint32_t)__cvta_generic_to_shared(tile);
      const int slot = block % kOut;  // whole sectors where the output's rows start on one
      for (int k = 0; k < my_tiles; ++k) {
        issue_tile<LANES>(acc, q_addr + k * kTileStep, q_lbo, b_addr);
        wgmma_wait<0>();
        fence_acc(acc);
        finish_tile(acc, penalty, s_scale, (member + 2 * k) * kTileQueries, s_out + slot, kOutStride);
      }
      if (!kCutFlush && (slot == kOut - 1 || step + 1 == steps)) {
        // The gathered blocks [block - slot + first_slot, block] leave: kOut
        // neighbouring lanes write one query's maxima, a whole sector.
        const int first_slot = max(slot - (block - team_first), 0);
        team_sync(team);
        float* dst = out + (int64_t)q0 * nblocks + block - slot;
#pragma unroll 4
        for (int i = t; i < chunk_queries * kOut; i += kTeamThreads) {
          const int qi = i / kOut, j = i % kOut;
          if (j >= first_slot && j <= slot) dst[(int64_t)qi * nblocks + j] = s_out[qi * kOutStride + j];
        }
      }
    }
    if (copy_ahead) cp_async_wait<0>();  // the copy begun at the last step, unused
  }
}

template <int LANES, bool PACKED>
int launch_lanes(const int32_t* q, int q_stride, const int32_t* min_lanes, const float* q_scale, int nq,
                 const void* db, const uint8_t* valid, int nblocks, float* out, cudaStream_t stream) {
  constexpr int kPairQueries = 2 * kTileQueries;  // a team's two warpgroups take the same number of tiles
  const int qc = (min(nq, kChunkQueries) + kPairQueries - 1) / kPairQueries * kPairQueries;
  auto kernel = blockmax_wgmma_kernel<LANES, PACKED>;
  int device = 0;
  int smem_max = 0;
  int sm_count = 0;  // the persistent grid's size
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // Twin rows: a second row tile per team where it fits, for the next block's copy.
  const int row_tiles = !PACKED && smem_bytes<LANES, PACKED>(qc, 2) <= smem_max ? 2 : 1;
  const int bytes = smem_bytes<LANES, PACKED>(qc, row_tiles);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<min(nblocks, sm_count), kThreads, bytes, stream>>>(q, q_stride, min_lanes, q_scale, nq, db, valid,
                                                              nblocks, row_tiles, out);
  return (int)cudaGetLastError();
}

template <bool PACKED>
int launch(const void* q, int q_stride, const void* min_lanes,
           const void* q_scale, int nq, const void* db, const void* valid,
           int nblocks, int lanes, void* out, void* stream) {
  if (nq <= 0 || nblocks <= 0) return 0;
  const auto* qp = static_cast<const int32_t*>(q);
  const auto* ml = static_cast<const int32_t*>(min_lanes);
  const auto* qs = static_cast<const float*>(q_scale);
  const auto* vp = static_cast<const uint8_t*>(valid);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define ISCC_MMA_CASE(L) \
  case L: return launch_lanes<L, PACKED>(qp, q_stride, ml, qs, nq, db, vp, nblocks, op, s);
  switch (lanes) {
    ISCC_MMA_CASE(1)
    ISCC_MMA_CASE(2)
    ISCC_MMA_CASE(3)
    ISCC_MMA_CASE(4)
    ISCC_MMA_CASE(5)
    ISCC_MMA_CASE(6)
    ISCC_MMA_CASE(7)
    ISCC_MMA_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ISCC_MMA_CASE
}

// One bare wgmma tile over shared-memory images that the caller laid out
// (ops/wgmma_layout.py): the images are copied into shared memory as they
// are, ksteps m64n128k32 run over them with the descriptors' start address
// advanced by two k-chunks per step, and every thread writes its
// accumulators where the fragment layout of finish_tile says they belong.
__global__ void __launch_bounds__(128)
wgmma_tile_kernel(const uint8_t* __restrict__ a_image, int a_bytes, int a_lbo, int a_sbo,
                  const uint8_t* __restrict__ b_image, int b_bytes, int b_lbo, int b_sbo, int ksteps,
                  int32_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s_a = smem;
  uint8_t* s_b = smem + a_bytes;
  for (int i = threadIdx.x; i < a_bytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(s_a)[i] = reinterpret_cast<const uint4*>(a_image)[i];
  }
  for (int i = threadIdx.x; i < b_bytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(s_b)[i] = reinterpret_cast<const uint4*>(b_image)[i];
  }
  fence_proxy_async();
  __syncthreads();
  const uint32_t a_addr = (uint32_t)__cvta_generic_to_shared(s_a);
  const uint32_t b_addr = (uint32_t)__cvta_generic_to_shared(s_b);
  int acc[64];
  wgmma_fence();
  for (int ks = 0; ks < ksteps; ++ks) {
    wgmma_m64n128k32(acc, smem_desc(a_addr + 2 * ks * a_lbo, a_lbo, a_sbo),
                     smem_desc(b_addr + 2 * ks * b_lbo, b_lbo, b_sbo), ks > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  const int lane = threadIdx.x & 31;
  const int row = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    out[row * kBlockRows + 8 * j + col] = acc[4 * j];
    out[row * kBlockRows + 8 * j + col + 1] = acc[4 * j + 1];
    out[(row + 8) * kBlockRows + 8 * j + col] = acc[4 * j + 2];
    out[(row + 8) * kBlockRows + 8 * j + col + 1] = acc[4 * j + 3];
  }
}

}  // namespace

// out (nq, nblocks) f32 <- block maxima of the (cap = 128 * nblocks,
// nbits = 32 * lanes) ±1 int8 twin db (16-byte aligned) against the
// (nq, q_stride) packed queries q. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int iscc_blockmax_mma_unpacked(const void* q, int q_stride, const void* min_lanes,
                                          const void* q_scale, int nq, const void* db,
                                          const void* valid, int nblocks, int lanes,
                                          void* out, void* stream) {
  return launch<false>(q, q_stride, min_lanes, q_scale, nq, db, valid, nblocks, lanes, out, stream);
}

// The same from the (cap, lanes) packed partition db, as iscc_blockmax.
extern "C" int iscc_blockmax_mma_packed(const void* q, int q_stride, const void* min_lanes,
                                        const void* q_scale, int nq, const void* db,
                                        const void* valid, int nblocks, int lanes,
                                        void* out, void* stream) {
  return launch<true>(q, q_stride, min_lanes, q_scale, nq, db, valid, nblocks, lanes, out, stream);
}

// out (64, 128) int32 <- A (64 x 32 ksteps) x B (128 x 32 ksteps)^T from the
// two shared-memory images (16-byte aligned, a multiple of 16 bytes each,
// laid out with the given leading and stride byte offsets), 1 <= ksteps.
extern "C" int iscc_wgmma_tile(const void* a_image, int a_bytes, int a_lbo, int a_sbo, const void* b_image,
                               int b_bytes, int b_lbo, int b_sbo, int ksteps, void* out, void* stream) {
  if (ksteps <= 0 || a_bytes <= 0 || b_bytes <= 0 || a_bytes % 16 || b_bytes % 16) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(wgmma_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               a_bytes + b_bytes);
  if (err != cudaSuccess) return (int)err;
  wgmma_tile_kernel<<<1, 128, a_bytes + b_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a_image), a_bytes, a_lbo, a_sbo, static_cast<const uint8_t*>(b_image), b_bytes,
      b_lbo, b_sbo, ksteps, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
