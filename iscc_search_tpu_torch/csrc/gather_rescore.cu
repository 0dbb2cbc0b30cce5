// Phase 3 of the exact NPHD scan on Hopper: exact ±1 dots of each query
// against the rows of its top candidate 128-row blocks.
//
// Replaces the Pallas TPU kernel _gather_rescore_kernel of
// iscc_search_tpu/ops/pallas_scan.py (via pallas_gather_rescore), which
// gathers each candidate block from a plain ±1 int8 twin of the database
// (8x the packed bytes) with a scalar-prefetched BlockSpec, and
// _gather_rescore_packed_kernel (via pallas_gather_rescore_packed). Here the
// rows are read straight from the compact packed partition (cap, lanes); no
// twin exists.
//
// Output contract (that of pallas_gather_rescore): out[q, c] is the raw
// dot_pm1 of query q against row block_ids[q, c / 128] * 128 + c % 128,
// as f32, with dot_pm1 = 32 * min_lanes - 2 * popc((q ^ row) & prefix_mask).
// Column c of query q belongs to the (query, slot) pair p = q * kk + c / 128,
// so out is (Q * kk) pairs of 128 consecutive floats. Block ids may repeat
// within a query.
//
// Two forms compute it; the wrapper (ops/hopper_scan.py, gather_rescore)
// chooses by candidate reuse r = Q * kk / (cap / 128), the pairs per block
// of the partition:
//
// Query-major (iscc_gather_rescore): one 128-thread block per pair, one row
// per thread; neighbouring threads read neighbouring rows, so each pair's
// block is one contiguous 128 * lanes * 4-byte read. A block chosen by n
// queries is read n times. At low reuse (config 3 and config 4, r < 1)
// every block is read about once, and the scattered block reads and the
// store are all there is: it reads 66-77% of its bound there (PERF.md).
//
// Block-major (iscc_gather_rescore_blocks): each candidate block is read
// once for all the pairs that chose it. (a) The pairs are inverted on the
// card by a counting sort on the block id, written out here (no library
// sort or scan):
//   count_pairs    rank[p] = atomicAdd(&counts[block_ids[p]], 1), the
//                  pair's place in its block's list (any order of arrival);
//   sum_tiles      the counts summed per tile of kScanTile blocks;
//   scan_tiles     counts -> exclusive offsets in place, each tile adding
//                  the sums of the tiles before it;
//   scatter_pairs  sorted[offsets[b] + rank[p]] = (p, b).
// The counts are zeroed on the stream first (cudaMemsetAsync), so a CUDA
// graph replay starts from zero. (b) serve_blocks: the sorted list is cut
// into segments of kSegment pairs, one 128-thread block each, so a block
// chosen by every query is split over several thread blocks. A segment is
// a few runs of pairs of one block. Thread t keeps row t of the run's block
// in registers, loaded once per run, and the next run's rows are in flight
// while this run is served; per pair it reads the query's words from shared
// memory (a broadcast), and the thread block writes the pair's 128 floats,
// one coalesced 512-byte store. Every pair is written by exactly one thread
// block, so the output does not depend on the order the atomics gave the
// lists.
//
// What bounds it on an H100: bytes. At the product's limit-100 slice (Q=64,
// kk=4,096 on a ~17,900-block partition, r ~15) the output is 134 MB of
// f32 (0.040 ms at 3.35 TB/s), the distinct rows ~32 MB; the query-major
// form re-reads 537 MB of blocks from L2, the block-major form ~32 MB plus
// the inversion's passes over 262,144 pairs and the block counts. Without
// its row reads the serving stage takes the time of its stores alone; what
// it loses is the wait on each segment's first rows (PERF.md, section 6,
// measured with experiments/exp_gather_ablate.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Timing cuts (experiments/exp_gather_ablate.py): ISCC_GATHER_ABLATE,
// defined only in a build of that script's own, is a mask of parts of the
// block-major form to leave out so that what is left can be timed. 0, the
// library's build, leaves nothing out; any other value computes something
// else than the dots.
#ifndef ISCC_GATHER_ABLATE
#define ISCC_GATHER_ABLATE 0
#endif
constexpr bool kCutStore = ISCC_GATHER_ABLATE & 1;    // serving stores nothing (the dots are still computed)
constexpr bool kCutCompute = ISCC_GATHER_ABLATE & 2;  // serving loads no rows and counts no bits: the stores alone
constexpr bool kCutServe = ISCC_GATHER_ABLATE & 4;    // no serving launch: the inversion alone
constexpr bool kCutRows = ISCC_GATHER_ABLATE & 8;     // serving loads no rows (a constant per thread stands in)

constexpr int kBlockRows = 128;
constexpr int kSegment = 32;       // pairs of the sorted list per serving thread block
constexpr int kPairThreads = 256;  // threads per block of count_pairs / scatter_pairs
constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;     // consecutive block counts per scan thread
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kScanWarps = kScanThreads / 32;

// ------------------------------------------------------------ query-major

template <int LANES>
__global__ void __launch_bounds__(kBlockRows)
gather_rescore_kernel(const int32_t* __restrict__ q, int q_stride,
                      const int32_t* __restrict__ min_lanes,
                      const int32_t* __restrict__ block_ids, int kk,
                      const int32_t* __restrict__ db,
                      float* __restrict__ out) {
  const int64_t cand = blockIdx.x;  // q * kk + j
  const int qi = (int)(cand / kk);
  const int64_t row = (int64_t)__ldg(block_ids + cand) * kBlockRows + threadIdx.x;
  const int ml = max(0, min(__ldg(min_lanes + qi), LANES));
  int h = 0;
#pragma unroll
  for (int l = 0; l < LANES; ++l) {
    const uint32_t qw = (uint32_t)__ldg(q + (int64_t)qi * q_stride + l);
    const uint32_t rw = (uint32_t)__ldg(db + row * LANES + l);
    h += l < ml ? __popc(qw ^ rw) : 0;
  }
  out[cand * kBlockRows + threadIdx.x] = (float)(32 * ml - 2 * h);
}

template <int LANES>
void launch(const int32_t* q, int q_stride, const int32_t* min_lanes,
            const int32_t* block_ids, int nq, int kk, const int32_t* db,
            float* out, cudaStream_t stream) {
  const dim3 grid((unsigned)((int64_t)nq * kk));
  gather_rescore_kernel<LANES><<<grid, kBlockRows, 0, stream>>>(
      q, q_stride, min_lanes, block_ids, kk, db, out);
}

// ------------------------------------------------------------ block-major

// (a) The inversion of block_ids: a counting sort of the pairs by block.

__global__ void __launch_bounds__(kPairThreads)
count_pairs(const int32_t* __restrict__ block_ids, int npairs,
            int32_t* __restrict__ counts, int32_t* __restrict__ rank) {
  const int p = blockIdx.x * kPairThreads + threadIdx.x;
  if (p < npairs) rank[p] = atomicAdd(counts + __ldg(block_ids + p), 1);
}

// Exclusive prefix of v over the kScanThreads threads of the thread block;
// *total gets the block's sum. warp_sums: kScanWarps words of shared memory,
// free again when this returns.
__device__ __forceinline__ int block_exclusive(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += up;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kScanWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    if (lane < kScanWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[kScanWarps - 1];
  const int prefix = (warp ? warp_sums[warp - 1] : 0) + inc - v;
  __syncthreads();
  return prefix;
}

__global__ void __launch_bounds__(kScanThreads)
sum_tiles(const int32_t* __restrict__ counts, int nblocks,
          int32_t* __restrict__ tile_sums) {
  __shared__ int warp_sums[kScanWarps];
  const int64_t base = (int64_t)blockIdx.x * kScanTile + threadIdx.x;
  int s = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int64_t b = base + (int64_t)i * kScanThreads;
    s += b < nblocks ? counts[b] : 0;
  }
  int total;
  block_exclusive(s, warp_sums, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// counts -> exclusive offsets, in place: thread t of tile k takes the
// kScanItems blocks from k * kScanTile + t * kScanItems on. The tile moves
// through shared memory (one row of kScanItems + 1 words per thread, so the
// threads' rows fall in different banks), read and written coalesced.
__global__ void __launch_bounds__(kScanThreads)
scan_tiles(int32_t* __restrict__ counts, int nblocks,
           const int32_t* __restrict__ tile_sums) {
  __shared__ int warp_sums[kScanWarps];
  __shared__ int s_tile[kScanThreads * (kScanItems + 1)];
  const int t = threadIdx.x;
  const int64_t tile0 = (int64_t)blockIdx.x * kScanTile;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int idx = i * kScanThreads + t;  // the tile's idx-th block: thread idx / kScanItems, item idx % kScanItems
    s_tile[idx / kScanItems * (kScanItems + 1) + idx % kScanItems] = tile0 + idx < nblocks ? counts[tile0 + idx] : 0;
  }
  int earlier = 0;
  for (int i = t; i < (int)blockIdx.x; i += kScanThreads) earlier += tile_sums[i];
  int base;
  block_exclusive(earlier, warp_sums, &base);  // its barriers also publish s_tile
  int v[kScanItems];
  int own = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = s_tile[t * (kScanItems + 1) + i];
    own += v[i];
  }
  int tile_total;
  int run = base + block_exclusive(own, warp_sums, &tile_total);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    s_tile[t * (kScanItems + 1) + i] = run;
    run += v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int idx = i * kScanThreads + t;
    if (tile0 + idx < nblocks) counts[tile0 + idx] = s_tile[idx / kScanItems * (kScanItems + 1) + idx % kScanItems];
  }
}

__global__ void __launch_bounds__(kPairThreads)
scatter_pairs(const int32_t* __restrict__ block_ids, int npairs,
              const int32_t* __restrict__ offsets,
              const int32_t* __restrict__ rank, int2* __restrict__ sorted) {
  const int p = blockIdx.x * kPairThreads + threadIdx.x;
  if (p >= npairs) return;
  const int b = __ldg(block_ids + p);
  sorted[offsets[b] + rank[p]] = make_int2(p, b);
}

// (b) Serving: one thread block per segment of kSegment sorted pairs.

template <int LANES>
__device__ __forceinline__ void load_rows(const int32_t* __restrict__ db, int block, uint32_t (&r)[LANES]) {
  const int64_t row = (int64_t)block * kBlockRows + threadIdx.x;
#pragma unroll
  for (int l = 0; l < LANES; ++l) r[l] = kCutRows ? (uint32_t)(block + l) : (uint32_t)__ldg(db + row * LANES + l);
}

// The segment's entries are staged in shared memory by warp 0 (lane j the
// j-th pair: kSegment == 32), which also marks where each run of one block
// starts (a ballot). The thread block then walks the runs: while it serves
// run r from the rows in registers, the loads of run r + 1's rows are in
// flight. The first run's rows are asked for before the staging.
template <int LANES>
__global__ void __launch_bounds__(kBlockRows)
serve_blocks(const int32_t* __restrict__ q, int q_stride,
             const int32_t* __restrict__ min_lanes, int kk,
             const int32_t* __restrict__ db,
             const int2* __restrict__ sorted, int npairs,
             float* __restrict__ out) {
  static_assert(kSegment == 32, "warp 0 stages one pair per lane");
  constexpr int kQuads = (LANES + 3) / 4;
  __shared__ int4 s_entry[kSegment];  // pair, block, clamped min_lanes, -1
  __shared__ uint4 s_q[kSegment][kQuads];
  __shared__ uint32_t s_runs;
  const int t = threadIdx.x;
  const int begin = blockIdx.x * kSegment;
  const int n = min(kSegment, npairs - begin);
  uint32_t cur[LANES], nxt[LANES];
  if (!kCutCompute) load_rows<LANES>(db, __ldg(&sorted[begin].y), cur);
  if (t < 32) {
    const int2 e = t < n ? __ldg(&sorted[begin + t]) : make_int2(0, -1);
    const int before = __shfl_up_sync(0xffffffffu, e.y, 1);
    const uint32_t runs = __ballot_sync(0xffffffffu, t < n && (t == 0 || e.y != before));
    if (t < n) {
      const int qi = e.x / kk;
      s_entry[t] = make_int4(e.x, e.y, max(0, min(__ldg(min_lanes + qi), LANES)), -1);
      uint32_t w[4 * kQuads];
#pragma unroll
      for (int l = 0; l < 4 * kQuads; ++l) w[l] = l < LANES ? (uint32_t)__ldg(q + (int64_t)qi * q_stride + l) : 0u;
#pragma unroll
      for (int j = 0; j < kQuads; ++j) s_q[t][j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
    }
    if (t == 0) s_runs = runs;
  }
  __syncthreads();
  uint32_t runs = s_runs;
  while (runs) {  // uniform: every thread walks the same runs
    const int start = __ffs(runs) - 1;
    runs &= runs - 1;
    const int end = runs ? __ffs(runs) - 1 : n;
    if (runs && !kCutCompute) load_rows<LANES>(db, s_entry[end].y, nxt);
    for (int i = start; i < end; ++i) {
      const int4 e = s_entry[i];
      uint32_t qw[4 * kQuads];
#pragma unroll
      for (int j = 0; j < kQuads; ++j) {
        const uint4 v = s_q[i][j];
        qw[4 * j] = v.x;
        qw[4 * j + 1] = v.y;
        qw[4 * j + 2] = v.z;
        qw[4 * j + 3] = v.w;
      }
      int h = 0;
      if (kCutCompute) {
      } else if (e.z == LANES) {  // a full-length prefix, the common case: no masking
#pragma unroll
        for (int l = 0; l < LANES; ++l) h += __popc(qw[l] ^ cur[l]);
      } else {
#pragma unroll
        for (int l = 0; l < LANES; ++l) h += l < e.z ? __popc(qw[l] ^ cur[l]) : 0;
      }
      if (!kCutStore || h == e.w) {  // e.w is -1: a cut build still computes the dots it does not store
        __stcs(out + (int64_t)e.x * kBlockRows + t, (float)(32 * e.z - 2 * h));  // streamed: keeps the rows in L2
      }
    }
#pragma unroll
    for (int l = 0; l < LANES; ++l) cur[l] = nxt[l];
  }
}

template <int LANES>
void launch_serve(const int32_t* q, int q_stride, const int32_t* min_lanes,
                  int kk, const int32_t* db, const int2* sorted, int npairs,
                  float* out, cudaStream_t stream) {
  const unsigned grid = (unsigned)((npairs + kSegment - 1) / kSegment);
  serve_blocks<LANES><<<grid, kBlockRows, 0, stream>>>(q, q_stride, min_lanes, kk, db, sorted, npairs, out);
}

}  // namespace

// out (nq, kk * 128) f32 <- dots of the (nq, q_stride) packed queries q
// against the rows of their (nq, kk) candidate blocks of the (cap, lanes)
// packed partition db, one thread block per (query, candidate block).
// Returns cudaGetLastError() after the launch.
extern "C" int iscc_gather_rescore(const void* q, int q_stride,
                                   const void* min_lanes, const void* block_ids,
                                   int nq, int kk, const void* db, int lanes,
                                   void* out, void* stream) {
  if (nq <= 0 || kk <= 0) return 0;
  const auto* qp = static_cast<const int32_t*>(q);
  const auto* ml = static_cast<const int32_t*>(min_lanes);
  const auto* ids = static_cast<const int32_t*>(block_ids);
  const auto* dbp = static_cast<const int32_t*>(db);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: launch<1>(qp, q_stride, ml, ids, nq, kk, dbp, op, s); break;
    case 2: launch<2>(qp, q_stride, ml, ids, nq, kk, dbp, op, s); break;
    case 3: launch<3>(qp, q_stride, ml, ids, nq, kk, dbp, op, s); break;
    case 4: launch<4>(qp, q_stride, ml, ids, nq, kk, dbp, op, s); break;
    case 5: launch<5>(qp, q_stride, ml, ids, nq, kk, dbp, op, s); break;
    case 6: launch<6>(qp, q_stride, ml, ids, nq, kk, dbp, op, s); break;
    case 7: launch<7>(qp, q_stride, ml, ids, nq, kk, dbp, op, s); break;
    case 8: launch<8>(qp, q_stride, ml, ids, nq, kk, dbp, op, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The same output by the block-major form, for a partition of nblocks
// 128-row blocks. workspace: ws_words int32 words, 16-byte aligned, laid out
// as sorted (2 * P), rank (P), counts (nblocks), tile sums (ceil(nblocks /
// kScanTile)) for P = nq * kk pairs (ops/gather_layout.py,
// workspace_words). Returns the first error of the memset or the launches.
extern "C" int iscc_gather_rescore_blocks(const void* q, int q_stride,
                                          const void* min_lanes, const void* block_ids,
                                          int nq, int kk, const void* db, int nblocks,
                                          int lanes, void* workspace, long long ws_words,
                                          void* out, void* stream) {
  if (nq <= 0 || kk <= 0) return 0;
  if (lanes < 1 || lanes > 8 || nblocks <= 0) return (int)cudaErrorInvalidValue;
  const long long npairs = (long long)nq * kk;
  const long long ntiles = (nblocks + kScanTile - 1) / kScanTile;
  if (npairs > 0x7fffffffLL / 2 || ws_words < 3 * npairs + nblocks + ntiles ||
      reinterpret_cast<uintptr_t>(workspace) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int P = (int)npairs;
  auto* ws = static_cast<int32_t*>(workspace);
  auto* sorted = reinterpret_cast<int2*>(ws);
  int32_t* rank = ws + 2 * npairs;
  int32_t* counts = rank + npairs;
  int32_t* tile_sums = counts + nblocks;
  const auto* qp = static_cast<const int32_t*>(q);
  const auto* ml = static_cast<const int32_t*>(min_lanes);
  const auto* ids = static_cast<const int32_t*>(block_ids);
  const auto* dbp = static_cast<const int32_t*>(db);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);

  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * (size_t)nblocks, s);
  if (err != cudaSuccess) return (int)err;
  const unsigned pair_grid = (unsigned)((P + kPairThreads - 1) / kPairThreads);
  count_pairs<<<pair_grid, kPairThreads, 0, s>>>(ids, P, counts, rank);
  sum_tiles<<<(unsigned)ntiles, kScanThreads, 0, s>>>(counts, nblocks, tile_sums);
  scan_tiles<<<(unsigned)ntiles, kScanThreads, 0, s>>>(counts, nblocks, tile_sums);
  scatter_pairs<<<pair_grid, kPairThreads, 0, s>>>(ids, P, counts, rank, sorted);
  if (kCutServe) return (int)cudaGetLastError();
  switch (lanes) {
    case 1: launch_serve<1>(qp, q_stride, ml, kk, dbp, sorted, P, op, s); break;
    case 2: launch_serve<2>(qp, q_stride, ml, kk, dbp, sorted, P, op, s); break;
    case 3: launch_serve<3>(qp, q_stride, ml, kk, dbp, sorted, P, op, s); break;
    case 4: launch_serve<4>(qp, q_stride, ml, kk, dbp, sorted, P, op, s); break;
    case 5: launch_serve<5>(qp, q_stride, ml, kk, dbp, sorted, P, op, s); break;
    case 6: launch_serve<6>(qp, q_stride, ml, kk, dbp, sorted, P, op, s); break;
    case 7: launch_serve<7>(qp, q_stride, ml, kk, dbp, sorted, P, op, s); break;
    default: launch_serve<8>(qp, q_stride, ml, kk, dbp, sorted, P, op, s); break;
  }
  return (int)cudaGetLastError();
}
