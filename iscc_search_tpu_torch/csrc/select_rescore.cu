// Phases 2 and 3 of the exact NPHD scan on Hopper in one launch, for a
// small number of candidate blocks a query: the top-kk blocks by their
// phase-1 maxima, the exact rescore of their rows and the top-out_k rows.
//
// It replaces no TPU kernel: the JAX package runs phase 2 as lax.top_k and
// the final cut as lax.top_k over the Pallas gather's dots
// (iscc_search_tpu/ops/pallas_scan.py, pallas_blockmax_topk_impl). The
// port ran them as a chain of ~30 PyTorch calls per partition scan
// (topk_blocks_hier, the candidate rows and validity, gather_rescore, the
// score epilogue, torch.topk, torch.gather; ops/hopper_scan.py,
// select_rescore_topk_plain), whose host launches paced a search; this
// kernel is one launch in their place.
//
// One 256-thread block per query:
//
//   phase 2   Where the partition's nb blocks are whole super-blocks of 128
//             and more than 2 * kk of them (topk_blocks_hier's hierarchy),
//             one coalesced pass over the query's row of block maxima keeps
//             each super-block's maximum in shared memory (a warp per
//             super-block, a float4 a lane); the top-kk super-blocks are
//             selected among them, their kk * 128 block maxima loaded, and
//             the top-kk blocks selected among those. Otherwise one flat
//             selection over the row. A block holding a top-k row has a
//             maximum at or above the k-th score, and so has its
//             super-block, whichever of tied maxima a selection keeps: the
//             candidates hold the top-k scores exactly.
//   select    A selection is a radix select of the kk-th largest key (four
//             passes of 8-bit digits over the keys that share the prefix so
//             far; warp-aggregated shared-memory histograms), then an
//             ordered compaction of the keys above it and the first keys
//             equal to it. No sort: phase 3 needs the set.
//   phase 3   Each warp rescores whole candidate blocks, 32 rows a step: the
//             ±1 dot over the common prefix as gather_rescore computes it,
//             h = popc((q ^ row) & prefix), kept as a bin (h, or 257 for an
//             invalid row). The score 0.5 + (32 * ml - 2h) * q_scale is a
//             strictly decreasing function of the bin, so the final top-out_k
//             is a stable counting sort of the candidates by bin: per-warp
//             bin counts, one exclusive scan over (bin, warp), and each
//             candidate's place is its (bin, warp) base plus its rank among
//             the warp's earlier candidates of its bin. Candidates placed
//             below out_k are written: scores rounded as the chain rounds
//             them (product, then sum: __fmul_rn, __fadd_rn), rows, and
//             NEG_SCORE / -1 for invalid rows.
//
// Every step is deterministic: counts are sums, and ties are taken in a
// fixed order (by position in a selection, by warp and step in phase 3).
//
// What bounds it on an H100: bytes. The block maxima are read once (the
// whole row; the kk selected super-blocks' 512 bytes again, from L2) and
// the candidate rows once: at config 3's Q=512, kk=16, the four partitions'
// maxima are ~170 MB and their rows ~4 x 33 MB, ~0.09 ms at 3.35 TB/s.
// Shared memory holds the keys of at most kMaxCandidates candidates (32 KB
// of the 48 KB a block takes without opting in, with the per-warp bin
// counts beside it): the wrapper routes larger kk to the chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockRows = 128;       // rows per block-max cell
constexpr int kSuperBlock = 128;      // blocks per super-block of phase 2's hierarchy
constexpr int kMaxCandidates = 8192;  // candidate rows a query; FUSED_MAX_CANDIDATES of ops/hopper_scan.py
constexpr int kMaxKK = kMaxCandidates / kBlockRows;
constexpr int kSteps = kBlockRows / 32;  // phase-3 steps of 32 rows a candidate block
constexpr int kInvalidBin = 257;      // bin h <= 256 is a valid row at prefix Hamming distance h
constexpr int kBins = kInvalidBin + 1;
constexpr int kCounts = kBins * kWarps;
constexpr int kScanItems = (kCounts + kThreads - 1) / kThreads;
constexpr int kSuperUnroll = 8;       // super-blocks in flight per warp
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegScore = -1.0f;    // NEG_SCORE

struct Shared {
  // Phase 2: the ordered keys of a selection's inputs (super-block maxima,
  // then candidate block maxima); phase 3: the candidates' bins (uint16).
  uint32_t keys[kMaxCandidates];
  int counts[kCounts];  // phase 3: candidates by (bin, warp), then their places
  int hist[256];
  int warp_a[kWarps];
  int warp_b[kWarps];
  int sel_super[kMaxKK];
  int sel_block[kMaxKK];
  int digit;
  int remaining;
};

// A float's bits as an unsigned key of the same order.
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct SharedKeys {
  const uint32_t* k;
  __device__ __forceinline__ uint32_t operator()(int i) const { return k[i]; }
};

struct RowKeys {
  const float* row;
  __device__ __forceinline__ uint32_t operator()(int i) const { return order_key(__ldg(row + i)); }
};

// Exclusive prefix of v over the block's threads; *total gets the sum.
// Uses s.warp_a; every thread calls it.
__device__ __forceinline__ int block_exclusive(int v, Shared& s, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += up;
  }
  if (lane == 31) s.warp_a[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s.warp_a[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += up;
    }
    if (lane < kWarps) s.warp_a[lane] = w;
  }
  __syncthreads();
  *total = s.warp_a[kWarps - 1];
  const int prefix = (warp ? s.warp_a[warp - 1] : 0) + inc - v;
  __syncthreads();
  return prefix;
}

// The k-th largest of the n keys (1 <= k <= n), by radix select; *take_equal
// gets how many keys equal to it belong to the top k.
template <class Keys>
__device__ uint32_t kth_largest(const Keys& keys, int n, int k, Shared& s, int* take_equal) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t prefix = 0, mask = 0;
  int remaining = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += kThreads) s.hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += kThreads) {  // uniform: every lane meets the match
      const int i = base + threadIdx.x;
      int d = 256;  // no digit
      if (i < n) {
        const uint32_t key = keys(i);
        if ((key & mask) == prefix) d = (int)((key >> shift) & 255u);
      }
      const unsigned peers = __match_any_sync(kFull, d);
      if (d < 256 && lane == __ffs(peers) - 1) atomicAdd(&s.hist[d], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      // Lane l holds digits 255 - 8l down to 248 - 8l: all 256 in descending order.
      int c[8];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = s.hist[255 - 8 * lane - j];
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      int above = incl - sum;  // keys of the prefix with a larger digit
      if (above < remaining && remaining <= incl) {  // exactly one lane
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (above < remaining && remaining <= above + c[j]) {
            s.digit = 255 - 8 * lane - j;
            s.remaining = remaining - above;
          }
          above += c[j];
        }
      }
    }
    __syncthreads();
    prefix |= (uint32_t)s.digit << shift;
    mask |= 255u << shift;
    remaining = s.remaining;
  }
  *take_equal = remaining;
  return prefix;
}

// out[0, k) <- the positions of the top k keys: those above kth, then the
// first take_equal (by position) of those equal to it. Ends on a barrier.
template <class Keys>
__device__ void collect_top(const Keys& keys, int n, int k, uint32_t kth, int take_equal, int* out, Shared& s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned before = (1u << lane) - 1u;
  const int n_above = k - take_equal;
  int seen_above = 0, seen_equal = 0;
  for (int base = 0; base < n && (seen_above < n_above || seen_equal < take_equal); base += kThreads) {
    const int i = base + threadIdx.x;
    const uint32_t key = i < n ? keys(i) : 0u;
    const bool above = i < n && key > kth;
    const bool equal = i < n && key == kth;
    const unsigned a = __ballot_sync(kFull, above);
    const unsigned e = __ballot_sync(kFull, equal);
    if (lane == 0) {
      s.warp_a[warp] = __popc(a);
      s.warp_b[warp] = __popc(e);
    }
    __syncthreads();
    int ra = seen_above + __popc(a & before);
    int re = seen_equal + __popc(e & before);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int wa = s.warp_a[w], we = s.warp_b[w];
      if (w < warp) {
        ra += wa;
        re += we;
      }
      seen_above += wa;
      seen_equal += we;
    }
    if (above) {
      out[ra] = i;
    } else if (equal && re < take_equal) {
      out[n_above + re] = i;
    }
    __syncthreads();
  }
}

// s.keys[0, ns) <- the ordered keys of the maxima of the row's ns super-blocks.
__device__ void super_maxima(const float* __restrict__ row, int ns, Shared& s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4* row4 = reinterpret_cast<const float4*>(row);
  for (int first = warp; first < ns; first += kWarps * kSuperUnroll) {
    float4 v[kSuperUnroll];
#pragma unroll
    for (int u = 0; u < kSuperUnroll; ++u) {
      const int sb = first + u * kWarps;
      v[u] = sb < ns ? __ldcs(row4 + (int64_t)sb * (kSuperBlock / 4) + lane) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kSuperUnroll; ++u) {
      float m = fmaxf(fmaxf(v[u].x, v[u].y), fmaxf(v[u].z, v[u].w));
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, d));
      const int sb = first + u * kWarps;
      if (lane == 0 && sb < ns) s.keys[sb] = order_key(m);
    }
  }
}

// Phase 2: s.sel_block[0, kk) <- the query's top-kk block ids.
__device__ void select_blocks(const float* __restrict__ row, int nblocks, int kk, Shared& s) {
  const int ns = nblocks / kSuperBlock;
  int take;
  if (nblocks % kSuperBlock || ns <= 2 * kk || ns > kMaxCandidates) {
    // Ragged or too few super-blocks (topk_blocks_hier's flat case), or more
    // super-block maxima than shared memory holds: one selection over the row.
    const RowKeys keys{row};
    const uint32_t kth = kth_largest(keys, nblocks, kk, s, &take);
    collect_top(keys, nblocks, kk, kth, take, s.sel_block, s);
    return;
  }
  const SharedKeys keys{s.keys};
  super_maxima(row, ns, s);
  __syncthreads();
  uint32_t kth = kth_largest(keys, ns, kk, s, &take);
  collect_top(keys, ns, kk, kth, take, s.sel_super, s);
  const int nc = kk * kSuperBlock;
  for (int p = threadIdx.x; p < nc; p += kThreads) {
    s.keys[p] = order_key(__ldg(row + (int64_t)s.sel_super[p / kSuperBlock] * kSuperBlock + p % kSuperBlock));
  }
  __syncthreads();
  kth = kth_largest(keys, nc, kk, s, &take);
  collect_top(keys, nc, kk, kth, take, s.sel_block, s);
  if (threadIdx.x < kk) {
    const int p = s.sel_block[threadIdx.x];
    s.sel_block[threadIdx.x] = s.sel_super[p / kSuperBlock] * kSuperBlock + p % kSuperBlock;
  }
  __syncthreads();
}

template <int LANES>
__global__ void __launch_bounds__(kThreads)
select_rescore_kernel(const int32_t* __restrict__ q, int q_stride,
                      const int32_t* __restrict__ min_lanes,
                      const float* __restrict__ q_scale,
                      const float* __restrict__ block_max, int nblocks, int kk, int out_k,
                      const int32_t* __restrict__ db, const uint8_t* __restrict__ valid,
                      float* __restrict__ out_scores, int32_t* __restrict__ out_rows) {
  __shared__ Shared s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned before = (1u << lane) - 1u;
  const int qi = blockIdx.x;

  select_blocks(block_max + (int64_t)qi * nblocks, nblocks, kk, s);

  // Phase 3, pass 1: each candidate's bin, and the candidates by (bin, warp).
  const int ml = max(0, min(__ldg(min_lanes + qi), LANES));
  uint32_t qw[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) qw[l] = (uint32_t)__ldg(q + (int64_t)qi * q_stride + l);
  for (int i = threadIdx.x; i < kCounts; i += kThreads) s.counts[i] = 0;
  __syncthreads();  // the keys are free: phase 2 is done
  uint16_t* bins = reinterpret_cast<uint16_t*>(s.keys);
  for (int j = warp; j < kk; j += kWarps) {
    const int64_t first = (int64_t)s.sel_block[j] * kBlockRows + lane;
    uint32_t w[kSteps][LANES];
    uint8_t ok[kSteps];
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {  // every load of the block in flight first
      const int64_t row = first + r * 32;
#pragma unroll
      for (int l = 0; l < LANES; ++l) w[r][l] = (uint32_t)__ldg(db + row * LANES + l);
      ok[r] = __ldg(valid + row);
    }
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      int h = 0;
#pragma unroll
      for (int l = 0; l < LANES; ++l) h += l < ml ? __popc(qw[l] ^ w[r][l]) : 0;
      const int bin = ok[r] ? h : kInvalidBin;
      bins[j * kBlockRows + r * 32 + lane] = (uint16_t)bin;
      const unsigned peers = __match_any_sync(kFull, bin);
      if (lane == __ffs(peers) - 1) s.counts[bin * kWarps + warp] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();

  // The (bin, warp) counts -> the first place of each, in place.
  {
    int v[kScanItems];
    int own = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const int idx = threadIdx.x * kScanItems + i;
      v[i] = idx < kCounts ? s.counts[idx] : 0;
      own += v[i];
    }
    int total;
    int run = block_exclusive(own, s, &total);
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const int idx = threadIdx.x * kScanItems + i;
      if (idx < kCounts) s.counts[idx] = run;
      run += v[i];
    }
  }
  __syncthreads();

  // Pass 2: the same walk; each candidate's place, and the first out_k written.
  const float qs = __ldg(q_scale + qi);
  float* scores = out_scores + (int64_t)qi * out_k;
  int32_t* rows = out_rows + (int64_t)qi * out_k;
  for (int j = warp; j < kk; j += kWarps) {
    const int block = s.sel_block[j];
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      const int t = r * 32 + lane;
      const int bin = bins[j * kBlockRows + t];
      const unsigned peers = __match_any_sync(kFull, bin);
      int* place = &s.counts[bin * kWarps + warp];
      const int base = *place;
      __syncwarp();
      if (lane == __ffs(peers) - 1) *place = base + __popc(peers);
      __syncwarp();
      const int pos = base + __popc(peers & before);
      if (pos < out_k) {
        const bool ok = bin != kInvalidBin;
        scores[pos] = ok ? __fadd_rn(0.5f, __fmul_rn((float)(32 * ml - 2 * bin), qs)) : kNegScore;
        rows[pos] = ok ? block * kBlockRows + t : -1;
      }
    }
  }
}

template <int LANES>
void launch(const int32_t* q, int q_stride, const int32_t* min_lanes, const float* q_scale,
            const float* block_max, int nq, int nblocks, int kk, int out_k, const int32_t* db,
            const uint8_t* valid, float* out_scores, int32_t* out_rows, cudaStream_t stream) {
  select_rescore_kernel<LANES><<<(unsigned)nq, kThreads, 0, stream>>>(
      q, q_stride, min_lanes, q_scale, block_max, nblocks, kk, out_k, db, valid, out_scores, out_rows);
}

}  // namespace

// (out_scores, out_rows) (nq, out_k) f32 / int32 <- each query's top-out_k
// rows of its top-kk blocks by the (nq, nblocks) f32 phase-1 maxima
// block_max (16-byte aligned), rescored exactly against the (cap, lanes)
// packed partition db with validity valid (cap,) uint8: scores descending,
// NEG_SCORE and row -1 for invalid candidates. 1 <= kk <= min(nblocks, 64),
// 1 <= out_k <= kk * 128. Returns cudaGetLastError() after the launch.
extern "C" int iscc_select_rescore(const void* q, int q_stride, const void* min_lanes, const void* q_scale,
                                   const void* block_max, int nq, int nblocks, int kk, int out_k,
                                   const void* db, const void* valid, int lanes,
                                   void* out_scores, void* out_rows, void* stream) {
  if (nq <= 0) return 0;
  if (kk < 1 || kk > kMaxKK || kk > nblocks || out_k < 1 || out_k > kk * kBlockRows ||
      reinterpret_cast<uintptr_t>(block_max) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* qp = static_cast<const int32_t*>(q);
  const auto* ml = static_cast<const int32_t*>(min_lanes);
  const auto* qs = static_cast<const float*>(q_scale);
  const auto* bm = static_cast<const float*>(block_max);
  const auto* dbp = static_cast<const int32_t*>(db);
  const auto* vp = static_cast<const uint8_t*>(valid);
  auto* os = static_cast<float*>(out_scores);
  auto* orow = static_cast<int32_t*>(out_rows);
  auto s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: launch<1>(qp, q_stride, ml, qs, bm, nq, nblocks, kk, out_k, dbp, vp, os, orow, s); break;
    case 2: launch<2>(qp, q_stride, ml, qs, bm, nq, nblocks, kk, out_k, dbp, vp, os, orow, s); break;
    case 3: launch<3>(qp, q_stride, ml, qs, bm, nq, nblocks, kk, out_k, dbp, vp, os, orow, s); break;
    case 4: launch<4>(qp, q_stride, ml, qs, bm, nq, nblocks, kk, out_k, dbp, vp, os, orow, s); break;
    case 5: launch<5>(qp, q_stride, ml, qs, bm, nq, nblocks, kk, out_k, dbp, vp, os, orow, s); break;
    case 6: launch<6>(qp, q_stride, ml, qs, bm, nq, nblocks, kk, out_k, dbp, vp, os, orow, s); break;
    case 7: launch<7>(qp, q_stride, ml, qs, bm, nq, nblocks, kk, out_k, dbp, vp, os, orow, s); break;
    case 8: launch<8>(qp, q_stride, ml, qs, bm, nq, nblocks, kk, out_k, dbp, vp, os, orow, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
