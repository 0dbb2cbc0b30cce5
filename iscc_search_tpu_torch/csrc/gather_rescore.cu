// Phase 3 of the exact NPHD scan on Hopper: exact ±1 dots of each query
// against the rows of its top candidate 128-row blocks.
//
// Replaces the Pallas TPU kernel _gather_rescore_kernel of
// iscc_search_tpu/ops/pallas_scan.py (via pallas_gather_rescore), which
// gathers each candidate block from a plain ±1 int8 twin of the database
// (8x the packed bytes) with a scalar-prefetched BlockSpec. Here a thread
// block reads its block id itself and gathers the 128 rows straight from
// the compact packed partition (cap, lanes); no twin exists.
//
// Output contract (that of pallas_gather_rescore): out[q, c] is the raw
// dot_pm1 of query q against row block_ids[q, c / 128] * 128 + c % 128,
// as f32, with dot_pm1 = 32 * min_lanes - 2 * popc((q ^ row) & prefix_mask).
//
// Shape: one 128-thread block per (query, candidate block), one row per
// thread; neighbouring threads read neighbouring rows, so each candidate
// block is one contiguous 128 * lanes * 4-byte read.
//
// What bounds it on an H100: latency of the scattered block reads. At
// Q=512 and 16 candidate blocks per query a partition gathers 8192 blocks
// (at most 32 MB, largely from L2 across queries), a few microseconds of
// HBM bandwidth; the launch and the per-block load latency dominate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 128;

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

}  // namespace

// out (nq, kk * 128) f32 <- dots of the (nq, q_stride) packed queries q
// against the rows of their (nq, kk) candidate blocks of the (cap, lanes)
// packed partition db. Returns cudaGetLastError() after the launch.
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
