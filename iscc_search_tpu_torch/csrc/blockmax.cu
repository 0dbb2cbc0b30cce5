// Phase 1 of the exact NPHD scan on Hopper: per-128-row block maxima of
// each query's score over one code-length partition.
//
// Replaces the Pallas TPU kernels _scan_kernel_bitplane (128/256-bit
// partitions) and _scan_kernel_unpacked_perm (64/192-bit partitions) of
// iscc_search_tpu/ops/pallas_scan.py, reached through pallas_blockmax. It
// computes what they compute, not their layouts: those kernels read
// bit-transposed or row-permuted int8 twins of the database that exist for
// the TPU's matrix unit and its (8, 128) tiling. This kernel reads the
// compact packed partition (cap, lanes) directly and needs no twin.
//
// Arithmetic (the identity of iscc_search_tpu/ops/pm1_scan.py):
//   dot_pm1 = min_bits - 2 * popc((q ^ row) & prefix_mask),
//   min_bits = 32 * min_lanes, so the prefix mask covers whole lanes.
// An invalid row contributes dot - 65536 (the plain penalty of
// make_blockmax_penalty, kept in int32 here and never rounded to bf16), so
// a block with no valid row still orders below every real score. The
// block maximum m becomes 0.5 + m * q_scale rounded ONCE (__fmaf_rn), as the
// JAX phase-1 kernels produce it: where q_scale is not a power of two (a
// 192-bit common prefix, 1/384) a separately rounded multiply and add
// differs in the last bit. The plain PyTorch version computes the same
// single rounding in float64 (exact there) and rounds to float32 once.
//
// Shape: one warp per 128-row block, 4 rows per lane held in registers for
// the whole kernel, so the database is read exactly once; queries are
// staged through shared memory in tiles and each query's block maximum is a
// warp min-reduction of 2*popc + penalty via __shfl_xor_sync.
//
// What bounds it on an H100: integer issue, not memory. Each (query, row)
// pair costs `lanes` XOR/AND/POPC triples; POPC issues at 16 per clock per
// SM, so at 10.5M mixed-length rows and Q=512 the popcounts alone are
// ~3e10 operations (~8 ms), while the packed database is only ~0.3 GB. Its
// time grows with Q from the byte bound at Q=1 (86% of it on config 3), so
// the engine's scan_kernel="auto" keeps it for batches below 8 queries only:
// blockmax_small.cu (int8 tensor cores, rows unpacked in registers) takes 8
// to 128 queries and blockmax_mma.cu (wgmma) larger batches, the same
// function bit for bit (engine/device_index.py, auto_phase1; PERF.md,
// section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 128;
constexpr int kRowsPerLane = kBlockRows / 32;
constexpr int kWarps = 8;  // 128-row blocks per thread block
constexpr int kQueryTile = 64;
constexpr int kInvalidPenalty = 65536;

template <int LANES>
__global__ void __launch_bounds__(kWarps * 32)
blockmax_kernel(const int32_t* __restrict__ q, int q_stride,
                const int32_t* __restrict__ min_lanes,
                const float* __restrict__ q_scale, int nq,
                const int32_t* __restrict__ db,
                const uint8_t* __restrict__ valid, int nblocks,
                float* __restrict__ out) {
  __shared__ uint32_t s_q[kQueryTile][LANES];
  __shared__ int s_ml[kQueryTile];
  __shared__ float s_qs[kQueryTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int block = blockIdx.x * kWarps + warp;
  const bool active = block < nblocks;

  // This lane's rows: block*128 + r*32 + lane (neighbouring lanes read
  // neighbouring rows).
  uint32_t rows[kRowsPerLane][LANES];
  int pen[kRowsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerLane; ++r) {
    const int64_t row = (int64_t)block * kBlockRows + r * 32 + lane;
#pragma unroll
    for (int l = 0; l < LANES; ++l) {
      rows[r][l] = active ? (uint32_t)__ldg(db + row * LANES + l) : 0u;
    }
    pen[r] = (active && __ldg(valid + row)) ? 0 : kInvalidPenalty;
  }

  for (int q0 = 0; q0 < nq; q0 += kQueryTile) {
    const int nt = min(kQueryTile, nq - q0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < nt * LANES; i += blockDim.x) {
      const int qi = i / LANES;
      const int l = i - qi * LANES;
      s_q[qi][l] = (uint32_t)q[(int64_t)(q0 + qi) * q_stride + l];
    }
    for (int i = threadIdx.x; i < nt; i += blockDim.x) {
      s_ml[i] = min_lanes[q0 + i];
      s_qs[i] = q_scale[q0 + i];
    }
    __syncthreads();
    if (!active) continue;  // whole warp: no shuffle partner is left out

    for (int qi = 0; qi < nt; ++qi) {
      const int ml = max(0, min(s_ml[qi], LANES));
      uint32_t qw[LANES];
      uint32_t mask[LANES];
#pragma unroll
      for (int l = 0; l < LANES; ++l) {
        qw[l] = s_q[qi][l];
        mask[l] = l < ml ? 0xffffffffu : 0u;
      }
      // min over rows of 2*hamming + penalty  ==  32*ml - max(dot - penalty)
      int best = 0x7fffffff;
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        int h = 0;
#pragma unroll
        for (int l = 0; l < LANES; ++l) h += __popc((qw[l] ^ rows[r][l]) & mask[l]);
        best = min(best, 2 * h + pen[r]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
      }
      if (lane == 0) {
        const int m = 32 * ml - best;
        out[(int64_t)(q0 + qi) * nblocks + block] =
            __fmaf_rn((float)m, s_qs[qi], 0.5f);
      }
    }
  }
}

template <int LANES>
void launch(const int32_t* q, int q_stride, const int32_t* min_lanes,
            const float* q_scale, int nq, const int32_t* db,
            const uint8_t* valid, int nblocks, float* out,
            cudaStream_t stream) {
  const dim3 grid((nblocks + kWarps - 1) / kWarps);
  blockmax_kernel<LANES><<<grid, kWarps * 32, 0, stream>>>(
      q, q_stride, min_lanes, q_scale, nq, db, valid, nblocks, out);
}

}  // namespace

// out (nq, nblocks) f32 <- block maxima of the (cap = 128 * nblocks, lanes)
// packed partition db against the (nq, q_stride) packed queries q.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int iscc_blockmax(const void* q, int q_stride, const void* min_lanes,
                             const void* q_scale, int nq, const void* db,
                             const void* valid, int nblocks, int lanes,
                             void* out, void* stream) {
  if (nq <= 0 || nblocks <= 0) return 0;
  const auto* qp = static_cast<const int32_t*>(q);
  const auto* ml = static_cast<const int32_t*>(min_lanes);
  const auto* qs = static_cast<const float*>(q_scale);
  const auto* dbp = static_cast<const int32_t*>(db);
  const auto* vp = static_cast<const uint8_t*>(valid);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: launch<1>(qp, q_stride, ml, qs, nq, dbp, vp, nblocks, op, s); break;
    case 2: launch<2>(qp, q_stride, ml, qs, nq, dbp, vp, nblocks, op, s); break;
    case 3: launch<3>(qp, q_stride, ml, qs, nq, dbp, vp, nblocks, op, s); break;
    case 4: launch<4>(qp, q_stride, ml, qs, nq, dbp, vp, nblocks, op, s); break;
    case 5: launch<5>(qp, q_stride, ml, qs, nq, dbp, vp, nblocks, op, s); break;
    case 6: launch<6>(qp, q_stride, ml, qs, nq, dbp, vp, nblocks, op, s); break;
    case 7: launch<7>(qp, q_stride, ml, qs, nq, dbp, vp, nblocks, op, s); break;
    case 8: launch<8>(qp, q_stride, ml, qs, nq, dbp, vp, nblocks, op, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
