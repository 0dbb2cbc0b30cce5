// Phase 1 of the exact NPHD scan on Hopper's int8 tensor cores: per-128-row
// block maxima of each query's score over one code-length partition, from
// ±1 int8 rows and mma.sync.m16n8k32 s8 x s8 -> s32.
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
// Shape: one thread block (four warps) per 128-row block. Its rows are
// staged once into shared memory as ±1 int8 (a copy from the twin, or an
// unpack of the packed words), each row padded by 16 bytes so that the B
// fragment loads hit 32 distinct banks. Then a loop over query tiles of 64:
// each warp takes 16 queries, builds their A fragments from the packed query
// words (zero past min_lanes), and runs 16 n-tiles (8 rows each) x nbits/32
// k-steps of m16n8k32 (the tile of mma_s8.cuh). Penalty and running max stay
// in registers; the four lanes that share a C row finish the max with
// __shfl_xor_sync.
//
// What bounds it on an H100: tensor-core issue fed from shared memory. Each
// m16n8k32 (4096 MACs) needs two 128-byte shared loads for its B fragment,
// so shared-memory bandwidth caps it near half the card's int8 peak. The twin
// entry also reads the twin's bytes, 8x the packed bytes (~2 GB per Q=512
// sweep at config 3, ~0.6 ms at 3.35 TB/s); the packed entry reads the
// packed rows and pays the in-kernel unpack instead. No wgmma, TMA or
// pipelining yet: overlap comes from several resident thread blocks per SM.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

using iscc_mma::kBlockRows;
using iscc_mma::kNTiles;
using iscc_mma::kQueryTile;
using iscc_mma::kRowPad;
using iscc_mma::kWarpQueries;
using iscc_mma::kWarps;
constexpr int kInvalidPenalty = 65536;

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

template <int LANES, bool PACKED>
__global__ void __launch_bounds__(kWarps * 32)
blockmax_mma_kernel(const int32_t* __restrict__ q, int q_stride,
                    const int32_t* __restrict__ min_lanes,
                    const float* __restrict__ q_scale, int nq,
                    const void* __restrict__ db,
                    const uint8_t* __restrict__ valid, int nblocks,
                    float* __restrict__ out) {
  constexpr int kBits = LANES * 32;
  constexpr int kStride = kBits + kRowPad;  // bytes per staged row
  __shared__ __align__(16) int8_t s_rows[kBlockRows * kStride];
  __shared__ uint8_t s_valid[kBlockRows];

  const int block = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // A/C row, B column within the tile
  const int t = lane & 3;   // k group of A/B, column pair of C

  // Stage the block's rows as ±1 int8, once for every query tile.
  if (PACKED) {
    const uint32_t* rows =
        static_cast<const uint32_t*>(db) + (int64_t)block * kBlockRows * LANES;
    for (int i = threadIdx.x; i < kBlockRows * LANES; i += blockDim.x) {
      const uint32_t r = __brev(__ldg(rows + i));
      uint4* dst = reinterpret_cast<uint4*>(s_rows + (i / LANES) * kStride +
                                            (i % LANES) * 32);
      dst[0] = make_uint4(pm1_of(r, 0), pm1_of(r, 1), pm1_of(r, 2), pm1_of(r, 3));
      dst[1] = make_uint4(pm1_of(r, 4), pm1_of(r, 5), pm1_of(r, 6), pm1_of(r, 7));
    }
  } else {
    constexpr int kVecs = kBits / 16;  // 16-byte vectors per twin row
    const uint4* rows =
        static_cast<const uint4*>(db) + (int64_t)block * kBlockRows * kVecs;
    for (int i = threadIdx.x; i < kBlockRows * kVecs; i += blockDim.x) {
      *reinterpret_cast<uint4*>(s_rows + (i / kVecs) * kStride + (i % kVecs) * 16) =
          __ldg(rows + i);
    }
  }
  for (int i = threadIdx.x; i < kBlockRows; i += blockDim.x) {
    s_valid[i] = valid[(int64_t)block * kBlockRows + i];
  }
  __syncthreads();

  // Validity of this lane's C columns: bit 2n + c <-> row 8n + 2t + c.
  uint32_t vmask = 0;
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) {
    vmask |= (s_valid[8 * n + 2 * t] ? 1u : 0u) << (2 * n);
    vmask |= (s_valid[8 * n + 2 * t + 1] ? 1u : 0u) << (2 * n + 1);
  }

  for (int q0 = warp * kWarpQueries; q0 < nq; q0 += kQueryTile) {
    // A fragments of queries q0 + g (regs 0, 2) and q0 + g + 8 (regs 1, 3):
    // k-step l is code word l; regs 0/1 hold k 4t..4t+3, regs 2/3 k 16+4t...
    const int qa = q0 + g;
    const int qb = qa + 8;
    const int mla = qa < nq ? max(0, min(min_lanes[qa], LANES)) : 0;
    const int mlb = qb < nq ? max(0, min(min_lanes[qb], LANES)) : 0;
    uint32_t a[LANES][4];
#pragma unroll
    for (int l = 0; l < LANES; ++l) {
      const uint32_t wa = l < mla ? __brev((uint32_t)q[(int64_t)qa * q_stride + l]) : 0u;
      const uint32_t wb = l < mlb ? __brev((uint32_t)q[(int64_t)qb * q_stride + l]) : 0u;
      a[l][0] = l < mla ? pm1_of(wa, t) : 0u;
      a[l][1] = l < mlb ? pm1_of(wb, t) : 0u;
      a[l][2] = l < mla ? pm1_of(wa, 4 + t) : 0u;
      a[l][3] = l < mlb ? pm1_of(wb, 4 + t) : 0u;
    }

    int best_a = INT_MIN;
    int best_b = INT_MIN;
#pragma unroll 4
    for (int n = 0; n < kNTiles; ++n) {
      // B fragment: column g is row 8n + g; k 4t..4t+3 and 16+4t...
      int c[4];
      iscc_mma::dot_tile(a, s_rows + (8 * n + g) * kStride + 4 * t, c);
      // C: c[0]/c[1] are query qa, rows 8n + 2t + {0, 1}; c[2]/c[3] query qb.
      const int p0 = (vmask >> (2 * n)) & 1u ? 0 : kInvalidPenalty;
      const int p1 = (vmask >> (2 * n + 1)) & 1u ? 0 : kInvalidPenalty;
      best_a = max(best_a, max(c[0] - p0, c[1] - p1));
      best_b = max(best_b, max(c[2] - p0, c[3] - p1));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      best_a = max(best_a, __shfl_xor_sync(0xffffffffu, best_a, off));
      best_b = max(best_b, __shfl_xor_sync(0xffffffffu, best_b, off));
    }
    if (t == 0) {
      if (qa < nq) {
        out[(int64_t)qa * nblocks + block] = __fmaf_rn((float)best_a, q_scale[qa], 0.5f);
      }
      if (qb < nq) {
        out[(int64_t)qb * nblocks + block] = __fmaf_rn((float)best_b, q_scale[qb], 0.5f);
      }
    }
  }
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
  const dim3 grid(nblocks);
  const dim3 threads(kWarps * 32);
#define ISCC_MMA_CASE(L)                                                   \
  case L:                                                                  \
    blockmax_mma_kernel<L, PACKED><<<grid, threads, 0, s>>>(              \
        qp, q_stride, ml, qs, nq, db, vp, nblocks, op);                    \
    break;
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
  return (int)cudaGetLastError();
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
