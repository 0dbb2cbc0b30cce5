// Phase 1 of the NPHD scan from bit-plane twins on Hopper's int8 tensor
// cores: 0/1 int8 planes of 256-bit rows, mma.sync.m16n8k32 with the ±1/0
// int8 queries, dot_pm1 = 2 * dot01 - sum(q).
//
// Replaces two Pallas TPU kernels of benchmarks/:
//   - exp_bitplane_int8.py _kernel_variant (:53; make_variant :105,
//     pallas_call :118), all of its modes: entry iscc_blockmax_bitplane
//     reads the bit_transpose_packed twin (32-bit elements) with the script's
//     bf16 epilogue, x = bf16(bf16(2 * dot01 - qsum) + pen_bf16), block max,
//     __fmaf_rn(m, qs, 0.5);
//   - exp_bitplane_u8.py _kernel (:123; blockmax_subword_impl :152,
//     pallas_call :167): entry iscc_blockmax_subword reads the build_twin
//     sub-word twins (8- or 16-bit elements) with the script's int32
//     epilogue, x = dot01 + pen_i32 (0 / -32768), block max m, then
//     __fmaf_rn((float)(2m - qsum), qs, 0.5), equal to blockmax.cu.
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
//
// Shape: one thread block (four warps) per original 128-row block. It
// un-transposes the block's 4 KB of planes into shared memory as a
// (128 rows x 256) 0/1 int8 tile (a thread takes four consecutive u of one
// (b, j1) and writes one 32-bit word of four bytes per bit s), then runs
// blockmax_mma.cu's loop (mma_s8.cuh): each warp 16 queries, 16 n-tiles x
// 8 k-steps.
// qsum comes from the A fragments (__dp4a) and a shuffle over the 4 lanes
// of a row.
//
// What bounds it on an H100: 5.5e11 int8 MACs at N = 8,388,608, Q = 256
// (1.1e12 operations, 0.56 ms at the int8 peak) against 268 MB of twin
// (0.080 ms): the operations. The twin's element reads are 1-4 bytes each,
// at a stride of a view row: the 32 thread blocks of a group read each
// 32-byte sector between them, so L2 rather than device memory serves the
// repeats.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

using namespace iscc_mma;

constexpr int kGroupBlocks = 32;  // 128-row blocks per 4096-row group

template <int W>
struct Element;
template <>
struct Element<32> { using type = uint32_t; };
template <>
struct Element<16> { using type = uint16_t; };
template <>
struct Element<8> { using type = uint8_t; };

template <int W, bool BF16_EPI>
__global__ void __launch_bounds__(kWarps * 32)
bitplane_kernel(const int8_t* __restrict__ q, const float* __restrict__ qs, int nq,
                const void* __restrict__ twin, const void* __restrict__ pen, int nblocks,
                float* __restrict__ out) {
  using Elem = typename Element<W>::type;
  constexpr int kBands = 32 / W;
  constexpr int kViewRows = kBands * kBits;  // view rows per group
  __shared__ __align__(16) int8_t s_rows[kBlockRows * kStride];
  __shared__ float s_penf[kBlockRows];
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
    const int64_t p = (int64_t)grp * kGroupBlocks * kBlockRows + (r >> 2) * 128 + (r & 3) * 32 + j0;
    if (BF16_EPI) {
      s_penf[r] = __uint_as_float((uint32_t) static_cast<const uint16_t*>(pen)[p] << 16);
    } else {
      s_peni[r] = static_cast<const int32_t*>(pen)[p];
    }
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

    float fbest_a = -INFINITY, fbest_b = -INFINITY;
    int ibest_a = INT_MIN, ibest_b = INT_MIN;
#pragma unroll 4
    for (int n = 0; n < kNTiles; ++n) {
      int c[4];
      dot_tile(a, s_rows + (8 * n + g) * kStride + 4 * t, c);
      const int r = 8 * n + 2 * t;  // C columns r, r + 1
      if (BF16_EPI) {
        const float p0 = s_penf[r], p1 = s_penf[r + 1];
        fbest_a = fmaxf(fbest_a, fmaxf(round_bf16(round_bf16((float)(2 * c[0] - sum_a)) + p0),
                                       round_bf16(round_bf16((float)(2 * c[1] - sum_a)) + p1)));
        fbest_b = fmaxf(fbest_b, fmaxf(round_bf16(round_bf16((float)(2 * c[2] - sum_b)) + p0),
                                       round_bf16(round_bf16((float)(2 * c[3] - sum_b)) + p1)));
      } else {
        const int p0 = s_peni[r], p1 = s_peni[r + 1];
        ibest_a = max(ibest_a, max(c[0] + p0, c[1] + p1));
        ibest_b = max(ibest_b, max(c[2] + p0, c[3] + p1));
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      fbest_a = fmaxf(fbest_a, __shfl_xor_sync(0xffffffffu, fbest_a, off));
      fbest_b = fmaxf(fbest_b, __shfl_xor_sync(0xffffffffu, fbest_b, off));
      ibest_a = max(ibest_a, __shfl_xor_sync(0xffffffffu, ibest_a, off));
      ibest_b = max(ibest_b, __shfl_xor_sync(0xffffffffu, ibest_b, off));
    }
    if (t == 0) {
      const float ma = BF16_EPI ? fbest_a : (float)(2 * ibest_a - sum_a);
      const float mb = BF16_EPI ? fbest_b : (float)(2 * ibest_b - sum_b);
      if (qa < nq) out[(int64_t)qa * nblocks + blk] = __fmaf_rn(ma, qs[qa], 0.5f);
      if (qb < nq) out[(int64_t)qb * nblocks + blk] = __fmaf_rn(mb, qs[qb], 0.5f);
    }
  }
}

template <int W, bool BF16_EPI>
int launch(const void* q, const void* qs, int nq, const void* twin, const void* pen, int nrows,
           void* out, void* stream) {
  if (nq <= 0 || nrows <= 0) return 0;
  if (nrows % (kGroupBlocks * kBlockRows)) return (int)cudaErrorInvalidValue;
  const int nblocks = nrows / kBlockRows;
  bitplane_kernel<W, BF16_EPI><<<nblocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qs), nq, twin, pen, nblocks,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// out (nq, nrows / 128) f32 <- block maxima of the (nrows / 16, 128) u32
// bit_transpose_packed twin of 256-bit rows against the (nq, 256) int8
// ±1/0 queries q, (nq,) f32 scales qs and the (nrows,) bf16 penalty in
// bitplane_penalty_perm order; nrows % 4096 == 0. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int iscc_blockmax_bitplane(const void* q, const void* qs, int nq, const void* twin,
                                      const void* pen, int nrows, void* out, void* stream) {
  return launch<32, true>(q, qs, nq, twin, pen, nrows, out, stream);
}

// The same from a build_twin sub-word twin of width_bits 8 or 16 and an
// (nrows,) int32 penalty in penalty_perm order, with the int32 epilogue.
extern "C" int iscc_blockmax_subword(const void* q, const void* qs, int nq, const void* twin,
                                     const void* pen, int nrows, int width_bits, void* out,
                                     void* stream) {
  if (width_bits == 8) return launch<8, false>(q, qs, nq, twin, pen, nrows, out, stream);
  if (width_bits == 16) return launch<16, false>(q, qs, nq, twin, pen, nrows, out, stream);
  return (int)cudaErrorInvalidValue;
}
