// The phase-1 epilogue probes of benchmarks/exp_kernels.py on Hopper's
// tensor cores: per-128-row block maxima (and the probes' other reductions)
// of 256-bit ±1 int8 rows against ±1/0 int8 queries.
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
//   kBf16Dot  the dot on the bf16 tensor cores (m16n8k16, f32 accumulate),
//             then fma(m(dot + f32(pen)));
//   kDotOnly / kDotOnlyBf16  the dot of row t*4096 + c, c < 32, per
//             4096-row sub-tile t; every other dot is computed and folded
//             into a value that is stored only if it is impossible, so
//             that no MMA is dead code;
//   kConsume  per sub-tile, the sum of bf16(dot) over its 4096 rows, in
//             each of its 32 columns (exact in f32 for ±1 rows);
//   kTree2d   per sub-tile and class c < 32, fma(max over rows c + 32i of
//             bf16(dot) + pen).
// m is a max over the 128 rows of a block, fma(m) = __fmaf_rn(m, qs, 0.5),
// the one rounding of the Pallas kernels in interpret mode. db_wrap != 0
// reads db row r % db_wrap for row r (the *_nodma probes: chunk 0 only).
//
// Shape: blockmax_mma.cu's (the tile of mma_s8.cuh). One thread block of
// four warps per 128-row block (per 4096-row sub-tile for the last three
// epilogues, which loop over its 32 blocks and keep per-query state in
// shared memory, each (query, class) owned by one lane). The rows are
// staged once into shared memory, 16-byte padded; each warp takes 16
// queries, A fragments straight from the int8 queries, 16 n-tiles x 8
// k-steps of mma.sync.m16n8k32 s8. The bf16 probes convert both operands
// to bf16 pairs on the fly and issue two m16n8k16 per s8 k-step, over the
// same k positions.
//
// What bounds it on an H100: the twin's bytes (2.68 GB at N = 10,485,760,
// 0.80 ms at 3.35 TB/s) against 6.9e11 int8 MACs (1.4e12 operations,
// 0.69 ms at the int8 peak): memory, if the MMA loop kept up (the *_nodma
// probes read 4 MB, so the operations bound them); blockmax_mma.cu's loop
// runs at a quarter of the int8 peak, so the loop and the epilogue are what
// the probes compare.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

using namespace iscc_mma;

constexpr int kGroupBlocks = 32;  // 4096-row sub-tile of the group probes
constexpr int kClasses = 32;
constexpr int kMaxSharedBytes = 232448;

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

// Two int8 values (bytes 2h, 2h + 1 of w) as a bf16 pair, the first in the
// low half.
__device__ __forceinline__ uint32_t s8x2_bf16x2(uint32_t w, int h) {
  const __nv_bfloat162 v = __floats2bfloat162_rn((float)(int8_t)(w >> (16 * h)),
                                                 (float)(int8_t)(w >> (16 * h + 8)));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// dot_tile over the bf16 tensor cores: each s8 k-step of the A and B
// registers becomes two m16n8k16 over the same k positions (bytes 0-1 of a
// word pair with A/B register 0, bytes 2-3 with register 2 / B register 1),
// both operands converted to bf16 pairs on the fly; f32 accumulation is
// exact for these integer dots.
__device__ __forceinline__ void dot_tile_bf16(const uint32_t (&a)[kSteps][4], const int8_t* brow,
                                              int (&c)[4]) {
  float f0 = 0.f, f1 = 0.f, f2 = 0.f, f3 = 0.f;
#pragma unroll
  for (int l = 0; l < kSteps; ++l) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t bw = *reinterpret_cast<const uint32_t*>(brow + 32 * l + 16 * half);
      asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(f0), "+f"(f1), "+f"(f2), "+f"(f3)
          : "r"(s8x2_bf16x2(a[l][2 * half], 0)), "r"(s8x2_bf16x2(a[l][2 * half + 1], 0)),
            "r"(s8x2_bf16x2(a[l][2 * half], 1)), "r"(s8x2_bf16x2(a[l][2 * half + 1], 1)),
            "r"(s8x2_bf16x2(bw, 0)), "r"(s8x2_bf16x2(bw, 1)));
    }
  }
  c[0] = (int)f0;
  c[1] = (int)f1;
  c[2] = (int)f2;
  c[3] = (int)f3;
}

template <int EPI>
__device__ __forceinline__ float pen_value(const void* pen, int64_t row) {
  if (EPI == kU8Max) return (float)static_cast<const uint8_t*>(pen)[row];
  return __uint_as_float((uint32_t) static_cast<const uint16_t*>(pen)[row] << 16);
}

// The element of the block max: bf16(dot) + pen rounded to bf16, or its
// f32 / u8 forms.
template <int EPI>
__device__ __forceinline__ float element(int dot, float pen) {
  if (EPI == kBf16NoPen) return (float)dot;
  if (EPI == kBf16Dot) return (float)dot + pen;
  if (EPI == kU8Max) {
    const int y = min(max((dot >> 1) + 127, 0), 255);
    return (float)((y * (int)pen) & 0xFF);
  }
  return round_bf16(round_bf16((float)dot) + pen);
}

template <int EPI>
__global__ void __launch_bounds__(kWarps * 32)
variant_kernel(const int8_t* __restrict__ q, const float* __restrict__ qs, int nq,
               const int8_t* __restrict__ db, const void* __restrict__ pen, int nblocks,
               int db_wrap, float* __restrict__ out) {
  constexpr bool kGroup = EPI >= kDotOnly;
  constexpr int kBlocks = kGroup ? kGroupBlocks : 1;
  constexpr bool kBf16Mma = EPI == kBf16Dot || EPI == kDotOnlyBf16;
  constexpr bool kUsesPen = EPI != kBf16NoPen && EPI != kDotOnly && EPI != kDotOnlyBf16 &&
                            EPI != kConsume;
  __shared__ __align__(16) int8_t s_rows[kBlockRows * kStride];
  __shared__ float s_pen[kBlockRows];
  extern __shared__ float s_state[];  // kConsume: [q]; kTree2d: [q * 32 + class]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  int sink = 0;  // kDotOnly*: max of the dots that are not stored

  if (EPI == kConsume || EPI == kTree2d) {
    const int n_state = nq * (EPI == kTree2d ? kClasses : 1);
    for (int i = threadIdx.x; i < n_state; i += blockDim.x) {
      s_state[i] = EPI == kTree2d ? -INFINITY : 0.f;
    }
  }

  for (int b = 0; b < kBlocks; ++b) {
    const int64_t blk = (int64_t)blockIdx.x * kBlocks + b;
    const int64_t row0 = blk * kBlockRows;
    const int64_t src0 = db_wrap ? row0 % db_wrap : row0;
    __syncthreads();  // the previous block's rows are consumed
    const uint4* rows = reinterpret_cast<const uint4*>(db + src0 * kBits);
    for (int i = threadIdx.x; i < kBlockRows * (kBits / 16); i += blockDim.x) {
      *reinterpret_cast<uint4*>(s_rows + (i / (kBits / 16)) * kStride + (i % (kBits / 16)) * 16) =
          __ldg(rows + i);
    }
    if (kUsesPen) {
      for (int i = threadIdx.x; i < kBlockRows; i += blockDim.x) {
        s_pen[i] = pen_value<EPI>(pen, row0 + i);
      }
    }
    __syncthreads();

    for (int q0 = warp * kWarpQueries; q0 < nq; q0 += kQueryTile) {
      const int qa = q0 + g;
      const int qb = qa + 8;
      uint32_t a[kSteps][4];
      load_a(q, qa, nq, t, a);

      float best_a = -INFINITY, best_b = -INFINITY;
      float sum_a = 0.f, sum_b = 0.f;
      float cls_a[4][2], cls_b[4][2];  // kTree2d: class 8m + 2t + i
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        cls_a[m][0] = cls_a[m][1] = cls_b[m][0] = cls_b[m][1] = -INFINITY;
      }
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        int c[4];
        if (kBf16Mma) {
          dot_tile_bf16(a, s_rows + (8 * n + g) * kStride + 4 * t, c);
        } else {
          dot_tile(a, s_rows + (8 * n + g) * kStride + 4 * t, c);
        }
        const int r = 8 * n + 2 * t;  // C columns r, r + 1
        if (EPI == kDotOnly || EPI == kDotOnlyBf16) {
          if (b == 0 && n < 4) {
            const int64_t col = (int64_t)blockIdx.x * kClasses + r;
            if (qa < nq) {
              out[(int64_t)qa * nblocks + col] = (float)c[0];
              out[(int64_t)qa * nblocks + col + 1] = (float)c[1];
            }
            if (qb < nq) {
              out[(int64_t)qb * nblocks + col] = (float)c[2];
              out[(int64_t)qb * nblocks + col + 1] = (float)c[3];
            }
          } else {
            sink = max(sink, max(max(c[0], c[1]), max(c[2], c[3])));
          }
        } else if (EPI == kConsume) {
          sum_a += round_bf16((float)c[0]) + round_bf16((float)c[1]);
          sum_b += round_bf16((float)c[2]) + round_bf16((float)c[3]);
        } else {
          const float p0 = kUsesPen ? s_pen[r] : 0.f;
          const float p1 = kUsesPen ? s_pen[r + 1] : 0.f;
          const float x0 = element<EPI>(c[0], p0), x1 = element<EPI>(c[1], p1);
          const float x2 = element<EPI>(c[2], p0), x3 = element<EPI>(c[3], p1);
          if (EPI == kTree2d) {
            cls_a[n & 3][0] = fmaxf(cls_a[n & 3][0], x0);
            cls_a[n & 3][1] = fmaxf(cls_a[n & 3][1], x1);
            cls_b[n & 3][0] = fmaxf(cls_b[n & 3][0], x2);
            cls_b[n & 3][1] = fmaxf(cls_b[n & 3][1], x3);
          } else {
            best_a = fmaxf(best_a, fmaxf(x0, x1));
            best_b = fmaxf(best_b, fmaxf(x2, x3));
          }
        }
      }

      if (EPI == kTree2d) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int cls = 8 * m + 2 * t + i;
            if (qa < nq) s_state[qa * kClasses + cls] = fmaxf(s_state[qa * kClasses + cls], cls_a[m][i]);
            if (qb < nq) s_state[qb * kClasses + cls] = fmaxf(s_state[qb * kClasses + cls], cls_b[m][i]);
          }
        }
      } else if (EPI == kConsume) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
          sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
        }
        if (t == 0) {
          if (qa < nq) s_state[qa] += sum_a;
          if (qb < nq) s_state[qb] += sum_b;
        }
      } else if (!kGroup) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          best_a = fmaxf(best_a, __shfl_xor_sync(0xffffffffu, best_a, off));
          best_b = fmaxf(best_b, __shfl_xor_sync(0xffffffffu, best_b, off));
        }
        if (t == 0) {
          const int qs_[2] = {qa, qb};
          const float best[2] = {best_a, best_b};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int qi = qs_[i];
            if (qi >= nq) continue;
            const float v = EPI == kU8Max ? (best[i] - 127.f) * 2.f : __fmaf_rn(best[i], qs[qi], 0.5f);
            if (EPI == kTrans) {
              out[blk * nq + qi] = v;
            } else {
              out[(int64_t)qi * nblocks + blk] = v;
            }
          }
        }
      }
    }
  }

  if (EPI == kConsume || EPI == kTree2d) {
    __syncthreads();
    for (int i = threadIdx.x; i < nq * kClasses; i += blockDim.x) {
      const int qi = i / kClasses;
      const int cls = i % kClasses;
      const float v = EPI == kConsume ? s_state[qi] : __fmaf_rn(s_state[i], qs[qi], 0.5f);
      out[(int64_t)qi * nblocks + (int64_t)blockIdx.x * kClasses + cls] = v;
    }
  }
  if (sink == INT_MAX) out[0] = 0.f;  // never: |dot| <= 256 * 128 * 128
}

template <int EPI>
int launch_epi(const void* q, const void* qs, int nq, const void* db, const void* pen, int nrows,
               int db_wrap, void* out, cudaStream_t s) {
  constexpr bool kGroup = EPI >= kDotOnly;
  const int nblocks = nrows / kBlockRows;
  const size_t state = EPI == kTree2d ? (size_t)nq * kClasses * sizeof(float)
                       : EPI == kConsume ? (size_t)nq * sizeof(float)
                                         : 0;
  if (state > (size_t)(kMaxSharedBytes - kBlockRows * kStride - kBlockRows * (int)sizeof(float))) {
    return (int)cudaErrorInvalidValue;
  }
  if (state) {
    const cudaError_t err = cudaFuncSetAttribute(
        variant_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)state);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(kGroup ? nblocks / kGroupBlocks : nblocks);
  variant_kernel<EPI><<<grid, kWarps * 32, state, s>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qs), nq,
      static_cast<const int8_t*>(db), pen, nblocks, db_wrap, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// out <- variant epi of the (nq, 256) int8 queries q, (nq,) f32 scales qs,
// (nrows, 256) int8 rows db (16-byte aligned) and the (nrows,) penalty pen
// (bf16 bits, or uint8 for kU8Max); out is (nq, nrows / 128) f32, or
// (nrows / 128, nq) for kTrans. nrows % 128 == 0 (% 4096 for the sub-tile
// epilogues); db_wrap = 0, or a multiple of 128: row r reads db row
// r % db_wrap. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int iscc_blockmax_variant(int epi, const void* q, const void* qs, int nq, const void* db,
                                     const void* pen, int nrows, int db_wrap, void* out,
                                     void* stream) {
  if (nq <= 0 || nrows <= 0) return 0;
  const bool group = epi >= kDotOnly;
  if (nrows % (kBlockRows * (group ? kGroupBlocks : 1)) || db_wrap < 0 || db_wrap % kBlockRows) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
#define ISCC_EPI_CASE(E) \
  case E:                \
    return launch_epi<E>(q, qs, nq, db, pen, nrows, db_wrap, out, s);
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
