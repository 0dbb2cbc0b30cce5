// The int4 probe of benchmarks/exp_int4.py on Hopper's s4 tensor cores:
// dots of 256-element int4 rows with int4 queries, mma.sync.m16n8k64
// s4 x s4 -> s32.
//
// Replaces the Pallas TPU kernel of benchmarks/exp_int4.py (main :38,
// pallas_call :100, inline body kern :89), and stands in for its XLA int4
// dot_general (dot4, :54), which PyTorch has no counterpart of:
//   - iscc_int4_dot: the full (nq, nrows) int32 dot;
//   - iscc_int4_probe: the Pallas probe's (nq, nrows / 128) f32 output,
//     column i * 128 + j = dot of row i * chunk + j for j < 128. Every row
//     is dotted; the dots that are not stored fold into a value that is
//     stored only if it is impossible, so that no MMA is dead code.
// Operands are int4 twins (ops/bitplane.py build_int4_twin): 128 bytes per
// row, element 2m in the low nibble of byte m, the order mma.sync reads .s4
// values from a register (element i in bits 4i..4i+3).
//
// Shape: no shared memory. A warp owns 64 consecutive rows (eight n-tiles
// of 8); for each n-tile, lane (g, t) loads bytes [32t, 32t + 32) of row g
// (two 16-byte loads) as its B registers for all four k-steps, and the A
// fragments of each 16-query tile come from the same bytes of the queries:
// k-step l pairs word 2l (A reg 0/1, B reg 0) and word 2l + 1 (A reg 2/3,
// B reg 1) of those 32 bytes. The dot sums over k, so this order of k (the
// same for A and B) gives the exact dot. Queries past nq are zero rows of
// the m16 tile (Q = 8 fills half of it).
//
// What bounds it on an H100: bytes. At N = 1,048,576 the twin is 134 MB
// (0.040 ms at 3.35 TB/s) and the full dot's (8, N) int32 output another
// 34 MB; its 5.4e8 int4 MACs are nothing beside them.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kRowBytes = 128;  // 256 int4 values
constexpr int kWarps = 8;
constexpr int kWarpRows = 64;
constexpr int kBlockRows = kWarps * kWarpRows;
constexpr int kProbeCols = 128;

__device__ __forceinline__ void load32(const uint8_t* p, uint32_t (&w)[8]) {
  const uint4 lo = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 hi = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
  w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

template <bool PROBE>
__global__ void __launch_bounds__(kWarps * 32)
int4_kernel(const uint8_t* __restrict__ q, int nq, const uint8_t* __restrict__ db, int nrows,
            int chunk, void* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t warp_row0 = (int64_t)blockIdx.x * kBlockRows + warp * kWarpRows;
  int sink = 0;

  for (int nt = 0; nt < kWarpRows / 8; ++nt) {
    const int64_t r0 = warp_row0 + 8 * nt;
    if (r0 >= nrows) break;
    uint32_t b[8];
    load32(db + (r0 + g) * kRowBytes + 32 * t, b);
    for (int m0 = 0; m0 < nq; m0 += 16) {
      const int qa = m0 + g;
      const int qb = qa + 8;
      uint32_t aa[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      uint32_t ab[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      if (qa < nq) load32(q + (int64_t)qa * kRowBytes + 32 * t, aa);
      if (qb < nq) load32(q + (int64_t)qb * kRowBytes + 32 * t, ab);
      int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        asm volatile(
            "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3)
            : "r"(aa[2 * l]), "r"(ab[2 * l]), "r"(aa[2 * l + 1]), "r"(ab[2 * l + 1]),
              "r"(b[2 * l]), "r"(b[2 * l + 1]));
      }
      // C: c0/c1 query qa, rows r0 + 2t, r0 + 2t + 1; c2/c3 query qb.
      const int64_t r = r0 + 2 * t;
      if (!PROBE) {
        int32_t* o = static_cast<int32_t*>(out);
        if (qa < nq) *reinterpret_cast<int2*>(o + (int64_t)qa * nrows + r) = make_int2(c0, c1);
        if (qb < nq) *reinterpret_cast<int2*>(o + (int64_t)qb * nrows + r) = make_int2(c2, c3);
      } else if (r0 % chunk < kProbeCols) {
        float* o = static_cast<float*>(out);
        const int64_t ncols = nrows / kProbeCols;
        const int64_t col = r0 / chunk * kProbeCols + r % chunk;
        if (qa < nq) *reinterpret_cast<float2*>(o + qa * ncols + col) = make_float2((float)c0, (float)c1);
        if (qb < nq) *reinterpret_cast<float2*>(o + qb * ncols + col) = make_float2((float)c2, (float)c3);
      } else {
        sink = max(sink, max(max(c0, c1), max(c2, c3)));
      }
    }
  }
  if (PROBE && sink == INT_MAX) static_cast<float*>(out)[0] = 0.f;  // never: |dot| <= 256 * 64
}

template <bool PROBE>
int launch(const void* q, int nq, const void* db, int nrows, int chunk, void* out, void* stream) {
  if (nq <= 0 || nrows <= 0) return 0;
  if (nrows % kProbeCols || (PROBE && (chunk <= 0 || chunk % kProbeCols || nrows % chunk))) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((nrows + kBlockRows - 1) / kBlockRows);
  int4_kernel<PROBE><<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), nq, static_cast<const uint8_t*>(db), nrows, chunk, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out (nq, nrows) int32 <- dots of the (nq, 128) and (nrows, 128) uint8
// int4 twins q and db (16-byte aligned rows, nrows % 128 == 0). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int iscc_int4_dot(const void* q, int nq, const void* db, int nrows, void* out, void* stream) {
  return launch<false>(q, nq, db, nrows, 1, out, stream);
}

// out (nq, nrows / 128) f32 <- the probe's columns (chunk % 128 == 0,
// nrows % chunk == 0).
extern "C" int iscc_int4_probe(const void* q, int nq, const void* db, int nrows, int chunk, void* out,
                               void* stream) {
  return launch<true>(q, nq, db, nrows, chunk, out, stream);
}
