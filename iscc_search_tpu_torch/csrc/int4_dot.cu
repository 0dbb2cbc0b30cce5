// The int4 probe of benchmarks/exp_int4.py on Hopper's tensor cores: dots of
// 256-element int4 rows with int4 queries, streamed from device memory.
//
// Replaces the Pallas TPU kernel of benchmarks/exp_int4.py (main :38,
// pallas_call :100, inline body kern :89), and stands in for its XLA int4
// dot_general (dot4, :54), which PyTorch has no counterpart of:
//   - iscc_int4_dot: the full (nq, nrows) int32 dot;
//   - iscc_int4_probe: the Pallas probe's (nq, nrows / chunk * 128) f32
//     output, column i * 128 + j = dot of row i * chunk + j for j < 128
//     (nrows / 128 columns at the script's chunk of 16,384). Every row
//     is dotted; the dots that are not stored fold into a value that is
//     stored only if it is impossible, so that no MMA is dead code.
// Operands are int4 twins (ops/bitplane.py build_int4_twin): 128 bytes per
// row, element 2m in the low nibble of byte m, the order mma.sync reads .s4
// values from a register (element i in bits 4i..4i+3).
//
// The dot runs on the int8 tensor-core path. Hopper's tensor cores have no
// 4-bit mode (wgmma has no .s4 type), and mma.sync.m16n8k64 s4 x s4, which
// still assembles for sm_90a, is expanded into an unpack routine plus int8
// MMAs and ran 2.5x slower here (PERF.md, sections 6 and 7). Instead,
// (w << 4) & 0xF0F0F0F0 and w & 0xF0F0F0F0 turn one register of eight int4
// values into two registers of int8 values, each 16 times the int4 value;
// with the queries prepared the same way once, mma.sync.m16n8k32 s8 gives
// 256 times the dot, and >> 8 is exact (|dot| <= 256 * 64). Eight MMAs per
// n-tile. A lane's words are dotted in another k order than the twin's, the
// same for queries and rows, so the dot is the twin's.
//
// Shape: no shared memory. A warp owns 32 consecutive rows (four n-tiles of
// 8). Lane (g, t) issues all eight 16-byte streaming loads of its rows
// (bytes [16t, 16t + 16) and [64 + 16t, 64 + 16t + 16) of row g of each
// n-tile, so the four lanes of a row cover whole 32-byte sectors) before
// the first MMA; the query fragments are loaded once per 16-query tile,
// outside the n-tile loop (for nq <= 16 once per warp). The t lanes swap
// halves of two n-tiles with __shfl_xor_sync, so that each stores 16 bytes:
// four consecutive rows of a query. Queries past nq are zero rows of the
// m16 tile (Q = 8 fills half of it).
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
constexpr int kWarpTiles = 4;  // n-tiles of 8 rows per warp, loaded together
constexpr int kWarpRows = 8 * kWarpTiles;
constexpr int kBlockRows = kWarps * kWarpRows;
constexpr int kProbeCols = 128;

// 16 bytes of a row that is read once: past L1.
__device__ __forceinline__ uint4 load_streaming(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// A lane's 32 bytes of a 128-byte twin row: words 0-3 and 4-7.
__device__ __forceinline__ void lane_words(const uint4& lo, const uint4& hi, uint32_t (&w)[8]) {
  w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
  w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

// The two int8 registers of one int4 register: elements 0, 2, 4, 6 and
// elements 1, 3, 5, 7, each times 16.
__device__ __forceinline__ uint32_t even_x16(uint32_t w) { return (w << 4) & 0xF0F0F0F0u; }
__device__ __forceinline__ uint32_t odd_x16(uint32_t w) { return w & 0xF0F0F0F0u; }

// The A fragments of queries qa (rows g) and qb = qa + 8 of a 16-query
// tile, and the dot of one n-tile against them.
struct QueryTile {
  uint32_t a_even[8], a_odd[8], b_even[8], b_odd[8];

  __device__ __forceinline__ void set(const uint32_t (&wa)[8], const uint32_t (&wb)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a_even[i] = even_x16(wa[i]); a_odd[i] = odd_x16(wa[i]);
      b_even[i] = even_x16(wb[i]); b_odd[i] = odd_x16(wb[i]);
    }
  }

  // One k-step per word: its even elements as k 4t.., its odd ones as k 16 + 4t...
  __device__ __forceinline__ void dot(const uint32_t (&row)[8], int (&c)[4]) const {
    c[0] = c[1] = c[2] = c[3] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
          : "r"(a_even[i]), "r"(b_even[i]), "r"(a_odd[i]), "r"(b_odd[i]), "r"(even_x16(row[i])),
            "r"(odd_x16(row[i])));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] >>= 8;  // 16 * 16 times the dot
  }
};

// Lanes t and t ^ 1 swap halves of two n-tiles' C pairs (x0, x1 of n-tile
// j0; y0, y1 of n-tile j0 + 1, rows 2t and 2t + 1 of each), so that an even
// t holds rows 2t..2t + 3 of n-tile j0 and an odd t rows 2t - 2..2t + 1 of
// n-tile j0 + 1; returns the first of the lane's four rows within the two
// n-tiles' 16.
__device__ __forceinline__ int swap_to_quads(int t, int x0, int x1, int y0, int y1, int4& quad) {
  const bool odd = t & 1;
  const int got0 = __shfl_xor_sync(0xffffffffu, odd ? x0 : y0, 1);
  const int got1 = __shfl_xor_sync(0xffffffffu, odd ? x1 : y1, 1);
  quad = odd ? make_int4(got0, got1, y0, y1) : make_int4(x0, x1, got0, got1);
  return odd ? 8 + 2 * (t - 1) : 2 * t;
}

template <bool PROBE>
__global__ void __launch_bounds__(kWarps * 32)
int4_kernel(const uint8_t* __restrict__ q, int nq, const uint8_t* __restrict__ db, int nrows,
            int chunk, void* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // nrows is a multiple of 128, so a warp's 32 rows are all there or none is.
  const int64_t r0 = (int64_t)blockIdx.x * kBlockRows + warp * kWarpRows;
  if (r0 >= nrows) return;

  // Every load of the warp's rows before anything waits for one.
  uint4 lo[kWarpTiles], hi[kWarpTiles];
#pragma unroll
  for (int j = 0; j < kWarpTiles; ++j) {
    const uint8_t* p = db + (r0 + 8 * j + g) * kRowBytes + 16 * t;
    lo[j] = load_streaming(p);
    hi[j] = load_streaming(p + 64);
  }

  const bool stored = !PROBE || r0 % chunk < kProbeCols;  // the whole group, or none of it
  int sink = 0;
  for (int m0 = 0; m0 < nq; m0 += 16) {
    const int qa = m0 + g;
    const int qb = qa + 8;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const uint4* pa = reinterpret_cast<const uint4*>(q + (int64_t)qa * kRowBytes + 16 * t);
    const uint4* pb = reinterpret_cast<const uint4*>(q + (int64_t)qb * kRowBytes + 16 * t);
    uint32_t wa[8], wb[8];
    lane_words(qa < nq ? __ldg(pa) : zero, qa < nq ? __ldg(pa + 4) : zero, wa);
    lane_words(qb < nq ? __ldg(pb) : zero, qb < nq ? __ldg(pb + 4) : zero, wb);
    QueryTile tile;
    tile.set(wa, wb);

    // C of n-tile j: c[j][0], c[j][1] query qa, rows 8j + 2t, 8j + 2t + 1;
    // c[j][2], c[j][3] query qb.
    int c[kWarpTiles][4];
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j) {
      uint32_t row[8];
      lane_words(lo[j], hi[j], row);
      tile.dot(row, c[j]);
    }

    if (!PROBE) {
      int32_t* o = static_cast<int32_t*>(out);
#pragma unroll
      for (int j = 0; j < kWarpTiles; j += 2) {
        int4 quad;
        int first = swap_to_quads(t, c[j][0], c[j][1], c[j + 1][0], c[j + 1][1], quad);
        if (qa < nq) __stcs(reinterpret_cast<int4*>(o + (int64_t)qa * nrows + r0 + 8 * j + first), quad);
        if (m0 + 8 < nq) {  // warp-uniform: the tile has a second half
          first = swap_to_quads(t, c[j][2], c[j][3], c[j + 1][2], c[j + 1][3], quad);
          if (qb < nq) __stcs(reinterpret_cast<int4*>(o + (int64_t)qb * nrows + r0 + 8 * j + first), quad);
        }
      }
    } else if (stored) {
      float* o = static_cast<float*>(out);
      const int64_t ncols = (int64_t)(nrows / chunk) * kProbeCols;
      const int64_t col0 = r0 / chunk * kProbeCols + r0 % chunk + 2 * t;
#pragma unroll
      for (int j = 0; j < kWarpTiles; ++j) {
        if (qa < nq) *reinterpret_cast<float2*>(o + qa * ncols + col0 + 8 * j) = make_float2((float)c[j][0], (float)c[j][1]);
        if (qb < nq) *reinterpret_cast<float2*>(o + qb * ncols + col0 + 8 * j) = make_float2((float)c[j][2], (float)c[j][3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kWarpTiles; ++j) sink = max(sink, max(max(c[j][0], c[j][1]), max(c[j][2], c[j][3])));
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

// out (nq, nrows / chunk * 128) f32 <- the probe's columns (chunk % 128 ==
// 0, nrows % chunk == 0).
extern "C" int iscc_int4_probe(const void* q, int nq, const void* db, int nrows, int chunk, void* out,
                               void* stream) {
  return launch<true>(q, nq, db, nrows, chunk, out, stream);
}
