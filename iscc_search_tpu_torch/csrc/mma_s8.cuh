// The int8 tensor-core tile of blockmax_bitplane.cu's sub-word kernel: one 128-row block
// staged in shared memory as int8, each row padded by 16 bytes so that the B
// fragment loads hit 32 distinct banks, dotted over its k-steps by
// mma.sync.m16n8k32 (dot_tile, any row width); for 256-bit rows, A fragments
// read straight from (Q, 256) int8 queries (load_a).
//
// mma.sync.m16n8k32 s8 fragments, lane = 4 g + t: A regs 0 / 1 hold k
// 4t..4t+3 of query rows g / g + 8, regs 2 / 3 k 16 + 4t...; B regs 0 / 1
// hold the same k of row g of the n-tile; C regs 0 / 1 are query g, rows
// 2t and 2t + 1 of the n-tile, regs 2 / 3 query g + 8.

#pragma once

#include <stdint.h>

namespace iscc_mma {

constexpr int kBlockRows = 128;
constexpr int kBits = 256;
constexpr int kSteps = kBits / 32;  // k-steps of m16n8k32
constexpr int kWarps = 4;
constexpr int kWarpQueries = 16;  // m of m16n8k32
constexpr int kQueryTile = kWarps * kWarpQueries;
constexpr int kNTiles = kBlockRows / 8;  // n of m16n8k32
constexpr int kRowPad = 16;              // bytes after each staged row
constexpr int kStride = kBits + kRowPad;  // bytes per staged 256-bit row

// A fragments of queries qa and qa + 8 (zero past nq) for every k-step.
__device__ __forceinline__ void load_a(const int8_t* __restrict__ q, int qa, int nq, int t,
                                       uint32_t (&a)[kSteps][4]) {
  const int qb = qa + 8;
#pragma unroll
  for (int l = 0; l < kSteps; ++l) {
    const int k = 32 * l + 4 * t;
    a[l][0] = qa < nq ? *reinterpret_cast<const uint32_t*>(q + (int64_t)qa * kBits + k) : 0u;
    a[l][1] = qb < nq ? *reinterpret_cast<const uint32_t*>(q + (int64_t)qb * kBits + k) : 0u;
    a[l][2] = qa < nq ? *reinterpret_cast<const uint32_t*>(q + (int64_t)qa * kBits + k + 16) : 0u;
    a[l][3] = qb < nq ? *reinterpret_cast<const uint32_t*>(q + (int64_t)qb * kBits + k + 16) : 0u;
  }
}

// The int32 dots of one n-tile over STEPS k-steps (32 k each); brow is the
// staged row of the lane's B column, already offset by 4t.
template <int STEPS>
__device__ __forceinline__ void dot_tile(const uint32_t (&a)[STEPS][4], const int8_t* brow,
                                         int (&c)[4]) {
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
  for (int l = 0; l < STEPS; ++l) {
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow + 32 * l);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(brow + 32 * l + 16);
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3)
        : "r"(a[l][0]), "r"(a[l][1]), "r"(a[l][2]), "r"(a[l][3]), "r"(b0), "r"(b1));
  }
  c[0] = c0;
  c[1] = c1;
  c[2] = c2;
  c[3] = c3;
}

}  // namespace iscc_mma
