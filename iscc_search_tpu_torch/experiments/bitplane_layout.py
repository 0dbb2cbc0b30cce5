"""
The flow of ``iscc_blockmax_bitplane`` in ``csrc/blockmax_bitplane.cu``
(TPU kernel 10, phase 1 from the bit-transposed twin, on ``wgmma``) mirrored
in numpy, so that it runs on the CPU (``tests/test_torch_bitplane_layout.py``).
Constants the tests read back from the ``.cu`` source carry its names.

- **The twin.** Per 4,096-row group, element ``(u, 32 j1 + j0)`` of the
  ``bit_transpose_packed`` twin holds at bit ``s`` bit ``u`` of original
  row ``j0 * 128 + 4 s + j1``. So the 128 rows of block ``j0`` are rows
  ``r = 4 s + j1`` of a 0/1 int8 tile whose byte ``u`` is that bit.
- **Launches and shares.** One persistent launch per chunk of
  :data:`CHUNK_QUERIES` queries, of ``min(slices, sms)`` thread blocks. The
  unit is a slice: :data:`SLICE_BLOCKS` consecutive ``j0`` of one group,
  32 KiB of twin that TMA lands as one box of 256 ``u`` x 4 ``j1`` x 8
  ``j0`` (:func:`slice_offset`). Each thread block takes a contiguous share
  of slices (:func:`shares`); every twin byte is read once per launch.
- **The producer warpgroup** (:data:`PRODUCER_THREADS` threads) reads its
  share of a slice into registers, half a slice at a time, with 16-byte
  loads (:func:`producer_thread` says which bytes; :func:`wavefronts` counts
  the banks' turns). Each of its warps plans two of the slice's blocks
  (:func:`pen_words`: one word per band and lane holds both blocks'
  penalties) into a table in shared memory, which one barrier of the
  warpgroup publishes; once the second half is read, a proxy fence and a
  barrier free the slice for the next TMA. Block after block it
  un-transposes into one of two row tiles in wgmma's 128-byte swizzle
  (:func:`s8_offset`): four elements ``e0..e3`` (four consecutive ``u`` of
  one column) become four words ``P_b`` = byte ``b`` of each by a 4 x 4 byte
  transpose of eight PRMTs (:func:`transpose4`), and the word of row
  ``4 s + j1`` at K bytes ``u..u+3`` is ``(P_{s / 8} >> s % 8) & 0x01010101``
  (:func:`plane_word`).
- **The penalty, once per block** (:func:`block_plan`): kernel 8's rule
  (``variant_layout.plans`` for ``bf16``). ``y = 2 dot01 - qsum`` lies in
  [-256, 256] and ``y -> bf16(bf16(y) + p)`` is non-decreasing, so where
  every penalty of the block is finite and either its largest ``pmax`` or
  at most ``pmax - 512``, the dominated rows are stored again, after the
  block's rows, as copies of the block's first row at ``pmax`` (each thread
  takes that row's word from the lane that holds its column), and the block
  takes the fast path: the integer maximum of the dots, one element per
  query. Any other block keeps its rows and takes the per-element path.
  :func:`path_blocks` counts the blocks on each path as the kernel does.
- **The consumers** (:data:`CONSUMER_GROUPS` warpgroups) hold the chunk's
  queries in shared memory as wgmma's A operand, one 64-query tile each, and
  run ``m64n128k32`` on the row tile of each block, issuing in turns round a
  ring; the block maxima of a slice's 8 blocks are one 32-byte sector per
  query, gathered and written by the warp that computed them.
"""

from __future__ import annotations

import numpy as np

from iscc_search_tpu_torch.experiments import exp_kernels as ek
from iscc_search_tpu_torch.experiments import variant_layout as vl

BLOCK_ROWS = 128  # kBlockRows
BITS = 256  # kBits
GROUP_BLOCKS = 32  # kGroupBlocks: blocks (j0) of a 4,096-row group
BANDS = 4  # kBands: the column bands j1 of a block
SLICE_BLOCKS = 8  # kSliceBlocks: consecutive j0 per slice
SLICE_BYTES = BITS * BANDS * SLICE_BLOCKS * 4  # kSliceBytes
TILE_QUERIES = 64  # kTileQueries
CHUNK_QUERIES = 256  # kChunkQueries
PRODUCER_THREADS = 128  # kProducerThreads
CONSUMER_GROUPS = CHUNK_QUERIES // TILE_QUERIES  # kConsumerGroups: one query tile each
OUT_STRIDE = SLICE_BLOCKS + 1  # kOutStride
SWIZZLE_BYTES = vl.SWIZZLE_BYTES
S8_ATOM = vl.S8_ATOM
S8_TILE_BYTES = BITS // SWIZZLE_BYTES * S8_ATOM  # kS8TileBytes
S8_CHUNKS = BITS // 16  # kS8Chunks
PLANE_MASK = 0x01010101  # kPlaneMask
# PRMT selectors of the 4 x 4 byte transpose (transpose4): pairs of bytes,
# then pairs of halves.
PAIR_LO, PAIR_HI, HALF_LO, HALF_HI = 0x5140, 0x7362, 0x5410, 0x7632
DOMINANCE = vl.DOMINANCE
SMEM_LIMIT = vl.SMEM_LIMIT
SMS = vl.SMS


PLAN_BYTES = 32  # sizeof(BlockPlan): pmax, fast, substitute, first_top, dom[4]


def smem_bytes(qc):
    # type: (int) -> int
    """Dynamic shared memory at ``qc`` resident queries: two row tiles, two
    slices, the query tile, scales and query sums, two slices' penalty slots
    and plans, the gather, six mbarriers and 1,024 bytes to align the tiles."""
    return (2 * S8_TILE_BYTES + 2 * SLICE_BYTES + S8_CHUNKS * qc * 16 + qc * 8 + 2 * SLICE_BLOCKS * BLOCK_ROWS * 4
            + 2 * SLICE_BLOCKS * PLAN_BYTES + qc * OUT_STRIDE * 4 + 6 * 8 + 1024)


# ------------------------------------------------------------ arithmetic


def prmt(x, y, s):
    # type: (np.ndarray, np.ndarray, int) -> np.ndarray
    """PRMT (``__byte_perm``) on arrays: byte n of the result is byte
    ``(s >> 4n) & 7`` of the 8-byte value ``y:x``."""
    both = (np.asarray(y, np.uint64) & 0xFFFFFFFF) << np.uint64(32) | (np.asarray(x, np.uint64) & 0xFFFFFFFF)
    out = np.zeros(both.shape, np.uint64)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= ((both >> np.uint64(8 * sel)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def transpose4(e0, e1, e2, e3):
    # type: (np.ndarray, np.ndarray, np.ndarray, np.ndarray) -> list
    """The kernel's eight PRMTs: ``P_b`` holds byte ``b`` of ``e0, e1, e2,
    e3`` in its bytes 0-3."""
    t0, t1 = prmt(e0, e1, PAIR_LO), prmt(e0, e1, PAIR_HI)
    t2, t3 = prmt(e2, e3, PAIR_LO), prmt(e2, e3, PAIR_HI)
    return [prmt(t0, t2, HALF_LO), prmt(t0, t2, HALF_HI), prmt(t1, t3, HALF_LO), prmt(t1, t3, HALF_HI)]


def plane_word(p, s):
    # type: (list, int) -> np.ndarray
    """The 0/1 bytes of bit ``s`` of the four elements: row ``4 s + j1`` at
    their four K bytes."""
    return (p[s >> 3] >> np.uint32(s & 7)) & np.uint32(PLANE_MASK)


s8_offset = vl.s8_offset  # byte k of row r in a row tile: kernel 8's layout


# ------------------------------------------------------- staging, threads


def producer_thread(p):
    # type: (np.ndarray) -> tuple[np.ndarray, np.ndarray]
    """(j1, u0) of producer thread ``p``: its column band and the first of
    its eight K bytes. Lane l = 4 b2 + j1 (bits: j1, then a, b, h); warp w.
    A half-warp's 8-byte stores of one row set fill every bank once, and a
    quarter-warp's 16-byte slice loads touch each bank at most twice."""
    p = np.asarray(p)
    w, lane = p >> 5, p & 31
    a, b, h = (lane >> 2) & 1, (lane >> 3) & 1, (lane >> 4) & 1
    return lane & 3, 128 * (w >> 1) + 16 * (4 * b + 2 * (w & 1) + h) + 8 * a


def slice_offset(u, j1, c):
    """Byte offset of element (u, 32 j1 + j0) in a slice, c = j0 - its first
    j0: TMA's box of 8 x 4 x 256 four-byte elements, j0 innermost."""
    return np.asarray(u) * (BANDS * SLICE_BLOCKS * 4) + np.asarray(j1) * (SLICE_BLOCKS * 4) + np.asarray(c) * 4


def slice_box(twin, slice_index):
    # type: (np.ndarray, int) -> np.ndarray
    """The (256 u, 4 j1, 8 c) uint32 elements TMA lands for one slice of a
    (G * 256, 128) twin."""
    g, first = divmod(slice_index * SLICE_BLOCKS, GROUP_BLOCKS)
    rows = np.asarray(twin, np.uint32)[g * BITS : (g + 1) * BITS].reshape(BITS, BANDS, GROUP_BLOCKS)
    return rows[:, :, first : first + SLICE_BLOCKS]


def wavefronts(addresses, width):
    # type: (np.ndarray, int) -> int
    """Shared-memory turns of one warp instruction: 32 byte addresses of
    ``width``-byte accesses, served in phases of 128 bytes (8 lanes for 16
    bytes, 16 for 8, all 32 for 4); a phase takes as many turns as the most
    distinct 4-byte words any one bank holds among its lanes' bytes."""
    addresses = np.asarray(addresses).reshape(-1)
    per_phase = max(1, 128 // width) if width > 4 else 32
    turns = 0
    for start in range(0, len(addresses), per_phase):
        words = {(int(a) + k) // 4 for a in addresses[start : start + per_phase] for k in range(0, width, 4)}
        banks = {}
        for word in words:
            banks[word % 32] = banks.get(word % 32, 0) + 1
        turns += max(banks.values())
    return turns


# ------------------------------------------------------------- the plan


def penalty_rows(pen, block=None):
    # type: (np.ndarray, int | None) -> np.ndarray
    """The f32 penalties of tile rows r = 4 s + j1 from the flat penalty in
    ``bitplane_penalty_perm`` order (bf16 bits): (128,) of ``block``, or
    (N / 128, 128) of every block."""
    bits = np.asarray(pen).reshape(-1).view(np.uint16)
    r = np.arange(BLOCK_ROWS)
    blocks = np.arange(bits.size // BLOCK_ROWS) if block is None else np.asarray(block)
    g, j0 = np.divmod(blocks, GROUP_BLOCKS)
    at = (g * GROUP_BLOCKS * BLOCK_ROWS + j0)[..., None] + (r >> 2) * 128 + (r & 3) * 32
    return (bits[at].astype(np.uint32) << 16).view(np.float32)


def pen_words(pen, slice_index, w, lane):
    # type: (np.ndarray, int, int, int) -> np.ndarray
    """The (4,) uint32 words producer warp ``w``'s lane reads for a slice
    (``load_pens``): band j's word holds the bf16 penalty of row 4 lane + j
    of block 2w in its low half and of block 2w + 1 in its high half."""
    bits = np.asarray(pen).reshape(-1).view(np.uint16)
    g, first = divmod(slice_index * SLICE_BLOCKS, GROUP_BLOCKS)
    at = g * GROUP_BLOCKS * BLOCK_ROWS + lane * 128 + np.arange(BANDS) * 32 + first + 2 * w
    return bits[at].astype(np.uint32) | bits[at + 1].astype(np.uint32) << 16


def block_plan(p):
    # type: (np.ndarray) -> tuple[bool, float, np.ndarray, int]
    """(fast, pmax, dominated masks, first top row) of one block's (128,)
    penalties: mask j1 has bit s set where row 4 s + j1 is replaced (fast
    blocks only), as the kernel's ballots build them."""
    fast, pmax, source = vl.plan(ek.EPI_BF16, p)
    dom = source != np.arange(BLOCK_ROWS)
    masks = np.array([sum(1 << s for s in range(32) if dom[4 * s + j1]) for j1 in range(BANDS)], np.uint64)
    with np.errstate(invalid="ignore"):
        first_top = int(np.argmax(p == np.float32(pmax)))
    return fast, pmax, masks, first_top


def path_blocks(pen, nq):
    # type: (np.ndarray, int) -> tuple[int, int]
    """(blocks the kernel finishes, those of them on the fast path) of one
    call with ``nq`` queries: every block once per query chunk."""
    fast = vl.plans(ek.EPI_BF16, penalty_rows(pen))[0]
    chunks = -(-nq // CHUNK_QUERIES)
    return len(fast) * chunks, int(fast.sum()) * chunks


# ------------------------------------------------------------ the flow


def untranspose(box, c, masks, first_top):
    # type: (np.ndarray, int, np.ndarray, int) -> np.ndarray
    """The (32 KiB,) uint8 row tile of block c of a slice as the producer's
    128 threads write it: two groups of four elements per thread, eight
    PRMTs each, one 8-byte store per row; then each row whose bit is set in
    ``masks`` is stored again with the words of row ``first_top``, which
    each thread shuffles in from the lane of its own K bytes that holds
    that row."""
    p = np.arange(PRODUCER_THREADS)
    j1, u0 = producer_thread(p)
    s_t, j1_t = first_top >> 2, first_top & 3
    tile = np.zeros(S8_TILE_BYTES, np.uint8)

    def store(rows, threads, words):
        for h in range(2):
            for k in range(4):
                tile[s8_offset(rows, u0[threads] + 4 * h + k)] = (words[h] >> np.uint32(8 * k)) & 0xFF

    planes = [transpose4(*[box[u0 + 4 * h + k, j1, c] for k in range(4)]) for h in range(2)]
    for s in range(32):
        store(4 * s + j1, p, [plane_word(planes[h], s) for h in range(2)])
    if masks.any():
        src = (p & ~3) | j1_t  # __shfl_sync from the lane with j1 = j1_t
        top = [plane_word(planes[h], s_t)[src] for h in range(2)]
        mine = masks[j1]
        for s in range(32):
            sub = ((mine >> np.uint64(s)) & np.uint64(1)).astype(bool)
            store(4 * s + j1[sub], p[sub], [top[h][sub] for h in range(2)])
    return tile


def tile_rows(tile):
    # type: (np.ndarray) -> np.ndarray
    """The (128, 256) int8 rows wgmma reads from a row tile."""
    r = np.arange(BLOCK_ROWS)[:, None]
    k = np.arange(BITS)[None, :]
    return tile[s8_offset(r, k)].astype(np.int8)


def shares(nslices, sms=SMS):
    # type: (int, int) -> list[tuple[int, int]]
    """(first slice, one past the last) of every thread block of a launch."""
    ctas = min(nslices, sms)
    return [(cta * nslices // ctas, (cta + 1) * nslices // ctas) for cta in range(ctas)]


def run(q, qs, twin, pen, sms=SMS, counts=None):
    # type: (np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, list | None) -> np.ndarray
    """
    The kernel's output, computed along its flow: launches per query chunk,
    shares of slices, the plan and the un-transpose with its substitution,
    the dots from the row tile, both epilogues, the gather of a slice.

    :param q: (Q, 256) int8 ±1/0
    :param qs: (Q,) float32
    :param twin: (N / 16, 128) uint32 (or int32) ``bit_transpose_packed`` twin
    :param pen: (N,) bf16 bits (uint16 / int16) in ``bitplane_penalty_perm`` order
    :param counts: a list [finished, fast] the flow adds its blocks to
    :return: (Q, N / 128) float32; NaN where nothing was written
    """
    twin = np.asarray(twin).view(np.uint32)
    nq = q.shape[0]
    nblocks = twin.shape[0] // BITS * GROUP_BLOCKS
    out = np.full((nq, nblocks), np.nan, np.float32)
    qsum_all = q.astype(np.int64).sum(axis=1)
    for q0 in range(0, nq, CHUNK_QUERIES):
        qi = np.arange(q0, min(nq, q0 + CHUNK_QUERIES))
        qf, qsum, s = q[qi].astype(np.float32), qsum_all[qi], qs[qi]
        for first, end in shares(nblocks // SLICE_BLOCKS, sms):
            for sl in range(first, end):
                box = slice_box(twin, sl)
                gather = np.full((len(qi), SLICE_BLOCKS), np.nan, np.float32)
                for c in range(SLICE_BLOCKS):
                    block = sl * SLICE_BLOCKS + c
                    p = penalty_rows(pen, block)
                    fast, pmax, masks, first_top = block_plan(p)
                    rows = tile_rows(untranspose(box, c, masks, first_top))
                    y = 2 * (qf @ rows.astype(np.float32).T).astype(np.int64) - qsum[:, None]
                    if fast:
                        e = vl.element(ek.EPI_BF16, y.max(axis=1), pmax)
                    else:
                        e = vl.finish_general(ek.EPI_BF16, vl._fmax_rows(vl.general(ek.EPI_BF16, y, p[None, :])))
                    if counts is not None:
                        counts[0] += 1
                        counts[1] += int(fast)
                    gather[:, c] = vl.finalize(ek.EPI_BF16, e, s)
                out[qi[:, None], sl * SLICE_BLOCKS + np.arange(SLICE_BLOCKS)] = gather
    return out
