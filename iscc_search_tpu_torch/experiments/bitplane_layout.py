"""
The flow of ``csrc/blockmax_bitplane.cu`` mirrored in numpy, so that it runs
on the CPU (``tests/test_torch_bitplane_layout.py``): one kernel templated on
the twin's element width W, ``iscc_blockmax_bitplane`` (TPU kernel 10, W =
32, bf16 epilogue) and ``iscc_blockmax_subword`` (TPU kernel 11, W = 8 or
16, int32 epilogue). Constants the tests read back from the ``.cu`` source
carry its names; functions of the width take it as ``width``.

- **The twins.** Per 4,096-row group, element ``(256 b + u, 32 j1 + j0)``
  holds at bit ``s`` bit ``u`` of original row ``j0 * 128 + r``,
  ``r = s * (128 / W) + 4 b + j1`` (:func:`plane_bands` bands ``b``). With
  ``s' = s * bands + b``, ``r = 4 s' + j1`` at every width: the 128 rows of
  block ``j0`` are rows ``4 s' + j1`` of a 0/1 int8 tile whose byte ``k``
  is bit ``u`` = :func:`k_to_u` of ``k`` (``u`` itself at W = 32; odd
  octets of ``u`` swapped in pairs below, the queries permuted alike).
- **Launches and shares.** One persistent launch per chunk of
  :data:`CHUNK_QUERIES` queries, of ``min(slices, sms)`` thread blocks. The
  unit is a slice: :func:`slice_blocks` consecutive ``j0`` of one group,
  which TMA lands as one box of ``j0`` x 4 ``j1`` x 256 ``u`` x bands, ``j0``
  innermost (:func:`slice_offset`, :func:`slice_box`). TMA wants 16 bytes
  or more innermost: 8 blocks at W = 32 and 16 (32 KiB, two in flight), 16
  at W = 8 (64 KiB, one in flight, :func:`slice_bufs`). Each thread block
  takes a contiguous share of slices (:func:`shares`); every twin byte is
  read once per launch.
- **The producer warpgroup** (:data:`PRODUCER_THREADS` threads) holds
  :data:`HOLD_BLOCKS` blocks of a slice in registers at a time
  (:func:`load_hold`): per band and each of its eight K bytes one load of
  16, 8 or 4 bytes (:func:`producer_thread` says which bytes; :func:`load_address`
  where they lie; :func:`wavefronts` counts the banks' turns). Each of its
  warps plans two of every eight blocks (:func:`pen_words`) into a table in
  shared memory, which one barrier of the warpgroup publishes; once the
  slice's last hold is read, a proxy fence and a barrier free it for the
  next TMA. Each four loaded words of one band and word position (four K
  bytes) become four words ``P_n`` = byte ``n`` of each by a 4 x 4 byte
  transpose of eight PRMTs (:func:`transpose4`), in place; the word of row
  ``4 s' + j1`` at those K bytes is ``(P_n >> m) & 0x01010101``
  (:func:`plane_word`), stored into one of two row tiles in wgmma's 128-byte
  swizzle (:func:`s8_offset`).
- **The penalty, once per block** (:func:`block_plan`): kernel 8's rule
  (``variant_layout.plans`` for ``bf16``; in integers for the int32
  epilogue). ``y = 2 dot01 - qsum`` lies in [-256, 256] and both epilogues
  are non-decreasing in it, so where every penalty of the block is (finite
  and) either its largest ``pmax`` or at most ``pmax - 512``, the dominated
  rows are stored again, after the block's rows, as copies of the block's
  first row at ``pmax`` (each thread takes that row's word from the lane that
  holds its column), and the block takes the fast path: the integer maximum
  of the dots, one element per query. Any other block keeps its rows and
  takes the per-element path. :func:`path_blocks` counts the blocks on each
  path as the kernel does.
- **The consumers** (:data:`CONSUMER_GROUPS` warpgroups) hold the chunk's
  queries in shared memory as wgmma's A operand, one 64-query tile each, and
  run ``m64n128k32`` on the row tile of each block, issuing in turns round a
  ring; the block maxima of :data:`FLUSH_BLOCKS` blocks are one 32-byte
  sector per query, gathered and written by the warp that computed them.
"""

from __future__ import annotations

import numpy as np

from iscc_search_tpu_torch.experiments import exp_kernels as ek
from iscc_search_tpu_torch.experiments import variant_layout as vl

WIDTHS = (32, 16, 8)  # element widths W: kernel 10, then kernel 11's two twins
BLOCK_ROWS = 128  # kBlockRows
BITS = 256  # kBits
GROUP_BLOCKS = 32  # kGroupBlocks: blocks (j0) of a 4,096-row group
BANDS = 4  # kBands: the column bands j1 of a block
HOLD_BLOCKS = 4  # kHoldBlocks: blocks a producer thread holds in registers at a time
FLUSH_BLOCKS = 8  # kFlushBlocks: blocks per flush of the gather
TILE_QUERIES = 64  # kTileQueries
CHUNK_QUERIES = 256  # kChunkQueries
PRODUCER_THREADS = 128  # kProducerThreads
CONSUMER_GROUPS = CHUNK_QUERIES // TILE_QUERIES  # kConsumerGroups: one query tile each
OUT_STRIDE = FLUSH_BLOCKS + 1  # kOutStride
SWIZZLE_BYTES = vl.SWIZZLE_BYTES
S8_ATOM = vl.S8_ATOM
S8_TILE_BYTES = BITS // SWIZZLE_BYTES * S8_ATOM  # kS8TileBytes
S8_CHUNKS = BITS // 16  # kS8Chunks
PLANE_MASK = 0x01010101  # kPlaneMask
# PRMT selectors of the 4 x 4 byte transpose (transpose4): pairs of bytes,
# then pairs of halves; and the byte swap of the queries' odd octets.
PAIR_LO, PAIR_HI, HALF_LO, HALF_HI = 0x5140, 0x7362, 0x5410, 0x7632
PAIR_SWAP = 0x2301
DOMINANCE = 512  # kDominance
SMEM_LIMIT = vl.SMEM_LIMIT
SMS = vl.SMS
PLAN_BYTES = 32  # sizeof(BlockPlan): pmax, fast, substitute, first_top, dom[4]


# ------------------------------------------------------------ the widths


def plane_bands(width):
    # type: (int) -> int
    """Bands ``b`` of a group's view rows (``Width::kPlaneBands``); also the
    blocks in one 32-bit word of a view row (``kWordBlocks``)."""
    return 32 // width


def slice_blocks(width):
    # type: (int) -> int
    """``Width::kSliceBlocks``: TMA's box needs 16 bytes or more of them."""
    return 16 if width == 8 else 8


def slice_bufs(width):
    # type: (int) -> int
    """``Width::kSliceBufs``: slices in flight."""
    return 1 if width == 8 else 2


def row_bytes(width):
    # type: (int) -> int
    """``Width::kRowBytes``: one (b, u, j1) of a slice."""
    return slice_blocks(width) * width // 8


def slice_bytes(width):
    # type: (int) -> int
    """``Width::kSliceBytes``."""
    return plane_bands(width) * BITS * BANDS * row_bytes(width)


def hold_words(width):
    # type: (int) -> int
    """``Width::kHoldWords``: 32-bit words per band and K byte of a hold."""
    return width // 8


def k_to_u(k, width):
    # type: (np.ndarray, int) -> np.ndarray
    """Bit ``u`` that K byte ``k`` of a row tile (and of the permuted queries)
    holds: ``k`` at W = 32, else ``k ^ ((k >> 3) & 1)`` (``Width::kPairSwap``).
    An involution."""
    k = np.asarray(k)
    return k ^ ((k >> 3) & 1) if width < 32 else k


def smem_bytes(qc, width=32):
    # type: (int, int) -> int
    """Dynamic shared memory at ``qc`` resident queries: two row tiles, the
    slices in flight, the query tile, scales and query sums, two slices'
    penalty slots and plans, the gather, six mbarriers and 1,024 bytes to
    align the tiles."""
    sb = slice_blocks(width)
    return (2 * S8_TILE_BYTES + slice_bufs(width) * slice_bytes(width) + S8_CHUNKS * qc * 16 + qc * 8
            + 2 * sb * BLOCK_ROWS * 4 + 2 * sb * PLAN_BYTES + qc * OUT_STRIDE * 4 + 6 * 8 + 1024)


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
    """The kernel's eight PRMTs: ``P_n`` holds byte ``n`` of ``e0, e1, e2,
    e3`` in its bytes 0-3."""
    t0, t1 = prmt(e0, e1, PAIR_LO), prmt(e0, e1, PAIR_HI)
    t2, t3 = prmt(e2, e3, PAIR_LO), prmt(e2, e3, PAIR_HI)
    return [prmt(t0, t2, HALF_LO), prmt(t0, t2, HALF_HI), prmt(t1, t3, HALF_LO), prmt(t1, t3, HALF_HI)]


def plane_word(hold, c, g, sp, width):
    # type: (np.ndarray, int, int, int, int) -> np.ndarray
    """The 0/1 bytes of row ``4 sp + j1`` of hold block ``c`` at the thread's
    K bytes ``4 g .. 4 g + 3``, from a transposed hold (:func:`load_hold`):
    bit ``s = sp // bands`` of band ``b = sp % bands``, which is bit
    ``(c % bands) * W + s`` of the hold's word ``c // bands``."""
    bands = plane_bands(width)
    bit = c % bands * width + sp // bands
    return (hold[sp % bands, 4 * g + (bit >> 3), c // bands] >> np.uint32(bit & 7)) & np.uint32(PLANE_MASK)


s8_offset = vl.s8_offset  # byte k of row r in a row tile: kernel 8's layout


# ------------------------------------------------------- staging, threads


def producer_thread(p):
    # type: (np.ndarray) -> tuple[np.ndarray, np.ndarray]
    """(j1, u0) of producer thread ``p``: its column band and the first of
    its eight K bytes. Lane l = 4 b2 + j1 (bits: j1, then a, b, h); warp w.
    A half-warp's 8-byte stores of one row set fill every bank once."""
    p = np.asarray(p)
    w, lane = p >> 5, p & 31
    a, b, h = (lane >> 2) & 1, (lane >> 3) & 1, (lane >> 4) & 1
    return lane & 3, 128 * (w >> 1) + 16 * (4 * b + 2 * (w & 1) + h) + 8 * a


def slice_offset(b, u, j1, c, width=32):
    """Byte offset of element (256 b + u, 32 j1 + j0) in a slice, c = j0 -
    its first j0: TMA's box of j0 x 4 j1 x 256 u x bands, j0 innermost."""
    b, u, j1, c = map(np.asarray, (b, u, j1, c))
    return ((b * BITS + u) * BANDS + j1) * row_bytes(width) + c * (width // 8)


def slice_box(twin, slice_index, width=32):
    # type: (np.ndarray, int, int) -> np.ndarray
    """The bytes TMA lands for one slice of a (G * bands * 256, 128) twin of
    ``width``-bit elements: (slice_bytes,) uint8."""
    sb = slice_blocks(width)
    raw = np.ascontiguousarray(twin).view(np.uint8).reshape(-1, plane_bands(width), BITS, BANDS, GROUP_BLOCKS,
                                                            width // 8)
    g, first = divmod(slice_index * sb, GROUP_BLOCKS)
    return np.ascontiguousarray(raw[g, :, :, :, first : first + sb]).reshape(-1)


def load_address(p, b, i, h, width=32):
    # type: (np.ndarray, int, int, int, int) -> np.ndarray
    """Byte offset in the slice of producer thread ``p``'s load (``i``, band
    ``b``) of hold ``h``: view row ``256 b + k_to_u(u0 + i)``, its band, the
    hold's first block. Each load is ``width / 2`` bytes (four blocks)."""
    j1, u0 = producer_thread(p)
    return slice_offset(b, k_to_u(u0 + i, width), j1, HOLD_BLOCKS * h, width)


def load_hold(box, h, width=32):
    # type: (np.ndarray, int, int) -> np.ndarray
    """(bands, 8, words, 128) uint32: the words every producer thread loads
    for hold ``h`` of a slice, after the in-place byte transpose of each four
    (i = 4 g .. 4 g + 3) of one band and word position."""
    words = np.asarray(box, np.uint8).view(np.uint32)
    p = np.arange(PRODUCER_THREADS)
    bands, nw = plane_bands(width), hold_words(width)
    hold = np.zeros((bands, 8, nw, len(p)), np.uint32)
    for b in range(bands):
        for i in range(8):
            addr = load_address(p, b, i, h, width)
            for v in range(nw):
                hold[b, i, v] = words[(addr + 4 * v) // 4]
    for b in range(bands):
        for g in range(2):
            for v in range(nw):
                hold[b, 4 * g : 4 * g + 4, v] = transpose4(*hold[b, 4 * g : 4 * g + 4, v])
    return hold


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


def penalty_rows(pen, block=None, width=32):
    # type: (np.ndarray, int | None, int) -> np.ndarray
    """The penalties of tile rows r = 4 s' + j1 from the flat penalty in the
    twin's dot-column order (f32 from bf16 bits at W = 32, else int32):
    (128,) of ``block``, or (N / 128, 128) of every block."""
    flat = np.asarray(pen).reshape(-1)
    r = np.arange(BLOCK_ROWS)
    blocks = np.arange(flat.size // BLOCK_ROWS) if block is None else np.asarray(block)
    g, j0 = np.divmod(blocks, GROUP_BLOCKS)
    at = (g * GROUP_BLOCKS * BLOCK_ROWS + j0)[..., None] + (r >> 2) * 128 + (r & 3) * 32
    if width < 32:
        return flat.astype(np.int32)[at]
    return (flat.view(np.uint16)[at].astype(np.uint32) << 16).view(np.float32)


def pen_words(pen, slice_index, w, lane, pair=0, width=32):
    # type: (np.ndarray, int, int, int, int, int) -> np.ndarray
    """What producer warp ``w``'s lane reads for its block pair ``pair`` of a
    slice (``load_pens``), per band j for row 4 lane + j: (4,) uint32 words
    holding the bf16 penalty of block 8 pair + 2 w in the low half and of
    the next block in the high half at W = 32; (4, 2) int32 of the two
    blocks below."""
    flat = np.asarray(pen).reshape(-1)
    g, first = divmod(slice_index * slice_blocks(width), GROUP_BLOCKS)
    at = g * GROUP_BLOCKS * BLOCK_ROWS + lane * 128 + np.arange(BANDS) * 32 + first + 8 * pair + 2 * w
    if width < 32:
        return np.stack([flat[at], flat[at + 1]], axis=1).astype(np.int32)
    bits = flat.view(np.uint16)
    return bits[at].astype(np.uint32) | bits[at + 1].astype(np.uint32) << 16


def plans(p):
    # type: (np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]
    """(fast (B,), pmax (B,), dominated (B, 128)) of B blocks' (B, 128)
    penalties: f32 (kernel 8's ``bf16`` rule) or int32 (the same rule in
    integers, where every value is finite)."""
    p = np.asarray(p)
    if not np.issubdtype(p.dtype, np.integer):
        fast, pmax, source = vl.plans(ek.EPI_BF16, p)
        return fast, pmax, source != np.arange(BLOCK_ROWS)
    pmax = p.max(axis=1)
    below = p != pmax[:, None]
    fast = ((~below) | (p.astype(np.int64) <= pmax[:, None].astype(np.int64) - DOMINANCE)).all(axis=1)
    return fast, pmax, fast[:, None] & below


def block_plan(p):
    # type: (np.ndarray) -> tuple[bool, float | int, np.ndarray, int]
    """(fast, pmax, dominated masks, first top row) of one block's (128,)
    penalties: mask j1 has bit s' set where row 4 s' + j1 is replaced (fast
    blocks only), as the kernel's ballots build them."""
    p = np.asarray(p)
    fast, pmax, dom = plans(p[None, :])
    masks = np.array([sum(1 << s for s in range(32) if dom[0, 4 * s + j1]) for j1 in range(BANDS)], np.uint64)
    with np.errstate(invalid="ignore"):
        first_top = int(np.argmax(p == pmax[0]))
    return bool(fast[0]), pmax[0].item(), masks, first_top


def path_blocks(pen, nq, width=32):
    # type: (np.ndarray, int, int) -> tuple[int, int]
    """(blocks the kernel finishes, those of them on the fast path) of one
    call with ``nq`` queries: every block once per query chunk."""
    fast = plans(penalty_rows(pen, width=width))[0]
    chunks = -(-nq // CHUNK_QUERIES)
    return len(fast) * chunks, int(fast.sum()) * chunks


# ------------------------------------------------------------ the flow


def untranspose(box, c, masks, first_top, width=32):
    # type: (np.ndarray, int, np.ndarray, int, int) -> np.ndarray
    """The (32 KiB,) uint8 row tile of block c of a slice as the producer's
    128 threads write it from their hold (:func:`load_hold`): one 8-byte
    store per row; then each row whose bit is set in ``masks`` is stored
    again with the words of row ``first_top``, which each thread shuffles in
    from the lane of its own K bytes that holds that row."""
    p = np.arange(PRODUCER_THREADS)
    j1, u0 = producer_thread(p)
    hold = load_hold(box, c // HOLD_BLOCKS, width)
    c %= HOLD_BLOCKS
    sp_t, j1_t = first_top >> 2, first_top & 3
    tile = np.zeros(S8_TILE_BYTES, np.uint8)

    def store(rows, threads, words):
        for g in range(2):
            for k in range(4):
                tile[s8_offset(rows, u0[threads] + 4 * g + k)] = (words[g] >> np.uint32(8 * k)) & 0xFF

    for sp in range(32):
        store(4 * sp + j1, p, [plane_word(hold, c, g, sp, width) for g in range(2)])
    if masks.any():
        src = (p & ~3) | j1_t  # __shfl_sync from the lane with j1 = j1_t
        top = [plane_word(hold, c, g, sp_t, width)[src] for g in range(2)]
        mine = masks[j1]
        for sp in range(32):
            sub = ((mine >> np.uint64(sp)) & np.uint64(1)).astype(bool)
            store(4 * sp + j1[sub], p[sub], [top[g][sub] for g in range(2)])
    return tile


def tile_rows(tile):
    # type: (np.ndarray) -> np.ndarray
    """The (128, 256) int8 rows wgmma reads from a row tile, in K order."""
    r = np.arange(BLOCK_ROWS)[:, None]
    k = np.arange(BITS)[None, :]
    return tile[s8_offset(r, k)].astype(np.int8)


def shares(nslices, sms=SMS):
    # type: (int, int) -> list[tuple[int, int]]
    """(first slice, one past the last) of every thread block of a launch."""
    ctas = min(nslices, sms)
    return [(cta * nslices // ctas, (cta + 1) * nslices // ctas) for cta in range(ctas)]


def run(q, qs, twin, pen, width=32, sms=SMS, counts=None):
    # type: (np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int, list | None) -> np.ndarray
    """
    The kernel's output, computed along its flow: launches per query chunk,
    shares of slices, the plan and the un-transpose with its substitution,
    the dots of the permuted queries with the row tile, both paths of the
    width's epilogue, the gather.

    :param q: (Q, 256) int8 ±1/0
    :param qs: (Q,) float32
    :param twin: ``bit_transpose_packed`` (N / 16, 128) uint32 / int32 twin at
        W = 32, else ``build_twin``'s (N * bands / 16, 128) uint8 / int16
    :param pen: (N,) bf16 bits (uint16 / int16) in ``bitplane_penalty_perm``
        order at W = 32, else int32 in ``penalty_perm`` order
    :param counts: a list [finished, fast] the flow adds its blocks to
    :return: (Q, N / 128) float32; NaN where nothing was written
    """
    twin = np.ascontiguousarray(twin)
    nq = q.shape[0]
    nblocks = twin.shape[0] // (plane_bands(width) * BITS) * GROUP_BLOCKS
    sb = slice_blocks(width)
    out = np.full((nq, nblocks), np.nan, np.float32)
    qsum_all = q.astype(np.int64).sum(axis=1)
    q_k = q[:, k_to_u(np.arange(BITS), width)].astype(np.float32)  # the query tile's K order
    for q0 in range(0, nq, CHUNK_QUERIES):
        qi = np.arange(q0, min(nq, q0 + CHUNK_QUERIES))
        qf, qsum, s = q_k[qi], qsum_all[qi], qs[qi]
        for first, end in shares(nblocks // sb, sms):
            for sl in range(first, end):
                box = slice_box(twin, sl, width)
                for c in range(sb):
                    block = sl * sb + c
                    p = penalty_rows(pen, block, width)
                    fast, pmax, masks, first_top = block_plan(p)
                    rows = tile_rows(untranspose(box, c, masks, first_top, width))
                    dot = (qf @ rows.astype(np.float32).T).astype(np.int64)
                    if width < 32:
                        m = dot.max(axis=1) + pmax if fast else (dot + p[None, :]).max(axis=1)
                        e = (2 * m - qsum).astype(np.float32)
                    elif fast:
                        e = vl.element(ek.EPI_BF16, (2 * dot - qsum[:, None]).max(axis=1), pmax)
                    else:
                        y = 2 * dot - qsum[:, None]
                        e = vl.finish_general(ek.EPI_BF16, vl._fmax_rows(vl.general(ek.EPI_BF16, y, p[None, :])))
                    if counts is not None:
                        counts[0] += 1
                        counts[1] += int(fast)
                    out[qi, block] = vl.finalize(ek.EPI_BF16, e, s)
    return out
