"""
The flow of ``csrc/blockmax_variants.cu`` (TPU kernel 8's phase-1 epilogue
probes on ``wgmma``) mirrored in numpy, so that it runs on the CPU
(``tests/test_torch_variant_layout.py``). Constants the tests read back
from the ``.cu`` source carry its names.

- **Launches and shares.** One persistent launch per chunk of
  :data:`CHUNK_QUERIES` queries, of ``min(units, sms)`` thread blocks; the
  unit is a 128-row block, or a 4,096-row sub-tile for the sub-tile
  epilogues (consume, tree2d), whose state lives across a sub-tile's
  blocks. Each thread block's contiguous share of units is cut into
  :func:`teams` contiguous parts (two teams for the int8 epilogues, one for
  the bf16 ones); every team makes the same number of steps, and a step
  past a team's last block repeats the thread block's last block with its
  epilogue skipped (:class:`Share`).
- **The penalty, once per block** (:func:`plans`): ``pmax`` is the block's
  largest penalty. Every dot lies in [-256, 256], so a row whose penalty is
  ``<= pmax - 512`` can never hold the block's maximum; where every other
  row is at ``pmax`` (and all are finite), the dominated rows are replaced
  by the block's first row at ``pmax`` on their way into the row tile, and
  the block takes the fast path: the plain maximum of the dots, then one
  :func:`element` per query. For ``u8max`` the fast path needs every
  penalty in {0, 1}. Any other block keeps its rows and takes the
  per-element path (:func:`general`, :func:`finish_general`): the maximum
  of the f32 sums ``dot + p``, rounded to bf16 once. ``tree2d`` always takes
  it. Its maxima are ``fmaxf``'s, which drop a NaN penalty that the plain
  version's ``amax`` keeps (NaN is outside the wrapper's contract).
  :func:`path_blocks` counts the blocks on each path as the kernel does. The int8 kernel's rows land by TMA, one 128-byte x 128-row box per
  swizzle atom (:func:`s8_offset`), and the dominated rows are then
  overwritten in the tile; the bf16 kernel reads rows into registers and
  substitutes as it reads.
- **Output.** Block maxima of :data:`OUT_BLOCKS` consecutive blocks are
  gathered per query and flushed when the gather is full or the team's
  share ends (:func:`flush_range`); ``trans`` writes each block's scores
  straight into its row; ``dotonly*`` store the first 32 dots of a
  sub-tile's first block; consume and tree2d flush at a sub-tile's last
  block.
- **bf16 operands** (``bf16dot``, ``dotonly_bf16``): int8 values become bf16
  through the f32 bits ``0x4B0000uu`` (:func:`s8x4_bf16x4`, PRMT
  selectors as in the kernel), and land in K-major core matrices of 8 rows
  x 8 bf16 (:func:`bf16_offset`); one ``m64n128k16`` reads two k-chunks.
"""

from __future__ import annotations

import numpy as np

from iscc_search_tpu_torch.experiments import exp_kernels as ek

BLOCK_ROWS = 128
BITS = 256
SUB_BLOCKS = 32  # kGroupBlocks
CLASSES = 32  # kClasses
TILE_QUERIES = 64  # kTileQueries
CHUNK_QUERIES = 256  # kChunkQueries
TEAM_THREADS = 256  # kTeamThreads
OUT_BLOCKS = 8  # kOutBlocks
OUT_STRIDE = OUT_BLOCKS + 1  # kOutStride
SWIZZLE_BYTES = 128  # kSwizzleBytes: the int8 row tile's 128-byte swizzle
S8_ATOM = BLOCK_ROWS * SWIZZLE_BYTES  # kS8Atom: 128 rows x 128 k-bytes, one TMA box
S8_SBO = 8 * SWIZZLE_BYTES  # kS8Sbo
BF16_LBO = BLOCK_ROWS * 16 + 16  # kBf16Lbo: the bf16 row tile's k-chunks
S8_CHUNKS = BITS // 16  # kS8Chunks
BF16_CHUNKS = 2 * S8_CHUNKS  # kBf16Chunks
DOMINANCE = 512.0  # kDominance
MAGIC_BITS = 0x4B000000  # kMagicBits
MAGIC_OFFSET = 8388736.0  # kMagicOffset
INT_MAGIC = 0x4B400000  # kIntMagic
INT_MAGIC_VALUE = 12582912.0  # kIntMagicValue
PERM_BYTES = (0x7440, 0x7441, 0x7442, 0x7443)  # selectors of s8x4_bf16x4: byte i of u under 0x4B
PERM_HIGH = 0x7632  # the top halves of two words
SMEM_LIMIT = 232448  # bytes of shared memory a thread block may take on an H100
SMS = 132

BF16_EPIS = (ek.EPI_BF16DOT, ek.EPI_DOTONLY_BF16)
PEN_EPIS = (ek.EPI_BF16, ek.EPI_TRANS, ek.EPI_U8MAX, ek.EPI_BF16DOT, ek.EPI_TREE2D)
SUB_TILE_EPIS = (ek.EPI_CONSUME, ek.EPI_TREE2D)
GATHER_EPIS = (ek.EPI_BF16, ek.EPI_BF16_NOPEN, ek.EPI_U8MAX, ek.EPI_BF16DOT)
FINISH_MAX_EPIS = GATHER_EPIS + (ek.EPI_TRANS,)  # finishes_max: counted in g_path_blocks


def teams(epi):
    # type: (int) -> int
    return 1 if epi in BF16_EPIS else 2


def s8_smem_bytes(qc):
    # type: (int) -> int
    """Dynamic shared memory of the int8 kernel at ``qc`` resident queries:
    two row tiles per team, the query tile, scales, two penalty slots per
    team, each team's gather and two mbarriers."""
    return (2 * 2 * BITS // SWIZZLE_BYTES * S8_ATOM + S8_CHUNKS * qc * 16 + qc * 4 + 2 * 2 * BLOCK_ROWS * 4
            + 2 * qc * OUT_STRIDE * 4 + 2 * 2 * 8 + 1024)


def bf16_smem_bytes(qc):
    # type: (int) -> int
    """Of the bf16 kernel: one bf16 row tile, the bf16 query tile, scales,
    two penalty slots, the gather."""
    return BF16_CHUNKS * BF16_LBO + BF16_CHUNKS * qc * 16 + qc * 4 + 2 * BLOCK_ROWS * 4 + qc * OUT_STRIDE * 4


# ----------------------------------------------------------- arithmetic


def round_bf16(x):
    # type: (np.ndarray) -> np.ndarray
    """float32 values rounded to the nearest bf16 (ties to even), as f32."""
    x = np.asarray(x, np.float32)
    b = x.view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return np.where(np.isnan(x), x, r)


def byte_perm(x, y, s):
    # type: (int, int, int) -> int
    """PRMT (``__byte_perm``): byte n of the result is byte ``(s >> 4n) & 7``
    of the 8-byte value ``y:x``."""
    both = (y & 0xFFFFFFFF) << 32 | (x & 0xFFFFFFFF)
    return sum(((both >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n) for n in range(4))


def s8x4_bf16x4(w):
    # type: (int) -> tuple[int, int]
    """The kernel's conversion of one word of four int8 values (byte 0
    first) into two words of bf16 pairs (the first in the low half)."""
    u = w ^ 0x80808080
    f = [np.float32(np.uint32(byte_perm(u, MAGIC_BITS, s)).view(np.float32)) - np.float32(MAGIC_OFFSET)
         for s in PERM_BYTES]
    bits = [int(np.float32(v).view(np.uint32)) for v in f]
    return byte_perm(bits[0], bits[1], PERM_HIGH), byte_perm(bits[2], bits[3], PERM_HIGH)


def exact_float(d):
    # type: (np.ndarray) -> np.ndarray
    """The kernel's int32 -> f32 without I2F (|d| < 2^22)."""
    bits = (np.asarray(d, np.int64) + INT_MAGIC).astype(np.uint32)
    return bits.view(np.float32) - np.float32(INT_MAGIC_VALUE)


def bf16_offset(r, k, lbo):
    """Byte offset of bf16 element (row ``r``, k-index ``k``) in a K-major
    no-swizzle tile: core matrices of 8 rows x 16 bytes (8 values), 8-row
    groups 128 bytes apart, k-chunks ``lbo`` apart."""
    return (k // 8) * lbo + (r // 8) * 128 + (r % 8) * 16 + (k % 8) * 2


def s8_offset(r, k):
    """Byte offset of byte ``k`` of row ``r`` in the int8 row tile: two
    atoms of 128 rows x 128 k-bytes in the 128-byte swizzle (the 16-byte
    piece index XOR the row's index within its 8-row group)."""
    return (k // SWIZZLE_BYTES) * S8_ATOM + r * SWIZZLE_BYTES + ((k // 16 % 8) ^ (r % 8)) * 16 + k % 16


def pen_values(epi, pen):
    # type: (int, np.ndarray) -> np.ndarray
    """The flat penalty row as the kernel reads it, in f32: bf16 bits
    (uint16) or uint8 (``u8max``)."""
    pen = np.asarray(pen).reshape(-1)
    if epi == ek.EPI_U8MAX:
        return pen.astype(np.float32)
    return (pen.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def plans(epi, p):
    # type: (int, np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]
    """(fast (B,), pmax (B,), source rows (B, 128)) of B blocks from their
    (B, 128) f32 penalties (ignored for epilogues without one): row ``r``
    of a block's tile holds the bytes of row ``source[b, r]`` of the block."""
    rows = np.broadcast_to(np.arange(BLOCK_ROWS), (len(p), BLOCK_ROWS))
    if epi not in PEN_EPIS or epi == ek.EPI_TREE2D:
        return np.full(len(p), epi != ek.EPI_TREE2D), np.zeros(len(p), np.float32), rows
    with np.errstate(invalid="ignore"):
        pmax = np.fmax.reduce(p, axis=1)  # fmaxf: a NaN loses to any number
        below = p != pmax[:, None]
        if epi == ek.EPI_U8MAX:
            ok = (p == 0) | (p == 1)
        else:
            ok = np.isfinite(p) & ((p == pmax[:, None]) | (p <= pmax[:, None] - np.float32(DOMINANCE)))
    fast = ok.all(axis=1)
    first_top = np.argmax(~below, axis=1)
    source = np.where(fast[:, None] & below, first_top[:, None], rows)
    return fast, pmax, source


def plan(epi, p):
    # type: (int, np.ndarray) -> tuple[bool, float, np.ndarray]
    """:func:`plans` of one block: (fast, pmax, source rows)."""
    fast, pmax, source = plans(epi, np.asarray(p)[None, :])
    return bool(fast[0]), float(pmax[0]), source[0]


def general(epi, d, p):
    # type: (int, np.ndarray, np.ndarray) -> np.ndarray
    """The per-element path's values, whose maximum :func:`finish_general`
    finishes: the f32 sum ``dot + p`` (``u8max``: its element itself)."""
    d = np.asarray(d, np.int64)
    if epi == ek.EPI_U8MAX:
        y = np.clip((d >> 1) + 127, 0, 255)
        return ((y * np.asarray(p).astype(np.int64)) & 0xFF).astype(np.float32)
    return exact_float(d) + np.asarray(p, np.float32)


def element(epi, m, p):
    # type: (int, np.ndarray, float) -> np.ndarray
    """The fast path's one element per query: ``m`` the block's largest
    dots (int), ``p`` = pmax."""
    m = np.asarray(m, np.int64)
    if epi == ek.EPI_U8MAX:
        return general(epi, m, p)
    if epi == ek.EPI_BF16_NOPEN:
        return m.astype(np.float32)
    if epi == ek.EPI_BF16DOT:
        return m.astype(np.float32) + np.float32(p)
    return round_bf16(round_bf16(m.astype(np.float32)) + np.float32(p))


def finish_general(epi, v):
    # type: (int, np.ndarray) -> np.ndarray
    return v if epi in (ek.EPI_BF16DOT, ek.EPI_U8MAX) else round_bf16(v)


def finalize(epi, e, qs):
    # type: (int, np.ndarray, np.ndarray) -> np.ndarray
    """The score of an element: ``(e - 127) * 2`` for ``u8max``, else
    ``0.5 + e * qs`` rounded once."""
    if epi == ek.EPI_U8MAX:
        return (np.asarray(e, np.float32) - np.float32(127)) * np.float32(2)
    return (0.5 + np.asarray(e, np.float64) * np.asarray(qs, np.float64)).astype(np.float32)


# ----------------------------------------------------------- shares


class Share:
    """A team's blocks: ``first``..``end`` (one past), the thread block's
    ``last`` block and the team's ``steps``."""

    def __init__(self, first, end, last, steps):
        self.first, self.end, self.last, self.steps = first, end, last, steps

    def block_of(self, step):
        # type: (int) -> int
        return min(self.first + step, self.last)

    def real(self, step):
        # type: (int) -> bool
        return self.first + step < self.end


def grid(epi, nblocks, sms=SMS):
    # type: (int, int, int) -> int
    """Thread blocks of one launch: one per SM, at most one per unit."""
    return min(nblocks // (SUB_BLOCKS if epi in SUB_TILE_EPIS else 1), sms)


def share_of(nblocks, unit, nteams, team, cta, ctas):
    # type: (int, int, int, int, int, int) -> Share
    units = nblocks // unit
    u0, u1 = cta * units // ctas, (cta + 1) * units // ctas
    team_units = -(-(u1 - u0) // nteams)
    t0 = min(u0 + team * team_units, u1)
    t1 = min(t0 + team_units, u1)
    return Share(t0 * unit, t1 * unit, u1 * unit - 1, team_units * unit)


def shares(epi, nblocks, sms=SMS):
    # type: (int, int, int) -> list[Share]
    """Every team's share of one launch, thread block by thread block."""
    ctas = grid(epi, nblocks, sms)
    unit = SUB_BLOCKS if epi in SUB_TILE_EPIS else 1
    return [share_of(nblocks, unit, teams(epi), team, cta, ctas) for cta in range(ctas) for team in range(teams(epi))]


def flush_range(block, sh):
    # type: (int, Share) -> tuple[int, int] | None
    """(first slot, last slot) of the gather that leaves after ``block``,
    or None: the gather leaves when it is full or the team's share ends;
    its first slot is the team's first block where that lies in it."""
    slot = block % OUT_BLOCKS
    if slot == OUT_BLOCKS - 1 or block == sh.end - 1:
        return max(slot - (block - sh.first), 0), slot
    return None


# ------------------------------------------------------------ the flow


def fast_share(epi, pen):
    # type: (int, np.ndarray) -> float
    """The share of blocks that take the fast path."""
    return float(plans(epi, pen_values(epi, pen).reshape(-1, BLOCK_ROWS))[0].mean())


def path_blocks(epi, pen, nq):
    # type: (int, np.ndarray, int) -> tuple[int, int]
    """(blocks whose maxima the kernel finishes, those of them on the fast
    path) of one call with ``nq`` queries, as its ``g_path_blocks`` counts
    them: every block once per query chunk; (0, 0) for the epilogues
    without block maxima."""
    if epi not in FINISH_MAX_EPIS:
        return 0, 0
    fast = plans(epi, pen_values(epi, pen).reshape(-1, BLOCK_ROWS))[0]
    chunks = -(-nq // CHUNK_QUERIES)
    return len(fast) * chunks, int(fast.sum()) * chunks


def _fmax_rows(v):
    # type: (np.ndarray) -> np.ndarray
    """The kernel's per-element maximum over axis 1: ``fmaxf`` from -inf,
    so a NaN is dropped (all NaN gives -inf)."""
    return np.fmax(np.fmax.reduce(v, axis=1), np.float32(-np.inf))


def run(epi, q, qs, db, pen, db_wrap=0, sms=SMS, counts=None):
    # type: (int, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int) -> np.ndarray
    """
    The kernel's output, computed along its flow: launches per query chunk,
    teams' shares and steps, the per-block plan and row substitution, the
    epilogue, gathers and sub-tile flushes.

    :param q: (Q, 256) int8 ±1/0
    :param qs: (Q,) float32
    :param db: (N, 256) int8 ±1
    :param pen: (N,) bf16 bits as uint16 / int16, or uint8 (``u8max``)
    :param db_wrap: 0, or rows read again and again (row r reads r % db_wrap)
    :param sms: the card's SMs (the grid's size)
    :param counts: a list [finished, fast] the flow adds its blocks to, as
        the kernel adds them to ``g_path_blocks``
    :return: (Q, N / 128) float32, (N / 128, Q) for ``trans``; NaN where
        nothing was written
    """
    nq, nrows = q.shape[0], db.shape[0]
    nblocks = nrows // BLOCK_ROWS
    src = np.arange(nrows) % db_wrap if db_wrap else np.arange(nrows)
    dots = (q.astype(np.float32) @ db[src].astype(np.float32).T).astype(np.int64)
    p_all = pen_values(epi, pen) if epi in PEN_EPIS else np.zeros(nrows, np.float32)
    trans = epi == ek.EPI_TRANS
    out = np.full((nblocks, nq) if trans else (nq, nblocks), np.nan, np.float32)
    for q0 in range(0, nq, CHUNK_QUERIES):
        qi = np.arange(q0, min(nq, q0 + CHUNK_QUERIES))
        d_chunk, s = dots[qi], qs[qi]
        for sh in shares(epi, nblocks, sms):
            sums = np.zeros(len(qi), np.int64)
            cls = np.full((len(qi), CLASSES), -np.inf, np.float32)
            gather = np.full((len(qi), OUT_BLOCKS), np.nan, np.float32)
            for step in range(sh.steps):
                block = sh.block_of(step)
                if not sh.real(step):
                    continue  # the wgmmas are issued, the epilogue skipped
                rows = slice(block * BLOCK_ROWS, (block + 1) * BLOCK_ROWS)
                p = p_all[rows]
                fast, pmax, source = plan(epi, p)
                tile = d_chunk[:, block * BLOCK_ROWS + source]  # the dots of the rows in the tile
                sub, r = divmod(block, SUB_BLOCKS)
                cols = slice(sub * CLASSES, (sub + 1) * CLASSES)
                if epi in (ek.EPI_DOTONLY, ek.EPI_DOTONLY_BF16):
                    if r == 0:
                        out[qi, cols] = tile[:, :CLASSES]
                elif epi == ek.EPI_CONSUME:
                    sums += tile.sum(axis=1)
                    if r == SUB_BLOCKS - 1:
                        out[qi, cols] = sums[:, None]
                        sums[:] = 0
                elif epi == ek.EPI_TREE2D:
                    v = general(epi, tile, p[None, :])
                    cls = np.fmax(cls, _fmax_rows(v.reshape(len(qi), BLOCK_ROWS // CLASSES, CLASSES)))
                    if r == SUB_BLOCKS - 1:
                        out[qi, cols] = finalize(epi, round_bf16(cls), s[:, None])
                        cls[:] = -np.inf
                else:
                    if fast:
                        e = element(epi, tile.max(axis=1), pmax)
                    else:
                        e = finish_general(epi, _fmax_rows(general(epi, tile, p[None, :])))
                    if counts is not None:
                        counts[0] += 1
                        counts[1] += int(fast)
                    score = finalize(epi, e, s)
                    if trans:
                        out[block, qi] = score
                    else:
                        gather[:, block % OUT_BLOCKS] = score
                        flush = flush_range(block, sh)
                        if flush is not None:
                            first_slot, slot = flush
                            base = block - slot
                            out[qi[:, None], base + np.arange(first_slot, slot + 1)] = gather[:, first_slot : slot + 1]
    return out
