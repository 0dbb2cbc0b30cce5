"""
The fragment maps, bit order and work split of ``csrc/blockmax_small.cu``
(the small-batch phase 1 on ``mma.sync.m16n8k32.s8``), mirrored in Python so
that the kernel's flow can be run lane by lane on the CPU
(``tests/test_torch_small_layout.py``).

- Rows are the MMA's M side (16-row m-tiles), queries its N side (n-tiles
  of 8), the 32 bits of one packed word one k-step. Lane ``4 g + t`` holds
  (PTX ISA, ``mma.m16n8k32`` with 8-bit operands; :func:`a_coords`,
  :func:`b_coords`, :func:`c_coords`):

  - A register ``i`` byte ``j``: row ``g + 8 (i % 2)``, k ``4 t + j + 16 (i // 2)``;
  - B register ``i`` byte ``j``: k ``4 t + j + 16 i``, column ``g``;
  - C register ``i``: row ``g + 8 (i // 2)``, column ``2 t + i % 2``.

- k-position ``k`` of a k-step is bit :func:`bit_of_k` of the word: ``4 t +
  j`` is bit ``2 t + 8 j``, ``16 + 4 t + j`` is bit ``2 t + 1 + 8 j``. So
  lane ``(g, t)``'s A registers are ``word & (0x01010101 << 2 t)`` and
  ``(word >> 1) & (0x01010101 << 2 t)`` (:func:`a_registers`: bytes 0 or
  ``4 ** t``), and its B registers the same bits of the query's word as
  bytes ``±2 ** (6 - 2 t)`` (:func:`b_registers`): every product is
  :data:`PRODUCT_SCALE` times the 0/1 row bit times the ±1 query bit.
- From :data:`WGMMA_TILES` n-tiles on, the same A registers feed ``wgmma``
  (the RS form, ``m64nNk32``: each warp's 16 rows, the same fragment) and B
  lies in shared memory as K-major core matrices (``ops/wgmma_layout.py``);
  below, ``mma.sync`` reads B in fragment order (:func:`b_word`).
- A batch is chunks of up to :data:`MAX_QUERIES` queries, each padded to
  :func:`ntiles` n-tiles; a persistent grid of :func:`grid` thread blocks,
  each of :data:`WARPS` warps, splits the blocks contiguously over all its
  warps (:func:`share_begin`); each warp streams its blocks through a ring
  of :func:`ring_stages` stages and gathers the maxima of
  :data:`OUT_BLOCKS` consecutive blocks before it writes them.
"""

from __future__ import annotations

BLOCK_ROWS = 128
WARPS = 8  # kWarps
MAX_QUERIES = 128  # kMaxQueries: 16 n-tiles of 8
OUT_BLOCKS = 8  # kOutBlocks: one 32-byte sector of a query's maxima
NTILE_CHOICES = (1, 2, 4, 8, 12, 16)  # the instantiated n-tile counts (launch_lanes)
WGMMA_TILES = 8  # kWgmmaTiles: n-tiles from which the kernel takes wgmma
BYTE_BITS = 0x01010101
PRODUCT_SCALE = 64  # A byte 2^2t times B byte ±2^(6-2t)
INVALID_PENALTY = 65536
SMEM_LIMIT = 232448  # bytes of shared memory a thread block may take on an H100
SMEM_PER_SM = 233472  # bytes of shared memory of one SM, 1,024 of them reserved per thread block


def bit_of_k(k):
    # type: (int) -> int
    """The bit of a packed word (bit 0 the least significant) that k-position
    ``k`` (0..31) of the word's k-step carries."""
    t, j = k % 16 // 4, k % 4
    return 2 * t + 8 * j + (1 if k >= 16 else 0)


def a_coords(lane, reg, byte):
    # type: (int, int, int) -> tuple[int, int]
    """(row, k) of byte ``byte`` of A register ``reg`` of ``lane``."""
    g, t = lane // 4, lane % 4
    return g + 8 * (reg % 2), 4 * t + byte + 16 * (reg // 2)


def b_coords(lane, reg, byte):
    # type: (int, int, int) -> tuple[int, int]
    """(k, column) of byte ``byte`` of B register ``reg`` of ``lane``."""
    g, t = lane // 4, lane % 4
    return 4 * t + byte + 16 * reg, g


def c_coords(lane, reg):
    # type: (int, int) -> tuple[int, int]
    """(row, column) of C register ``reg`` of ``lane``."""
    g, t = lane // 4, lane % 4
    return g + 8 * (reg // 2), 2 * t + reg % 2


def a_registers(word_g, word_g8, t):
    # type: (int, int, int) -> tuple[int, int, int, int]
    """Lane ``(g, t)``'s A registers of one k-step from the words of rows
    ``g`` and ``g + 8`` of the m-tile: bytes 0 or ``4 ** t``. Ints or
    integer arrays that broadcast."""
    bits = BYTE_BITS << 2 * t
    w0, w1 = word_g & 0xFFFFFFFF, word_g8 & 0xFFFFFFFF
    return w0 & bits, w1 & bits, (w0 >> 1) & bits, (w1 >> 1) & bits


def signed_bytes(bits01, e):
    # type: (int, int) -> int
    """Four bytes of ``+2 ** e`` (from a 1 byte) or ``-2 ** e`` (from a 0
    byte), two's complement, each byte apart (``signed_bytes``, ``__vsub4``)."""
    out = 0
    for j in range(4):
        bit = (bits01 >> 8 * j) & 1
        out |= (((2 * bit - 1) << e) & 0xFF) << 8 * j
    return out


def b_registers(word, t, live):
    # type: (int, int, bool) -> tuple[int, int]
    """Lane ``(g, t)``'s B registers of one k-step for its query's word:
    bytes ``±2 ** (6 - 2 t)``, or zero where the word lies past the query's
    common prefix (``live`` False) or the query past the chunk."""
    if not live:
        return 0, 0
    w = word & 0xFFFFFFFF
    return signed_bytes((w >> 2 * t) & BYTE_BITS, 6 - 2 * t), signed_bytes((w >> (2 * t + 1)) & BYTE_BITS, 6 - 2 * t)


def b_word(ks, qi, k4, nt):
    # type: (int, int, int, int) -> int
    """Index (in 4-byte words) of the B bytes of k-positions ``4 k4 ..
    4 k4 + 3`` of k-step ``ks`` for query ``qi`` of the chunk in shared
    memory: fragment order below :data:`WGMMA_TILES` n-tiles (lane ``4 (qi
    % 8) + k4 % 4`` of n-tile ``qi // 8``, register ``k4 // 4``), else the
    K-major core-matrix image of ``wgmma`` (k-chunk ``2 ks + k4 // 4``, a
    panel of ``8 nt`` queries of 16 bytes)."""
    t, h = k4 % 4, k4 // 4
    if nt >= WGMMA_TILES:
        return (2 * ks + h) * nt * 8 * 4 + (qi // 8) * 32 + (qi % 8) * 4 + t
    return ((ks * nt + qi // 8) * 32 + (qi % 8) * 4 + t) * 2 + h


def ntiles(nq):
    # type: (int) -> int
    """n-tiles of a chunk for a batch of ``nq`` queries."""
    tiles = -(-min(nq, MAX_QUERIES) // 8)
    return next(n for n in NTILE_CHOICES if tiles <= n)


def ring_stages(lanes):
    # type: (int) -> int
    """Block-sized stages of each warp's ring."""
    return min(8, max(2, 16 // lanes))


def ctas_per_sm(nt):
    # type: (int) -> int
    """Thread blocks per SM the launch is sized for (``ctas_per_sm``)."""
    return 2 if nt <= 8 else 1


def grid(nblocks, nq, sm_count):
    # type: (int, int, int) -> tuple[int, int]
    """(thread blocks along x, query chunks along y) of a launch."""
    nt = ntiles(nq)
    return min(ctas_per_sm(nt) * sm_count, -(-nblocks // WARPS)), -(-nq // (8 * nt))


def share_begin(cta, warp, ctas, nblocks):
    # type: (int, int, int, int) -> int
    """First block of warp ``warp`` (``WARPS``: the end of the share) of
    thread block ``cta``."""
    return (cta * WARPS + warp) * nblocks // (ctas * WARPS)


def smem_bytes(lanes, nt):
    # type: (int, int) -> int
    """Dynamic shared memory of one thread block (``Smem::kBytes``)."""
    stages = WARPS * ring_stages(lanes)
    rows = -(-(stages * 8) // 128) * 128
    return (rows + stages * BLOCK_ROWS * lanes * 4 + stages * BLOCK_ROWS + lanes * nt * 32 * 8
            + nt * 8 * 8 + WARPS * nt * 8 * (OUT_BLOCKS + 1) * 4)
