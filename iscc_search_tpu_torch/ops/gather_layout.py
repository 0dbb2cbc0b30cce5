"""
The block-major form of ``csrc/gather_rescore.cu`` (``iscc_gather_rescore_blocks``)
mirrored in numpy, index for index, so that its flow runs on the CPU
(``tests/test_torch_gather_layout.py``).

The kernel inverts ``block_ids`` with a counting sort of the ``P = Q * kk``
(query, slot) pairs by block id, then serves each block once for the pairs
that chose it:

- :func:`count_pairs`: each pair's ``atomicAdd`` on its block's count
  returns its rank in the block's list; the atomics arrive in any order
  (``order``);
- :func:`sum_tiles` and :func:`scan_tiles`: the counts summed per tile of
  :data:`SCAN_TILE` blocks, then turned into exclusive offsets in place,
  thread ``t`` of a tile taking :data:`SCAN_ITEMS` consecutive blocks;
- :func:`scatter_pairs`: ``sorted[offsets[b] + rank[p]] = (p, b)``;
- :func:`serve_blocks`: the sorted list in segments of :data:`SEGMENT`
  pairs, one 128-thread block each; a segment is runs of pairs of one block
  (warp 0's ballot marks where each starts), the run's rows are loaded once
  (the next run's while this one is served), and each pair's 128 dots
  written to ``out[p * 128 : p * 128 + 128]``.

:func:`workspace_words` is the size of the int32 workspace the wrapper
allocates: ``sorted`` (2 words per pair), ``rank`` (1 per pair), the block
counts and the tile sums, in that order.
"""

from __future__ import annotations

import numpy as np

BLOCK_ROWS = 128
SEGMENT = 32  # kSegment: pairs of the sorted list per serving thread block
SCAN_THREADS = 256  # kScanThreads
SCAN_ITEMS = 16  # kScanItems
SCAN_TILE = SCAN_THREADS * SCAN_ITEMS  # kScanTile


def ntiles(nblocks):
    # type: (int) -> int
    return -(-nblocks // SCAN_TILE)


def workspace_words(npairs, nblocks):
    # type: (int, int) -> int
    """int32 words of the block-major form's workspace for ``npairs`` pairs
    over a partition of ``nblocks`` blocks."""
    return 3 * npairs + nblocks + ntiles(nblocks)


def count_pairs(block_ids, nblocks, order):
    # type: (np.ndarray, int, np.ndarray) -> tuple[np.ndarray, np.ndarray]
    """(counts (nblocks,), rank (P,)): the atomics of the pairs of the flat
    ``block_ids`` applied in the order ``order`` (a permutation of the
    pairs), each returning the count it found."""
    counts = np.zeros(nblocks, np.int64)
    rank = np.empty(len(block_ids), np.int64)
    for p in order:
        b = block_ids[p]
        rank[p] = counts[b]
        counts[b] += 1
    return counts, rank


def sum_tiles(counts):
    # type: (np.ndarray) -> np.ndarray
    """Per tile: thread t sums blocks ``tile * SCAN_TILE + i * SCAN_THREADS + t``
    for ``i < SCAN_ITEMS``, then the thread block sums its threads."""
    nblocks = len(counts)
    sums = np.zeros(ntiles(nblocks), np.int64)
    for tile in range(len(sums)):
        b = tile * SCAN_TILE + np.arange(SCAN_ITEMS)[:, None] * SCAN_THREADS + np.arange(SCAN_THREADS)[None, :]
        per_thread = np.where(b < nblocks, counts[np.minimum(b, nblocks - 1)], 0).sum(axis=0)
        sums[tile] = per_thread.sum()
    return sums


def scan_tiles(counts, tile_sums):
    # type: (np.ndarray, np.ndarray) -> np.ndarray
    """The offsets ``scan_tiles`` writes over the counts: tile ``k``'s base
    is the sum of ``tile_sums[:k]``; thread ``t`` holds blocks ``k *
    SCAN_TILE + t * SCAN_ITEMS + i``, its prefix is the exclusive scan of the
    threads' totals, and it writes running offsets over its items."""
    nblocks = len(counts)
    offsets = counts.copy()
    for tile in range(len(tile_sums)):
        base = int(tile_sums[:tile].sum())
        first = tile * SCAN_TILE + np.arange(SCAN_THREADS) * SCAN_ITEMS
        b = first[:, None] + np.arange(SCAN_ITEMS)[None, :]
        v = np.where(b < nblocks, counts[np.minimum(b, nblocks - 1)], 0)
        own = v.sum(axis=1)
        prefix = np.concatenate([[0], np.cumsum(own)[:-1]])
        run = base + prefix[:, None] + np.concatenate([np.zeros((SCAN_THREADS, 1), np.int64), np.cumsum(v, axis=1)[:, :-1]], axis=1)
        inside = b < nblocks
        offsets[b[inside]] = run[inside]
    return offsets


def scatter_pairs(block_ids, offsets, rank):
    # type: (np.ndarray, np.ndarray, np.ndarray) -> np.ndarray
    """(P, 2) sorted (pair, block): entry ``offsets[b] + rank[p]`` is ``(p, b)``.
    Every entry is written once (else -1 stays, which the tests refuse)."""
    sorted_pairs = np.full((len(block_ids), 2), -1, np.int64)
    pos = offsets[block_ids] + rank
    sorted_pairs[pos, 0] = np.arange(len(block_ids))
    sorted_pairs[pos, 1] = block_ids
    return sorted_pairs


def serve_blocks(q_packed, min_lanes, kk, db, sorted_pairs):
    # type: (np.ndarray, np.ndarray, int, np.ndarray, np.ndarray) -> tuple[np.ndarray, np.ndarray, int]
    """(out (P * 128,) float32, writes per output column, row-block loads):
    segment ``s`` of :data:`SEGMENT` sorted pairs, thread ``t`` the block's
    row ``t``; one load of rows per run of one block, and each entry writes
    ``32 * ml - 2 * popc`` over the first ``ml`` lanes to
    ``out[p * 128 + t]``."""
    lanes = db.shape[1]
    npairs = len(sorted_pairs)
    out = np.full(npairs * BLOCK_ROWS, np.nan, np.float32)
    writes = np.zeros(npairs * BLOCK_ROWS, np.int64)
    loads = 0
    t = np.arange(BLOCK_ROWS)
    qw = q_packed.view(np.uint32)
    dbw = db.view(np.uint32)
    for begin in range(0, npairs, SEGMENT):
        entries = sorted_pairs[begin : begin + SEGMENT]
        n = len(entries)
        # Warp 0's ballot: lane j starts a run where its block differs from lane j - 1's.
        runs = sum(1 << j for j in range(n) if j == 0 or entries[j, 1] != entries[j - 1, 1])
        rows = dbw[entries[0, 1] * BLOCK_ROWS + t]  # (128, lanes), asked for before the staging
        loads += 1
        while runs:
            start = (runs & -runs).bit_length() - 1
            runs &= runs - 1
            end = (runs & -runs).bit_length() - 1 if runs else n
            nxt = None
            if runs:  # the next run's rows, in flight while this run is served
                nxt = dbw[entries[end, 1] * BLOCK_ROWS + t]
                loads += 1
            for p, b in entries[start:end]:
                if b != entries[start, 1]:
                    raise AssertionError("a run holds one block")
                qi = p // kk
                ml = max(0, min(int(min_lanes[qi]), lanes))
                x = np.ascontiguousarray(rows[:, :ml] ^ qw[qi, :ml][None, :])
                h = np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1, dtype=np.int64)
                out[p * BLOCK_ROWS + t] = 32 * ml - 2 * h
                writes[p * BLOCK_ROWS + t] += 1
            rows = nxt
    return out, writes, loads


def gather_blocks(q_packed, min_lanes, block_ids, db, order=None):
    # type: (np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray | None) -> dict
    """The whole block-major flow on numpy arrays: ``q_packed`` (Q, >=
    lanes) int32, ``min_lanes`` (Q,), ``block_ids`` (Q, kk), ``db`` (cap,
    lanes) int32; ``order`` the atomics' arrival order (the pairs' own
    order if None). Returns the stages' outputs, and ``out`` as (Q, kk *
    128) float32."""
    nq, kk = block_ids.shape
    nblocks = db.shape[0] // BLOCK_ROWS
    flat = block_ids.reshape(-1).astype(np.int64)
    order = np.arange(len(flat)) if order is None else order
    counts, rank = count_pairs(flat, nblocks, order)
    tile_sums = sum_tiles(counts)
    offsets = scan_tiles(counts, tile_sums)
    sorted_pairs = scatter_pairs(flat, offsets, rank)
    out, writes, loads = serve_blocks(q_packed, min_lanes, kk, db, sorted_pairs)
    return {
        "counts": counts, "rank": rank, "tile_sums": tile_sums, "offsets": offsets, "sorted": sorted_pairs,
        "writes": writes, "loads": loads, "out": out.reshape(nq, kk * BLOCK_ROWS),
    }
