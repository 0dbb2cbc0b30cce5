"""
The flow of ``csrc/select_rescore.cu`` (``iscc_select_rescore``, phases 2-3
of a scan in one launch) mirrored in numpy, step for step, so that it runs on
the CPU (``tests/test_torch_select_layout.py``) and the kernel's output can
be held to it exactly on the card, tie order included.

One thread block serves one query:

- phase 2, :func:`select_blocks`: where the row of block maxima is whole
  super-blocks of :data:`SUPER_BLOCK` and more than ``2 * kk`` of them (and
  at most :data:`MAX_CANDIDATES`, the keys' shared array), the super-block
  maxima, the top-kk super-blocks, their blocks' maxima and the top-kk
  blocks among them; otherwise one flat selection over the row. Each
  selection (:func:`select_top`) is a radix select of the kk-th largest key
  (:func:`kth_largest`, four 8-bit digits) and the keys above it, then the
  first keys equal to it, by position;
- phase 3, :func:`select_rescore`: each candidate row's bin (its prefix
  Hamming distance h, or :data:`INVALID_BIN`), then a stable counting sort by
  bin over the kernel's walk: warp ``w`` takes candidate blocks ``j = w, w +
  WARPS, ...``, 32 rows a step, so a place is the (bin, warp) base plus the
  rank in the warp's walk. The first ``out_k`` places are the result.

:func:`check_contract` holds an output, the kernel's or the mirror's, to the
contract of the chain it replaces, on the CPU and on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from iscc_search_tpu_torch.ops.pm1_scan import NEG_SCORE, masked_queries, unpack_pm1

WARPS = 8  # kWarps: 256 threads a query
BLOCK_ROWS = 128  # kBlockRows
SUPER_BLOCK = 128  # kSuperBlock
MAX_CANDIDATES = 8192  # kMaxCandidates (FUSED_MAX_CANDIDATES of ops/hopper_scan.py)
INVALID_BIN = 257  # kInvalidBin


def order_keys(values):
    # type: (np.ndarray) -> np.ndarray
    """float32 values as uint32 keys of the same order (``order_key``)."""
    u = np.ascontiguousarray(values, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def kth_largest(keys, k):
    # type: (np.ndarray, int) -> tuple[int, int]
    """(the k-th largest key, how many keys equal to it belong to the top
    k), by four passes of 8-bit digits over the keys that share the prefix
    chosen so far, each choosing the digit where the count from the top
    reaches what is left of k."""
    prefix, mask, remaining = 0, 0, k
    for shift in (24, 16, 8, 0):
        same = keys[(keys & mask) == prefix]
        hist = np.bincount((same >> shift) & 255, minlength=256)
        above = 0
        for digit in range(255, -1, -1):
            if above + hist[digit] >= remaining:
                break
            above += hist[digit]
        prefix |= digit << shift
        mask |= 255 << shift
        remaining -= above
    return prefix, remaining


def select_top(keys, k):
    # type: (np.ndarray, int) -> np.ndarray
    """Positions of the top k keys: those above the k-th largest in order,
    then the first of those equal to it (``collect_top``)."""
    kth, take_equal = kth_largest(keys, k)
    return np.concatenate([np.flatnonzero(keys > kth), np.flatnonzero(keys == kth)[:take_equal]])


def select_blocks(row, kk):
    # type: (np.ndarray, int) -> np.ndarray
    """Phase 2 for one query's (nblocks,) float32 block maxima: its kk
    block ids in the kernel's order (``select_blocks``)."""
    nblocks = len(row)
    ns = nblocks // SUPER_BLOCK
    if nblocks % SUPER_BLOCK or ns <= 2 * kk or ns > MAX_CANDIDATES:
        return select_top(order_keys(row), kk)
    supers = row.reshape(ns, SUPER_BLOCK)
    sel_super = select_top(order_keys(supers.max(axis=1)), kk)
    pos = select_top(order_keys(supers[sel_super].reshape(-1)), kk)
    return sel_super[pos // SUPER_BLOCK] * SUPER_BLOCK + pos % SUPER_BLOCK


def candidate_bins(q_words, ml, blocks, db, valid):
    # type: (np.ndarray, int, np.ndarray, np.ndarray, np.ndarray) -> tuple[np.ndarray, np.ndarray]
    """(rows (kk, 128), bins (kk, 128)): the candidate blocks' rows and each
    row's bin, its Hamming distance to the query over the first ``ml``
    lanes, or INVALID_BIN where the row is invalid."""
    rows = blocks[:, None].astype(np.int64) * BLOCK_ROWS + np.arange(BLOCK_ROWS)
    x = np.ascontiguousarray(db.view(np.uint32)[rows][:, :, :ml] ^ q_words.view(np.uint32)[:ml])
    h = np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1, dtype=np.int64)
    return rows, np.where(valid[rows] != 0, h, INVALID_BIN)


def select_rescore(q_packed, min_lanes, q_scale, block_max, db, valid, kk, out_k):
    # type: (...) -> tuple[np.ndarray, np.ndarray]
    """The kernel's output on numpy arrays: ``q_packed`` (Q, >= lanes)
    int32, ``min_lanes`` (Q,) int32, ``q_scale`` (Q,) float32, ``block_max``
    (Q, nblocks) float32, ``db`` (cap, lanes) int32, ``valid`` (cap,) uint8.
    Returns (scores (Q, out_k) float32, rows (Q, out_k) int32)."""
    nq = len(q_packed)
    lanes = db.shape[1]
    scores = np.empty((nq, out_k), np.float32)
    out_rows = np.empty((nq, out_k), np.int32)
    j = np.arange(kk)[:, None].repeat(BLOCK_ROWS, axis=1)
    walk = np.arange(BLOCK_ROWS)[None, :].repeat(kk, axis=0)  # step * 32 + lane
    for qi in range(nq):
        ml = max(0, min(int(min_lanes[qi]), lanes))
        blocks = select_blocks(block_max[qi], kk)
        rows, bins = candidate_bins(q_packed[qi, :lanes], ml, blocks, db, valid)
        # The stable counting sort: by bin, then warp, then the warp's walk.
        order = np.lexsort((walk.ravel(), j.ravel(), (j % WARPS).ravel(), bins.ravel()))[:out_k]
        b = bins.ravel()[order]
        dot = (32 * ml - 2 * b).astype(np.float32)
        ok = b != INVALID_BIN
        scores[qi] = np.where(ok, np.float32(0.5) + dot * np.float32(q_scale[qi]), np.float32(NEG_SCORE))
        out_rows[qi] = np.where(ok, rows.ravel()[order], -1)
    return scores, out_rows


def check_contract(scores, rows, want_scores, q_packed, min_lanes, q_scale, db, valid):
    # type: (...) -> None
    """Raise AssertionError unless (``scores``, ``rows``), on any device,
    keep the chain's contract: float32 scores ``torch.equal`` to the chain's
    ``want_scores``; int32 rows -1 exactly where the score is NEG_SCORE,
    else distinct within a query, valid and carrying their exact score."""
    if scores.dtype != torch.float32 or rows.dtype != torch.int32 or not torch.equal(scores, want_scores):
        raise AssertionError("the scores differ from the chain's")
    dead = scores == NEG_SCORE
    live = rows.clamp(min=0).long()
    if not torch.equal(rows == -1, dead) or not bool(valid[live][~dead].bool().all()):
        raise AssertionError("a row is -1 off NEG_SCORE, or invalid")
    fill = -1 - torch.arange(rows.shape[1], device=rows.device)
    ordered = torch.sort(torch.where(dead, fill, live), dim=1).values
    if not bool((ordered[:, 1:] != ordered[:, :-1]).all()):
        raise AssertionError("a row is repeated within a query")
    nbits = db.shape[1] * 32
    cand = unpack_pm1(db[live.reshape(-1)], nbits).reshape(*live.shape, nbits)
    exact = 0.5 + torch.einsum("qb,qkb->qk", masked_queries(q_packed, min_lanes, nbits), cand) * q_scale[:, None]
    if not torch.equal(torch.where(dead, NEG_SCORE, exact), scores):
        raise AssertionError("a row does not carry its exact score")
