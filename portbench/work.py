"""
The least time of the scan's work on one H100, frozen.

``bound``, ``phase1_work`` and ``gather_work`` are copies of the functions
of the same names in ``chip_smoke.py`` (the repository's smoke run), with
the peaks they were used with. The work is derived from shapes alone:
whatever kernels a later version of the program runs, the same search
counts the same bytes and operations here.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_S = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
BLOCK = 128  # rows per block of the two-phase scan


def bound(nbytes, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase1_work(cap, lanes, nq):
    """(bytes, operations) of phase 1 over one packed partition: the rows and
    their validity read once, the queries (words, prefix lanes, scale) read
    once, the (nq, cap / 128) f32 maxima written once; two operations per ±1
    product of every (query, row) dot."""
    return cap * lanes * 4 + cap + nq * (lanes * 4 + 8) + nq * (cap // 128) * 4, nq * cap * 2 * lanes * 32


def gather_work(nq, kk, lanes, blocks):
    """(bytes, operations) of gather_rescore: the rows of the ``blocks``
    distinct candidate blocks, the block ids and the queries (words and
    prefix lanes) read once, the (nq, kk * 128) f32 dots written once; one
    popc per (candidate row, lane)."""
    return blocks * 128 * lanes * 4 + nq * kk * 4 + nq * (lanes * 4 + 4) + nq * kk * 512, nq * kk * 128 * lanes


def sweep_work(nq, partitions, k):
    """(bytes, int8 operations) of one exact top-``k`` sweep of ``nq``
    queries over ``partitions``, a list of (rows, lanes): per partition,
    phase 1 over its rows, and phase 3 over the ``k`` candidate blocks per
    query that the top ``k`` rows can lie in at most (distinct blocks
    counted once), each candidate row's dot counted as 2 int8 operations
    per ±1 product, as in phase 1."""
    nbytes = ops = 0
    for rows, lanes in partitions:
        b1, o1 = phase1_work(rows, lanes, nq)
        kk = min(k, -(-rows // BLOCK))
        blocks = min(nq * kk, -(-rows // BLOCK))
        b3, _ = gather_work(nq, kk, lanes, blocks)
        nbytes += b1 + b3
        ops += o1 + nq * kk * BLOCK * 2 * lanes * 32
    return nbytes, ops


def least_seconds(nbytes, ops):
    """The least time of ``nbytes`` and ``ops`` int8 operations on one H100:
    the larger of the two bounds."""
    return bound(nbytes, ops, INT8_OPS_S)[0] / 1e3
