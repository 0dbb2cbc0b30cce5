"""
Exact chunked top-k scan over the packed code matrix in plain PyTorch (port
of ``iscc_search_tpu/ops/topk.py``): the brute-force oracle of both metrics.

The database is walked in fixed-size chunks; each chunk is scored and merged
into a carried (Q, k) best set with ``torch.topk``, so no full (Q, N) score
matrix exists. Tie order follows ``torch.topk``, not ``lax.top_k``.
"""

from __future__ import annotations

import torch

from iscc_search_tpu_torch.ops.nphd import NEG_SCORE, hamming_scores, nphd_scores


def topk_scan_impl(q_codes, q_lanes, db_codes, db_lanes, db_valid, k, chunk_size=8192, metric="nphd", ndim_bits=None):
    # type: (...) -> tuple[torch.Tensor, torch.Tensor]
    """
    Exact top-k search over a packed database.

    :param q_codes: (Q, L) int32-carried uint32 packed queries
    :param q_lanes: (Q,) int32 query lane counts (ignored for metric="hamming")
    :param db_codes: (N, L) int32-carried uint32 packed database; N must be a
        multiple of chunk_size (the engine pads capacity with invalid rows)
    :param db_lanes: (N,) int32 row lane counts
    :param db_valid: (N,) bool row validity (tombstones/padding = False)
    :param k: results per query, at most chunk_size
    :param metric: "nphd" or "hamming"
    :param ndim_bits: bit width for hamming normalization
    :return: (scores (Q, k) float32 desc-sorted, indices (Q, k) int32;
        padding entries have score NEG_SCORE and index -1)
    """
    n = db_codes.shape[0]
    q = q_codes.shape[0]
    if n % chunk_size:
        raise ValueError(f"db size {n} not a multiple of chunk_size {chunk_size}")
    if k > chunk_size:
        raise ValueError(f"k={k} exceeds chunk_size={chunk_size}")
    if metric not in ("nphd", "hamming"):
        raise ValueError(f"unknown metric: {metric!r} (expected 'nphd' or 'hamming')")
    db_valid = db_valid.to(torch.bool)
    best_s = torch.full((q, k), NEG_SCORE, dtype=torch.float32, device=q_codes.device)
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=q_codes.device)
    for base in range(0, n, chunk_size):
        sl = slice(base, base + chunk_size)
        if metric == "nphd":
            s = nphd_scores(q_codes, q_lanes, db_codes[sl], db_lanes[sl], db_valid[sl])
        else:
            s = hamming_scores(q_codes, db_codes[sl], ndim_bits, db_valid[sl])
        idx = torch.arange(base, base + chunk_size, dtype=torch.int32, device=q_codes.device).expand(q, chunk_size)
        best_s, pos = torch.topk(torch.cat([best_s, s], dim=1), k, dim=1)
        best_i = torch.gather(torch.cat([best_i, idx], dim=1), 1, pos)
    return best_s, torch.where(best_s > NEG_SCORE, best_i, -1)
