"""
Dense NPHD (Normalized Prefix Hamming Distance) scores in PyTorch — the
brute-force exactness oracle of the port (port of
``iscc_search_tpu/ops/nphd.py``).

    nphd(q, d) = popcount(xor(q, d) over the common prefix) / min_bits
    min_bits   = min(len(q), len(d))
    score      = 1.0 - nphd

ISCC-UNIT bodies are multiples of 64 bits packed into 32-bit lanes, so the
common prefix is a whole number of lanes. Scores of invalid rows are
NEG_SCORE (-1.0), below every real score in [0, 1].
"""

from __future__ import annotations

import torch

NEG_SCORE = -1.0


def popcount32(x):
    # type: (torch.Tensor) -> torch.Tensor
    """Per-element popcount of int32-carried uint32 words (PyTorch has no
    popcount op): SWAR bit counting on the zero-extended int64 value, which
    keeps every intermediate non-negative and free of overflow."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return (v & 0x3F).to(torch.int32)


def nphd_scores(q_codes, q_lanes, db_codes, db_lanes, db_valid=None):
    # type: (torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None) -> torch.Tensor
    """
    Dense NPHD similarity scores for all (query, db) pairs.

    Memory is O(Q * N * L): callers scoring a large database pass it in row
    slices.

    :param q_codes: (Q, L) int32-carried uint32 packed query codes
    :param q_lanes: (Q,) int32 active lane counts per query
    :param db_codes: (N, L) int32-carried uint32 packed database codes
    :param db_lanes: (N,) int32 active lane counts per row
    :param db_valid: optional (N,) bool; invalid rows score NEG_SCORE
    :return: (Q, N) float32 scores in [0, 1] (or NEG_SCORE)
    """
    max_lanes = q_codes.shape[-1]
    pops = popcount32(q_codes[:, None, :] ^ db_codes[None, :, :])  # (Q, N, L)
    min_lanes = torch.minimum(q_lanes[:, None], db_lanes[None, :])  # (Q, N)
    lane_idx = torch.arange(max_lanes, dtype=min_lanes.dtype, device=q_codes.device)
    prefix_mask = lane_idx[None, None, :] < min_lanes[:, :, None]
    ham = torch.where(prefix_mask, pops, 0).sum(dim=-1)  # (Q, N)
    min_bits = (min_lanes * 32).to(torch.float32)
    scores = 1.0 - ham.to(torch.float32) / torch.clamp(min_bits, min=1.0)
    if db_valid is not None:
        scores = torch.where(db_valid.to(torch.bool)[None, :], scores, NEG_SCORE)
    return scores


def hamming_scores(q_codes, db_codes, ndim_bits, db_valid=None):
    # type: (torch.Tensor, torch.Tensor, int, torch.Tensor | None) -> torch.Tensor
    """
    Dense fixed-width Hamming similarity: score = 1 - hamming / ndim_bits
    (the simprint score; port of the JAX ``hamming_scores``).

    :param q_codes: (Q, L) int32-carried uint32 packed query simprints
    :param db_codes: (N, L) int32-carried uint32 packed stored simprints
    :param ndim_bits: simprint width in bits (lanes beyond it are zero on
        both sides and add nothing to the distance)
    :param db_valid: optional (N,) bool; invalid rows score NEG_SCORE
    :return: (Q, N) float32 scores
    """
    ham = popcount32(q_codes[:, None, :] ^ db_codes[None, :, :]).sum(dim=-1)
    scores = 1.0 - ham.to(torch.float32) / float(ndim_bits)
    if db_valid is not None:
        scores = torch.where(db_valid.to(torch.bool)[None, :], scores, NEG_SCORE)
    return scores
