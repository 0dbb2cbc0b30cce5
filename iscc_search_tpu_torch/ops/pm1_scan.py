"""
The ±1 formulation of the NPHD scan in PyTorch (port of
``iscc_search_tpu/ops/pm1_scan.py``).

Key identity: with codes encoded as ±1 vectors, ``dot(q, d) = matched_bits -
mismatched_bits = bits - 2*hamming``. Masking the *query* to the pair's
common prefix (zeros contribute nothing to the dot) gives, for a query
compared over ``min_bits``:

    dot = min_bits - 2 * hamming_prefix
    nphd_score = 1 - hamming_prefix / min_bits = 0.5 + dot / (2 * min_bits)

The engine partitions rows by code length, so ``min_bits`` depends only on
(query, partition) and the scale is a per-query broadcast.

Codes are held as ``int32`` tensors that carry the uint32 bits
(``np.ndarray.view(np.int32)``): PyTorch's CPU build implements no ``>>`` on
``uint32``, and an ``int32`` ``>>`` sign-extends. So the code below widens a
word to ``int64`` and masks it to its 32 bits before any shift.

These functions are the plain versions: the CPU path of the port and the
reference the CUDA kernels of :mod:`iscc_search_tpu_torch.ops.hopper_scan`
are held against.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_SCORE = -1.0


def unpack_pm1(packed, nbits):
    # type: (torch.Tensor, int) -> torch.Tensor
    """
    Unpack (N, L) int32-carried uint32 codes to (N, nbits) float32 ±1 values.

    Bit order: lanes in order, MSB-first within each lane — identical to the
    big-endian byte order of the original code bodies, so 64-bit group g
    occupies columns [64g, 64g+64). Each byte of a word (most significant
    first, masked after the shift) indexes a table of its eight ±1 values.
    """
    lanes = nbits // 32
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int32, device=packed.device)
    byte_vals = (packed[:, :lanes, None] >> shifts) & 0xFF  # (N, lanes, 4)
    table = _PM1_BYTES.to(packed.device)
    return table[byte_vals.long()].reshape(packed.shape[0], nbits)


# Row b: the eight bits of byte b, most significant first, as ±1 float32.
_PM1_BYTES = (((torch.arange(256)[:, None] >> torch.arange(7, -1, -1)) & 1) * 2 - 1).to(torch.float32)


def unpack_pm1_np(packed, nbits):
    # type: (np.ndarray, int) -> np.ndarray
    """NumPy twin of unpack_pm1 (host-side query preparation), float32."""
    lanes = nbits // 32
    as_bytes = packed[:, :lanes].astype(">u4", order="C").view(np.uint8).reshape(packed.shape[0], lanes * 4)
    bits = np.unpackbits(as_bytes, axis=1)
    return bits.astype(np.float32) * 2 - 1


def query_prefix(q_lanes, partition_bits):
    # type: (torch.Tensor, int) -> tuple[torch.Tensor, torch.Tensor]
    """
    Common-prefix lanes and score scale of each query against one partition.

    :return: (min_lanes (Q,) int32 = min(q_lanes, partition lanes),
        q_scale (Q,) float32 = 1 / (2 * min_bits)), computed in f32 exactly
        as the JAX ``prepare_queries_impl`` computes it
    """
    min_lanes = torch.clamp(q_lanes.to(torch.int32), max=partition_bits // 32)
    min_bits = torch.clamp(min_lanes * 32, min=1).to(torch.float32)
    return min_lanes, torch.ones_like(min_bits) / (2.0 * min_bits)


def masked_queries(q_packed, min_lanes, nbits):
    # type: (torch.Tensor, torch.Tensor, int) -> torch.Tensor
    """(Q, nbits) f32 ±1 queries, zeroed past each query's common prefix."""
    q_pm1 = unpack_pm1(q_packed[:, : nbits // 32], nbits)
    col = torch.arange(nbits, dtype=torch.int32, device=q_packed.device)
    return torch.where(col[None, :] < (min_lanes * 32)[:, None], q_pm1, 0.0)


def prepare_queries_impl(q_packed, q_lanes, partition_bits):
    # type: (torch.Tensor, torch.Tensor, int) -> tuple[torch.Tensor, torch.Tensor]
    """
    Device query prep for one partition: unpack + prefix-mask + scale from
    the packed queries. Bit-exact vs the JAX ``prepare_queries_impl``.

    :return: (q_pm1 (Q, partition_bits) float32, q_scale (Q,) float32)
    """
    min_lanes, q_scale = query_prefix(q_lanes, partition_bits)
    return masked_queries(q_packed, min_lanes, partition_bits), q_scale


def prepare_queries(q_packed, q_lanes, partition_bits):
    # type: (np.ndarray, np.ndarray, int) -> tuple[np.ndarray, np.ndarray]
    """
    Host-side query prep for one length partition (numpy).

    :param q_packed: (Q, L) uint32 packed query codes
    :param q_lanes: (Q,) int32 query lane counts
    :param partition_bits: partition code width in bits
    :return: (q_pm1 (Q, partition_bits) float32, q_scale (Q,) float32)
    """
    q_pm1 = unpack_pm1_np(q_packed, partition_bits)
    q_bits = q_lanes.astype(np.int64) * 32
    min_bits = np.minimum(q_bits, partition_bits)
    col = np.arange(partition_bits)[None, :]
    q_pm1 = np.where(col < min_bits[:, None], q_pm1, 0.0).astype(np.float32)
    q_scale = (1.0 / (2.0 * np.maximum(min_bits, 1))).astype(np.float32)
    return q_pm1, q_scale


def topk_blocks_hier(block_max, k, super_block=128):
    # type: (torch.Tensor, int, int) -> torch.Tensor
    """
    EXACT top-k block ids from per-block maxima, hierarchically.

    Blocks group into super-blocks of ``super_block``; the top-k super-blocks
    by maximum survive, then the top-k blocks among their members. Exactness
    (ties included) is the block-max superset argument applied twice: a block
    holding any top-k row has max >= the k-th score, so its super-block does
    too, and every survivor contributes a row scoring >= the k-th score.

    The JAX version gathers the surviving super-blocks with a one-hot matmul
    (a TPU workaround for slow lane gathers); here it is ``torch.gather``.
    Tie order follows ``torch.topk``, not ``lax.top_k``.

    :return: (Q, min(k, n_blocks)) int64 distinct block ids
    """
    q, nb = block_max.shape
    kk = min(k, nb)
    ns = nb // super_block
    if nb % super_block or ns <= kk * 2:
        # Ragged or too few super-blocks for the hierarchy to pay for itself.
        return torch.topk(block_max, kk, dim=1).indices
    bm3 = block_max.reshape(q, ns, super_block)
    top_super = torch.topk(bm3.amax(dim=2), kk, dim=1).indices  # (Q, kk)
    cand = torch.gather(bm3, 1, top_super[:, :, None].expand(q, kk, super_block))
    pos = torch.topk(cand.reshape(q, kk * super_block), kk, dim=1).indices
    sel_super = torch.gather(top_super, 1, pos // super_block)
    return sel_super * super_block + pos % super_block


def segmented_unpack_dots(q_d, db_packed, rows, nbits):
    # type: (torch.Tensor, torch.Tensor, torch.Tensor, int) -> torch.Tensor
    """±1 dots of each query against gathered packed rows, bounded memory.

    ``rows`` is (Q, total) row ids; returns (Q, total) float32 dots. The
    rows are gathered, unpacked and dotted in segments sized to a ~1 GiB f32
    unpacked working set, as the JAX version does.
    """
    q, total = rows.shape
    seg = 1 << max(11, ((1 << 30) // max(1, q * nbits * 4)).bit_length() - 1)
    q_f = q_d.to(torch.float32)[:, :, None]  # (Q, nbits, 1)
    out = torch.empty((q, total), dtype=torch.float32, device=q_d.device)
    for s in range(0, total, seg):
        part = rows[:, s : s + seg]
        width = part.shape[1]
        cand = unpack_pm1(db_packed[part.reshape(-1)], nbits).reshape(q, width, nbits)
        out[:, s : s + width] = torch.bmm(cand, q_f)[:, :, 0]
    return out


def _chunk_scores(q_pm1, q_scale, chunk_packed, chunk_valid, nbits):
    """Scores for one chunk: unpack -> matmul -> scale -> mask."""
    dot = q_pm1 @ unpack_pm1(chunk_packed, nbits).T
    s = 0.5 + dot * q_scale[:, None]
    return torch.where(chunk_valid[None, :], s, NEG_SCORE)


def pm1_topk_impl(q_pm1, q_scale, db_packed, db_valid, k, nbits, chunk_size=32768, recall_target=None):
    # type: (...) -> tuple[torch.Tensor, torch.Tensor]
    """
    Exact top-k scan via the ±1 matmul identity: each chunk is scored and
    its top-k kept, then one final top-k over every chunk's winners.

    :param q_pm1: (Q, nbits) float32 ±1/0 prefix-masked queries
    :param q_scale: (Q,) float32 per-query scale = 1 / (2 * min_bits)
    :param db_packed: (N, nbits//32) int32 packed codes, N % chunk_size == 0
    :param db_valid: (N,) bool tombstone/padding mask
    :param recall_target: accepted for the JAX signature and served EXACTLY
        (the JAX engine's approximate per-chunk top-k is not ported)
    :return: (scores (Q, k) float32 desc, indices (Q, k) int64, -1 padding)
    """
    n = db_packed.shape[0]
    if n % chunk_size:
        raise ValueError(f"db size {n} not a multiple of chunk_size {chunk_size}")
    db_valid = db_valid.to(torch.bool)
    kk = min(k, chunk_size)
    all_s, all_i = [], []
    for base in range(0, n, chunk_size):
        s = _chunk_scores(q_pm1, q_scale, db_packed[base : base + chunk_size], db_valid[base : base + chunk_size], nbits)
        ts, ti = torch.topk(s, kk, dim=1)
        all_s.append(ts)
        all_i.append(ti + base)
    all_s, all_i = torch.cat(all_s, dim=1), torch.cat(all_i, dim=1)
    out_k = min(k, all_s.shape[1])
    fs, pos = torch.topk(all_s, out_k, dim=1)
    fi = torch.where(fs > NEG_SCORE, torch.gather(all_i, 1, pos), -1)
    if out_k < k:
        fs = torch.nn.functional.pad(fs, (0, k - out_k), value=NEG_SCORE)
        fi = torch.nn.functional.pad(fi, (0, k - out_k), value=-1)
    return fs, fi


def pm1_blockmax_topk_impl(q_pm1, q_scale, db_packed, db_valid, k, nbits, chunk_size=32768, block=128):
    # type: (...) -> tuple[torch.Tensor, torch.Tensor]
    """
    EXACT top-k in two phases, the plain whole-scan reference:

    1. scan chunks computing only per-``block``-row block maxima of the scores;
    2. take the top-k blocks per query by maximum, gather those rows, rescore
       them exactly, and select the final top-k.

    Every row scoring strictly above the k-th score lives in a block whose max
    exceeds it; at most k-1 such rows exist, so their blocks survive the
    block cut, and each surviving block contributes a row >= the k-th score.

    :param q_pm1: (Q, nbits) float32 ±1/0 prefix-masked queries
    :param q_scale: (Q,) float32 per-query scale = 1 / (2 * min_bits)
    :param db_packed: (N, nbits//32) int32 packed codes, N % chunk_size == 0
    :param db_valid: (N,) bool tombstone/padding mask
    :return: (scores (Q, k) float32 desc, indices (Q, k) int64, -1 padding)
    """
    n = db_packed.shape[0]
    q = q_pm1.shape[0]
    if n % chunk_size or chunk_size % block:
        raise ValueError("db size must divide by chunk_size and chunk_size by block")
    db_valid = db_valid.to(torch.bool)
    total_blocks = n // block
    if total_blocks < k:
        # Tiny database: the single-phase exact path is cheap enough.
        return pm1_topk_impl(q_pm1, q_scale, db_packed, db_valid, k, nbits, chunk_size)

    block_max = torch.empty((q, total_blocks), dtype=torch.float32, device=q_pm1.device)
    bpc = chunk_size // block
    for c in range(n // chunk_size):
        sl = slice(c * chunk_size, (c + 1) * chunk_size)
        s = _chunk_scores(q_pm1, q_scale, db_packed[sl], db_valid[sl], nbits)
        block_max[:, c * bpc : (c + 1) * bpc] = s.reshape(q, bpc, block).amax(dim=2)

    top_blocks = topk_blocks_hier(block_max, k)  # (Q, k) block ids
    offsets = torch.arange(block, device=q_pm1.device)
    rows = (top_blocks[:, :, None] * block + offsets).reshape(q, k * block)
    dots = segmented_unpack_dots(q_pm1, db_packed, rows, nbits)
    scores = 0.5 + dots * q_scale[:, None]
    scores = torch.where(db_valid[rows], scores, NEG_SCORE)
    fs, pos = torch.topk(scores, k, dim=1)
    fi = torch.gather(rows, 1, pos)
    return fs, torch.where(fs > NEG_SCORE, fi, -1)


def pm1_topk_packedq_impl(q_packed, q_lanes, db_packed, db_valid, k, nbits, **kw):
    # type: (...) -> tuple[torch.Tensor, torch.Tensor]
    """Query prep from packed queries + :func:`pm1_topk_impl`."""
    q_pm1, q_scale = prepare_queries_impl(q_packed, q_lanes, nbits)
    return pm1_topk_impl(q_pm1, q_scale, db_packed, db_valid, k, nbits, **kw)


def pm1_blockmax_topk_packedq_impl(q_packed, q_lanes, db_packed, db_valid, k, nbits, **kw):
    # type: (...) -> tuple[torch.Tensor, torch.Tensor]
    """Query prep from packed queries + :func:`pm1_blockmax_topk_impl`."""
    q_pm1, q_scale = prepare_queries_impl(q_packed, q_lanes, nbits)
    return pm1_blockmax_topk_impl(q_pm1, q_scale, db_packed, db_valid, k, nbits, **kw)
