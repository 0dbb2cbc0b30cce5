"""
Sharded ±1-matmul top-k over a device mesh (port of
``iscc_search_tpu/parallel/pm1_sharded.py``).

Row-shards the packed code matrix over the mesh's axes; each shard runs the
local ±1 scan (:mod:`iscc_search_tpu_torch.ops.pm1_scan`, plain PyTorch as
the JAX scan is XLA) over its rows, then the per-shard candidates merge via
:mod:`iscc_search_tpu_torch.parallel.merge`: a flat merge on a 1-D mesh, the
two-stage in-process-then-across-processes merge on the 2-D mesh. Placement
uploads only this process's row block (:func:`~.mesh.place_rows`).
"""

from __future__ import annotations

import functools

from iscc_search_tpu_torch.ops.pm1_scan import pm1_blockmax_topk_impl, pm1_topk_impl
from iscc_search_tpu_torch.parallel.merge import merge_shards
from iscc_search_tpu_torch.parallel.mesh import place_rows


def shard_pm1_database(mesh, db_packed, db_valid):
    # type: (...) -> tuple
    """Place packed codes + validity row-sharded over ALL mesh axes (each
    process uploads its own row block).

    :return: (packed, valid), each a list of this process's shards
    """
    if db_packed.shape[0] % mesh.size:
        raise ValueError(f"db rows {db_packed.shape[0]} not divisible by {mesh.size} shards")
    return place_rows(mesh, db_packed), place_rows(mesh, db_valid)


def sharded_pm1_topk(
    mesh,
    q_pm1,
    q_scale,
    db_packed,
    db_valid,
    k,
    nbits,
    chunk_size=32768,
    recall_target=None,
    merge_k=None,
):
    # type: (...) -> tuple
    """
    Global top-k over a row-sharded packed database via the ±1 matmul scan:
    two-phase block-max per shard, or the chunked scan under a
    ``recall_target`` (served exactly).

    :param q_pm1: (Q, nbits) float32 ±1 queries, prefix-masked
    :param q_scale: (Q,) float32 per-query scale 1/(2*min_bits)
    :param db_packed/db_valid: row-sharded (see shard_pm1_database)
    :param merge_k: width of the global top-k over the gathered candidates
        (default ``k``); a count above the per-shard ``k`` needs it wider
    :return: (scores (Q, merge_k or k), global rows of the same width) on the lead device
    """
    scan = pm1_blockmax_topk_impl if recall_target is None else functools.partial(pm1_topk_impl,
                                                                                  recall_target=recall_target)
    parts = [
        scan(q_pm1.to(d), q_scale.to(d), db_packed[i], db_valid[i], k, nbits, chunk_size=chunk_size)
        for i, d in enumerate(mesh.devices)
    ]
    return merge_shards(mesh, parts, db_packed[0].shape[0], merge_k or k)
