"""
Sharded exact top-k search over a device mesh (port of
``iscc_search_tpu/parallel/sharded.py``).

The packed code matrix shards row-wise across the mesh axis; each shard runs
the local exact scan (:func:`~iscc_search_tpu_torch.ops.topk.topk_scan_impl`)
over its rows, then the per-shard (scores, global rows) candidates merge on
the lead device (:func:`~iscc_search_tpu_torch.parallel.merge.merge_topk`).
The merge moves only ``n_shards x k`` candidates per query.
"""

from __future__ import annotations

from iscc_search_tpu_torch.ops.topk import topk_scan_impl
from iscc_search_tpu_torch.parallel.merge import merge_shards
from iscc_search_tpu_torch.parallel.mesh import SHARD_AXIS, place_rows


def shard_database(mesh, db_codes, db_lanes, db_valid, axis_name=SHARD_AXIS):
    # type: (...) -> tuple
    """
    Place database arrays row-sharded over the mesh axis.

    Row count must divide evenly by the mesh size (the engine pads capacity
    with invalid rows).

    :return: (codes, lanes, valid), each a list of this process's shards
    """
    n = mesh.shape[axis_name]
    if db_codes.shape[0] % n:
        raise ValueError(f"db rows {db_codes.shape[0]} not divisible by {n} shards")
    return (
        place_rows(mesh, db_codes),
        place_rows(mesh, db_lanes),
        place_rows(mesh, db_valid),
    )


def sharded_topk(
    mesh,
    q_codes,
    q_lanes,
    db_codes,
    db_lanes,
    db_valid,
    k,
    chunk_size=8192,
    metric="nphd",
    ndim_bits=None,
    merge_k=None,
):
    # type: (...) -> tuple
    """
    Exact global top-k over a row-sharded database.

    :param mesh: :class:`~iscc_search_tpu_torch.parallel.mesh.Mesh` (1-D here,
        2-D for :func:`~iscc_search_tpu_torch.parallel.hier.hier_topk`)
    :param q_codes: (Q, L) int32-carried packed queries (copied to every shard's device)
    :param q_lanes: (Q,) int32 query lane counts
    :param db_codes/db_lanes/db_valid: row-sharded database (see shard_database)
    :param k: results per query
    :return: (scores (Q, merge_k or k), global rows of the same width) on the lead device
    """
    parts = [
        topk_scan_impl(q_codes.to(d), q_lanes.to(d), db_codes[i], db_lanes[i], db_valid[i], k, chunk_size, metric,
                       ndim_bits)
        for i, d in enumerate(mesh.devices)
    ]
    return merge_shards(mesh, parts, db_codes[0].shape[0], merge_k or k)
