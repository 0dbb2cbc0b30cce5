"""
Sharded two-phase top-k through the Hopper kernels, per shard (port of
``iscc_search_tpu/parallel/pallas_sharded.py``).

Row-shards the ±1 int8 twin over the mesh's axes and runs, on every shard,
the single-device path of :mod:`iscc_search_tpu_torch.ops.hopper_scan` with
phase 1 from the twin (``blockmax_mma_unpacked``, the counterpart of TPU
kernel 4 ``_scan_kernel_unpacked``), the hierarchical block select and
``gather_rescore``; then the per-shard candidates merge via
:mod:`iscc_search_tpu_torch.parallel.merge`.

Differences from the JAX module: the queries arrive packed with their
common-prefix lanes (``q_packed, min_lanes``) in place of ``q_pm1``, as the
port's kernels take them; the kernels read the validity mask and the rows
unpermuted, so there is no ``db_perm`` twin and no ``db_penalty`` row
(``shard_blockmax_penalty``); each shard is one launch, so there is no
``chunk_size``; on CPU tensors every kernel takes its plain version, so
there is no ``interpret``.
"""

from __future__ import annotations

from iscc_search_tpu_torch.ops import hopper_scan
from iscc_search_tpu_torch.parallel.merge import merge_shards, scan_shards


def shard_unpacked_db(mesh, db_packed_sharded, nbits):
    # type: (...) -> list
    """
    The row-sharded ±1 int8 twin of a row-sharded packed database: each
    shard's twin is built on its own device
    (:func:`~iscc_search_tpu_torch.ops.hopper_scan.build_unpacked_db`, in
    row chunks, so the transient memory is one chunk).
    """
    return [hopper_scan.build_unpacked_db(shard, nbits) for shard in db_packed_sharded]


def sharded_pallas_topk(mesh, q_packed, min_lanes, q_scale, db_packed, db_unpacked, db_valid, k, nbits, merge_k=None):
    # type: (...) -> tuple
    """
    Global exact top-k over a row-sharded ±1 int8 twin: the kernels per
    shard + the merge.

    :param q_packed: (Q, >= nbits // 32) int32 packed queries
    :param min_lanes: (Q,) int32 common-prefix lanes against this partition
    :param q_scale: (Q,) float32 per-query scale 1/(2*min_bits)
    :param db_packed/db_valid: row-sharded packed rows (phase 3 reads them)
        and uint8 validity
    :param db_unpacked: row-sharded ±1 int8 twin (:func:`shard_unpacked_db`),
        phase 1's input
    :return: (scores (Q, merge_k or k), global rows of the same width) on the lead device
    """
    if db_unpacked is None:
        raise ValueError("sharded_pallas_topk needs the int8 twin")
    if db_packed[0].shape[1] * 32 != nbits:
        raise ValueError(f"db_packed shards {tuple(db_packed[0].shape)} are not a {nbits}-bit partition")
    parts = scan_shards(mesh, db_packed[0].shape[0], lambda i, d: hopper_scan.blockmax_topk_impl(
        q_packed.to(d), min_lanes.to(d), q_scale.to(d), db_packed[i], db_valid[i], k, db_unpacked=db_unpacked[i],
        unpacked=True))
    return merge_shards(mesh, parts, db_packed[0].shape[0], merge_k or k)
