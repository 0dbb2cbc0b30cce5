"""
Shared shard-merge helpers for row-sharded top-k scans (port of
``iscc_search_tpu/parallel/merge.py``).

Every sharded scan follows the same shape: a local top-k per shard, local
row indices lifted to global rows, then a candidate merge across the mesh's
axes, innermost first. An axis within the process merges in the process:
each shard's ``(Q, k)`` candidates go to the lead device (the mesh's first),
then ``torch.cat`` + ``torch.topk``. The axis that crosses processes merges
by ``all_gather`` over the mesh's group, then ``torch.topk``. On a 2-D
``(dcn, ici)`` mesh only ``n_hosts * merge_k`` candidates per query cross
processes, however many shards each holds.

The JAX helpers run inside a ``shard_map`` body and take the mesh's axis
tuple; these take the :class:`~iscc_search_tpu_torch.parallel.mesh.Mesh`
and lists of this process's shards.
"""

from __future__ import annotations

import torch

from iscc_search_tpu_torch.ops.nphd import NEG_SCORE


def flat_shard_index(mesh, local):
    # type: (Mesh, int) -> int
    """Row-major flat shard id over the mesh's axes of this process's
    ``local``-th shard (host-major: process ``rank`` holds a contiguous run)."""
    return mesh.rank * len(mesh.devices) + local


def lift_rows(idx, local_rows, shard):
    # type: (torch.Tensor, int, int) -> torch.Tensor
    """Map local row indices (-1 = empty) of flat shard ``shard`` to global rows (host-major order)."""
    return torch.where(idx >= 0, idx + shard * local_rows, -1)


def _topk(scores, idx, merge_k):
    s, pos = torch.topk(scores, min(merge_k, scores.shape[1]), dim=1)
    return s, torch.gather(idx, 1, pos)


def _all_gather(t, group):
    # type: (torch.Tensor, object) -> torch.Tensor
    """``(Q, w)`` of every rank of ``group`` side by side, rank order. Gloo
    gathers host tensors, so a CUDA tensor is staged through host memory
    there; NCCL gathers on the card."""
    import torch.distributed as dist

    on_card = dist.get_backend(group) == "nccl"
    src = t if on_card else t.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.cat(parts, dim=1).to(t.device)


def merge_shards(mesh, parts, local_rows, merge_k):
    # type: (Mesh, list[tuple], int, int) -> tuple
    """:func:`lift_rows` + :func:`merge_topk` of this process's shards'
    ``(scores, local rows)`` pairs, in the order of ``mesh.devices``, each
    shard holding ``local_rows`` rows."""
    scores = [s for s, _ in parts]
    idx = [lift_rows(r, local_rows, flat_shard_index(mesh, i)) for i, (_, r) in enumerate(parts)]
    return merge_topk(scores, idx, mesh, merge_k)


def merge_topk(scores, idx, mesh, merge_k):
    # type: (list[torch.Tensor], list[torch.Tensor], Mesh, int) -> tuple
    """
    Merge per-shard (Q, k) candidates to the global top-``merge_k``.

    Reduces over the INNERMOST axis first: on a (dcn, ici) mesh the ici
    merge runs per process before anything crosses processes. On a 1-D mesh
    in one process this is exactly the flat merge.

    :param scores: this process's shards' (Q, k) scores, in the order of
        ``mesh.devices``
    :param idx: their global rows (:func:`lift_rows`), -1 for none
    :return: (scores (Q, <= merge_k), rows), on the lead device of every
        process; rows -1 where the score is NEG_SCORE
    """
    lead = mesh.devices[0]
    s_parts = [s.to(lead) for s in scores]
    i_parts = [i.to(lead) for i in idx]
    for extent in reversed(mesh.local_shape):
        if extent == 1 and s_parts[0].shape[1] <= merge_k:
            continue  # one sorted part that fits: the top-k would only reorder ties
        # Consecutive runs of `extent` parts are one line of the grid along this axis.
        merged = [
            _topk(torch.cat(s_parts[j : j + extent], dim=1), torch.cat(i_parts[j : j + extent], dim=1), merge_k)
            for j in range(0, len(s_parts), extent)
        ]
        s_parts, i_parts = [m[0] for m in merged], [m[1] for m in merged]
    (s,), (i,) = s_parts, i_parts
    if mesh.group is not None:
        s, i = _topk(_all_gather(s, mesh.group), _all_gather(i, mesh.group), merge_k)
    return s, torch.where(s > NEG_SCORE, i, -1)
