"""
Hierarchical multi-process top-k: a 2-D (dcn x ici) mesh with a two-stage
merge (port of ``iscc_search_tpu/parallel/hier.py``).

BASELINE config 5 (100M codes over several accelerators) spans hosts. Its
H100 counterpart is one process per node driving the node's cards, with
``torch.distributed`` joining the nodes. The mesh is 2-D:

- axis ``ici``: the shards within one process (its cards);
- axis ``dcn``: one entry per process, joined by the process group;

and the merge is hierarchical: each shard scans its rows, the per-shard
candidates merge per process first, and only the per-process winners are
gathered across processes (``n_hosts * merge_k`` candidates per query,
however many cards each process drives). The final top-k is on the lead
device of every process.

:func:`make_mesh_2d` gives row ``h`` of the grid to process ``h`` of the
group, so the ``ici`` axis never crosses a process. In one process (no
group) the grouping is positional, as on JAX's virtual CPU mesh.
"""

from __future__ import annotations

from iscc_search_tpu_torch.parallel.mesh import Mesh, available_devices, place_rows, process_count, process_row_block
from iscc_search_tpu_torch.parallel.pm1_sharded import sharded_pm1_topk
from iscc_search_tpu_torch.parallel.sharded import sharded_topk

DCN_AXIS = "dcn"
ICI_AXIS = "ici"
ROW_AXES = (DCN_AXIS, ICI_AXIS)


def _world_group():
    """The default process group when it joins more than one process, else None."""
    import torch.distributed as dist

    return dist.group.WORLD if process_count() > 1 else None


def make_mesh_2d(n_hosts=None, chips_per_host=None, device="cuda", devices=None, group=None):
    # type: (int | None, int | None, ...) -> Mesh
    """
    2-D (dcn, ici) mesh.

    Across processes (``group``, by default the ``torch.distributed`` world
    when it holds more than one process): ``n_hosts`` is the group's size
    and this process holds row ``rank`` of the grid, its first
    ``chips_per_host`` devices (by default all of them). Every process must
    hold the same count. In one process: ``n_hosts x chips_per_host`` of
    this process's devices, grouped by position.

    :param device: ``"cuda"`` (this process's CUDA devices) or ``"cpu"``
        (any number of shards on the CPU; ``chips_per_host`` defaults to 1)
    :param devices: an explicit device list in place of ``device`` (a
        device may repeat: several shards on one card, a test affordance)
    :param group: the process group of the ``dcn`` axis; pass one of a
        single process to run the cross-process merge in one process
    """
    pool = list(devices) if devices is not None else available_devices(device)
    group = group if group is not None else _world_group()
    if group is not None:
        import torch
        import torch.distributed as dist

        world = dist.get_world_size(group)
        if n_hosts is not None and n_hosts != world:
            raise ValueError(f"n_hosts={n_hosts}, but the process group holds {world} processes")
        n_hosts = world
        if pool is None:
            pool = [torch.device("cpu")] * (chips_per_host or 1)
        chips_per_host = chips_per_host or len(pool)
        if chips_per_host > len(pool):
            raise ValueError(f"requested {n_hosts}x{chips_per_host} devices, only {len(pool)} available in this process")
        counts = [None] * world
        dist.all_gather_object(counts, chips_per_host, group=group)
        if len(set(counts)) != 1:
            raise ValueError(f"mesh processes hold unequal device counts: {counts}")
        return Mesh(ROW_AXES, (n_hosts, chips_per_host), pool[:chips_per_host], group=group)
    n_hosts = n_hosts or 1
    if pool is None:
        import torch

        pool = [torch.device("cpu")] * (n_hosts * (chips_per_host or 1))
    if chips_per_host is None:
        if len(pool) % n_hosts:
            raise ValueError(f"{len(pool)} devices not divisible by {n_hosts} hosts")
        chips_per_host = len(pool) // n_hosts
    need = n_hosts * chips_per_host
    if need > len(pool):
        raise ValueError(f"requested {n_hosts}x{chips_per_host} devices, only {len(pool)} available")
    return Mesh(ROW_AXES, (n_hosts, chips_per_host), pool[:need])


def shard_database_2d(mesh, db_codes, db_lanes, db_valid):
    # type: (...) -> tuple
    """Row-shard database arrays over the flattened (dcn, ici) axes; each
    process uploads its own row block (:func:`~.mesh.place_rows`).

    :return: (codes, lanes, valid), each a list of this process's shards
    """
    n = mesh.shape[DCN_AXIS] * mesh.shape[ICI_AXIS]
    if db_codes.shape[0] % n:
        raise ValueError(f"db rows {db_codes.shape[0]} not divisible by {n} shards")
    return (
        place_rows(mesh, db_codes),
        place_rows(mesh, db_lanes),
        place_rows(mesh, db_valid),
    )


def make_global_array(mesh, local_rows, global_shape):
    # type: (...) -> list
    """
    This process's shards of a row-sharded global array, from its local rows.

    ``local_rows`` covers the contiguous row range owned by this process's
    devices (host-major order, :func:`~.mesh.process_row_block`), split
    evenly over them.
    """
    lo, hi = process_row_block(mesh, global_shape[0])
    if local_rows.shape[0] != hi - lo:
        raise ValueError(f"{local_rows.shape[0]} local rows, this process owns rows [{lo}, {hi})")
    local = Mesh(mesh.axis_names, mesh.local_shape, mesh.devices)
    return place_rows(local, local_rows)


def hier_topk(mesh, q_codes, q_lanes, db_codes, db_lanes, db_valid, k,
              chunk_size=8192, metric="nphd", ndim_bits=None, merge_k=None):
    # type: (...) -> tuple
    """
    Exact global top-k over a (dcn, ici)-sharded database, two-stage merge
    (:func:`~.sharded.sharded_topk`'s scan and merge, which follows the
    mesh's axes).

    :return: (scores (Q, merge_k or k), global rows) on the lead device
    """
    return sharded_topk(mesh, q_codes, q_lanes, db_codes, db_lanes, db_valid, k, chunk_size, metric, ndim_bits,
                        merge_k=merge_k)


def hier_pm1_topk(mesh, q_pm1, q_scale, db_packed, db_valid, k, nbits, chunk_size=32768, merge_k=None):
    # type: (...) -> tuple
    """Global ±1-matmul top-k over a (dcn, ici)-sharded packed database,
    two-stage merge (:func:`~.pm1_sharded.sharded_pm1_topk`, exact)."""
    return sharded_pm1_topk(mesh, q_pm1, q_scale, db_packed, db_valid, k, nbits, chunk_size=chunk_size, merge_k=merge_k)
