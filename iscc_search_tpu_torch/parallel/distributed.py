"""
Multi-process initialization for multi-node deployments (port of
``iscc_search_tpu/parallel/distributed.py``; BASELINE config 5).

One process per node joins the cluster through ``torch.distributed``; it
drives the node's cards as the ``ici`` axis of a 2-D mesh
(:func:`~iscc_search_tpu_torch.parallel.hier.make_mesh_2d`), and the
process group is its ``dcn`` axis. Nothing tells a process of a cluster:
the coordinator's address, the process count and this process's id come
from the arguments or the environment.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket

import torch

from iscc_search_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, available_devices, process_count

logger = logging.getLogger(__name__)

INIT_TIMEOUT_S = 300  # a process that waits longer for the others, or for a collective, fails


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    # type: (str | None, int | None, int | None) -> None
    """
    Join (or bootstrap) a multi-process cluster.

    Arguments default to the ISCC_SEARCH_COORDINATOR (``host:port``, rank 0
    listens there) / ISCC_SEARCH_NUM_HOSTS / ISCC_SEARCH_HOST_ID environment
    variables. Single-host setups skip initialization.

    The backend is NCCL when every process has a card of its own (the
    processes compare their hosts and cards through the rendezvous store
    first), else gloo: NCCL refuses two processes on one card.
    """
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("ISCC_SEARCH_COORDINATOR")
    num_processes = num_processes or _int_env("ISCC_SEARCH_NUM_HOSTS")
    process_id = process_id if process_id is not None else _int_env("ISCC_SEARCH_HOST_ID")

    if coordinator_address is None and (num_processes is None or num_processes == 1):
        # Explicit ISCC_SEARCH_NUM_HOSTS=1 with no coordinator IS the
        # documented single-host mode.
        logger.info("No coordinator configured - single-host mode")
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a cluster needs the coordinator address, the process count and this process's id")
    host, _, port = coordinator_address.rpartition(":")
    timeout = datetime.timedelta(seconds=INIT_TIMEOUT_S)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0, timeout=timeout)
    backend = _choose_backend(store, num_processes, process_id)
    dist.init_process_group(backend, store=store, world_size=num_processes, rank=process_id, timeout=timeout)
    logger.info(
        f"Joined cluster: process {dist.get_rank()}/{dist.get_world_size()} over {backend}, "
        f"{torch.cuda.device_count()} local CUDA devices"
    )


def _card_id():
    # type: () -> str
    """This process's card as ``host/uuid``, or "" without one."""
    if not torch.cuda.is_available():
        return ""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return f"{socket.gethostname()}/{getattr(props, 'uuid', torch.cuda.current_device())}"


def _choose_backend(store, num_processes, process_id):
    # type: (...) -> str
    """"nccl" when every process has a card and no two share one, else "gloo"."""
    store.set(f"iscc_card/{process_id}", _card_id())
    cards = [store.get(f"iscc_card/{rank}").decode() for rank in range(num_processes)]
    return "nccl" if all(cards) and len(set(cards)) == num_processes else "gloo"


def _int_env(name):
    # type: (str) -> int | None
    raw = os.environ.get(name)
    return int(raw) if raw else None


def global_mesh(axis_name=SHARD_AXIS, device="cuda"):
    # type: (str, str) -> Mesh
    """1-D mesh over every CUDA device of the (possibly multi-process)
    cluster: this process's devices, joined to the others' by the default
    process group."""
    import torch.distributed as dist

    local = available_devices(device) or [torch.device("cpu")]
    n_procs = process_count()
    if n_procs == 1:
        return Mesh((axis_name,), (len(local),), local)
    return Mesh((axis_name,), (n_procs * len(local),), local, group=dist.group.WORLD)
