"""
Device meshes and row placement for sharded search (port of
``iscc_search_tpu/parallel/mesh.py``).

A JAX ``Mesh`` is a grid of devices whose rows may belong to different
processes. Here it is a small :class:`Mesh` object: the axis names and
shape, this process's devices (the shards along the axes that stay within
the process, in row-major order), and the ``torch.distributed`` group of
the axis that crosses processes (``None`` in one process). The database
rows shard over every axis, host-major; queries are copied to each shard's
device.
"""

from __future__ import annotations

import numpy as np
import torch

SHARD_AXIS = "shards"


class Mesh:
    """
    A row-sharding mesh.

    :param axis_names: axis names, outermost first
    :param shape: extent of each axis, in the same order
    :param devices: this process's shards, one ``torch.device`` each, in
        row-major order over the axes (a device may hold several shards)
    :param group: the ``torch.distributed`` group joined by the outermost
        axis, which then crosses processes: each process holds an equal
        contiguous run of it, in rank order (row ``rank`` of a 2-D grid).
        ``None``: the whole grid is here.
    """

    def __init__(self, axis_names, shape, devices, group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.devices = [torch.device(d) for d in devices]
        self.group = group
        self.size = int(np.prod(list(self.shape.values())))
        if group is None:
            self.n_procs, self.rank = 1, 0
        else:
            import torch.distributed as dist

            self.n_procs, self.rank = dist.get_world_size(group), dist.get_rank(group)
            if self.shape[self.axis_names[0]] % self.n_procs:
                raise ValueError(f"the outermost axis of {self.shape} does not split over {self.n_procs} processes")
        if len(self.devices) * self.n_procs != self.size:
            raise ValueError(f"{len(self.devices)} local devices x {self.n_procs} processes do not fill {self.shape}")

    @property
    def local_shape(self):
        # type: () -> tuple
        """Extent of each axis within this process (the outermost one's share)."""
        extents = list(self.shape.values())
        extents[0] //= self.n_procs
        return tuple(extents)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]}, processes={self.n_procs})"


def process_count():
    # type: () -> int
    """Processes in the default ``torch.distributed`` group, 1 without one
    (the counterpart of ``jax.process_count()``)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index():
    # type: () -> int
    """This process's rank in the default ``torch.distributed`` group, 0
    without one (the counterpart of ``jax.process_index()``)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def available_devices(device="cuda"):
    # type: (str | torch.device) -> list[torch.device] | None
    """This process's devices of ``device``'s type: every CUDA device, or
    ``None`` for the CPU, which holds any number of shards."""
    kind = torch.device(device).type
    if kind == "cpu":
        return None
    if kind != "cuda":
        raise ValueError(f"no mesh over device type {kind!r}: 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass device='cpu' for shards on the CPU)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices=None, axis_name=SHARD_AXIS, device="cuda", devices=None):
    # type: (int | None, str, str | torch.device, list | None) -> Mesh
    """
    1-D mesh over the first ``n_devices`` devices of this process.

    :param n_devices: shard count; by default every device (one on the CPU)
    :param device: ``"cuda"`` (the CUDA devices; more than
        ``torch.cuda.device_count()`` raises) or ``"cpu"`` (``n_devices``
        shards on the CPU, the counterpart of JAX's virtual host devices)
    :param devices: an explicit device list to take the shards from, in
        place of ``device`` (a device may repeat: several shards on one
        card, a test affordance)
    """
    pool = list(devices) if devices is not None else available_devices(device)
    if pool is None:
        pool = [torch.device("cpu")] * (n_devices or 1)
    if n_devices is None:
        n_devices = len(pool)
    if n_devices > len(pool):
        raise ValueError(f"requested {n_devices} devices, only {len(pool)} available")
    return Mesh((axis_name,), (n_devices,), pool[:n_devices])


def process_row_block(mesh, n_rows):
    # type: (Mesh, int) -> tuple[int, int]
    """
    Contiguous global row range [lo, hi) owned by THIS process's devices when
    ``n_rows`` rows shard over all of ``mesh``'s axes (host-major order).
    """
    if n_rows % mesh.n_procs:
        raise ValueError(f"{n_rows} rows not divisible by {mesh.n_procs} processes")
    per_proc = n_rows // mesh.n_procs
    return mesh.rank * per_proc, (mesh.rank + 1) * per_proc


def upload(array, device):
    # type: (np.ndarray | torch.Tensor, torch.device) -> torch.Tensor
    """A host array on ``device``: uint32 codes travel as their int32 bits,
    bool validity as uint8 (the kernels' layouts)."""
    if isinstance(array, torch.Tensor):
        if array.dtype == torch.bool:
            array = array.to(torch.uint8)
        return array.to(device).contiguous()
    if array.dtype == np.uint32:
        array = array.view(np.int32)
    elif array.dtype == np.bool_:
        array = array.view(np.uint8)
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def place_rows(mesh, arr):
    # type: (Mesh, np.ndarray | torch.Tensor) -> list[torch.Tensor]
    """
    Row-shard a host array over ALL mesh axes (host-major row order).

    Every process holds the full host array (the store is the shared
    truth) but uploads ONLY its own contiguous row block, split over its
    devices: no device receives another process's rows.

    :return: this process's shards, one tensor per entry of ``mesh.devices``
    """
    n = arr.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows not divisible by {mesh.size} shards")
    lo, _ = process_row_block(mesh, n)
    per = n // mesh.size
    return [upload(arr[lo + i * per : lo + (i + 1) * per], dev) for i, dev in enumerate(mesh.devices)]
