"""
Kind "units_mesh": kind "units" row-sharded over a mesh of ``cards`` devices.

The data, the queries and the requests are kind "units"' own; the index is
built with ``DeviceNphdIndex.from_arrays(..., mesh=make_mesh(cards))``, as
``TpuIndex(mesh_devices=cards)`` builds it: on CUDA one shard on each of the
first ``cards`` cards (fewer cards raise), on the CPU ``cards`` shards of
the CPU. Every card is synchronised at the end of the build and of the
first search, so the harness's set-up stages hold their work.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.spans import SweepRecorder
from portbench.systems import units
from portbench.systems.units import Data, Pool, make_data, make_pool, sweep_shapes  # noqa: F401


class System(units.System):
    """The row-sharded index answering requests of one mix."""

    def __init__(self, data, config, mix, device, spans):
        from iscc_search_tpu_torch.engine.device_index import DeviceNphdIndex
        from iscc_search_tpu_torch.parallel.mesh import make_mesh

        self.mesh = make_mesh(config["cards"], device=device.type)
        n = len(data.lanes)
        keys = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
        self.index = DeviceNphdIndex.from_arrays(keys, data.codes, data.lanes, data.valid, device=device.type,
                                                 mesh=self.mesh)
        self.recorder = SweepRecorder(self.index, spans)
        self.mix = mix
        self.count = mix["count"]
        self.sync()

    def sync(self):
        """Wait for every card of the mesh."""
        for d in self.mesh.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def first_search(self, pool):
        super().first_search(pool)
        self.sync()
