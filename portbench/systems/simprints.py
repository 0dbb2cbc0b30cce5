"""
Kind "simprints": a ``SimprintEngine`` of 128-bit chunk simprints.

Asset ``a`` holds chunks ``0..C-1``; chunk ``j`` is row ``a * C + j``, under
the composite key (asset ``a`` as 8 big-endian bytes, offset ``j * 100``,
size 100). The simprints and the removed rows are drawn on the device from
the seed, and the engine's chunk index is built from them with
``DeviceHammingIndex.from_arrays``: the same rows and validity that
``add_packed`` and ``remove`` would leave, without the key-to-row map that
only ``remove``, ``get`` and ``in`` read. A request is one query asset:
every chunk of a stored asset with a few bits flipped, searched by
``search_raw`` with a ``SearchBatcher`` over the chunk index as its
``sweep_fn``, as ``TpuIndex.search_assets`` does with the batcher that
``TpuIndex._sp_sweep_fn`` builds.
"""

from __future__ import annotations

import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from portbench.spans import SweepRecorder
from portbench.systems.units import bodies_of, device_generator, flip_bits, removed_mask, seed_rng

OFFSET_STEP = 100  # chunk j lies at offset j * 100, size 100


@dataclass
class Data:
    codes: np.ndarray  # (assets * chunks, lanes) uint32
    valid: np.ndarray  # (assets * chunks,) bool
    assets: int
    chunks: int
    lanes: int


@dataclass
class Pool:
    codes: np.ndarray  # (items, chunks, lanes) uint32 query simprints
    bodies: list  # per item, its chunks' bodies
    requests: list
    sample: int


def composite_keys(rows, chunks):
    """(len(rows), 16) uint8 keys of the given rows."""
    rows = np.asarray(rows, np.int64)
    keys = np.empty((len(rows), 16), np.uint8)
    keys[:, :8] = (rows // chunks).astype(">u8").view(np.uint8).reshape(-1, 8)
    keys[:, 8:12] = (rows % chunks * OFFSET_STEP).astype(">u4").view(np.uint8).reshape(-1, 4)
    keys[:, 12:] = np.array([OFFSET_STEP], ">u4").view(np.uint8)
    return keys


def make_data(config, seed, device):
    lanes = config["ndim"] // 32
    n = config["assets"] * config["chunks_per_asset"]
    g = device_generator(seed, device)
    codes = torch.randint(-(2**31), 2**31, (n, lanes), dtype=torch.int32, generator=g, device=device)
    valid = removed_mask(g, n, config["tombstone_every"], device)
    return Data(codes.cpu().numpy().view(np.uint32), valid.cpu().numpy(), config["assets"],
                config["chunks_per_asset"], lanes)


def make_pool(data, config, mix, seed):
    """``mix["pool_requests"]`` requests of one query asset each, a distinct
    stored asset with 0..``max_flips`` bits of every chunk flipped."""
    rng = seed_rng(seed, 1)
    items = mix["pool_requests"]
    sources = rng.choice(data.assets, items, replace=False)
    rows = (sources[:, None] * data.chunks + np.arange(data.chunks)[None, :]).ravel()
    codes = data.codes[rows].copy()
    flat = np.zeros((len(rows), 8), np.uint32)
    flat[:, : data.lanes] = codes
    flip_bits(rng, flat, np.full(len(rows), data.lanes, np.int32), mix["max_flips"])
    codes = flat[:, : data.lanes].reshape(items, data.chunks, data.lanes)
    bodies = [bodies_of(codes[i], np.full(data.chunks, data.lanes)) for i in range(items)]
    return Pool(codes, bodies, [np.array([i]) for i in range(items)], mix["sample"])


def sweep_shapes(data, config, mix):
    """([(rows, lanes)] of the one partition, candidates per chunk query)."""
    return [(data.assets * data.chunks, data.lanes)], mix["limit"] * config["oversampling"]


class System:
    """The engine and its sweep batcher answering query assets."""

    outside_label = "scoring"  # host time inside a request, outside the batcher and the sweep

    def __init__(self, data, config, mix, device, spans):
        from iscc_search_tpu_torch.engine.batcher import SearchBatcher
        from iscc_search_tpu_torch.engine.device_index import DeviceHammingIndex
        from iscc_search_tpu_torch.engine.simprint import SimprintEngine

        self._dir = tempfile.TemporaryDirectory(prefix="portbench-simprint-")
        self.engine = SimprintEngine(self._dir.name, ndim=config["ndim"], oversampling_factor=config["oversampling"],
                                     device=str(device))
        n = len(data.valid)
        # path=None: an index in memory, which never saves.
        self.engine._index = DeviceHammingIndex.from_arrays(
            composite_keys(np.arange(n), data.chunks), data.codes, data.lanes, data.valid, path=None,
            ndim=config["ndim"], device=str(device))
        self.recorder = SweepRecorder(self.engine._index, spans)
        self.batcher = SearchBatcher(self.recorder, return_rows=True, **mix["batcher"])
        self.spans = spans
        self.mix = mix
        self.kwargs = dict(limit=mix["limit"], threshold=mix["threshold"], detailed=mix["detailed"],
                           doc_freq_fn=lambda _: 1, total_assets=data.assets)
        self.count = mix["limit"] * config["oversampling"]

    def sweep_fn(self, bodies, count):
        t0 = time.perf_counter()
        out = self.batcher.search(bodies, count)
        self.spans.add("batcher", t0, time.perf_counter())
        return out

    def first_search(self, pool):
        """The first search builds and uploads the partition."""
        self.engine.search_raw(pool.bodies[0], **self.kwargs)

    def warm_shapes(self, pool):
        """One sweep at every size the batcher can fuse: 1 .. clients whole
        requests, at most ``max_batch`` chunk queries."""
        chunks = len(pool.bodies[0])
        flat = [b for item in pool.bodies[: self.mix["clients"]] for b in item]
        most = min(self.mix["clients"] * chunks, self.mix["batcher"]["max_batch"])
        for nq in range(chunks, most + 1, chunks):
            self.engine._index.search(flat[:nq], self.count, return_rows=True)

    def handle(self, pool, request):
        """The query asset's matches as plain tuples: (asset body, score,
        queried, matches, [(query, match, score, offset, size, freq)])."""
        (item,) = request
        matches = self.engine.search_raw(pool.bodies[item], sweep_fn=self.sweep_fn, **self.kwargs)
        return [[(m.iscc_id_body, m.score, m.queried, m.matches,
                  [(c.query, c.match, c.score, c.offset, c.size, c.freq) for c in m.chunks or ()]) for m in matches]]

    def close(self):
        self.batcher.close()
        self.engine = self.recorder = self.batcher = None
        self._dir.cleanup()
