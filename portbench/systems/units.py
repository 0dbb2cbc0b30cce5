"""
Kind "units": one ``DeviceNphdIndex`` of variable-length ISCC-UNIT codes.

The codes, their lengths and the removed rows are drawn on the device from
the seed; the index is built from them with ``DeviceNphdIndex.from_arrays``
(row ``r`` holds the big-endian key ``r``). A request is a batch of unit
queries: stored codes with a few bits flipped, and new codes of the same
length mix, sent to ``search``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.spans import SweepRecorder

MAX_LANES = 8  # 256-bit codes in 32-bit lanes


@dataclass
class Data:
    codes: np.ndarray  # (n, 8) uint32, lanes past each length zero
    lanes: np.ndarray  # (n,) int32
    valid: np.ndarray  # (n,) bool, False for removed rows


@dataclass
class Pool:
    codes: np.ndarray  # (items, 8) uint32 query codes
    lanes: np.ndarray  # (items,) int32
    bodies: list  # the query bodies, big-endian lanes
    requests: list  # per request, the item ids it sends
    sample: int  # items whose answers are compared


def seed_rng(seed, stream):
    """A numpy generator of ``stream`` for ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % 2**64, stream])


def device_generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**64)
    return g


def random_codes(g, n, lanes_choices, p, device):
    """(codes (n, 8) int32 tensor, lanes (n,) int32 tensor) on ``device``:
    random bits, lengths drawn from the mix, lanes past each length zero."""
    codes = torch.randint(-(2**31), 2**31, (n, MAX_LANES), dtype=torch.int32, generator=g, device=device)
    pick = torch.multinomial(torch.tensor(p, dtype=torch.float64, device=device), n, replacement=True, generator=g)
    lanes = torch.tensor(lanes_choices, dtype=torch.int32, device=device)[pick]
    codes.masked_fill_(torch.arange(MAX_LANES, device=device)[None, :] >= lanes[:, None], 0)
    return codes, lanes


def removed_mask(g, n, every, device):
    """(n,) bool tensor, False for ``n // every`` rows drawn from ``g``."""
    valid = torch.ones(n, dtype=torch.bool, device=device)
    valid[torch.randperm(n, generator=g, device=device)[: n // every]] = False
    return valid


def make_data(config, seed, device):
    g = device_generator(seed, device)
    codes, lanes = random_codes(g, config["rows"], config["lanes"], config["lane_p"], device)
    valid = removed_mask(g, config["rows"], config["tombstone_every"], device)
    return Data(codes.cpu().numpy().view(np.uint32), lanes.cpu().numpy(), valid.cpu().numpy())


def flip_bits(rng, codes, lanes, max_flips):
    """Flip 0..max_flips distinct bits of each row inside its length, in place."""
    n = len(lanes)
    flips = rng.integers(0, max_flips + 1, n)
    keys = rng.random((n, MAX_LANES * 32))
    keys[np.arange(MAX_LANES * 32)[None, :] >= (lanes * 32)[:, None]] = 2.0  # past the length: last
    pos = np.argsort(keys, axis=1)[:, :max_flips]
    rows = np.repeat(np.arange(n), max_flips)[(np.arange(max_flips)[None, :] < flips[:, None]).ravel()]
    pos = pos[np.arange(max_flips)[None, :] < flips[:, None]]
    np.bitwise_xor.at(codes, (rows, pos // 32), (np.uint32(1) << (pos % 32).astype(np.uint32)))


def bodies_of(codes, lanes):
    return [codes[i, : lanes[i]].astype(">u4").tobytes() for i in range(len(lanes))]


def make_pool(data, config, mix, seed):
    """The queries of ``mix["pool_requests"]`` requests, each
    ``mix["queries_per_request"]`` items: a share ``near_share`` are stored
    rows with 0..``max_flips`` bits flipped, the rest new codes of the
    configuration's length mix."""
    rng = seed_rng(seed, 1)
    qpr = mix["queries_per_request"]
    items = mix["pool_requests"] * qpr
    near = rng.random(items) < mix["near_share"]
    src = rng.integers(0, len(data.lanes), items)
    codes = data.codes[src].copy()
    lanes = data.lanes[src].copy()
    fresh = np.flatnonzero(~near)
    lanes[fresh] = rng.choice(np.asarray(config["lanes"], np.int32), len(fresh), p=config["lane_p"])
    codes[fresh] = rng.integers(0, 2**32, (len(fresh), MAX_LANES), dtype=np.uint32)
    codes[np.arange(MAX_LANES)[None, :] >= lanes[:, None]] = 0
    flip_bits(rng, codes, lanes, mix["max_flips"])
    requests = [np.arange(r * qpr, (r + 1) * qpr) for r in range(mix["pool_requests"])]
    return Pool(codes, lanes, bodies_of(codes, lanes), requests, mix["sample"])


def sweep_shapes(data, config, mix):
    """([(rows, lanes)] of every length partition, results per query)."""
    lanes, rows = np.unique(data.lanes, return_counts=True)
    return [(int(r), int(v)) for r, v in zip(rows, lanes)], mix["count"]


class System:
    """The index answering requests of one mix."""

    outside_label = "request"  # host time inside a request, outside the sweep

    def __init__(self, data, config, mix, device, spans):
        from iscc_search_tpu_torch.engine.device_index import DeviceNphdIndex

        n = len(data.lanes)
        keys = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
        self.index = DeviceNphdIndex.from_arrays(keys, data.codes, data.lanes, data.valid, device=str(device))
        self.recorder = SweepRecorder(self.index, spans)
        self.mix = mix
        self.count = mix["count"]

    def first_search(self, pool):
        """The first search builds and uploads the partitions."""
        self.index.search(pool.bodies[:1], self.count)

    def warm_shapes(self, pool):
        """One search at the mix's batch size."""
        self.index.search(pool.bodies[: self.mix["queries_per_request"]], self.count)

    def handle(self, pool, request):
        """Per item of the request, (keys (m, 8) uint8, scores (m,) float32)."""
        return self.recorder.search([pool.bodies[i] for i in request], self.count)

    def close(self):
        self.index = self.recorder = None
