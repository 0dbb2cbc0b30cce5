"""
Bit-packing of variable-length binary codes into fixed-width uint32 lane
matrices — the device-resident layout of the TPU engine.

Replaces the reference's usearch byte-vector layout (iscc-usearch
ShardedNphdIndex stores raw byte arrays per vector): here every code row is a
fixed 8x32-bit lane vector (256 bits max) plus a per-row lane count. ISCC-UNIT
bodies are always multiples of 64 bits (64/128/192/256 — models.py __len__),
so prefix masks land on whole 32-bit lanes and NPHD prefix popcounts reduce to
masked per-lane popcounts.

Lanes are big-endian within each 4-byte group so lane-prefix equality equals
byte-prefix equality.

This is a copy of ``iscc_search_tpu/ops/packing.py``: that package imports
jax and platformdirs at import time, so the port cannot import it on a host
without them. ``tests/test_torch_ops.py`` holds the two copies equal.
"""

from __future__ import annotations

import numpy as np

MAX_BITS = 256
LANE_BITS = 32
MAX_LANES = MAX_BITS // LANE_BITS  # 8


def pack_codes(bodies, max_lanes=MAX_LANES):
    # type: (list[bytes], int) -> tuple[np.ndarray, np.ndarray]
    """
    Pack variable-length code bodies into a (N, max_lanes) uint32 matrix.

    :param bodies: code bodies; each length must be a multiple of 4 bytes
        and at most 4*max_lanes
    :param max_lanes: lane capacity per row (default 8 = 256 bits)
    :return: (codes uint32 (N, max_lanes), nlanes int32 (N,))
    """
    n = len(bodies)
    codes = np.zeros((n, max_lanes), dtype=np.uint32)
    nlanes = np.zeros((n,), dtype=np.int32)

    # Bulk path: group rows by byte length and decode each group with one
    # frombuffer (per-row struct decoding dominates ingest otherwise).
    by_len = {}  # type: dict[int, list[int]]
    for i, body in enumerate(bodies):
        nb = len(body)
        if nb % 4 or nb == 0:
            raise ValueError(f"code body length {nb} not a positive multiple of 4 bytes")
        if nb > 4 * max_lanes:
            raise ValueError(f"code body too long: {nb} bytes > {4 * max_lanes}")
        by_len.setdefault(nb, []).append(i)
        nlanes[i] = nb // 4
    for nb, idxs in by_len.items():
        k = nb // 4
        blob = b"".join(bodies[i] for i in idxs)
        arr = np.frombuffer(blob, dtype=">u4").reshape(len(idxs), k).astype(np.uint32)
        codes[np.asarray(idxs), :k] = arr
    return codes, nlanes


def pack_code(body, max_lanes=MAX_LANES):
    # type: (bytes, int) -> tuple[np.ndarray, int]
    """Pack a single code body; returns (lane vector (max_lanes,), nlanes)."""
    codes, nlanes = pack_codes([body], max_lanes)
    return codes[0], int(nlanes[0])


def unpack_code(lanes, nlanes):
    # type: (np.ndarray, int) -> bytes
    """Inverse of pack_code: recover the code body bytes."""
    return np.asarray(lanes[:nlanes], dtype=np.uint32).astype(">u4").tobytes()
