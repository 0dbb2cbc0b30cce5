"""
Device-resident packed-code NPHD index in PyTorch (port of the in-memory
core of ``iscc_search_tpu/engine/device_index.py``).

- Codes live on the host as a bit-packed ``(N, 8)`` uint32 lane matrix plus
  per-row lane counts, keys and a validity bitmap. Updates tombstone the old
  row and append a new one.
- The device mirror partitions rows by code length (lane count), so the NPHD
  prefix scale is a per-query broadcast inside each partition. A partition
  is a packed ``(cap, lanes)`` int32 tensor and a ``(cap,)`` uint8 validity
  tensor on ``device``; no unpacked, permuted or bit-transposed twin exists.
- Search runs, per partition, the exact two-phase scan of
  :mod:`iscc_search_tpu_torch.ops.hopper_scan` (phase-1 block-max kernel,
  hierarchical top-k blocks, phase-3 gather-rescore kernel, final top-k),
  then merges the partitions' candidates on the host.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
item): persistence (``save``, ``compact``, loading a saved directory), the
multi-device ``mesh``, the multi-host ``control_hook`` and ``scan_kernel``
values other than ``"auto"``.
"""

from __future__ import annotations

import itertools
import threading
from pathlib import Path

import numpy as np
import torch

from iscc_search_tpu_torch.ops.hopper_scan import blockmax_topk_packedq_impl
from iscc_search_tpu_torch.ops.packing import MAX_LANES, pack_codes, unpack_code

_MIN_DEVICE_ROWS = 8192  # device partition capacity floor
_CAP_QUANTUM = 65536  # partition capacity granularity above the floor

_TODO_PERSISTENCE = "ROADMAP.md, 'Modules to port' item 1: persistence"
_TODO_PARALLEL = "ROADMAP.md, 'Modules to port' item 5: parallel/* on torch.distributed"
_TODO_KNOBS = "ROADMAP.md, 'Modules to port' item 6: knobs"

# Row-space generations are unique across instances, as in the JAX engine.
_ROW_GEN_COUNTER = itertools.count(1)


def _pow2ceil(n):
    # type: (int) -> int
    p = 1
    while p < n:
        p <<= 1
    return p


def _cap_rows(n):
    # type: (int) -> int
    """Partition capacity for ``n`` rows: pow2 up to 65536 rows (floor
    8192), else 12.5% headroom rounded up to a 65536 multiple — the JAX
    engine's sizing, so both scan the same padded row counts."""
    if n <= _CAP_QUANTUM:
        return max(_MIN_DEVICE_ROWS, _pow2ceil(n))
    return -(-(n + n // 8) // _CAP_QUANTUM) * _CAP_QUANTUM


def _to_device(array, device):
    # type: (np.ndarray, torch.device) -> torch.Tensor
    """Upload a contiguous host array (uint32 codes travel as int32 bits,
    bool validity as uint8)."""
    if array.dtype == np.uint32:
        array = array.view(np.int32)
    elif array.dtype == np.bool_:
        array = array.view(np.uint8)
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


class _Partition:
    """Device mirror of one code-length partition."""

    __slots__ = ("packed_dev", "valid_dev", "row_map", "cap", "count")

    def __init__(self, packed_dev, valid_dev, row_map, cap, count):
        self.packed_dev = packed_dev  # (cap, lanes) int32
        self.valid_dev = valid_dev  # (cap,) uint8; rebound (never mutated) per validity generation
        self.row_map = row_map  # (cap,) int32 global row per device row (padding rows -> 0, invalid)
        self.cap = cap
        self.count = count  # real rows uploaded


class PackedCodeIndex:
    """
    Packed host arrays + per-length device partitions + exact search.

    Subclasses fix the metric and key width.
    """

    metric = "nphd"
    key_bytes = 8

    @property
    def ROW_BYTES(self):
        # type: () -> int
        """Per-row storage estimate for shard sizing: key + lanes + nlanes + valid."""
        return self.key_bytes + MAX_LANES * 4 + 4 + 1

    def __init__(
        self,
        path=None,
        max_dim=256,
        shard_size=512 * 1024 * 1024,
        ndim=None,
        recall_target=None,
        scan_kernel="auto",
        mesh=None,
        device="cuda",
    ):
        # type: (str | Path | None, int, int, int | None, float | None, str, object, str | torch.device) -> None
        """
        Create an empty in-memory index. The parameters up to ``mesh`` are
        the JAX engine's, in its order.

        :param path: index directory; only a directory without a saved index
            is accepted (loading and saving are not ported yet)
        :param max_dim: maximum code width in bits
        :param shard_size: bytes per sealed segment; sets ``shard_rows`` as
            the JAX engine does (segments come with persistence)
        :param ndim: fixed code width in bits for the hamming metric
        :param recall_target: accepted for API parity and served EXACTLY —
            exact results meet any recall target; ``>= 1.0`` becomes None
        :param scan_kernel: "auto" only (the Hopper kernels on CUDA, their
            plain versions on the CPU)
        :param mesh: must be None (single device)
        :param device: torch device of the partitions, "cuda" by default;
            nothing is auto-detected
        """
        if mesh is not None:
            raise NotImplementedError(f"multi-device mesh search is not ported yet ({_TODO_PARALLEL})")
        if scan_kernel != "auto":
            raise NotImplementedError(f"scan_kernel={scan_kernel!r} is not ported yet ({_TODO_KNOBS})")
        self.path = Path(path) if path is not None else None
        if self.path is not None and (self.path / "state.json").exists():
            raise NotImplementedError(f"loading a saved index is not ported yet ({_TODO_PERSISTENCE})")
        self.max_dim = max_dim
        self.ndim = ndim
        self.max_lanes = MAX_LANES
        self.shard_rows = max(1024, shard_size // self.ROW_BYTES)
        self.recall_target = recall_target if (recall_target is None or recall_target < 1.0) else None
        self.scan_kernel = scan_kernel
        self.mesh = None
        self.device = torch.device(device)
        self._lock = threading.RLock()

        cap = _MIN_DEVICE_ROWS
        self._keys = np.zeros((cap, self.key_bytes), dtype=np.uint8)
        self._codes = np.zeros((cap, self.max_lanes), dtype=np.uint32)
        self._nlanes = np.zeros((cap,), dtype=np.int32)
        self._valid = np.zeros((cap,), dtype=bool)
        self._rows = 0  # appended rows (including tombstoned)
        self._row_gen = next(_ROW_GEN_COUNTER)
        self._key_to_row = {}  # type: dict[bytes, int] | None  # None = lazy (built by _keymap)
        self._live = 0  # live (non-tombstoned) key count
        self._partitions = None  # type: dict[int, _Partition] | None
        self._device_stale = True
        self._synced_rows = 0  # host rows already mirrored on the device
        self._valid_dirty = False  # tombstones changed since the last sync

    @classmethod
    def from_arrays(cls, keys, codes, nlanes, valid, **kwargs):
        # type: (np.ndarray, np.ndarray, np.ndarray, np.ndarray, ...) -> PackedCodeIndex
        """
        An index holding the given host state: (n, key_bytes) uint8 keys,
        (n, <= 8) uint32 codes, (n,) int32 lane counts, (n,) bool validity —
        e.g. the first ``_rows`` rows of the JAX index's host arrays.

        :param kwargs: constructor arguments (``device`` etc.)
        """
        idx = cls(**kwargs)
        n = len(keys)
        idx._ensure_capacity(n)
        idx._keys[:n] = keys
        idx._codes[:n, : codes.shape[1]] = codes
        idx._nlanes[:n] = nlanes
        idx._valid[:n] = valid
        idx._rows = n
        idx._key_to_row = None  # built from the validity bitmap on first use
        idx._live = int(np.count_nonzero(idx._valid[:n]))
        return idx

    # -- public API -------------------------------------------------------------

    def __len__(self):
        # type: () -> int
        return self._live

    @property
    def size(self):
        # type: () -> int
        """Number of live (non-tombstoned) keys."""
        return self._live

    def __contains__(self, key):
        # type: (bytes | int) -> bool
        return self._key(key) in self._keymap

    @property
    def control_hook(self):
        """Multi-host operation hook: always None here (not ported yet)."""
        return None

    @control_hook.setter
    def control_hook(self, hook):
        if hook is not None:
            raise NotImplementedError(f"the multi-host control hook is not ported yet ({_TODO_PARALLEL})")

    @property
    def _keymap(self):
        # type: () -> dict[bytes, int]
        """key -> row map, built lazily from the validity bitmap."""
        km = self._key_to_row
        if km is None:
            with self._lock:
                km = self._key_to_row
                if km is None:
                    rows = self._rows
                    width = self.key_bytes
                    buf = self._keys[:rows].tobytes()
                    km = {}
                    for i in np.flatnonzero(self._valid[:rows]).tolist():
                        off = i * width
                        km[buf[off : off + width]] = i
                    self._key_to_row = km
        return km

    def add(self, keys, vectors):
        # type: (list, list[bytes]) -> None
        """
        Append codes; an existing key is updated (old row tombstoned).

        :param keys: row keys (int for 8-byte indexes, bytes otherwise)
        :param vectors: code bodies (bytes, multiples of 4 bytes)
        """
        if not keys:
            return
        with self._lock:
            kbs = [self._key(k) for k in keys]
            packed, nlanes = pack_codes([self._vector_bytes(v) for v in vectors], self.max_lanes)
            n = len(kbs)
            self._ensure_capacity(self._rows + n)
            start = self._rows
            keymap = self._keymap
            batch_dup_rows = []  # rows within THIS batch superseded by a later duplicate key
            for i, kb in enumerate(kbs):
                old = keymap.get(kb)
                if old is None:
                    self._live += 1
                else:
                    self._valid[old] = False
                    self._valid_dirty = True
                    if old >= start:
                        batch_dup_rows.append(old)
                row = start + i
                self._keys[row] = np.frombuffer(kb, dtype=np.uint8)
                keymap[kb] = row
            self._codes[start : start + n] = packed
            self._nlanes[start : start + n] = nlanes
            self._valid[start : start + n] = True
            for row in batch_dup_rows:
                self._valid[row] = False
            self._rows += n
            self._device_stale = True

    def add_packed(self, keys, packed, nlanes):
        # type: (np.ndarray, np.ndarray, np.ndarray | int) -> None
        """
        Vectorized bulk append of pre-packed rows.

        CONTRACT: ``keys`` must be unique within the batch and not already
        present in the index (no dedup/update, as in the JAX engine).

        :param keys: (n, key_bytes) uint8 key matrix
        :param packed: (n, L) uint32 packed codes, L <= max_lanes
        :param nlanes: (n,) int32 lane counts, or a scalar applied to all rows
        """
        keys = np.ascontiguousarray(keys, dtype=np.uint8)
        packed = np.ascontiguousarray(packed, dtype=np.uint32)
        n = keys.shape[0]
        if n == 0:
            return
        if keys.ndim != 2 or keys.shape[1] != self.key_bytes:
            raise ValueError(f"keys must be (n, {self.key_bytes}) uint8, got {keys.shape}")
        if packed.shape[0] != n or packed.ndim != 2 or packed.shape[1] > self.max_lanes:
            raise ValueError(f"packed must be (n, <= {self.max_lanes}) uint32, got {packed.shape}")
        if np.isscalar(nlanes) or getattr(nlanes, "ndim", 1) == 0:
            nlanes = np.full(n, int(nlanes), np.int32)
        else:
            nlanes = np.ascontiguousarray(nlanes, dtype=np.int32)
            if nlanes.shape != (n,):
                raise ValueError(f"nlanes must be (n,), got {nlanes.shape}")
        if int(nlanes.max(initial=0)) > packed.shape[1] or int(nlanes.min(initial=1)) < 1:
            raise ValueError("nlanes out of range")
        with self._lock:
            self._ensure_capacity(self._rows + n)
            start = self._rows
            self._keys[start : start + n] = keys
            self._codes[start : start + n, : packed.shape[1]] = packed
            self._codes[start : start + n, packed.shape[1] :] = 0
            self._nlanes[start : start + n] = nlanes
            self._valid[start : start + n] = True
            km = self._key_to_row
            if km is not None:
                width = self.key_bytes
                buf = keys.tobytes()
                for i in range(n):
                    km[buf[i * width : (i + 1) * width]] = start + i
            self._rows += n
            self._live += n
            self._device_stale = True

    def remove(self, keys):
        # type: (list) -> int
        """Tombstone keys; returns the number of keys actually removed."""
        removed = 0
        with self._lock:
            keymap = self._keymap
            for k in keys:
                row = keymap.pop(self._key(k), None)
                if row is not None:
                    self._valid[row] = False
                    self._live -= 1
                    removed += 1
            if removed:
                self._device_stale = True
                self._valid_dirty = True
        return removed

    def get(self, key):
        # type: (bytes | int) -> bytes | None
        """Stored code body for a key, or None."""
        with self._lock:
            row = self._keymap.get(self._key(key))
            if row is None:
                return None
            return unpack_code(self._codes[row], int(self._nlanes[row]))

    @property
    def row_generation(self):
        # type: () -> int
        """Current row-space generation (see :meth:`body_at`)."""
        with self._lock:
            return self._row_gen

    def body_at(self, row, gen=None):
        # type: (int, int | None) -> bytes | None
        """Stored code body at a ROW returned by ``search(return_rows=True)``,
        or None when the row does not exist or ``gen`` is stale."""
        with self._lock:
            if gen is not None and gen != self._row_gen:
                return None
            if row < 0 or row >= self._rows or self._nlanes[row] <= 0:
                return None
            return unpack_code(self._codes[row], int(self._nlanes[row]))

    def search(self, query_bodies, count, return_rows=False):
        # type: (list[bytes], int, bool) -> list[tuple]
        """
        Exact top-``count`` scan for a batch of queries.

        :param query_bodies: query code bodies
        :param count: results per query
        :param return_rows: also return each candidate's host row id
        :return: per query a (keys (m, key_bytes) uint8, scores (m,) float32)
            pair — plus rows (m,) int when ``return_rows`` — sorted by score
            descending; m <= count
        """
        if not query_bodies or self._rows == 0 or self._live == 0:
            empty = [
                (np.zeros((0, self.key_bytes), np.uint8), np.zeros(0, np.float32), np.zeros(0, np.int64))
                for _ in query_bodies
            ]
            return empty if return_rows else [e[:2] for e in empty]
        return self._search_impl(query_bodies, count, return_rows)

    def save(self, wait=True):
        # type: (bool) -> None
        raise NotImplementedError(f"saving is not ported yet ({_TODO_PERSISTENCE})")

    def compact(self):
        # type: () -> None
        raise NotImplementedError(f"compaction is not ported yet ({_TODO_PERSISTENCE})")

    def close(self):
        # type: () -> None
        """Release the device mirror (nothing is persisted)."""
        with self._lock:
            self._partitions = None
            self._synced_rows = 0
            self._device_stale = True

    # -- internals ----------------------------------------------------------------

    def _search_impl(self, query_bodies, count, return_rows=False):
        # type: (list[bytes], int, bool) -> list[tuple]
        with self._lock:
            synced = self._sync_device()
            # A consistent (buffer, validity, row_map) triple per partition:
            # a concurrent sync rebinds validity and appends rows past count.
            partitions = {lanes: (p.packed_dev, p.valid_dev, p.row_map, p.cap) for lanes, p in synced.items()}
            keys_snapshot = self._keys[: self._rows]

        q_codes, q_lanes = pack_codes([self._vector_bytes(b) for b in query_bodies], self.max_lanes)
        q_codes_dev = _to_device(q_codes, self.device)
        q_lanes_dev = _to_device(q_lanes, self.device)
        pending = []
        for lanes in sorted(partitions):
            packed_dev, valid_dev, row_map, cap = partitions[lanes]
            # k as the JAX engine buckets it (pow2, at most the partition);
            # trimmed to `count` in _collect_results.
            k = min(_pow2ceil(max(1, count)), cap)
            scores, rows = blockmax_topk_packedq_impl(q_codes_dev, q_lanes_dev, packed_dev, valid_dev, k, lanes * 32)
            pending.append((row_map, scores, rows))
        return self._collect_results(pending, len(query_bodies), count, keys_snapshot, return_rows)

    def _collect_results(self, pending, nq, count, keys_snapshot, return_rows):
        # type: (list, int, int, np.ndarray, bool) -> list[tuple]
        """Read back every partition's (scores, rows), map device rows to
        global rows, and merge the per-query candidates on the host."""
        if self.device.type == "cuda":
            # Every copy is queued before one wait: the readbacks overlap each
            # other and the tail of the device work.
            host = []
            for row_map, scores_dev, idx_dev in pending:
                pair = []
                for t in (scores_dev[:, :count], idx_dev[:, :count]):
                    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    buf.copy_(t, non_blocking=True)
                    pair.append(buf)
                host.append((row_map, *pair))
            torch.cuda.current_stream(self.device).synchronize()
        else:
            host = [(rm, s[:, :count], i[:, :count]) for rm, s, i in pending]

        cand_scores = [[] for _ in range(nq)]  # type: list[list[np.ndarray]]
        cand_rows = [[] for _ in range(nq)]  # type: list[list[np.ndarray]]
        for row_map, scores_t, idx_t in host:
            scores = scores_t.numpy()
            idx = idx_t.numpy()
            for qi in range(nq):
                sel = idx[qi] >= 0
                cand_scores[qi].append(scores[qi][sel])
                cand_rows[qi].append(row_map[idx[qi][sel]])

        results = []
        for qi in range(nq):
            s = np.concatenate(cand_scores[qi])
            r = np.concatenate(cand_rows[qi])
            order = np.argsort(-s, kind="stable")[:count]
            rr = r[order]
            if return_rows:
                results.append((keys_snapshot[rr], s[order].astype(np.float32), rr))
            else:
                results.append((keys_snapshot[rr], s[order].astype(np.float32)))
        return results

    def _key(self, key):
        # type: (bytes | int) -> bytes
        if isinstance(key, (int, np.integer)):
            return int(key).to_bytes(self.key_bytes, "big")
        key = bytes(key)
        if len(key) != self.key_bytes:
            raise ValueError(f"key must be {self.key_bytes} bytes, got {len(key)}")
        return key

    def _vector_bytes(self, vec):
        # type: (bytes | np.ndarray) -> bytes
        if isinstance(vec, np.ndarray):
            vec = vec.tobytes()
        return bytes(vec)

    def _ensure_capacity(self, needed):
        # type: (int) -> None
        cap = self._keys.shape[0]
        if needed <= cap:
            return
        new_cap = _pow2ceil(needed)

        def grow(arr, shape):
            out = np.zeros(shape, dtype=arr.dtype)
            out[: self._rows] = arr[: self._rows]
            return out

        self._keys = grow(self._keys, (new_cap, self.key_bytes))
        self._codes = grow(self._codes, (new_cap, self.max_lanes))
        self._nlanes = grow(self._nlanes, (new_cap,))
        self._valid = grow(self._valid, (new_cap,))

    def _sync_device(self):
        # type: () -> dict[int, _Partition]
        """
        Mirror the host arrays on the device as per-length partitions: a full
        build on first use, afterwards only the rows appended since the last
        sync (a partition whose capacity overflows is rebuilt alone) and,
        after tombstoning, fresh validity tensors.
        """
        if not self._device_stale and self._partitions is not None:
            return self._partitions

        rows = self._rows
        try:
            if self._partitions is None:
                self._partitions = {}
                nlanes = self._nlanes[:rows]
                for lanes in np.unique(nlanes):
                    lanes = int(lanes)
                    row_map = np.flatnonzero(nlanes == lanes).astype(np.int32)
                    self._partitions[lanes] = self._build_partition(lanes, row_map)
            else:
                new_lanes = self._nlanes[self._synced_rows : rows]
                for lanes in np.unique(new_lanes):
                    lanes = int(lanes)
                    new_rows = (self._synced_rows + np.flatnonzero(new_lanes == lanes)).astype(np.int32)
                    part = self._partitions.get(lanes)
                    if part is None or part.count + len(new_rows) > part.cap:
                        row_map = np.flatnonzero(self._nlanes[:rows] == lanes).astype(np.int32)
                        self._partitions[lanes] = self._build_partition(lanes, row_map)
                    else:
                        self._append_to_partition(part, lanes, new_rows)
                if self._valid_dirty:
                    for part in self._partitions.values():
                        valid = np.zeros((part.cap,), bool)
                        valid[: part.count] = self._valid[part.row_map[: part.count]]
                        part.valid_dev = _to_device(valid, self.device)
        except BaseException:
            # A partial incremental sync would re-append rows on retry: force
            # a full rebuild instead.
            self._partitions = None
            self._synced_rows = 0
            self._device_stale = True
            raise

        self._synced_rows = rows
        self._valid_dirty = False
        self._device_stale = False
        return self._partitions

    def _build_partition(self, lanes, row_map):
        # type: (int, np.ndarray) -> _Partition
        """Upload one partition from scratch (capacity per _cap_rows)."""
        n = len(row_map)
        cap = _cap_rows(n)
        packed = np.zeros((cap, lanes), np.uint32)
        packed[:n] = self._codes[row_map, :lanes]
        valid = np.zeros((cap,), bool)
        valid[:n] = self._valid[row_map]
        full_map = np.zeros((cap,), np.int32)
        full_map[:n] = row_map
        return _Partition(_to_device(packed, self.device), _to_device(valid, self.device), full_map, cap, n)

    def _append_to_partition(self, part, lanes, new_rows):
        # type: (_Partition, int, np.ndarray) -> None
        """Device append of new rows, in place.

        Writing rows past ``part.count`` in place is safe for a concurrent
        search holding an older snapshot: its validity tensor marks those
        rows invalid, and an invalid row's bits reach no result. Validity is
        rebound to a fresh tensor, never written in place.
        """
        m = len(new_rows)
        start = part.count
        part.packed_dev[start : start + m] = _to_device(self._codes[new_rows, :lanes], self.device)
        part.row_map[start : start + m] = new_rows
        part.count = start + m
        valid = np.zeros((part.cap,), bool)
        valid[: part.count] = self._valid[part.row_map[: part.count]]
        part.valid_dev = _to_device(valid, self.device)


class DeviceNphdIndex(PackedCodeIndex):
    """
    Variable-length NPHD index over uint64 keys (port of the JAX engine's
    ``DeviceNphdIndex``). Search is exact.
    """

    metric = "nphd"
    key_bytes = 8

    def search_one(self, query_body, count):
        # type: (bytes, int) -> dict[int, float]
        """Top-``count`` matches for one query as {uint64 key: score}."""
        ((keys, scores),) = self.search([query_body], count)
        return {int.from_bytes(keys[i].tobytes(), "big"): float(scores[i]) for i in range(len(scores))}
