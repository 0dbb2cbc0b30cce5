"""
Device-resident packed-code indexes in PyTorch (port of
``iscc_search_tpu/engine/device_index.py``: the host arrays, the device
mirror, the exact search and the segment persistence): ``DeviceNphdIndex``
over 8-byte keys and ``DeviceHammingIndex``, the simprint engine's
fixed-width index over 16-byte keys.

- Codes live on the host as a bit-packed ``(N, 8)`` uint32 lane matrix plus
  per-row lane counts, keys and a validity bitmap. Updates tombstone the old
  row and append a new one.
- The device mirror partitions rows by code length (lane count), so the NPHD
  prefix scale is a per-query broadcast inside each partition. A partition
  is a packed ``(cap, lanes)`` int32 tensor and a ``(cap,)`` uint8 validity
  tensor on ``device``; no permuted or bit-transposed twin exists, and an
  unpacked one only on a mesh under ``scan_kernel="pallas"``.
- Search runs, per partition, the exact two-phase scan of
  :mod:`iscc_search_tpu_torch.ops.hopper_scan` (phase-1 block-max kernel,
  hierarchical top-k blocks, phase-3 gather-rescore kernel, final top-k),
  then merges the partitions' candidates on the host. Phase 1 has three
  kernels that return the same block maxima bit for bit: XOR + popc, the
  int8 tensor cores through ``mma.sync`` for small batches and through
  ``wgmma`` for large ones; ``scan_kernel`` forces one (``"popc"``,
  ``"mma_small"``, ``"mma"``) or, as ``"auto"``, takes per partition the one
  that :func:`auto_phase1` names for the batch size and the partition's
  width.
- ``scan_kernel`` also takes the JAX engine's values, and every route is a
  kernel route. ``"xla"`` routes as ``"auto"``: the JAX engine's XLA scan
  exists because Pallas lowers only on a TPU, and the port's kernels run on
  every card it supports. ``"pallas"`` routes as ``"auto"`` on one device
  (the TPU's bit-transposed and permuted twins are not ported,
  ``ops/hopper_scan.py``); on a mesh it builds the ±1 int8 twin per shard
  within ``ISCC_SEARCH_UNPACKED_MAX_BYTES`` and searches it through
  ``sharded_pallas_topk`` (phase 1 on ``blockmax_mma_unpacked``), at any
  ``count``; a partition without its twin takes the kernel route per shard.
- ``recall_target < 1.0`` is served exactly, by the same routes. Off a TPU
  the JAX engine's ``"approx"`` route is exact too: XLA lowers
  ``approx_max_k`` to its exact fallback there.
- With a ``mesh`` (:mod:`iscc_search_tpu_torch.parallel`), each partition
  is row-sharded over the mesh at a power-of-two capacity per shard; every
  shard runs the same per-partition scan on its own device, then the
  shards' candidates merge (:func:`~iscc_search_tpu_torch.parallel.merge.merge_topk`):
  on the lead device, and across processes through the mesh's process group.
- Multi-host (:mod:`iscc_search_tpu_torch.parallel.service`): a settable
  ``control_hook`` mirrors ``add``, ``add_packed``, ``remove`` and
  ``search`` to the follower processes of a cluster; each public method
  validates and normalizes its arguments, then goes through the hook to its
  ``_*_impl``, which a follower calls directly, as in the JAX engine.
- Persistence is the JAX engine's, file for file: sealed immutable segments
  of ``shard_size`` bytes (``seg-%08d.npz``, written once), a rewritable
  active segment and a validity bitmap under a fresh name on every save
  (``active-%08d.npz``, ``valid-%08d.npz``), each written to a temporary
  file, fsynced and renamed, one directory fsync, then the ``state.json``
  rename as the commit point; superseded files go only after it. Saves
  snapshot the arrays under the lock and write on a background worker;
  queued snapshots coalesce by sequence. A directory saved by either
  package loads in the other. ``path=None`` is an in-memory index that
  never saves.
"""

from __future__ import annotations

import io
import itertools
import json
import logging
import os
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from iscc_search_tpu_torch import tracing
from iscc_search_tpu_torch.ops import hopper_scan
from iscc_search_tpu_torch.ops.hopper_scan import blockmax_topk_packedq_impl
from iscc_search_tpu_torch.ops.packing import MAX_LANES, pack_codes, unpack_code
from iscc_search_tpu_torch.ops.pm1_scan import query_prefix
from iscc_search_tpu_torch.parallel.merge import merge_shards, scan_shards
from iscc_search_tpu_torch.parallel.pallas_sharded import shard_unpacked_db, sharded_pallas_topk
from iscc_search_tpu_torch.parallel.pm1_sharded import shard_pm1_database

_MIN_DEVICE_ROWS = 8192  # device partition capacity floor
_CAP_QUANTUM = 65536  # partition capacity granularity above the floor

logger = logging.getLogger(__name__)

# The JAX engine's values ("auto", "pallas", "xla"), then the port's forced
# phase-1 kernels (keys of hopper_scan.PHASE1).
SCAN_KERNELS = ("auto", "pallas", "xla", "mma", "mma_small", "popc")

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


def _unpacked_budget_bytes():
    # type: () -> int
    """Device bytes one shard's ±1 int8 twin may take (8x its packed rows),
    ``ISCC_SEARCH_UNPACKED_MAX_BYTES``, 9 GiB by default as in the JAX
    engine; a partition whose twin would not fit serves from the packed
    rows."""
    return int(os.environ.get("ISCC_SEARCH_UNPACKED_MAX_BYTES", 9 * 1024**3))


def _scan_k(rows, count):
    # type: (int, int) -> int
    """The k of a scan over ``rows`` rows (a partition, or one shard) for
    ``count`` results: bucketed to a power of two, at most ``rows``, the
    JAX engine's k; trimmed to ``count`` in ``_collect_results``."""
    return min(_pow2ceil(max(1, count)), rows)


def _to_device(array, device):
    # type: (np.ndarray, torch.device) -> torch.Tensor
    """Upload a contiguous host array (uint32 codes travel as int32 bits,
    bool validity as uint8)."""
    if array.dtype == np.uint32:
        array = array.view(np.int32)
    elif array.dtype == np.bool_:
        array = array.view(np.uint8)
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


# scan_kernel="auto", by the partition's lane count: (the smallest batch for
# which phase 1 goes to the small-batch kernel, the smallest for which it
# goes to the wgmma kernel of blockmax_mma.cu). Below the first the XOR +
# popc kernel wins: it is linear in the batch from the byte bound at Q=1,
# while the small-batch kernel pays its unpack per row word whatever the
# batch. Above 128 queries the small-batch kernel reads the rows once per
# 128-query chunk, and the wgmma kernel, flat up to 128 queries and
# staging the rows once for up to 512, wins. Taken from the [route] table of
# chip_smoke.py (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6), which
# fails when the table goes stale.
_AUTO_ROUTE = {2: (8, 129), 4: (8, 129), 6: (8, 129), 8: (8, 129)}


def resolve_device(device):
    # type: (str | torch.device) -> torch.device
    """``device`` as a torch.device. A CUDA device without a card raises:
    nothing falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}, but no CUDA device is available (pass device='cpu' for the CPU)")
    return dev


def auto_phase1(nq, lanes):
    # type: (int, int) -> str
    """The phase-1 kernel ``scan_kernel="auto"`` takes for a batch of ``nq``
    queries on a partition of ``lanes`` lanes: ``"popc"``, ``"mma_small"``
    or ``"mma"`` (keys of ``hopper_scan.PHASE1``). An odd lane count reads
    the next even one's entry, the nearest measured width that does no less
    work."""
    small_from, mma_from = _AUTO_ROUTE[min(MAX_LANES, lanes + lanes % 2)]
    return "mma" if nq >= mma_from else "mma_small" if nq >= small_from else "popc"


def _fsync_dir(path):
    # type: (Path) -> None
    dfd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _atomic_write(path, data, sync_dir=True):
    # type: (Path, bytes, bool) -> None
    """Write bytes durably: temp file + fsync + rename + DIRECTORY fsync.

    Without the directory fsync the rename itself is neither durable nor
    ordered across power loss: a later rename (the manifest) could survive
    while an earlier one (a segment) is lost, leaving the manifest
    referencing a missing file. Batch writers pass sync_dir=False per file
    and make ONE directory fsync before the manifest instead (the required
    ordering is only data-renames-durable-before-manifest-rename)."""
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=path.name, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        if sync_dir:
            _fsync_dir(path.parent)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _npz_bytes(**arrays):
    # type: (...) -> bytes
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


class _Partition:
    """Device mirror of one code-length partition."""

    __slots__ = ("packed_dev", "valid_dev", "unpacked_dev", "row_map", "cap", "count")

    def __init__(self, packed_dev, valid_dev, row_map, cap, count, unpacked_dev=None):
        # (cap, lanes) int32 and (cap,) uint8; with a mesh, lists of this
        # process's shards. Validity is rebound (never mutated) per generation.
        self.packed_dev = packed_dev
        self.valid_dev = valid_dev
        # The ±1 int8 twin per shard (a list like packed_dev), on a mesh under
        # scan_kernel="pallas" within _unpacked_budget_bytes(); else None.
        self.unpacked_dev = unpacked_dev
        self.row_map = row_map  # (cap,) int32 global row per device row (padding rows -> 0, invalid)
        self.cap = cap
        self.count = count  # real rows uploaded


class PackedCodeIndex:
    """
    Packed host arrays + per-length device partitions + exact search +
    segment persistence.

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
        Create or open a packed-code index directory. The parameters up to
        ``mesh`` are the JAX engine's, in its order.

        :param path: segment directory (created by the first save; a saved
            index found there is loaded), or None for an in-memory index
            that never saves
        :param max_dim: maximum code width in bits
        :param shard_size: seal an immutable segment after this many bytes
        :param ndim: fixed code width in bits for the hamming metric
        :param recall_target: accepted for API parity and served EXACTLY by
            the kernel routes (exact results meet any recall target; off a
            TPU XLA lowers the JAX engine's approximate top-k to an exact
            one too); ``>= 1.0`` becomes None
        :param scan_kernel: the scan. "popc" (XOR + popc), "mma_small" (int8
            tensor cores, ``mma.sync``, small batches) and "mma" (int8 tensor
            cores, ``wgmma``) force a phase-1 kernel; "auto" takes one per
            partition and batch (:func:`auto_phase1`); "pallas" (the JAX
            engine's fused kernels) routes as "auto" on one device and
            through the ±1 int8 twin per shard on a mesh (phase 1 on
            ``blockmax_mma_unpacked``) where it fits
            ``ISCC_SEARCH_UNPACKED_MAX_BYTES``; "xla" (the JAX engine's XLA
            scan) routes as "auto". The results are the same. On the CPU
            every kernel runs its plain version. Another value raises
            ``ValueError``.
        :param mesh: optional :class:`~iscc_search_tpu_torch.parallel.mesh.Mesh`:
            partitions row-shard over it and searches merge the shards'
            candidates; a mesh of one shard is no mesh. Its devices must be
            of ``device``'s type; its first is the lead device, where
            queries are prepared and results merged
        :param device: torch device of the partitions, "cuda" by default;
            nothing is auto-detected, and "cuda" without a card raises
        """
        if scan_kernel not in SCAN_KERNELS:
            raise ValueError(f"scan_kernel: {scan_kernel!r} is not one of {SCAN_KERNELS}")
        self.path = Path(path) if path is not None else None
        self.max_dim = max_dim
        self.ndim = ndim
        self.max_lanes = MAX_LANES
        self.shard_rows = max(1024, shard_size // self.ROW_BYTES)
        self.recall_target = recall_target if (recall_target is None or recall_target < 1.0) else None
        self.scan_kernel = scan_kernel
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = resolve_device(device)
        if self.mesh is not None:
            kinds = {d.type for d in self.mesh.devices}
            if kinds != {self.device.type}:
                raise ValueError(f"device={str(device)!r}, but the mesh's shards are on {sorted(kinds)}")
            self.device = self.mesh.devices[0]
        # Multi-host SPMD hook (parallel/service.py): set on the coordinator's
        # indexes to fan device-relevant ops out to follower processes; None
        # everywhere else (single-process) and on follower replicas.
        self.control_hook = None
        # Followers never persist (the coordinator's directory is the truth);
        # an in-memory index has no directory to save to.
        self.save_enabled = self.path is not None
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
        self.dirty = 0  # unsaved key mutations since last save
        self._segments = []  # type: list[dict]  # {"file", "start", "rows"} sealed on disk
        self._partitions = None  # type: dict[int, _Partition] | None
        self._device_stale = True
        self._synced_rows = 0  # host rows already mirrored on the device
        self._valid_dirty = False  # tombstones changed since the last sync
        self._closed = False
        # Background save worker: latest snapshot pending (coalesced) + the
        # one in flight; drain_rotations()/close() join both.
        self._save_cv = threading.Condition()
        self._save_queue = None  # type: dict | None
        self._save_inflight = False
        self._save_stop = False
        self._save_thread = None  # type: threading.Thread | None
        self._written_seq = 0  # highest snapshot seq successfully on disk
        self._resave_all = False  # a failed write must re-emit sealed files
        # Sealed segments not yet confirmed written (queued snapshots can be
        # coalesced away; their seals must ride the NEXT snapshot instead).
        self._unconfirmed_seals = set()  # type: set[str]
        # Monotonic counters: every snapshot gets a sequence number (older
        # snapshots must never replace newer ones in the coalescing queue)
        # and every emitted data file gets a unique name (the old manifest
        # keeps referencing the OLD files until the new manifest commits).
        self._save_seq = 0
        self._file_seq = 0
        # Files no manifest-to-be references anymore; unlinked by the save
        # worker only AFTER a newer manifest commits (never eagerly: the
        # on-disk manifest may still reference them).
        self._pending_deletes = set()  # type: set[str]

        if self.path is not None and (self.path / "state.json").exists():
            self._load()

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
        idx.dirty = n
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

    @property
    def shard_count(self):
        # type: () -> int
        active_rows = self._rows - (self._segments[-1]["start"] + self._segments[-1]["rows"] if self._segments else 0)
        return len(self._segments) + (1 if active_rows > 0 or not self._segments else 0)

    @property
    def serialized_length(self):
        # type: () -> int
        """Estimated serialized bytes of live state (monitoring)."""
        return self._rows * self.ROW_BYTES

    @property
    def tombstone_fraction(self):
        # type: () -> float
        if self._rows == 0:
            return 0.0
        return 1.0 - self._live / self._rows

    def add(self, keys, vectors):
        # type: (list, list[bytes]) -> None
        """
        Append codes; an existing key is updated (old row tombstoned).

        :param keys: row keys (int for 8-byte indexes, bytes otherwise)
        :param vectors: code bodies (bytes, multiples of 4 bytes)
        """
        if not keys:
            return
        if self.control_hook is not None:
            # Mirror the EXACT engine-level call on every cluster process so
            # replicas append identical rows in identical order (bytes are
            # pickle-friendly; ndarray vectors normalize to bytes first).
            vectors = [self._vector_bytes(v) for v in vectors]
            return self.control_hook("add", (list(keys), vectors), lambda: self._add_impl(keys, vectors))
        return self._add_impl(keys, vectors)

    def _add_impl(self, keys, vectors):
        # type: (list, list[bytes]) -> None
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
            self.dirty += n
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
        if self.control_hook is not None:
            return self.control_hook(
                "add_packed", (keys, packed, nlanes), lambda: self._add_packed_impl(keys, packed, nlanes)
            )
        return self._add_packed_impl(keys, packed, nlanes)

    def _add_packed_impl(self, keys, packed, nlanes):
        # type: (np.ndarray, np.ndarray, np.ndarray) -> None
        n = keys.shape[0]
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
            self.dirty += n
            self._device_stale = True

    def remove(self, keys):
        # type: (list) -> int
        """Tombstone keys; returns the number of keys actually removed."""
        if self.control_hook is not None:
            return self.control_hook("remove", (list(keys),), lambda: self._remove_impl(keys))
        return self._remove_impl(keys)

    def _remove_impl(self, keys):
        # type: (list) -> int
        removed = 0
        with self._lock:
            keymap = self._keymap
            for k in keys:
                row = keymap.pop(self._key(k), None)
                if row is not None:
                    self._valid[row] = False
                    self._live -= 1
                    removed += 1
                    self.dirty += 1
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
        if self.control_hook is not None:
            bodies = [self._vector_bytes(b) for b in query_bodies]
            return self.control_hook(
                "search", (bodies, count), lambda: self._search_impl(bodies, count, return_rows)
            )
        return self._search_impl(query_bodies, count, return_rows)

    def save(self, wait=True):
        # type: (bool) -> None
        """
        Persist sealed segments (write-once), the active segment, the validity
        bitmap, and the state manifest. Atomic per file; the manifest rename is
        the commit point. Compacts first when tombstones dominate.

        The arrays are snapshotted under the lock (a memcpy) and written by a
        background worker, so concurrent ``add``/``search`` never stall on
        file I/O. ``wait=False`` returns after scheduling; queued snapshots
        coalesce (a newer snapshot's manifest supersedes an older one), so at
        most one write queues behind the one in flight.
        """
        if not self.save_enabled:
            return
        with self._lock:
            if self.tombstone_fraction > 0.5 and self._rows > _MIN_DEVICE_ROWS:
                self._compact_locked()
            snapshot = self._snapshot_locked()
            self.dirty = 0
        self._enqueue_save(snapshot, wait=wait)

    def _snapshot_locked(self):
        # type: () -> dict
        """Copy everything one save needs; caller holds the lock.

        Every sealed segment whose write has not been CONFIRMED on disk is
        (re-)included: a queued snapshot may be superseded by a newer one
        before the worker writes it (coalescing), and a manifest must never
        reference a seg file that only a dropped or failed snapshot carried.
        """
        writes = []  # (descriptor, keys, codes, nlanes) per segment file
        emitted = set()
        sealed_rows = self._segments[-1]["start"] + self._segments[-1]["rows"] if self._segments else 0
        if self._resave_all:
            # A previous write failed after sealing in memory: re-emit every
            # sealed file so the next manifest never references a missing one.
            for seg in self._segments:
                writes.append(self._segment_snapshot(seg))
                emitted.add(seg["file"])
            self._resave_all = False
        else:
            for seg in self._segments:
                if seg["file"] in self._unconfirmed_seals:
                    writes.append(self._segment_snapshot(seg))
                    emitted.add(seg["file"])
        while self._rows - sealed_rows >= self.shard_rows:
            self._file_seq += 1
            seg = {
                "file": f"seg-{self._file_seq:08d}.npz",  # unique, never reused
                "start": sealed_rows,
                "rows": self.shard_rows,
            }
            self._segments.append(seg)
            writes.append(self._segment_snapshot(seg))
            emitted.add(seg["file"])
            sealed_rows += self.shard_rows
        self._unconfirmed_seals.update(emitted)
        # Fresh names for the rewritable files on EVERY save: overwriting
        # them in place would invalidate the data the still-committed OLD
        # manifest references; a crash between the data write and the
        # manifest rename must leave the old state loadable.
        self._save_seq += 1
        seq = self._save_seq
        active = {"file": f"active-{seq:08d}.npz", "start": sealed_rows, "rows": self._rows - sealed_rows}
        valid_file = f"valid-{seq:08d}.npz"
        writes.append(self._segment_snapshot(active))
        state = {
            "rows": self._rows,
            "max_dim": self.max_dim,
            "ndim": self.ndim,
            "key_bytes": self.key_bytes,
            "segments": list(self._segments),
            "active": active,
            "valid_file": valid_file,
            "save_seq": seq,
            "file_seq": self._file_seq,
        }
        # Previous active/valid files are unreferenced once THIS manifest
        # commits; queue them for post-commit deletion (the worker unlinks
        # only after the rename, and a superseding snapshot inherits them).
        self._pending_deletes.add(f"active-{seq - 1:08d}.npz")
        self._pending_deletes.add(f"valid-{seq - 1:08d}.npz")
        self._pending_deletes.update({"active.npz", "valid.npy"})  # legacy fixed names
        self._pending_deletes.discard(active["file"])
        self._pending_deletes.discard(valid_file)
        return {
            "seq": seq,
            "writes": writes,
            "valid": self._valid[: self._rows].copy(),
            "valid_file": valid_file,
            "state": state,
            "sealed_files": sorted(emitted),
            "delete_after": sorted(self._pending_deletes),
        }

    def _segment_snapshot(self, seg):
        # type: (dict) -> tuple
        s, n = seg["start"], seg["rows"]
        return (
            seg,
            self._keys[s : s + n].copy(),
            self._codes[s : s + n].copy(),
            self._nlanes[s : s + n].copy(),
        )

    def _enqueue_save(self, snapshot, wait):
        # type: (dict, bool) -> None
        with self._save_cv:
            if self._save_thread is None or not self._save_thread.is_alive():
                self._save_stop = False
                self._save_thread = threading.Thread(
                    target=self._save_worker, name=f"save-{self.path.name}", daemon=True
                )
                self._save_thread.start()
            # Coalesce by SEQUENCE: an older snapshot (taken before, enqueued
            # after: snapshot and enqueue are not atomic) must never replace
            # a newer one in the queue, NOR be written after a newer one that
            # the worker already dequeued/committed (the written-seq
            # watermark): snapshots are full-state, so newer subsumes older.
            if snapshot["seq"] > self._written_seq and (
                self._save_queue is None or snapshot["seq"] > self._save_queue["seq"]
            ):
                self._save_queue = snapshot
            self._save_cv.notify_all()
            if wait:
                self._save_cv.wait_for(lambda: self._save_queue is None and not self._save_inflight)

    def _save_worker(self):
        # type: () -> None
        while True:
            with self._save_cv:
                self._save_cv.wait_for(lambda: self._save_queue is not None or self._save_stop)
                if self._save_queue is None:
                    return
                snapshot = self._save_queue
                self._save_queue = None
                if snapshot["seq"] <= self._written_seq:
                    self._save_cv.notify_all()
                    continue
                self._save_inflight = True
            try:
                self._write_snapshot(snapshot)
                with self._save_cv:
                    self._written_seq = max(self._written_seq, snapshot["seq"])
                with self._lock:
                    if snapshot.get("sealed_files"):
                        self._unconfirmed_seals.difference_update(snapshot["sealed_files"])
                    self._pending_deletes.difference_update(snapshot.get("delete_after", ()))
            except Exception:
                # The one place a failed write is survived: the next save
                # re-emits every sealed file and the index counts as dirty.
                logger.exception(f"background save failed for {self.path}")
                with self._lock:
                    self._resave_all = True
                    self.dirty += 1  # state on disk is stale again
            finally:
                with self._save_cv:
                    self._save_inflight = False
                    self._save_cv.notify_all()

    def _write_snapshot(self, snapshot):
        # type: (dict) -> None
        self.path.mkdir(parents=True, exist_ok=True)
        for seg, keys, codes, nlanes in snapshot["writes"]:
            payload = _npz_bytes(keys=keys, codes=codes, nlanes=nlanes)
            _atomic_write(self.path / seg["file"], payload, sync_dir=False)
        _atomic_write(self.path / snapshot["valid_file"], _npz_bytes(valid=snapshot["valid"]), sync_dir=False)
        # ONE directory fsync makes all the data renames above durable
        # BEFORE the manifest rename can be (ordering is all that matters;
        # per-file dir fsyncs would pay N+2 disk barriers for the same
        # guarantee).
        _fsync_dir(self.path)
        # The manifest rename is the commit point: every file above has a
        # fresh name, so a crash anywhere before this line leaves the OLD
        # manifest with all of ITS files intact.
        _atomic_write(self.path / "state.json", json.dumps(snapshot["state"]).encode())
        # Only now are the superseded files unreferenced by the on-disk state.
        for name in snapshot.get("delete_after", ()):
            try:
                (self.path / name).unlink()
            except OSError:
                pass

    def compact(self):
        # type: () -> None
        """Drop tombstoned rows and rewrite all segments on next save."""
        with self._lock:
            self._compact_locked()

    def reset(self):
        # type: () -> None
        """Release in-memory and device resources (files untouched)."""
        with self._lock:
            cap = _MIN_DEVICE_ROWS
            self._keys = np.zeros((cap, self.key_bytes), dtype=np.uint8)
            self._codes = np.zeros((cap, self.max_lanes), dtype=np.uint32)
            self._nlanes = np.zeros((cap,), dtype=np.int32)
            self._valid = np.zeros((cap,), dtype=bool)
            self._rows = 0
            self._row_gen = next(_ROW_GEN_COUNTER)
            self._key_to_row = {}
            self._live = 0
            self._segments = []
            self._unconfirmed_seals = set()
            self._partitions = None
            self._device_stale = True
            self._synced_rows = 0
            self._valid_dirty = False
            self.dirty = 0

    def drain_rotations(self):
        # type: () -> None
        """Block until every queued/in-flight background save is on disk."""
        with self._save_cv:
            self._save_cv.wait_for(lambda: self._save_queue is None and not self._save_inflight)

    def close(self):
        # type: () -> None
        """Drain background saves, save if dirty, release device memory. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.drain_rotations()
        # Read dirty only AFTER the drain: a background write that failed
        # during the drain re-marks the index dirty (_resave_all), and that
        # state must not be lost at shutdown.
        with self._lock:
            dirty = self.dirty
        if dirty:
            self.save(wait=True)
        with self._save_cv:
            self._save_stop = True
            self._save_cv.notify_all()
        if self._save_thread is not None:
            self._save_thread.join(timeout=60)
        with self._lock:
            self._partitions = None
            self._synced_rows = 0
            self._device_stale = True

    # -- internals ----------------------------------------------------------------

    def _search_impl(self, query_bodies, count, return_rows=False):
        # type: (list[bytes], int, bool) -> list[tuple]
        # Spans (iscc_search_tpu_torch.tracing): "search" and, one after the
        # other, its children prepare and launch here, wait and merge in
        # _collect_results; on a mesh, mesh.scan and mesh.merge under launch.
        # The launch counts "fused_scans", the scans (a mesh: shard scans)
        # whose phases 2-3 take one launch, where there are any.
        root = tracing.start("search")
        try:
            with self._lock:
                synced = self._sync_device()
                # A consistent (buffers, validity, row_map) triple per partition:
                # a concurrent sync rebinds validity and appends rows past count.
                partitions = {
                    lanes: (p.packed_dev, p.valid_dev, p.unpacked_dev, p.row_map, p.cap)
                    for lanes, p in synced.items()
                }
                keys_snapshot = self._keys[: self._rows]

            q_codes, q_lanes = pack_codes([self._vector_bytes(b) for b in query_bodies], self.max_lanes)
            q_codes_dev = _to_device(q_codes, self.device)
            q_lanes_dev = _to_device(q_lanes, self.device)
            launch = None
            if root is not None:
                t = time.perf_counter_ns()
                tracing.add("search.prepare", root.t0, t)
                # Open, so that the mesh's spans (parallel/merge.py) nest under it.
                launch = tracing.start("search.launch", t)
            pending = []
            fused = 0
            try:
                for lanes in sorted(partitions):
                    packed_dev, valid_dev, unpacked_dev, row_map, cap = partitions[lanes]
                    if self.mesh is None:
                        scores, rows = blockmax_topk_packedq_impl(q_codes_dev, q_lanes_dev, packed_dev, valid_dev,
                                                                  _scan_k(cap, count), lanes * 32,
                                                                  phase1=self._phase1(len(query_bodies), lanes))
                    else:
                        scores, rows = self._mesh_scan(q_codes_dev, q_lanes_dev, packed_dev, valid_dev,
                                                       unpacked_dev, cap, lanes, count)
                    pending.append((row_map, scores, rows))
                    if launch is not None:
                        fused += self._fused_scans(packed_dev, cap, count)
            finally:
                if launch is not None:
                    tracing.stop(launch, counts={"fused_scans": fused} if fused else None)
            return self._collect_results(pending, len(query_bodies), count, keys_snapshot, return_rows, root)
        finally:
            if root is not None:
                tracing.stop(root, counts={"queries": len(query_bodies)})

    def _fused_scans(self, packed, cap, count):
        # type: (torch.Tensor | list[torch.Tensor], int, int) -> int
        """How many of one partition's scans for ``count`` results take
        the fused phases 2-3 (``hopper_scan.scan_route``): its one scan, or
        on a mesh each of this process's shard scans."""
        if self.mesh is None:
            return int(hopper_scan.scan_route(packed.device, _scan_k(cap, count), cap) == "fused")
        k = _scan_k(cap // self.mesh.size, count)
        return sum(hopper_scan.scan_route(shard.device, k, shard.shape[0]) == "fused" for shard in packed)

    def _phase1(self, nq, lanes):
        # type: (int, int) -> str
        """The phase-1 kernel of a kernel route: :func:`auto_phase1`'s under
        "auto", "pallas" and "xla", else the one ``scan_kernel`` forces."""
        return auto_phase1(nq, lanes) if self.scan_kernel in ("auto", "pallas", "xla") else self.scan_kernel

    def _mesh_scan(self, q_codes, q_lanes, packed_shards, valid_shards, unpacked_shards, cap, lanes, count):
        # type: (...) -> tuple[torch.Tensor, torch.Tensor]
        """One partition's search on the mesh, merged on the lead device
        (across processes too): ``sharded_pallas_topk`` where the partition
        has its twin ("pallas"), else the kernel route per shard
        (:meth:`_sharded_scan`). Both merge at ``merge_k =
        min(pow2(count), k * n_shards)``: a count above the per-shard ``k``
        would otherwise drop rows that exist across shards."""
        k = _scan_k(cap // self.mesh.size, count)
        if unpacked_shards is not None:
            nbits = lanes * 32
            min_lanes, q_scale = query_prefix(q_lanes, nbits)
            merge_k = min(_pow2ceil(max(1, count)), k * self.mesh.size)
            return sharded_pallas_topk(self.mesh, q_codes, min_lanes, q_scale, packed_shards, unpacked_shards,
                                       valid_shards, k, nbits, merge_k=merge_k)
        return self._sharded_scan(q_codes, q_lanes, packed_shards, valid_shards, k, lanes, count,
                                  self._phase1(q_codes.shape[0], lanes))

    def _sharded_scan(self, q_codes, q_lanes, packed_shards, valid_shards, k, lanes, count, phase1):
        # type: (...) -> tuple[torch.Tensor, torch.Tensor]
        """The kernel route on the mesh: the single-device scan on each of
        this process's shards (on its device), rows lifted to the
        partition's global rows, then the merge (across processes too)."""
        parts = scan_shards(self.mesh, packed_shards[0].shape[0], lambda i, d: blockmax_topk_packedq_impl(
            q_codes.to(d), q_lanes.to(d), packed_shards[i], valid_shards[i], k, lanes * 32, phase1=phase1))
        merge_k = min(_pow2ceil(max(1, count)), k * self.mesh.size)
        return merge_shards(self.mesh, parts, packed_shards[0].shape[0], merge_k)

    def _collect_results(self, pending, nq, count, keys_snapshot, return_rows, span=None):
        # type: (list, int, int, np.ndarray, bool, tracing.Span | None) -> list[tuple]
        """Read back every partition's (scores, rows), map device rows to
        global rows, and merge the per-query candidates on the host (the
        spans ``search.wait`` and ``search.merge`` under ``span``)."""
        t0 = time.perf_counter_ns() if span is not None else 0
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
        if span is not None:
            t1 = time.perf_counter_ns()
            tracing.add("search.wait", t0, t1)

        # One merge for the whole (nq, columns) block: the partitions side by
        # side in pending's order, then one stable sort per row. Invalid
        # slots (row -1) sort last, and equal scores keep the order partition
        # by partition, column by column, so each query's first
        # min(count, valid) columns are the per-query merge's answer.
        idx = [i.numpy() for _, _, i in host]
        valid = np.concatenate([i >= 0 for i in idx], axis=1)
        rows = np.concatenate([rm.take(np.maximum(i, 0)) for (rm, _, _), i in zip(host, idx)], axis=1)
        scores = np.concatenate([s.numpy() for _, s, _ in host], axis=1)
        order = np.argsort(np.where(valid, -scores, np.inf), axis=1, kind="stable")[:, :count]
        # Every gather is a take() of flat positions: take_along_axis, or a
        # 2-D fancy index such as keys_snapshot[rows], is several times slower
        # (five to ten times for 16-byte keys).
        pick = order + np.arange(nq)[:, None] * valid.shape[1]
        scores = scores.take(pick).astype(np.float32, copy=False)
        rows = rows.take(pick)
        keys = keys_snapshot.take(rows.ravel(), axis=0).reshape(*rows.shape, keys_snapshot.shape[1])
        n_valid = np.count_nonzero(valid, axis=1)
        m = np.minimum(n_valid, count).tolist()
        if return_rows:
            results = [(keys[q, :n], scores[q, :n], rows[q, :n]) for q, n in enumerate(m)]
        else:
            results = [(keys[q, :n], scores[q, :n]) for q, n in enumerate(m)]
        # The readback buffers and the merge's temporaries are freed here,
        # inside its span, and not at the return.
        del host, idx, valid, order, pick
        if span is not None:
            tracing.add("search.merge", t1, time.perf_counter_ns(), {"candidates": int(n_valid.sum())})
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

    def _compact_locked(self):
        # type: () -> None
        live = np.flatnonzero(self._valid[: self._rows])
        n = len(live)
        cap = max(_MIN_DEVICE_ROWS, _pow2ceil(max(1, n)))
        keys = np.zeros((cap, self.key_bytes), dtype=np.uint8)
        codes = np.zeros((cap, self.max_lanes), dtype=np.uint32)
        nlanes = np.zeros((cap,), dtype=np.int32)
        valid = np.zeros((cap,), dtype=bool)
        keys[:n] = self._keys[live]
        codes[:n] = self._codes[live]
        nlanes[:n] = self._nlanes[live]
        valid[:n] = True
        self._keys, self._codes, self._nlanes, self._valid = keys, codes, nlanes, valid
        self._rows = n
        self._row_gen = next(_ROW_GEN_COUNTER)  # live rows renumbered
        self._key_to_row = {self._keys[i].tobytes(): i for i in range(n)}
        self._live = n
        # All previously sealed segments are invalidated by the rewrite, but
        # the committed manifest still references them, so deletion must
        # wait until a NEW manifest lands (a crash before that must reload
        # the old, pre-compaction state intact).
        for seg in self._segments:
            self._pending_deletes.add(seg["file"])
        self._segments = []
        self._unconfirmed_seals = set()
        self._partitions = None  # row space rewritten: full device rebuild
        self._synced_rows = 0
        self._valid_dirty = False
        self._device_stale = True
        self.dirty += 1  # force persistence of the rewritten layout

    def _load(self):
        # type: () -> None
        state = json.loads((self.path / "state.json").read_text())
        if state.get("key_bytes") != self.key_bytes:
            raise ValueError(
                f"index at {self.path} has key_bytes={state.get('key_bytes')}, expected {self.key_bytes}"
            )
        self.max_dim = state["max_dim"]
        self.ndim = state.get("ndim")
        rows = state["rows"]
        self._save_seq = state.get("save_seq", 0)
        self._file_seq = state.get("file_seq", 0)
        active_name = state["active"]["file"]
        self._ensure_capacity(max(rows, 1))
        pos = 0
        self._segments = []
        for seg in state["segments"] + [state["active"]]:
            f = self.path / seg["file"]
            if not f.exists():
                # The manifest is written last, so a crash cannot leave it
                # ahead of its files; a file deleted afterwards is tolerated
                # by truncating the load at the gap.
                break
            with np.load(f) as z:
                n = z["keys"].shape[0]
                self._keys[pos : pos + n] = z["keys"]
                self._codes[pos : pos + n] = z["codes"]
                self._nlanes[pos : pos + n] = z["nlanes"]
            if seg["file"] != active_name:
                self._segments.append(seg)
            pos += n
        self._rows = pos
        self._row_gen = next(_ROW_GEN_COUNTER)  # row space rebuilt from disk
        # Versioned valid file (legacy stores used a fixed "valid.npy")
        valid_f = self.path / state.get("valid_file", "valid.npy")
        if valid_f.exists():
            with np.load(valid_f) as z:
                v = z["valid"]
                self._valid[: min(len(v), pos)] = v[: min(len(v), pos)]
        else:
            self._valid[:pos] = True
        # The key map is rebuilt lazily (first mutation/get, see _keymap). The
        # persisted validity bitmap already says which rows were superseded, so the live
        # count is just its popcount.
        self._key_to_row = None
        self._live = int(np.count_nonzero(self._valid[:pos]))
        self._partitions = None
        self._synced_rows = 0
        self._valid_dirty = False
        self._device_stale = True
        self._gc_unreferenced(state)

    def _gc_unreferenced(self, state):
        # type: (dict) -> None
        """Delete data files the committed manifest does not reference.

        A crash after the manifest rename but before the worker's deferred
        deletions leaves superseded files (and *.tmp residue) behind; they
        are garbage and reclaimed here. SEQUENCE GUARD: only files whose
        parsed sequence is <= the committed counters are deleted; files
        with a HIGHER sequence belong to another live instance's in-flight
        save (a probe opening the directory mid-save must not delete the
        writer's fresh data before its manifest commits)."""
        referenced = {seg["file"] for seg in state["segments"]}
        referenced.add(state["active"]["file"])
        referenced.add(state.get("valid_file", "valid.npy"))
        save_seq = state.get("save_seq", 0)
        file_seq = state.get("file_seq", 0)

        def committed_seq(name):
            # "active-00000007.npz" -> (7, save counter); "seg-00000003.npz"
            # -> (3, file counter); unparseable -> None (never deleted here)
            stem = name.split(".", 1)[0]
            prefix, _, digits = stem.partition("-")
            if not digits.isdigit():
                return None
            n = int(digits)
            if prefix in ("active", "valid"):
                return n <= save_seq
            if prefix == "seg" and len(digits) == 8:
                return n <= file_seq
            return None

        for f in self.path.iterdir():
            name = f.name
            if name in referenced or not f.is_file():
                continue
            if name.endswith(".tmp"):
                # Crash residue from _atomic_write. Data-file tmps are
                # seq-guarded via their target-name prefix (an in-flight
                # writer's files carry a higher seq); manifest tmps
                # (state.jsonXXX.tmp) are always safe to reclaim: deleting
                # an in-flight one merely fails that save, which retries.
                if committed_seq(name) is True or name.startswith("state.json"):
                    try:
                        f.unlink()
                    except OSError:
                        pass
                continue
            if name.endswith(".npz") and committed_seq(name) is True:
                try:
                    f.unlink()
                except OSError:
                    pass

    def _sync_device(self):
        # type: () -> dict[int, _Partition]
        """
        Mirror the host arrays on the device as per-length partitions: a full
        build on first use, afterwards only the rows appended since the last
        sync (a partition whose capacity overflows is rebuilt alone) and,
        after tombstoning, fresh validity tensors. With a mesh every sync
        rebuilds in full: an append would fill only the last shard's rows
        and break the equal blocks.
        """
        if not self._device_stale and self._partitions is not None:
            return self._partitions

        rows = self._rows
        try:
            if self._partitions is None or self.mesh is not None:
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
        """Upload one partition from scratch: capacity per _cap_rows, or
        with a mesh a power of two per shard (equal shard blocks), each
        process uploading only its own row block."""
        n = len(row_map)
        if self.mesh is not None:
            n_shards = self.mesh.size
            cap = max(_MIN_DEVICE_ROWS, _pow2ceil(-(-n // n_shards))) * n_shards
        else:
            cap = _cap_rows(n)
        packed = np.zeros((cap, lanes), np.uint32)
        packed[:n] = self._codes[row_map, :lanes]
        valid = np.zeros((cap,), bool)
        valid[:n] = self._valid[row_map]
        full_map = np.zeros((cap,), np.int32)
        full_map[:n] = row_map
        if self.mesh is not None:
            packed_dev, valid_dev = shard_pm1_database(self.mesh, packed, valid)
            # The twin shards row-wise too, so the budget holds per shard; one
            # unpermuted twin (the JAX engine builds a permuted one, and a plain
            # one where twice the bytes fit). The JAX engine's _use_pallas also
            # turns the twins on under "auto" on a TPU; the port's "auto" keeps
            # its kernel routes.
            unpacked_dev = None
            if self.scan_kernel == "pallas" and cap // self.mesh.size * lanes * 32 <= _unpacked_budget_bytes():
                unpacked_dev = shard_unpacked_db(self.mesh, packed_dev, lanes * 32)
            return _Partition(packed_dev, valid_dev, full_map, cap, n, unpacked_dev=unpacked_dev)
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


class DeviceHammingIndex(PackedCodeIndex):
    """
    Fixed-width Hamming index over 16-byte composite keys
    (iscc_id_body(8) + offset(4) + size(4)), the simprint engine's store
    (port of the JAX engine's ``DeviceHammingIndex``).

    Every row has ``ndim`` bits, so the NPHD score of the shared search is
    the Hamming similarity ``1 - hamming / ndim``: the same phase-1 kernels
    and ``gather_rescore`` serve it, one partition of ``ndim / 32`` lanes.
    """

    metric = "hamming"
    key_bytes = 16

    def __init__(self, path, ndim=128, shard_size=512 * 1024 * 1024, scan_kernel="auto", device="cuda"):
        # type: (str | Path | None, int, int, str, str | torch.device) -> None
        super().__init__(path, max_dim=ndim, shard_size=shard_size, ndim=ndim, scan_kernel=scan_kernel, device=device)
