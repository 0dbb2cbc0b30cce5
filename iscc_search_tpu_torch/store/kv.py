"""
ctypes binding for the native tructstore (``iscc_search_tpu_torch/native/store.cpp``,
a copy of the JAX package's ``native/store.cpp``).

HostStore is the source-of-truth storage of the index backend: plain and
dupsort sub-databases, prefix range scans, batched dup puts, entry counts,
crash-safe persistence (an append log and a snapshot). The Python side is a
copy of ``iscc_search_tpu/store/kv.py`` (``tests/test_torch_host_copies.py``
compares the bytecode of every function but the build), so a directory
written by either package's store opens in the other.

The build differs: the shared library is compiled with ``g++`` at first use
from the port's own copy of the source into ``build/torch_store/<key>/``
beside the package (git-ignored), keyed by a hash of the source and flags.
Several processes building at first use each compile into a private
temporary directory and publish the library with an atomic rename,
as ``ops/_build.py`` does for the CUDA sources. Nothing is written inside
the package.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parent.parent / "native" / "store.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_store"
LIB_NAME = "libtructstore.so"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")  # the JAX package's Makefile
_BUILD_LOCK = threading.Lock()
_LIB = None


def build_key():
    # type: () -> str
    """Hash of the flags and the source's bytes."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return h.hexdigest()[:16]


def _build_library():
    # type: () -> Path
    """Compile the store with ``g++`` unless a library with the current key
    exists; return its path."""
    out_dir = BUILD_ROOT / build_key()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found on PATH (or $CXX): the host store is built from native/store.cpp")
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=str(out_dir), prefix="tmp") as tmp:
        cmd = [cxx, *CXX_FLAGS, "-o", str(Path(tmp) / LIB_NAME), str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(Path(tmp) / LIB_NAME, lib_path)
    return lib_path


def _load_library():
    # type: () -> ctypes.CDLL
    global _LIB
    if _LIB is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is not None:  # pragma: no cover - race guard
            return _LIB
        lib = ctypes.CDLL(str(_build_library()))

        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ts_open.argtypes = [ctypes.c_char_p]
        lib.ts_open.restype = ctypes.c_void_p
        lib.ts_close.argtypes = [ctypes.c_void_p]
        lib.ts_close.restype = None
        for name in ("ts_put", "ts_dup_put", "ts_dup_del"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, c_u8p, ctypes.c_uint32, c_u8p, ctypes.c_uint32]
            fn.restype = ctypes.c_int
        lib.ts_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p, c_u8p, ctypes.c_uint32]
        lib.ts_del.restype = ctypes.c_int
        lib.ts_drop_db.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ts_drop_db.restype = ctypes.c_int
        lib.ts_dup_putmulti.argtypes = [ctypes.c_void_p, ctypes.c_char_p, c_u8p, ctypes.c_uint64]
        lib.ts_dup_putmulti.restype = ctypes.c_int64
        lib.ts_get.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            c_u8p,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.ts_get.restype = ctypes.c_int
        lib.ts_putmulti.argtypes = [ctypes.c_void_p, ctypes.c_char_p, c_u8p, ctypes.c_uint64]
        lib.ts_putmulti.restype = ctypes.c_int64
        lib.ts_get_many.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            c_u8p,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.ts_get_many.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.ts_range_scan_after.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            c_u8p,
            ctypes.c_uint32,
            c_u8p,
            ctypes.c_uint32,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.ts_range_scan_after.restype = ctypes.POINTER(ctypes.c_uint8)
        for name in ("ts_prefix_scan", "ts_get_dups", "ts_range_scan"):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                c_u8p,
                ctypes.c_uint32,
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
            ]
            fn.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.ts_list_dbs.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.ts_list_dbs.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.ts_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.ts_free.restype = None
        lib.ts_last_error.argtypes = [ctypes.c_void_p]
        lib.ts_last_error.restype = ctypes.c_char_p
        for name in ("ts_entries", "ts_key_count"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            fn.restype = ctypes.c_int64
        lib.ts_used_bytes.argtypes = [ctypes.c_void_p]
        lib.ts_used_bytes.restype = ctypes.c_int64
        for name in ("ts_flush", "ts_sync", "ts_compact"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.ts_log_bytes.argtypes = [ctypes.c_void_p]
        lib.ts_log_bytes.restype = ctypes.c_uint64
        _LIB = lib
        return lib


def _buf(data):
    # type: (bytes) -> ctypes.Array
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else (ctypes.c_uint8 * 1)()


def _parse_pairs(ptr, length):
    # type: (ctypes.POINTER, int) -> list[tuple[bytes, bytes]]
    raw = ctypes.string_at(ptr, length)
    pairs = []
    off = 0
    while off < length:
        (klen,) = struct.unpack_from("<I", raw, off)
        off += 4
        key = raw[off : off + klen]
        off += klen
        (vlen,) = struct.unpack_from("<I", raw, off)
        off += 4
        val = raw[off : off + vlen]
        off += vlen
        pairs.append((key, val))
    return pairs


def _parse_values(ptr, length):
    # type: (ctypes.POINTER, int) -> list[bytes]
    raw = ctypes.string_at(ptr, length)
    vals = []
    off = 0
    while off < length:
        (vlen,) = struct.unpack_from("<I", raw, off)
        off += 4
        vals.append(raw[off : off + vlen])
        off += vlen
    return vals


class HostStore:
    """
    Crash-safe KV store with named plain/dupsort sub-databases.

    Thin Python veneer over the C++ engine; all data structures and the
    append-log/snapshot persistence live in native code.
    """

    # Compact when the log grows beyond this (keeps replay-on-open bounded).
    AUTO_COMPACT_BYTES = 256 * 1024 * 1024

    def __init__(self, path):
        # type: (str | os.PathLike) -> None
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self._lib = _load_library()
        self._h = self._lib.ts_open(str(self.path).encode())
        if not self._h:
            raise OSError(f"failed to open store at {self.path}")
        self._closed = False
        self._inflight = 0
        self._state_cond = threading.Condition()
        self._pin = threading.local()  # per-thread session pin depth
        self._compact_lock = threading.Lock()
        self._compact_thread = None  # type: threading.Thread | None

    @contextlib.contextmanager
    def _use(self):
        """In-flight gate around every native call.

        A bare closed-check would be TOCTOU: a reader could load the handle,
        then close() frees the native Store before the C call runs (ctypes
        releases the GIL), and the freed pointer reaches the library —
        use-after-free. Calls register here; close() refuses to free the
        native store until the in-flight count drains to zero, and new calls
        after close() raise instead of passing NULL.

        A thread holding a session() pin skips the per-call bookkeeping —
        its pin already holds the in-flight count (the gate costs ~30% of
        bulk-ingest throughput when paid per call).
        """
        if getattr(self._pin, "depth", 0):
            # Use the handle captured at session entry: close() nulls _h
            # immediately (to fail NEW callers) but waits for the pinned
            # session to exit before freeing the native store.
            yield self._pin.handle
            return
        with self._state_cond:
            if self._h is None:
                raise RuntimeError(f"HostStore at {self.path} is closed")
            self._inflight += 1
            h = self._h
        try:
            yield h
        finally:
            with self._state_cond:
                self._inflight -= 1
                if self._inflight == 0:
                    self._state_cond.notify_all()

    @contextlib.contextmanager
    def session(self):
        """Pin the store for a burst of calls (one gate acquisition total).

        Used by batch writers (add_assets makes thousands of native calls
        under one logical operation); close() still waits for the session
        to end before freeing the native store.
        """
        with self._use() as h:
            self._pin.depth = getattr(self._pin, "depth", 0) + 1
            self._pin.handle = h
            try:
                yield self
            finally:
                self._pin.depth -= 1

    def _last_error(self):
        # type: () -> str
        try:
            with self._use() as h:  # gate: close() must not free mid-call
                msg = self._lib.ts_last_error(h)
        except RuntimeError:
            return ""
        return msg.decode("utf-8", "replace") if msg else ""

    # -- mutations ----------------------------------------------------------

    def _checked(self, rc):
        # type: (int) -> bool
        """Map the native 1/0/-1 mutation result to True/False/raise.

        The bool-shaped API previously conflated -1-class failures (size
        limits, db-kind mismatch — the write is DROPPED) with benign no-ops
        (missing key, duplicate dup pair); production callers ignore the
        bool, so an oversized value was reported to the client as success
        and silently never persisted."""
        if rc < 0:
            raise ValueError(f"store mutation rejected: {self._last_error() or 'unknown error'}")
        return bool(rc)

    def put(self, db, key, val):
        # type: (str, bytes, bytes) -> bool
        with self._use() as h:
            return self._checked(self._lib.ts_put(h, db.encode(), _buf(key), len(key), _buf(val), len(val)))

    def delete(self, db, key):
        # type: (str, bytes) -> bool
        with self._use() as h:
            return self._checked(self._lib.ts_del(h, db.encode(), _buf(key), len(key)))

    def dup_put(self, db, key, val):
        # type: (str, bytes, bytes) -> bool
        """Insert (key, val) into a dupsort db; duplicate pairs are no-ops."""
        with self._use() as h:
            return self._checked(self._lib.ts_dup_put(h, db.encode(), _buf(key), len(key), _buf(val), len(val)))

    def dup_delete(self, db, key, val):
        # type: (str, bytes, bytes) -> bool
        with self._use() as h:
            return self._checked(self._lib.ts_dup_del(h, db.encode(), _buf(key), len(key), _buf(val), len(val)))

    @staticmethod
    def _encode_pairs(pairs):
        # type: (list[tuple[bytes, bytes]]) -> bytes
        parts = []
        for key, val in pairs:
            parts.append(struct.pack("<I", len(key)))
            parts.append(key)
            parts.append(struct.pack("<I", len(val)))
            parts.append(val)
        return b"".join(parts)

    def dup_putmulti(self, db, pairs):
        # type: (str, list[tuple[bytes, bytes]]) -> int
        """Batched dupsort insert (single native call; C loop)."""
        if not pairs:
            return 0
        blob = self._encode_pairs(pairs)
        with self._use() as h:
            n = self._lib.ts_dup_putmulti(h, db.encode(), _buf(blob), len(blob))
        if n < 0:
            raise ValueError(f"putmulti rejected: {self._last_error() or 'malformed buffer'}")
        return int(n)

    def dup_putmulti_arrays(self, db, keys, vals):
        # type: (str, ..., ...) -> int
        """Batched dupsort insert from FIXED-WIDTH record arrays.

        Bulk-ingest fast path: the wire blob for ``n`` records is built with
        one vectorized numpy fill instead of ``2n`` python bytes objects —
        at BASELINE config-4 scale (100M chunk pointers) the per-object
        churn of :meth:`dup_putmulti` dominates the native insert itself.

        :param keys: (n, key_width) uint8 array
        :param vals: (n, val_width) uint8 array
        """
        keys = np.ascontiguousarray(keys, dtype=np.uint8)
        vals = np.ascontiguousarray(vals, dtype=np.uint8)
        if keys.ndim != 2 or vals.ndim != 2 or keys.shape[0] != vals.shape[0]:
            raise ValueError(f"keys/vals must be (n, w) uint8 with equal n, got {keys.shape}/{vals.shape}")
        n, kw = keys.shape
        vw = vals.shape[1]
        if n == 0:
            return 0
        # Same wire format _encode_pairs emits: <u32 klen><key><u32 vlen><val>
        rec = np.empty((n, 8 + kw + vw), np.uint8)
        rec[:, 0:4] = np.frombuffer(struct.pack("<I", kw), np.uint8)
        rec[:, 4 : 4 + kw] = keys
        rec[:, 4 + kw : 8 + kw] = np.frombuffer(struct.pack("<I", vw), np.uint8)
        rec[:, 8 + kw :] = vals
        blob = rec.tobytes()
        with self._use() as h:
            rc = self._lib.ts_dup_putmulti(h, db.encode(), _buf(blob), len(blob))
        if rc < 0:
            raise ValueError(f"putmulti rejected: {self._last_error() or 'malformed buffer'}")
        return int(rc)

    def putmulti(self, db, pairs):
        # type: (str, list[tuple[bytes, bytes]]) -> int
        """Batched plain put (replace semantics; single native call)."""
        if not pairs:
            return 0
        blob = self._encode_pairs(pairs)
        with self._use() as h:
            n = self._lib.ts_putmulti(h, db.encode(), _buf(blob), len(blob))
        if n < 0:
            raise ValueError(f"putmulti rejected: {self._last_error() or 'malformed buffer'}")
        return int(n)

    def drop_db(self, db):
        # type: (str) -> bool
        with self._use() as h:
            return bool(self._lib.ts_drop_db(h, db.encode()))

    # -- reads ---------------------------------------------------------------

    def get(self, db, key):
        # type: (str, bytes) -> bytes | None
        val_p = ctypes.POINTER(ctypes.c_uint8)()
        vlen = ctypes.c_uint32()
        with self._use() as h:
            ok = self._lib.ts_get(h, db.encode(), _buf(key), len(key), ctypes.byref(val_p), ctypes.byref(vlen))
        if ok < 0:
            # An external-value READ ERROR must never masquerade as key-absent
            raise OSError(f"store read failed: {self._last_error() or 'unknown error'}")
        if not ok:
            return None
        try:
            return ctypes.string_at(val_p, vlen.value)
        finally:
            self._lib.ts_free(val_p)

    _MISSING = 0xFFFFFFFF  # ts_get_many per-key vlen sentinel: key absent

    def get_many(self, db, keys):
        # type: (str, list[bytes]) -> list[bytes | None]
        """Batched plain get: one native call for N equal-width keys.

        Returns one ``bytes | None`` per key, in request order. The serving
        hot path enriches top-k rows through this (one lock acquisition +
        one ctypes crossing instead of N).
        """
        if not keys:
            return []
        width = len(keys[0])
        if any(len(k) != width for k in keys):
            raise ValueError("get_many requires equal-width keys")
        blob = b"".join(keys)
        out_len = ctypes.c_uint64()
        out_count = ctypes.c_uint64()
        with self._use() as h:
            ptr = self._lib.ts_get_many(
                h, db.encode(), _buf(blob), width, len(keys), ctypes.byref(out_len), ctypes.byref(out_count)
            )
        if out_len.value == self._SCAN_ERROR:
            raise OSError(f"store read failed: {self._last_error() or 'unknown error'}")
        if not ptr:
            return [None] * len(keys)
        try:
            raw = ctypes.string_at(ptr, out_len.value)
        finally:
            self._lib.ts_free(ptr)
        vals = []  # type: list[bytes | None]
        off = 0
        for _ in keys:
            (vlen,) = struct.unpack_from("<I", raw, off)
            off += 4
            if vlen == self._MISSING:
                vals.append(None)
                continue
            vals.append(raw[off : off + vlen])
            off += vlen
        return vals

    _SCAN_ERROR = 2**64 - 1  # out_len sentinel: I/O error, not an empty result

    def _scan(self, fn, db, arg, limit):
        out_len = ctypes.c_uint64()
        out_count = ctypes.c_uint64()
        with self._use() as h:
            ptr = fn(h, db.encode(), _buf(arg), len(arg), limit, ctypes.byref(out_len), ctypes.byref(out_count))
        if out_len.value == self._SCAN_ERROR:
            raise OSError(f"store scan failed: {self._last_error() or 'unknown error'}")
        if not ptr or out_len.value == 0:
            return []
        try:
            return _parse_pairs(ptr, out_len.value)
        finally:
            self._lib.ts_free(ptr)

    def prefix_scan(self, db, prefix, limit=0):
        # type: (str, bytes, int) -> list[tuple[bytes, bytes]]
        """All (key, value) pairs with key starting with prefix, key-ordered."""
        return self._scan(self._lib.ts_prefix_scan, db, prefix, limit)

    def range_scan(self, db, start=b"", limit=0):
        # type: (str, bytes, int) -> list[tuple[bytes, bytes]]
        """All (key, value) pairs from start key onward."""
        return self._scan(self._lib.ts_range_scan, db, start, limit)

    def range_scan_after(self, db, after_key, after_val, limit=0):
        # type: (str, bytes, bytes, int) -> list[tuple[bytes, bytes]]
        """(key, value) pairs strictly after (after_key, after_val)."""
        out_len = ctypes.c_uint64()
        out_count = ctypes.c_uint64()
        with self._use() as h:
            ptr = self._lib.ts_range_scan_after(
                h,
                db.encode(),
                _buf(after_key),
                len(after_key),
                _buf(after_val),
                len(after_val),
                limit,
                ctypes.byref(out_len),
                ctypes.byref(out_count),
            )
        if out_len.value == self._SCAN_ERROR:
            raise OSError(f"store scan failed: {self._last_error() or 'unknown error'}")
        if not ptr or out_len.value == 0:
            return []
        try:
            return _parse_pairs(ptr, out_len.value)
        finally:
            self._lib.ts_free(ptr)

    def iter_range(self, db, start=b"", batch=8192):
        # type: (str, bytes, int) -> ...
        """
        Stream (key, value) pairs in bounded pages.

        Unlike ``range_scan`` (which serializes the WHOLE database into one
        buffer — an OOM hazard at 100M-chunk simprint scale), this holds at
        most ``batch`` pairs at a time. Page continuation is exclusive on the
        full (key, value) pair, so dupsort runs that straddle a page boundary
        neither repeat nor skip.
        """
        page = self.range_scan(db, start=start, limit=batch)
        while page:
            yield from page
            if len(page) < batch:
                return
            last_key, last_val = page[-1]
            page = self.range_scan_after(db, last_key, last_val, limit=batch)

    def get_dups(self, db, key, limit=0):
        # type: (str, bytes, int) -> list[bytes]
        """All dupsort values for an exact key (sorted)."""
        out_len = ctypes.c_uint64()
        out_count = ctypes.c_uint64()
        with self._use() as h:
            ptr = self._lib.ts_get_dups(
                h, db.encode(), _buf(key), len(key), limit, ctypes.byref(out_len), ctypes.byref(out_count)
            )
        if out_len.value == self._SCAN_ERROR:
            raise OSError(f"store scan failed: {self._last_error() or 'unknown error'}")
        if not ptr or out_len.value == 0:
            return []
        try:
            return _parse_values(ptr, out_len.value)
        finally:
            self._lib.ts_free(ptr)

    def entries(self, db):
        # type: (str) -> int
        """Entry count (dup pairs counted individually, like LMDB stat)."""
        with self._use() as h:
            return int(self._lib.ts_entries(h, db.encode()))

    def key_count(self, db):
        # type: (str) -> int
        with self._use() as h:
            return int(self._lib.ts_key_count(h, db.encode()))

    def list_dbs(self):
        # type: () -> list[str]
        out_len = ctypes.c_uint64()
        out_count = ctypes.c_uint64()
        with self._use() as h:
            ptr = self._lib.ts_list_dbs(h, ctypes.byref(out_len), ctypes.byref(out_count))
        if not ptr or out_len.value == 0:
            return []
        try:
            return [v.decode() for v in _parse_values(ptr, out_len.value)]
        finally:
            self._lib.ts_free(ptr)

    def used_bytes(self):
        # type: () -> int
        """Approximate live payload bytes (disk-usage reporting parity)."""
        with self._use() as h:
            return int(self._lib.ts_used_bytes(h))

    # -- durability ----------------------------------------------------------

    def flush(self):
        # type: () -> None
        """Push buffered appends to the OS; auto-compact oversized logs.

        Compaction runs on a BACKGROUND thread: the native ts_compact is
        incremental (log rotation + sliced shared-lock snapshot streaming),
        so concurrent puts/gets see only sub-millisecond lock slices instead
        of a full-store pause (a 1M-asset aggregator ingest measured a 15.5s
        stall on the old synchronous path — benchmarks/AGGREGATOR_INGEST.json).
        """
        with self._use() as h:
            ok = self._lib.ts_flush(h)
            log_bytes = self._lib.ts_log_bytes(h)
        if not ok:  # pragma: no cover
            raise OSError(f"store flush failed: {self._last_error() or 'unknown error'}")
        if log_bytes > self.AUTO_COMPACT_BYTES:
            self._compact_in_background()

    def _compact_in_background(self):
        # type: () -> None
        """Start (at most one) background compaction; no-op while one runs."""
        with self._compact_lock:
            if self._compact_thread is not None and self._compact_thread.is_alive():
                return
            thread = threading.Thread(
                target=self._compact_quietly, name=f"compact-{self.path.name}", daemon=True
            )
            self._compact_thread = thread
            thread.start()

    def _compact_quietly(self):
        # type: () -> None
        try:
            self.compact()
        except (RuntimeError, OSError):  # pragma: no cover - store closed / IO error
            # RuntimeError: closed before the thread entered; OSError: the
            # compaction failed and left the rotated state (self-healing on
            # the next compact). Either way the store keeps serving.
            pass

    def sync(self):
        # type: () -> None
        """Flush + fdatasync (durability point)."""
        with self._use() as h:
            ok = self._lib.ts_sync(h)
        if not ok:  # pragma: no cover
            raise OSError(f"store sync failed: {self._last_error() or 'unknown error'}")

    def compact(self):
        # type: () -> None
        """Rewrite the snapshot and truncate the log (atomic via rename)."""
        with self._use() as h:
            ok = self._lib.ts_compact(h)
        if not ok:  # pragma: no cover
            raise OSError(f"store compact failed: {self._last_error() or 'unknown error'}")

    def close(self):
        # type: () -> None
        with self._state_cond:
            if self._closed:
                return
            self._closed = True
            h, self._h = self._h, None  # new calls fail from here on
            # wait_for: the retest-after-wakeup loop lives in threading.py
            # (a hand-written while would add a loop-bottom test copy whose
            # "woken while still in flight" arm needs a spurious wakeup).
            self._state_cond.wait_for(lambda: not self._inflight)
        self._lib.ts_close(h)

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
