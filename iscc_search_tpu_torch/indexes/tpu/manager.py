"""
The multi-index manager over :class:`TpuIndex` (port of
``iscc_search_tpu/indexes/tpu/manager.py``; the code is the JAX package's but
for the ``device`` argument). ``open_index`` and ``follow_index`` are the
multi-host entries: the coordinator opens the served index before it
serves, each follower runs its follower loop.

Directory-per-index layout with a lock-guarded instance cache and
per-component size accounting, functional twin of the reference's
UsearchIndexManager (indexes/usearch/manager.py). Single-writer-process
constraint carries over: device buffers and segment files have no
multi-process coordination.
"""

from __future__ import annotations

import shutil
import threading
from pathlib import Path
from typing import TYPE_CHECKING

from iscc_search_tpu_torch.engine.device_index import resolve_device
from iscc_search_tpu_torch.indexes import common
from iscc_search_tpu_torch.indexes.tpu.index import TpuIndex
from iscc_search_tpu_torch.schema import IsccIndex
from iscc_search_tpu_torch.utils import get_logger

if TYPE_CHECKING:  # pragma: no cover
    from iscc_search_tpu_torch.schema import IsccAddResult, IsccEntry, IsccQuery, IsccSearchResult  # noqa: F401

logger = get_logger(__name__)


class TpuIndexManager:
    """Protocol implementation managing multiple device-scan indexes."""

    def __init__(self, base_path, max_dim=256, device="cuda"):
        # type: (str | Path, int, str) -> None
        """
        :param device: torch device of every index's engines, "cuda" by default
        """
        self.device = resolve_device(device)
        self.base_path = Path(base_path)
        self.base_path.mkdir(parents=True, exist_ok=True)
        self.max_dim = max_dim
        self._index_cache = {}  # type: dict[str, TpuIndex]
        self._cache_lock = threading.Lock()

    def list_indexes(self):
        # type: () -> list[IsccIndex]
        indexes = []
        for index_dir in self.base_path.iterdir():
            if not index_dir.is_dir() or not (index_dir / "store").exists():
                continue
            name = index_dir.name
            try:
                idx = self._get_or_load_index(name)
                size_mb, sizes_mb = self._get_index_sizes_mb(index_dir, idx)
                indexes.append(IsccIndex(name=name, assets=len(idx), size=size_mb, sizes=sizes_mb))
            except Exception as e:
                logger.warning(f"Failed to load index '{name}': {type(e).__name__}: {e}")
                continue
        indexes.sort(key=lambda x: x.name)
        return indexes

    def create_index(self, index):
        # type: (IsccIndex) -> IsccIndex
        common.validate_index_name(index.name)
        index_path = self.base_path / index.name
        # Existence check and cache insert under the lock: two concurrent
        # creates of the same name must not both construct an instance.
        with self._cache_lock:
            if index_path.exists():
                raise FileExistsError(f"Index '{index.name}' already exists")
            idx = TpuIndex(index_path, realm_id=None, max_dim=self.max_dim, device=self.device)
            self._index_cache[index.name] = idx
        return IsccIndex(name=index.name, assets=0, size=0)

    def get_index(self, name):
        # type: (str) -> IsccIndex
        self._validate_index_exists(name)
        idx = self._get_or_load_index(name)
        size_mb, sizes_mb = self._get_index_sizes_mb(self.base_path / name, idx)
        return IsccIndex(name=name, assets=len(idx), size=size_mb, sizes=sizes_mb)

    def delete_index(self, name):
        # type: (str) -> None
        self._validate_index_exists(name)
        with self._cache_lock:
            if name in self._index_cache:
                self._index_cache[name].close()
                del self._index_cache[name]
        shutil.rmtree(self.base_path / name)

    def add_assets(self, index_name, assets):
        # type: (str, list[IsccEntry]) -> list[IsccAddResult]
        self._validate_index_exists(index_name)
        return self._get_or_load_index(index_name).add_assets(assets)

    def get_asset(self, index_name, iscc_id):
        # type: (str, str) -> IsccEntry
        self._validate_index_exists(index_name)
        return self._get_or_load_index(index_name).get_asset(iscc_id)

    def search_assets(self, index_name, query, limit=100):
        # type: (str, IsccQuery, int) -> IsccSearchResult
        self._validate_index_exists(index_name)
        return self._get_or_load_index(index_name).search_assets(query, limit)

    def sync(self, index_name):
        # type: (str) -> None
        """
        Durability barrier: fdatasync the index's host store log.

        Used by the aggregator before persisting an advanced poll cursor —
        the cursor must never claim records that only reached the OS page
        cache (add_assets flushes but does not fsync per batch).
        """
        self._validate_index_exists(index_name)
        self._get_or_load_index(index_name).store.sync()

    def rebuild(self, name, unit_types=None, simprint_types=None):
        # type: (str, list[str] | None, list[str] | None) -> dict
        """Rebuild derived indexes (None = all tracked types of that kind)."""
        self._validate_index_exists(name)
        idx = self._get_or_load_index(name)
        if unit_types is None:
            unit_types = idx.tracked_unit_types
        if simprint_types is None:
            simprint_types = idx.tracked_simprint_types
        return idx.rebuild(unit_types, simprint_types)

    def follow_index(self, name):
        # type: (str) -> None
        """
        Multi-host follower entry: open index ``name`` (creating an empty
        replica directory when absent — a fresh cluster starts empty on every
        process) and run its follower loop until the coordinator stops.
        """
        common.validate_index_name(name)
        self._get_or_load_index(name).follow()

    def open_index(self, name):
        # type: (str) -> TpuIndex
        """Eagerly load (or create) index ``name``.

        The multi-host coordinator calls this at serve startup: follower
        processes connect to the control plane during TpuIndex construction,
        so the coordinator must construct BEFORE traffic arrives, not lazily
        on the first request."""
        common.validate_index_name(name)
        return self._get_or_load_index(name)

    def close(self):
        # type: () -> None
        for name, idx in list(self._index_cache.items()):
            try:
                idx.close()
            except Exception:  # pragma: no cover
                logger.exception(f"Failed to close index '{name}'")
        self._index_cache = {}

    # -- helpers --------------------------------------------------------------

    def _get_or_load_index(self, name):
        # type: (str) -> TpuIndex
        if name in self._index_cache:
            return self._index_cache[name]
        with self._cache_lock:
            if name in self._index_cache:  # pragma: no cover - race guard
                return self._index_cache[name]
            idx = TpuIndex(self.base_path / name, max_dim=self.max_dim, device=self.device)
            self._index_cache[name] = idx
            return idx

    def _validate_index_exists(self, name):
        # type: (str) -> None
        # Pattern check BEFORE any filesystem access so crafted names
        # (e.g. "..") can never address paths outside the base directory.
        common.validate_index_name(name)
        # A loaded index IS proof of existence: the stat() otherwise costs
        # ~80 us on every search/get (measured on the serving hot path).
        # delete_index drops the cache entry, so staleness only arises from
        # out-of-band directory removal — which the next store access
        # surfaces anyway.
        if name in self._index_cache:
            return
        if not (self.base_path / name / "store").exists():
            raise FileNotFoundError(f"Index '{name}' not found")

    def _get_index_sizes_mb(self, path, idx):
        # type: (Path, TpuIndex) -> tuple[int, dict[str, int]]
        """Total and per-component MB: store payload + derived segment bytes."""
        component_bytes = {"store": idx.store.used_bytes()}
        derived = idx.derived_sizes
        for entry in path.iterdir():
            if entry.is_dir() and entry.name not in derived and entry.name != "store":
                component_bytes[entry.name] = sum(f.stat().st_size for f in entry.rglob("*") if f.is_file())
        component_bytes.update(derived)
        mb = 1024 * 1024
        return sum(component_bytes.values()) // mb, {k: v // mb for k, v in component_bytes.items()}
