"""
KV index manager — one store directory per index (reference parity:
indexes/lmdb/manager.py, one {name}.lmdb file per index with a lock-guarded
instance cache).
"""

from __future__ import annotations

import shutil
import threading
from pathlib import Path

from iscc_search_tpu_torch.indexes import common
from iscc_search_tpu_torch.indexes.kv.index import KvIndex
from iscc_search_tpu_torch.schema import IsccIndex
from iscc_search_tpu_torch.utils import get_logger

logger = get_logger(__name__)


class KvIndexManager:
    """Protocol implementation managing multiple KvIndex stores."""

    def __init__(self, base_path):
        # type: (str | Path) -> None
        self.base_path = Path(base_path)
        self.base_path.mkdir(parents=True, exist_ok=True)
        self._cache = {}  # type: dict[str, KvIndex]
        self._cache_lock = threading.Lock()

    def _index_path(self, name):
        # type: (str) -> Path
        return self.base_path / f"{name}.kv"

    def list_indexes(self):
        # type: () -> list[IsccIndex]
        indexes = []
        for entry in sorted(self.base_path.iterdir()):
            if entry.is_dir() and entry.suffix == ".kv":
                name = entry.stem
                try:
                    idx = self._get_or_load(name)
                    indexes.append(
                        IsccIndex(
                            name=name,
                            assets=idx.get_asset_count(),
                            size=idx.used_bytes() // (1024 * 1024),
                        )
                    )
                except Exception as e:
                    logger.warning(f"Failed to load index '{name}': {e}")
        return indexes

    def create_index(self, index):
        # type: (IsccIndex) -> IsccIndex
        common.validate_index_name(index.name)
        path = self._index_path(index.name)
        # Existence check and cache insert under the lock: two concurrent
        # creates of the same name must not both construct an instance.
        with self._cache_lock:
            if path.exists():
                raise FileExistsError(f"Index '{index.name}' already exists")
            self._cache[index.name] = KvIndex(path)
        return IsccIndex(name=index.name, assets=0, size=0)

    def get_index(self, name):
        # type: (str) -> IsccIndex
        self._validate_exists(name)
        idx = self._get_or_load(name)
        return IsccIndex(name=name, assets=idx.get_asset_count(), size=idx.used_bytes() // (1024 * 1024))

    def delete_index(self, name):
        # type: (str) -> None
        self._validate_exists(name)
        with self._cache_lock:
            if name in self._cache:
                self._cache[name].close()
                del self._cache[name]
        shutil.rmtree(self._index_path(name))

    def add_assets(self, index_name, assets):
        # type: (str, list) -> list
        self._validate_exists(index_name)
        return self._get_or_load(index_name).add_assets(assets)

    def get_asset(self, index_name, iscc_id):
        # type: (str, str) -> ...
        self._validate_exists(index_name)
        return self._get_or_load(index_name).get_asset(iscc_id)

    def search_assets(self, index_name, query, limit=100):
        # type: (str, ..., int) -> ...
        self._validate_exists(index_name)
        return self._get_or_load(index_name).search_assets(query, limit)

    def sync(self, index_name):
        # type: (str) -> None
        """Durability barrier: fdatasync the index's store log (see tpu manager)."""
        self._validate_exists(index_name)
        self._get_or_load(index_name).store.sync()

    def close(self):
        # type: () -> None
        for name, idx in list(self._cache.items()):
            try:
                idx.close()
            except Exception:  # pragma: no cover
                logger.exception(f"Failed to close index '{name}'")
        self._cache = {}

    def _get_or_load(self, name):
        # type: (str) -> KvIndex
        if name in self._cache:
            return self._cache[name]
        with self._cache_lock:
            if name in self._cache:  # pragma: no cover - race guard
                return self._cache[name]
            idx = KvIndex(self._index_path(name))
            self._cache[name] = idx
            return idx

    def _validate_exists(self, name):
        # type: (str) -> None
        # Pattern check first: crafted names must never address paths
        # outside the base directory.
        common.validate_index_name(name)
        if not self._index_path(name).exists():
            raise FileNotFoundError(f"Index '{name}' not found")
