"""
In-memory index backend — testing/development stand-in.

Protocol parity with the reference memory backend (indexes/memory/index.py):
dict storage, exact iscc_code matching only (score 1.0, all queried unit
types 1.0), no persistence.
"""

from __future__ import annotations

import threading

from iscc_search_tpu_torch.indexes import common
from iscc_search_tpu_torch.schema import (
    IsccAddResult,
    IsccGlobalMatch,
    IsccIndex,
    IsccQuery,
    IsccSearchResult,
    Status,
)


class MemoryIndex:
    """Dict-of-dicts index implementing IsccIndexProtocol."""

    def __init__(self):
        # type: () -> None
        self._indexes = {}  # type: dict[str, dict]
        # The threaded WSGI server calls this backend from many threads;
        # iterating a dict another thread mutates raises RuntimeError.
        self._lock = threading.RLock()

    def list_indexes(self):
        # type: () -> list[IsccIndex]
        with self._lock:
            return [
                IsccIndex(name=name, assets=len(data["assets"]), size=0)
                for name, data in self._indexes.items()
            ]

    def create_index(self, index):
        # type: (IsccIndex) -> IsccIndex
        common.validate_index_name(index.name)
        with self._lock:
            if index.name in self._indexes:
                raise FileExistsError(f"Index '{index.name}' already exists")
            self._indexes[index.name] = {"assets": {}}
            return IsccIndex(name=index.name, assets=0, size=0)

    def get_index(self, name):
        # type: (str) -> IsccIndex
        with self._lock:
            if name not in self._indexes:
                raise FileNotFoundError(f"Index '{name}' not found")
            return IsccIndex(name=name, assets=len(self._indexes[name]["assets"]), size=0)

    def delete_index(self, name):
        # type: (str) -> None
        with self._lock:
            if name not in self._indexes:
                raise FileNotFoundError(f"Index '{name}' not found")
            del self._indexes[name]

    def add_assets(self, index_name, assets):
        # type: (str, list) -> list[IsccAddResult]
        # All-or-nothing like the persistent backends: validate the whole
        # batch BEFORE mutating, so a bad asset mid-batch commits nothing.
        for asset in assets:
            if asset.iscc_id is None:
                raise ValueError("Asset must have iscc_id field when adding to index")
        with self._lock:
            if index_name not in self._indexes:
                raise FileNotFoundError(f"Index '{index_name}' not found")
            store = self._indexes[index_name]["assets"]
            results = []
            for asset in assets:
                status = Status.updated if asset.iscc_id in store else Status.created
                store[asset.iscc_id] = asset
                results.append(IsccAddResult(iscc_id=asset.iscc_id, status=status))
            return results

    def get_asset(self, index_name, iscc_id):
        # type: (str, str) -> ...
        with self._lock:
            if index_name not in self._indexes:
                raise FileNotFoundError(f"Index '{index_name}' not found")
            store = self._indexes[index_name]["assets"]
            if iscc_id not in store:
                raise FileNotFoundError(f"Asset '{iscc_id}' not found in index '{index_name}'")
            return store[iscc_id]

    def search_assets(self, index_name, query, limit=100):
        # type: (str, IsccQuery, int) -> IsccSearchResult
        with self._lock:  # a concurrent delete must 404, not KeyError->500
            if index_name not in self._indexes:
                raise FileNotFoundError(f"Index '{index_name}' not found")

        query, query_iscc_id = common.expand_iscc_id_query(
            query, lambda i: self.get_asset(index_name, i)
        )
        query = common.normalize_query(query)

        match_types = {common.get_unit_type(u): 1.0 for u in query.units or []}
        matches = []
        with self._lock:
            data = self._indexes.get(index_name)
            if data is None:  # deleted while the query was being expanded
                raise FileNotFoundError(f"Index '{index_name}' not found")
            assets_snapshot = list(data["assets"].values())
        for asset in assets_snapshot:
            if query.iscc_code and asset.iscc_code and asset.iscc_code == query.iscc_code:
                matches.append(
                    IsccGlobalMatch(iscc_id=asset.iscc_id, score=1.0, types=match_types, metadata=asset.metadata)
                )
        if query_iscc_id:
            matches = [m for m in matches if m.iscc_id != query_iscc_id]
        return IsccSearchResult(query=query, global_matches=matches[:limit], chunk_matches=[])

    def close(self):
        # type: () -> None
        """No-op (no external resources)."""
