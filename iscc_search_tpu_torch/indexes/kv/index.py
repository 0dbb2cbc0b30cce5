"""
Host-store index backend — persistent exact/prefix search without a device.

Functional twin of the reference's LMDB backend (indexes/lmdb/index.py):
per-unit-type inverted dupsort maps with **bidirectional prefix matching**
(forward: stored extends query; reverse: stored is a 64/128/192-bit prefix of
the query — lmdb/index.py:447-494) and matched-bits scoring normalized by the
query unit length, averaged over all queried units (lmdb/index.py:255-264).
Storage is the native tructstore instead of LMDB.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

from iscc_search_tpu_torch.indexes import common
from iscc_search_tpu_torch.models import IsccUnit
from iscc_search_tpu_torch.schema import IsccAddResult, IsccGlobalMatch, IsccQuery, IsccSearchResult, Status
from iscc_search_tpu_torch.store import HostStore

DB_ASSETS = "assets"
DB_META = "metadata"


class KvIndex:
    """Single host-store index with inverted unit-type maps."""

    def __init__(self, path):
        # type: (str | Path) -> None
        self.path = Path(path)
        self.store = HostStore(self.path)
        # Serializes writers: add_assets is a multi-op sequence (read
        # existing, delete stale unit rows, put record, put unit rows) and
        # two interleaved updates of the same asset would leave stale unit
        # rows behind — the reference's single LMDB write transaction
        # provided this serialization implicitly.
        self._write_lock = threading.Lock()
        self._realm_id = None  # type: int | None
        raw = self.store.get(DB_META, b"realm_id")
        if raw is not None:
            self._realm_id = int(raw.decode())

    def add_assets(self, assets):
        # type: (list) -> list[IsccAddResult]
        if not assets:
            return []
        # Validate the WHOLE batch before mutating anything, mirroring the
        # reference's all-or-nothing LMDB write transaction (lmdb/index.py:
        # a mid-batch error aborts the txn): a realm mismatch or malformed
        # unit in asset N must not leave assets 0..N-1 — or a half-indexed
        # asset N — committed.
        realm = self._realm_id
        for asset in assets:
            if asset.iscc_id is None:
                raise ValueError("Asset must have iscc_id field when adding to index")
            asset_realm = common.extract_realm_id(asset.iscc_id)
            if realm is None:
                realm = asset_realm
            elif realm != asset_realm:
                raise ValueError(
                    f"Realm ID mismatch: index has realm={realm}, "
                    f"but asset '{asset.iscc_id}' has realm={asset_realm}. "
                    f"All assets in an index must have the same realm ID."
                )
            for unit_str in asset.units or []:
                IsccUnit(unit_str)  # raises on malformed unit strings
            common.extract_iscc_id_body(asset.iscc_id)

        with self._write_lock, self.store.session():
            return self._add_assets_inner(assets, realm)

    def _add_assets_inner(self, assets, realm):
        # type: (list, int | None) -> list
        if self._realm_id is None:
            self._realm_id = realm
            self.store.put(DB_META, b"realm_id", str(realm).encode())
            if self.store.get(DB_META, b"created_at") is None:
                self.store.put(DB_META, b"created_at", str(time.time()).encode())

        results = []
        for asset in assets:
            iscc_id_key = asset.iscc_id.encode("utf-8")
            existing = self.store.get(DB_ASSETS, iscc_id_key)
            status = Status.updated if existing is not None else Status.created
            if existing is not None:
                # Drop unit rows the update no longer carries — a stale body
                # would keep prefix-matching against data the asset no longer
                # claims. (The reference lmdb backend leaves these forever;
                # removing eagerly is strictly more correct.)
                new_units = set(asset.units or [])
                iscc_id_body = common.extract_iscc_id_body(asset.iscc_id)
                for old_unit_str in common.deserialize_asset(existing).units or []:
                    if old_unit_str in new_units:
                        continue
                    old_unit = IsccUnit(old_unit_str)
                    self.store.dup_delete(f"unit:{old_unit.unit_type}", old_unit.body, iscc_id_body)
            self.store.put(DB_ASSETS, iscc_id_key, common.serialize_asset(asset))

            if asset.units:
                iscc_id_body = common.extract_iscc_id_body(asset.iscc_id)
                for unit_str in asset.units:
                    unit = IsccUnit(unit_str)
                    self.store.dup_put(f"unit:{unit.unit_type}", unit.body, iscc_id_body)

            results.append(IsccAddResult(iscc_id=asset.iscc_id, status=status))
        self.store.flush()
        return results

    def get_asset(self, iscc_id):
        # type: (str) -> ...
        common.validate_iscc_id(iscc_id, expected_realm=self._realm_id)
        raw = self.store.get(DB_ASSETS, iscc_id.encode("utf-8"))
        if raw is None:
            raise FileNotFoundError(f"Asset '{iscc_id}' not found")
        return common.deserialize_asset(raw)

    def search_assets(self, query, limit=100):
        # type: (IsccQuery, int) -> IsccSearchResult
        """
        Bidirectional prefix search; per-unit scores = matched_bits /
        query_bits, averaged over all queried units (unmatched contribute 0).
        """
        query, query_iscc_id = common.expand_iscc_id_query(query, self.get_asset)
        query = common.normalize_query(query)

        query_unit_lengths = {}  # type: dict[str, int]
        matches = {}  # type: dict[str, dict[str, int]]

        for unit_str in query.units or []:
            unit = IsccUnit(unit_str)
            unit_type = unit.unit_type
            query_bits = len(unit)
            query_unit_lengths[unit_type] = max(query_unit_lengths.get(unit_type, 0), query_bits)
            for iscc_id, bits in self._search_unit(unit).items():
                matches.setdefault(iscc_id, {})
                matches[iscc_id][unit_type] = max(matches[iscc_id].get(unit_type, 0), bits)

        match_list = []
        num_queried = len(query.units or [])
        for iscc_id, unit_bits in matches.items():
            unit_scores = {t: bits / float(query_unit_lengths[t]) for t, bits in unit_bits.items()}
            # matches only come from the units loop, so num_queried >= 1 here
            total = sum(unit_scores.values()) / num_queried
            metadata = None
            raw = self.store.get(DB_ASSETS, iscc_id.encode("utf-8"))
            if raw is not None:
                metadata = common.deserialize_asset(raw).metadata
            match_list.append(IsccGlobalMatch(iscc_id=iscc_id, score=total, types=unit_scores, metadata=metadata))

        match_list.sort(key=lambda x: x.score, reverse=True)
        if query_iscc_id:
            match_list = [m for m in match_list if m.iscc_id != query_iscc_id]
        return IsccSearchResult(query=query, global_matches=match_list[:limit], chunk_matches=[])

    def _search_unit(self, unit):
        # type: (IsccUnit) -> dict[str, int]
        """Bidirectional prefix matching over one unit-type inverted map."""
        db = f"unit:{unit.unit_type}"
        query_body = unit.body
        query_bits = len(unit)
        found = {}  # type: dict[str, int]

        # Forward: stored units extending the full query body
        for _key, body in self.store.prefix_scan(db, query_body):
            iscc_id = common.reconstruct_iscc_id(body, self._realm_id)
            found[iscc_id] = max(found.get(iscc_id, 0), query_bits)

        # Reverse: stored units that are proper prefixes of the query
        for bit_length in (64, 128, 192):
            if bit_length >= query_bits:
                continue
            prefix = query_body[: bit_length // 8]
            for body in self.store.get_dups(db, prefix):
                iscc_id = common.reconstruct_iscc_id(body, self._realm_id)
                found[iscc_id] = max(found.get(iscc_id, 0), bit_length)
        return found

    def get_asset_count(self):
        # type: () -> int
        return self.store.entries(DB_ASSETS)

    def get_realm_id(self):
        # type: () -> int | None
        return self._realm_id

    def used_bytes(self):
        # type: () -> int
        return self.store.used_bytes()

    def close(self):
        # type: () -> None
        self.store.close()
