"""
The index backend over the port's engines (port of
``iscc_search_tpu/indexes/tpu/index.py``, the flagship backend; module path
and class name kept so a reader finds the counterpart). The code is the JAX
package's but for the ``device`` argument and the cluster it reads: the
``torch.distributed`` world (:func:`~iscc_search_tpu_torch.parallel.mesh.process_count`,
:func:`~iscc_search_tpu_torch.parallel.mesh.process_index`) in place of
``jax.process_count()`` / ``jax.process_index()``. A mesh in one process
(``mesh_devices``, ``mesh_hosts``) serves alone; under a world of several
processes the 2-D mesh crosses them and the multi-host control plane
(:mod:`iscc_search_tpu_torch.parallel.service`) serves the index: process 0
hooks every NPHD engine, the others run :meth:`TpuIndex.follow`.

Functional twin of the reference's usearch backend (UsearchIndex,
iscc_search/indexes/usearch/index.py) re-architected for the device scan engine:

- Source of truth: native HostStore (assets, metadata, INSTANCE dupsort,
  per-type simprint data) — mirrors the LMDB-is-truth consistency model
  (reference usearch/index.py:203-209).
- Derived: per-unit-type :class:`DeviceNphdIndex` (exact NPHD scan) and
  per-simprint-type :class:`SimprintEngine` (exact Hamming scan). Derived
  state commits after the store, is rebuildable, and count-sync-checked on
  load (warn-and-load-stale, reference usearch/index.py:1602-1648).
- add_assets semantics parity (reference usearch/index.py:194-537): realm
  inference/validation, within-batch dedup keeping the last occurrence,
  created/updated status, idempotent no-op fast path gated on stored bytes +
  derived presence + per-type simprint fingerprints, stale-INSTANCE cleanup,
  remove-before-add updates, auto-flush at flush_interval.
- search_assets parity (usearch/index.py:735-881): INSTANCE exact
  bidirectional prefix matching (binary 1.0 scores), per-type NPHD scan
  scores (1 - distance), threshold + confidence-weighted aggregation
  (sum s^e / sum s), metadata enrichment, iscc_id self-exclusion, and
  chunk-level simprint matches (exact or oversampled-scan path).

Directory layout:
    {path}/store/           HostStore (log + snapshot)
    {path}/{unit_type}/     DeviceNphdIndex segments
    {path}/SIMPRINT_{t}/    SimprintEngine segments
"""

from __future__ import annotations

import hashlib
import json
import shutil
import struct
import threading
import time
from pathlib import Path

import numpy as np
from typing import TYPE_CHECKING

from iscc_search_tpu_torch import codec as ic
from iscc_search_tpu_torch.engine import simprint_ops as sp_ops
from iscc_search_tpu_torch.engine.batcher import SearchBatcher
from iscc_search_tpu_torch.engine.device_index import DeviceNphdIndex, resolve_device
from iscc_search_tpu_torch.engine.simprint import SimprintEngine
from iscc_search_tpu_torch.indexes import common
from iscc_search_tpu_torch.models import IsccID, IsccUnit
from iscc_search_tpu_torch.schema import (
    IsccAddResult,
    IsccChunkMatch,
    IsccGlobalMatch,
    IsccMatchedChunk,
    IsccQuery,
    IsccSearchResult,
    Status,
    Types,
)
from iscc_search_tpu_torch.store import HostStore
from iscc_search_tpu_torch.utils import get_logger

if TYPE_CHECKING:  # pragma: no cover
    from iscc_search_tpu_torch.schema import IsccEntry, IsccSimprint  # noqa: F401

logger = get_logger(__name__)

# HostStore database names
DB_META = "metadata"
DB_ASSETS = "assets"
DB_INSTANCE = "instance"


def _sp_db(sp_type):
    # type: (str) -> str
    return f"sp:{sp_type}"


def _spa_db(sp_type):
    # type: (str) -> str
    return f"spa:{sp_type}"


def _spi_db(sp_type):
    # type: (str) -> str
    """Per-asset inverse simprint db: iscc_id_body -> simprint+offset+size.

    Makes per-asset simprint reads/deletes O(the asset's own chunks) instead
    of a scan over the whole forward db (advisory finding, round 2)."""
    return f"spi:{sp_type}"


class TpuIndex:
    """Single device-scan index over a HostStore source of truth."""

    SP_FINGERPRINT_BYTES = 16

    def __init__(self, path, realm_id=None, max_dim=256, device="cuda", **options):
        # type: (str | Path, int | None, int, str, ...) -> None
        """
        Create or open an index directory.

        :param path: Index directory (store/ + derived segment dirs)
        :param realm_id: Realm for new indexes; inferred from first asset if None
        :param max_dim: Maximum unit width in bits
        :param device: torch device of every derived engine, "cuda" by
            default; nothing is auto-detected, and "cuda" without a card
            raises (tests pass "cpu")
        :param options: Per-index overrides of global search options
        """
        from iscc_search_tpu_torch.options import search_opts

        self._opts = search_opts.override(options)
        self.device = resolve_device(device)
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.max_dim = max_dim
        self._realm_id = None  # type: int | None
        self._nphd_indexes = {}  # type: dict[str, DeviceNphdIndex]
        self._simprint_indexes = {}  # type: dict[str, SimprintEngine]
        self._batchers = {}  # type: dict[str, SearchBatcher]
        self._batcher_lock = threading.Lock()
        self._sp_types_cache = None  # type: list[str] | None
        self._closed = False
        self._write_lock = threading.RLock()
        self._batch_counter = 0
        self._service = None  # multi-host control plane (set by _init_multihost)

        self.store = HostStore(self.path / "store")
        self._init_metadata(realm_id)
        self._load_nphd_indexes()
        self._load_simprint_indexes()
        self._init_multihost()

    # ------------------------------------------------------------------ add

    def add_assets(self, assets):
        # type: (list[IsccEntry]) -> list[IsccAddResult]
        """
        Batch upsert with created/updated status per asset.

        The store commits first; derived device indexes update after (not
        atomic — they are rebuildable, and the idempotent no-op gate requires
        derived presence so a crash between the two phases re-indexes on
        retry instead of being skipped forever).
        """
        if not assets:
            return []

        self._batch_counter += 1
        t_batch = time.perf_counter()
        results = []  # type: list[IsccAddResult]

        with self._write_lock, self.store.session():
            t_store = time.perf_counter()
            # Validate the WHOLE batch before mutating anything — including
            # the realm-inference write (all-or-nothing parity with the
            # reference's single LMDB transaction): a realm mismatch,
            # malformed unit, or undecodable simprint in asset N must not
            # leave assets 0..N-1 committed, nor pin the realm of an empty
            # index. Parsed objects are kept and reused by the indexing loop
            # (no double decode on the ingest hot path).
            realm = self._realm_id
            parsed_ids = []  # type: list
            parsed_units = []  # type: list[list]
            parsed_sps = []  # type: list[dict[str, list[tuple[bytes, bytes]]]]
            for asset in assets:
                if asset.iscc_id is None:
                    raise ValueError("Asset must have iscc_id field when adding to index")
                iscc_id_obj = common.parse_iscc_id(asset.iscc_id)
                parsed_ids.append(iscc_id_obj)
                if realm is None:
                    realm = iscc_id_obj.realm_id
                elif realm != iscc_id_obj.realm_id:
                    raise ValueError(
                        f"Realm ID mismatch: index has realm={realm}, "
                        f"but asset '{asset.iscc_id}' has realm={iscc_id_obj.realm_id}. "
                        f"All assets in an index must have the same realm ID."
                    )
                parsed_units.append([IsccUnit(u) for u in asset.units or []])
                sp_decoded = {}  # type: dict[str, list[tuple[bytes, bytes]]]
                for sp_type, sp_list in (asset.simprints or {}).items():
                    sp_decoded[sp_type] = [
                        (
                            ic.decode_base64(sp_obj.simprint),
                            sp_ops.pack_chunk_pointer(iscc_id_obj.body, sp_obj.offset, sp_obj.size),
                        )
                        for sp_obj in sp_list
                    ]
                parsed_sps.append(sp_decoded)

            if self._realm_id is None:
                self._realm_id = realm
                self.store.put(DB_META, b"realm_id", struct.pack(">I", self._realm_id))
                logger.info(f"Inferred realm_id={self._realm_id} from first asset")

            nphd_batches = {}  # type: dict[str, tuple[list[int], list[bytes]]]
            nphd_updated_keys = set()  # type: set[int]
            nphd_dropped = {}  # type: dict[str, set[int]]
            sp_batches = {}  # type: dict[str, tuple[list[bytes], list[bytes]]]
            sp_deleted_keys = {}  # type: dict[str, list[bytes]]
            sp_inv_pairs = {}  # type: dict[str, list[tuple[bytes, bytes]]]
            sp_store_pairs = {}  # type: dict[str, list[tuple[bytes, bytes]]]

            # Within-batch dedup: keep the LAST occurrence of each ISCC-ID;
            # earlier occurrences still produce a positional result.
            last_occurrence = {a.iscc_id: i for i, a in enumerate(assets)}
            batch_seen = set()  # type: set[int]

            # One batched read for every key's pre-batch row (asset writes
            # are deferred below and only the LAST occurrence of a key ever
            # writes, so the per-asset get always returned the pre-batch
            # value anyway — get_many is equivalent and one native call).
            all_key_bytes = [struct.pack(">Q", int(p)) for p in parsed_ids]
            existing_rows = self.store.get_many(DB_ASSETS, all_key_bytes)
            asset_pairs = []  # type: list[tuple[bytes, bytes]]
            instance_pairs = []  # type: list[tuple[bytes, bytes]]

            for i, asset in enumerate(assets):
                iscc_id_obj = parsed_ids[i]  # validated + decoded above
                key = int(iscc_id_obj)
                key_bytes = all_key_bytes[i]
                iscc_id_body = iscc_id_obj.body

                existing = existing_rows[i]
                status = Status.updated if (existing is not None or key in batch_seen) else Status.created
                batch_seen.add(key)

                if i != last_occurrence[asset.iscc_id]:
                    results.append(IsccAddResult(iscc_id=asset.iscc_id, status=status))
                    continue

                asset_bytes = common.serialize_asset(asset)
                sp_fingerprints = {
                    sp_type: self._simprint_fingerprint(sp_list)
                    for sp_type, sp_list in (asset.simprints or {}).items()
                }

                # Idempotent no-op: store bytes unchanged AND derived NPHD
                # vectors present AND every incoming simprint type already
                # indexed identically (fingerprint + derived presence).
                if (
                    existing == asset_bytes
                    and self._nphd_units_present(key, asset.units)
                    and self._simprints_already_indexed(iscc_id_body, asset, sp_fingerprints)
                ):
                    results.append(IsccAddResult(iscc_id=asset.iscc_id, status=status))
                    continue

                if existing is not None:
                    nphd_updated_keys.add(key)
                    # Drop rows the update no longer carries: INSTANCE bodies
                    # (a stale shorter body would keep prefix-matching as
                    # identity) and whole similarity types (a stale vector
                    # would keep returning the asset for content it no longer
                    # claims — the reference leaves these until rebuild;
                    # removing eagerly is strictly more correct).
                    new_units = set(asset.units or [])
                    new_types = {u.unit_type for u in parsed_units[i]}
                    for old_unit_str in common.deserialize_asset(existing).units or []:
                        if old_unit_str in new_units:
                            continue
                        old_unit = IsccUnit(old_unit_str)
                        if old_unit.unit_type.startswith("INSTANCE_"):
                            self.store.dup_delete(DB_INSTANCE, old_unit.body, key_bytes)
                        elif old_unit.unit_type not in new_types:
                            nphd_dropped.setdefault(old_unit.unit_type, set()).add(key)

                asset_pairs.append((key_bytes, asset_bytes))

                for unit in parsed_units[i]:
                    unit_type = unit.unit_type
                    if unit_type.startswith("INSTANCE_"):
                        instance_pairs.append((unit.body, key_bytes))
                    else:
                        nphd_batches.setdefault(unit_type, ([], []))
                        nphd_batches[unit_type][0].append(key)
                        nphd_batches[unit_type][1].append(unit.body)

                if asset.simprints:
                    for sp_type, decoded in parsed_sps[i].items():
                        self._register_sp_type(sp_type)
                        if self.store.get(_spa_db(sp_type), iscc_id_body) is not None:
                            deleted = sp_ops.delete_asset_simprints(
                                self.store,
                                _sp_db(sp_type),
                                iscc_id_body,
                                inv_db=_spi_db(sp_type),
                                trust_inverse=self._spi_trusted(sp_type),
                            )
                            sp_deleted_keys.setdefault(sp_type, []).extend(deleted)
                        self.store.put(_spa_db(sp_type), iscc_id_body, sp_fingerprints[sp_type])
                        for sp_bytes, chunk_ptr in decoded:
                            sp_store_pairs.setdefault(sp_type, []).append((sp_bytes, chunk_ptr))
                            # inverse entry = sp_bytes + offset(4) + size(4),
                            # i.e. the chunk pointer's tail re-keyed by asset
                            sp_inv_pairs.setdefault(sp_type, []).append((iscc_id_body, sp_bytes + chunk_ptr[8:]))
                            sp_batches.setdefault(sp_type, ([], []))
                            sp_batches[sp_type][0].append(chunk_ptr)
                            sp_batches[sp_type][1].append(sp_bytes)

                results.append(IsccAddResult(iscc_id=asset.iscc_id, status=status))

            # Batched writes, ordered for crash prefixes: asset rows before
            # their INSTANCE rows (an asset without its instance row is a
            # recoverable miss; an instance row without its asset would be a
            # dangling key). Same per-asset invariant the interleaved writes
            # kept — delete/put pair sets are disjoint (only rows the update
            # no longer carries are deleted), so deletes moving earlier is
            # inert.
            self.store.putmulti(DB_ASSETS, asset_pairs)
            self.store.dup_putmulti(DB_INSTANCE, instance_pairs)
            # Inverse rows FIRST: if the forward write then fails, inverse
            # rows for missing forward pairs are harmless (deletes no-op);
            # the opposite order could orphan forward rows the inverse can't
            # find, silently breaking later per-asset deletes.
            for sp_type, pairs in sp_inv_pairs.items():
                self.store.dup_putmulti(_spi_db(sp_type), pairs)
            for sp_type, pairs in sp_store_pairs.items():
                self.store.dup_putmulti(_sp_db(sp_type), pairs)
            self.store.flush()  # push the batch to the OS (commit point parity)
            t_store = time.perf_counter() - t_store

            # ---- derived updates (after the store commit; rebuildable) ----
            t_nphd = time.perf_counter()
            n_nphd = 0
            for unit_type, (keys, vectors) in nphd_batches.items():
                nphd_index = self._get_or_create_nphd_index(unit_type)
                if len(keys) != len(set(keys)):
                    # Keep the LONGEST vector per key (same-type dual-length
                    # units) — the same rule _rebuild_nphd_index applies, so a
                    # rebuilt index always matches the live one.
                    unique = {}  # type: dict[int, bytes]
                    for k, v in zip(keys, vectors):
                        if k not in unique or len(v) > len(unique[k]):
                            unique[k] = v
                    keys, vectors = list(unique.keys()), list(unique.values())
                to_remove = [k for k in keys if k in nphd_updated_keys]
                if to_remove:
                    nphd_index.remove(to_remove)
                nphd_index.add(keys, vectors)
                n_nphd += len(keys)
                self._set_count(b"nphd_count:", unit_type, nphd_index.size)
            # Updates that dropped a whole similarity type: remove the stale
            # vectors from that type's derived index (no add follows).
            for unit_type, dropped in nphd_dropped.items():
                nphd_index = self._nphd_indexes.get(unit_type)
                if nphd_index is None:
                    continue
                if nphd_index.remove(list(dropped)):
                    self._set_count(b"nphd_count:", unit_type, nphd_index.size)
            t_nphd = time.perf_counter() - t_nphd

            t_sp = time.perf_counter()
            n_sp = 0
            for sp_type, (composite_keys, sp_vectors) in sp_batches.items():
                sp_index = self._get_or_create_simprint_index(sp_type, len(sp_vectors[0]) * 8)
                if sp_type in sp_deleted_keys:
                    sp_index.remove(sp_deleted_keys[sp_type])
                sp_index.add_raw(composite_keys, sp_vectors)
                n_sp += len(composite_keys)
                self._set_count(b"sp_count:", sp_type, sp_index.size)
            # Types with deletions but no additions this batch (an update
            # shrank a type to an empty list): the removal must still reach
            # the derived index or deleted chunks would keep matching.
            for sp_type, deleted in sp_deleted_keys.items():
                if sp_type in sp_batches:
                    continue
                sp_index = self._simprint_indexes.get(sp_type)
                if sp_index is None:
                    continue
                sp_index.remove(deleted)
                self._set_count(b"sp_count:", sp_type, sp_index.size)
            t_sp = time.perf_counter() - t_sp

            # Auto-flush derived indexes past the mutation threshold. The
            # snapshot happens here (cheap memcpy); the file I/O runs on the
            # index's background save worker so ingest never stalls at flush
            # boundaries (reference CHANGELOG 0.2.2 background rotation).
            t_flush = time.perf_counter()
            interval = self._opts.flush_interval
            if interval > 0:
                for nphd_index in self._nphd_indexes.values():
                    if nphd_index.dirty >= interval:
                        nphd_index.save(wait=False)
                for sp_index in self._simprint_indexes.values():
                    if sp_index.dirty >= interval:
                        sp_index.save(wait=False)
            t_flush = time.perf_counter() - t_flush

            logger.debug(
                f"add_assets batch={self._batch_counter} assets={len(assets)} nphd={n_nphd} sp={n_sp} | "
                f"store={t_store:.3f}s nphd={t_nphd:.3f}s sp={t_sp:.3f}s flush={t_flush:.3f}s "
                f"TOTAL={time.perf_counter() - t_batch:.3f}s"
            )

        return results

    # ---------------------------------------------------------------- lookup

    def get_asset(self, iscc_id):
        # type: (str) -> IsccEntry
        """Fetch a stored asset by ISCC-ID (realm-checked)."""
        common.validate_iscc_id(iscc_id, expected_realm=self._realm_id)
        key_bytes = struct.pack(">Q", int(IsccID(iscc_id)))
        asset_bytes = self.store.get(DB_ASSETS, key_bytes)
        if asset_bytes is None:
            raise FileNotFoundError(f"Asset '{iscc_id}' not found in index")
        return common.deserialize_asset(asset_bytes)

    # ---------------------------------------------------------------- search

    def search_assets(self, query, limit=100, exact=False):
        # type: (IsccQuery, int, bool) -> IsccSearchResult
        """
        Top-k search: INSTANCE exact matches + per-type NPHD scan + simprint
        chunk matches, aggregated with confidence weighting.
        """
        query, query_iscc_id = common.expand_iscc_id_query(query, self.get_asset)
        query = common.normalize_query(query)
        t_search = time.perf_counter()

        chunk_matches = []  # type: list[IsccChunkMatch]
        has_sp = bool(self._simprint_indexes) or bool(self._get_sp_types())
        t_sp = time.perf_counter()
        if has_sp and query.simprints:
            chunk_matches = self._search_simprints(query, limit, exact=exact)
        t_sp = time.perf_counter() - t_sp

        matches = []  # type: list[IsccGlobalMatch]
        if query.units:
            aggregated = {}  # type: dict[int, dict[str, float]]
            for unit_str in query.units:
                unit = IsccUnit(unit_str)
                unit_type = unit.unit_type
                if unit_type.startswith("INSTANCE_"):
                    found = self._search_instance_unit(unit.body)
                else:
                    if unit_type not in self._nphd_indexes:
                        continue
                    found = self._search_similarity_unit(unit_type, unit.body, limit)
                for key, score in found.items():
                    slot = aggregated.setdefault(key, {})
                    slot[unit_type] = max(slot.get(unit_type, 0.0), max(0.0, score))

            scored = []  # type: list[tuple[int, float, dict[str, float]]]
            threshold = self._opts.match_threshold_units
            exponent = self._opts.confidence_exponent
            # Plain accumulation: per-key dict comprehensions + generator
            # sums cost a frame per candidate on the serving hot path.
            for key, unit_scores in aggregated.items():
                confident = False
                weighted_sum = 0.0
                weight_sum = 0.0
                for s in unit_scores.values():
                    if s >= threshold:
                        confident = True
                        weighted_sum += s**exponent
                        weight_sum += s
                if not confident:
                    continue
                # weight_sum == 0 only at threshold 0 with all-zero scores;
                # such keys keep their (0.0-scored) slot, as before.
                scored.append((key, weighted_sum / weight_sum if weight_sum > 0 else 0.0, unit_scores))

            if query_iscc_id:
                query_key = int(IsccID(query_iscc_id))
                scored = [r for r in scored if r[0] != query_key]

            scored.sort(key=lambda x: x[1], reverse=True)
            scored = scored[:limit]

            # Enrich in one batched store read (one lock + one native call
            # for the whole top-k) and parse only the metadata field — the
            # full-model validation per match tripled enrichment cost.
            rows = self.store.get_many(DB_ASSETS, [struct.pack(">Q", key) for key, _, _ in scored])
            for (key, total, unit_scores), asset_bytes in zip(scored, rows):
                iscc_id = IsccID.str_from_int(key, self._realm_id)
                # Metadata-only parse (1.8x over the full IsccEntry build —
                # the match carries nothing else from the stored record).
                # Validated model construction stays: pydantic's C-path
                # __init__ measures 2x FASTER than model_construct here.
                metadata = common.metadata_from_asset_bytes(asset_bytes) if asset_bytes is not None else None
                matches.append(
                    IsccGlobalMatch(iscc_id=iscc_id, score=total, types=unit_scores, metadata=metadata)
                )

        if query_iscc_id and chunk_matches:  # pragma: no cover
            # Defensive parity (reference usearch/index.py:869-871): stored
            # assets serialize without simprints, so an iscc_id-expanded query
            # can't produce chunk matches in this backend today — but the
            # self-exclusion guard must survive any future enrichment of
            # get_asset with reconstructed simprints.
            chunk_matches = [m for m in chunk_matches if m.iscc_id != query_iscc_id]

        logger.debug(
            f"search_assets units={len(query.units or [])} "
            f"sp_types={len(query.simprints or {})} limit={limit} | "
            f"simprints={t_sp:.3f}s TOTAL={time.perf_counter() - t_search:.3f}s "
            f"-> {len(matches)} global, {len(chunk_matches)} chunk matches"
        )
        return IsccSearchResult(query=query, global_matches=matches, chunk_matches=chunk_matches)

    def _search_similarity_unit(self, unit_type, unit_body, limit):
        # type: (str, bytes, int) -> dict[int, float]
        """
        NPHD scan for one query unit, routed through the per-type request
        batcher when enabled (concurrent API calls fuse into one sweep).
        """
        # .get(): a concurrent rebuild may pop the entry between the caller's
        # membership check and this lookup — treat as no matches, not KeyError.
        nphd_index = self._nphd_indexes.get(unit_type)
        if nphd_index is None:
            return {}
        if self._opts.search_batching:
            batcher = self._batchers.get(unit_type)
            if batcher is None:
                # Lock the check-then-create: two concurrent first requests
                # must not both spawn a collector thread (the loser's thread
                # would leak for the process lifetime). Re-fetch the LIVE
                # index inside the lock — binding a batcher to a stale
                # reference that a rebuild just reset would permanently serve
                # empty results (rebuild swaps happen under this same lock).
                with self._batcher_lock:
                    batcher = self._batchers.get(unit_type)
                    if batcher is None:
                        nphd_index = self._nphd_indexes.get(unit_type)
                        if nphd_index is None:
                            return {}
                        batcher = SearchBatcher(
                            nphd_index,
                            max_batch=self._opts.query_batch_max,
                            window_ms=self._opts.search_batching_window_ms,
                        )
                        self._batchers[unit_type] = batcher
            try:
                ((keys, scores),) = batcher.search([unit_body], limit)
            except RuntimeError:
                # Batcher closed by a concurrent rebuild: fall back to an
                # unbatched search on the current index.
                nphd_index = self._nphd_indexes.get(unit_type)
                if nphd_index is None:
                    return {}
                ((keys, scores),) = nphd_index.search([unit_body], limit)
        else:
            ((keys, scores),) = nphd_index.search([unit_body], limit)
        return {int.from_bytes(keys[i].tobytes(), "big"): float(scores[i]) for i in range(len(scores))}

    def _search_instance_unit(self, instance_code):
        # type: (bytes) -> dict[int, float]
        """
        Bidirectional prefix match on INSTANCE codes via the store's ordered
        dupsort db. Identity codes score binary 1.0 (reference
        usearch/index.py:1957-2022).
        """
        results = {}  # type: dict[int, float]
        # Forward: stored codes extending the query prefix
        for _k, val in self.store.prefix_scan(DB_INSTANCE, instance_code):
            results[struct.unpack(">Q", val)[0]] = 1.0
        # Reverse: stored codes that are prefixes of the query (64/128-bit cuts)
        qlen = len(instance_code)
        cut_points = []
        if qlen == 32:
            cut_points.append(16)
        if qlen >= 16:
            cut_points.append(8)
        for cut in cut_points:
            for val in self.store.get_dups(DB_INSTANCE, instance_code[:cut]):
                results[struct.unpack(">Q", val)[0]] = 1.0
        return results

    # ------------------------------------------------------------- simprints

    def _search_simprints(self, query, limit, exact=False):
        # type: (IsccQuery, int, bool) -> list[IsccChunkMatch]
        """Chunk-level search: exact store lookups or device-scan path."""
        asset_type_results = {}  # type: dict[bytes, dict[str, sp_ops.TypeMatchResult]]
        threshold = self._opts.match_threshold_simprints
        total_assets = self.store.entries(DB_ASSETS)

        # search_assets only routes here when query.simprints is truthy
        for sp_type, simprint_strs in query.simprints.items():
            query_sp_bytes = [ic.decode_base64(s) for s in simprint_strs]
            if exact:
                if self.store.key_count(_sp_db(sp_type)) == 0:
                    continue
                raw_matches = sp_ops.search_simprints_exact(
                    self.store,
                    _sp_db(sp_type),
                    query_sp_bytes,
                    limit=limit * 2,
                    threshold=threshold,
                    detailed=True,
                )
            else:
                sp_index = self._simprint_indexes.get(sp_type)
                if sp_index is None:
                    if self.store.key_count(_sp_db(sp_type)) > 0:
                        logger.warning(
                            f"Simprint index missing for type '{sp_type}' but store has data - "
                            "skipping this type in search. Run an explicit rebuild to restore results."
                        )
                    continue

                def doc_freq_fn(sp_key, _db=_sp_db(sp_type)):
                    # type: (bytes, str) -> int
                    return sp_ops.count_doc_freq(self.store, _db, sp_key)

                sweep_fn = self._sp_sweep_fn(sp_type) if self._opts.search_batching else None
                try:
                    raw_matches = sp_index.search_raw(
                        simprints=query_sp_bytes,
                        limit=limit * 2,
                        threshold=threshold,
                        detailed=True,
                        doc_freq_fn=doc_freq_fn,
                        total_assets=total_assets,
                        sweep_fn=sweep_fn,
                    )
                except RuntimeError:
                    # Batcher closed by a concurrent rebuild: fall back to an
                    # unbatched sweep on the current engine.
                    sp_index = self._simprint_indexes.get(sp_type)
                    if sp_index is None:  # pragma: no cover - rebuild never drops types
                        continue
                    raw_matches = sp_index.search_raw(
                        simprints=query_sp_bytes,
                        limit=limit * 2,
                        threshold=threshold,
                        detailed=True,
                        doc_freq_fn=doc_freq_fn,
                        total_assets=total_assets,
                    )

            for raw in raw_matches:
                slot = asset_type_results.setdefault(raw.iscc_id_body, {})
                slot[sp_type] = sp_ops.TypeMatchResult(
                    score=raw.score, queried=raw.queried, matches=raw.matches, chunks=raw.chunks
                )

        if not asset_type_results:
            return []

        multi = []
        for body, type_results in asset_type_results.items():
            asset_score = sum(tr.score for tr in type_results.values()) / len(type_results)
            digest = IsccID.from_body(body, self._realm_id).digest
            multi.append(sp_ops.SimprintMatchMulti(iscc_id=digest, score=asset_score, types=type_results))
        multi.sort(key=lambda x: (-x.score, x.iscc_id))
        multi = multi[:limit]

        return [self._convert_simprint_match(m) for m in multi]

    def _sp_sweep_fn(self, sp_type):
        # type: (str) -> ...
        """Cross-request batched device sweep for one simprint type, or None.

        Concurrent ``search_assets`` calls with simprints fuse their chunk
        sweeps exactly like unit searches do (same SearchBatcher, in
        return_rows mode); one query asset per device sweep measured ~10x
        below the fused-batch throughput at BASELINE config-4 scale."""
        key = "sp:" + sp_type
        batcher = self._batchers.get(key)
        if batcher is None:
            # Same locked check-then-create discipline as the unit batchers:
            # re-fetch the LIVE engine inside the lock so a rebuild swap can
            # never leave a batcher bound to a reset index.
            with self._batcher_lock:
                batcher = self._batchers.get(key)
                if batcher is None:
                    sp_index = self._simprint_indexes.get(sp_type)
                    if sp_index is None:  # pragma: no cover - caller checked
                        return None
                    batcher = SearchBatcher(
                        sp_index._index,
                        max_batch=max(self._opts.query_batch_max, SimprintEngine.max_sweep_queries),
                        window_ms=self._opts.search_batching_window_ms,
                        return_rows=True,
                    )
                    self._batchers[key] = batcher
        return batcher.search

    def _convert_simprint_match(self, raw_match):
        # type: (sp_ops.SimprintMatchMulti) -> IsccChunkMatch
        """Raw bytes-level match -> wire schema, with metadata enrichment."""
        iscc_id_str = "ISCC:" + ic.encode_base32(raw_match.iscc_id)
        source = None
        metadata = None
        key_bytes = raw_match.iscc_id[2:]
        asset_bytes = self.store.get(DB_ASSETS, key_bytes)
        if asset_bytes is not None:
            asset = common.deserialize_asset(asset_bytes)
            if asset.metadata:
                source = asset.metadata.get("source")
                metadata = asset.metadata

        types_converted = {}
        for sp_type, tr in raw_match.types.items():
            chunks = None
            if tr.chunks is not None:
                chunks = [
                    IsccMatchedChunk(
                        query=ic.encode_base64(c.query),
                        match=ic.encode_base64(c.match),
                        score=c.score,
                        freq=c.freq,
                        offset=c.offset,
                        size=c.size,
                        content=None,
                    )
                    for c in tr.chunks
                ]
            types_converted[sp_type] = Types(score=tr.score, matches=tr.matches, queried=tr.queried, chunks=chunks)

        return IsccChunkMatch(
            iscc_id=iscc_id_str, score=raw_match.score, types=types_converted, source=source, metadata=metadata
        )

    # ------------------------------------------------------------- lifecycle

    def flush(self):
        # type: () -> None
        """Save dirty derived indexes; each failure is isolated."""
        with self._write_lock:
            for unit_type, nphd_index in self._nphd_indexes.items():
                if nphd_index.dirty == 0:
                    continue
                try:
                    nphd_index.save()
                    self._set_count(b"nphd_count:", unit_type, nphd_index.size)
                except Exception:  # pragma: no cover
                    logger.exception(f"Failed to flush NPHD index '{unit_type}'")
            for sp_type, sp_index in self._simprint_indexes.items():
                if sp_index.dirty == 0:
                    continue
                try:
                    sp_index.save()
                    self._set_count(b"sp_count:", sp_type, sp_index.size)
                except Exception:  # pragma: no cover
                    logger.exception(f"Failed to flush simprint index '{sp_type}'")
            self.store.flush()

    def close(self):
        # type: () -> None
        """Flush derived state, sync the store, release resources. Idempotent."""
        with self._write_lock:
            if self._closed:
                return
            if self._service is not None:
                # Coordinator: release followers from their follow() loop
                # before tearing down the engines they mirror; follower:
                # close the channel (the coordinator handles a dead channel).
                try:
                    self._service.stop()
                except Exception:  # pragma: no cover
                    logger.exception("Failed to stop multihost control plane")
            for batcher in self._batchers.values():
                try:
                    batcher.close()
                except Exception:  # pragma: no cover
                    logger.exception("Failed to close search batcher")
            self._batchers.clear()
            for unit_type, nphd_index in list(self._nphd_indexes.items()):
                try:
                    dirty = nphd_index.dirty > 0
                    size = nphd_index.size
                    nphd_index.close()
                    if dirty:
                        self._set_count(b"nphd_count:", unit_type, size)
                        logger.info(f"Saved NPHD index '{unit_type}' ({size} vectors)")
                except Exception:  # pragma: no cover
                    logger.exception(f"Failed to close NPHD index '{unit_type}'")
            self._nphd_indexes.clear()
            for sp_type, sp_index in list(self._simprint_indexes.items()):
                try:
                    dirty = sp_index.dirty > 0
                    size = sp_index.size
                    sp_index.close()
                    if dirty:
                        self._set_count(b"sp_count:", sp_type, size)
                        logger.info(f"Saved simprint index '{sp_type}' ({size} vectors)")
                except Exception:  # pragma: no cover
                    logger.exception(f"Failed to close simprint index '{sp_type}'")
            self._simprint_indexes.clear()
            try:
                self.store.sync()
                self.store.close()
            except Exception:  # pragma: no cover
                logger.exception("Failed to close host store")
            self._closed = True
            logger.info(f"Closed TpuIndex at {self.path}")

    def __len__(self):
        # type: () -> int
        return self.store.entries(DB_ASSETS)

    # --------------------------------------------------------------- rebuild

    @property
    def tracked_unit_types(self):
        # type: () -> list[str]
        return sorted(self._tracked_types(b"nphd_count:"))

    @property
    def tracked_simprint_types(self):
        # type: () -> list[str]
        return sorted(self._get_sp_types())

    def rebuild(self, unit_types, simprint_types):
        # type: (list[str], list[str]) -> dict[str, list[str]]
        """Rebuild derived indexes from the source-of-truth store.

        Runs under the write lock: a rebuild pops/resets live indexes and
        deletes their segment dirs, which must not interleave with a
        concurrent add_assets batch (adds would land in an orphaned index).
        """
        if self._service is not None:
            # A rebuild swaps whole index objects; mirroring that through the
            # op stream would desynchronize follower replicas mid-swap.
            raise RuntimeError(
                "rebuild is unsupported while serving multi-host: rebuild offline "
                "(single process), redistribute the index directory, and restart the cluster"
            )
        with self._write_lock:
            rebuilt_units = [ut for ut in unit_types if self._rebuild_nphd_index(ut)]
            rebuilt_sp = [st for st in simprint_types if self._rebuild_simprint_index(st)]
            return {"unit_types": rebuilt_units, "simprint_types": rebuilt_sp}

    def _rebuild_nphd_index(self, unit_type):
        # type: (str) -> bool
        t0 = time.time()
        logger.info(f"Rebuilding NPHD index for unit_type '{unit_type}'...")
        # Collect the longest body per key for this type from stored assets
        best = {}  # type: dict[int, bytes]
        for key_bytes, asset_bytes in self.store.iter_range(DB_ASSETS):
            asset = common.deserialize_asset(asset_bytes)
            for unit_str in asset.units or []:
                unit = IsccUnit(unit_str)
                if unit.unit_type == unit_type:
                    key = struct.unpack(">Q", key_bytes)[0]
                    if key not in best or len(unit.body) > len(best[key]):
                        best[key] = unit.body
        if not best:
            logger.info(f"No vectors found for unit_type '{unit_type}' - skipping rebuild")
            return False

        # Build ASIDE, swap at the end: searches keep serving the old index
        # for the whole (potentially minutes-long) rebuild instead of
        # returning empty results for this unit type.
        shard_dir = self.path / unit_type
        build_dir = self.path / f"{unit_type}.rebuilding"
        if build_dir.exists():
            shutil.rmtree(build_dir)  # crash residue from an aborted rebuild
        nphd_index = self._new_nphd_index(unit_type, path=build_dir)
        nphd_index.add(list(best.keys()), list(best.values()))
        nphd_index.save()

        # ATOMIC swap under _batcher_lock: the new index REPLACES the old in
        # one dict assignment (searches never observe a missing type), and
        # batcher creation re-reads _nphd_indexes inside the same lock so it
        # can never bind a new batcher to the old index (any batcher closed
        # here wakes its in-flight callers, who fall back unbatched onto the
        # already-installed new index).
        with self._batcher_lock:
            old_batcher = self._batchers.pop(unit_type, None)
            if old_batcher is not None:
                old_batcher.close()
            old = self._nphd_indexes.get(unit_type)
            self._nphd_indexes[unit_type] = nphd_index
        if old is not None:
            old.reset()
        if shard_dir.exists():
            shutil.rmtree(shard_dir)
        build_dir.rename(shard_dir)
        nphd_index.path = shard_dir  # saves drained above; future saves land here
        self._set_count(b"nphd_count:", unit_type, nphd_index.size)
        logger.info(f"Rebuilt NPHD index '{unit_type}': {len(best)} vectors in {time.time() - t0:.2f}s")
        return True

    def _rebuild_simprint_index(self, sp_type):
        # type: (str) -> bool
        t0 = time.time()
        if self.store.key_count(_sp_db(sp_type)) == 0:
            logger.info(f"No vectors found for simprint type '{sp_type}' - skipping rebuild")
            return False
        # Build ASIDE, swap at the end (same contract as the NPHD rebuild)
        sp_dir = self.path / f"SIMPRINT_{sp_type}"
        build_dir = self.path / f"SIMPRINT_{sp_type}.rebuilding"
        if build_dir.exists():
            shutil.rmtree(build_dir)
        ndim = self._detect_sp_ndim(sp_type)
        sp_index = self._new_simprint_index(sp_type, ndim, path=build_dir)
        # Vectorized bulk rebuild: collect the forward rows as arrays, dedup
        # composite keys keep-FIRST in iteration order (the rule the
        # streamed add_raw rebuild applied; duplicate chunk pointers — one
        # asset submitting two simprints for the same offset+size — have no
        # stored wire order in the sp_bytes-sorted forward db, so "first
        # seen" is the only stable choice), then bulk-append. The per-item
        # add() upsert measured ~28K rows/s — an hour at the 100M-chunk
        # BASELINE config-4 scale; this path is memcpy-bound. Peak host
        # memory is corpus-sized (keys 16B + vectors ndim/8 B per row), the
        # same order as the engine's own host arrays.
        key_parts, vec_parts = [], []
        for keys, vectors in sp_ops.iter_simprint_vectors(self.store, _sp_db(sp_type)):
            key_parts.append(np.frombuffer(b"".join(keys), np.uint8).reshape(len(keys), -1))
            vec_parts.append(np.frombuffer(b"".join(vectors), np.uint8).reshape(len(vectors), -1))
        all_keys = np.concatenate(key_parts)
        all_vecs = np.concatenate(vec_parts)
        view = np.ascontiguousarray(all_keys).view(f"V{all_keys.shape[1]}").ravel()
        _, first_seen = np.unique(view, return_index=True)
        if len(first_seen) != len(view):
            keep = np.sort(first_seen)
            all_keys, all_vecs = all_keys[keep], all_vecs[keep]
        total = len(all_keys)
        chunk = 4_194_304  # bound per-append temporaries
        for lo in range(0, total, chunk):
            sp_index.add_packed(all_keys[lo : lo + chunk], all_vecs[lo : lo + chunk])
        del key_parts, vec_parts, all_keys, all_vecs
        sp_index.save()

        # Same atomic swap discipline as the NPHD rebuild: close the sweep
        # batcher under the creation lock so no new batcher can bind to the
        # outgoing engine (in-flight callers fall back unbatched onto the
        # already-installed new engine).
        with self._batcher_lock:
            old_batcher = self._batchers.pop("sp:" + sp_type, None)
            if old_batcher is not None:
                old_batcher.close()
            old = self._simprint_indexes.get(sp_type)
            self._simprint_indexes[sp_type] = sp_index  # atomic: no missing-type window
        if old is not None:
            old.reset()
        if sp_dir.exists():
            shutil.rmtree(sp_dir)
        build_dir.rename(sp_dir)
        sp_index.relocate(sp_dir)
        self._set_count(b"sp_count:", sp_type, sp_index.size)
        logger.info(f"Rebuilt simprint index '{sp_type}': {total} vectors in {time.time() - t0:.2f}s")
        return True

    # ------------------------------------------------------------ monitoring

    @property
    def derived_sizes(self):
        # type: () -> dict[str, int]
        """Serialized bytes per derived component (unflushed included)."""
        with self._write_lock:
            nphd = list(self._nphd_indexes.items())
            sps = list(self._simprint_indexes.items())
        sizes = {}
        for unit_type, index in nphd:
            disk = sum(f.stat().st_size for f in index.path.glob("*") if f.is_file()) if index.path.exists() else 0
            sizes[unit_type] = max(disk, index.serialized_length)
        for sp_type, sp_index in sps:
            sizes[f"SIMPRINT_{sp_type}"] = sp_index.data_size
        return sizes

    # --------------------------------------------------------------- helpers

    def _init_metadata(self, realm_id):
        # type: (int | None) -> None
        realm_bytes = self.store.get(DB_META, b"realm_id")
        if realm_bytes is not None:
            self._realm_id = struct.unpack(">I", realm_bytes)[0]
            max_dim_bytes = self.store.get(DB_META, b"max_dim")
            if max_dim_bytes:
                self.max_dim = struct.unpack(">I", max_dim_bytes)[0]
            return
        if realm_id is not None:
            self._realm_id = realm_id
            self.store.put(DB_META, b"realm_id", struct.pack(">I", realm_id))
        self.store.put(DB_META, b"max_dim", struct.pack(">I", self.max_dim))
        self.store.put(DB_META, b"created_at", struct.pack(">d", time.time()))

    def _set_count(self, prefix, type_name, count):
        # type: (bytes, str, int) -> None
        self.store.put(DB_META, prefix + type_name.encode(), struct.pack(">Q", count))

    def _get_count(self, prefix, type_name):
        # type: (bytes, str) -> int | None
        raw = self.store.get(DB_META, prefix + type_name.encode())
        return struct.unpack(">Q", raw)[0] if raw else None

    def _tracked_types(self, prefix):
        # type: (bytes) -> set[str]
        return {k[len(prefix):].decode() for k, _ in self.store.prefix_scan(DB_META, prefix)}

    def _get_sp_types(self):
        # type: () -> list[str]
        # Cached: every search consults this (has-simprints gate) and the
        # store read measured ~30 us/request of pure overhead on the hot
        # path. This object is the single writer, so the cache only needs
        # invalidation at the one write site (_register_sp_type).
        if self._sp_types_cache is None:
            raw = self.store.get(DB_META, b"sp_types")
            self._sp_types_cache = json.loads(raw.decode()) if raw else []
        return self._sp_types_cache

    def _register_sp_type(self, sp_type):
        # type: (str) -> None
        types = self._get_sp_types()
        if sp_type not in types:
            types.append(sp_type)
            self._sp_types_cache = types
            self.store.put(DB_META, b"sp_types", json.dumps(types).encode())
            # Types registered by THIS version always maintain the per-asset
            # inverse db, so an empty inverse lookup is authoritative (no
            # full-forward-db fallback scan). Pre-inverse stores lack the
            # marker and keep the legacy fallback.
            self.store.put(DB_META, b"spi_v1:" + sp_type.encode(), b"1")

    def _spi_trusted(self, sp_type):
        # type: (str) -> bool
        """True when the inverse db is authoritative for this simprint type."""
        return self.store.get(DB_META, b"spi_v1:" + sp_type.encode()) is not None

    def _device_mesh(self):
        # type: () -> ...
        """Shared search mesh (lazy, cached): 1-D over ``mesh_devices``
        devices of this index's type, or the 2-D (dcn x ici) mesh when
        ``mesh_hosts`` (explicit) or the ``torch.distributed`` world says so."""
        if not hasattr(self, "_mesh"):
            from iscc_search_tpu_torch.parallel.mesh import process_count

            n_procs = process_count()
            hosts = self._opts.mesh_hosts or (n_procs if n_procs > 1 else 0)
            if hosts > 1:
                from iscc_search_tpu_torch.parallel import make_mesh_2d

                self._mesh = make_mesh_2d(hosts, self._opts.mesh_devices or None, device=self.device)
            elif self._opts.mesh_devices > 1:
                from iscc_search_tpu_torch.parallel import make_mesh

                self._mesh = make_mesh(self._opts.mesh_devices, device=self.device)
            else:
                self._mesh = None
        return self._mesh

    # ------------------------------------------------------------- multi-host

    def _init_multihost(self):
        # type: () -> None
        """
        Stand up the cluster control plane when running in a
        ``torch.distributed`` world of several processes with a 2-D mesh
        (parallel/service.py design notes).

        Process 0 (coordinator) owns the product surface: it hooks every NPHD
        engine so searches/mutations execute SPMD cluster-wide, and verifies
        each follower replica matches its row state before serving. Follower
        processes open their own index directory (a copy of the coordinator's,
        or empty alongside an empty coordinator — NOT the same live directory;
        the store is single-writer) and then run :meth:`follow`.
        """
        mesh = self._device_mesh()
        if mesh is None or len(mesh.axis_names) != 2:
            return
        from iscc_search_tpu_torch.parallel import mesh as pmesh

        if pmesh.process_count() <= 1:
            return
        from iscc_search_tpu_torch.parallel.service import MultihostService

        self._service = MultihostService(
            is_coordinator=pmesh.process_index() == 0,
            n_followers=pmesh.process_count() - 1,
            coordinator_host=self._opts.multihost_coordinator,
            port=self._opts.multihost_control_port,
        )
        if self._service.is_coordinator:
            for unit_type, nphd_index in self._nphd_indexes.items():
                name = self._replica_name(unit_type)
                self._service.hook(name, nphd_index)
                self._service.check(name, nphd_index._rows, nphd_index._live)
        else:
            # Followers never persist: the coordinator's directory is truth.
            for nphd_index in self._nphd_indexes.values():
                nphd_index.save_enabled = False

    def _replica_name(self, unit_type):
        # type: (str) -> str
        return f"{self.path.name}:{unit_type}"

    def _resolve_replica(self, name):
        # type: (str) -> DeviceNphdIndex
        index_name, _, unit_type = name.partition(":")
        if index_name != self.path.name:
            raise ValueError(
                f"control op addressed index '{index_name}' but this follower serves '{self.path.name}'"
            )
        return self._get_or_create_nphd_index(unit_type)

    def follow(self):
        # type: () -> None
        """
        Follower loop (multi-host): apply coordinator operations — joining
        every SPMD search collective — until the coordinator stops.
        """
        if self._service is None or self._service.is_coordinator:
            raise RuntimeError("follow() runs only on follower processes of a multi-host cluster")
        self._service.follow(self._resolve_replica)

    def _new_nphd_index(self, unit_type, path=None):
        # type: (str, ...) -> DeviceNphdIndex
        return DeviceNphdIndex(
            path if path is not None else self.path / unit_type,
            max_dim=self.max_dim,
            shard_size=self._opts.shard_size_units * 1024 * 1024,
            recall_target=self._opts.scan_recall_target,
            scan_kernel=self._opts.scan_kernel,
            mesh=self._device_mesh(),
            device=self.device,
        )

    def _new_simprint_index(self, sp_type, ndim, path=None):
        # type: (str, int, ...) -> SimprintEngine
        return SimprintEngine(
            path if path is not None else self.path / f"SIMPRINT_{sp_type}",
            ndim=ndim,
            shard_size=self._opts.shard_size_simprints * 1024 * 1024,
            oversampling_factor=self._opts.oversampling_factor,
            device=self.device,
        )

    def _get_or_create_nphd_index(self, unit_type):
        # type: (str) -> DeviceNphdIndex
        if unit_type not in self._nphd_indexes:
            nphd_index = self._new_nphd_index(unit_type)
            if self._service is not None:
                if self._service.is_coordinator:
                    # Hook BEFORE first use: every device op on this index
                    # must fan out from call one (followers auto-create their
                    # replica through _resolve_replica on the first op).
                    self._service.hook(self._replica_name(unit_type), nphd_index)
                else:
                    nphd_index.save_enabled = False
            self._nphd_indexes[unit_type] = nphd_index
            logger.debug(f"Created NPHD index for unit_type '{unit_type}'")
        return self._nphd_indexes[unit_type]

    def _get_or_create_simprint_index(self, sp_type, ndim):
        # type: (str, int) -> SimprintEngine
        if sp_type not in self._simprint_indexes:
            self._simprint_indexes[sp_type] = self._new_simprint_index(sp_type, ndim)
            logger.debug(f"Created simprint index for type '{sp_type}' (ndim={ndim})")
        return self._simprint_indexes[sp_type]

    def _detect_sp_ndim(self, sp_type):
        # type: (str) -> int
        pairs = self.store.range_scan(_sp_db(sp_type), limit=1)
        return len(pairs[0][0]) * 8 if pairs else 128

    def _load_nphd_indexes(self):
        # type: () -> None
        """Load tracked NPHD indexes; warn (but keep) stale-count state."""
        for unit_type in self._tracked_types(b"nphd_count:"):
            shard_dir = self.path / unit_type
            try:
                nphd_index = self._new_nphd_index(unit_type) if shard_dir.exists() else None
                if nphd_index is None:
                    logger.warning(
                        f"NPHD index directory missing for '{unit_type}' - run an explicit rebuild."
                    )
                    continue
                # Never None: _tracked_types enumerates these very count keys,
                # so every unit_type reaching here has one by construction.
                expected = self._get_count(b"nphd_count:", unit_type)
                actual = nphd_index.size
                if expected != actual:
                    logger.warning(
                        f"NPHD index '{unit_type}' out of sync: expected {expected} vectors, found {actual}. "
                        f"Skipping auto-rebuild. Run 'iscc-search-tpu index rebuild --unit-type {unit_type}' "
                        f"(or '--all') to repair."
                    )
                self._nphd_indexes[unit_type] = nphd_index
                logger.info(f"Loaded NPHD index '{unit_type}': {actual} vectors, {nphd_index.shard_count} segments")
            except Exception as e:  # pragma: no cover
                logger.warning(f"Failed to load NPHD index '{unit_type}': {e}. Skipping.")

    def _load_simprint_indexes(self):
        # type: () -> None
        for sp_type in self._get_sp_types():
            sp_dir = self.path / f"SIMPRINT_{sp_type}"
            if not sp_dir.exists():
                logger.warning(
                    f"Simprint index directory missing for type '{sp_type}' - "
                    "searches of this type will be empty until an explicit rebuild is run."
                )
                continue
            try:
                sp_index = self._new_simprint_index(sp_type, self._detect_sp_ndim(sp_type))
                expected = self._get_count(b"sp_count:", sp_type)
                actual = sp_index.size
                if expected is not None and expected != actual:
                    logger.warning(
                        f"Simprint index '{sp_type}' out of sync: expected {expected}, found {actual}. "
                        f"Skipping auto-rebuild. Run 'iscc-search-tpu index rebuild --simprint-type {sp_type}' "
                        f"(or '--all') to repair."
                    )
                self._simprint_indexes[sp_type] = sp_index
                logger.info(f"Loaded simprint index '{sp_type}': {actual} vectors")
            except Exception as e:  # pragma: no cover
                logger.warning(f"Failed to load simprint index '{sp_type}': {e}. Skipping.")

    # -------------------------------------------------- idempotent no-op gates

    def _nphd_units_present(self, key, units):
        # type: (int, list[str] | None) -> bool
        """True when every similarity unit of the asset is in its derived index."""
        for unit_str in units or []:
            unit_type = IsccUnit(unit_str).unit_type
            if unit_type.startswith("INSTANCE_"):
                continue
            nphd_index = self._nphd_indexes.get(unit_type)
            if nphd_index is None or key not in nphd_index:
                return False
        return True

    @staticmethod
    def _simprint_fingerprint(simprints):
        # type: (list[IsccSimprint]) -> bytes
        """
        Order-independent 16-byte digest over one type's (simprint, offset,
        size) triples — the cheap equality witness for the no-op gate.
        """
        triples = sorted((ic.decode_base64(sp.simprint), sp.offset, sp.size) for sp in simprints)
        hasher = hashlib.blake2b(digest_size=TpuIndex.SP_FINGERPRINT_BYTES)
        for sp_bytes, offset, size in triples:
            hasher.update(struct.pack("!I", len(sp_bytes)))
            hasher.update(sp_bytes)
            hasher.update(struct.pack("!II", offset, size))
        return hasher.digest()

    def _simprints_already_indexed(self, iscc_id_body, asset, fingerprints):
        # type: (bytes, IsccEntry, dict[str, bytes]) -> bool
        """
        Subset semantics: every simprint type PRESENT in the incoming asset
        must be indexed identically (fingerprint match) AND its vectors must
        exist in the derived index (derived state commits after the store, so
        a crashed batch is retried, not skipped).
        """
        for sp_type, sp_list in (asset.simprints or {}).items():
            stored = self.store.get(_spa_db(sp_type), iscc_id_body)
            if stored is None or stored != fingerprints[sp_type]:
                return False
            sp_index = self._simprint_indexes.get(sp_type)
            if sp_index is None:
                return False
            for sp_obj in sp_list:
                ptr = sp_ops.pack_chunk_pointer(iscc_id_body, sp_obj.offset, sp_obj.size)
                if ptr not in sp_index:
                    return False
        return True
