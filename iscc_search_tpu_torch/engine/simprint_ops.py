"""
A copy of ``iscc_search_tpu/engine/simprint_ops.py`` (the port imports nothing of the JAX package);
``tests/test_torch_host_copies.py`` holds every function of it to the
original's bytecode, the package name aside.

Pure simprint operations: chunk pointers, IDF, coverage x quality scoring,
and exact hard-boundary search over the host store.

Functional parity with the reference's stateless simprint layer
(iscc_search/indexes/simprint/lmdb_ops.py): 16-byte chunk pointers
(lmdb_ops.py:30-64), smooth IDF log(1 + N/(1+freq)) (lmdb_ops.py:67-81),
doc-frequency counting with a dup scan cap (lmdb_ops.py:139-166), and the
exact coverage x quality search (lmdb_ops.py:169-301). Storage calls go to
the native HostStore instead of LMDB cursors.
"""

from __future__ import annotations

import math
import struct
from collections import defaultdict
from dataclasses import dataclass
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from iscc_search_tpu_torch.store import HostStore  # noqa: F401

CHUNK_POINTER_BYTES = 16
MAX_OFFSET = 2**32 - 1
MAX_SIZE = 2**32 - 1
DOC_FREQ_CAP = 1000  # safety cap on dup scans per simprint key


@dataclass(frozen=True)
class MatchedChunkRaw:
    """Raw (bytes-level) matched chunk."""

    query: bytes
    match: bytes
    score: float
    offset: int
    size: int
    freq: int


@dataclass(frozen=True)
class SimprintMatchRaw:
    """Raw per-asset match for one simprint type."""

    iscc_id_body: bytes
    score: float
    queried: int
    matches: int
    chunks: list | None = None


@dataclass(frozen=True)
class TypeMatchResult:
    """Per-type stats carried into the multi-type aggregate."""

    score: float
    queried: int
    matches: int
    chunks: list | None = None


@dataclass(frozen=True)
class SimprintMatchMulti:
    """Cross-type aggregated match for one asset."""

    iscc_id: bytes  # full 10-byte ISCC-ID digest
    score: float
    types: dict


def pack_chunk_pointer(iscc_id_body, offset, size):
    # type: (bytes, int, int) -> bytes
    """Pack iscc_id_body(8) + offset(4) + size(4), big-endian."""
    if len(iscc_id_body) != 8:
        raise ValueError(f"ISCC-ID body must be 8 bytes, got {len(iscc_id_body)}")
    if offset > MAX_OFFSET:
        raise ValueError(f"Offset {offset} exceeds max {MAX_OFFSET}")
    if size > MAX_SIZE:
        raise ValueError(f"Size {size} exceeds max {MAX_SIZE}")
    return iscc_id_body + struct.pack("!II", offset, size)


def unpack_chunk_pointer(data):
    # type: (bytes) -> tuple[bytes, int, int]
    """Inverse of pack_chunk_pointer."""
    if len(data) != CHUNK_POINTER_BYTES:
        raise ValueError(f"Expected {CHUNK_POINTER_BYTES} bytes, got {len(data)}")
    offset, size = struct.unpack("!II", data[8:16])
    return data[:8], offset, size


def calculate_idf(freq, total_assets):
    # type: (int, int) -> float
    """Smooth IDF: log(1 + total_assets / (1 + freq)); 0.0 for empty corpora."""
    if total_assets <= 0:
        return 0.0
    return math.log(1 + total_assets / (1 + freq))


def count_doc_freq(store, db, simprint_key, dup_limit=DOC_FREQ_CAP):
    # type: (HostStore, str, bytes, int) -> int
    """Distinct assets holding a simprint (scan capped at dup_limit values).

    Floor 1: a concurrent update can delete the store rows between the
    device scan (which matched the simprint) and this lookup — a zero here
    would fail the wire schema's freq >= 1 and 500 the whole search for a
    benign race; the matched chunk itself proves at least one holder."""
    values = store.get_dups(db, simprint_key, limit=dup_limit)
    return max(1, len({v[:8] for v in values}))


def pack_inverse_entry(sp_bytes, offset, size):
    # type: (bytes, int, int) -> bytes
    """Per-asset inverse row: simprint bytes + offset(4) + size(4)."""
    return sp_bytes + struct.pack("!II", offset, size)


def unpack_inverse_entry(data):
    # type: (bytes) -> tuple[bytes, int, int]
    """Inverse of pack_inverse_entry (simprint length = len - 8)."""
    offset, size = struct.unpack("!II", data[-8:])
    return data[:-8], offset, size


def _asset_pairs(store, db, iscc_id_body, inv_db=None, trust_inverse=False):
    # type: (HostStore, str, bytes, str | None, bool) -> list[tuple[bytes, bytes]]
    """
    All (simprint_key, chunk_pointer) pairs of one asset.

    Fast path: the per-asset inverse db (``inv_db``) holds the asset's own
    rows under one dupsort key, making the lookup O(asset's chunks). With
    ``trust_inverse`` an EMPTY inverse result is authoritative (the store
    has always maintained the inverse db for this type — e.g. the asset's
    simprint list was empty); without it, empty falls back to a bounded-page
    stream over the whole forward db (legacy stores, never one giant buffer).
    """
    if inv_db is not None:
        entries = store.get_dups(inv_db, iscc_id_body)
        if entries or trust_inverse:
            pairs = []
            for entry in entries:
                sp, offset, size = unpack_inverse_entry(entry)
                pairs.append((sp, pack_chunk_pointer(iscc_id_body, offset, size)))
            return pairs
    return [(key, val) for key, val in store.iter_range(db) if val[:8] == iscc_id_body]


def read_asset_simprints(store, db, iscc_id_body, inv_db=None, trust_inverse=False):
    # type: (HostStore, str, bytes, str | None, bool) -> set[tuple[bytes, int, int]]
    """All (simprint, offset, size) triples stored for one asset."""
    triples = set()
    for key, val in _asset_pairs(store, db, iscc_id_body, inv_db, trust_inverse):
        _, offset, size = unpack_chunk_pointer(val)
        triples.add((key, offset, size))
    return triples


def delete_asset_simprints(store, db, iscc_id_body, inv_db=None, trust_inverse=False):
    # type: (HostStore, str, bytes, str | None, bool) -> list[bytes]
    """Remove all of an asset's chunk pointers; returns deleted pointers.

    Collect-then-delete, deliberately: every matching pair is gathered FIRST
    and deleted only after collection finishes — deleting during a paged scan
    would invalidate the (key, value) continuation and could skip entries.
    Memory is bounded by the asset's own pointer count, not the database size.
    """
    deleted = _asset_pairs(store, db, iscc_id_body, inv_db, trust_inverse)
    for key, val in deleted:
        store.dup_delete(db, key, val)
    if inv_db is not None:
        store.delete(inv_db, iscc_id_body)
    return [val for _, val in deleted]


def coverage_quality_score(matches, doc_frequencies, num_queried):
    # type: (list[tuple[bytes, bytes, int, int]], dict[bytes, int], int) -> float
    """
    Score = coverage x quality for an asset's exact matches.

    Coverage: fraction of unique query simprints matched. Quality: min-max
    normalized inverse document frequency within the match set (single or
    uniform frequency sets score quality 1.0) — formula parity with the
    reference (lmdb_ops.py:253-301).
    """
    if not matches:
        return 0.0
    best_freq = {}  # type: dict[bytes, int]
    for query_sp, match_sp, _, _ in matches:
        freq = doc_frequencies.get(match_sp, 1)
        prev = best_freq.get(query_sp)
        best_freq[query_sp] = freq if prev is None else min(prev, freq)

    coverage = len(best_freq) / num_queried
    freqs = list(best_freq.values())
    if len(freqs) == 1 or min(freqs) == max(freqs):
        quality = 1.0
    else:
        max_inv = 1.0 / min(freqs)
        min_inv = 1.0 / max(freqs)
        quality = sum((1.0 / f - min_inv) / (max_inv - min_inv) for f in freqs) / len(freqs)
    return coverage * quality


def search_simprints_exact(store, db, query_simprints, limit, threshold, detailed, dup_limit=DOC_FREQ_CAP):
    # type: (HostStore, str, list[bytes], int, float, bool, int) -> list[SimprintMatchRaw]
    """
    Hard-boundary exact search: collision lookup per query simprint, grouped
    by asset, scored coverage x quality, sorted (-score, asset id).
    """
    if not query_simprints:
        return []

    asset_matches = defaultdict(list)  # type: dict[bytes, list]
    simprint_to_assets = defaultdict(set)  # type: dict[bytes, set]

    for sp in query_simprints:
        for val in store.get_dups(db, sp, limit=dup_limit):
            body, offset, size = unpack_chunk_pointer(val)
            asset_matches[body].append((sp, sp, offset, size))
            simprint_to_assets[sp].add(body)

    doc_frequencies = {sp: len(assets) for sp, assets in simprint_to_assets.items()}
    num_queried = len(query_simprints)

    results = []
    for body, matches in asset_matches.items():
        score = coverage_quality_score(matches, doc_frequencies, num_queried)
        if score < threshold:
            continue
        chunks = None
        if detailed:
            chunks = [
                MatchedChunkRaw(
                    query=q, match=m, score=1.0, offset=o, size=s, freq=doc_frequencies.get(m, 1)
                )
                for q, m, o, s in matches
            ]
        results.append(
            SimprintMatchRaw(iscc_id_body=body, score=score, queried=num_queried, matches=len(matches), chunks=chunks)
        )
    results.sort(key=lambda x: (-x.score, x.iscc_id_body))
    return results[:limit]


def iter_simprint_vectors(store, db, batch_size=100_000):
    # type: (HostStore, str, int) -> ...
    """Yield (composite_keys, vectors) batches for derived-index rebuild.

    Streamed in bounded pages; peak memory is one batch, not the database.
    """
    keys, vectors = [], []
    for sp_bytes, chunk_ptr in store.iter_range(db, batch=batch_size):
        keys.append(chunk_ptr)
        vectors.append(sp_bytes)
        if len(keys) >= batch_size:
            yield keys, vectors
            keys, vectors = [], []
    if keys:
        yield keys, vectors
