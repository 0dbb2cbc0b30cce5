"""
Simprint engine: granular chunk-level similarity search on device (port of
``iscc_search_tpu/engine/simprint.py``; the code is the JAX package's but for
the ``device`` argument, ``max_sweep_queries`` and the port's spans,
``simprint.search`` and ``simprint.score``, in ``search_raw_many``).

Replaces the reference's HNSW-based UsearchSimprintIndex
(indexes/simprint/usearch_core.py). Chunks are stored in a
:class:`DeviceHammingIndex` keyed by 16-byte composite keys
(iscc_id_body + offset + size). Scoring parity with the reference
(usearch_core.py:137-269): per-query best match per asset, IDF weighting with
an unmatched-query penalty, configurable oversampling, chunk detail lists.

The exhaustive scan could compute the per-asset best directly, but the
reference's candidate-list semantics (oversample ``limit x factor`` per query,
then group) are kept so rankings match bit-for-bit; the scan makes the
candidate list exact instead of approximate.
"""

from __future__ import annotations

import time
from collections import defaultdict
from pathlib import Path

import numpy as np

from iscc_search_tpu_torch import tracing
from iscc_search_tpu_torch.engine import simprint_ops as ops
from iscc_search_tpu_torch.engine.device_index import DeviceHammingIndex


class SimprintEngine:
    """Per-type derived simprint index with IDF-weighted asset scoring."""

    def __init__(self, path, ndim=128, shard_size=512 * 1024 * 1024, oversampling_factor=20, device="cuda"):
        # type: (str | Path, int, int, int, str) -> None
        """
        :param device: torch device of the chunk index's partitions, "cuda"
            by default (nothing is auto-detected)
        """
        self.path = Path(path)
        self.ndim = ndim
        self.oversampling_factor = oversampling_factor
        self._index = DeviceHammingIndex(self.path, ndim=ndim, shard_size=shard_size, device=device)

    def relocate(self, path):
        # type: (str | Path) -> None
        """Point at a renamed directory (rebuild-aside swap); saves must be
        drained by the caller before the rename."""
        self.path = Path(path)
        self._index.path = self.path

    # -- mutation -------------------------------------------------------------

    def add_raw(self, composite_keys, vectors):
        # type: (list[bytes], list[bytes]) -> None
        """Add chunk vectors, deduplicating repeated keys (keep first)."""
        if not composite_keys:
            return
        seen = set()
        keys, vecs = [], []
        for k, v in zip(composite_keys, vectors):
            kb = bytes(k)
            if kb in seen:
                continue
            seen.add(kb)
            keys.append(kb)
            vecs.append(v)
        self._index.add(keys, vecs)

    def add_packed(self, keys, vectors):
        # type: (np.ndarray, np.ndarray) -> None
        """
        Bulk append of chunk vectors as arrays (rebuild / bulk-ingest path).

        Same contract as :meth:`PackedCodeIndex.add_packed`: keys must be
        new and unique (no per-row dedup) — satisfied by rebuild-from-truth
        and bulk loaders by construction.

        :param keys: (n, 16) uint8 composite keys (iscc_id_body+offset+size)
        :param vectors: (n, ndim // 8) uint8 simprint bytes
        """
        vectors = np.ascontiguousarray(vectors, dtype=np.uint8)
        n, nbytes = vectors.shape
        if nbytes != self.ndim // 8:
            raise ValueError(f"vectors must be (n, {self.ndim // 8}) uint8, got {vectors.shape}")
        # Big-endian lane packing, bit-exact with ops.packing.pack_codes.
        packed = vectors.reshape(n, nbytes // 4, 4).view(">u4")[..., 0].astype(np.uint32)
        self._index.add_packed(keys, packed, nbytes // 4)

    def remove(self, composite_keys):
        # type: (list[bytes]) -> None
        if composite_keys:
            self._index.remove(composite_keys)

    def __contains__(self, composite_key):
        # type: (bytes) -> bool
        return composite_key in self._index

    # -- search ----------------------------------------------------------------

    def search_raw(self, simprints, limit=10, threshold=0.0, detailed=False, doc_freq_fn=None, total_assets=0, sweep_fn=None):
        # type: (list[bytes], int, float, bool, ..., int, ...) -> list[ops.SimprintMatchRaw]
        """
        IDF-weighted asset-level search for ONE query asset's simprints.

        For each query simprint the scan returns the exact top
        ``limit * oversampling_factor`` chunks; results are grouped by asset
        (composite key prefix), the best match per (query, asset) kept, and
        asset scores computed as sum(idf_i * sim_i) / sum(all idf_i) with
        unmatched query simprints contributing idf * 0.0.

        :param sweep_fn: optional ``(bodies, count) -> [(keys, scores, rows)]``
            replacing the direct device sweep (cross-request batcher hook)
        """
        return self.search_raw_many(
            [simprints],
            limit=limit,
            threshold=threshold,
            detailed=detailed,
            doc_freq_fn=doc_freq_fn,
            total_assets=total_assets,
            sweep_fn=sweep_fn,
        )[0]

    #: Device sweep width cap. One sweep of Q chunk queries over the
    #: 100,000,000-chunk BASELINE config 4 on one 80 GB H100 holds: the
    #: resident 128-bit rows (capacity 112,525,312 x 16 B = 1.8 GB) and their
    #: validity (0.11 GB); the phase-1 block maxima, (Q, 879,104) f32 =
    #: 1.8 GB at Q=512; phases 2-3 at most ``hopper_scan.PHASE3_BUDGET_BYTES``
    #: (1 GiB) whatever the count, and at this count (200: 256 blocks per
    #: query) 0.5 GB; about 4.2 GB in all (peak 3.84 GiB measured by
    #: ``chip_smoke.py``). Memory would allow ~16x more, but the tensor-core
    #: phase 1 holds at most 512 queries in shared memory and reads the rows
    #: again for each 512 more, so a wider sweep saves no device time; larger
    #: fused batches split into consecutive sweeps.
    max_sweep_queries = 512

    def search_raw_many(self, queries, limit=10, threshold=0.0, detailed=False, doc_freq_fn=None, total_assets=0, sweep_fn=None):
        # type: (list[list[bytes]], int, float, bool, ..., int, ...) -> list[list[ops.SimprintMatchRaw]]
        """
        Batched :meth:`search_raw` over MANY query assets in fused device
        sweeps — all assets' chunk simprints concatenate into one scan (split
        at :attr:`max_sweep_queries`), then per-asset grouping/scoring runs on
        the segmented results (the reference's per-asset search unit,
        ``iscc_search/indexes/simprint/usearch_core.py:137-269``, without
        paying a sweep per asset).
        """
        if not queries:
            return []
        # Spans (iscc_search_tpu_torch.tracing): this request's root and one
        # "simprint.score" per query asset scored.
        root = tracing.start("simprint.search")
        try:
            if len(self._index) == 0:
                return [[] for _ in queries]
            count = max(1, limit * self.oversampling_factor)
            flat = [bytes(s) for q in queries for s in q]
            if not flat:
                return [[] for _ in queries]
            sweep = sweep_fn or (lambda bodies, c: self._index.search(bodies, c, return_rows=True))
            # Capture the row-space generation BEFORE the sweeps: a compact()
            # racing the search renumbers rows, and body_at() must then fall back
            # to query bytes instead of silently reading a different key's body.
            # (Capturing early is the safe direction — worst case an unnecessary
            # fallback, never a wrong read.)
            row_gen = getattr(self._index, "row_generation", None)
            batch_results = []  # type: list
            cap = self.max_sweep_queries
            for lo in range(0, len(flat), cap):
                batch_results.extend(sweep(flat[lo : lo + cap], count))
            out = []
            off = 0
            for q in queries:
                n = len(q)
                if n == 0:
                    out.append([])
                    continue
                t0 = time.perf_counter_ns() if root is not None else 0
                out.append(
                    self._score_query_asset(
                        q, batch_results[off : off + n], limit, threshold, detailed, doc_freq_fn, total_assets, row_gen
                    )
                )
                if root is not None:
                    tracing.add("simprint.score", t0, time.perf_counter_ns())
                off += n
            return out
        finally:
            if root is not None:
                tracing.stop(root, counts={"assets": len(queries)})

    def _score_query_asset(self, simprints, batch_results, limit, threshold, detailed, doc_freq_fn, total_assets, row_gen=None):
        # type: (list[bytes], list, int, float, bool, ..., int, int | None) -> list[ops.SimprintMatchRaw]
        """Group one query asset's per-chunk scan results by matched asset and
        compute IDF-weighted asset scores (reference scoring parity)."""
        # asset -> {query_idx: (offset, size, score, row)}
        asset_best = defaultdict(dict)  # type: dict[bytes, dict]
        for query_idx, (keys, scores, rows) in enumerate(batch_results):
            # Vectorized threshold cut: the per-candidate python loop below
            # only ever walks survivors (typically a handful of the
            # limit x oversampling candidates at production thresholds).
            for i in np.flatnonzero(np.asarray(scores) >= threshold).tolist():
                score = float(scores[i])
                raw_key = keys[i].tobytes()
                asset_id, offset, size = ops.unpack_chunk_pointer(raw_key)
                best = asset_best[asset_id].get(query_idx)
                if best is None or score > best[2]:
                    asset_best[asset_id][query_idx] = (offset, size, score, int(rows[i]))

        if not asset_best:
            return []

        # Matched vectors matter only for doc-frequency lookups and detailed
        # chunk output; without either, IDF is the same constant for every
        # simprint (freq == 1) and the fetch is skipped entirely. When they
        # ARE needed, body_at(row) is an O(1) array read — the per-candidate
        # get() it replaces built the full key->row map (~15 GB / minutes at
        # the 100M-chunk BASELINE config 4 scale; SURVEY §7 "doc-frequency
        # lookups during scoring").
        need_bytes = doc_freq_fn is not None or detailed
        freq_cache = {}  # type: dict[bytes, int]

        def get_freq(sp_key):
            # type: (bytes) -> int
            if sp_key not in freq_cache:
                freq_cache[sp_key] = doc_freq_fn(sp_key) if doc_freq_fn is not None else 1
            return freq_cache[sp_key]

        results = []
        for asset_id, best_per_query in asset_best.items():
            total_idf = 0.0
            weighted_sim = 0.0
            match_cache = {}  # type: dict[int, bytes]  # query_idx -> match bytes
            for query_idx, (offset, size, sim, row) in best_per_query.items():
                if need_bytes:
                    stored = self._index.body_at(row, row_gen)
                    match_bytes = stored if stored is not None else bytes(simprints[query_idx])
                    match_cache[query_idx] = match_bytes
                    idf = ops.calculate_idf(get_freq(match_bytes), total_assets)
                else:
                    idf = ops.calculate_idf(1, total_assets)
                total_idf += idf
                weighted_sim += idf * sim
            for qi in range(len(simprints)):
                if qi not in best_per_query:
                    freq = get_freq(bytes(simprints[qi])) if need_bytes else 1
                    total_idf += ops.calculate_idf(freq, total_assets)

            asset_score = weighted_sim / total_idf if total_idf > 0 else 0.0

            chunks = None
            if detailed:
                chunks = []
                for query_idx, (offset, size, sim, row) in best_per_query.items():
                    match_bytes = match_cache[query_idx]  # fetched in the scoring loop
                    chunks.append(
                        ops.MatchedChunkRaw(
                            query=bytes(simprints[query_idx]),
                            match=match_bytes,
                            score=sim,
                            offset=offset,
                            size=size,
                            freq=get_freq(match_bytes),
                        )
                    )

            results.append(
                ops.SimprintMatchRaw(
                    iscc_id_body=asset_id,
                    score=asset_score,
                    queried=len(simprints),
                    matches=len(best_per_query),
                    chunks=chunks,
                )
            )

        results.sort(key=lambda x: (-x.score, x.iscc_id_body))
        return results[:limit]

    # -- lifecycle / stats -------------------------------------------------------

    @property
    def dirty(self):
        # type: () -> int
        return self._index.dirty

    @property
    def size(self):
        # type: () -> int
        return self._index.size

    @property
    def shard_count(self):
        # type: () -> int
        return self._index.shard_count

    @property
    def data_size(self):
        # type: () -> int
        """On-disk + unflushed serialized bytes (monitoring)."""
        disk = sum(f.stat().st_size for f in self.path.glob("*") if f.is_file()) if self.path.exists() else 0
        return max(disk, self._index.serialized_length)

    def save(self, wait=True):
        # type: (bool) -> None
        """Persist derived state; ``wait=False`` queues the write on the
        underlying index's background save worker (auto-flush path)."""
        self._index.save(wait=wait)

    def reset(self):
        # type: () -> None
        self._index.reset()

    def drain_rotations(self):
        # type: () -> None
        self._index.drain_rotations()

    def close(self):
        # type: () -> None
        self._index.close()
