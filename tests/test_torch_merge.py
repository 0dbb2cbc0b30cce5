"""The host merge of ``PackedCodeIndex.search`` (``_collect_results``) on the
CPU, held array for array to the per-query merge it replaced: the same keys,
float32 scores and rows, in the same order (ties included), with the same
dtypes and shapes.

Each case searches a real index. A spy on ``_collect_results`` hands the
partitions' readbacks to both the engine's merge and :func:`reference_merge`;
some cases reshape the scan's output on the way (partitions of different
widths, queries with no valid candidate)."""

import numpy as np
import pytest
import torch

from iscc_search_tpu_torch.engine import DeviceHammingIndex, DeviceNphdIndex
from iscc_search_tpu_torch.engine import device_index as di
from iscc_search_tpu_torch.ops.nphd import NEG_SCORE

# live rows per code length (lanes); the 8-lane partition holds fewer than K
LIVE = {2: 300, 3: 40, 4: 150, 8: 6}
K = 10
# A few lane values only, so equal scores are common within and across partitions.
ALPHABET = np.array([0, 0xFFFF0000, 0x0F0F0F0F, 0x12345678], np.uint32)


def reference_merge(host, nq, count, keys_snapshot, return_rows):
    """The per-query merge: each query's valid candidates of every
    partition, concatenated in partition order, one stable sort each."""
    cand_scores = [[] for _ in range(nq)]
    cand_rows = [[] for _ in range(nq)]
    for row_map, scores, idx in host:
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


def _codes(rng, n, lanes):
    codes = ALPHABET[rng.integers(0, len(ALPHABET), (n, 8))]
    codes[np.arange(8)[None, :] >= lanes[:, None]] = 0
    return codes


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(11)
    built = {}
    # NPHD, four partitions: a third more rows than live, the extra removed.
    lanes = np.concatenate([np.full(n + n // 3, lv, np.int32) for lv, n in LIVE.items()])
    rng.shuffle(lanes)
    n = len(lanes)
    valid = np.ones(n, bool)
    for lv, live in LIVE.items():
        valid[np.flatnonzero(lanes == lv)[live:]] = False
    keys = rng.permutation(n).astype(">u8").view(np.uint8).reshape(n, 8)
    built["nphd4"] = DeviceNphdIndex.from_arrays(keys, _codes(rng, n, lanes), lanes, valid, device="cpu")
    # NPHD, one partition.
    n = 500
    lanes = np.full(n, 2, np.int32)
    keys = rng.permutation(n).astype(">u8").view(np.uint8).reshape(n, 8)
    built["nphd1"] = DeviceNphdIndex.from_arrays(keys, _codes(rng, n, lanes), lanes, rng.random(n) > 0.1,
                                                 device="cpu")
    # Hamming, 64 bits, 16-byte keys: always one partition.
    n = 700
    lanes = np.full(n, 2, np.int32)
    keys = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    built["hamming"] = DeviceHammingIndex.from_arrays(keys, _codes(rng, n, lanes), lanes, rng.random(n) > 0.1,
                                                      path=None, ndim=64, device="cpu")
    return built


def _queries(index, nq, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, index._rows, nq)
    return [index._codes[r, : index._nlanes[r]].astype(">u4").tobytes() for r in rows]


def _ragged(scores, rows, j):
    """Partition j keeps its first K - 3j columns."""
    w = max(1, K - 3 * j)
    return scores[:, :w], rows[:, :w]


def _empty(scores, rows, j):
    """The first and the last query find no valid candidate."""
    scores, rows = scores.clone(), rows.clone()
    for q in (0, -1):
        scores[q], rows[q] = NEG_SCORE, -1
    return scores, rows


# name: (index, queries, count, return_rows, what the scan's output goes through)
CASES = {
    "nphd-four-partitions-nq1": ("nphd4", 1, K, True, None),
    "nphd-four-partitions-nq512": ("nphd4", 512, K, False, None),
    "nphd-four-partitions-rows": ("nphd4", 33, K, True, None),
    "nphd-one-partition-nq512": ("nphd1", 512, K, True, None),
    "nphd-one-partition-nq1": ("nphd1", 1, K, False, None),
    "nphd-ragged-widths": ("nphd4", 20, K, True, _ragged),
    "nphd-no-valid-candidate": ("nphd4", 9, K, False, _empty),
    "nphd-count-above-columns": ("nphd4", 3, 9000, True, None),
    "hamming-nq512": ("hamming", 512, 40, True, None),
    "hamming-nq1": ("hamming", 1, 40, False, None),
    "hamming-no-valid-candidate": ("hamming", 5, 40, True, _empty),
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_batched_merge_matches_the_per_query_merge(indexes, monkeypatch, case):
    kind, nq, count, return_rows, reshape = CASES[case]
    index = indexes[kind]
    if reshape is not None:
        scan, calls = di.blockmax_topk_packedq_impl, []

        def reshaped_scan(*args, **kwargs):
            calls.append(None)
            return reshape(*scan(*args, **kwargs), len(calls) - 1)

        monkeypatch.setattr(di, "blockmax_topk_packedq_impl", reshaped_scan)
    merge, seen = index._collect_results, []

    def spy(pending, nq_, count_, keys_snapshot, return_rows_, span=None):
        host = [(rm.copy(), s[:, :count_].numpy().copy(), i[:, :count_].numpy().copy()) for rm, s, i in pending]
        seen.append((host, reference_merge(host, nq_, count_, keys_snapshot.copy(), return_rows_)))
        return merge(pending, nq_, count_, keys_snapshot, return_rows_, span)

    monkeypatch.setattr(index, "_collect_results", spy)
    got = index.search(_queries(index, nq, seed=nq + count), count, return_rows=return_rows)
    ((host, want),) = seen
    assert len(got) == len(want) == nq
    for g, w in zip(got, want):
        assert len(g) == len(w) == (3 if return_rows else 2)
        for ga, wa in zip(g, w):
            assert ga.dtype == wa.dtype and ga.shape == wa.shape
            np.testing.assert_array_equal(ga, wa)
        assert g[0].shape[1:] == (index.key_bytes,) and g[1].dtype == np.float32

    # Each case holds what its name says.
    widths = [s.shape[1] for _, s, _ in host]
    lengths = [len(g[1]) for g in got]
    assert len(host) == (4 if kind == "nphd4" else 1)
    if reshape is _ragged:
        assert len(set(widths)) == len(widths)
    if reshape is _empty:
        assert lengths[0] == lengths[-1] == 0 and max(lengths) > 0
    if case == "nphd-count-above-columns":
        assert max(widths) < count and any((i < 0).any() for _, _, i in host)
    if kind == "nphd4":
        if reshape is None:  # the 8-lane partition's NEG_SCORE / -1 tail
            assert (host[-1][2] < 0).any()
        # Equal scores across partitions among one query's candidates.
        ties = [
            len(np.intersect1d(a[q][ia[q] >= 0], b[q][ib[q] >= 0])) > 0
            for q in range(nq)
            for x, (_, a, ia) in enumerate(host)
            for _, b, ib in host[x + 1:]
        ]
        assert any(ties)
    if kind == "hamming":
        assert max(len(np.unique(g[1])) < len(g[1]) for g in got)  # equal scores within a partition


def test_the_merge_returns_copies_of_the_readback(indexes, monkeypatch):
    """Nothing of the result aliases the scan's output or the readback
    buffers, which are freed (or reused) once the merge returns."""
    index = indexes["nphd4"]
    scan, outputs = di.blockmax_topk_packedq_impl, []

    def recording_scan(*args, **kwargs):
        outputs.extend(scan(*args, **kwargs))
        return outputs[-2:]

    monkeypatch.setattr(di, "blockmax_topk_packedq_impl", recording_scan)
    got = index.search(_queries(index, 6, seed=2), K, return_rows=True)
    for t in outputs:
        assert isinstance(t, torch.Tensor)
        for res in got:
            assert not any(np.shares_memory(a, t.numpy()) for a in res)
    assert not any(np.shares_memory(a, index._keys) for res in got for a in res)
