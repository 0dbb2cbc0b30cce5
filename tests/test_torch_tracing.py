"""The port's spans (``iscc_search_tpu_torch.tracing``) on the CPU: when they
record, what a search, a batched search and a chunk search record, and the
ring's bound. No timing thresholds: only order, nesting, ids and counts."""

import threading

import numpy as np
import pytest
import torch

from iscc_search_tpu_torch import tracing
from iscc_search_tpu_torch.engine import DeviceNphdIndex
from iscc_search_tpu_torch.engine import device_index as di
from iscc_search_tpu_torch.engine.batcher import SearchBatcher
from iscc_search_tpu_torch.engine.simprint import SimprintEngine
from iscc_search_tpu_torch.ops.nphd import NEG_SCORE
from iscc_search_tpu_torch.server import metrics

NAME, T0, T1, ID, PARENT, REQUEST, THREAD, COUNTS = range(8)
CHILDREN = ["search.prepare", "search.launch", "search.wait", "search.merge"]
# live rows per code length (lanes): one partition holds fewer than K
LIVE = {2: 300, 4: 250, 8: 6}
K = 10


@pytest.fixture(autouse=True)
def recorder():
    """Nothing recorded before a test, recording off after it."""
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(3)
    lanes = np.concatenate([np.full(n + n // 3, lv, np.int32) for lv, n in LIVE.items()])
    n = len(lanes)
    codes = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    codes[np.arange(8)[None, :] >= lanes[:, None]] = 0
    valid = np.ones(n, bool)
    start = 0
    for lv, live in LIVE.items():  # the last third of each length's rows removed
        valid[start + live : start + live + live // 3] = False
        start += live + live // 3
    keys = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    idx = DeviceNphdIndex.from_arrays(keys, codes, lanes, valid, device="cpu")
    idx.search([codes[0, :2].astype(">u4").tobytes()], K)  # the partitions built
    return idx


def queries(nq, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2**32, lv, dtype=np.uint32).astype(">u4").tobytes()
            for lv in rng.choice(list(LIVE), nq)]


def records():
    got, dropped = tracing.snapshot()
    assert dropped == 0
    return got


def test_nothing_is_recorded_while_off(index, monkeypatch):
    class NoClock:
        def perf_counter_ns(self):
            raise AssertionError("a span site read the clock while nothing records")

    monkeypatch.setattr(di, "time", NoClock())  # the engine's only use of the clock is its spans
    assert not tracing.recording() and tracing.start("search") is None
    index.search(queries(5), K)
    assert records() == []


def test_enable_and_disable(index):
    tracing.enable()
    assert tracing.recording()
    index.search(queries(3), K)
    n = len(records())
    assert n == 5
    tracing.disable()
    index.search(queries(3), K)
    assert len(records()) == n


def test_a_profiler_session_turns_recording_on_and_off(index):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.recording()
        index.search(queries(3), K)
    assert not tracing.recording()
    index.search(queries(3), K)
    assert [r[NAME] for r in records()] == CHILDREN + ["search"]


def test_a_search_records_its_root_and_four_children_in_order(index):
    qs = queries(7)
    tracing.enable()
    out = index.search(qs, K)
    got = records()
    (root,) = [r for r in got if r[NAME] == "search"]
    kids = [r for r in got if r[PARENT] == root[ID]]
    assert [r[NAME] for r in kids] == CHILDREN and len(got) == 5
    assert root[PARENT] is None and root[COUNTS] == {"queries": len(qs)}
    assert {r[REQUEST] for r in got} == {root[REQUEST]} and {r[THREAD] for r in got} == {threading.get_ident()}
    edges = [root[T0]] + [t for r in kids for t in (r[T0], r[T1])] + [root[T1]]
    assert edges == sorted(edges)  # nested in the root, one after the other
    # Every query gets min(K, live rows) candidates from each partition.
    assert kids[-1][COUNTS] == {"candidates": len(qs) * sum(min(K, live) for live in LIVE.values())}
    assert [len(keys) for keys, _ in out] == [K] * len(qs)


def test_the_merge_counts_the_valid_slots_it_merges(index, monkeypatch):
    """search.merge's candidates are the valid slots (row >= 0) of every
    partition's first K columns, with a query that has none."""
    scan, valid_slots = di.blockmax_topk_packedq_impl, []

    def scan_without_query_0(*args, **kwargs):
        scores, rows = (t.clone() for t in scan(*args, **kwargs))
        scores[0], rows[0] = NEG_SCORE, -1
        valid_slots.append(int(torch.count_nonzero(rows[:, :K] >= 0)))
        return scores, rows

    monkeypatch.setattr(di, "blockmax_topk_packedq_impl", scan_without_query_0)
    tracing.enable()
    out = index.search(queries(6), K)
    (merge,) = [r for r in records() if r[NAME] == "search.merge"]
    assert len(valid_slots) == len(LIVE) and merge[COUNTS] == {"candidates": sum(valid_slots)}
    assert sum(valid_slots) == 5 * sum(min(K, live) for live in LIVE.values())
    assert [len(keys) for keys, _ in out] == [0] + [K] * 5


def test_a_failing_search_closes_its_span(index, monkeypatch):
    def fail(*args, **kwargs):
        raise RuntimeError("scan failed")

    monkeypatch.setattr(di, "blockmax_topk_packedq_impl", fail)
    tracing.enable()
    with pytest.raises(RuntimeError, match="scan failed"):
        index.search(queries(2), K)
    # search.launch is an open span (the mesh's spans nest under it), closed
    # like search itself when a scan raises.
    assert [r[NAME] for r in records()] == ["search.prepare", "search.launch", "search"]
    tracing.add("after", 1, 2)
    assert records()[-1][PARENT] is None  # the thread's stack is empty again


def test_a_batched_search_is_one_request_across_threads(index):
    batcher = SearchBatcher(index, max_batch=64, window_ms=0.0)
    qs = queries(4)
    sweeps0, seconds0 = metrics.sweep_seconds._totals.get((), 0), metrics.sweep_seconds._sums.get((), 0.0)
    tracing.enable()
    result = []
    client = threading.Thread(target=lambda: result.append(batcher.search(qs, K)))
    client.start()
    client.join(60)
    assert not client.is_alive() and len(result[0]) == len(qs)
    tracing.disable()
    batcher.close()
    got = {r[NAME]: r for r in records()}
    assert set(got) == {"batcher.queue", "batcher.sweep", "batcher.handoff", "search"} | set(CHILDREN)
    assert len({r[REQUEST] for r in got.values()}) == 1
    queue, sweep, handoff, root = (got[n] for n in ("batcher.queue", "batcher.sweep", "batcher.handoff", "search"))
    assert queue[THREAD] == handoff[THREAD] == client.ident != sweep[THREAD] == root[THREAD]
    assert root[PARENT] == sweep[ID] and sweep[COUNTS] == {"queries": len(qs), "served": [queue[REQUEST]]}
    assert queue[T1] == sweep[T0] <= root[T0] <= root[T1] <= sweep[T1] == handoff[T0] <= handoff[T1]
    # The sweep span's two clock reads are the histogram's.
    assert metrics.sweep_seconds._totals[()] == sweeps0 + 1
    assert metrics.sweep_seconds._sums[()] - seconds0 == pytest.approx((sweep[T1] - sweep[T0]) / 1e9, abs=1e-9)


def test_a_fused_sweep_lists_every_request_it_serves(index):
    batcher = SearchBatcher(index, max_batch=64, window_ms=200.0)
    tracing.enable()
    clients = [threading.Thread(target=batcher.search, args=(queries(2, seed), K)) for seed in range(3)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(60)
    assert not any(c.is_alive() for c in clients)
    tracing.disable()
    batcher.close()
    got = records()
    queues = {r[REQUEST] for r in got if r[NAME] == "batcher.queue"}
    served = [i for r in got if r[NAME] == "batcher.sweep" for i in r[COUNTS]["served"]]
    assert len(queues) == 3 and sorted(served) == sorted(queues)


def test_a_chunk_search_scores_each_query_asset_in_a_span(tmp_path):
    rng = np.random.default_rng(4)
    engine = SimprintEngine(tmp_path / "sp", ndim=64, device="cpu")
    n = 40
    keys = np.zeros((n, 16), np.uint8)
    keys[:, 7] = np.arange(n) // 4  # 10 assets of 4 chunks
    keys[:, 11] = np.arange(n) % 4
    vectors = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    engine.add_packed(keys, vectors)
    assets = [[vectors[i].tobytes() for i in range(a * 4, a * 4 + 4)] for a in (1, 5, 7)] + [[]]
    tracing.enable()
    out = engine.search_raw_many(assets, limit=3, threshold=0.5)
    got = records()
    assert [len(m) > 0 for m in out] == [True, True, True, False]
    (root,) = [r for r in got if r[NAME] == "simprint.search"]
    scores = [r for r in got if r[NAME] == "simprint.score"]
    assert root[COUNTS] == {"assets": 4} and len(scores) == 3  # the empty asset is not scored
    assert all(r[PARENT] == root[ID] and root[T0] <= r[T0] <= r[T1] <= root[T1] for r in scores)
    (sweep,) = [r for r in got if r[NAME] == "search"]
    assert sweep[PARENT] == root[ID] and {r[REQUEST] for r in got} == {root[REQUEST]}
    engine.close()


def test_the_ring_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "RING", 4)
    tracing.clear()
    tracing.enable()
    for i in range(10):
        tracing.stop(tracing.start(f"s{i}"))
    got, dropped = tracing.snapshot()
    assert [r[NAME] for r in got] == ["s6", "s7", "s8", "s9"] and dropped == 6
    tracing.clear()
    assert tracing.snapshot() == ([], 0)


def test_spans_nest_on_their_own_thread():
    tracing.enable()
    outer = tracing.start("outer")
    inner = tracing.start("inner")
    other = []
    worker = threading.Thread(target=lambda: other.append(tracing.start("other")) or tracing.stop(other[0]))
    worker.start()
    worker.join(10)
    tracing.stop(inner)
    tracing.stop(outer)
    got = {r[NAME]: r for r in records()}
    assert got["inner"][PARENT] == got["outer"][ID] and got["inner"][REQUEST] == got["outer"][REQUEST]
    assert got["other"][PARENT] is None and got["other"][REQUEST] != got["outer"][REQUEST]
    assert tracing.request_id() not in {r[REQUEST] for r in got.values()}  # no span open: a new request


def test_recording_reads_the_profilers_flag_at_every_call(monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    assert tracing.recording()
    span = tracing.start("x")
    assert span is not None
    tracing.stop(span)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", False)
    assert not tracing.recording()
