"""The mesh's spans (``mesh.scan``, ``mesh.merge``) on the CPU: a search of
a ``DeviceNphdIndex`` row-sharded over four CPU shards records one
``mesh.scan`` per shard and partition and one ``mesh.merge`` per partition,
under ``search.launch``, with their counts; a single-device index records
neither; recording changes no answer. No timing thresholds."""

import numpy as np
import pytest
import torch

from iscc_search_tpu_torch import tracing
from iscc_search_tpu_torch.engine import DeviceNphdIndex
from iscc_search_tpu_torch.engine import device_index as di
from iscc_search_tpu_torch.parallel import make_mesh, shard_database, sharded_topk
from iscc_search_tpu_torch.parallel import merge as merge_mod
from iscc_search_tpu_torch.parallel.pm1_sharded import shard_pm1_database, sharded_pm1_topk

NAME, T0, T1, ID, PARENT, REQUEST, THREAD, COUNTS = range(8)
SHARDS = 4
K = 10
SHARD_K = 16  # the per-shard scan's k for K results: the next power of two
LIVE = {2: 300, 4: 250, 8: 40}  # rows per code length (lanes)


@pytest.fixture(autouse=True)
def recorder():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def arrays():
    rng = np.random.default_rng(5)
    lanes = np.concatenate([np.full(n, lv, np.int32) for lv, n in LIVE.items()])
    n = len(lanes)
    codes = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    codes[np.arange(8)[None, :] >= lanes[:, None]] = 0
    valid = np.ones(n, bool)
    valid[::7] = False
    keys = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    return keys, codes, lanes, valid


def make_index(mesh=True, scan_kernel="auto"):
    idx = DeviceNphdIndex.from_arrays(*arrays(), device="cpu", scan_kernel=scan_kernel,
                                      mesh=make_mesh(SHARDS, device="cpu") if mesh else None)
    idx.search(queries(1), K)  # the partitions built
    return idx


def queries(nq, seed=9):
    rng = np.random.default_rng(seed)
    _, codes, lanes, _ = arrays()
    pick = rng.integers(0, len(lanes), nq)
    return [codes[i, : lanes[i]].astype(">u4").tobytes() for i in pick]


def records():
    got, dropped = tracing.snapshot()
    assert dropped == 0
    return got


def shard_rows(idx):
    """{lanes: rows of one shard} of the index's partitions."""
    return {lanes: p.cap // SHARDS for lanes, p in idx._partitions.items()}


@pytest.mark.parametrize("scan_kernel", ["auto", "pallas"])
def test_a_mesh_search_records_its_shards_and_merges_under_launch(scan_kernel):
    idx = make_index(scan_kernel=scan_kernel)
    if scan_kernel == "pallas":  # the twin route: every partition has its int8 twin per shard
        assert all(p.unpacked_dev is not None for p in idx._partitions.values())
    nq = 5
    tracing.enable()
    idx.search(queries(nq), K)
    got = records()
    (root,) = [r for r in got if r[NAME] == "search"]
    (launch,) = [r for r in got if r[NAME] == "search.launch"]
    assert launch[PARENT] == root[ID]
    mesh_spans = [r for r in got if r[NAME].startswith("mesh.")]
    assert mesh_spans and all(r[PARENT] == launch[ID] and r[REQUEST] == root[REQUEST] for r in mesh_spans)
    assert all(launch[T0] <= r[T0] <= r[T1] <= launch[T1] for r in mesh_spans)
    # Per partition, in lane order: one scan per shard, then one merge.
    rows = shard_rows(idx)
    want = []
    for lanes in sorted(rows):
        want += [("mesh.scan", {"shard": s, "rows": rows[lanes]}) for s in range(SHARDS)]
        want.append(("mesh.merge", {"candidates": SHARDS * nq * SHARD_K, "bytes": 0}))  # one device: nothing moves
    assert [(r[NAME], r[COUNTS]) for r in sorted(mesh_spans, key=lambda r: r[T0])] == want
    assert [r[NAME] for r in got] == ["search.prepare"] + [n for n, _ in want] + ["search.launch", "search.wait",
                                                                                   "search.merge", "search"]


def test_a_single_device_index_records_no_mesh_span():
    idx = make_index(mesh=False)
    tracing.enable()
    idx.search(queries(5), K)
    got = records()
    assert [r[NAME] for r in got] == ["search.prepare", "search.launch", "search.wait", "search.merge", "search"]


@pytest.mark.parametrize("scan_kernel", ["auto", "pallas"])
def test_recording_changes_no_answer(scan_kernel):
    idx = make_index(scan_kernel=scan_kernel)
    bodies = queries(12, seed=3)
    off = idx.search(bodies, K, return_rows=True)
    tracing.enable()
    on = idx.search(bodies, K, return_rows=True)
    assert records()
    for a, b in zip(off, on):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_nothing_is_recorded_while_off(monkeypatch):
    class NoClock:
        def perf_counter_ns(self):
            raise AssertionError("a span site read the clock while nothing records")

    idx = make_index()
    monkeypatch.setattr(di, "time", NoClock())
    monkeypatch.setattr(merge_mod, "time", NoClock())
    idx.search(queries(5), K)
    assert records() == []


def test_a_failing_shard_scan_leaves_no_span_open(monkeypatch):
    """The launch span is closed whatever a shard's scan raises, so the
    next span on the thread has no parent."""
    idx = make_index()

    def broken(*args, **kwargs):
        raise RuntimeError("scan refused")

    monkeypatch.setattr(di, "blockmax_topk_packedq_impl", broken)
    tracing.enable()
    with pytest.raises(RuntimeError, match="scan refused"):
        idx.search(queries(3), K)
    names = [r[NAME] for r in records()]
    assert names == ["search.prepare", "search.launch", "search"]
    span = tracing.start("next")
    tracing.stop(span)
    assert records()[-1][PARENT] is None


def test_the_sharded_scans_of_parallel_record_the_same_spans():
    """``sharded_topk`` and ``sharded_pm1_topk`` called alone: one
    ``mesh.scan`` per shard, one ``mesh.merge``, and no parent."""
    rng = np.random.default_rng(1)
    mesh = make_mesh(SHARDS, device="cpu")
    n, nq, k = 4096, 3, 8
    codes = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    lanes = np.full(n, 8, np.int32)
    valid = np.ones(n, bool)
    q = torch.from_numpy(codes[:nq].view(np.int32).copy())
    db = shard_database(mesh, codes, lanes, valid)
    packed, pvalid = shard_pm1_database(mesh, codes, valid)
    q_pm1 = torch.from_numpy(np.unpackbits(codes[:nq].astype(">u4").view(np.uint8), axis=1).astype(np.float32) * 2 - 1)
    q_scale = torch.full((nq,), 1 / 512, dtype=torch.float32)
    tracing.enable()
    sharded_topk(mesh, q, torch.from_numpy(lanes[:nq]), *db, k, chunk_size=n // SHARDS)
    sharded_pm1_topk(mesh, q_pm1, q_scale, packed, pvalid, k, 256, chunk_size=n // SHARDS)
    got = records()
    assert all(r[PARENT] is None for r in got)
    per_call = [("mesh.scan", {"shard": s, "rows": n // SHARDS}) for s in range(SHARDS)]
    per_call.append(("mesh.merge", {"candidates": SHARDS * nq * k, "bytes": 0}))
    assert [(r[NAME], r[COUNTS]) for r in got] == per_call * 2
