"""The metrics read from the program's own spans (``program_spans.py``):
both cells at a small size on the CPU with the program's recorder on."""

import sys
import time

import pytest

from portbench import harness, program_spans
from portbench.tests.conftest import TINY

PROGRAM_SPAN_METRICS = {
    "c3_bulk512": {f"{m}.units" for m in ("prepare_ms_per_sweep", "launch_ms_per_sweep", "wait_ms_per_sweep",
                                           "merge_ms_per_sweep", "merge_candidates_per_query")},
    "c4_asset1": {f"{m}.chunks" for m in ("prepare_ms_per_sweep", "launch_ms_per_sweep", "wait_ms_per_sweep",
                                           "merge_ms_per_sweep", "merge_candidates_per_query")}
    | {"batcher_ms_per_request", "score_self_ms_per_asset"},
}
CANDIDATES = {"c3_bulk512": 4 * 10, "c4_asset1": 1 * 400}  # partitions x count, every query's candidates


@pytest.fixture
def recorder():
    from iscc_search_tpu_torch import tracing

    tracing.clear()
    tracing.enable()
    yield tracing
    tracing.disable()
    tracing.clear()


def test_the_metrics_name_their_cells(spec):
    named = {m["name"]: m for m in spec["per_layer"]}
    for workload, names in PROGRAM_SPAN_METRICS.items():
        for name in names:
            assert named[name]["workloads"] == [workload] and named[name]["source"] == "host_clock"
            assert harness.load_reader(name) is not None


@pytest.mark.parametrize("workload", list(TINY))
def test_every_program_span_metric_reads_a_number(spec, workload, recorder):
    config_over, mix_over = TINY[workload]
    result, _ = harness.run_cell(spec, workload, 3_000_000_019, 1.0, 1, "cpu", config_over=config_over,
                                 mix_over=mix_over, log=lambda *_: None)
    assert result["correct"] is True
    metrics = result["metrics"]
    for name in PROGRAM_SPAN_METRICS[workload]:
        assert isinstance(metrics[name]["value"], float) and metrics[name]["value"] >= 0, name
    kind = "units" if workload.startswith("c3") else "chunks"
    assert metrics[f"merge_candidates_per_query.{kind}"]["value"] == CANDIDATES[workload]
    records, dropped = recorder.snapshot()
    assert dropped == 0
    roots = {r[program_spans.ID]: r for r in records if r[program_spans.NAME] == "search"}
    kids = {}
    for r in records:
        if r[program_spans.PARENT] in roots:
            kids.setdefault(r[program_spans.PARENT], []).append(r)
    assert roots and set(kids) == set(roots)
    t0, t1 = program_spans.T0, program_spans.T1
    for root_id, children in kids.items():
        root = roots[root_id]
        assert tuple(c[program_spans.NAME] for c in children) == program_spans.CHILDREN
        edges = [root[t0]] + [t for c in children for t in (c[t0], c[t1])] + [root[t1]]
        assert edges == sorted(edges)


def empty_run(t_start=0.0, t_end=1e9):
    return harness.Run(1.0, t_start, t_end, [], [], [], ([(256, 2)], 10))


def one_of_each(tracing):
    """Nine records, one of every span the readers read, in one request."""
    now = time.perf_counter_ns
    request = tracing.start("simprint.search")
    sweep = tracing.start("search")
    for name in program_spans.CHILDREN:
        tracing.add(name, now(), now(), {"candidates": 4} if name == "search.merge" else None)
    tracing.stop(sweep, counts={"queries": 2})
    tracing.add("simprint.score", now(), now())
    tracing.add("batcher.queue", now(), now())
    tracing.add("batcher.handoff", now(), now())
    tracing.stop(request, counts={"assets": 1})


ALL = sorted(set().union(*PROGRAM_SPAN_METRICS.values()))


@pytest.mark.parametrize("name", ALL)
def test_a_reader_of_nothing_returns_none(name, recorder, monkeypatch):
    read = harness.load_reader(name)
    assert read(empty_run()) is None  # the ring is empty
    monkeypatch.setattr(recorder, "RING", 9)
    recorder.clear()
    one_of_each(recorder)
    assert read(empty_run()) >= 0
    assert read(empty_run(0.0, 1e-9)) is None  # nothing inside the window
    recorder.add("one more", 1, 2)
    assert recorder.snapshot()[1] == 1 and read(empty_run()) is None  # the ring dropped a record
    recorder.clear()
    one_of_each(recorder)
    # A program without the recorder (the module neither loaded nor found).
    monkeypatch.delattr(sys.modules["iscc_search_tpu_torch"], "tracing")
    monkeypatch.setitem(sys.modules, "iscc_search_tpu_torch.tracing", None)
    assert read(empty_run()) is None
