"""The work arithmetic at known shapes, and the split of the trace's idle time."""

import pytest

from portbench import work


def test_phase1_work_counts_rows_queries_and_maxima():
    # 1,024 rows of 8 lanes, 2 queries: rows 32,768 B + validity 1,024 B,
    # queries 2 x (32 + 8) B, maxima 2 x 8 x 4 B; 2 x 1,024 dots of 256 bits.
    assert work.phase1_work(1024, 8, 2) == (32768 + 1024 + 80 + 64, 2 * 1024 * 256 * 2)


def test_gather_work_counts_distinct_blocks_once():
    # 3 distinct blocks of 4-lane rows, 2 queries x 2 candidate blocks.
    assert work.gather_work(2, 2, 4, 3) == (3 * 128 * 16 + 16 + 2 * 20 + 2 * 2 * 512, 2 * 2 * 128 * 4)


def test_sweep_work_sums_the_partitions():
    one = work.sweep_work(512, [(1 << 20, 8)], 10)
    two = work.sweep_work(512, [(1 << 20, 8), (1 << 20, 8)], 10)
    assert two == (2 * one[0], 2 * one[1])
    b1, o1 = work.phase1_work(1 << 20, 8, 512)
    b3, _ = work.gather_work(512, 10, 8, 5120)
    assert one == (b1 + b3, o1 + 512 * 10 * 128 * 2 * 256)
    # Fewer candidate blocks than the partition holds: at most all of them, once.
    assert work.sweep_work(4, [(256, 2)], 10)[0] == work.phase1_work(256, 2, 4)[0] + work.gather_work(4, 2, 2, 2)[0]


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 1979e12) == pytest.approx(1.0)
    assert work.least_seconds(3.35e12, 2 * 1979e12) == pytest.approx(2.0)
    assert work.bound(3.35e9, 0, 1) == (1.0, "bytes")


def test_idle_time_goes_to_the_innermost_span_open_at_each_instant():
    """A gap is split where spans open and close: a sweep inside a batcher
    call inside a request, and a stretch with no request open."""
    from portbench.tracing import label_gaps

    spans = [("request", 0, 100e-9), ("batcher", 10e-9, 60e-9), ("search", 20e-9, 40e-9),
             ("request", 120e-9, 130e-9)]
    idle = label_gaps([(0, 100), (100, 150)], spans, 0, "scoring")
    assert idle == pytest.approx({"search": 20e-9, "batcher wait": 30e-9, "scoring": 60e-9, "client loop": 40e-9})
    assert label_gaps([], spans, 0, "scoring") == {}
