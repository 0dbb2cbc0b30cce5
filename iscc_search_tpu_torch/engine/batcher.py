"""
A copy of ``iscc_search_tpu/engine/batcher.py`` (the port imports nothing of the JAX package);
``tests/test_torch_host_copies.py`` holds every function of it to the
original's bytecode, the package name aside, but for the port's spans
(:mod:`iscc_search_tpu_torch.tracing`: ``batcher.queue``,
``batcher.sweep``, ``batcher.handoff``) in ``_Pending.__init__``,
``SearchBatcher.search`` and ``SearchBatcher._run_batch``.

Cross-request micro-batching for device scans.

The scan engine's throughput scales with the fused query batch (one sweep
serves hundreds of queries), but HTTP requests arrive one query at a time.
SearchBatcher coalesces concurrent callers: requests enqueue and block; a
collector thread drains the queue (bounded window / batch size), runs ONE
batched device search, and distributes per-caller results. Under concurrency
the device sees large fused batches; a lone caller pays at most ``window_ms``
extra latency (first caller in a batch triggers immediate collection, so the
idle-server fast path adds ~zero).

This replaces the reference's thread-per-request → HNSW-per-query model with
the TPU-appropriate shape (SURVEY §2.3 thread concurrency row).
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING

from iscc_search_tpu_torch import tracing
from iscc_search_tpu_torch.utils import get_logger

if TYPE_CHECKING:  # pragma: no cover
    from iscc_search_tpu_torch.engine.device_index import PackedCodeIndex  # noqa: F401

logger = get_logger(__name__)


class _Pending:
    __slots__ = ("bodies", "count", "event", "result", "error", "trace")

    def __init__(self, bodies, count):
        self.bodies = bodies
        self.count = count
        self.event = threading.Event()
        self.result = None
        self.error = None
        # While spans are recorded: [request id, enqueued, sweep start,
        # sweep end] in perf_counter_ns, the sweep's filled by the collector.
        self.trace = None


class SearchBatcher:
    """
    Batches concurrent ``search(bodies, count)`` calls into fused device scans.

    :param index: PackedCodeIndex-like object with .search(list[bytes], count)
    :param max_batch: maximum fused query count per sweep
    :param window_ms: how long the collector waits to fill a batch after the
        first request arrives (0 = no extra wait, still batches whatever is
        queued at collection time)
    :param return_rows: fuse ``search(..., return_rows=True)`` calls instead —
        per-query results are (keys, scores, rows) triples (the simprint
        engine's sweep shape, which feeds ``body_at`` scoring lookups)
    """

    def __init__(self, index, max_batch=256, window_ms=2.0, return_rows=False):
        # type: (..., int, float, bool) -> None
        self.index = index
        self.return_rows = return_rows
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self._queue = []  # type: list[_Pending]
        self._cond = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._collector, name="scan-batcher", daemon=True)
        self._thread.start()

    def search(self, bodies, count):
        # type: (list[bytes], int) -> list
        """Blocking search through the batcher; same result shape as index.search."""
        if not bodies:
            return []
        pending = _Pending(list(bodies), count)
        if tracing.recording():
            pending.trace = [tracing.request_id(), time.perf_counter_ns(), 0, 0]
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append(pending)
            self._cond.notify()
        pending.event.wait()
        if pending.trace is not None and pending.trace[3]:
            request, enqueued, sweep_start, sweep_end = pending.trace
            tracing.add("batcher.queue", enqueued, sweep_start, request=request)
            tracing.add("batcher.handoff", sweep_end, time.perf_counter_ns(), request=request)
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _collector(self):
        # type: () -> None
        last_dispatch = float("-inf")  # first request always dispatches at once
        while True:
            with self._cond:
                # wait_for: the retest-after-wakeup loop lives in threading.py
                # (a hand-written while compiles an extra loop-bottom test
                # copy that only a spurious wakeup could exercise).
                self._cond.wait_for(lambda: self._queue or self._closed)
                if self._closed and not self._queue:
                    return
                queued = sum(len(p.bodies) for p in self._queue)
            # Idle-server fast path: the first request after a quiet period
            # dispatches immediately. Under load (the previous sweep ended
            # within the window) sleep out the remaining window so followers
            # pile on — unless a full batch is already queued. Batches also
            # form naturally while a sweep is in flight.
            if self.window_s > 0 and queued < self.max_batch:
                wait = self.window_s - (time.monotonic() - last_dispatch)
                if wait > 0:
                    time.sleep(wait)
            with self._cond:
                # The queue is never empty here (the wait above only falls
                # through with items queued, and nothing else pops): admit
                # the head unconditionally — an oversized first request
                # forms its own batch — then fill up to max_batch.
                first = self._queue.pop(0)
                batch = [first]  # type: list[_Pending]
                n_queries = len(first.bodies)
                while self._queue and n_queries + len(self._queue[0].bodies) <= self.max_batch:
                    item = self._queue.pop(0)
                    batch.append(item)
                    n_queries += len(item.bodies)
            self._run_batch(batch)
            last_dispatch = time.monotonic()

    def _run_batch(self, batch):
        # type: (list[_Pending]) -> None
        """Run one fused sweep and distribute results.

        Every pending entry's event is ALWAYS set exactly once — result
        slicing runs inside the try so a malformed engine return surfaces as
        the caller's error instead of killing the collector thread (which
        would hang the in-flight caller and every future search forever).
        """
        bodies = [b for item in batch for b in item.bodies]
        max_count = max(item.count for item in batch)
        try:
            from iscc_search_tpu_torch.server import metrics

            t0 = time.perf_counter_ns()
            # The sweep's span, in the request of the first caller it serves.
            served = [item.trace for item in batch if item.trace is not None] if tracing.recording() else ()
            sweep = tracing.start("batcher.sweep", t0, served[0][0]) if served else None
            try:
                if self.return_rows:
                    results = self.index.search(bodies, max_count, return_rows=True)
                else:
                    results = self.index.search(bodies, max_count)
            finally:
                t1 = time.perf_counter_ns()
                if sweep is not None:
                    for trace in served:
                        trace[2:] = (t0, t1)
                    tracing.stop(sweep, t1, {"queries": len(bodies), "served": [trace[0] for trace in served]})
            metrics.sweep_seconds.observe((t1 - t0) / 1e9)
            metrics.batch_queries.observe(len(bodies))
            if len(results) != len(bodies):
                # A short return would otherwise hand trailing callers EMPTY
                # result lists (a silent wrong answer) instead of an error.
                raise RuntimeError(
                    f"engine returned {len(results)} results for {len(bodies)} queries"
                )
            distributed = []
            offset = 0
            for item in batch:
                n = len(item.bodies)
                per_query = []
                for res in results[offset : offset + n]:
                    per_query.append(tuple(col[: item.count] for col in res))
                distributed.append(per_query)
                offset += n
        except Exception as exc:
            for item in batch:
                item.error = exc
                item.event.set()
            return
        for item, per_query in zip(batch, distributed):
            item.result = per_query
            item.error = None
            item.event.set()

    def close(self):
        # type: () -> None
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(5)
