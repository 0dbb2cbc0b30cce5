"""Host spans the harness records around its calls into the program."""

from __future__ import annotations

import threading
import time


class Spans:
    """Append-only (kind, start, end) records in ``time.perf_counter``
    seconds, from any thread; ``sweeps`` also holds each device sweep's
    query count."""

    def __init__(self):
        self.records = []  # (kind, t0, t1)
        self.sweeps = []  # (queries, t0, t1)
        self._lock = threading.Lock()

    def add(self, kind, t0, t1):
        with self._lock:
            self.records.append((kind, t0, t1))

    def add_sweep(self, nq, t0, t1):
        with self._lock:
            self.sweeps.append((nq, t0, t1))
            self.records.append(("search", t0, t1))

    def since(self, t):
        """(records, sweeps) that started at or after ``t``."""
        with self._lock:
            return [r for r in self.records if r[1] >= t], [s for s in self.sweeps if s[1] >= t]


class SweepRecorder:
    """Stands between a caller and an index: ``search`` is the index's, with
    each call recorded as one device sweep of ``len(bodies)`` queries."""

    def __init__(self, index, spans):
        self.index = index
        self.spans = spans

    def search(self, bodies, count, **kwargs):
        t0 = time.perf_counter()
        out = self.index.search(bodies, count, **kwargs)
        self.spans.add_sweep(len(bodies), t0, time.perf_counter())
        return out
