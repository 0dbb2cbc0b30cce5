"""
The traced run: the device's work from ``torch.profiler`` and the idle gaps
labelled by the harness's host spans.

The profiler records the device alone (``ProfilerActivity.CUDA``: kernels,
copies and fills, and the launch calls), read from its raw events, which
carry wall-clock nanoseconds; host spans are converted to the same clock.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

TOP = 10  # entries of each breakdown list


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float  # the union of the intervals in which an operation ran on the device
    kernels: int  # kernel launches (copies and fills not counted)
    by_name: dict = field(default_factory=dict)  # device op name -> seconds
    idle_by_label: dict = field(default_factory=dict)  # what the host was in -> idle device seconds


class Profiler:
    """``torch.profiler`` over the device, started and stopped by the harness."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self):
        # Offset from time.perf_counter() to the profiler's wall clock.
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self._prof.__enter__()
        self.t_start = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self._prof.__exit__(None, None, None)

    def device_events(self):
        """[(name, start_ns, end_ns)] of the device's operations."""
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
                out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        return out

    def reduce(self, spans, outside_label):
        """The :class:`DeviceTrace` of the window ``[start, stop]``."""
        lo = int(self.t_start * 1e9) + self.offset_ns
        hi = int(self.t_stop * 1e9) + self.offset_ns
        events = [(n, max(s, lo), min(e, hi)) for n, s, e in self.device_events() if e > lo and s < hi]
        by_name = defaultdict(float)
        kernels = 0
        for name, s, e in events:
            by_name[name] += (e - s) / 1e9
            kernels += not name.startswith(("Memcpy", "Memset"))
        busy, gaps = union_and_gaps(sorted((s, e) for _, s, e in events), lo, hi)
        return DeviceTrace((hi - lo) / 1e9, busy / 1e9, kernels, dict(by_name),
                           label_gaps(gaps, spans, self.offset_ns, outside_label))


def union_and_gaps(intervals, lo, hi):
    """(covered nanoseconds, [(start, end)] uncovered) of sorted intervals in [lo, hi]."""
    busy, gaps, cursor = 0, [], lo
    for s, e in intervals:
        if s > cursor:
            gaps.append((cursor, s))
            cursor = s
        if e > cursor:
            busy += e - cursor
            cursor = e
    if hi > cursor:
        gaps.append((cursor, hi))
    return busy, gaps


def covered_before(intervals):
    """A function of times t: how much of the union of ``intervals`` lies before t."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = np.array([s for s, _ in merged], np.float64)
    ends = np.array([e for _, e in merged], np.float64)
    done = np.concatenate([[0.0], np.cumsum(ends - starts)])

    def before(t):
        i = np.searchsorted(starts, t, "right")  # intervals that started before t
        open_part = np.where(i > 0, np.minimum(t, ends[np.maximum(i - 1, 0)]) - starts[np.maximum(i - 1, 0)], 0.0)
        return done[np.maximum(i - 1, 0)] * (i > 0) + np.maximum(open_part, 0.0)

    return before


def label_gaps(gaps, spans, offset_ns, outside_label):
    """{label: idle seconds}: every instant of every gap under the innermost
    host span open then: ``search`` (inside the index's search: packing,
    launches, the host merge), ``batcher wait`` (a client waiting on the
    batcher, no sweep running), ``outside_label`` (inside a request,
    neither) or ``client loop`` (no request open)."""
    if not gaps:
        return {}
    lo = np.array([s for s, _ in gaps], np.float64)
    hi = np.array([e for _, e in gaps], np.float64)
    out, inner = {}, 0.0
    for kinds, label in ((("search",), "search"), (("search", "batcher"), "batcher wait"),
                         (("search", "batcher", "request"), outside_label)):
        before = covered_before([(round(t0 * 1e9) + offset_ns, round(t1 * 1e9) + offset_ns)
                                 for k, t0, t1 in spans if k in kinds])
        covered = float((before(hi) - before(lo)).sum()) / 1e9
        if covered - inner > 0:
            out[label] = covered - inner
        inner = covered
    rest = float((hi - lo).sum()) / 1e9 - inner
    if rest > 0:
        out["client loop"] = rest
    return out


def breakdown(trace):
    """The ``breakdown`` of the result line: the device operations that took
    the most time, and the idle device time by what the host was in."""
    top = sorted(trace.by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(trace.idle_by_label.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[name[:160], s] for name, s in top], "idle_gaps": [[lab, s] for lab, s in idle]}
