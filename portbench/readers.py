"""
What the metric files of ``portbench/metrics`` read from a finished run.

Each takes the :class:`~portbench.harness.Run` and returns a number, or
None where the run holds nothing to read (a device metric on the CPU): the
harness then leaves the metric out of the result line.
"""

from __future__ import annotations

import numpy as np

from portbench import work


def setup_s(run):
    return run.setup_s


def items_per_s(run):
    """Items (unit queries, query assets) of the requests answered inside
    the window, over the window."""
    done = sum(n for _, t1, n in run.requests if t1 <= run.t_end)
    return done / (run.t_end - run.t_start)


def request_p95_ms(run):
    """The 95th percentile of the latency of every request sent in the window."""
    if not run.requests:
        return None
    return float(np.percentile([t1 - t0 for t0, t1, _ in run.requests], 95)) * 1e3


def score_ms_per_asset(run):
    """Host time of a request outside the batcher's sweeps, per query asset."""
    inside = sum(t1 - t0 for kind, t0, t1 in run.spans if kind == "batcher")
    outside = sum(t1 - t0 for t0, t1, _ in run.requests) - inside
    assets = sum(n for _, _, n in run.requests)
    return outside / assets * 1e3 if assets else None


def kernels_per_sweep(run):
    if run.trace is None or not run.sweeps:
        return None
    return run.trace.kernels / len(run.sweeps)


def scan_roofline(run):
    """The least time of the window's sweeps (``work.sweep_work`` at each
    sweep's query count) over the device's busy time."""
    if run.trace is None or not run.sweeps or run.trace.busy_s <= 0:
        return None
    parts, k = run.shapes
    nbytes = ops = 0
    for nq, _, _ in run.sweeps:
        b, o = work.sweep_work(nq, parts, k)
        nbytes += b
        ops += o
    return 100.0 * work.least_seconds(nbytes, ops) / run.trace.busy_s


def device_idle_pct(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
