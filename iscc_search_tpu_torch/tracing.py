"""
The port's own spans: where a search's host time goes, by layer.

A span is one record, a tuple ``(name, t0_ns, t1_ns, span_id, parent_id,
request_id, thread_id, counts)``:

- ``t0_ns``, ``t1_ns``: ``time.perf_counter_ns()`` at its start and end,
  the clock a caller's own ``time.perf_counter()`` spans read;
- ``parent_id``: the span open on the same thread when it started (a
  stack per thread), or None;
- ``request_id``: shared by every span of one request, across threads. A
  span takes its parent's, or a new one where it has no parent; the search
  batcher carries its callers' ids to its collector thread;
- ``counts``: a small dict of the work counted at that boundary, or None.

Spans are recorded after :func:`enable` (until :func:`disable`) and while a
``torch.profiler`` session is open, whatever its activities, so a profile
of the card holds the program's spans of the same window. They go into a
ring of at most :data:`RING` records in memory; :func:`snapshot` returns
them and how many the ring dropped. Nothing is written to disk or sent
anywhere. A span adds no device work: no ``record_function``, no NVTX
range. While nothing records, a span site reads one flag
(:func:`start` returns None) and makes no object.

The spans (README.md, "Tracing the search path"):

- ``search`` (``PackedCodeIndex._search_impl``; count ``queries``) and its
  four children, one after the other: ``search.prepare`` (the lock, the
  device sync, the partition snapshot, query packing and upload),
  ``search.launch`` (every partition's scan enqueued; count ``fused_scans``,
  the scans whose phases 2-3 took one launch, where there are any),
  ``search.wait`` (the readbacks queued and the stream waited for) and
  ``search.merge`` (the per-query merge on the host; count ``candidates``
  read back and merged);
- on a mesh, from every sharded scan of :mod:`iscc_search_tpu_torch.parallel`,
  under ``search.launch`` in an index's search (``PackedCodeIndex(mesh=...)``):
  one ``mesh.scan`` per shard and partition (the shard's scan enqueued on
  its device; counts ``shard``, the flat shard id, and ``rows``, the
  shard's scanned capacity) and one ``mesh.merge`` per partition (the
  shards' candidates moved to the lead device, concatenated and cut to the
  top-k; counts ``candidates``, the shards' candidates merged, and
  ``bytes``, the scores and rows that moved from another device);
- ``batcher.queue`` (a caller's enqueue to the start of the sweep that
  serves it), ``batcher.sweep`` (the fused sweep, parent of ``search``;
  counts ``queries`` and ``served``, the request ids of its callers) and
  ``batcher.handoff`` (the sweep's end to the caller's return);
- ``simprint.search`` (``SimprintEngine.search_raw_many``; count
  ``assets``) and one ``simprint.score`` per query asset scored.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import torch.autograd.profiler as _profiler

RING = 2**20  # records kept; older ones are dropped, and counted

_enabled = False
_ring = deque(maxlen=RING)
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)  # span and request ids, unique in the process
_local = threading.local()


class Span:
    """An open span, from :func:`start` to :func:`stop`."""

    __slots__ = ("name", "t0", "id", "parent", "request")

    def __init__(self, name, t0, parent, request):
        self.name = name
        self.t0 = t0
        self.id = next(_ids)
        self.parent = parent
        self.request = request


def recording():
    """True while spans are recorded: after :func:`enable`, or inside a
    ``torch.profiler`` session (torch rebinds its flag, so it is read here
    at every call)."""
    return _enabled or _profiler._is_profiler_enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def clear():
    """Drop every record and the count of dropped ones."""
    global _ring, _dropped
    with _lock:
        _ring = deque(maxlen=RING)
        _dropped = 0


def snapshot():
    """(records, dropped): the ring's records, oldest first, and how many
    older ones it dropped."""
    with _lock:
        return list(_ring), _dropped


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _append(name, t0, t1, span_id, parent, request, counts):
    global _dropped
    record = (name, t0, t1, span_id, parent, request, threading.get_ident(), counts)
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(record)


def request_id():
    """The request of this thread's open span, or a new request id."""
    stack = _stack()
    return stack[-1].request if stack else next(_ids)


def start(name, t0=None, request=None):
    """Open span ``name`` on this thread (from ``t0``, else now; in
    ``request``, else its parent's) and return it, or None while nothing
    records. Every span started is closed by :func:`stop`."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return None
    stack = _stack()
    top = stack[-1] if stack else None
    if request is None:
        request = top.request if top is not None else next(_ids)
    span = Span(name, time.perf_counter_ns() if t0 is None else t0, top.id if top is not None else None, request)
    stack.append(span)
    return span


def stop(span, t1=None, counts=None):
    """Close ``span`` (at ``t1``, else now) and record it."""
    t1 = time.perf_counter_ns() if t1 is None else t1
    _stack().remove(span)
    _append(span.name, span.t0, t1, span.id, span.parent, span.request, counts)


def add(name, t0, t1, counts=None, request=None):
    """Record a finished span ``[t0, t1]`` under this thread's open span
    (in ``request``, else that span's). The caller has checked that spans
    are recorded (it holds an open span, or :func:`recording` was true)."""
    stack = _stack()
    top = stack[-1] if stack else None
    if request is None:
        request = top.request if top is not None else next(_ids)
    _append(name, t0, t1, next(_ids), top.id if top is not None else None, request, counts)
