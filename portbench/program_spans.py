"""
What the metric files read from the program's own spans
(``iscc_search_tpu_torch.tracing``), recorded while the traced run's
``torch.profiler`` session is open.

Each reader takes the :class:`~portbench.harness.Run` and keeps the records
with ``run.t_start <= t0`` and ``t1 <= run.t_end`` (the program's clock is
``time.perf_counter_ns()``, the harness's ``time.perf_counter()``). It
returns None, and the harness leaves the metric out, where the window holds
no such records (a program without the recorder, or a run in which it did
not record) or the ring dropped any.
"""

from __future__ import annotations

from collections import defaultdict

NAME, T0, T1, ID, PARENT, REQUEST, THREAD, COUNTS = range(8)
CHILDREN = ("search.prepare", "search.launch", "search.wait", "search.merge")


def window(run):
    """The program's span records inside the run's window, or None."""
    try:
        from iscc_search_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    records, dropped = tracing.snapshot()
    if dropped:
        return None
    lo, hi = run.t_start * 1e9, run.t_end * 1e9
    return [r for r in records if lo <= r[T0] and r[T1] <= hi]


def sweeps(run):
    """(roots, {child name: [records]}) of the window's ``search`` spans
    and their children, or None where it holds none."""
    records = window(run)
    if not records:
        return None
    roots = {r[ID]: r for r in records if r[NAME] == "search"}
    if not roots:
        return None
    kids = defaultdict(list)
    for r in records:
        if r[PARENT] in roots:
            kids[r[NAME]].append(r)
    return roots, kids


def child_ms_per_sweep(name):
    """A reader: the mean time of child ``name`` per ``search`` span, in ms."""

    def read(run):
        found = sweeps(run)
        if found is None or not found[1].get(name):
            return None
        roots, kids = found
        return sum(r[T1] - r[T0] for r in kids[name]) / len(roots) / 1e6

    return read


def merge_candidates_per_query(run):
    """Candidates read back and merged (``search.merge``) per query of the
    window's sweeps."""
    found = sweeps(run)
    if found is None or not found[1].get("search.merge"):
        return None
    roots, kids = found
    queries = sum(roots[r[PARENT]][COUNTS]["queries"] for r in kids["search.merge"])
    return sum(r[COUNTS]["candidates"] for r in kids["search.merge"]) / queries if queries else None


def batcher_ms_per_request(run):
    """The batcher's time around a caller's sweep (``batcher.queue`` and
    ``batcher.handoff``), in ms per request it served."""
    records = window(run)
    if not records:
        return None
    by_request = defaultdict(dict)  # request id -> {name: [ns]}
    for r in records:
        if r[NAME] in ("batcher.queue", "batcher.handoff"):
            by_request[r[REQUEST]].setdefault(r[NAME], []).append(r[T1] - r[T0])
    served = [sum(map(sum, spans.values())) for spans in by_request.values() if len(spans) == 2]
    return sum(served) / len(served) / 1e6 if served else None


def score_self_ms_per_asset(run):
    """The simprint engine's scoring (``simprint.score``) per query asset
    of the window's chunk searches (``simprint.search``), in ms."""
    records = window(run)
    if not records:
        return None
    roots = {r[ID]: r for r in records if r[NAME] == "simprint.search"}
    assets = sum(r[COUNTS]["assets"] for r in roots.values())
    if not assets:
        return None
    return sum(r[T1] - r[T0] for r in records if r[NAME] == "simprint.score" and r[PARENT] in roots) / assets / 1e6
