"""
What the metric files of the mesh cells read from the program's mesh spans
(``mesh.scan``, ``mesh.merge``: ``iscc_search_tpu_torch.tracing``), nested
under the ``search.launch`` span of each ``search`` in the traced run's
window (``program_spans.window``). Each reader returns None, and the
harness leaves the metric out, where the window holds no such span: a
program without them, or a single-device index.
"""

from __future__ import annotations

from portbench.program_spans import COUNTS, ID, NAME, PARENT, T0, T1, window


def under_launch(run, name):
    """(the window's ``search`` spans by id, the ``name`` spans under their
    ``search.launch``), or None where it holds no ``name`` span."""
    records = window(run)
    if not records:
        return None
    roots = {r[ID]: r for r in records if r[NAME] == "search"}
    launches = {r[ID] for r in records if r[NAME] == "search.launch" and r[PARENT] in roots}
    spans = [r for r in records if r[NAME] == name and r[PARENT] in launches]
    return (roots, spans) if spans else None


def ms_per_sweep(name):
    """A reader: the time of every ``name`` span per ``search`` span, in ms."""

    def read(run):
        found = under_launch(run, name)
        if found is None:
            return None
        roots, spans = found
        return sum(r[T1] - r[T0] for r in spans) / len(roots) / 1e6

    return read


def crosscard_bytes_per_query(run):
    """The ``bytes`` count of every ``mesh.merge`` span (scores and rows
    moved from another card to the lead) over the ``queries`` count of the
    window's ``search`` spans."""
    found = under_launch(run, "mesh.merge")
    if found is None:
        return None
    roots, spans = found
    queries = sum(r[COUNTS]["queries"] for r in roots.values())
    return sum(r[COUNTS]["bytes"] for r in spans) / queries if queries else None
