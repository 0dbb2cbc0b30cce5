"""
The program's recorder in the CPU tests of a traced run.

On the card a traced run (``--trace 1``) opens ``torch.profiler``, which
turns on the program's recorder (``iscc_search_tpu_torch.tracing``), and
the metrics of ``program_spans.py`` read its spans. On the CPU the harness
opens no profiler, so a test parametrised with ``trace`` 1 runs with the
recorder enabled in its place, and cleared before and after.
"""

import pytest


@pytest.fixture(autouse=True)
def program_spans(request):
    callspec = getattr(request.node, "callspec", None)
    try:
        from iscc_search_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        tracing = None
    if tracing is None or callspec is None or callspec.params.get("trace") != 1:
        yield
        return
    tracing.clear()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.clear()
