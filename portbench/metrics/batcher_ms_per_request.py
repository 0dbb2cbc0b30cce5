"""
batcher_ms_per_request: Host ms per request in the search batcher around
its sweep: the batcher.queue span (enqueued to the sweep's start) plus the
batcher.handoff span (the sweep's end to the caller's return).
"""

from portbench.program_spans import batcher_ms_per_request as read  # noqa: F401
