"""
wait_ms_per_sweep.units: Host ms per device sweep in the program's
search.wait span (the readbacks queued and the stream waited for: the
device's tail, as the host waits for it), the mean over the window's search
spans.
"""

from portbench.program_spans import child_ms_per_sweep

read = child_ms_per_sweep("search.wait")
