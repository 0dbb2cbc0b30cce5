"""
launch_ms_per_sweep.units: Host ms per device sweep in the program's
search.launch span (every length partition's scan enqueued on the device),
the mean over the window's search spans.
"""

from portbench.program_spans import child_ms_per_sweep

read = child_ms_per_sweep("search.launch")
