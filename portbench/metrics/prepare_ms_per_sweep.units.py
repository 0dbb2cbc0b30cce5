"""
prepare_ms_per_sweep.units: Host ms per device sweep in the program's
search.prepare span (the lock, the device sync, the partition snapshot,
query packing and upload), the mean over the window's search spans.
"""

from portbench.program_spans import child_ms_per_sweep

read = child_ms_per_sweep("search.prepare")
