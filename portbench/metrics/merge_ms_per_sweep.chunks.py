"""
merge_ms_per_sweep.chunks: Host ms per device sweep in the program's
search.merge span (the per-query merge of the partitions' candidates on the
host), the mean over the window's search spans.
"""

from portbench.program_spans import child_ms_per_sweep

read = child_ms_per_sweep("search.merge")
