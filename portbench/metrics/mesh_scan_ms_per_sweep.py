"""
mesh_scan_ms_per_sweep: Host ms per device sweep in the program's mesh.scan
spans (each shard's scan of each length partition enqueued on its card, by
one host thread), the sum over a search's spans, the mean over the window's
search spans.
"""

from portbench.mesh_spans import ms_per_sweep

read = ms_per_sweep("mesh.scan")
