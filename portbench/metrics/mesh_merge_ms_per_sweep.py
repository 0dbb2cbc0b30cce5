"""
mesh_merge_ms_per_sweep: Host ms per device sweep in the program's
mesh.merge spans (each partition's shard candidates moved to the lead card,
concatenated and cut to the top-k there), the sum over a search's spans,
the mean over the window's search spans.
"""

from portbench.mesh_spans import ms_per_sweep

read = ms_per_sweep("mesh.merge")
