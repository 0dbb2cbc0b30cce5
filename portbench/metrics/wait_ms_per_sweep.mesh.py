"""
wait_ms_per_sweep.mesh: Host ms per device sweep in the program's
search.wait span (the readbacks queued on the lead card and its stream
waited for, which waits on every card's copies: the cards' tail, as the
host waits for it), the mean over the window's search spans.
"""

from portbench.program_spans import child_ms_per_sweep

read = child_ms_per_sweep("search.wait")
