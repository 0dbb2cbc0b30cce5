"""
device_idle_pct.mesh: 100 x (1 - the union of every card's busy time /
traced window), from torch.profiler: the share of the window in which no
card works.
"""

from portbench.readers import device_idle_pct as read  # noqa: F401
