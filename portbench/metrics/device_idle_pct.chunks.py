"""
device_idle_pct.chunks: 100 x (1 - device busy time / traced window), from
torch.profiler, in the chunk cell.
"""

from portbench.readers import device_idle_pct as read  # noqa: F401
