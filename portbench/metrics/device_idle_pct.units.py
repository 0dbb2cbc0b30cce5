"""
device_idle_pct.units: 100 x (1 - device busy time / traced window), from
torch.profiler, in the unit cells.
"""

from portbench.readers import device_idle_pct as read  # noqa: F401
