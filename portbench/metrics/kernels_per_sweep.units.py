"""
kernels_per_sweep.units: Device kernels in the profiler's trace per device
sweep of unit queries.
"""

from portbench.readers import kernels_per_sweep as read  # noqa: F401
