"""
kernels_per_sweep.chunks: Device kernels in the profiler's trace per device
sweep of chunk queries.
"""

from portbench.readers import kernels_per_sweep as read  # noqa: F401
