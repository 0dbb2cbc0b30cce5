"""
kernels_per_sweep.mesh: Device kernels of every card in the profiler's
trace per device sweep of unit queries.
"""

from portbench.readers import kernels_per_sweep as read  # noqa: F401
