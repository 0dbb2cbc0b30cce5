"""
setup_s: Seconds from the process's start to the first timed request: import
and CUDA init, data from the seed, the build, the first search and the warm-
up.
"""

from portbench.readers import setup_s as read  # noqa: F401
