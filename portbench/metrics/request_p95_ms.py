"""
request_p95_ms: The 95th percentile of the latency of every request sent in
the window, in ms.
"""

from portbench.readers import request_p95_ms as read  # noqa: F401
