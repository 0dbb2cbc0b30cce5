"""
scan_roofline.chunks: The least time of the window's chunk scans
(portbench/work.py) over the device's busy time, in %.
"""

from portbench.readers import scan_roofline as read  # noqa: F401
