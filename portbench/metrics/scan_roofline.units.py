"""
scan_roofline.units: The least time of the window's unit scans
(portbench/work.py) over the device's busy time, in %.
"""

from portbench.readers import scan_roofline as read  # noqa: F401
