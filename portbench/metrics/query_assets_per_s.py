"""
query_assets_per_s: Query assets answered in the window per second of the
window.
"""

from portbench.readers import items_per_s as read  # noqa: F401
