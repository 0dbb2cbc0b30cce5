"""
scan_roofline.mesh: The least time of the window's unit scans on the
cell's four cards, in %: the work of the global partitions
(portbench/work.py, whatever implements it) spread evenly over the cards,
over the union of the cards' busy time. The shards' padding and per-shard
phase 3 count as overhead, so it cannot pass 100%.
"""

from portbench.readers import scan_roofline

CARDS = 4  # the cards of the mesh cells


def read(run):
    share = scan_roofline(run)
    return None if share is None else share / CARDS
