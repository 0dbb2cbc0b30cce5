"""
crosscard_bytes_per_query: Bytes of shard candidates (scores and rows)
copied from the other cards to the lead card per unit query: the bytes
count of the mesh.merge spans over the queries count of the search spans.
"""

from portbench.mesh_spans import crosscard_bytes_per_query as read  # noqa: F401
