"""
merge_candidates_per_query.units: Candidates read back from the device and
merged on the host per query (the search.merge span's count over the search
span's queries).
"""

from portbench.program_spans import merge_candidates_per_query as read  # noqa: F401
