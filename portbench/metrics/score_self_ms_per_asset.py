"""
score_self_ms_per_asset: Host ms per query asset in the simprint engine's
own scoring (the simprint.score spans of _score_query_asset), without the
harness's handling of the matches.
"""

from portbench.program_spans import score_self_ms_per_asset as read  # noqa: F401
