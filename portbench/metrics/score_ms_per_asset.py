"""
score_ms_per_asset: Host ms per query asset outside the sweep_fn the harness
passes in: the simprint engine's per-asset scoring.
"""

from portbench.readers import score_ms_per_asset as read  # noqa: F401
