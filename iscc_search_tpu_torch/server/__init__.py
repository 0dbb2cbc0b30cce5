"""The serving layer's metrics registry (the rest of ``server/`` is not ported yet)."""
