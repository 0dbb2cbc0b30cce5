"""
The search options the index backend reads (the part of
``iscc_search_tpu/options.py`` ``SearchOptions`` that ``indexes/tpu/index.py``
reads), as a dataclass without pydantic.

Same field names, defaults and ``ISCC_SEARCH_<FIELD>`` environment names;
``from_env()`` and ``override()`` as there, each value checked against the
field's bounds (``ValueError`` where pydantic raises ``ValidationError``).
The server, aggregator and CLI fields are not ported (ROADMAP.md, queue 1,
"Server, options, CLI, remote, aggregator"). One value differs:
``scan_kernel`` takes the port's phase-1 choices (``"auto"``, ``"mma"``,
``"popc"``; ``engine/device_index.py`` ``SCAN_KERNELS``) where the JAX
package takes ``"auto"``, ``"pallas"`` and ``"xla"``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

from iscc_search_tpu_torch.engine.device_index import SCAN_KERNELS

__all__ = ["SearchOptions", "search_opts"]

ENV_PREFIX = "ISCC_SEARCH_"
_TRUE = {"1", "true", "t", "yes", "y", "on"}
_FALSE = {"0", "false", "f", "no", "n", "off"}
# field -> (lower bound, upper bound, strict lower bound) as in the JAX schema
_BOUNDS = {
    "shard_size_units": (1, None, False),
    "shard_size_simprints": (1, None, False),
    "match_threshold_units": (0.0, 1.0, False),
    "match_threshold_simprints": (0.0, 1.0, False),
    "confidence_exponent": (1, None, False),
    "oversampling_factor": (1, None, False),
    "flush_interval": (0, None, False),
    "query_batch_max": (1, None, False),
    "scan_recall_target": (0.0, 1.0, True),
    "mesh_devices": (0, None, False),
    "mesh_hosts": (0, None, False),
    "multihost_control_port": (1, 65535, False),
    "search_batching_window_ms": (0.0, None, False),
}


def _parse(name, kind, raw):
    # type: (str, type, object) -> object
    """``raw`` (an environment string or a value) as a ``kind`` value, the
    way pydantic's lax mode coerces it."""
    if raw is None:
        return None
    if kind is bool:
        if isinstance(raw, bool):
            return raw
        text = str(raw).strip().lower()
        if text in _TRUE or text in _FALSE:
            return text in _TRUE
    elif kind is int and not isinstance(raw, bool):
        try:
            value = float(raw) if isinstance(raw, float) else int(str(raw).strip())
        except ValueError:
            value = None
        if value is not None and value == int(value):
            return int(value)
    elif kind is float and not isinstance(raw, bool):
        try:
            return float(raw)
        except ValueError:
            pass
    elif kind is str and isinstance(raw, str):
        return raw
    raise ValueError(f"{name}: {raw!r} is not a valid {kind.__name__}")


@dataclass
class SearchOptions:
    """Runtime options of the index backend, overridable via ISCC_SEARCH_* environment variables."""

    # Segment sizes (MB): bounded crash-loss windows
    shard_size_units: int = 512
    shard_size_simprints: int = 512
    # Match thresholds / scoring
    match_threshold_units: float = 0.75
    match_threshold_simprints: float = 0.75
    confidence_exponent: int = 4
    oversampling_factor: int = 20
    # Auto-save derived indexes after N dirty mutations (0 disables)
    flush_interval: int = 100000
    # Device/scan knobs
    query_batch_max: int = 512
    scan_recall_target: float | None = None
    mesh_devices: int = 0
    mesh_hosts: int = 0
    multihost_coordinator: str = "localhost"
    multihost_control_port: int = 7801
    scan_kernel: str = "auto"
    search_batching: bool = True
    search_batching_window_ms: float = 0.0

    def __post_init__(self):
        for f in dataclasses.fields(self):
            kind = {"int": int, "float": float, "bool": bool, "str": str}[f.type.split(" |")[0]]
            value = _parse(f.name, kind, getattr(self, f.name))
            if value is None and "None" not in f.type:
                raise ValueError(f"{f.name}: None is not a valid {kind.__name__}")
            lo, hi, strict = _BOUNDS.get(f.name, (None, None, False))
            if value is not None and (
                (lo is not None and (value <= lo if strict else value < lo)) or (hi is not None and value > hi)
            ):
                raise ValueError(f"{f.name}: {value!r} outside {'(' if strict else '['}{lo}, {hi}]")
            object.__setattr__(self, f.name, value)
        if self.scan_kernel not in SCAN_KERNELS:
            raise ValueError(f"scan_kernel: {self.scan_kernel!r} is not one of {SCAN_KERNELS}")

    @classmethod
    def from_env(cls, env=None):
        # type: (dict | None) -> SearchOptions
        """Build options from ISCC_SEARCH_* env vars (unset fields use defaults)."""
        env = os.environ if env is None else env
        kwargs = {}
        for f in dataclasses.fields(cls):
            raw = env.get(ENV_PREFIX + f.name.upper())
            if raw is not None and raw != "":
                kwargs[f.name] = raw
        return cls(**kwargs)

    def override(self, update=None):
        # type: (dict | None) -> SearchOptions
        """Validated copy with per-field updates; an unknown field raises."""
        update = update or {}
        unknown = set(update) - {f.name for f in dataclasses.fields(self)}
        if unknown:
            raise ValueError(f"unknown search options: {sorted(unknown)}")
        return dataclasses.replace(self, **update)


search_opts = SearchOptions.from_env()
