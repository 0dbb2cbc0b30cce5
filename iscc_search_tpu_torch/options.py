"""
Configuration options of the port: the deployment settings of the server
and the index backend from ``ISCC_SEARCH_*`` environment variables (port of
``iscc_search_tpu/options.py``, a pydantic model there), as a dataclass, and
the backend factory by URI (``get_index``, ``manager_for``).

Same field names, defaults, bounds, patterns and ``ISCC_SEARCH_<FIELD>``
environment names; ``from_env()`` and ``override()`` as there, each value
checked against the field's bounds (``ValueError`` where pydantic raises
``ValidationError``). Not ported: the fields only the JAX engine reads
(``scan_chunk_rows``, ``compile_cache_dir``: the port's kernels are cached
by source hash under ``build/torch_kernels/``); ``override()`` drops
those keys, so a JAX options dict applies unchanged, and ``from_env()``
ignores their variables.
``distributed`` joins a ``torch.distributed`` cluster
(``ISCC_SEARCH_COORDINATOR``, ``_NUM_HOSTS``, ``_HOST_ID``) where the JAX
package calls ``jax.distributed.initialize()``. ``scan_kernel`` takes the
JAX values ``"auto"``, ``"pallas"`` and ``"xla"`` and the port's forced
phase-1 kernels ``"mma"``, ``"mma_small"`` and ``"popc"``
(``engine/device_index.py`` ``SCAN_KERNELS``). The default ``index_uri`` is
the platform data directory platformdirs gives on Linux (``$XDG_DATA_HOME``
or ``~/.local/share``, then ``iscc-search-tpu``), without platformdirs.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from pathlib import Path
from urllib.parse import urlparse

from iscc_search_tpu_torch.aggregator import NETWORKS
from iscc_search_tpu_torch.engine.device_index import SCAN_KERNELS

__all__ = ["SearchOptions", "search_opts", "get_index"]

ENV_PREFIX = "ISCC_SEARCH_"
_TRUE = {"1", "true", "t", "yes", "y", "on"}
_FALSE = {"0", "false", "f", "no", "n", "off"}
# field -> (lower bound, upper bound, strict lower bound) as in the JAX schema
_BOUNDS = {
    "http_threads": (1, None, False),
    "http_max_pending": (0, None, False),
    "http_queue_deadline_ms": (0.0, None, False),
    "scaleout_breaker_ms": (0.0, None, False),
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
    "aggregator_poll_interval": (1, None, False),
    "aggregator_hub_refresh_interval": (1, None, False),
    "aggregator_convert_workers": (0, 8, False),
    "sentry_traces_sample_rate": (0.0, 1.0, False),
}
HTTP_BACKENDS = ("pooled", "wsgiref")  # the JAX field's pattern ^(pooled|wsgiref)$
JAX_ONLY = ("scan_chunk_rows", "compile_cache_dir")  # JAX fields that only the JAX engine reads


def user_data_dir():
    # type: () -> str
    """The data directory platformdirs gives ``iscc-search-tpu`` on Linux."""
    base = os.environ.get("XDG_DATA_HOME", "")
    if not base.strip():
        base = os.path.expanduser("~/.local/share")
    return os.path.join(base, "iscc-search-tpu")


def _default_convert_workers():
    # type: () -> int
    """1 where more than one core is available to this process, else 0 (as
    the JAX default)."""
    return 1 if len(getattr(os, "sched_getaffinity", lambda _: range(os.cpu_count() or 1))(0)) > 1 else 0


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
    """Runtime options, overridable via ISCC_SEARCH_* environment variables."""

    # Server
    index_uri: str = field(default_factory=lambda: f"tpu:///{Path(user_data_dir()).as_posix()}")
    api_secret: str | None = None
    cors_origins: str = "*"
    host: str = "0.0.0.0"
    port: int = 8000
    workers: int | None = None
    http_backend: str = "pooled"
    http_threads: int = 16
    http_max_pending: int = 64
    http_queue_deadline_ms: float = 500.0
    scaleout_breaker_ms: float = 50.0
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
    distributed: bool = False
    multihost_index: str | None = None
    # Aggregator mode
    aggregator_network: str | None = None
    aggregator_hub_list_url: str | None = None
    aggregator_poll_interval: int = 60
    aggregator_hub_refresh_interval: int = 3600
    aggregator_convert_workers: int = field(default_factory=_default_convert_workers)
    # Logging and error tracking
    log_level: str = "info"
    sentry_dsn: str | None = None
    sentry_traces_sample_rate: float = 0.05

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
        if self.http_backend not in HTTP_BACKENDS:
            raise ValueError(f"http_backend: {self.http_backend!r} is not one of {HTTP_BACKENDS}")
        if not self.aggregator_network:
            self.aggregator_network = None
        elif self.aggregator_network not in NETWORKS:
            raise ValueError(
                f"aggregator_network must be one of {sorted(NETWORKS)}, got: '{self.aggregator_network}'"
            )

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
        """Validated copy with per-field updates; an unknown field raises.
        The fields only the JAX engine reads (``JAX_ONLY``) are dropped."""
        update = {name: value for name, value in (update or {}).items() if name not in JAX_ONLY}
        unknown = set(update) - {f.name for f in dataclasses.fields(self)}
        if unknown:
            raise ValueError(f"unknown search options: {sorted(unknown)}")
        return dataclasses.replace(self, **update)

    @property
    def cors_origins_list(self):
        # type: () -> list[str]
        return [origin.strip() for origin in self.cors_origins.split(",")]

    @property
    def aggregator_mode(self):
        # type: () -> bool
        return self.aggregator_network is not None

    @property
    def aggregator_index_name(self):
        # type: () -> str
        return NETWORKS[self.aggregator_network]["index"]

    @property
    def aggregator_hub_list_source(self):
        # type: () -> str
        if self.aggregator_hub_list_url:
            return self.aggregator_hub_list_url
        return f"https://raw.githubusercontent.com/iscc/iscc-hub/main/hubs/{self.aggregator_network}.yaml"


search_opts = SearchOptions.from_env()


def _normalize_uri_path(path):
    # type: (str) -> str
    import sys

    if sys.platform == "win32" and path.startswith("/") and len(path) > 2 and path[2] == ":":  # pragma: no cover
        return path[1:]
    if path.startswith("//"):  # pragma: no cover - URI with extra slashes
        return path[1:]
    return path


def get_index(uri=None, device="cuda"):
    # type: (str | None, str) -> ...
    """
    Backend factory by URI scheme.

    - memory:// -> MemoryIndex (no persistence)
    - kv:///path (alias lmdb://) -> KvIndexManager (host-store exact/prefix search)
    - tpu:///path (alias usearch://) -> TpuIndexManager (device scan engine on ``device``)
    """
    uri = uri if uri is not None else search_opts.index_uri

    if uri == "memory://" or uri.startswith("memory://"):
        from iscc_search_tpu_torch.indexes.memory import MemoryIndex

        return MemoryIndex()

    if "://" not in uri:
        supported = ["memory://", "kv:///path", "tpu:///path"]
        raise ValueError(
            f"ISCC_SEARCH_INDEX_URI requires explicit scheme, got: '{uri}'. Supported schemes: {', '.join(supported)}"
        )

    parsed = urlparse(uri)
    path = _normalize_uri_path(parsed.path)
    return manager_for(parsed.scheme, path, uri=uri, device=device)


def manager_for(scheme, path, uri=None, device="cuda"):
    # type: (str, str, str | None, str) -> ...
    """Scheme -> backend manager over a filesystem path; ``tpu`` engines run
    on ``device`` (the card unless the caller asks for the CPU)."""
    if scheme in ("kv", "lmdb"):
        from iscc_search_tpu_torch.indexes.kv import KvIndexManager

        return KvIndexManager(path)

    if scheme in ("tpu", "usearch"):
        from iscc_search_tpu_torch.indexes.tpu import TpuIndexManager

        return TpuIndexManager(path, device=device)

    supported = ["memory://", "kv://", "tpu://"]
    raise ValueError(
        f"Unsupported ISCC_SEARCH_INDEX_URI scheme: '{uri or scheme}'. Supported schemes: {', '.join(supported)}."
    )
