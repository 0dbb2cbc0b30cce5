"""
CLI multi-index configuration (copy of ``iscc_search_tpu/config.py``).

The second half of the dual-config split (see options.py): a persistent JSON
config for CLI workflows with named local/remote indexes and a git-like
active-index concept (add/list/use/remove plus auto-discovery of index
directories).

The models are the port's wire-type dataclasses (``schema._wire``) in place
of pydantic models, with the same fields, defaults, ``model_dump()`` and
checks; a failed check raises the port's ``schema.ValidationError``. An
``indexes`` entry given as a dict is resolved as pydantic's smart union
resolves it: each of ``LocalIndexConfig`` (needs ``path``) and
``RemoteIndexConfig`` (needs ``url`` and ``index_name``) is tried, and where
both validate the one with more fields given wins (``LocalIndexConfig`` on a
tie). ``discover()`` reads the port's ``options.user_data_dir()`` (no
platformdirs).

Config file: ~/.iscc-search-tpu/config.json, the JAX package's own (a
configuration written by either package loads in the other), overridable
for tests.
"""

from __future__ import annotations

import json
import re
from dataclasses import field
from pathlib import Path

from iscc_search_tpu_torch.schema import ValidationError, _Model, _dict, _fail, _number, _string, _wire

_SCHEME = re.compile(r"^(tpu|kv|usearch|lmdb)$")


def default_config_dir():
    # type: () -> Path
    """Resolved at call time (not import) so HOME changes take effect —
    required for test isolation and matches shell-tool expectations."""
    return Path.home() / ".iscc-search-tpu"


@_wire
class LocalIndexConfig(_Model):
    """A named local index rooted at a directory (tpu:// or kv:// backend)."""

    type: str = "local"
    path: str = field(kw_only=True)  # required, in pydantic's field order
    scheme: str = "tpu"

    def __post_init__(self):
        _string(self, "type", optional=False)
        _string(self, "path", optional=False)
        _string(self, "scheme", _SCHEME, optional=False)


@_wire
class RemoteIndexConfig(_Model):
    """A named remote index on an API server."""

    type: str = "remote"
    url: str = field(kw_only=True)
    index_name: str = field(kw_only=True)
    api_key: str | None = None

    def __post_init__(self):
        _string(self, "type", optional=False)
        _string(self, "url", optional=False)
        _string(self, "index_name", optional=False)
        _string(self, "api_key")


def _index_config(obj, name, value):
    # type: (Config, str, object) -> LocalIndexConfig | RemoteIndexConfig
    """One ``indexes`` entry: a model instance as given, a dict as the
    member of the union it validates as (see the module docstring)."""
    if isinstance(value, (LocalIndexConfig, RemoteIndexConfig)):
        return value
    if not isinstance(value, dict):
        _fail(obj, ("indexes", name, "LocalIndexConfig"), "model_type",
              "Input should be a valid dictionary or instance of LocalIndexConfig", value)
    valid, errors = [], []
    for cls in (LocalIndexConfig, RemoteIndexConfig):
        try:
            valid.append(cls(**value))
        except ValidationError as exc:
            errors += [{**e, "loc": ("indexes", name, cls.__name__) + tuple(e["loc"])} for e in exc.errors()]
    if not valid:
        raise ValidationError(type(obj).__name__, errors)
    return max(valid, key=lambda model: len(model.model_fields_set))


@_wire
class Config(_Model):
    """Persisted configuration document."""

    version: int = 1
    active: str | None = None
    indexes: dict = field(default_factory=dict)  # name -> LocalIndexConfig | RemoteIndexConfig

    def __post_init__(self):
        _number(self, "version", int)
        _string(self, "active")
        indexes = _dict(self, "indexes", self.indexes)
        self.indexes = {name: _index_config(self, name, value) for name, value in indexes.items()}


class ConfigManager:
    """Load/save/modify the persistent CLI configuration."""

    def __init__(self, config_dir=None):
        # type: (str | Path | None) -> None
        self.config_dir = Path(config_dir) if config_dir else default_config_dir()
        self.config_path = self.config_dir / "config.json"
        self._config = None  # type: Config | None

    @property
    def config(self):
        # type: () -> Config
        if self._config is None:
            self._config = self._load()
        return self._config

    def _load(self):
        # type: () -> Config
        if self.config_path.exists():
            try:
                return Config(**json.loads(self.config_path.read_text()))
            except Exception:
                # A corrupt config file must not brick the CLI; start fresh.
                return Config()
        return Config()

    def save(self):
        # type: () -> None
        self.config_dir.mkdir(parents=True, exist_ok=True)
        tmp = self.config_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.config.model_dump(mode="json"), indent=2))
        tmp.replace(self.config_path)

    # -- index registry -------------------------------------------------------

    def add_local(self, name, path, scheme="tpu", use=True):
        # type: (str, str | Path, str, bool) -> None
        """Register a local index directory under a name."""
        if name in self.config.indexes:
            raise ValueError(f"Index '{name}' already configured")
        self.config.indexes[name] = LocalIndexConfig(path=str(Path(path).expanduser().resolve()), scheme=scheme)
        if use or self.config.active is None:
            self.config.active = name
        self.save()

    def add_remote(self, name, url, index_name, api_key=None, use=True):
        # type: (str, str, str, str | None, bool) -> None
        """Register a remote index (server URL + index name) under a name."""
        if name in self.config.indexes:
            raise ValueError(f"Index '{name}' already configured")
        self.config.indexes[name] = RemoteIndexConfig(url=url, index_name=index_name, api_key=api_key)
        if use or self.config.active is None:
            self.config.active = name
        self.save()

    def remove(self, name):
        # type: (str) -> None
        if name not in self.config.indexes:
            raise KeyError(f"Index '{name}' not configured")
        del self.config.indexes[name]
        if self.config.active == name:
            self.config.active = next(iter(self.config.indexes), None)
        self.save()

    def use(self, name):
        # type: (str) -> None
        if name not in self.config.indexes:
            raise KeyError(f"Index '{name}' not configured")
        self.config.active = name
        self.save()

    def list(self):
        # type: () -> dict
        return dict(self.config.indexes)

    def get_active(self):
        # type: () -> tuple[str, LocalIndexConfig | RemoteIndexConfig] | None
        name = self.config.active
        if name is None or name not in self.config.indexes:
            return None
        return name, self.config.indexes[name]

    def discover(self, base_dir=None):
        # type: (str | Path | None) -> list[str]
        """
        Auto-discover index directories under the default data dir and
        register unknown ones by directory name.
        """
        from iscc_search_tpu_torch.options import user_data_dir

        base = Path(base_dir) if base_dir else Path(user_data_dir())
        found = []
        if not base.exists():
            return found
        # LocalIndexConfig.path is the manager BASE directory (the index lives
        # at {path}/{name}/store — see get_active_index/_local_manager and
        # `index remove --delete-data`). Registering the entry dir itself
        # would make every consumer open an empty nested index beside the
        # real data.
        base_path = str(base.resolve())
        for entry in sorted(base.iterdir()):
            if entry.is_dir() and (entry / "store").exists():
                if entry.name in self.config.indexes:
                    continue
                self.config.indexes[entry.name] = LocalIndexConfig(path=base_path, scheme="tpu")
                found.append(entry.name)
        if found:
            if self.config.active is None:
                self.config.active = found[0]
            self.save()
        return found
