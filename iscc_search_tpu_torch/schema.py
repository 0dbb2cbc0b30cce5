"""
Wire schemas of the index backend without pydantic (port of
``iscc_search_tpu/schema.py``, whose models are pydantic ``BaseModel``s; the
card's Python has no pydantic).

The same classes with the same field names, order and defaults, as
dataclasses. ``model_dump()`` returns what pydantic's returns for the same
values (``mode="json"``, ``exclude_none`` and ``exclude`` as there), and
``model_copy(update=...)`` copies without validation, as pydantic's does.
Construction coerces as pydantic's lax mode does where the backend relies on
it (nested dicts become models, ints become floats in float fields, strings
become ``Status``) and checks the field constraints of the JAX schema
(patterns, lengths, ranges), raising ``ValueError`` where pydantic raises
its ``ValidationError`` (a ``ValueError`` subclass).
"""

from __future__ import annotations

import copy
import dataclasses
import re
from dataclasses import dataclass, field
from enum import Enum
from typing import Any

_ISCC_ID = re.compile(r"^ISCC:[A-Z2-7]{16}$")
_ISCC_CODE = re.compile(r"^ISCC:[A-Z2-7]{16,}$")
_BASE64 = re.compile(r"^[A-Za-z0-9+/_=-]+$")
_INDEX_NAME = re.compile(r"^[a-z][a-z0-9]*$")
_U32_MAX = 4294967295


def _dump(value, mode, exclude_none):
    # type: (Any, str, bool) -> Any
    if isinstance(value, _Model):
        return value.model_dump(mode=mode, exclude_none=exclude_none)
    if isinstance(value, Enum):
        return value.value if mode == "json" else value
    if isinstance(value, dict):
        return {k: _dump(v, mode, exclude_none) for k, v in value.items()}
    if isinstance(value, list) or (mode == "json" and isinstance(value, tuple)):
        return [_dump(v, mode, exclude_none) for v in value]
    return value


def _fail(cls, name, msg):
    raise ValueError(f"{cls.__name__}.{name}: {msg}")


def _pattern(obj, name, regex, optional=True):
    value = getattr(obj, name)
    if value is None and optional:
        return
    if not isinstance(value, str) or not regex.match(value):
        _fail(type(obj), name, f"{value!r} does not match {regex.pattern!r}")


def _number(obj, name, kind, lo=None, hi=None, optional=False):
    """Coerce field ``name`` to ``kind`` (int or float) as pydantic's lax
    mode does and check ``lo <= value <= hi``."""
    value = getattr(obj, name)
    if value is None and optional:
        return
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        _fail(type(obj), name, f"{value!r} is not a number")
    if kind is int:
        if value != int(value):
            _fail(type(obj), name, f"{value!r} is not an integer")
        value = int(value)
    else:
        value = float(value)
    if (lo is not None and value < lo) or (hi is not None and value > hi):
        _fail(type(obj), name, f"{value!r} outside [{lo}, {hi}]")
    setattr(obj, name, value)


def _min_len(obj, name, n):
    value = getattr(obj, name)
    if value is not None and len(value) < n:
        _fail(type(obj), name, f"needs at least {n} items, got {len(value)}")


def _model(cls, value):
    """A nested model from its dict; a missing or unknown field raises
    ValueError, as pydantic's ValidationError does."""
    if isinstance(value, cls) or value is None:
        return value
    if not isinstance(value, dict):
        raise ValueError(f"{cls.__name__}: {value!r} is not a dict")
    try:
        return cls(**value)
    except TypeError as exc:
        raise ValueError(f"{cls.__name__}: {exc}") from None


class _Model:
    """``model_dump`` / ``model_copy`` over the dataclass fields, in order."""

    def model_dump(self, mode="python", exclude_none=False, exclude=None):
        # type: (str, bool, set | None) -> dict
        out = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if (exclude and f.name in exclude) or (exclude_none and value is None):
                continue
            out[f.name] = _dump(value, mode, exclude_none)
        return out

    def model_copy(self, update=None):
        # type: (dict | None) -> _Model
        new = copy.copy(self)
        for name, value in (update or {}).items():
            setattr(new, name, value)
        return new


@dataclass
class HttpError(_Model):
    detail: str | list[str]


@dataclass
class IsccIndex(_Model):
    name: str
    assets: int | None = None
    size: int | None = None
    sizes: dict[str, int] | None = None

    def __post_init__(self):
        if not isinstance(self.name, str) or not 1 <= len(self.name) <= 32:
            _fail(IsccIndex, "name", f"{self.name!r} must be 1-32 characters")
        _pattern(self, "name", _INDEX_NAME, optional=False)
        _number(self, "assets", int, lo=0, optional=True)
        _number(self, "size", int, lo=0, optional=True)
        if self.sizes is not None and any(v < 0 for v in self.sizes.values()):
            _fail(IsccIndex, "sizes", "sizes must be >= 0")


@dataclass
class IsccSimprint(_Model):
    simprint: str
    offset: int
    size: int

    def __post_init__(self):
        if not isinstance(self.simprint, str) or len(self.simprint) < 11:
            _fail(IsccSimprint, "simprint", f"{self.simprint!r} is shorter than 11 characters")
        _pattern(self, "simprint", _BASE64, optional=False)
        _number(self, "offset", int, lo=0, hi=_U32_MAX)
        _number(self, "size", int, lo=0, hi=_U32_MAX)


def _simprint_groups(obj, name, item):
    """Coerce a {type: [item, ...]} field, each list non-empty."""
    groups = getattr(obj, name)
    if groups is None:
        return
    if not isinstance(groups, dict):
        _fail(type(obj), name, "must be a dict of lists")
    for sp_type, items in groups.items():
        if not isinstance(items, list) or not items:
            _fail(type(obj), name, f"group {sp_type!r} must be a non-empty list")
    if item is not str:
        setattr(obj, name, {t: [_model(item, v) for v in items] for t, items in groups.items()})


@dataclass
class IsccQuery(_Model):
    iscc_id: str | None = None
    iscc_code: str | None = None
    units: list[str] | None = None
    simprints: dict[str, list[str]] | None = None

    def __post_init__(self):
        _pattern(self, "iscc_id", _ISCC_ID)
        _pattern(self, "iscc_code", _ISCC_CODE)
        _min_len(self, "units", 1)
        _simprint_groups(self, "simprints", str)


class Status(str, Enum):
    created = "created"
    updated = "updated"


@dataclass
class IsccAddResult(_Model):
    iscc_id: str
    status: Status

    def __post_init__(self):
        _pattern(self, "iscc_id", _ISCC_ID, optional=False)
        self.status = Status(self.status)


class IsccMetadata(_Model):
    """Metadata with extra fields allowed: ``name`` and ``source``, then the
    extras in their given order (pydantic's ``extra="allow"`` dump)."""

    def __init__(self, name=None, source=None, **extra):
        # type: (str | None, str | None, ...) -> None
        for key in ("name", "source"):
            value = locals()[key]
            if value is not None and not isinstance(value, str):
                _fail(IsccMetadata, key, f"{value!r} is not a string")
        self.name = name
        self.source = source
        self.extra = extra

    def model_dump(self, mode="python", exclude_none=False, exclude=None):
        # type: (str, bool, set | None) -> dict
        items = {"name": self.name, "source": self.source, **self.extra}
        return {
            k: _dump(v, mode, exclude_none)
            for k, v in items.items()
            if not (exclude and k in exclude) and not (exclude_none and v is None)
        }

    def __eq__(self, other):
        return isinstance(other, IsccMetadata) and self.model_dump() == other.model_dump()

    def __repr__(self):
        return f"IsccMetadata({self.model_dump()!r})"


@dataclass
class IsccMatchedChunk(_Model):
    query: str
    match: str
    score: float
    freq: int
    offset: int
    size: int
    content: str | None = None

    def __post_init__(self):
        _pattern(self, "query", _BASE64, optional=False)
        _pattern(self, "match", _BASE64, optional=False)
        _number(self, "score", float, lo=0.0, hi=1.0)
        _number(self, "freq", int, lo=1)
        _number(self, "offset", int, lo=0, hi=_U32_MAX)
        _number(self, "size", int, lo=0, hi=_U32_MAX)


@dataclass
class IsccEntry(_Model):
    iscc_id: str | None = None
    iscc_code: str | None = None
    units: list[str] | None = None
    simprints: dict[str, list[IsccSimprint]] | None = None
    metadata: dict[str, Any] | None = None

    def __post_init__(self):
        _pattern(self, "iscc_id", _ISCC_ID)
        _pattern(self, "iscc_code", _ISCC_CODE)
        _min_len(self, "units", 2)
        _simprint_groups(self, "simprints", IsccSimprint)
        if self.metadata is not None and not isinstance(self.metadata, dict):
            _fail(IsccEntry, "metadata", "must be a dict")


def _unit_scores(obj, name):
    scores = getattr(obj, name)
    if not isinstance(scores, dict) or not scores:
        _fail(type(obj), name, "must be a non-empty dict")
    for key, value in scores.items():
        if isinstance(value, bool) or not isinstance(value, (int, float)) or not 0.0 <= value <= 1.0:
            _fail(type(obj), name, f"{key!r}: {value!r} outside [0, 1]")
    setattr(obj, name, {k: float(v) for k, v in scores.items()})


@dataclass
class IsccGlobalMatch(_Model):
    iscc_id: str
    score: float
    types: dict[str, float]
    metadata: IsccMetadata | None = None

    def __post_init__(self):
        _pattern(self, "iscc_id", _ISCC_ID, optional=False)
        _number(self, "score", float, lo=0.0, hi=1.0)
        _unit_scores(self, "types")
        self.metadata = _model(IsccMetadata, self.metadata)


@dataclass
class Types(_Model):
    score: float
    matches: int
    queried: int
    chunks: list[IsccMatchedChunk] | None = None

    def __post_init__(self):
        _number(self, "score", float, lo=0.0, hi=1.0)
        _number(self, "matches", int, lo=0)
        _number(self, "queried", int, lo=1)
        if self.chunks is not None:
            self.chunks = [_model(IsccMatchedChunk, c) for c in self.chunks]


@dataclass
class IsccChunkMatch(_Model):
    iscc_id: str
    score: float
    types: dict[str, Types]
    source: str | None = None
    metadata: IsccMetadata | None = None

    def __post_init__(self):
        _pattern(self, "iscc_id", _ISCC_ID, optional=False)
        _number(self, "score", float, lo=0.0, hi=1.0)
        if not isinstance(self.types, dict) or not self.types:
            _fail(IsccChunkMatch, "types", "must be a non-empty dict")
        self.types = {k: _model(Types, v) for k, v in self.types.items()}
        self.metadata = _model(IsccMetadata, self.metadata)


@dataclass
class IsccSearchResult(_Model):
    query: IsccQuery
    global_matches: list[IsccGlobalMatch]
    chunk_matches: list[IsccChunkMatch] = field(default_factory=list)

    def __post_init__(self):
        self.query = _model(IsccQuery, self.query)
        self.global_matches = [_model(IsccGlobalMatch, m) for m in self.global_matches]
        self.chunk_matches = [_model(IsccChunkMatch, m) for m in self.chunk_matches]
