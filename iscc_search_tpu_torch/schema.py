"""
Wire schemas of the index backend without pydantic (port of
``iscc_search_tpu/schema.py``, whose models are pydantic ``BaseModel``s; the
card's Python has no pydantic).

The same classes with the same field names, order and defaults, as
dataclasses. As with pydantic:

- construction coerces as pydantic's lax mode does (nested dicts become
  models, numeric strings and bools become numbers, strings become
  ``Status``), ignores keys that are not fields (``IsccMetadata`` keeps them,
  pydantic's ``extra="allow"``) and checks the field constraints of the JAX
  schema (types, patterns, lengths, ranges);
- a failed check raises ``ValidationError`` (a ``ValueError``), whose
  ``errors()`` gives pydantic's ``type``, ``loc`` and ``msg`` for the failed
  field. pydantic lists every failed field; this lists the first, in field
  order (all missing fields at once);
- ``model_dump()`` returns what pydantic's returns for the same values
  (``mode="json"``, ``exclude_none``, ``exclude_unset`` and ``exclude`` as
  there), ``model_dump_json()`` the same values as compact JSON, and
  ``model_copy(update=...)`` copies without validation, as pydantic's does.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import re
from dataclasses import dataclass, field
from enum import Enum
from typing import Any

_ISCC_ID = re.compile(r"^ISCC:[A-Z2-7]{16}$")
_ISCC_CODE = re.compile(r"^ISCC:[A-Z2-7]{16,}$")
_BASE64 = re.compile(r"^[A-Za-z0-9+/_=-]+$")
_INDEX_NAME = re.compile(r"^[a-z][a-z0-9]*$")
_U32_MAX = 4294967295


class ValidationError(ValueError):
    """A model's fields failed validation; ``errors()`` in pydantic's shape
    (dicts with ``type``, ``loc``, ``msg`` and ``input``)."""

    def __init__(self, title, errors):
        # type: (str, list[dict]) -> None
        self.title = title
        self._errors = [dict(e) for e in errors]
        n = len(self._errors)
        lines = [f"{n} validation error{'' if n == 1 else 's'} for {title}"]
        for e in self._errors:
            lines += [".".join(str(p) for p in e["loc"]), f"  {e['msg']} [type={e['type']}]"]
        super().__init__("\n".join(lines))

    def errors(self):
        # type: () -> list[dict]
        return [dict(e) for e in self._errors]


def _fail(obj, loc, kind, msg, value):
    """Raise the one error of field path ``loc`` (a name or a tuple)."""
    loc = loc if isinstance(loc, tuple) else (loc,)
    raise ValidationError(type(obj).__name__, [{"type": kind, "loc": loc, "msg": msg, "input": value}])


def _plural(n, word):
    return f"{n} {word}{'' if n == 1 else 's'}"


def _bound(value):
    """A bound as pydantic prints it (``0``, not ``0.0``)."""
    return int(value) if float(value).is_integer() else value


def _dump(value, mode, exclude_none, exclude_unset):
    # type: (Any, str, bool, bool) -> Any
    if isinstance(value, _Model):
        return value.model_dump(mode=mode, exclude_none=exclude_none, exclude_unset=exclude_unset)
    if isinstance(value, Enum):
        return value.value if mode == "json" else value
    if isinstance(value, dict):
        return {k: _dump(v, mode, exclude_none, exclude_unset) for k, v in value.items()}
    if isinstance(value, list) or (mode == "json" and isinstance(value, tuple)):
        return [_dump(v, mode, exclude_none, exclude_unset) for v in value]
    return value


def _str(obj, loc, value, regex=None, min_len=None, max_len=None):
    if not isinstance(value, str):
        _fail(obj, loc, "string_type", "Input should be a valid string", value)
    if min_len is not None and len(value) < min_len:
        _fail(obj, loc, "string_too_short", f"String should have at least {_plural(min_len, 'character')}", value)
    if max_len is not None and len(value) > max_len:
        _fail(obj, loc, "string_too_long", f"String should have at most {_plural(max_len, 'character')}", value)
    if regex is not None and not regex.match(value):
        _fail(obj, loc, "string_pattern_mismatch", f"String should match pattern '{regex.pattern}'", value)


def _string(obj, name, regex=None, min_len=None, max_len=None, optional=True):
    value = getattr(obj, name)
    if value is None and optional:
        return
    _str(obj, name, value, regex, min_len, max_len)


def _num(obj, loc, value, kind, lo=None, hi=None):
    """``value`` coerced to ``kind`` (int or float) as pydantic's lax mode
    does, checked against ``lo <= value <= hi``."""
    raw = value
    if isinstance(value, str):
        try:
            value = int(value.strip()) if kind is int else float(value.strip())
        except ValueError:
            if kind is int:
                _fail(obj, loc, "int_parsing", "Input should be a valid integer, unable to parse string as an integer", raw)
            _fail(obj, loc, "float_parsing", "Input should be a valid number, unable to parse string as a number", raw)
    if not isinstance(value, (int, float)):
        if kind is int:
            _fail(obj, loc, "int_type", "Input should be a valid integer", raw)
        _fail(obj, loc, "float_type", "Input should be a valid number", raw)
    if kind is int:
        if value != int(value):
            _fail(obj, loc, "int_from_float", "Input should be a valid integer, got a number with a fractional part", raw)
        value = int(value)
    else:
        value = float(value)
    if value != value and hi is not None:  # NaN: pydantic reports the upper bound
        _fail(obj, loc, "less_than_equal", f"Input should be less than or equal to {_bound(hi)}", raw)
    if lo is not None and value < lo:
        _fail(obj, loc, "greater_than_equal", f"Input should be greater than or equal to {_bound(lo)}", raw)
    if hi is not None and value > hi:
        _fail(obj, loc, "less_than_equal", f"Input should be less than or equal to {_bound(hi)}", raw)
    return value


def _number(obj, name, kind, lo=None, hi=None, optional=False):
    value = getattr(obj, name)
    if value is None and optional:
        return
    setattr(obj, name, _num(obj, name, value, kind, lo, hi))


def _list(obj, loc, value, min_items=0):
    if not isinstance(value, (list, tuple)):
        _fail(obj, loc, "list_type", "Input should be a valid list", value)
    if len(value) < min_items:
        msg = f"List should have at least {_plural(min_items, 'item')} after validation, not {len(value)}"
        _fail(obj, loc, "too_short", msg, value)
    return list(value)


def _dict(obj, loc, value, min_items=0):
    if not isinstance(value, dict):
        _fail(obj, loc, "dict_type", "Input should be a valid dictionary", value)
    if len(value) < min_items:
        msg = f"Dictionary should have at least {_plural(min_items, 'item')} after validation, not {len(value)}"
        _fail(obj, loc, "too_short", msg, value)
    return value


def _model(obj, loc, cls, value, optional=True):
    """A nested model from its dict; its errors carry ``loc`` in front."""
    if isinstance(value, cls) or (value is None and optional):
        return value
    loc = loc if isinstance(loc, tuple) else (loc,)
    if not isinstance(value, dict):
        _fail(obj, loc, "model_type", f"Input should be a valid dictionary or instance of {cls.__name__}", value)
    try:
        return cls(**value)
    except ValidationError as exc:
        errors = [{**e, "loc": loc + tuple(e["loc"])} for e in exc.errors()]
        raise ValidationError(type(obj).__name__, errors) from None


def _models(obj, name, cls):
    """A list field of nested models."""
    items = _list(obj, name, getattr(obj, name))
    setattr(obj, name, [_model(obj, (name, i), cls, v, optional=False) for i, v in enumerate(items)])


def _wire(cls):
    """``dataclass(cls)`` whose constructor, as pydantic's, takes keywords
    only, ignores keys that are not fields, reports missing fields as
    ``ValidationError`` and records the fields it was given (for
    ``exclude_unset``)."""
    cls = dataclass(cls)
    init = cls.__init__
    fields = dataclasses.fields(cls)
    names = {f.name for f in fields}
    required = [
        f.name for f in fields if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING
    ]

    def __init__(self, **values):
        given = {k: v for k, v in values.items() if k in names}
        missing = [name for name in required if name not in given]
        if missing:
            errors = [{"type": "missing", "loc": (n,), "msg": "Field required", "input": values} for n in missing]
            raise ValidationError(cls.__name__, errors)
        object.__setattr__(self, "_fields_set", frozenset(given))
        init(self, **given)

    __init__.__qualname__ = f"{cls.__qualname__}.__init__"
    cls.__init__ = __init__
    return cls


class _Model:
    """``model_dump`` / ``model_dump_json`` / ``model_copy`` over the
    dataclass fields, in order."""

    _fields_set = frozenset()

    @property
    def model_fields_set(self):
        # type: () -> set[str]
        return set(self._fields_set)

    def _items(self):
        return [(f.name, getattr(self, f.name)) for f in dataclasses.fields(self)]

    def model_dump(self, mode="python", exclude_none=False, exclude=None, exclude_unset=False):
        # type: (str, bool, set | None, bool) -> dict
        out = {}
        for name, value in self._items():
            if (exclude and name in exclude) or (exclude_none and value is None):
                continue
            if exclude_unset and name not in self._fields_set:
                continue
            out[name] = _dump(value, mode, exclude_none, exclude_unset)
        return out

    def model_dump_json(self, exclude_none=False, exclude_unset=False):
        # type: (bool, bool) -> str
        """Compact JSON of ``model_dump(mode="json", ...)`` (pydantic's
        separators; float reprs may differ from pydantic's bytes, never in
        value)."""
        data = self.model_dump(mode="json", exclude_none=exclude_none, exclude_unset=exclude_unset)
        return json.dumps(data, separators=(",", ":"), ensure_ascii=False)

    def model_copy(self, update=None):
        # type: (dict | None) -> _Model
        new = copy.copy(self)
        for name, value in (update or {}).items():
            setattr(new, name, value)
        object.__setattr__(new, "_fields_set", self._fields_set | set(update or ()))
        return new


@_wire
class HttpError(_Model):
    detail: str | list[str]


@_wire
class IsccIndex(_Model):
    name: str
    assets: int | None = None
    size: int | None = None
    sizes: dict[str, int] | None = None

    def __post_init__(self):
        _string(self, "name", _INDEX_NAME, min_len=1, max_len=32, optional=False)
        _number(self, "assets", int, lo=0, optional=True)
        _number(self, "size", int, lo=0, optional=True)
        if self.sizes is not None:
            sizes = _dict(self, "sizes", self.sizes)
            self.sizes = {k: _num(self, ("sizes", k), v, int, lo=0) for k, v in sizes.items()}


@_wire
class IsccSimprint(_Model):
    simprint: str
    offset: int
    size: int

    def __post_init__(self):
        _string(self, "simprint", _BASE64, min_len=11, optional=False)
        _number(self, "offset", int, lo=0, hi=_U32_MAX)
        _number(self, "size", int, lo=0, hi=_U32_MAX)


def _strings(obj, name, min_items):
    """An optional list-of-strings field with at least ``min_items`` items."""
    value = getattr(obj, name)
    if value is None:
        return
    items = _list(obj, name, value, min_items)
    for i, item in enumerate(items):
        _str(obj, (name, i), item)
    setattr(obj, name, items)


def _simprint_groups(obj, name, item):
    """Coerce an optional {type: [item, ...]} field, each list non-empty."""
    groups = getattr(obj, name)
    if groups is None:
        return
    out = {}
    for sp_type, items in _dict(obj, name, groups).items():
        items = _list(obj, (name, sp_type), items, 1)
        if item is str:
            for i, v in enumerate(items):
                _str(obj, (name, sp_type, i), v)
            out[sp_type] = items
        else:
            out[sp_type] = [_model(obj, (name, sp_type, i), item, v, optional=False) for i, v in enumerate(items)]
    setattr(obj, name, out)


@_wire
class IsccQuery(_Model):
    iscc_id: str | None = None
    iscc_code: str | None = None
    units: list[str] | None = None
    simprints: dict[str, list[str]] | None = None

    def __post_init__(self):
        _string(self, "iscc_id", _ISCC_ID)
        _string(self, "iscc_code", _ISCC_CODE)
        _strings(self, "units", 1)
        _simprint_groups(self, "simprints", str)


class Status(str, Enum):
    created = "created"
    updated = "updated"


@_wire
class IsccAddResult(_Model):
    iscc_id: str
    status: Status

    def __post_init__(self):
        _string(self, "iscc_id", _ISCC_ID, optional=False)
        try:
            self.status = Status(self.status)
        except ValueError:
            _fail(self, "status", "enum", "Input should be 'created' or 'updated'", self.status)


class IsccMetadata(_Model):
    """Metadata with extra fields allowed: ``name`` and ``source``, then the
    extras in their given order (pydantic's ``extra="allow"`` dump)."""

    def __init__(self, **values):
        # type: (...) -> None
        for key in ("name", "source"):
            if values.get(key) is not None:
                _str(self, key, values[key])
        self._fields_set = frozenset(values)
        self.name = values.pop("name", None)
        self.source = values.pop("source", None)
        self.extra = values

    def _items(self):
        return [("name", self.name), ("source", self.source), *self.extra.items()]

    def __eq__(self, other):
        return isinstance(other, IsccMetadata) and self.model_dump() == other.model_dump()

    def __repr__(self):
        return f"IsccMetadata({self.model_dump()!r})"


@_wire
class IsccMatchedChunk(_Model):
    query: str
    match: str
    score: float
    freq: int
    offset: int
    size: int
    content: str | None = None

    def __post_init__(self):
        _string(self, "query", _BASE64, optional=False)
        _string(self, "match", _BASE64, optional=False)
        _number(self, "score", float, lo=0.0, hi=1.0)
        _number(self, "freq", int, lo=1)
        _number(self, "offset", int, lo=0, hi=_U32_MAX)
        _number(self, "size", int, lo=0, hi=_U32_MAX)
        _string(self, "content")


@_wire
class IsccEntry(_Model):
    iscc_id: str | None = None
    iscc_code: str | None = None
    units: list[str] | None = None
    simprints: dict[str, list[IsccSimprint]] | None = None
    metadata: dict[str, Any] | None = None

    def __post_init__(self):
        _string(self, "iscc_id", _ISCC_ID)
        _string(self, "iscc_code", _ISCC_CODE)
        _strings(self, "units", 2)
        _simprint_groups(self, "simprints", IsccSimprint)
        if self.metadata is not None:
            _dict(self, "metadata", self.metadata)


def _unit_scores(obj, name):
    """A non-empty {type: score in [0, 1]} field."""
    scores = _dict(obj, name, getattr(obj, name), 1)
    setattr(obj, name, {k: _num(obj, (name, k), v, float, lo=0.0, hi=1.0) for k, v in scores.items()})


@_wire
class IsccGlobalMatch(_Model):
    iscc_id: str
    score: float
    types: dict[str, float]
    metadata: IsccMetadata | None = None

    def __post_init__(self):
        _string(self, "iscc_id", _ISCC_ID, optional=False)
        _number(self, "score", float, lo=0.0, hi=1.0)
        _unit_scores(self, "types")
        self.metadata = _model(self, "metadata", IsccMetadata, self.metadata)


@_wire
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
            _models(self, "chunks", IsccMatchedChunk)


@_wire
class IsccChunkMatch(_Model):
    iscc_id: str
    score: float
    types: dict[str, Types]
    source: str | None = None
    metadata: IsccMetadata | None = None

    def __post_init__(self):
        _string(self, "iscc_id", _ISCC_ID, optional=False)
        _number(self, "score", float, lo=0.0, hi=1.0)
        types = _dict(self, "types", self.types, 1)
        self.types = {k: _model(self, ("types", k), Types, v, optional=False) for k, v in types.items()}
        _string(self, "source")
        self.metadata = _model(self, "metadata", IsccMetadata, self.metadata)


@_wire
class IsccSearchResult(_Model):
    query: IsccQuery
    global_matches: list[IsccGlobalMatch]
    chunk_matches: list[IsccChunkMatch] = field(default_factory=list)

    def __post_init__(self):
        self.query = _model(self, "query", IsccQuery, self.query, optional=False)
        _models(self, "global_matches", IsccGlobalMatch)
        _models(self, "chunk_matches", IsccChunkMatch)
