"""
A copy of ``iscc_search_tpu/models.py`` (the port imports nothing of the JAX package);
``tests/test_torch_host_copies.py`` holds every function of it to the
original's bytecode, the package name aside.

ISCC object model — typed wrappers over raw ISCC digests.

Functional parity with the reference object model (iscc_search/models.py:68-420):
header parsing, unit-type strings ("CONTENT_TEXT_V0"), ISCC-CODE -> units
decomposition (including the WIDE special case), ISCC-ID <-> uint64 keys, and
the minimal IsccItem container. Built on the self-contained codec in
:mod:`iscc_search_tpu_torch.codec` (the environment has no iscc-core).
"""

from __future__ import annotations

import json
from functools import cached_property

import numpy as np

from iscc_search_tpu_torch import codec as ic

# 2-byte header -> type string (see IsccBase.iscc_type)
_TYPE_CACHE = {}  # type: dict[bytes, str]


def new_iscc_id():
    # type: () -> bytes
    """Generate a random REALM-0 ISCC-ID digest (52-bit us timestamp + 12-bit hub id)."""
    return ic.new_iscc_id_digest(realm_id=0)


def split_iscc_sequence(data):
    # type: (bytes) -> list[bytes]
    """
    Split a concatenation of ISCC-DIGESTS into individual digests.

    Mirrors reference models.py:45-65: walks headers, derives each unit's byte
    length from its decoded header length field.
    """
    units = []
    offset = 0
    try:
        while offset < len(data):
            fields = ic.decode_header(data[offset:])
            ln_bits = ic.decode_length(fields.maintype, fields.length, fields.subtype)
            unit_len = 2 + ln_bits // 8
            if offset + unit_len > len(data):
                raise ValueError("truncated ISCC-DIGEST in sequence")
            units.append(data[offset : offset + unit_len])
            offset += unit_len
    except ValueError:
        raise
    except Exception as e:  # pragma: no cover - defensive
        raise ValueError(f"Invalid ISCC-SEQUENCE: {e}")
    return units


class IsccBase:
    """Base class for ISCC objects (string/bytes conversion, header access)."""

    __slots__ = ("digest", "__dict__")

    def __init__(self, iscc):
        # type: (str | bytes) -> None
        if isinstance(iscc, str):
            self.digest = ic.decode_base32(ic.iscc_clean(iscc))
        elif isinstance(iscc, (bytes, bytearray, memoryview)):
            self.digest = bytes(iscc)
        else:
            raise TypeError("`iscc` must be str, bytes")

    @property
    def body(self):
        # type: () -> bytes
        """ISCC-BODY bytes (payload after the 2-byte header)."""
        return self.digest[2:]

    @cached_property
    def fields(self):
        # type: () -> ic.IsccTuple
        """Decoded header fields (maintype, subtype, version, length, body)."""
        return ic.decode_header(self.digest)

    @cached_property
    def iscc_type(self):
        # type: () -> str
        """Type string "MAINTYPE_SUBTYPE_VERSION" (e.g. "CONTENT_TEXT_V0")."""
        # All currently defined field values fit a 2-byte header, so the type
        # string is fully determined by those bytes — cache process-wide
        # (unit-type resolution dominates bulk-ingest profiles otherwise).
        header = self.digest[:2]
        # 0x88 in either byte marks a multi-nibble (extended) header field:
        # those types are not 2-byte-determined, so they bypass the cache.
        cacheable = not ((header[0] | header[1]) & 0x88)
        if cacheable:
            cached = _TYPE_CACHE.get(header)
            if cached is not None:
                return cached
        mt = ic.MT(self.fields.maintype)
        st_enum = ic.SUBTYPE_MAP.get((mt, ic.VS(self.fields.version)), ic.ST)
        st = st_enum(self.fields.subtype)
        vs = ic.VS(self.fields.version)
        result = f"{mt.name}_{st.name}_{vs.name}"
        if cacheable:
            _TYPE_CACHE[header] = result
        return result

    def __str__(self):
        # type: () -> str
        return f"ISCC:{ic.encode_base32(self.digest)}"

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"{type(self).__name__}('{self}')"

    def __len__(self):
        # type: () -> int
        """ISCC-BODY bit length (64, 128, 192, or 256)."""
        return len(self.digest[2:]) * 8

    def __bytes__(self):
        # type: () -> bytes
        return self.digest

    def __eq__(self, other):
        if isinstance(other, IsccBase):
            return self.digest == other.digest
        return NotImplemented

    def __hash__(self):
        return hash(self.digest)


class IsccID(IsccBase):
    """ISCC-ID: globally unique asset identifier (header + 8-byte body)."""

    _iscc_id_headers = (
        ic.encode_header(ic.MT.ID, 0, ic.VS.V1, 0),
        ic.encode_header(ic.MT.ID, 1, ic.VS.V1, 0),
    )

    def __int__(self):
        """64-bit integer key from the ISCC-ID body (header info is dropped)."""
        return int.from_bytes(self.body, "big", signed=False)

    @property
    def realm_id(self):
        # type: () -> int
        return self.fields.subtype

    @classmethod
    def from_int(cls, iscc_id, realm_id):
        # type: (int, int) -> IsccID
        if realm_id not in (0, 1):
            # A negative index would silently wrap to the other realm
            raise ValueError(f"Unsupported realm_id: {realm_id} (only 0 and 1 are defined)")
        return cls(cls._iscc_id_headers[realm_id] + iscc_id.to_bytes(8, "big", signed=False))

    # 10-bit-group base32 table: a 10-byte ISCC-ID digest is 80 bits = eight
    # 2-char groups. stdlib base64._b32encode is pure Python and ~2x slower.
    _B32_PAIRS = [a + b for a in "ABCDEFGHIJKLMNOPQRSTUVWXYZ234567" for b in "ABCDEFGHIJKLMNOPQRSTUVWXYZ234567"]
    # Header as a high-shifted int so the whole digest is one 80-bit value
    _iscc_id_header_ints = tuple(int.from_bytes(h, "big") << 64 for h in _iscc_id_headers)

    @classmethod
    def str_from_int(cls, iscc_id, realm_id):
        # type: (int, int) -> str
        """Canonical string straight from the integer key.

        Bit-identical to ``str(IsccID.from_int(...))`` but skips object
        construction, header re-parsing, and stdlib base32 — the
        search-enrichment hot path builds one ISCC-ID string per match."""
        if realm_id not in (0, 1):
            raise ValueError(f"Unsupported realm_id: {realm_id} (only 0 and 1 are defined)")
        if iscc_id < 0 or iscc_id >> 64:
            # from_int's to_bytes(8) raises here; keep failing loudly rather
            # than OR-ing a bad key into the header bits
            raise OverflowError("iscc_id key out of uint64 range")
        v = cls._iscc_id_header_ints[realm_id] | iscc_id
        t = cls._B32_PAIRS
        return (
            "ISCC:" + t[(v >> 70) & 1023] + t[(v >> 60) & 1023] + t[(v >> 50) & 1023] + t[(v >> 40) & 1023]
            + t[(v >> 30) & 1023] + t[(v >> 20) & 1023] + t[(v >> 10) & 1023] + t[v & 1023]
        )

    @classmethod
    def from_body(cls, body, realm_id):
        # type: (bytes, int) -> IsccID
        if realm_id not in (0, 1):
            raise ValueError(f"Unsupported realm_id: {realm_id} (only 0 and 1 are defined)")
        return cls(cls._iscc_id_headers[realm_id] + body)

    @classmethod
    def random(cls):
        # type: () -> IsccID
        return cls(new_iscc_id())


class IsccUnit(IsccBase):
    """ISCC-UNIT: single-algorithm component (header + 8..32-byte body)."""

    @property
    def unit_type(self):
        # type: () -> str
        return self.iscc_type

    def __array__(self, dtype=np.uint8, copy=None):
        arr = np.frombuffer(self.body, dtype=dtype)
        if copy:
            return arr.copy()
        return arr


class IsccCode(IsccBase):
    """ISCC-CODE: composite of multiple ISCC-UNIT bodies."""

    @cached_property
    def units(self):
        # type: () -> list[IsccUnit]
        """
        Decompose into constituent ISCC-UNITs.

        Mirrors reference models.py:267-316: dynamic units (META/SEMANTIC/
        CONTENT) carry the composite's subtype (META always NONE), static
        DATA/INSTANCE carry ST.NONE; WIDE composites decompose to 128-bit
        DATA+INSTANCE. Raw ISCC-UNIT digests pass through with tail
        continuation (a sequence of unit digests also decodes).
        """
        units = []
        raw = self.digest
        while raw:
            mt, st, vs, ln, body = ic.decode_header(raw)
            if mt != ic.MT.ISCC:
                ln_bits = ic.decode_length(mt, ln)
                unit_digest = ic.encode_header(mt, st, vs, ln) + body[: ln_bits // 8]
                units.append(IsccUnit(unit_digest))
                raw = body[ln_bits // 8 :]
                continue

            if st == ic.ST_ISCC.WIDE:
                if len(body) != 32:
                    raise ValueError(f"ISCC-CODE body length wrong for WIDE composite: {len(body)} bytes != 32")
                data_ln = ic.encode_length(ic.MT.DATA, 128)
                inst_ln = ic.encode_length(ic.MT.INSTANCE, 128)
                units.append(IsccUnit(ic.encode_header(ic.MT.DATA, ic.ST.NONE, vs, data_ln) + body[:16]))
                units.append(IsccUnit(ic.encode_header(ic.MT.INSTANCE, ic.ST.NONE, vs, inst_ln) + body[16:32]))
                break

            main_types = ic.decode_units(ln)
            expected = (len(main_types) + 2) * 8
            if len(body) != expected:
                # A valid composite body is exactly this size; the negative
                # slices below would otherwise read DATA/INSTANCE from wrong
                # byte ranges of a truncated OR padded composite.
                raise ValueError(f"ISCC-CODE body length wrong: {len(body)} bytes != {expected}")
            for idx, mtype in enumerate(main_types):
                stype = ic.ST.NONE if mtype == ic.MT.META else st
                unit_ln = ic.encode_length(mtype, 64)
                units.append(
                    IsccUnit(ic.encode_header(mtype, stype, vs, unit_ln) + body[idx * 8 : (idx + 1) * 8])
                )
            data_ln = ic.encode_length(ic.MT.DATA, 64)
            inst_ln = ic.encode_length(ic.MT.INSTANCE, 64)
            units.append(IsccUnit(ic.encode_header(ic.MT.DATA, ic.ST.NONE, vs, data_ln) + body[-16:-8]))
            units.append(IsccUnit(ic.encode_header(ic.MT.INSTANCE, ic.ST.NONE, vs, inst_ln) + body[-8:]))
            break
        return units


class IsccItem:
    """
    Minimal ISCC container for efficient indexing (binary id + unit digests).

    Functional twin of the reference's msgspec struct (models.py:327-420)
    without the msgspec dependency.
    """

    __slots__ = ("id_data", "units_data")

    def __init__(self, id_data, units_data):
        # type: (bytes, bytes) -> None
        self.id_data = id_data
        self.units_data = units_data

    def __eq__(self, other):
        if isinstance(other, IsccItem):
            return self.id_data == other.id_data and self.units_data == other.units_data
        return NotImplemented

    def __hash__(self):
        return hash((self.id_data, self.units_data))

    @classmethod
    def new(cls, iscc_id, iscc_code=None, units=None):
        # type: (str | bytes, str | bytes | None, list | None) -> IsccItem
        if units:
            units_data = b"".join(IsccUnit(u).digest for u in units)
        elif iscc_code:
            units_data = b"".join(u.digest for u in IsccCode(iscc_code).units)
        else:
            raise ValueError("Either iscc_code or units must be provided")
        return cls(IsccID(iscc_id).digest, units_data)

    @classmethod
    def from_dict(cls, data):
        # type: (dict) -> IsccItem
        iscc_id = data.get("iscc_id")
        if iscc_id is None:
            iscc_id = str(IsccID.random())
        return cls.new(iscc_id, iscc_code=data.get("iscc_code"), units=data.get("units"))

    @property
    def iscc_id(self):
        # type: () -> str
        return f"ISCC:{ic.encode_base32(self.id_data)}"

    @property
    def iscc_code(self):
        # type: () -> str
        return ic.gen_iscc_code_v0(self.units, wide=True)["iscc"]

    @property
    def units(self):
        # type: () -> list[str]
        return [f"ISCC:{ic.encode_base32(u)}" for u in split_iscc_sequence(self.units_data)]

    @property
    def dict(self):
        # type: () -> dict
        return dict(iscc_id=self.iscc_id, iscc_code=self.iscc_code, units=self.units)

    @property
    def json(self):
        # type: () -> bytes
        return json.dumps(self.dict, separators=(",", ":")).encode("utf-8")
