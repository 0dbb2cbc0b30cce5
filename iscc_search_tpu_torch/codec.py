"""
A copy of ``iscc_search_tpu/codec.py`` (the port imports nothing of the JAX package);
``tests/test_torch_host_copies.py`` holds every function of it to the
original's bytecode, the package name aside.

ISCC codec core — self-contained reimplementation of the iscc-core subset used by
the reference engine (SURVEY.md §2.2: header encode/decode,
base32/base64, unit-type taxonomy, ISCC-CODE composition/decomposition, ISCC-ID
generation).

Wire format (ISO 24138):

- An ISCC-DIGEST is ISCC-HEADER + ISCC-BODY.
- The ISCC-HEADER packs four fields (MainType, SubType, Version, Length) as
  variable-length nibbles ("varnibble"), padded to a whole number of bytes.
  For all currently defined values every field fits in one nibble, so headers
  are 2 bytes.
- Varnibble encoding: values 0-7 -> ``0xxx`` (4 bits); 8-71 -> ``10xxxxxx``
  (8 bits, value-8); 72-583 -> ``110x*9`` (12 bits, value-72);
  584-4679 -> ``1110x*12`` (16 bits, value-584).
- Canonical text form is ``ISCC:`` + RFC4648 base32 (upper case, no padding).

Verified against ground-truth ISCC strings found in the reference repo's tests
and docs (e.g. ``ISCC:AAAUHBUDQUT3LPWR`` = META_NONE_V0 64-bit,
``ISCC:MAIGIIFJRDGEQQAA`` = ID_REALM_0_V1, ``ISCC:KEC...`` = ISCC IMAGE
composite with META+CONTENT units).
"""

from __future__ import annotations

import base64
import enum
import os
import time
from typing import NamedTuple

__all__ = [
    "MT",
    "ST",
    "ST_CC",
    "ST_ISCC",
    "ST_ID_REALM",
    "VS",
    "UNITS",
    "IsccTuple",
    "encode_varnibble",
    "decode_varnibble",
    "encode_header",
    "decode_header",
    "encode_length",
    "decode_length",
    "encode_units",
    "decode_units",
    "encode_base32",
    "decode_base32",
    "encode_base64",
    "decode_base64",
    "encode_component",
    "gen_iscc_code_v0",
    "gen_iscc_id_v1",
    "iscc_clean",
    "SUBTYPE_MAP",
]


class MT(enum.IntEnum):
    """ISCC MainTypes."""

    META = 0
    SEMANTIC = 1
    CONTENT = 2
    DATA = 3
    INSTANCE = 4
    ISCC = 5
    ID = 6
    FLAKE = 7


class ST(enum.IntEnum):
    """Generic SubType (META, DATA, INSTANCE, FLAKE)."""

    NONE = 0


class ST_CC(enum.IntEnum):
    """SubTypes for MT.CONTENT and MT.SEMANTIC."""

    TEXT = 0
    IMAGE = 1
    AUDIO = 2
    VIDEO = 3
    MIXED = 4


class ST_ISCC(enum.IntEnum):
    """SubTypes for composite MT.ISCC codes."""

    TEXT = 0
    IMAGE = 1
    AUDIO = 2
    VIDEO = 3
    MIXED = 4
    SUM = 5  # DATA + INSTANCE only (64-bit bodies)
    WIDE = 7  # DATA + INSTANCE only (128-bit bodies); canonical "ISCC:K4A..." prefix


class ST_ID_REALM(enum.IntEnum):
    """SubTypes (realms) for MT.ID version V1."""

    REALM_0 = 0
    REALM_1 = 1


class VS(enum.IntEnum):
    """ISCC versions."""

    V0 = 0
    V1 = 1


# SubType enum resolver keyed by (MainType, Version) — mirrors the lookup the
# reference does via ``ic.SUBTYPE_MAP`` (models.py:120).
SUBTYPE_MAP = {
    (MT.META, VS.V0): ST,
    (MT.SEMANTIC, VS.V0): ST_CC,
    (MT.CONTENT, VS.V0): ST_CC,
    (MT.DATA, VS.V0): ST,
    (MT.INSTANCE, VS.V0): ST,
    (MT.ISCC, VS.V0): ST_ISCC,
    (MT.ID, VS.V1): ST_ID_REALM,
    (MT.FLAKE, VS.V0): ST,
}


class IsccTuple(NamedTuple):
    """Decoded ISCC header fields plus remaining body bytes."""

    maintype: int
    subtype: int
    version: int
    length: int
    body: bytes


# The ln field of a composite MT.ISCC header is a 3-bit set of the optional
# (dynamic) units present: bit2=META, bit1=SEMANTIC, bit0=CONTENT.
UNITS = (
    (),
    (MT.CONTENT,),
    (MT.SEMANTIC,),
    (MT.SEMANTIC, MT.CONTENT),
    (MT.META,),
    (MT.META, MT.CONTENT),
    (MT.META, MT.SEMANTIC),
    (MT.META, MT.SEMANTIC, MT.CONTENT),
)


def encode_varnibble(value):
    # type: (int) -> str
    """Encode an integer as a varnibble bitstring ('0'/'1' characters)."""
    if 0 <= value < 8:
        return format(value, "04b")
    if 8 <= value < 72:
        return "10" + format(value - 8, "06b")
    if 72 <= value < 584:
        return "110" + format(value - 72, "09b")
    if 584 <= value < 4680:
        return "1110" + format(value - 584, "012b")
    raise ValueError(f"value {value} out of varnibble range [0, 4680)")


def decode_varnibble(bits, pos):
    # type: (str, int) -> tuple[int, int]
    """Decode one varnibble from a bitstring starting at pos. Returns (value, new_pos)."""
    if len(bits) - pos < 4:
        raise ValueError("truncated varnibble")
    if bits[pos] == "0":
        return int(bits[pos + 1 : pos + 4], 2), pos + 4
    if bits[pos : pos + 2] == "10":
        if len(bits) - pos < 8:
            raise ValueError("truncated varnibble")
        return int(bits[pos + 2 : pos + 8], 2) + 8, pos + 8
    if bits[pos : pos + 3] == "110":
        if len(bits) - pos < 12:
            raise ValueError("truncated varnibble")
        return int(bits[pos + 3 : pos + 12], 2) + 72, pos + 12
    if bits[pos : pos + 4] == "1110":
        if len(bits) - pos < 16:
            raise ValueError("truncated varnibble")
        return int(bits[pos + 4 : pos + 16], 2) + 584, pos + 16
    raise ValueError("invalid varnibble prefix")


def encode_header(mtype, stype, version=0, length=0):
    # type: (int, int, int, int) -> bytes
    """
    Encode an ISCC-HEADER from its four fields.

    :param mtype: MainType
    :param stype: SubType
    :param version: Version
    :param length: Raw length field (see encode_length for derivation)
    :return: Header bytes (2 for all currently defined field values)
    """
    bits = (
        encode_varnibble(int(mtype))
        + encode_varnibble(int(stype))
        + encode_varnibble(int(version))
        + encode_varnibble(int(length))
    )
    # Pad with zero nibbles to a byte boundary.
    if len(bits) % 8:
        bits += "0000"
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


def decode_header(data):
    # type: (bytes) -> IsccTuple
    """
    Decode an ISCC-HEADER returning (maintype, subtype, version, length, body).

    The body is everything after the (byte-aligned) header. Fast path: every
    currently defined field value fits one nibble (top bit clear), making the
    header exactly two bytes — decoded arithmetically without bit strings.
    """
    if len(data) < 2:
        raise ValueError("ISCC-DIGEST too short for header")
    b0, b1 = data[0], data[1]
    if not ((b0 | b1) & 0x88):
        return IsccTuple(b0 >> 4, b0 & 7, b1 >> 4, b1 & 7, data[2:])
    bits = "".join(format(b, "08b") for b in data[: min(len(data), 8)])
    pos = 0
    mt, pos = decode_varnibble(bits, pos)
    st, pos = decode_varnibble(bits, pos)
    vs, pos = decode_varnibble(bits, pos)
    ln, pos = decode_varnibble(bits, pos)
    # Header is padded to a byte boundary with zero nibbles.
    hdr_bytes = (pos + 7) // 8
    return IsccTuple(mt, st, vs, ln, data[hdr_bytes:])


def encode_length(mtype, bits):
    # type: (int, int) -> int
    """
    Derive the raw header length field from a bit-length.

    For MT.META/SEMANTIC/CONTENT/DATA/INSTANCE/FLAKE the length field encodes
    multiples of 32 bits: ``ln = bits//32 - 1``. For MT.ID (V1) the field is 0
    for the 64-bit body. MT.ISCC length fields are unit-composition bitfields —
    use :func:`encode_units` instead.
    """
    mtype = int(mtype)
    if mtype == MT.ISCC:
        raise ValueError("use encode_units for MT.ISCC length fields")
    if mtype == MT.ID:
        if bits != 64:
            raise ValueError("ISCC-ID v1 bodies are 64-bit")
        return 0
    if bits % 32 or bits <= 0:
        raise ValueError(f"invalid bit length {bits} (must be positive multiple of 32)")
    return bits // 32 - 1


def decode_length(mtype, length, subtype=None):
    # type: (int, int, int | None) -> int
    """
    Decode the raw header length field to a body bit-length.

    For MT.ISCC the subtype is required to resolve WIDE (2x128-bit) vs the
    standard layout (64 bits per unit + 128 bits DATA+INSTANCE).
    """
    mtype = int(mtype)
    if mtype == MT.ID:
        return 64 + length * 8
    if mtype == MT.ISCC:
        if subtype is not None and int(subtype) == ST_ISCC.WIDE:
            return 256
        return len(decode_units(length)) * 64 + 128
    return (length + 1) * 32


def encode_units(units):
    # type: (tuple | list) -> int
    """Encode the set of optional unit MainTypes into the composite ln bitfield."""
    return UNITS.index(tuple(sorted(units)))


def decode_units(length):
    # type: (int) -> tuple
    """Decode the composite ln bitfield to the ordered optional unit MainTypes."""
    if not 0 <= length < len(UNITS):
        raise ValueError(f"invalid unit composition field {length}")
    return UNITS[length]


# Two-char lookup for 10-bit groups: stdlib base64.b32encode is pure Python
# (a loop over 5-byte groups) and measures ~2-3x slower than one big-int
# conversion + pair lookups on the short digests ISCC text encoding handles.
_B32_ALPHABET = "ABCDEFGHIJKLMNOPQRSTUVWXYZ234567"
_B32_PAIRS = tuple(a + b for a in _B32_ALPHABET for b in _B32_ALPHABET)


def encode_base32(data):
    # type: (bytes) -> str
    """RFC4648 base32 without padding (canonical ISCC text encoding)."""
    n = len(data)
    if not n:
        return ""
    nchars = (n * 8 + 4) // 5
    v = int.from_bytes(data, "big") << (nchars * 5 - n * 8)
    t = _B32_PAIRS
    out = []
    # nchars >= 2 for any non-empty input (8n+4)//5, so the pair loop always
    # runs at least once; the tail char appears only for odd nchars.
    for shift in range(nchars * 5 - 10, -1, -10):
        out.append(t[(v >> shift) & 1023])
    if nchars & 1:  # odd char count: one trailing 5-bit group
        out.append(_B32_ALPHABET[v & 31])
    return "".join(out)


# base32 alphabet -> int(x, 32) digit mapping ("0-9a-v"), used by the fast
# integer-based decoder below (~3x base64.b32decode for short codes).
_B32_TO_INT = str.maketrans("ABCDEFGHIJKLMNOPQRSTUVWXYZ234567", "0123456789abcdefghijklmnopqrstuv")
_B32_VALID = frozenset("ABCDEFGHIJKLMNOPQRSTUVWXYZ234567")


def decode_base32(code):
    # type: (str) -> bytes
    """Decode RFC4648 base32 (padding optional, case-insensitive)."""
    code = code.strip().upper().rstrip("=")
    if not code:
        return b""
    if _B32_VALID.issuperset(code):  # no per-call set build (2x on the check)
        if len(code) % 8 in (1, 3, 6):
            # 5*len leftover bits >= 5 can never occur in RFC4648 output
            raise ValueError(f"invalid base32 length: {len(code)}")
        nbits = len(code) * 5
        nbytes = nbits // 8
        value = int(code.translate(_B32_TO_INT), 32)
        rem = nbits - nbytes * 8
        if rem and value & ((1 << rem) - 1):
            # Reject non-canonical spellings: otherwise two distinct strings
            # differing only in trailing pad bits decode to the same digest
            # and one logical unit can enter an index under multiple aliases.
            raise ValueError("invalid base32: non-zero trailing pad bits")
        return (value >> rem).to_bytes(nbytes, "big")
    pad = (8 - len(code) % 8) % 8
    try:
        return base64.b32decode(code + "=" * pad)
    except Exception as exc:
        raise ValueError(f"invalid base32: {exc}") from None


def encode_base64(data):
    # type: (bytes) -> str
    """URL-safe base64 without padding (canonical SIMPRINT text encoding)."""
    return base64.urlsafe_b64encode(data).decode("ascii").rstrip("=")


def decode_base64(code):
    # type: (str) -> bytes
    """Decode base64 accepting both URL-safe and standard alphabets, padding optional."""
    code = code.strip().replace("+", "-").replace("/", "_").rstrip("=")
    pad = (4 - len(code) % 4) % 4
    try:
        return base64.urlsafe_b64decode(code + "=" * pad)
    except Exception as exc:
        raise ValueError(f"invalid base64: {exc}") from None


def iscc_clean(iscc):
    # type: (str) -> str
    """Strip the ISCC: prefix and surrounding whitespace from a canonical string."""
    return iscc.strip().removeprefix("ISCC:")


def encode_component(mtype, stype, version, bit_length, digest):
    # type: (int, int, int, int, bytes) -> str
    """
    Encode a single ISCC component (header + truncated body) as base32 text.

    Mirrors ``ic.encode_component`` as used by the reference aggregator
    (entry.py:92) to derive the 256-bit INSTANCE unit from a datahash.
    """
    nbytes = bit_length // 8
    if len(digest) < nbytes:
        raise ValueError(f"digest too short: {len(digest)} bytes < {nbytes}")
    header = encode_header(mtype, stype, version, encode_length(mtype, bit_length))
    return encode_base32(header + digest[:nbytes])


def _decode_unit_digest(unit):
    # type: (str | bytes) -> bytes
    if isinstance(unit, str):
        return decode_base32(iscc_clean(unit))
    return unit


# Order in which unit bodies appear in a composite ISCC-CODE body.
_COMPOSITE_ORDER = (MT.META, MT.SEMANTIC, MT.CONTENT, MT.DATA, MT.INSTANCE)


def gen_iscc_code_v0(units, wide=False):
    # type: (list[str | bytes], bool) -> dict
    """
    Compose an ISCC-CODE from ISCC-UNITs.

    Rules (mirroring the reference's use of ``ic.gen_iscc_code_v0`` in
    models.py:390 and indexes/common.py:311):

    - DATA and INSTANCE units are required; META/SEMANTIC/CONTENT optional.
    - At most one unit per MainType (duplicates keep the longest body).
    - Composite SubType: CONTENT's subtype if present, else SEMANTIC's, else
      SUM (or WIDE when ``wide=True`` applies). If both CONTENT and SEMANTIC
      are present their subtypes must agree.
    - ``wide=True`` produces a WIDE composite (128-bit DATA + 128-bit
      INSTANCE) when the inputs are exactly DATA+INSTANCE with >=128-bit
      bodies; otherwise it transparently falls back to the standard layout
      (the reference always passes wide=True — common.py:311).
    - Standard layout body: 64-bit truncation of each optional unit in
      META,SEMANTIC,CONTENT order, then 64-bit DATA and INSTANCE.

    :return: Dict with key "iscc" holding the canonical string
    """
    by_type = {}  # type: dict[int, IsccTuple]
    for unit in units:
        digest = _decode_unit_digest(unit)
        fields = decode_header(digest)
        if fields.maintype not in (MT.META, MT.SEMANTIC, MT.CONTENT, MT.DATA, MT.INSTANCE):
            raise ValueError(f"invalid unit MainType {fields.maintype} for ISCC-CODE composition")
        prev = by_type.get(fields.maintype)
        if prev is None or len(fields.body) > len(prev.body):
            by_type[fields.maintype] = fields
    if MT.DATA not in by_type or MT.INSTANCE not in by_type:
        raise ValueError("ISCC-CODE requires DATA and INSTANCE units")

    optional = [mt for mt in (MT.META, MT.SEMANTIC, MT.CONTENT) if mt in by_type]

    # Resolve composite subtype
    if MT.CONTENT in by_type:
        st = by_type[MT.CONTENT].subtype
        if MT.SEMANTIC in by_type and by_type[MT.SEMANTIC].subtype != st:
            raise ValueError("SEMANTIC and CONTENT unit subtypes must match")
    elif MT.SEMANTIC in by_type:
        st = by_type[MT.SEMANTIC].subtype
    else:
        st = ST_ISCC.SUM

    # WIDE applies only to pure DATA+INSTANCE with >=128-bit bodies
    if (
        wide
        and not optional
        and len(by_type[MT.DATA].body) >= 16
        and len(by_type[MT.INSTANCE].body) >= 16
    ):
        body = by_type[MT.DATA].body[:16] + by_type[MT.INSTANCE].body[:16]
        header = encode_header(MT.ISCC, ST_ISCC.WIDE, VS.V0, encode_units(()))
        return {"iscc": "ISCC:" + encode_base32(header + body)}

    parts = []
    for mt in optional + [MT.DATA, MT.INSTANCE]:
        if len(by_type[mt].body) < 8:
            # Without this, a short DATA/INSTANCE body would emit a composite
            # whose header length field disagrees with the actual body.
            raise ValueError(f"unit body too short for 64-bit composition: {mt}")
        parts.append(by_type[mt].body[:8])
    header = encode_header(MT.ISCC, st, VS.V0, encode_units(tuple(optional)))
    return {"iscc": "ISCC:" + encode_base32(header + b"".join(parts))}


def gen_iscc_id_v1(timestamp_us=None, server_id=0, realm_id=0):
    # type: (int | None, int, int) -> dict
    """
    Generate an ISCC-ID v1 digest from a microsecond timestamp and hub/server id.

    Body layout: (timestamp_us << 12) | server_id as a big-endian uint64
    (52-bit microsecond timestamp + 12-bit hub id — reference models.py:29-42).

    :return: Dict with "iscc" canonical string and "digest" bytes
    """
    if timestamp_us is None:
        timestamp_us = time.time_ns() // 1000
    if not 0 <= server_id < 4096:
        raise ValueError("server_id must fit in 12 bits")
    if realm_id not in (0, 1):
        raise ValueError("realm_id must be 0 or 1")
    if timestamp_us >= 1 << 52:
        raise ValueError("timestamp exceeds 52 bits")
    body = ((timestamp_us << 12) | server_id).to_bytes(8, "big")
    digest = encode_header(MT.ID, realm_id, VS.V1, 0) + body
    return {"iscc": "ISCC:" + encode_base32(digest), "digest": digest}


def new_iscc_id_digest(realm_id=0):
    # type: (int) -> bytes
    """Random ISCC-ID digest: current timestamp + random 12-bit server id."""
    server_id = int.from_bytes(os.urandom(2), "big") & 0xFFF
    return gen_iscc_id_v1(server_id=server_id, realm_id=realm_id)["digest"]
