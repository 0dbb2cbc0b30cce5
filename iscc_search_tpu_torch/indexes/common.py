"""
A copy of ``iscc_search_tpu/indexes/common.py`` over the port's pydantic-free
schema; ``tests/test_torch_host_copies.py`` holds every function of it to the
original's bytecode, the package name aside, and
``tests/test_torch_backend.py`` the bytes it writes to the store.

Common utilities shared by index backends.

Functional parity with reference iscc_search/indexes/common.py: asset
(de)serialization (simprints excluded from storage — common.py:28-41), ISCC-ID
validation / realm extraction / reconstruction (common.py:111-272), index-name
validation (common.py:202), and bidirectional query normalization
(common.py:275-330).
"""

from __future__ import annotations

import json
import re

from iscc_search_tpu_torch import codec as ic
from iscc_search_tpu_torch.models import IsccCode, IsccUnit
from iscc_search_tpu_torch.schema import IsccEntry

INDEX_NAME_PATTERN = re.compile(r"^[a-z][a-z0-9]*$")


def serialize_asset(asset):
    # type: (IsccEntry) -> bytes
    """
    Serialize IsccEntry to compact JSON bytes, excluding simprints.

    Simprints are stored separately in the simprint engine; excluding them here
    avoids double storage (reference common.py:28-41).
    """
    asset_dict = asset.model_dump(mode="json", exclude_none=True, exclude={"simprints"})
    return json.dumps(asset_dict, separators=(",", ":")).encode("utf-8")


def deserialize_asset(data):
    # type: (bytes) -> IsccEntry
    """Deserialize JSON bytes to IsccEntry.

    Corruption raises RuntimeError (a SERVER fault -> HTTP 500), never
    ValueError: the wsgi layer maps ValueError to 400 "invalid user input",
    and a corrupt stored record is not the client's mistake."""
    try:
        return IsccEntry(**json.loads(data.decode("utf-8")))
    except Exception as exc:
        raise RuntimeError(f"corrupt stored asset record: {exc}") from None


def metadata_from_asset_bytes(data):
    # type: (bytes) -> dict | None
    """Metadata field of a stored asset record, without building the model.

    The search-enrichment hot path needs only ``metadata``; a full IsccEntry
    validation per match costs ~3x the JSON parse. Same corruption contract
    as :func:`deserialize_asset` (RuntimeError -> HTTP 500, never a 400):
    a non-dict record or non-dict metadata raises here rather than leaking
    into response-model validation (which the wsgi layer maps to 422 —
    blaming the client for server-side bit rot)."""
    try:
        record = json.loads(data.decode("utf-8"))
    except Exception as exc:
        raise RuntimeError(f"corrupt stored asset record: {exc}") from None
    if not isinstance(record, dict):
        raise RuntimeError("corrupt stored asset record: not an object")
    metadata = record.get("metadata")
    if not (metadata is None or isinstance(metadata, dict)):
        raise RuntimeError("corrupt stored asset record: metadata is not an object")
    return metadata


def extract_iscc_id_body(iscc_id):
    # type: (str) -> bytes
    """Extract the 8-byte body from an ISCC-ID canonical string (one decode)."""
    return parse_iscc_id(iscc_id).body


def extract_realm_id(iscc_id):
    # type: (str) -> int
    """Extract the realm id (0 or 1) from an ISCC-ID header (one decode)."""
    return parse_iscc_id(iscc_id).realm_id


def reconstruct_iscc_id(body, realm_id):
    # type: (bytes, int) -> str
    """Rebuild an ISCC-ID canonical string from its 8-byte body and realm id."""
    if realm_id not in (0, 1):
        raise ValueError(f"Invalid realm_id {realm_id}, must be 0 or 1")
    if len(body) != 8:
        raise ValueError(f"ISCC-ID body must be 8 bytes, got {len(body)}")
    header = ic.encode_header(ic.MT.ID, realm_id, ic.VS.V1, 0)
    return "ISCC:" + ic.encode_base32(header + body)


def extract_unit_body(unit):
    # type: (str) -> bytes
    """Body bytes of an ISCC-UNIT canonical string."""
    return IsccUnit(unit).body


def get_unit_type(unit):
    # type: (str) -> str
    """Unit-type string ("{MAINTYPE}_{SUBTYPE}_V{N}") of an ISCC-UNIT."""
    return IsccUnit(unit).unit_type


def validate_index_name(name):
    # type: (str) -> None
    """Validate index name against ^[a-z][a-z0-9]*$."""
    if not INDEX_NAME_PATTERN.match(name):
        raise ValueError(
            f"Invalid index name: '{name}'. Must match pattern ^[a-z][a-z0-9]*$ "
            f"(start with lowercase letter, followed by lowercase letters/digits only)"
        )


def validate_iscc_id(iscc_id, expected_realm=None):
    # type: (str, int | None) -> None
    """
    Validate ISCC-ID format (and optionally realm).

    Checks prefix, base32, 10-byte length, MainType ID, zero length field,
    a SUPPORTED realm (0/1 — subtypes 2-7 would poison an index: downstream
    reconstruction only knows realms 0/1), and an optional expected realm
    (reference common.py:223-272). Delegates to parse_iscc_id so the two
    validators can never diverge.
    """
    parse_iscc_id(iscc_id, expected_realm)


def parse_iscc_id(iscc_id, expected_realm=None):
    # type: (str, int | None) -> ...
    """
    Validate and decode an ISCC-ID in one pass (single base32 + header decode).

    Same checks as validate_iscc_id, returning the decoded IsccID so callers
    don't decode twice on hot ingest paths.
    """
    from iscc_search_tpu_torch.models import IsccID

    if not iscc_id or not iscc_id.startswith("ISCC:"):
        raise ValueError(f"Invalid ISCC-ID format: '{iscc_id}' (must start with 'ISCC:')")
    try:
        obj = IsccID(iscc_id)
    except ValueError as e:
        raise ValueError(f"Invalid ISCC-ID base32 encoding: {e}")
    if len(obj.digest) != 10:
        raise ValueError(
            f"Invalid ISCC-ID length: {len(obj.digest)} bytes (expected 10 bytes = 2-byte header + 8-byte body)"
        )
    fields = obj.fields
    if fields.maintype != ic.MT.ID:
        raise ValueError(f"Invalid ISCC-ID main type: {fields.maintype} (expected {int(ic.MT.ID)})")
    if fields.length != 0:
        raise ValueError(
            f"Invalid ISCC-ID length field: {fields.length} (expected 0 for 64-bit ISCC-ID v1). "
            f"ISCC-ID '{iscc_id}' appears to be malformed."
        )
    if fields.subtype not in (0, 1):
        # Realms 2-7 pass the wire pattern but nothing downstream can
        # reconstruct them — accepting one would poison the whole index
        # (every later search raises on reconstruction).
        raise ValueError(
            f"Unsupported ISCC-ID realm: {fields.subtype} (only realms 0 and 1 are defined)"
        )
    if expected_realm is not None and fields.subtype != expected_realm:
        raise ValueError(
            f"Realm mismatch: ISCC-ID '{iscc_id}' has realm={fields.subtype}, "
            f"but expected realm={expected_realm}. Cannot query assets from different realm."
        )
    return obj


def expand_iscc_id_query(query, get_asset):
    # type: (..., ...) -> tuple
    """Turn a search-by-iscc_id into a content query from the stored asset.

    Shared by every backend (the same fetch/extract/rebuild logic was
    previously triplicated). ``get_asset`` takes the iscc_id string.
    :return: (expanded_query, original_iscc_id or None)
    """
    from iscc_search_tpu_torch.schema import IsccQuery

    if not query.iscc_id:
        return query, None
    asset = get_asset(query.iscc_id)
    sp = None
    if asset.simprints:
        sp = {t: [s.simprint for s in lst] for t, lst in asset.simprints.items()}
    return IsccQuery(iscc_code=asset.iscc_code, units=asset.units, simprints=sp), query.iscc_id


def normalize_query(query):
    # type: (IsccQuery) -> IsccQuery
    """
    Bidirectional query normalization (units <-> iscc_code).

    Mirrors reference common.py:275-330: populate both representations when
    derivable; simprint-only queries pass through; raise when the query is
    entirely empty.
    """
    if query.units:
        if query.iscc_code:
            return query
        try:
            iscc_code = ic.gen_iscc_code_v0(query.units, wide=True)["iscc"]
            return query.model_copy(update={"iscc_code": iscc_code})
        except ValueError:
            return query

    if query.iscc_code:
        units = [str(unit) for unit in IsccCode(query.iscc_code).units]
        return query.model_copy(update={"units": units})

    if query.simprints:
        return query

    raise ValueError("Query must have 'iscc_code', 'units', or 'simprints' for search")
