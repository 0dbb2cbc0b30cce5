"""Shared CLI helpers: active-index resolution and feature->simprint transforms
(copy of ``iscc_search_tpu/cli/common.py``), and the plain output that takes
the place of rich.

``get_active_index`` and ``_local_manager`` take the device of the ``tpu``
backend's engines (the card unless the caller asks for ``"cpu"``: the CLI's
global ``--device``). ``print_json`` and ``print_table`` print what the JAX
CLI's ``console.print_json`` and rich tables show, without rich: JSON
indented by 2 (the same parsed value), and a table as its title, its header
and one tab-separated line per row.
"""

from __future__ import annotations

import json

from iscc_search_tpu_torch import codec as ic
from iscc_search_tpu_torch.utils import get_logger

logger = get_logger(__name__)

_config_manager = None


def get_config_manager():
    # type: () -> ...
    """Process-wide ConfigManager (overridable in tests)."""
    global _config_manager
    if _config_manager is None:
        from iscc_search_tpu_torch.config import ConfigManager

        _config_manager = ConfigManager()
    return _config_manager


def set_config_manager(manager):
    # type: (...) -> None
    global _config_manager
    _config_manager = manager


def get_active_index(index_name=None, device="cuda"):
    # type: (str | None, str) -> tuple[..., str]
    """
    Resolve the index to operate on: the named one, or the configured active
    index. Local indexes are created on first use.

    :param device: Device of a local ``tpu`` index's engines.
    :return: (index protocol instance, index name)
    """
    from iscc_search_tpu_torch.config import LocalIndexConfig, RemoteIndexConfig
    from iscc_search_tpu_torch.remote import RemoteIndex
    from iscc_search_tpu_torch.schema import IsccIndex

    manager = get_config_manager()
    indexes = manager.list()

    if index_name is not None:
        if index_name not in indexes:
            raise ValueError(f"Index '{index_name}' not found in configuration")
        cfg = indexes[index_name]
        target = index_name
    else:
        active = manager.get_active()
        if active is None:
            raise ValueError("No active index configured. Use 'iscc-search-tpu index add' to configure an index.")
        target, cfg = active

    if isinstance(cfg, LocalIndexConfig):
        backend = _local_manager(cfg, device)
        try:
            backend.get_index(target)
        except FileNotFoundError:
            backend.create_index(IsccIndex(name=target))
        return backend, target
    if isinstance(cfg, RemoteIndexConfig):
        return RemoteIndex(url=cfg.url, index_name=cfg.index_name, api_key=cfg.api_key), cfg.index_name
    raise ValueError(f"Unknown index type: {type(cfg)}")  # pragma: no cover


def _local_manager(cfg, device="cuda"):
    # type: (..., str) -> ...
    """Build the backend manager via the shared scheme dispatch.

    Passes the filesystem path directly — round-tripping through a URI
    would let urlparse mangle legal dirnames containing '#' or '?'."""
    from iscc_search_tpu_torch.options import manager_for

    return manager_for(cfg.scheme, cfg.path, device=device)


def parse_simprints_from_features(features, simprint_bits=None):
    # type: (list[dict], int | None) -> dict[str, list[dict]] | None
    """
    Transform the .iscc.json ``features`` array into IsccEntry.simprints form.

    Input per feature: {maintype, subtype, version, simprints[], offsets[],
    sizes[]}; output: {"{MAIN}_{SUB}_V{n}": [{simprint, offset, size}, ...]}.
    Optionally truncates each simprint to ``simprint_bits`` (prefix-preserving
    truncation is similarity-preserving for ISCC simhashes).
    """
    if not features:
        return None
    result = {}  # type: dict[str, list[dict]]
    for feature in features:
        maintype = (feature.get("maintype") or "").upper()
        subtype = (feature.get("subtype") or "").upper()
        version = feature.get("version", 0)
        simprints = feature.get("simprints") or []
        offsets = feature.get("offsets") or []
        sizes = feature.get("sizes") or []
        if not maintype or not subtype or not simprints:
            logger.warning(f"Skipping feature with missing data: {feature.get('maintype')}-{feature.get('subtype')}")
            continue
        sp_type = f"{maintype}_{subtype}_V{version}"
        n = min(len(simprints), len(offsets), len(sizes))
        if n != len(simprints):
            logger.warning(
                f"Array length mismatch for {sp_type}: simprints={len(simprints)}, "
                f"offsets={len(offsets)}, sizes={len(sizes)}. Using {n} entries."
            )
        entries = []
        for i in range(n):
            sp = simprints[i]
            if simprint_bits is not None:
                try:
                    raw = ic.decode_base64(sp)
                    target = simprint_bits // 8
                    if len(raw) < target:
                        raise ValueError(f"simprint has {len(raw) * 8} bits < {simprint_bits}")
                    sp = ic.encode_base64(raw[:target])
                except Exception as e:
                    logger.error(f"Failed to truncate simprint for {sp_type}: {e}")
                    continue
            entries.append({"simprint": sp, "offset": offsets[i], "size": sizes[i]})
        if not entries:
            logger.warning(f"Skipping {sp_type}: no valid simprint entries")
            continue
        result.setdefault(sp_type, []).extend(entries)
    return result or None


def print_json(data):
    # type: (object) -> None
    """``data`` as JSON indented by 2 (rich's ``print_json`` layout)."""
    print(json.dumps(data, indent=2, ensure_ascii=False))


def print_table(title, columns, rows):
    # type: (str | None, list[str], list[list[str]]) -> None
    """A table: its title (if any), the header, then one row per line, the
    cells separated by tabs."""
    if title:
        print(title)
    for cells in [columns, *rows]:
        print("\t".join(cells))
