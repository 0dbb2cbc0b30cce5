"""`add` command: bulk-ingest .iscc.json files (glob/dir/file) in batches
(copy of ``iscc_search_tpu/cli/add.py``; the command on argparse, its output
plain)."""

from __future__ import annotations

import json
from pathlib import Path

from iscc_search_tpu_torch.cli.common import get_active_index, parse_simprints_from_features
from iscc_search_tpu_torch.schema import IsccEntry
from iscc_search_tpu_torch.utils import get_logger, timer

logger = get_logger(__name__)

BATCH_SIZE = 100


def expand_pattern_to_files(pattern):
    # type: (str) -> list[Path]
    """Expand a file path, directory, or glob into ingestible files."""
    p = Path(pattern)
    if p.is_file():
        return [p]
    if p.is_dir():
        files = list(p.glob("*.iscc.json")) + list(p.glob("*.ndjson")) + list(p.glob("*.jsonl"))
        return sorted(files)
    # For a bare glob like "*.json", Path().parent is already "." — glob
    # from it directly.
    return sorted(p.parent.glob(p.name))


def dict_to_entry(data, simprint_bits=None, include_simprints=True):
    # type: (dict, int | None, bool) -> IsccEntry | None
    """Convert one parsed .iscc.json document into an IsccEntry."""
    entry = {}
    for field in ("iscc_id", "iscc_code", "units", "metadata"):
        if data.get(field) is not None:
            entry[field] = data[field]
    if "iscc_code" not in entry and data.get("iscc"):
        entry["iscc_code"] = data["iscc"]
    if include_simprints and data.get("features"):
        simprints = parse_simprints_from_features(data["features"], simprint_bits)
        if simprints:
            entry["simprints"] = simprints
    if not entry.get("iscc_code") and not entry.get("units"):
        return None
    if entry.get("iscc_code") and not entry.get("units"):
        from iscc_search_tpu_torch.models import IsccCode

        entry["units"] = [str(u) for u in IsccCode(entry["iscc_code"]).units]
    if not entry.get("iscc_id"):
        from iscc_search_tpu_torch.models import IsccID

        entry["iscc_id"] = str(IsccID.random())
    return IsccEntry(**entry)


def iter_entries(path, simprint_bits=None, include_simprints=True):
    # type: (Path, int | None, bool) -> ...
    """Yield IsccEntry objects from a file (.iscc.json doc or NDJSON stream)."""
    if path.suffix in (".ndjson", ".jsonl"):
        with path.open("r", encoding="utf-8") as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    data = json.loads(line)
                except Exception as e:
                    logger.warning(f"Skipping {path}:{lineno}: invalid JSON ({e})")
                    continue
                try:
                    entry = dict_to_entry(data, simprint_bits, include_simprints)
                except Exception as e:
                    # One malformed row (bad iscc_id pattern, too few units,
                    # undecodable code) must not abort the whole bulk ingest.
                    logger.warning(f"Skipping {path}:{lineno}: invalid entry ({e})")
                    continue
                if entry is None:
                    logger.warning(f"Skipping {path}:{lineno}: no iscc_code or units")
                    continue
                yield entry
        return
    entry = file_to_entry(path, simprint_bits, include_simprints)
    if entry is not None:
        yield entry


def file_to_entry(path, simprint_bits=None, include_simprints=True):
    # type: (Path, int | None, bool) -> IsccEntry | None
    """Parse one .iscc.json file into an IsccEntry."""
    try:
        data = json.loads(path.read_text(encoding="utf-8"))
    except Exception as e:
        logger.warning(f"Skipping {path}: invalid JSON ({e})")
        return None
    try:
        entry = dict_to_entry(data, simprint_bits, include_simprints)
    except Exception as e:
        logger.warning(f"Skipping {path}: invalid entry ({e})")
        return None
    if entry is None:
        logger.warning(f"Skipping {path}: no iscc_code or units")
    return entry


def register(subparsers):
    # type: (...) -> None
    cmd = subparsers.add_parser("add", help="Add assets from .iscc.json FILES (file, directory, or glob PATTERN).")
    cmd.add_argument("pattern")
    cmd.add_argument("--index", dest="index_name", default=None, help="Target index (default: active index)")
    cmd.add_argument("--simprint-bits", choices=["64", "128", "192", "256"], default=None,
                     help="Truncate simprints to this bit length")
    cmd.add_argument("--no-simprints", action="store_true", help="Skip simprint indexing")
    cmd.add_argument("--batch-size", type=int, default=BATCH_SIZE, help=f"(default: {BATCH_SIZE})")
    cmd.set_defaults(func=add_command)


def add_command(args):
    # type: (...) -> None
    """Add assets from .iscc.json FILES (file, directory, or glob PATTERN)."""
    files = expand_pattern_to_files(args.pattern)
    if not files:
        print(f"No files matched: {args.pattern}")
        raise SystemExit(1)

    with timer("open index"):
        index, name = get_active_index(args.index_name, device=args.device)
    bits = int(args.simprint_bits) if args.simprint_bits else None
    created = updated = skipped = 0
    batch = []  # type: list[IsccEntry]

    def flush_batch():
        nonlocal created, updated
        if not batch:
            return
        results = index.add_assets(name, batch)
        created_n = sum(1 for r in results if r.status == "created")
        created += created_n
        updated += len(results) - created_n
        batch.clear()

    with timer(f"add {len(files)} files"):
        try:
            for path in files:
                produced = 0
                for entry in iter_entries(path, bits, include_simprints=not args.no_simprints):
                    produced += 1
                    batch.append(entry)
                    if len(batch) >= args.batch_size:
                        flush_batch()
                if produced == 0:
                    skipped += 1
            flush_batch()
        finally:
            index.close()  # flush derived indexes even when ingest fails mid-run

    print(f"Added {created} created, {updated} updated, {skipped} skipped")
