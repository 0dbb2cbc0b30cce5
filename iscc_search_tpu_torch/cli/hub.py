"""`hub` command: bulk-ingest ISCC datasets from the Hugging Face hub (copy
of ``iscc_search_tpu/cli/hub.py``; the command on argparse, its output
plain).

Streams parquet batches with pyarrow and upserts rows as IsccEntry batches
with freshly generated monotonic ISCC-IDs. Requires network access,
huggingface-hub and pyarrow (each gated when absent: a message and exit 1).
"""

from __future__ import annotations

from iscc_search_tpu_torch.cli.common import get_active_index, parse_simprints_from_features
from iscc_search_tpu_torch.schema import IsccEntry
from iscc_search_tpu_torch.utils import get_logger, timer

logger = get_logger(__name__)

BATCH_SIZE = 100


class _IdGenerator:
    """Fresh monotonic ISCC-IDs (timestamp microseconds, fixed server id)."""

    def __init__(self, realm_id=0, server_id=0):
        import time

        from iscc_search_tpu_torch import codec as ic

        self._ic = ic
        self.realm_id = realm_id
        self.server_id = server_id
        self._last = time.time_ns() // 1000

    def next(self):
        # type: () -> str
        self._last += 1
        return self._ic.gen_iscc_id_v1(self._last, self.server_id, self.realm_id)["iscc"]


def row_to_entry(row, gen, simprint_bits=None):
    # type: (dict, _IdGenerator, int | None) -> IsccEntry | None
    """Convert one dataset row to an IsccEntry with a fresh ISCC-ID."""
    entry = {"iscc_id": gen.next()}
    if row.get("iscc") or row.get("iscc_code"):
        entry["iscc_code"] = row.get("iscc") or row.get("iscc_code")
    if row.get("units"):
        entry["units"] = list(row["units"])
    if not entry.get("iscc_code") and not entry.get("units"):
        return None
    if entry.get("iscc_code") and not entry.get("units"):
        from iscc_search_tpu_torch.models import IsccCode

        entry["units"] = [str(u) for u in IsccCode(entry["iscc_code"]).units]
    features = row.get("features")
    if features is not None and len(features):
        import json as _json

        if isinstance(features, (bytes, str)):
            try:
                features = _json.loads(features)
            except Exception:
                features = None
        if features:
            simprints = parse_simprints_from_features(list(features), simprint_bits)
            if simprints:
                entry["simprints"] = simprints
    metadata = {}
    for field in ("name", "source", "media_type"):
        if row.get(field):
            metadata[field] = row[field]
    if metadata:
        entry["metadata"] = metadata
    return IsccEntry(**entry)


def register(subparsers):
    # type: (...) -> None
    cmd = subparsers.add_parser("hub", help="Ingest an ISCC parquet DATASET from the Hugging Face hub.")
    cmd.add_argument("dataset")
    cmd.add_argument("--index", dest="index_name", default=None, help="Target index (default: active index)")
    cmd.add_argument("--limit", type=int, default=None, help="Maximum rows to ingest")
    cmd.add_argument("--simprint-bits", choices=["64", "128", "192", "256"], default=None)
    cmd.add_argument("--batch-size", type=int, default=BATCH_SIZE, help=f"(default: {BATCH_SIZE})")
    cmd.set_defaults(func=hub_command)


def hub_command(args):
    # type: (...) -> None
    """Ingest an ISCC parquet DATASET from the Hugging Face hub."""
    try:
        from huggingface_hub import hf_hub_download, list_repo_files
    except ImportError:
        print("huggingface-hub is not installed")
        raise SystemExit(1)
    try:
        import pyarrow.parquet as pq
    except ImportError:
        print("pyarrow is not installed")
        raise SystemExit(1)

    dataset, batch_size, limit = args.dataset, args.batch_size, args.limit
    files = [f for f in list_repo_files(dataset, repo_type="dataset") if f.endswith(".parquet")]
    if not files:
        print(f"No parquet files in dataset {dataset}")
        raise SystemExit(1)

    index, name = get_active_index(args.index_name, device=args.device)
    gen = _IdGenerator()
    bits = int(args.simprint_bits) if args.simprint_bits else None
    total = 0
    batch = []  # type: list[IsccEntry]

    def flush():
        nonlocal total
        if batch:
            index.add_assets(name, batch)
            total += len(batch)
            batch.clear()

    limit_reached = False
    with timer(f"hub ingest {dataset}"):
        try:
            for filename in files:
                local = hf_hub_download(dataset, filename, repo_type="dataset")
                parquet = pq.ParquetFile(local)
                for record_batch in parquet.iter_batches(batch_size=batch_size):
                    for row in record_batch.to_pylist():
                        try:
                            entry = row_to_entry(row, gen, bits)
                        except Exception as e:
                            # One malformed dataset row must not abort a
                            # multi-GB ingest (same contract as `add`).
                            logger.warning(f"Skipping row in {filename}: invalid entry ({e})")
                            continue
                        if entry is None:
                            continue
                        batch.append(entry)
                        if len(batch) >= batch_size:
                            flush()
                        if limit and total + len(batch) >= limit:
                            limit_reached = True
                            break
                    if limit_reached:
                        break
                if limit_reached:
                    break
            flush()
        finally:
            index.close()  # flush derived indexes even when ingest fails mid-run
    suffix = " (limit reached)" if limit_reached else f" from {dataset}"
    print(f"Ingested {total} assets{suffix}")
