"""`search` command: similarity search by ISCC-CODE or ISCC-ID (copy of
``iscc_search_tpu/cli/search.py``; the command on argparse, its output
plain)."""

from __future__ import annotations

from iscc_search_tpu_torch.cli.common import get_active_index, print_json, print_table
from iscc_search_tpu_torch.schema import IsccQuery
from iscc_search_tpu_torch.utils import timer


def _is_iscc_id(iscc):
    # type: (str) -> bool
    """Route by decoded header MainType, not string length: a 64-bit
    single-unit ISCC-CODE is exactly as long as an ISCC-ID."""
    from iscc_search_tpu_torch import codec as ic

    try:
        mtype, *_ = ic.decode_header(ic.decode_base32(iscc.removeprefix("ISCC:")))
        return mtype == ic.MT.ID
    except Exception:
        return False  # let IsccQuery(iscc_code=...) produce the validation error


def register(subparsers):
    # type: (...) -> None
    cmd = subparsers.add_parser("search", help="Search for assets similar to an ISCC-CODE or ISCC-ID.")
    cmd.add_argument("iscc")
    cmd.add_argument("--index", dest="index_name", default=None, help="Target index (default: active index)")
    cmd.add_argument("--limit", type=int, default=10, help="(default: 10)")
    cmd.add_argument("--json", dest="as_json", action="store_true", help="Print the raw JSON result")
    cmd.set_defaults(func=search_command)


def search_command(args):
    # type: (...) -> None
    """Search for assets similar to an ISCC-CODE or ISCC-ID."""
    with timer("open index"):
        index, name = get_active_index(args.index_name, device=args.device)
    try:
        if _is_iscc_id(args.iscc):
            query = IsccQuery(iscc_id=args.iscc)
        else:
            query = IsccQuery(iscc_code=args.iscc)
        with timer("search_assets"):
            result = index.search_assets(name, query, args.limit)
    except (FileNotFoundError, ValueError) as e:
        print(e)
        raise SystemExit(1)
    finally:
        index.close()

    if args.as_json:
        print_json(result.model_dump(mode="json", exclude_none=True))
        return

    if not result.global_matches and not result.chunk_matches:
        print("No matches found")
        return

    if result.global_matches:
        rows = []
        for m in result.global_matches:
            types = ", ".join(f"{t}={s:.3f}" for t, s in m.types.items())
            rows.append([m.iscc_id, f"{m.score:.3f}", types])
        print_table(f"Global matches in '{name}'", ["ISCC-ID", "Score", "Types"], rows)

    if result.chunk_matches:
        rows = []
        for m in result.chunk_matches:
            types = ", ".join(f"{t}: {tr.matches}/{tr.queried}@{tr.score:.3f}" for t, tr in m.types.items())
            rows.append([m.iscc_id, f"{m.score:.3f}", types])
        print_table("Chunk matches", ["ISCC-ID", "Score", "Types"], rows)
