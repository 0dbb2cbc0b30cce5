"""`get` command: fetch a stored asset by ISCC-ID (port of
``iscc_search_tpu/cli/get.py``: the command on argparse, its output plain)."""

from __future__ import annotations

from iscc_search_tpu_torch.cli.common import get_active_index, print_json
from iscc_search_tpu_torch.utils import timer


def register(subparsers):
    # type: (...) -> None
    cmd = subparsers.add_parser("get", help="Get an asset by ISCC_ID.")
    cmd.add_argument("iscc_id")
    cmd.add_argument("--index", dest="index_name", default=None, help="Target index (default: active index)")
    cmd.set_defaults(func=get_command)


def get_command(args):
    # type: (...) -> None
    """Get an asset by ISCC_ID."""
    with timer("open index"):
        index, name = get_active_index(args.index_name, device=args.device)
    try:
        with timer("get_asset"):
            asset = index.get_asset(name, args.iscc_id)
    except (FileNotFoundError, ValueError) as e:
        print(e)
        raise SystemExit(1)
    finally:
        index.close()
    print_json(asset.model_dump(mode="json", exclude_none=True))
