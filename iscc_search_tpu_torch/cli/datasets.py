"""`datasets` command: list ISCC datasets available on the Hugging Face hub
(port of ``iscc_search_tpu/cli/datasets.py``: the command on argparse, its
output plain)."""

from __future__ import annotations

from iscc_search_tpu_torch.cli.common import print_table


def register(subparsers):
    # type: (...) -> None
    cmd = subparsers.add_parser("datasets", help="List candidate ISCC datasets on the Hugging Face hub.")
    cmd.add_argument("--search", dest="query", default="iscc", help="Search term (default: iscc)")
    cmd.add_argument("--limit", type=int, default=20, help="(default: 20)")
    cmd.set_defaults(func=datasets_command)


def datasets_command(args):
    # type: (...) -> None
    """List candidate ISCC datasets on the Hugging Face hub."""
    try:
        from huggingface_hub import HfApi
    except ImportError:
        print("huggingface-hub is not installed")
        raise SystemExit(1)

    api = HfApi()
    results = list(api.list_datasets(search=args.query, limit=args.limit))
    if not results:
        print("No datasets found")
        return
    rows = []
    for d in results:
        downloads = getattr(d, "downloads", None)
        updated = getattr(d, "last_modified", None)
        rows.append([d.id, str(downloads) if downloads is not None else "-",
                     str(updated)[:10] if updated is not None else "-"])
    print_table(f"Datasets matching '{args.query}'", ["ID", "Downloads", "Updated"], rows)
