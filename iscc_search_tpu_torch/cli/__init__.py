"""
iscc-search-tpu-torch CLI (port of ``iscc_search_tpu/cli``).

The JAX CLI's commands and options on ``argparse`` (the card's Python has
neither click nor rich): add, get, search, serve, index
{add,list,use,remove,rebuild}, hub, datasets, version; plus one global
option, ``--device {cuda,cpu}``, the device of a local ``tpu`` index's
engines (the card by default; nothing switches to the CPU by itself).
Output is plain ``print``: JSON indented by 2, tables as tab-separated
rows (``cli/common.py``).

Run as ``python -m iscc_search_tpu_torch.cli`` or ``iscc-search-tpu-torch``.
"""

from __future__ import annotations

import argparse
import sys

import iscc_search_tpu_torch
from iscc_search_tpu_torch.cli import add, datasets, get, hub, index, search, serve


def build_parser():
    # type: () -> argparse.ArgumentParser
    parser = argparse.ArgumentParser(
        prog="iscc-search-tpu-torch",
        description="ISCC-Search on PyTorch + CUDA — similarity search for ISCC codes on an NVIDIA Hopper GPU.",
    )
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Device of a local tpu index's engines (default: cuda)")
    parser.set_defaults(func=None)
    subparsers = parser.add_subparsers(dest="command", metavar="{add,get,search,serve,index,hub,datasets,version}")
    for module in (add, get, search, serve, index, hub, datasets):
        module.register(subparsers)
    cmd = subparsers.add_parser("version", help="Show version information.")
    cmd.set_defaults(func=version_command)
    return parser


def version_command(args):
    # type: (...) -> None
    """Show version information."""
    print(f"iscc-search-tpu-torch {iscc_search_tpu_torch.__version__}")


def main(argv=None):
    # type: (list[str] | None) -> int
    """Run the CLI on ``argv`` (default: ``sys.argv[1:]``); returns the exit code."""
    from iscc_search_tpu_torch.utils import configure_logging

    parser = build_parser()
    try:
        args = parser.parse_args(argv)
        if args.func is None:  # no command: the help, exit 2 (click's group)
            parser.print_help()
            return 2
        configure_logging()  # entry point opts in; the library never does on import
        args.func(args)
    except SystemExit as exc:
        if exc.code is None or isinstance(exc.code, int):
            return exc.code or 0
        print(exc.code, file=sys.stderr)
        return 1
    return 0
