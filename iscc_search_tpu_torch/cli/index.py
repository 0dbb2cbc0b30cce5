"""`index` command group: configure named indexes (add/list/use/remove/rebuild)
(port of ``iscc_search_tpu/cli/index.py``: the commands on argparse, their
output plain)."""

from __future__ import annotations

from iscc_search_tpu_torch.cli.common import get_config_manager, print_table


def register(subparsers):
    # type: (...) -> None
    group = subparsers.add_parser("index", help="Manage configured indexes (git-like add/list/use/remove).")
    sub = group.add_subparsers(dest="index_command", metavar="{add,list,use,remove,rebuild}")
    group.set_defaults(func=lambda args: _usage(group))

    cmd = sub.add_parser("add", help="Register a local or remote index under NAME.")
    cmd.add_argument("name")
    cmd.add_argument("--path", default=None, help="Local index base directory")
    cmd.add_argument("--scheme", default="tpu", choices=["tpu", "kv"], help="(default: tpu)")
    cmd.add_argument("--url", default=None, help="Remote server URL (registers a remote index)")
    cmd.add_argument("--remote-name", default=None, help="Index name on the remote server (default: NAME)")
    cmd.add_argument("--api-key", default=None, help="API key for the remote server")
    cmd.add_argument("--no-use", action="store_true", help="Do not activate the new index")
    cmd.set_defaults(func=index_add)

    cmd = sub.add_parser("list", help="List configured indexes (* marks the active one).")
    cmd.set_defaults(func=index_list)

    cmd = sub.add_parser("use", help="Set the active index.")
    cmd.add_argument("name")
    cmd.set_defaults(func=index_use)

    cmd = sub.add_parser("remove", help="Remove NAME from the configuration (data kept unless --delete-data).")
    cmd.add_argument("name")
    cmd.add_argument("--delete-data", action="store_true", help="Also delete the index data on disk")
    cmd.set_defaults(func=index_remove)

    cmd = sub.add_parser("rebuild", help="Rebuild derived device indexes from the source-of-truth store.")
    cmd.add_argument("name", nargs="?", default=None)
    cmd.add_argument("--unit-type", dest="unit_types", action="append", default=[], help="NPHD unit types to rebuild")
    cmd.add_argument("--simprint-type", dest="simprint_types", action="append", default=[],
                     help="Simprint types to rebuild")
    cmd.add_argument("--all", dest="rebuild_all", action="store_true", help="Rebuild all tracked derived indexes")
    cmd.set_defaults(func=index_rebuild)


def _usage(parser):
    # type: (...) -> None
    """``index`` without a subcommand: its help, exit 2 (click's group)."""
    parser.print_help()
    raise SystemExit(2)


def index_add(args):
    # type: (...) -> None
    """Register a local or remote index under NAME."""
    manager = get_config_manager()
    name, path, scheme, url = args.name, args.path, args.scheme, args.url
    try:
        if url:
            manager.add_remote(name, url, args.remote_name or name, api_key=args.api_key, use=not args.no_use)
            print(f"Added remote index '{name}' -> {url}")
        else:
            if not path:
                from iscc_search_tpu_torch.options import user_data_dir

                path = user_data_dir()
            manager.add_local(name, path, scheme=scheme, use=not args.no_use)
            print(f"Added local index '{name}' at {path} ({scheme}://)")
    except ValueError as e:
        print(e)
        raise SystemExit(1)


def index_list(args):
    # type: (...) -> None
    """List configured indexes (* marks the active one)."""
    manager = get_config_manager()
    discovered = manager.discover()
    if discovered:
        print(f"Discovered: {', '.join(discovered)}")
    indexes = manager.list()
    if not indexes:
        print("No indexes configured. Use 'iscc-search-tpu index add'.")
        return
    active = manager.config.active
    rows = []
    for name, cfg in indexes.items():
        mark = "*" if name == active else ""
        location = cfg.path if cfg.type == "local" else f"{cfg.url} ({cfg.index_name})"
        rows.append([mark, name, cfg.type, location])
    print_table(None, ["", "Name", "Type", "Location"], rows)


def index_use(args):
    # type: (...) -> None
    """Set the active index."""
    manager = get_config_manager()
    try:
        manager.use(args.name)
        print(f"Active index: {args.name}")
    except KeyError as e:
        print(e)
        raise SystemExit(1)


def index_remove(args):
    # type: (...) -> None
    """Remove NAME from the configuration (data kept unless --delete-data)."""
    manager = get_config_manager()
    name = args.name
    try:
        cfg = manager.list().get(name)
        manager.remove(name)
    except KeyError as e:
        print(e)
        raise SystemExit(1)
    if args.delete_data and cfg is not None and cfg.type == "local":
        import shutil
        from pathlib import Path

        target = Path(cfg.path) / name
        if target.exists():
            shutil.rmtree(target)
            print(f"Deleted data at {target}")
    print(f"Removed index '{name}'")


def index_rebuild(args):
    # type: (...) -> None
    """Rebuild derived device indexes from the source-of-truth store."""
    from iscc_search_tpu_torch.cli.common import get_active_index
    from iscc_search_tpu_torch.utils import timer

    unit_types, simprint_types, rebuild_all = args.unit_types, args.simprint_types, args.rebuild_all
    if not unit_types and not simprint_types and not rebuild_all:
        print("Specify --unit-type/--simprint-type or --all")
        raise SystemExit(1)
    with timer("open index"):
        index, idx_name = get_active_index(args.name, device=args.device)
    if not hasattr(index, "rebuild"):
        index.close()  # get_active_index opened (and may have created) it
        print("The configured backend does not support rebuild")
        raise SystemExit(1)
    try:
        with timer("rebuild"):
            result = index.rebuild(
                idx_name,
                unit_types=None if rebuild_all else list(unit_types),
                simprint_types=None if rebuild_all else list(simprint_types),
            )
    finally:
        index.close()
    print(f"Rebuilt unit types: {result['unit_types'] or '-'}")
    print(f"Rebuilt simprint types: {result['simprint_types'] or '-'}")
