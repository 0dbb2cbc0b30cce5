"""`serve` command: run the REST API server (port of
``iscc_search_tpu/cli/serve.py``: the command on argparse, its output
plain)."""

from __future__ import annotations


def register(subparsers):
    # type: (...) -> None
    cmd = subparsers.add_parser("serve", help="Run the ISCC-Search API server.")
    cmd.add_argument("--host", default=None, help="Bind host (default: ISCC_SEARCH_HOST or 0.0.0.0)")
    cmd.add_argument("--port", default=None, type=int, help="Bind port (default: ISCC_SEARCH_PORT or 8000)")
    cmd.add_argument("--index-uri", default=None, help="Backend URI (memory://, kv:///path, tpu:///path)")
    cmd.add_argument("--workers", default=None, type=int,
                     help="HTTP worker processes; more than 1 runs the scale-out topology")
    cmd.set_defaults(func=serve_command)


def serve_command(args):
    # type: (...) -> None
    """Run the ISCC-Search API server."""
    from iscc_search_tpu_torch.options import search_opts
    from iscc_search_tpu_torch.server.httpd import serve

    given = {"host": args.host, "port": args.port, "index_uri": args.index_uri, "workers": args.workers}
    opts = search_opts.override({k: v for k, v in given.items() if v is not None})
    # workers > 1 runs the scale-out topology (server/scaleout.py): this
    # process keeps exclusive index ownership (single-writer constraint) and
    # serves it over IPC to SO_REUSEPORT HTTP worker processes.
    if opts.aggregator_mode and opts.workers and opts.workers > 1:
        print("Aggregator mode requires a single worker (one poller).")
        raise SystemExit(1)
    serve(opts, device=args.device)
