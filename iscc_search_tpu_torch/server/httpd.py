"""
Threaded WSGI HTTP server with lifespan management (copy of
``iscc_search_tpu/server/httpd.py``).

``serve()`` opens the backend of ``ISCC_SEARCH_INDEX_URI`` on the card (or on
the device the caller names), serves the REST app over the pooled keep-alive
transport (``http_backend="pooled"``) or the stdlib thread-per-request server
(``"wsgiref"``), and on SIGTERM drains the server and flushes and closes the
index, as the JAX package's does. ``workers > 1`` runs the scale-out
topology (``server/scaleout.py``: this process is the engine and owns the
index on the device, N ``SO_REUSEPORT`` HTTP worker processes reach it over
a unix socket). Two deployments of the JAX package are not ported and raise
``NotImplementedError`` naming their ROADMAP.md item: multi-host serving
(``distributed``) and aggregator mode (``aggregator_network``).
"""

from __future__ import annotations

import threading
from socketserver import ThreadingMixIn
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

from iscc_search_tpu_torch.utils import get_logger, configure_logging

logger = get_logger(__name__)


class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    """Thread-per-request WSGI server."""

    daemon_threads = True
    # The socketserver default listen backlog is 5. Clients without
    # keep-alive (one TCP connect per request) overflow that under modest
    # concurrency, and a dropped SYN retransmits after exactly 1s — measured
    # as a 1074ms p99 at 16 clients vs an 89ms p50
    # (benchmarks/LATENCY_16clients.json, round 2).
    request_queue_size = 128


class QuietHandler(WSGIRequestHandler):
    """Route request logs through the application logger."""

    def log_message(self, format, *args):  # noqa: A002
        logger.info("%s - %s" % (self.address_string(), format % args))


def serve(opts=None, device="cuda"):
    # type: (..., str) -> None
    """Run the API server until interrupted (index lifecycle managed here).

    :param device: Device of the ``tpu://`` backend's engines (the card
        unless the caller asks for ``"cpu"``).
    """
    from iscc_search_tpu_torch.options import get_index, search_opts
    from iscc_search_tpu_torch.server.app import create_app

    opts = opts or search_opts
    if opts.distributed:
        raise NotImplementedError(
            "multi-host serving (ISCC_SEARCH_DISTRIBUTED) is not ported: ROADMAP.md queue 1 item 4"
        )
    if opts.workers and opts.workers > 1:
        # Multi-process scale-out: SO_REUSEPORT HTTP workers + this process
        # as the engine (single writer). Aggregator mode stays single-process
        # (one poller); the CLI rejects that combination.
        from iscc_search_tpu_torch.server.scaleout import serve_scaleout

        serve_scaleout(opts, device=device)
        return
    if opts.aggregator_mode:
        raise NotImplementedError(
            "aggregator mode (ISCC_SEARCH_AGGREGATOR_NETWORK) is not ported: ROADMAP.md queue 1 item 3, aggregator"
        )
    configure_logging(level=opts.log_level)
    index = get_index(opts.index_uri, device=device)
    app = create_app(index=index, opts=opts)

    # Bind the socket FIRST: if the port is taken, the index is closed
    # before anything else has started.
    try:
        if opts.http_backend == "wsgiref":
            httpd = make_server(
                opts.host, opts.port, app, server_class=ThreadingWSGIServer, handler_class=QuietHandler
            )
        else:
            from iscc_search_tpu_torch.server.pooled import PooledHTTPServer

            httpd = PooledHTTPServer(
                opts.host,
                opts.port,
                app,
                threads=opts.http_threads,
                max_pending=opts.http_max_pending,
                queue_deadline=opts.http_queue_deadline_ms / 1000.0,
            )
    except OSError:
        index.close()
        raise
    logger.info(f"Serving on http://{opts.host}:{opts.port} (backend: {opts.index_uri})")

    # Graceful SIGTERM (Docker/k8s stop): drain the server loop, then flush
    # and close the index in the finally block — parity with the reference's
    # stop_grace_period guidance (docs/howto/deployment.md). shutdown() must
    # run off the serving thread, so the handler hands it to a helper thread.
    import signal

    def _term(_signum, _frame):  # pragma: no cover - signal delivery timing
        logger.info("SIGTERM received: draining connections and saving state...")
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    previous = None
    try:
        previous = signal.signal(signal.SIGTERM, _term)
    except ValueError:  # pragma: no cover - non-main thread (tests/embedding)
        pass

    try:
        httpd.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        logger.info("Shutting down: closing index...")
        index.close()
        httpd.server_close()
        if previous is not None:
            try:
                signal.signal(signal.SIGTERM, previous)
            except ValueError:  # pragma: no cover
                pass
