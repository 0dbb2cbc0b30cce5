"""
REST API application — route surface parity with the reference server
(server/{indexes,assets,search,frontend}.py + probes at server/__init__.py):

    GET    /healthz                       liveness
    GET    /readyz                        readiness (list_indexes works)
    GET    /status                        public status (mode/version/ingest)
    GET    /indexes                       [auth, hidden in aggregator mode]
    POST   /indexes                 201   [auth, hidden in aggregator mode]
    GET    /indexes/{name}                [auth, hidden in aggregator mode]
    DELETE /indexes/{name}          204   [auth, hidden in aggregator mode]
    POST   /indexes/{name}/assets   201   [auth, hidden in aggregator mode]
    GET    /indexes/{name}/assets/{id}    [auth, foreign blocked in aggregator]
    POST   /indexes/{name}/search         [auth, foreign blocked in aggregator]
    GET    /indexes/{name}/search         [auth, foreign blocked in aggregator]
    GET    /openapi.json                  generated spec
    GET    /docs                          HTML docs
    GET    /                              landing page / frontend
    GET    /static/{path}                 web frontend assets

Exception contract mapping: ValueError->400, FileNotFoundError->404,
FileExistsError->409, pydantic validation->422.
"""

from __future__ import annotations

import atexit
import mimetypes
import threading
import time
from pathlib import Path

from iscc_search_tpu_torch import __version__
from iscc_search_tpu_torch.schema import IsccEntry, IsccIndex, IsccQuery
from iscc_search_tpu_torch.server import auth
from iscc_search_tpu_torch.server.openapi import build_openapi
from iscc_search_tpu_torch.server.wsgi import HTTPError, Response, WsgiApp
from iscc_search_tpu_torch.utils import get_logger

logger = get_logger(__name__)

STATIC_DIR = Path(__file__).parent / "static"
STATUS_CACHE_TTL = 30.0  # seconds; avoids walking segment files per request


def _dump(model):
    # type: (...) -> dict
    return model.model_dump(mode="json", exclude_unset=True, exclude_none=True)


def _model(cls, data):
    # type: (type, ...) -> ...
    """Validate a JSON object into a pydantic model; non-objects are 422
    (``cls(**data)`` on a list/str/int raises TypeError, not ValidationError)."""
    if not isinstance(data, dict):
        raise HTTPError(422, f"Request body must be a JSON object for {cls.__name__}")
    return cls(**data)


def init_sentry(opts):
    # type: (...) -> bool
    """
    Optional error tracking: initialized only when a DSN is configured AND
    sentry-sdk is installed (reference parity: env-gated, 5% default traces).
    """
    if not getattr(opts, "sentry_dsn", None):
        return False
    try:
        import sentry_sdk
    except ImportError:
        logger.warning("ISCC_SEARCH_SENTRY_DSN set but sentry-sdk is not installed")
        return False
    sentry_sdk.init(dsn=opts.sentry_dsn, traces_sample_rate=opts.sentry_traces_sample_rate)
    logger.info("Sentry error tracking initialized")
    return True


def create_app(index=None, opts=None):
    # type: (..., ...) -> WsgiApp
    """
    Build the WSGI application.

    :param index: Backend implementing IsccIndexProtocol (created from options
        when omitted — lifespan parity with reference server/__init__.py:75)
    :param opts: SearchOptions (global search_opts when omitted)
    """
    from iscc_search_tpu_torch.options import get_index, search_opts

    opts = opts or search_opts
    init_sentry(opts)
    app = WsgiApp(cors_origins=opts.cors_origins_list)

    if index is None:
        index = get_index(opts.index_uri)
        atexit.register(index.close)

    app.state.index = index
    app.state.opts = opts
    app.state.aggregator_status = {}
    app.state.status_cache = (0.0, None)
    app.state.status_lock = threading.Lock()
    openapi_spec = build_openapi()

    from iscc_search_tpu_torch.server import metrics as _metrics

    def _observe(method, route, status, seconds):
        # `route` is the matched route PATTERN recorded by the dispatcher
        # (e.g. "/indexes/{name}/search"); unmatched paths collapse to one
        # label so 404 scans can't grow the label set without bound.
        _metrics.http_requests.inc(method=method, route=route or "<unmatched>", status=str(status))
        _metrics.http_latency.observe(seconds)

    app.observer = _observe

    # ------------------------------------------------------------- probes

    @app.route("GET", "/healthz")
    def healthz(request):
        return Response({"status": "ok"})

    @app.route("GET", "/readyz")
    def readyz(request):
        idx = getattr(app.state, "index", None)
        if idx is None:  # pragma: no cover - index is always set in create_app
            return Response({"status": "not_ready", "reason": "index_not_initialized"}, status=503)
        try:
            idx.list_indexes()
        except Exception as exc:
            logger.warning(f"/readyz: list_indexes() failed: {exc}")
            return Response({"status": "not_ready", "reason": "list_indexes_failed"}, status=503)
        return Response({"status": "ready"})

    # ------------------------------------------------------------- status

    def _cached_index_info():
        # type: () -> dict | None
        """Aggregator index stats with a short TTL cache (size walks cost I/O)."""
        with app.state.status_lock:
            ts, cached = app.state.status_cache
            if time.monotonic() - ts < STATUS_CACHE_TTL:
                return cached
        info = None
        try:
            info = _dump(app.state.index.get_index(opts.aggregator_index_name))
        except Exception:  # pragma: no cover - index may not exist yet
            info = None
        with app.state.status_lock:
            app.state.status_cache = (time.monotonic(), info)
        return info

    @app.route("GET", "/status")
    def status(request):
        payload = {
            "version": __version__,
            "mode": "aggregator" if opts.aggregator_mode else "standard",
        }
        if opts.aggregator_mode:
            payload["network"] = opts.aggregator_network
            payload["index"] = _cached_index_info()
            hubs = []
            # Snapshot: the poller thread adds/prunes hubs concurrently, and
            # iterating the live dict can raise "changed size during iteration".
            for hub_status in list(app.state.aggregator_status.values()):
                hubs.append(
                    {
                        "hub_id": hub_status.hub_id,
                        "url": hub_status.url,
                        "cursor": hub_status.cursor,
                        "last_poll": hub_status.last_poll,
                        "ok": hub_status.ok,
                        # Redact error details on the public endpoint
                        "error": "poll failed" if hub_status.error else None,
                        "counts": dict(hub_status.counts),
                    }
                )
            payload["hubs"] = hubs
        return Response(payload)

    # ------------------------------------------------------------- indexes

    @app.route("GET", "/indexes")
    def list_indexes(request):
        auth.block_if_aggregator(opts)
        auth.verify_api_key(request, opts)
        return Response([_dump(i) for i in app.state.index.list_indexes()])

    @app.route("POST", "/indexes")
    def create_index(request):
        auth.block_if_aggregator(opts)
        auth.verify_api_key(request, opts)
        index_data = _model(IsccIndex, request.json() or {})
        created = app.state.index.create_index(index_data)
        return Response(_dump(created), status=201)

    @app.route("GET", "/indexes/{name}")
    def get_index_route(request):
        auth.block_if_aggregator(opts)
        auth.verify_api_key(request, opts)
        return Response(_dump(app.state.index.get_index(request.path_params["name"])))

    @app.route("DELETE", "/indexes/{name}")
    def delete_index(request):
        auth.block_if_aggregator(opts)
        auth.verify_api_key(request, opts)
        app.state.index.delete_index(request.path_params["name"])
        return Response(None, status=204)

    # ------------------------------------------------------------- assets

    @app.route("POST", "/indexes/{name}/assets")
    def add_assets(request):
        auth.block_if_aggregator(opts)
        auth.verify_api_key(request, opts)
        body = request.json()
        if not isinstance(body, list):
            raise HTTPError(422, "Request body must be a list of assets")
        assets = [_model(IsccEntry, item) for item in body]
        results = app.state.index.add_assets(request.path_params["name"], assets)
        return Response([_dump(r) for r in results], status=201)

    @app.route("GET", "/indexes/{name}/assets/{iscc_id}")
    def get_asset(request):
        auth.block_foreign_index_if_aggregator(request.path_params["name"], opts)
        auth.verify_api_key(request, opts)
        asset = app.state.index.get_asset(request.path_params["name"], request.path_params["iscc_id"])
        return Response(_dump(asset))

    # ------------------------------------------------------------- search

    def _limit(request):
        # type: (...) -> int
        try:
            limit = int(request.query.get("limit", 100))
        except ValueError:
            raise HTTPError(422, "limit must be an integer")
        if limit < 1:
            # Negative/zero limits reach the device top-k as k<1 (error) or
            # silently drop the best match via [:-n] slicing — reject instead.
            raise HTTPError(422, "limit must be >= 1")
        return limit

    @app.route("POST", "/indexes/{name}/search")
    def search_post(request):
        auth.block_foreign_index_if_aggregator(request.path_params["name"], opts)
        auth.verify_api_key(request, opts)
        query = _model(IsccQuery, request.json() or {})
        result = app.state.index.search_assets(request.path_params["name"], query, _limit(request))
        # model_dump_json: pydantic's C serializer straight to JSON is 2.4x
        # the dict-then-json.dumps round trip on a 100-match result.
        return Response(result.model_dump_json(exclude_none=True).encode("utf-8"))

    @app.route("GET", "/indexes/{name}/search")
    def search_get(request):
        auth.block_foreign_index_if_aggregator(request.path_params["name"], opts)
        auth.verify_api_key(request, opts)
        iscc_code = request.query.get("iscc_code")
        if not iscc_code:
            raise HTTPError(422, "iscc_code query parameter is required")
        query = IsccQuery(iscc_code=iscc_code)
        result = app.state.index.search_assets(request.path_params["name"], query, _limit(request))
        # model_dump_json: pydantic's C serializer straight to JSON is 2.4x
        # the dict-then-json.dumps round trip on a 100-match result.
        return Response(result.model_dump_json(exclude_none=True).encode("utf-8"))

    # ---------------------------------------------------------- docs/front

    @app.route("GET", "/openapi.json")
    @app.route("GET", "/openapi/openapi.json")
    def openapi(request):
        return Response(openapi_spec)

    @app.route("GET", "/docs")
    def docs(request):
        html = f"""<!doctype html>
<html>
  <head>
    <title>ISCC-Search TPU API - Documentation</title>
    <meta charset="utf-8" />
    <meta name="viewport" content="width=device-width, initial-scale=1" />
    <script src="https://unpkg.com/@stoplight/elements/web-components.min.js"></script>
    <link rel="stylesheet" href="https://unpkg.com/@stoplight/elements/styles.min.css">
  </head>
  <body>
    <elements-api apiDescriptionUrl="/openapi.json" router="hash" layout="sidebar" hideExport="true" />
  </body>
</html>"""
        return Response(html, media_type="text/html")

    @app.route("GET", "/")
    def landing(request):
        page = "aggregator.html" if opts.aggregator_mode else "index.html"
        f = STATIC_DIR / page
        if f.exists():
            return Response(f.read_text(), media_type="text/html")
        return Response(
            {"name": "ISCC-Search TPU", "version": __version__, "docs": "/docs", "openapi": "/openapi.json"}
        )

    @app.route("GET", "/metrics")
    def metrics_endpoint(request):
        # Prometheus 0.0.4 text exposition; per-process (see server/metrics.py)
        from iscc_search_tpu_torch.server import metrics

        return Response(metrics.registry.render(), media_type="text/plain; version=0.0.4")

    @app.route("GET", "/static/{path}")
    def static_files(request):
        rel = request.path_params["path"]
        f = (STATIC_DIR / rel).resolve()
        if not str(f).startswith(str(STATIC_DIR.resolve())) or not f.is_file():
            raise HTTPError(404, "Not Found")
        ctype = mimetypes.guess_type(str(f))[0] or "application/octet-stream"
        return Response(f.read_bytes(), media_type=ctype)

    return app
