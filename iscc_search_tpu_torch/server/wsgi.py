"""
Minimal WSGI micro-framework: routing, JSON bodies, CORS, error mapping
(copy of ``iscc_search_tpu/server/wsgi.py``; ``ValidationError`` is the
port's ``schema.ValidationError``, whose ``errors()`` has pydantic's shape).

The environment provides no ASGI/WSGI framework (no FastAPI/starlette), so the
REST layer is a small self-contained router. The protocol methods are
synchronous by contract (protocols/index.py), so a threaded WSGI server gives
the same concurrency model as the reference's FastAPI-threadpool setup
(SURVEY §1 key invariants).
"""

from __future__ import annotations

import json
import re
import time
import traceback
from urllib.parse import parse_qs

from iscc_search_tpu_torch.schema import ValidationError
from iscc_search_tpu_torch.utils import OverloadedError

from iscc_search_tpu_torch.utils import get_logger

logger = get_logger(__name__)

STATUS_TEXT = {
    200: "200 OK",
    201: "201 Created",
    204: "204 No Content",
    400: "400 Bad Request",
    401: "401 Unauthorized",
    404: "404 Not Found",
    405: "405 Method Not Allowed",
    409: "409 Conflict",
    422: "422 Unprocessable Entity",
    500: "500 Internal Server Error",
    503: "503 Service Unavailable",
}


class HTTPError(Exception):
    """Raise inside a handler to produce a structured JSON error response."""

    def __init__(self, status, detail):
        # type: (int, str | list) -> None
        self.status = status
        self.detail = detail


class Request:
    """Parsed WSGI request."""

    def __init__(self, environ):
        # type: (dict) -> None
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = environ.get("PATH_INFO", "/")
        self.query = {k: v[0] for k, v in parse_qs(environ.get("QUERY_STRING", "")).items()}
        self.headers = {
            k[5:].replace("_", "-").lower(): v for k, v in environ.items() if k.startswith("HTTP_")
        }
        if environ.get("CONTENT_TYPE"):
            self.headers["content-type"] = environ["CONTENT_TYPE"]
        self.path_params = {}  # type: dict[str, str]
        self._body = None  # type: bytes | None

    @property
    def body(self):
        # type: () -> bytes
        if self._body is None:
            try:
                length = int(self.environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                length = 0
            self._body = self.environ["wsgi.input"].read(length) if length else b""
        return self._body

    def json(self):
        # type: () -> object
        try:
            return json.loads(self.body.decode("utf-8"))
        except Exception:
            raise HTTPError(400, "Invalid JSON body")


class Response:
    """JSON (or raw) response."""

    def __init__(self, content=None, status=200, headers=None, media_type="application/json"):
        # type: (object, int, dict | None, str) -> None
        self.status = status
        self.headers = dict(headers or {})
        if status == 204 or content is None:
            self.body = b""
        elif isinstance(content, (bytes, bytearray)):
            self.body = bytes(content)
        elif isinstance(content, str) and media_type != "application/json":
            self.body = content.encode("utf-8")
        else:
            self.body = json.dumps(content).encode("utf-8")
        if self.body and "content-type" not in {k.lower() for k in self.headers}:
            self.headers["Content-Type"] = media_type


def _compile_route(pattern):
    # type: (str) -> re.Pattern
    regex = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern)
    return re.compile(f"^{regex}$")


class WsgiApp:
    """Route table + dispatch + CORS + exception mapping."""

    def __init__(self, cors_origins=("*",)):
        # type: (tuple | list) -> None
        self._routes = []  # type: list[tuple[str, str, re.Pattern, callable]]
        self.cors_origins = list(cors_origins)
        self.state = type("State", (), {})()
        # Optional (method, path, status, seconds) hook for metrics — set by
        # create_app; kept out of the dispatch signature so WsgiApp stays a
        # plain router.
        self.observer = None  # type: callable | None

    def route(self, method, pattern):
        # type: (str, str) -> callable
        def decorator(fn):
            self._routes.append((method.upper(), pattern, _compile_route(pattern), fn))
            return fn

        return decorator

    def _cors_headers(self, request):
        # type: (Request) -> dict
        origin = request.headers.get("origin")
        if not origin:
            return {}
        allowed = "*" if "*" in self.cors_origins else (origin if origin in self.cors_origins else None)
        if allowed is None:
            return {}
        return {
            "Access-Control-Allow-Origin": allowed,
            "Access-Control-Allow-Methods": "*",
            "Access-Control-Allow-Headers": "*",
        }

    def handle(self, request):
        # type: (Request) -> Response
        if request.method == "OPTIONS":
            return Response(None, status=204, headers=self._cors_headers(request))
        # HEAD is served by the GET handler with the body stripped
        effective_method = "GET" if request.method == "HEAD" else request.method
        path_matched = False
        for method, pattern, regex, fn in self._routes:
            m = regex.match(request.path)
            if not m:
                continue
            path_matched = True
            # The registered pattern (not the raw path) is what metrics may
            # label by — raw paths are attacker-controlled cardinality.
            request.matched_route = pattern
            if method != effective_method:
                continue
            request.path_params = m.groupdict()
            try:
                resp = fn(request)
            except HTTPError as e:
                resp = Response({"detail": e.detail}, status=e.status)
            except ValidationError as e:
                details = [f"{'.'.join(str(p) for p in err['loc'])}: {err['msg']}" for err in e.errors()]
                resp = Response({"detail": details}, status=422)
            except ValueError as e:
                resp = Response({"detail": str(e)}, status=400)
            except FileNotFoundError as e:
                resp = Response({"detail": str(e)}, status=404)
            except FileExistsError as e:
                resp = Response({"detail": str(e)}, status=409)
            except OverloadedError as e:
                resp = Response({"detail": str(e) or "Server overloaded, retry later"}, status=503)
                resp.headers["Retry-After"] = "1"
            except Exception:
                logger.error("Unhandled error:\n" + traceback.format_exc())
                resp = Response({"detail": "Internal Server Error"}, status=500)
            resp.headers.update(self._cors_headers(request))
            if request.method == "HEAD":
                resp.headers.setdefault("Content-Length", str(len(resp.body)))
                resp.body = b""
            return resp
        # CORS headers on the fallback responses too, or cross-origin browser
        # clients see an opaque network error instead of the JSON detail.
        if path_matched:
            resp = Response({"detail": "Method Not Allowed"}, status=405)
        else:
            resp = Response({"detail": "Not Found"}, status=404)
        resp.headers.update(self._cors_headers(request))
        return resp

    def __call__(self, environ, start_response):
        # type: (dict, callable) -> list[bytes]
        request = Request(environ)
        if self.observer is not None:
            t0 = time.perf_counter()
            resp = self.handle(request)
            route = getattr(request, "matched_route", None)
            self.observer(request.method, route, resp.status, time.perf_counter() - t0)
        else:
            resp = self.handle(request)
        headers = list(resp.headers.items())
        if resp.body:
            headers.append(("Content-Length", str(len(resp.body))))
        start_response(STATUS_TEXT.get(resp.status, f"{resp.status} Unknown"), headers)
        return [resp.body]
