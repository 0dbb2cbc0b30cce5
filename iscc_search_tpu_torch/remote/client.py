"""
Remote index client — IsccIndexProtocol over HTTP, on the standard library.

The same client as ``iscc_search_tpu/remote/client.py`` (reference
remote/client.py:29-279) without httpx: one keep-alive ``http.client``
connection per thread, X-API-Key auth, HTTP status -> exception mapping
(404 -> FileNotFoundError, 409 -> FileExistsError, 400/422 -> ValueError,
any other failure -> RuntimeError), chunked batch adds with
exponential-backoff retry on transport errors.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from urllib.parse import urlencode, urlsplit

from iscc_search_tpu_torch.schema import IsccAddResult, IsccEntry, IsccIndex, IsccSearchResult
from iscc_search_tpu_torch.utils import get_logger

logger = get_logger(__name__)

__all__ = ["RemoteIndex", "TransportError"]

MAX_RETRIES = 3
RETRY_BASE_DELAY = 1.0


class TransportError(ConnectionError):
    """The request or its response was lost in transport (connect, send or
    receive failed); the server may or may not have seen it."""


TRANSIENT_ERRORS = (TransportError,)


class Response:
    """Status and body of one HTTP response."""

    def __init__(self, status_code, content):
        # type: (int, bytes) -> None
        self.status_code = status_code
        self.content = content

    @property
    def is_success(self):
        # type: () -> bool
        return 200 <= self.status_code < 300

    @property
    def text(self):
        # type: () -> str
        return self.content.decode("utf-8", "replace")

    def json(self):
        # type: () -> object
        return json.loads(self.content)


class RemoteIndex:
    """HTTP client implementing IsccIndexProtocol against a remote server."""

    def __init__(self, url, index_name, api_key=None, chunk_size=100, timeout=60.0):
        # type: (str, str, str | None, int, float) -> None
        self.url = url.rstrip("/")
        self.index_name = index_name
        self.api_key = api_key
        self.chunk_size = chunk_size
        self.timeout = timeout
        parts = urlsplit(self.url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"RemoteIndex needs an http:// or https:// URL, got: '{url}'")
        self._scheme = parts.scheme
        self._host = parts.hostname
        self._port = parts.port
        self._prefix = parts.path
        self._local = threading.local()
        self._conns = []  # type: list[http.client.HTTPConnection]
        self._conns_lock = threading.Lock()

    def _connection(self):
        # type: () -> http.client.HTTPConnection
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = http.client.HTTPSConnection if self._scheme == "https" else http.client.HTTPConnection
            conn = cls(self._host, self._port, timeout=self.timeout)
            self._local.conn = conn
            self._local.used = False
            with self._conns_lock:
                self._conns.append(conn)
        return conn

    def _drop_connection(self):
        # type: () -> None
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def request(self, method, path, payload=None, params=None):
        # type: (str, str, object, dict | None) -> Response
        """One request on this thread's keep-alive connection. A connection
        the server closed while it sat idle is opened again once; any other
        loss raises TransportError."""
        target = self._prefix + path + (f"?{urlencode(params)}" if params else "")
        headers = {"Accept": "application/json"}
        if self.api_key:
            headers["X-API-Key"] = self.api_key
        body = None
        if payload is not None:
            body = json.dumps(payload).encode("utf-8")
            headers["Content-Type"] = "application/json"
        conn = self._connection()
        fresh = not self._local.used
        try:
            conn.request(method, target, body=body, headers=headers)
            raw = conn.getresponse()
            content = raw.read()
        except (OSError, http.client.HTTPException) as exc:
            self._drop_connection()
            if fresh:
                raise TransportError(f"{method} {target}: {exc!r}") from exc
            return self.request(method, path, payload, params)  # on a new connection
        self._local.used = True
        if raw.will_close:
            self._drop_connection()
        return Response(raw.status, content)

    def _json(self, response):
        # type: (Response) -> ...
        """Decode a success response; garbage from the server is a RuntimeError
        (a server fault), never a ValueError (reserved for invalid user input
        by the protocol's exception contract)."""
        try:
            return response.json()
        except Exception as exc:
            raise RuntimeError(f"Invalid JSON response from server: {exc}") from None

    def _raise_for_status(self, response):
        # type: (Response) -> None
        if response.is_success:
            return
        try:
            detail = response.json().get("detail", response.text)
        except Exception:
            detail = response.text
        if response.status_code == 404:
            raise FileNotFoundError(detail)
        if response.status_code == 409:
            raise FileExistsError(detail)
        if response.status_code in (400, 422):
            raise ValueError(detail)
        raise RuntimeError(f"HTTP {response.status_code}: {detail}")

    def list_indexes(self):
        # type: () -> list[IsccIndex]
        response = self.request("GET", "/indexes")
        self._raise_for_status(response)
        return [IsccIndex(**i) for i in self._json(response)]

    def create_index(self, index):
        # type: (IsccIndex) -> IsccIndex
        response = self.request("POST", "/indexes", payload={"name": index.name})
        self._raise_for_status(response)
        return IsccIndex(**self._json(response))

    def get_index(self, name):
        # type: (str) -> IsccIndex
        response = self.request("GET", f"/indexes/{name}")
        self._raise_for_status(response)
        return IsccIndex(**self._json(response))

    def delete_index(self, name):
        # type: (str) -> None
        response = self.request("DELETE", f"/indexes/{name}")
        self._raise_for_status(response)

    def add_assets(self, index_name, assets):
        # type: (str, list[IsccEntry]) -> list[IsccAddResult]
        """Chunked batch add (self.chunk_size per request) with retries."""
        if not assets:
            return []
        results = []  # type: list[IsccAddResult]
        for start in range(0, len(assets), self.chunk_size):
            results.extend(self._add_batch(index_name, assets[start : start + self.chunk_size]))
        return results

    def _add_batch(self, index_name, assets):
        # type: (str, list[IsccEntry]) -> list[IsccAddResult]
        payload = [a.model_dump(mode="json", exclude_unset=True) for a in assets]
        last_error = None  # type: Exception | None
        for attempt in range(1, MAX_RETRIES + 1):
            try:
                response = self.request("POST", f"/indexes/{index_name}/assets", payload=payload)
                self._raise_for_status(response)
                return [IsccAddResult(**r) for r in self._json(response)]
            except TRANSIENT_ERRORS as exc:
                last_error = exc
                if attempt < MAX_RETRIES:
                    delay = RETRY_BASE_DELAY * (2 ** (attempt - 1))
                    logger.warning(
                        f"Batch request failed (attempt {attempt}/{MAX_RETRIES}): {exc}. Retrying in {delay:.0f}s"
                    )
                    time.sleep(delay)
        raise last_error  # type: ignore[misc]

    def get_asset(self, index_name, iscc_id):
        # type: (str, str) -> IsccEntry
        response = self.request("GET", f"/indexes/{index_name}/assets/{iscc_id}")
        self._raise_for_status(response)
        return IsccEntry(**self._json(response))

    def search_assets(self, index_name, query, limit=100):
        # type: (str, ..., int) -> IsccSearchResult
        payload = query.model_dump(mode="json", exclude_unset=True)
        response = self.request("POST", f"/indexes/{index_name}/search", payload=payload, params={"limit": limit})
        self._raise_for_status(response)
        return IsccSearchResult(**self._json(response))

    def close(self):
        # type: () -> None
        """Close every thread's connection; idempotent (a later call opens
        new ones)."""
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            conn.close()
        self._local = threading.local()
        if conns:
            logger.debug(f"Closed remote index client for {self.url}")
