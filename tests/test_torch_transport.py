"""The port's HTTP transport, remote client and ``serve()`` on the CPU.

- The cases of ``tests/test_pooled.py`` (keep-alive, pipelining, framing,
  deadlines, the soak), the pooled-server and WSGI cases of
  ``tests/test_overload.py`` (shedding with 503 at admission and past the
  queue deadline) and ``tests/test_wsgi.py`` run against the port: each file
  is compiled with the JAX package's name read as the port's, so the same
  test bodies drive ``iscc_search_tpu_torch.server`` on local sockets.
- The port's ``RemoteIndex`` (``http.client``, no httpx) and the JAX one
  (httpx) against one live port server give equal results; the port's
  client maps status codes, chunks adds and retries them as the JAX client
  does.
- ``serve()`` in a subprocess on ``memory://`` and ``kv://`` answers, then
  drains and exits 0 on SIGTERM (every thread's stack in the failure
  message if it has not exited 60 s later); ``tpu://`` with
  ``device="cpu"`` too. Multi-host serving without ``multihost_index`` or
  a ``tpu://`` backend raises the JAX package's ``ValueError`` (the
  distributed ``serve()``: ``tests/test_torch_multihost.py``; scale-out
  workers: ``tests/test_torch_scaleout.py``; aggregator mode:
  ``tests/test_torch_aggregator.py``); no card with the default device
  raises.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import httpx
import pytest
import torch

from iscc_search_tpu.remote import RemoteIndex as JaxRemoteIndex
from iscc_search_tpu.schema import IsccEntry as JaxEntry
from iscc_search_tpu.schema import IsccQuery as JaxQuery
from iscc_search_tpu_torch.indexes.kv import KvIndexManager
from iscc_search_tpu_torch.indexes.memory import MemoryIndex
from iscc_search_tpu_torch.options import SearchOptions
from iscc_search_tpu_torch.protocols.index import IsccIndexProtocol
from iscc_search_tpu_torch.remote import RemoteIndex, client as remote_client
from iscc_search_tpu_torch.schema import IsccEntry, IsccIndex, IsccQuery
from iscc_search_tpu_torch.server import httpd
from iscc_search_tpu_torch.server.app import create_app
from iscc_search_tpu_torch.server.pooled import PooledHTTPServer
from tests.test_torch_server import make_assets

REPO = Path(__file__).resolve().parents[1]


def _port_cases(name, tests, fixtures=(), replace=()):
    """The named tests and fixtures of ``tests/<name>.py`` compiled with
    ``iscc_search_tpu.`` (and the logger name ``"iscc_search_tpu"``) read
    as the port's: the JAX package's test bodies against the port. Each
    ``(line, new)`` of ``replace`` puts ``new`` in the place of ``line``,
    which occurs once. Tests are renamed ``test_<name>__<test>``."""
    path = REPO / "tests" / f"{name}.py"
    source = path.read_text()
    for line, new in replace:
        assert source.count(line) == 1, line
        source = source.replace(line, new)
    source = (source.replace("iscc_search_tpu.", "iscc_search_tpu_torch.")
              .replace('"iscc_search_tpu"', '"iscc_search_tpu_torch"'))
    namespace = {"__name__": f"{__name__}.{name}", "__file__": str(path)}
    exec(compile(source, str(path), "exec"), namespace)
    found = {f"{name[5:]}__{t[5:]}": namespace[t] for t in tests}
    return {**{f"test_{k}": v for k, v in found.items()}, **{f: namespace[f] for f in fixtures}}


POOLED = [
    "test_roundtrip_and_crud", "test_keepalive_reuses_connection", "test_pipelined_requests",
    "test_http10_closes_by_default", "test_connection_close_honored", "test_head_request_no_body",
    "test_chunked_request_rejected", "test_malformed_request_line", "test_query_string_and_path_decode",
    "test_concurrent_clients", "test_body_spanning_multiple_reads", "test_shutdown_unblocks_serve_forever",
    "test_serve_uses_pooled_backend", "test_oversized_header_rejected", "test_bad_content_length_rejected",
    "test_body_too_large_rejected", "test_http10_keepalive_header_honored",
    "test_options_preflight_204_no_content_length_added", "test_raising_app_returns_500",
    "test_server_close_without_explicit_shutdown", "test_parked_connection_closed_by_peer",
    "test_negative_content_length_rejected", "test_expect_100_continue",
    "test_trickling_request_hits_whole_request_deadline", "test_idle_parked_connection_reaped",
    "test_pooled_soak_mixed_traffic", "test_transfer_encoding_variants_all_rejected",
    "test_repeated_headers_comma_joined", "test_idle_new_connection_does_not_pin_workers",
    "test_expect_100_continue_interim_response", "test_header_line_without_colon_is_skipped",
]
OVERLOAD = [  # its scale-out cases run in tests/test_torch_scaleout.py
    "test_queue_deadline_sheds_stale_requests", "test_admission_bound_sheds_burst",
    "test_overload_latency_stays_bounded", "test_zero_disables_shedding", "test_wsgi_maps_overloaded_to_503",
    "test_admission_probe_sheds_before_parse",
]
WSGI = [
    "test_request_parsing", "test_request_invalid_json", "test_request_bad_content_length", "test_response_types",
    "test_routing_and_path_params", "test_exception_mapping", "test_cors_denied_origin",
    "test_wsgi_callable_interface", "test_timer_logs", "test_fuzz_requests_never_500",
]
globals().update(_port_cases("test_pooled", POOLED, fixtures=("pooled_server",)))
globals().update(_port_cases("test_overload", OVERLOAD))
globals().update(_port_cases("test_wsgi", WSGI))


def test_the_loaded_cases_are_the_ports():
    """The loaded bodies resolve the port's classes, every named case exists."""
    cases = _port_cases("test_pooled", ["test_roundtrip_and_crud"], fixtures=("pooled_server",))
    body = cases["test_pooled__roundtrip_and_crud"]
    assert body.__globals__["PooledHTTPServer"] is PooledHTTPServer
    assert body.__globals__["create_app"] is create_app and body.__globals__["MemoryIndex"] is MemoryIndex
    text = (REPO / "tests" / "test_pooled.py").read_text()
    assert all(f"def {name}(" in text for name in POOLED)


# ------------------------------------------------------------ the client


@pytest.fixture
def live():
    """A port app over a memory backend on a pooled server at a free port."""
    app = create_app(index=MemoryIndex(), opts=SearchOptions(index_uri="memory://"))
    srv = PooledHTTPServer("127.0.0.1", 0, app, threads=4)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.server_close()
    thread.join(5)


def test_both_clients_answer_alike_against_a_live_port_server(live):
    assets = make_assets(9)
    ours, theirs = RemoteIndex(live, "alpha", chunk_size=4), JaxRemoteIndex(live, "alpha", chunk_size=4)
    assert isinstance(ours, IsccIndexProtocol)
    try:
        assert ours.create_index(IsccIndex(name="alpha")).model_dump() == {"name": "alpha", "assets": 0, "size": 0,
                                                                         "sizes": None}
        details = []
        for client in (ours, theirs):
            with pytest.raises(FileExistsError) as exc:
                client.create_index(IsccIndex(name="alpha"))
            details.append(str(exc.value))
        assert details[0] == details[1] == "Index 'alpha' already exists"
        added = ours.add_assets("alpha", [IsccEntry(**a) for a in assets[:5]])
        added += theirs.add_assets("alpha", [JaxEntry(**a) for a in assets[5:]])
        again = theirs.add_assets("alpha", [JaxEntry(**a) for a in assets[:2]])
        assert [r.model_dump(mode="json") for r in again] == \
            [r.model_dump(mode="json") for r in ours.add_assets("alpha", [IsccEntry(**a) for a in assets[:2]])]
        assert [r.status for r in added] == ["created"] * 9
        assert [i.model_dump() for i in ours.list_indexes()] == [i.model_dump() for i in theirs.list_indexes()]
        assert ours.get_index("alpha").model_dump() == theirs.get_index("alpha").model_dump()
        for a in assets[:3]:
            assert ours.get_asset("alpha", a["iscc_id"]).model_dump() == theirs.get_asset("alpha", a["iscc_id"]).model_dump()
            for q in ({"iscc_code": a["iscc_code"]}, {"units": a["units"]}, {"iscc_id": a["iscc_id"]}):
                for limit in (1, 10, 100):
                    assert ours.search_assets("alpha", IsccQuery(**q), limit).model_dump() == \
                        theirs.search_assets("alpha", JaxQuery(**q), limit).model_dump()
        for client, empty in ((ours, IsccQuery()), (theirs, JaxQuery())):
            with pytest.raises(FileNotFoundError):
                client.get_index("missing")
            with pytest.raises(FileNotFoundError):
                client.get_asset("alpha", "ISCC:MAIGIIFJRDGEQQAA")
            with pytest.raises(ValueError):
                client.search_assets("alpha", empty)
        ours.delete_index("alpha")
        with pytest.raises(FileNotFoundError):
            theirs.delete_index("alpha")
    finally:
        ours.close()
        theirs.close()
    ours.close()  # idempotent


def _stub(handler):
    """A server on a free port answering every request with
    ``handler(method, path, body) -> (status, bytes)``; returns (url, calls, stop)."""
    calls = []

    def app(environ, start_response):
        length = int(environ.get("CONTENT_LENGTH") or 0)
        body = environ["wsgi.input"].read(length)
        calls.append((environ["REQUEST_METHOD"], environ["PATH_INFO"], environ["QUERY_STRING"],
                      environ.get("HTTP_X_API_KEY"), body))
        status, payload = handler(environ["REQUEST_METHOD"], environ["PATH_INFO"], body)
        start_response(f"{status} X", [("Content-Type", "application/json")])
        return [payload]

    srv = PooledHTTPServer("127.0.0.1", 0, app, threads=2)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def stop():
        srv.server_close()
        thread.join(5)

    return f"http://127.0.0.1:{srv.server_port}", calls, stop


@pytest.mark.parametrize("status,exc", [(404, FileNotFoundError), (409, FileExistsError), (400, ValueError),
                                        (422, ValueError), (401, RuntimeError), (500, RuntimeError),
                                        (503, RuntimeError)])
def test_status_codes_map_to_the_protocol_exceptions(status, exc):
    url, _, stop = _stub(lambda m, p, b: (status, b'{"detail": "the detail"}'))
    client = RemoteIndex(url, "alpha")
    try:
        with pytest.raises(exc, match="the detail"):
            client.get_index("alpha")
        if exc is RuntimeError:
            with pytest.raises(RuntimeError, match=f"HTTP {status}"):
                client.list_indexes()
    finally:
        client.close()
        stop()


def test_plain_text_detail_and_garbage_success():
    url, _, stop = _stub(lambda m, p, b: (422, b"not-json-detail") if p == "/indexes/x" else (200, b"<html>"))
    client = RemoteIndex(url, "x")
    try:
        with pytest.raises(ValueError, match="not-json-detail"):
            client.get_index("x")
        with pytest.raises(RuntimeError, match="Invalid JSON"):
            client.list_indexes()
    finally:
        client.close()
        stop()


def test_key_limit_chunks_and_keep_alive():
    """The API key rides every request, the limit is a query parameter, adds
    go in chunks of ``chunk_size`` (a later chunk's failure propagates after
    the first was applied, with no retry on an HTTP error), and the requests
    share one connection."""
    result = json.dumps({"query": {}, "global_matches": [], "chunk_matches": []}).encode()

    def handler(method, path, body):
        if path.endswith("/assets"):
            items = json.loads(body)
            if any(a["iscc_id"].endswith("7") for a in items):
                return 400, b'{"detail": "bad chunk"}'
            return 201, json.dumps([{"iscc_id": a["iscc_id"], "status": "created"} for a in items]).encode()
        return 200, result

    url, calls, stop = _stub(handler)
    assets = [IsccEntry(**a) for a in make_assets(6)]
    client = RemoteIndex(url + "/", "idx", api_key="sekrit", chunk_size=4)
    try:
        assert client.url == url
        res = client.search_assets("idx", IsccQuery(units=None), limit=7)
        assert res.global_matches == [] and res.chunk_matches == []
        assert len(client.add_assets("idx", assets)) == 6
        assert client.add_assets("idx", []) == []
        bad = IsccEntry(**{**make_assets(1)[0], "iscc_id": "ISCC:MAIGIIFJRDGEQQA7"})
        with pytest.raises(ValueError, match="bad chunk"):
            client.add_assets("idx", assets[:4] + [bad])
    finally:
        client.close()
        stop()
    assert [(c[0], c[1], c[2]) for c in calls] == [("POST", "/indexes/idx/search", "limit=7")] + \
        [("POST", "/indexes/idx/assets", "")] * 4
    assert {c[3] for c in calls} == {"sekrit"}
    assert [len(json.loads(c[4])) for c in calls[1:]] == [4, 2, 4, 1]
    assert json.loads(calls[0][4]) == {"units": None}  # exclude_unset: only what the query was given
    assert json.loads(calls[1][4])[0] == make_assets(1)[0]


def test_adds_retry_with_backoff_on_transport_errors(monkeypatch):
    """A refused connection is a transport error: retried MAX_RETRIES times
    with delays 1x, 2x the base, then raised. An HTTP error is not retried."""
    delays = []
    monkeypatch.setattr(remote_client.time, "sleep", delays.append)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    client = RemoteIndex(f"http://127.0.0.1:{port}", "idx")
    with pytest.raises(remote_client.TransportError):
        client.add_assets("idx", [IsccEntry(**make_assets(1)[0])])
    assert delays == [1.0, 2.0] and remote_client.MAX_RETRIES == 3
    with pytest.raises(ConnectionError):  # reads are not retried
        client.list_indexes()
    client.close()


def test_a_failed_attempt_is_retried_until_it_succeeds(monkeypatch, live):
    """The first attempt's connection is lost before the response; the next
    attempt succeeds."""
    monkeypatch.setattr(remote_client.time, "sleep", lambda s: None)
    client = RemoteIndex(live, "idx")
    client.create_index(IsccIndex(name="idx"))
    real, calls = client.request, []

    def flaky(method, path, payload=None, params=None):
        calls.append(path)
        if len(calls) == 1:
            raise remote_client.TransportError("lost")
        return real(method, path, payload, params)

    monkeypatch.setattr(client, "request", flaky)
    assert [r.status for r in client.add_assets("idx", [IsccEntry(**make_assets(1)[0])])] == ["created"]
    assert calls == ["/indexes/idx/assets"] * 2
    client.close()


def test_a_connection_the_server_closed_is_opened_again():
    """The server reaps an idle keep-alive connection; the next request opens
    a new one instead of failing."""
    app = create_app(index=MemoryIndex(), opts=SearchOptions(index_uri="memory://"))
    srv = PooledHTTPServer("127.0.0.1", 0, app, threads=2, idle_timeout=0.2, sweep_interval=0.1)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    client = RemoteIndex(f"http://127.0.0.1:{srv.server_port}", "idx")
    try:
        assert client.list_indexes() == []
        time.sleep(1.5)
        with srv._parked_lock:
            assert not srv._parked  # reaped
        assert client.create_index(IsccIndex(name="idx")).name == "idx"
    finally:
        client.close()
        srv.server_close()
        thread.join(5)


def test_the_client_refuses_a_url_without_http():
    with pytest.raises(ValueError, match="http"):
        RemoteIndex("ftp://x", "idx")


def test_auth_end_to_end_over_sockets():
    app = create_app(index=MemoryIndex(), opts=SearchOptions(index_uri="memory://", api_secret="k3y"))
    srv = PooledHTTPServer("127.0.0.1", 0, app, threads=2)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    try:
        with pytest.raises(RuntimeError, match="401"):
            RemoteIndex(url, "idx").create_index(IsccIndex(name="idx"))
        assert RemoteIndex(url, "idx", api_key="k3y").create_index(IsccIndex(name="idx")).name == "idx"
        raw = socket.create_connection(("127.0.0.1", srv.server_port), timeout=5)
        raw.sendall(b"GET /indexes HTTP/1.1\r\nHost: x\r\nX-API-Key: s\xe9cret\r\nConnection: close\r\n\r\n")
        assert raw.recv(65536).startswith(b"HTTP/1.1 401")  # a non-ASCII key: 401, not 500
        raw.close()
    finally:
        srv.server_close()
        thread.join(5)


# ------------------------------------------------------------- serve()


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _serve_process(uri, call="serve()", **env):
    port = _free_port()
    proc_env = {k: v for k, v in os.environ.items() if not k.startswith("ISCC_SEARCH_")}
    proc_env.update(PYTHONPATH=str(REPO), ISCC_SEARCH_INDEX_URI=uri, ISCC_SEARCH_HOST="127.0.0.1",
                    ISCC_SEARCH_PORT=str(port), **env)
    proc = subprocess.Popen(
        [sys.executable, "-c", f"from iscc_search_tpu_torch.server.httpd import serve; {call}"],
        env=proc_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    url = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 90
    while True:
        try:
            urllib.request.urlopen(f"{url}/healthz", timeout=1)
            return proc, url
        except OSError:
            if proc.poll() is not None or time.monotonic() > deadline:
                proc.kill()
                raise AssertionError(proc.communicate()[0].decode()[-2000:])
            time.sleep(0.1)


@pytest.mark.parametrize("scheme", ["memory", "kv", "tpu"])
def test_serve_answers_and_drains_on_sigterm(scheme, tmp_path):
    """serve() in a subprocess: it answers, adds and searches; SIGTERM drains
    it, closes (flushes) the index and exits 0. A kv:// or tpu:// index
    reopened afterwards holds what was added. The tpu backend is asked for
    the CPU (its default is the card)."""
    uri = "memory://" if scheme == "memory" else f"{scheme}://{tmp_path / 'data'}"
    call = "serve(device='cpu')" if scheme == "tpu" else "serve()"
    # Every thread's stack on SIGUSR1: sent if SIGTERM does not end serve() in time.
    call = "import faulthandler, signal; faulthandler.register(signal.SIGUSR1, all_threads=True); " + call
    proc, url = _serve_process(uri, call, ISCC_SEARCH_HTTP_BACKEND="wsgiref" if scheme == "kv" else "pooled")
    assets = make_assets(5)
    try:
        client = RemoteIndex(url, "alpha")
        client.create_index(IsccIndex(name="alpha"))
        assert [r.status for r in client.add_assets("alpha", [IsccEntry(**a) for a in assets])] == ["created"] * 5
        res = client.search_assets("alpha", IsccQuery(iscc_code=assets[0]["iscc_code"]), limit=10)
        assert res.global_matches[0].iscc_id == assets[0]["iscc_id"]
        client.close()
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGUSR1)
            time.sleep(2)
            proc.kill()
            stacks = proc.communicate()[0].decode()
            raise AssertionError(f"serve() did not exit within 60 s of SIGTERM; every thread's stack:\n{stacks[-12000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = out.decode()
    assert proc.returncode == 0, text[-2000:]
    assert "SIGTERM received" in text and "closing index" in text
    if scheme == "kv":
        manager = KvIndexManager(tmp_path / "data")
        assert manager.get_index("alpha").assets == 5
        manager.close()
    elif scheme == "tpu":
        from iscc_search_tpu_torch.indexes.tpu import TpuIndexManager

        manager = TpuIndexManager(tmp_path / "data", device="cpu")
        got = manager.search_assets("alpha", IsccQuery(units=assets[3]["units"]), limit=10)
        assert assets[3]["iscc_id"] in [m.iscc_id for m in got.global_matches]
        manager.close()


@pytest.mark.parametrize("update,item", [
    ({"distributed": True}, "multi-host serving needs ISCC_SEARCH_MULTIHOST_INDEX and a tpu:// backend"),
    ({"distributed": True, "multihost_index": "data"}, "multi-host serving needs ISCC_SEARCH_MULTIHOST_INDEX and a tpu:// backend"),
])
def test_serve_refuses_what_is_not_ported(update, item, monkeypatch):
    """Outside a cluster ``serve()`` is the coordinator (rank 0): it refuses
    without ``multihost_index`` or a backend that can serve one, as the JAX
    package's does, before it binds."""
    for name in ("ISCC_SEARCH_COORDINATOR", "ISCC_SEARCH_NUM_HOSTS", "ISCC_SEARCH_HOST_ID"):
        monkeypatch.delenv(name, raising=False)
    opts = SearchOptions(index_uri="memory://", host="127.0.0.1", port=0).override(update)
    with pytest.raises(ValueError, match=item):
        httpd.serve(opts)


def test_serve_without_a_card_raises_on_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device opens")
    opts = SearchOptions(index_uri=f"tpu://{tmp_path}", host="127.0.0.1", port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        httpd.serve(opts)
    assert not any(tmp_path.iterdir())  # nothing opened, nothing written


def test_a_taken_port_closes_the_index(tmp_path, monkeypatch):
    """Binding first: a port in use raises OSError after closing the index."""
    closed = []
    real = KvIndexManager.close
    monkeypatch.setattr(KvIndexManager, "close", lambda self: (closed.append(1), real(self)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        sock.listen(1)
        opts = SearchOptions(index_uri=f"kv://{tmp_path}", host="127.0.0.1", port=sock.getsockname()[1])
        with pytest.raises(OSError):
            httpd.serve(opts)
    assert closed == [1]


def test_serve_opens_the_indexes_before_it_serves(tmp_path, monkeypatch):
    """``serve()`` opens every served index on its own thread before its
    server loop starts (the JAX server opens each on its first request)."""
    manager = KvIndexManager(tmp_path)
    manager.create_index(IsccIndex(name="alpha"))
    manager.close()
    events = []
    real = KvIndexManager.list_indexes
    monkeypatch.setattr(KvIndexManager, "list_indexes", lambda self: events.append(
        ("open", threading.current_thread(), [i.name for i in real(self)])))
    monkeypatch.setattr(httpd.ThreadingWSGIServer, "serve_forever",
                        lambda self, poll_interval=0.5: events.append("serve"))
    httpd.serve(SearchOptions(index_uri=f"kv://{tmp_path}", host="127.0.0.1", port=0, http_backend="wsgiref"))
    assert events == [("open", threading.current_thread(), ["alpha"]), "serve"]


def test_serve_over_wsgiref_in_a_thread():
    """The stdlib transport (``http_backend="wsgiref"``) serves the same app."""
    built = {}
    real = httpd.make_server

    def capture(*args, **kwargs):
        built["srv"] = real(*args, **kwargs)
        return built["srv"]

    opts = SearchOptions(index_uri="memory://", host="127.0.0.1", port=0, http_backend="wsgiref")
    httpd.make_server = capture
    try:
        thread = threading.Thread(target=httpd.serve, args=(opts,), daemon=True)
        thread.start()
        for _ in range(100):
            if "srv" in built:
                break
            time.sleep(0.05)
    finally:
        httpd.make_server = real
    srv = built["srv"]
    assert isinstance(srv, httpd.ThreadingWSGIServer)
    with httpx.Client(base_url=f"http://127.0.0.1:{srv.server_port}") as client:
        assert client.get("/healthz").json() == {"status": "ok"}
    srv.shutdown()
    thread.join(10)
    assert not thread.is_alive()
