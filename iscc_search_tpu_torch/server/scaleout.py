"""
Multi-process scale-out serving: SO_REUSEPORT HTTP workers + one engine
(copy of ``iscc_search_tpu/server/scaleout.py``).

One Python process tops out near a single core for the per-request work
(HTTP parse, JSON, validation) no matter how many threads it runs. This
module splits serving across processes:

- The **engine process** (the ``serve`` parent) keeps exclusive ownership of
  the index (the engines' tensors on the card, the segment files, the
  store's single-writer contract) and exposes the full IsccIndexProtocol
  over a unix-domain socket (length-prefixed pickle frames between our own
  processes; the socket lives in a 0700 runtime dir).
- **Worker processes** each bind the public port with SO_REUSEPORT (the
  kernel load-balances accepts), run the unchanged WSGI app
  (server/app.py) on the pooled HTTP/1.1 transport, and satisfy every
  index call through EngineRPCIndex. HTTP parse, JSON and validation
  spread across worker processes; only the engine's search runs in the
  process that holds the card.

The port differs in ``serve_scaleout`` alone: it opens the index on the
device the caller names (the card by default), hands the workers their
options as ``dataclasses.asdict`` (the port's options are a dataclass), and
spawns them with ``CUDA_VISIBLE_DEVICES=""``: a worker imports torch (the
options module imports the engine) but never sees the card, so it makes no
CUDA context beside the engine's. It opens every served index before the
workers start, where the JAX package's opens each on its first request.
"""

from __future__ import annotations

import json
import os
import pickle
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

from iscc_search_tpu_torch.utils import OverloadedError, get_logger

logger = get_logger(__name__)

_HEADER = struct.Struct(">I")
_MAX_FRAME = 1 << 30

# Exception types that cross the RPC boundary by name (the protocol's
# documented exception contract, protocols/index.py)
_EXC_TYPES = {
    "FileNotFoundError": FileNotFoundError,
    "FileExistsError": FileExistsError,
    "ValueError": ValueError,
    "KeyError": KeyError,
    "NotADirectoryError": NotADirectoryError,
    "PermissionError": PermissionError,
    "RuntimeError": RuntimeError,
    "OverloadedError": OverloadedError,
}


def _send_frame(sock, obj):
    # type: (socket.socket, object) -> None
    payload = pickle.dumps(obj, protocol=5)
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def _recv_exact(sock, n):
    # type: (socket.socket, int) -> bytes | None
    parts = []
    while n:
        data = sock.recv(min(n, 1 << 20))
        if not data:
            return None
        parts.append(data)
        n -= len(data)
    return b"".join(parts)


def _recv_frame(sock):
    # type: (socket.socket) -> object
    head = _recv_exact(sock, _HEADER.size)
    if head is None:
        raise ConnectionError("peer closed")
    (length,) = _HEADER.unpack(head)
    if length > _MAX_FRAME:
        raise ConnectionError("oversized frame")
    payload = _recv_exact(sock, length)
    if payload is None:
        raise ConnectionError("peer closed mid-frame")
    return pickle.loads(payload)


# ------------------------------------------------------------------ engine


class EngineIPCServer:
    """Serves the engine index over a unix socket to worker processes."""

    def __init__(self, index, socket_path, max_inflight=64):
        # type: (..., str, int) -> None
        self.index = index
        self.socket_path = socket_path
        # Engine-side overload guard: searches past this in-flight bound get
        # an immediate OverloadedError reply (workers map it to 503 +
        # Retry-After) instead of queueing behind the device. Mutations and
        # admin calls are never shed — they are rare and must not be dropped.
        self._search_slots = threading.BoundedSemaphore(max_inflight)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(socket_path)
        self._sock.listen(64)
        self._sock.settimeout(0.5)
        self._stop = threading.Event()
        self._threads = []  # type: list[threading.Thread]
        self._accept = threading.Thread(target=self._accept_loop, name="engine-ipc-accept", daemon=True)

    def start(self):
        # type: () -> None
        self._accept.start()

    def close(self):
        # type: () -> None
        self._stop.set()
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass
        if self._accept.is_alive():
            self._accept.join(2)
        for t in self._threads:
            t.join(2)
        try:
            os.unlink(self.socket_path)
        except OSError:  # pragma: no cover
            pass

    def _accept_loop(self):
        # type: () -> None
        # `while True` + explicit check (not a while-condition): the compiled
        # loop-bottom test copy's "stop observed between accept-return and
        # re-check" outcome is pure thread timing (see pooled._accept_loop).
        while True:
            if self._stop.is_set():
                return
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            t.start()
            # Prune finished handlers so reconnect churn can't grow the list
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve_conn(self, conn):
        # type: (socket.socket) -> None
        from iscc_search_tpu_torch.schema import IsccQuery

        try:
            while not self._stop.is_set():
                try:
                    frame = _recv_frame(conn)
                except ConnectionError:
                    return
                try:
                    op = frame[0]
                    if op == "search_raw":
                        # Hot path: plain dict in, dumped dict out — no
                        # pydantic on the worker side beyond input checks.
                        _, name, qdict, limit = frame
                        if not self._search_slots.acquire(blocking=False):
                            raise OverloadedError("engine search capacity exhausted")
                        try:
                            result = self.index.search_assets(name, IsccQuery(**qdict), limit)
                        finally:
                            self._search_slots.release()
                        reply = ("ok", result.model_dump(mode="json", exclude_none=True))
                    elif op == "call":
                        _, method, args = frame
                        if method not in (
                            "list_indexes",
                            "create_index",
                            "get_index",
                            "delete_index",
                            "add_assets",
                            "get_asset",
                            "search_assets",
                        ):
                            raise ValueError(f"unknown RPC method: {method}")
                        reply = ("ok", getattr(self.index, method)(*args))
                    elif op == "ping":
                        reply = ("ok", "pong")
                    else:
                        raise ValueError(f"unknown RPC op: {op}")
                except Exception as exc:  # noqa: BLE001 - full exception relay
                    reply = ("err", type(exc).__name__, str(exc))
                try:
                    _send_frame(conn, reply)
                except OSError:
                    return
        finally:
            try:
                conn.close()
            except OSError:  # pragma: no cover
                pass


# ------------------------------------------------------------------ worker


class _DumpedResult:
    """Search result already dumped by the engine; quacks like the model."""

    __slots__ = ("_data",)

    def __init__(self, data):
        self._data = data

    def model_dump(self, **_kw):
        return self._data

    def model_dump_json(self, **_kw):
        # Already dumped with exclude_none on the engine side
        return json.dumps(self._data)


class EngineRPCIndex:
    """IsccIndexProtocol client over the engine's unix socket.

    One connection per calling thread (thread-local), created lazily and
    reconnected on error — the pooled HTTP server runs a fixed thread pool,
    so the connection count is bounded by worker threads.

    Searches carry a worker-side OVERLOAD BREAKER: when the engine rejects a
    search (OverloadedError — its in-flight bound is full), subsequent
    searches for ``breaker_s`` fail fast locally instead of paying the
    pickle + socket round trip only to be rejected again: under deep
    overload that round trip is where goodput goes, the shared core
    rejecting requests one RPC at a time. The window is
    refreshed by every fresh engine rejection, so the breaker clears within
    ``breaker_s`` of the engine having capacity again. Mutations and admin
    calls never break — they are rare and must not be dropped.
    """

    def __init__(self, socket_path, breaker_s=0.05):
        # type: (str, float) -> None
        self.socket_path = socket_path
        self.breaker_s = breaker_s
        self._overloaded_until = 0.0  # monotonic; benign data race (float)
        self._local = threading.local()

    @property
    def overloaded(self):
        # type: () -> bool
        """True while the overload breaker window is active (see class doc).

        Cheap enough for the HTTP admission path: workers shed BEFORE
        parsing a request the engine would reject anyway."""
        return time.monotonic() < self._overloaded_until

    def _conn(self):
        # type: () -> socket.socket
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            conn.connect(self.socket_path)
            self._local.conn = conn
        return conn

    def _roundtrip(self, frame):
        # type: (tuple) -> object
        """One RPC round trip with retry ONLY on failed send.

        A failed send means the engine never received a complete frame (a
        torn frame makes its reader drop the connection without executing),
        so resending is safe. A failure AFTER the send must NOT resend:
        the engine may have executed a non-idempotent mutation
        (create_index, add_assets) whose reply was lost — re-executing
        would double-apply and surface phantom 409s.
        """
        try:
            conn = self._conn()
            _send_frame(conn, frame)
        except (ConnectionError, OSError):
            # Engine restarted its listener / stale fd: reconnect and resend
            self._drop_conn()
            conn = self._conn()
            _send_frame(conn, frame)
        try:
            reply = _recv_frame(conn)
        except (ConnectionError, OSError):
            self._drop_conn()
            raise ConnectionError("engine connection lost awaiting reply (request may have executed)")
        if reply[0] == "ok":
            return reply[1]
        _, exc_name, message = reply
        raise _EXC_TYPES.get(exc_name, RuntimeError)(message)

    def _drop_conn(self):
        # type: () -> None
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:  # pragma: no cover
                pass
            self._local.conn = None

    def ping(self, timeout=5.0):
        # type: (float) -> bool
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                return self._roundtrip(("ping",)) == "pong"
            except (ConnectionError, OSError, FileNotFoundError):
                time.sleep(0.05)
        return False

    # ------------------------------------------------- protocol methods

    def list_indexes(self):
        return self._roundtrip(("call", "list_indexes", ()))

    def create_index(self, index):
        return self._roundtrip(("call", "create_index", (index,)))

    def get_index(self, name):
        return self._roundtrip(("call", "get_index", (name,)))

    def delete_index(self, name):
        return self._roundtrip(("call", "delete_index", (name,)))

    def add_assets(self, index_name, assets):
        return self._roundtrip(("call", "add_assets", (index_name, assets)))

    def get_asset(self, index_name, iscc_id):
        return self._roundtrip(("call", "get_asset", (index_name, iscc_id)))

    def search_assets(self, index_name, query, limit=100):
        if self.breaker_s and time.monotonic() < self._overloaded_until:
            raise OverloadedError("engine search capacity exhausted (breaker)")
        qdict = query.model_dump(exclude_none=True) if hasattr(query, "model_dump") else dict(query)
        try:
            return _DumpedResult(self._roundtrip(("search_raw", index_name, qdict, limit)))
        except OverloadedError:
            if self.breaker_s:
                self._overloaded_until = time.monotonic() + self.breaker_s
            raise

    def close(self):
        # Worker-local: never forwards — the engine owns index lifetime.
        self._drop_conn()


def reuseport_socket(host, port, backlog=512):
    # type: (str, int, int) -> socket.socket
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen(backlog)
    return sock


def worker_main(argv=None):
    # type: (list | None) -> None
    """Entry point for one HTTP worker process (python -m ...server.worker)."""
    from iscc_search_tpu_torch.options import SearchOptions
    from iscc_search_tpu_torch.server.app import create_app
    from iscc_search_tpu_torch.server.pooled import PooledHTTPServer
    from iscc_search_tpu_torch.utils import configure_logging

    # Kernel-delivered SIGTERM if the engine dies without cleanup (e.g.
    # SIGKILL): workers must never outlive the engine as orphans holding
    # the public port. Set here in the exec'd child (single-threaded at
    # this point) — a parent-side preexec_fn would dlopen between fork and
    # exec in a multithreaded process.
    try:  # pragma: no cover - exercised by the subprocess e2e tests
        import ctypes

        PR_SET_PDEATHSIG = 1
        ctypes.CDLL(None).prctl(PR_SET_PDEATHSIG, signal.SIGTERM)
        if os.getppid() == 1:
            raise SystemExit("engine died before worker start")
    except (OSError, AttributeError):  # pragma: no cover - non-Linux
        # AttributeError: libc without prctl (macOS/BSD) — ctypes raises it,
        # not OSError, so catching OSError alone would crash-loop the worker.
        pass

    cfg = json.loads(os.environ["ISCC_SCALEOUT_CONFIG"])
    opts = SearchOptions(**cfg["opts"])
    configure_logging(level=opts.log_level)
    rpc = EngineRPCIndex(cfg["socket_path"], breaker_s=opts.scaleout_breaker_ms / 1000.0)
    if not rpc.ping(timeout=30.0):
        raise SystemExit("engine IPC not reachable")
    app = create_app(index=rpc, opts=opts)
    sock = reuseport_socket(opts.host, opts.port)
    srv = PooledHTTPServer(
        opts.host,
        opts.port,
        app,
        threads=opts.http_threads,
        sock=sock,
        max_pending=opts.http_max_pending,
        queue_deadline=opts.http_queue_deadline_ms / 1000.0,
        # Admission-time shed while the engine breaker is active: a request
        # the engine would reject must not cost a parse + RPC round trip.
        overload_probe=(lambda: rpc.overloaded) if opts.scaleout_breaker_ms else None,
    )

    def _term(_signum, _frame):  # pragma: no cover - signal timing
        threading.Thread(target=srv.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:  # pragma: no cover - non-main thread (tests/embedding)
        pass
    logger.info(f"Worker {os.getpid()} serving on {opts.host}:{opts.port}")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        srv.server_close()


# ------------------------------------------------------------- orchestrator


def _runnable_cores():
    # type: () -> int
    """Cores THIS process may run on (cgroup/affinity aware, not host total)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover - non-Linux
        return os.cpu_count() or 1


def _apply_core_guard(opts):
    # type: (...) -> object | None
    """
    Enforce the >= workers+1 core constraint (the engine process is the +1).

    On fewer cores the workers time-slice against the engine and saturate
    below single-process pooled serving (the JAX package measured it on a
    constrained host; not measured on the card's host). Returns opts with
    the worker count shrunk to fit, or None when
    even one worker cannot get a dedicated core (caller falls back to
    single-process serving). ISCC_SEARCH_SCALEOUT_FORCE=1 skips the guard.
    """
    if os.environ.get("ISCC_SEARCH_SCALEOUT_FORCE") == "1":
        return opts
    cores = _runnable_cores()
    requested = max(1, int(opts.workers or 1))
    allowed = cores - 1
    if allowed < 1:
        logger.warning(
            f"scale-out requested but only {cores} core(s) are available "
            "(needs >= workers+1): falling back to single-process pooled serving"
        )
        return None
    if requested > allowed:
        logger.warning(
            f"scale-out workers shrunk {requested} -> {allowed}: only {cores} core(s) "
            "available (needs >= workers+1; set ISCC_SEARCH_SCALEOUT_FORCE=1 to override)"
        )
        return opts.override({"workers": allowed})
    return opts


def _supervise(procs, spawn, stop, poll_wait=0.5, stable_after=10.0):
    # type: (list, ..., threading.Event, float, float) -> None
    """Worker respawn loop with per-slot exponential backoff.

    A persistent startup failure (bad config, import error) must not become
    a 2 Hz fork-and-crash loop — back off to 30 s and say so clearly; a slot
    that stays up for ``stable_after`` seconds resets to the base backoff.
    """
    n_workers = len(procs)
    backoff = [0.5] * n_workers
    next_spawn = [0.0] * n_workers
    while not stop.is_set():
        now = time.monotonic()
        for i, proc in enumerate(procs):
            code = proc.poll()
            if code is not None and not stop.is_set() and now >= next_spawn[i]:
                level = logger.warning if backoff[i] < 8 else logger.error
                level(
                    f"Worker {proc.pid} exited with {code}; respawning "
                    f"(next backoff {backoff[i]:.1f}s — repeated exits indicate a crash loop)"
                )
                procs[i] = spawn()
                next_spawn[i] = now + backoff[i]
                backoff[i] = min(backoff[i] * 2, 30.0)
            elif code is None and now >= next_spawn[i] + stable_after:
                backoff[i] = 0.5  # stable for a while: reset the backoff
        stop.wait(poll_wait)


def serve_scaleout(opts, stop=None, device="cuda"):
    # type: (..., threading.Event | None, str) -> None
    """Run the engine + N HTTP worker processes until interrupted.

    :param stop: optional externally-controlled stop event (tests); SIGTERM
        sets it either way.
    :param device: Device of the ``tpu://`` backend's engines in this
        process (the card unless the caller asks for ``"cpu"``).
    """
    from iscc_search_tpu_torch.options import get_index
    from iscc_search_tpu_torch.utils import configure_logging

    configure_logging(level=opts.log_level)

    guarded = _apply_core_guard(opts)
    if guarded is None:
        # Even one worker cannot get a dedicated core: single-process pooled
        # serving beats a time-sliced scale-out (see _apply_core_guard).
        from iscc_search_tpu_torch.server import httpd

        httpd.serve(opts.override({"workers": 1}), device=device)
        return
    opts = guarded

    if not opts.port:
        # Port 0 is valid single-process (the bound port is discoverable)
        # but meaningless for scale-out: each SO_REUSEPORT worker would bind
        # its OWN ephemeral port (the kernel only balances sockets bound to
        # the SAME port) and no single endpoint would exist.
        raise ValueError("scale-out serving requires an explicit port (got 0)")

    # Validate the public port is free BEFORE opening the index, and WITHOUT
    # SO_REUSEPORT: a reuseport probe would bind happily next to another
    # running instance — two engines would then open the same store
    # (dual-writer corruption) and split traffic between divergent views.
    # A plain bind fails EADDRINUSE against both server flavors.
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        # SO_REUSEADDR (not REUSEPORT): restart during TIME_WAIT works, but
        # a live listener still fails EADDRINUSE.
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        probe.bind((opts.host, opts.port))
    finally:
        probe.close()

    index = get_index(opts.index_uri, device=device)
    try:
        # Open every served index here, before the workers start, as serve()
        # does: opened lazily by the first request on the engine's IPC
        # thread, the host store's native open took ~13x as long (PERF.md
        # section 7) and could outlast a client's timeout.
        index.list_indexes()
        run_dir = tempfile.mkdtemp(prefix="iscc-scaleout-")
        os.chmod(run_dir, 0o700)
        socket_path = os.path.join(run_dir, "engine.sock")
        ipc = EngineIPCServer(index, socket_path)
    except BaseException:
        # Same cleanup contract as httpd.serve's failed bind: the index must
        # not leak unflushed when startup dies between open and serving.
        index.close()
        raise
    # From here on, ipc/index cleanup rides the big try/finally below —
    # an exception anywhere between ipc creation and the worker loop (cfg
    # serialization, env assembly, a stray KeyboardInterrupt) must not leak
    # the unflushed index or the IPC socket dir.
    procs = []  # type: list[subprocess.Popen]
    previous = None
    try:
        ipc.start()

        import dataclasses

        cfg = json.dumps({"opts": dataclasses.asdict(opts), "socket_path": socket_path})
        # Workers never touch a device index (all index calls go over IPC),
        # but they import torch (options imports the engine): hide the card
        # from them, so no worker makes a CUDA context of its own on
        # the engine's card. The package's location rides PYTHONPATH so `-m`
        # works from any cwd (and for non-installed source checkouts).
        import iscc_search_tpu_torch

        pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(iscc_search_tpu_torch.__file__)))
        pythonpath = pkg_parent + os.pathsep + os.environ.get("PYTHONPATH", "")
        env = dict(
            os.environ, ISCC_SCALEOUT_CONFIG=cfg, CUDA_VISIBLE_DEVICES="", PYTHONPATH=pythonpath.rstrip(os.pathsep)
        )
        n_workers = max(1, int(opts.workers or 1))

        def spawn():
            # PDEATHSIG is set by the child itself (worker_main, first thing):
            # a preexec_fn doing ctypes/dlopen between fork and exec in this
            # multithreaded parent can deadlock the child on the allocator or
            # loader lock (subprocess docs warn preexec_fn is thread-unsafe).
            return subprocess.Popen([sys.executable, "-m", "iscc_search_tpu_torch.server.worker"], env=env)

        stop = stop or threading.Event()

        def _term(_signum, _frame):  # pragma: no cover - signal timing
            logger.info("SIGTERM received: stopping workers, saving state...")
            stop.set()

        try:
            previous = signal.signal(signal.SIGTERM, _term)
        except ValueError:  # pragma: no cover - non-main thread
            pass

        for _ in range(n_workers):
            procs.append(spawn())
        logger.info(
            f"Scale-out serving on http://{opts.host}:{opts.port} "
            f"({n_workers} workers x {opts.http_threads} threads, backend: {opts.index_uri})"
        )
        _supervise(procs, spawn, stop)
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        for proc in procs:
            proc.terminate()
        deadline = time.monotonic() + 30
        for proc in procs:
            try:
                proc.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:  # pragma: no cover
                proc.kill()
        ipc.close()
        index.close()
        try:
            os.rmdir(run_dir)
        except OSError:  # pragma: no cover
            pass
        if previous is not None:
            try:
                signal.signal(signal.SIGTERM, previous)
            except ValueError:  # pragma: no cover
                pass
