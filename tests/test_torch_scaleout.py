"""The port's scale-out serving (``server/scaleout.py``, ``server/worker.py``)
against the JAX package's, on the CPU.

- The cases of ``tests/test_scaleout.py`` and the scale-out cases of
  ``tests/test_overload.py`` run against the port: each file is compiled
  with the JAX package's name read as the port's. The RPC cases run over
  the memory backend and over ``TpuIndexManager(..., device="cpu")``. The
  cases that open a ``tpu://`` index, stub ``get_index`` or ``serve`` with
  the JAX signatures, or check ``JAX_PLATFORMS`` in the workers'
  environment have port versions here: the port passes ``device`` on, and
  hides the card from its workers with ``CUDA_VISIBLE_DEVICES=""``.
- Two real worker processes and the engine of each package (the JAX one on
  JAX's CPU, the port's with ``device="cpu"``) answer the scripted request
  sequence of ``tests/test_torch_server.py`` with the same statuses and
  parsed bodies.
- A worker killed with SIGKILL is respawned while requests keep
  succeeding; SIGTERM ends the engine with exit 0 and the index flushed.
- A worker's environment hides the card, and its ``torch.cuda`` is never
  initialised.
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

import httpx
import pytest
import torch

from iscc_search_tpu_torch.indexes.memory import MemoryIndex
from iscc_search_tpu_torch.indexes.tpu import TpuIndexManager
from iscc_search_tpu_torch.options import SearchOptions
from iscc_search_tpu_torch.schema import IsccIndex, IsccQuery
from iscc_search_tpu_torch.server import httpd
from iscc_search_tpu_torch.server import scaleout as so
from iscc_search_tpu_torch.server.scaleout import EngineIPCServer, EngineRPCIndex
from tests.test_torch_server import SP, _run, _script, make_assets
from tests.test_torch_transport import REPO, _port_cases

SCALEOUT = [  # as they are; the rest have port versions below
    "test_rpc_full_protocol", "test_rpc_exception_relay", "test_rpc_unknown_method_rejected",
    "test_rpc_concurrent_threads", "test_rpc_reconnect_after_drop", "test_scaleout_end_to_end",
    "test_scaleout_worker_respawn", "test_worker_main_in_process", "test_worker_main_engine_unreachable",
    "test_serve_scaleout_port_in_use", "test_worker_module_imports", "test_recv_frame_oversized_rejected",
    "test_recv_frame_peer_closed_mid_frame", "test_recv_exact_spans_multiple_chunks",
    "test_rpc_search_accepts_plain_dict_query", "test_ping_times_out_without_engine",
    "test_serve_scaleout_rejects_port_zero",
]
OVERLOAD = [
    "test_engine_ipc_sheds_past_inflight_bound", "test_rpc_client_raises_overloaded",
    "test_rpc_breaker_fails_fast_after_rejection", "test_rpc_breaker_disabled",
]
globals().update(_port_cases("test_scaleout", SCALEOUT))
globals().update(_port_cases("test_overload", OVERLOAD))
_JaxCoreGuard = _port_cases("test_overload", [], fixtures=("TestCoreGuard",))["TestCoreGuard"]


class TestCoreGuard(_JaxCoreGuard):
    """The core guard's cases; the fall-back keeps the device."""

    def test_serve_scaleout_single_core_falls_back(self, monkeypatch, tmp_path):
        monkeypatch.delenv("ISCC_SEARCH_SCALEOUT_FORCE", raising=False)
        monkeypatch.setattr(so, "_runnable_cores", lambda: 1)
        called = []
        monkeypatch.setattr(httpd, "serve", lambda opts, device="cuda": called.append((opts, device)))
        so.serve_scaleout(SearchOptions(index_uri="memory://", workers=3, port=18123), device="cpu")
        assert called and called[0][0].workers == 1 and called[0][1] == "cpu"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Test files run in parallel processes: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["memory", "tpu"])
def ipc_pair(request, tmp_path):
    """The engine's IPC server over the port's memory backend or its tpu
    backend on the CPU, and a client (the JAX file's fixture, both kinds)."""
    index = MemoryIndex() if request.param == "memory" else TpuIndexManager(tmp_path / "idx", device="cpu")
    sock_path = str(tmp_path / "engine.sock")
    server = EngineIPCServer(index, sock_path)
    server.start()
    client = EngineRPCIndex(sock_path)
    assert client.ping()
    yield index, client
    client.close()
    server.close()
    index.close()


def test_the_loaded_cases_are_the_ports():
    cases = _port_cases("test_scaleout", ["test_worker_main_in_process"])
    body = cases["test_scaleout__worker_main_in_process"]
    assert body.__globals__["EngineIPCServer"] is EngineIPCServer and body.__globals__["MemoryIndex"] is MemoryIndex
    text = (REPO / "tests" / "test_scaleout.py").read_text()
    assert all(f"def {name}(" in text for name in SCALEOUT)
    assert _JaxCoreGuard.test_force_env_skips_guard.__globals__["__name__"].endswith("test_overload")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ in process


def test_serve_scaleout_in_process(tmp_path, monkeypatch):
    """serve_scaleout's loop with fake worker processes: the tpu index opened
    on the device asked for, spawn with the card hidden, one crash and its
    respawn, stop by the event, full cleanup."""
    spawned, opened = [], []

    class FakeProc:
        def __init__(self):
            self.pid = 4000 + len(spawned)
            self.terminated = False

        def poll(self):
            return 1 if self.pid == 4000 else None  # the first one crashes for good

        def terminate(self):
            self.terminated = True

        def wait(self, timeout=None):
            return 0

    def fake_popen(cmd, env=None):
        assert cmd[1:] == ["-m", "iscc_search_tpu_torch.server.worker"]
        assert env["CUDA_VISIBLE_DEVICES"] == ""
        assert str(REPO) in env["PYTHONPATH"].split(os.pathsep)
        cfg = json.loads(env["ISCC_SCALEOUT_CONFIG"])
        assert SearchOptions(**cfg["opts"]).workers == 2 and os.path.exists(cfg["socket_path"])
        spawned.append(FakeProc())
        return spawned[-1]

    from iscc_search_tpu_torch import options

    real = options.get_index
    monkeypatch.setattr(options, "get_index", lambda uri, device="cuda": opened.append(device) or real(uri, device))
    monkeypatch.setattr(so.subprocess, "Popen", fake_popen)
    stop = threading.Event()

    def stopper():
        deadline = time.time() + 15
        while len(spawned) < 3 and time.time() < deadline:  # 2 + 1 respawn
            time.sleep(0.05)
        stop.set()

    killer = threading.Thread(target=stopper, daemon=True)
    killer.start()
    opts = SearchOptions(index_uri=f"tpu://{tmp_path}/so", host="127.0.0.1", port=_free_port(), workers=2)
    so.serve_scaleout(opts, stop=stop, device="cpu")
    killer.join(5)
    assert opened == ["cpu"]
    assert len(spawned) >= 3
    assert all(p.terminated for p in spawned if p.poll() is None)


def test_serve_scaleout_opens_the_indexes_before_the_workers(tmp_path, monkeypatch):
    """serve_scaleout opens every served index before it spawns a worker
    (the JAX engine opens each on its first request, on its IPC thread)."""
    from iscc_search_tpu_torch.indexes.kv import KvIndexManager

    manager = KvIndexManager(tmp_path)
    manager.create_index(IsccIndex(name="alpha"))
    manager.close()
    events, stop = [], threading.Event()
    real = KvIndexManager.list_indexes
    monkeypatch.setattr(KvIndexManager, "list_indexes", lambda self: events.append(
        ("open", [i.name for i in real(self)])) or real(self))

    class FakeProc:
        pid = 4000

        def poll(self):
            return None

        def terminate(self):
            pass

        def wait(self, timeout=None):
            return 0

    def fake_popen(cmd, env=None):
        events.append("spawn")
        stop.set()
        return FakeProc()

    monkeypatch.setenv("ISCC_SEARCH_SCALEOUT_FORCE", "1")
    monkeypatch.setattr(so.subprocess, "Popen", fake_popen)
    opts = SearchOptions(index_uri=f"kv://{tmp_path}", host="127.0.0.1", port=_free_port(), workers=1)
    so.serve_scaleout(opts, stop=stop, device="cpu")
    assert events == [("open", ["alpha"]), "spawn"]


def test_serve_scaleout_on_the_default_device_needs_a_card(tmp_path, monkeypatch):
    """No fall-back to the CPU: without a card the default device raises
    before any worker is spawned."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device opens")
    monkeypatch.setattr(so.subprocess, "Popen", lambda *a, **k: pytest.fail("a worker was spawned"))
    opts = SearchOptions(index_uri=f"tpu://{tmp_path}/so", host="127.0.0.1", port=_free_port(), workers=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        so.serve_scaleout(opts)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_httpd_serve_dispatches_to_scaleout(monkeypatch, device):
    """httpd.serve() routes workers > 1 to serve_scaleout with its device,
    without opening the index or binding anything itself."""
    from iscc_search_tpu_torch import options

    called = []
    monkeypatch.setattr(so, "serve_scaleout", lambda opts, stop=None, device="cuda": called.append((opts, device)))
    monkeypatch.setattr(options, "get_index", lambda *a, **k: pytest.fail("engine index must not open here"))
    httpd.serve(SearchOptions(index_uri="memory://", workers=3), device=device)
    assert [(o.workers, d) for o, d in called] == [(3, device)]


@pytest.mark.parametrize("backend", ["pooled", "wsgiref"])
def test_httpd_serve_bind_failure_closes_index(monkeypatch, backend):
    """A failed public-port bind closes the just-opened index and raises."""
    closed = []

    class FakeIndex:
        def close(self):
            closed.append(True)

    monkeypatch.setattr("iscc_search_tpu_torch.options.get_index", lambda uri, device="cuda": FakeIndex())
    with socket.socket() as blocker:
        blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        blocker.bind(("127.0.0.1", 0))
        blocker.listen(1)
        opts = SearchOptions(index_uri="memory://", host="127.0.0.1", port=blocker.getsockname()[1],
                             http_backend=backend)
        with pytest.raises(OSError):
            httpd.serve(opts)
    assert closed == [True]


def test_validation_errors_cross_the_rpc_as_the_jax_engine_relays_them(ipc_pair, tmp_path):
    """A query the engine's ``IsccQuery`` refuses: both engines reply with
    the class name ``ValidationError`` (pydantic's and the port's), which
    is not in the relay table, so both clients raise ``RuntimeError``."""
    from iscc_search_tpu.indexes.memory import MemoryIndex as JaxMemoryIndex
    from iscc_search_tpu.schema import IsccIndex as JaxIndex
    from iscc_search_tpu.server import scaleout as jax_so

    frame = ("search_raw", "val", {"iscc_code": "ISCC:nope"}, 10)
    jax_path = str(tmp_path / "jax.sock")
    jax_engine = jax_so.EngineIPCServer(JaxMemoryIndex(), jax_path)
    jax_engine.start()
    try:
        jax_client = jax_so.EngineRPCIndex(jax_path)
        jax_client.create_index(JaxIndex(name="val"))
        with pytest.raises(RuntimeError, match="validation error for IsccQuery") as want:
            jax_client._roundtrip(frame)
        jax_client.close()
    finally:
        jax_engine.close()
    _, client = ipc_pair
    client.create_index(IsccIndex(name="val"))
    with pytest.raises(RuntimeError, match="validation error for IsccQuery") as got:
        client._roundtrip(frame)
    assert type(got.value) is type(want.value) is RuntimeError
    assert str(got.value).splitlines()[:2] == str(want.value).splitlines()[:2]
    assert so._EXC_TYPES.keys() == jax_so._EXC_TYPES.keys()


# ----------------------------------------------------------- processes


PORT_MAIN = """
import sys, torch
torch.set_num_threads(1)
from iscc_search_tpu_torch.options import SearchOptions
from iscc_search_tpu_torch.server.scaleout import serve_scaleout

serve_scaleout(SearchOptions(index_uri=sys.argv[2], host="127.0.0.1", port=int(sys.argv[1]), workers=2,
                             http_threads=4), device="cpu")
"""
JAX_MAIN = """
import sys
from iscc_search_tpu.options import SearchOptions
from iscc_search_tpu.server.scaleout import serve_scaleout

serve_scaleout(SearchOptions(index_uri=sys.argv[2], host="127.0.0.1", port=int(sys.argv[1]), workers=2,
                             http_threads=4))
"""


def _start(main, uri, log):
    """The engine script ``main`` in a subprocess on a free port, its output
    in ``log``; returns (process, base URL) once /healthz answers."""
    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu", ISCC_SEARCH_SCALEOUT_FORCE="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with open(log, "wb") as out:
        proc = subprocess.Popen([sys.executable, "-c", main, str(port), uri], env=env, stdout=out,
                                stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 120
    while True:
        try:
            with urllib.request.urlopen(f"{base}/healthz", timeout=2) as res:
                if json.load(res)["status"] == "ok":
                    return proc, base
        except OSError:
            if proc.poll() is not None or time.monotonic() > deadline:
                proc.kill()
                raise AssertionError(open(log).read()[-3000:])
            time.sleep(0.2)


def _listeners(port):
    """Sockets listening on TCP ``port`` (one per SO_REUSEPORT worker)."""
    count = 0
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        for line in open(table).read().splitlines()[1:]:
            fields = line.split()
            count += fields[3] == "0A" and int(fields[1].rsplit(":", 1)[1], 16) == port
    return count


def _workers(pid):
    return subprocess.run(["pgrep", "-P", str(pid)], capture_output=True, text=True).stdout.split()


def _stop(proc, log):
    """SIGTERM the engine; its exit code."""
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError("the engine did not exit on SIGTERM: " + open(log).read()[-3000:])


def test_both_scaleouts_answer_the_scripted_sequence_alike(tmp_path):
    """Two real workers and the engine of each package, tpu:// on the CPU:
    the sequence of tests/test_torch_server.py (index CRUD, assets, every
    search kind at limit 10 and 100, get, the error codes) gives the same
    statuses and parsed bodies from both."""
    assets = make_assets()
    jax_proc, jax_base = _start(JAX_MAIN, f"tpu://{tmp_path / 'jax'}", tmp_path / "jax.log")
    try:
        port_proc, port_base = _start(PORT_MAIN, f"tpu://{tmp_path / 'port'}", tmp_path / "port.log")
        try:
            assert len(_workers(jax_proc.pid)) == len(_workers(port_proc.pid)) == 2
            with httpx.Client(base_url=jax_base, timeout=120) as jc, httpx.Client(base_url=port_base,
                                                                                  timeout=120) as pc:
                statuses = _run(jc, pc, _script(assets))
                sp = {SP: [s["simprint"] for s in assets[0]["simprints"][SP]]}
                body = pc.post("/indexes/alpha/search?limit=100", json={"units": assets[0]["units"],
                                                                         "simprints": sp}).json()
        finally:
            port_code = _stop(port_proc, tmp_path / "port.log")
    finally:
        jax_code = _stop(jax_proc, tmp_path / "jax.log")
    assert (jax_code, port_code) == (0, 0)
    assert {200, 201, 204, 400, 404, 405, 409, 422} <= set(statuses) and 500 not in statuses
    assert [m["iscc_id"] for m in body["global_matches"][:2]] == [assets[0]["iscc_id"], assets[1]["iscc_id"]]
    assert assets[0]["iscc_id"] in [m["iscc_id"] for m in body["chunk_matches"]]


def test_a_killed_worker_is_respawned_and_sigterm_flushes(tmp_path):
    """SIGKILL one of two workers: it is respawned and requests keep
    succeeding; SIGTERM to the engine exits 0, and the index reopened on the
    CPU holds what was added over HTTP."""
    assets = make_assets(6)
    proc, base = _start(PORT_MAIN, f"tpu://{tmp_path / 'data'}", tmp_path / "engine.log")
    try:
        with httpx.Client(base_url=base, timeout=120) as client:
            assert client.post("/indexes", json={"name": "so"}).status_code == 201
            assert client.post("/indexes/so/assets", json=assets[:3]).status_code == 201
        children = _workers(proc.pid)
        assert len(children) == 2, children
        os.kill(int(children[0]), signal.SIGKILL)
        ok = 0
        for i in range(20):  # fresh connections: SO_REUSEPORT spreads them over the workers
            try:
                with urllib.request.urlopen(f"{base}/indexes/so", timeout=5) as res:
                    ok += json.load(res)["assets"] == 3
            except OSError:
                time.sleep(0.1)
        assert ok >= 15
        deadline = time.monotonic() + 60
        while len(_workers(proc.pid)) != 2 or children[0] in _workers(proc.pid):
            assert time.monotonic() < deadline, _workers(proc.pid)
            time.sleep(0.2)
        with httpx.Client(base_url=base, timeout=120) as client:
            assert client.post("/indexes/so/assets", json=assets[3:]).status_code == 201
    finally:
        code = _stop(proc, tmp_path / "engine.log")
    assert code == 0
    assert "respawning" in open(tmp_path / "engine.log").read()
    manager = TpuIndexManager(tmp_path / "data", device="cpu")
    try:
        assert manager.get_index("so").assets == 6
        got = manager.search_assets("so", IsccQuery(units=assets[4]["units"]), limit=10)
        assert assets[4]["iscc_id"] in [m.iscc_id for m in got.global_matches]
    finally:
        manager.close()


PROBE = """
import atexit, os, torch
atexit.register(lambda: print("probe", os.getpid(), repr(os.environ["CUDA_VISIBLE_DEVICES"]),
                              torch.cuda.is_initialized(), torch.cuda.device_count(), flush=True))
from iscc_search_tpu_torch.server.scaleout import worker_main
worker_main()
"""


def test_a_worker_hides_the_card(tmp_path, monkeypatch):
    """serve_scaleout in this process (tpu:// on the CPU) spawns its real
    workers with a probe that reports, at the worker's exit, its
    environment and whether torch.cuda was initialised: never, and no device
    is visible. The requests went through both workers' RPC."""
    real_popen = subprocess.Popen
    procs = []

    def probed_popen(cmd, env=None):
        assert cmd[1:] == ["-m", "iscc_search_tpu_torch.server.worker"]
        procs.append(real_popen([cmd[0], "-c", PROBE], env=env, stdout=subprocess.PIPE, text=True))
        return procs[-1]

    monkeypatch.setattr(so.subprocess, "Popen", probed_popen)
    stop = threading.Event()
    port = _free_port()
    opts = SearchOptions(index_uri=f"tpu://{tmp_path / 'data'}", host="127.0.0.1", port=port, workers=2,
                         http_threads=2)
    engine = threading.Thread(target=so.serve_scaleout, args=(opts,), kwargs={"stop": stop, "device": "cpu"})
    engine.start()
    assets = make_assets(4)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2):
                    break
            except OSError:
                assert time.monotonic() < deadline and engine.is_alive()
                time.sleep(0.2)
        with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=60) as client:
            assert client.post("/indexes", json={"name": "hide"}).status_code == 201
            assert client.post("/indexes/hide/assets", json=assets).status_code == 201
        for a in assets:  # new connections: both workers serve
            with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=60) as client:
                r = client.post("/indexes/hide/search", json={"units": a["units"]})
                assert r.json()["global_matches"][0]["iscc_id"] == a["iscc_id"]
        while _listeners(port) < 2:  # both workers up (a worker stopped while it starts prints nothing)
            assert time.monotonic() < deadline
            time.sleep(0.2)
        time.sleep(1.0)  # past each worker's SIGTERM handler, installed right after its listen
    finally:
        stop.set()
        engine.join(60)
    assert not engine.is_alive() and len(procs) == 2
    for proc in procs:
        out = proc.stdout.read()
        assert f"probe {proc.pid} '' False 0" in out, out
