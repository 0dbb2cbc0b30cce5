"""The port's multi-host control plane (``parallel/service.py``) on the CPU.

- The cases of ``tests/test_service.py`` and the control-channel cases of
  ``tests/test_branch_cov10.py`` compiled against the port
  (:func:`port_functions`): the JAX package's name read as the port's, each
  ``TpuIndex(...)`` and ``TpuIndexManager(...)`` given ``device="cpu"``.
  None is left out.
- The wire between the packages: a JAX ``MultihostService`` coordinator
  drives a port follower applying each op to a port CPU engine, and a port
  coordinator drives a JAX follower applying it to a JAX engine. The same
  ops (``add`` with an update and a batch duplicate, ``add_packed``,
  ``remove``, ``search``, ``check``) go through each coordinator's hooked
  engine; all four engines end in equal host state (``_keys``, ``_codes``,
  ``_nlanes``, ``_valid``, ``_rows``, ``_live``), and the searches answer
  alike.
"""

from __future__ import annotations

import ast
import re
import threading
from pathlib import Path

import numpy as np
import pytest

from iscc_search_tpu.engine.device_index import DeviceNphdIndex as JaxNphdIndex
from iscc_search_tpu.parallel.service import MultihostService as JaxService
from iscc_search_tpu_torch.engine.device_index import DeviceNphdIndex
from iscc_search_tpu_torch.parallel import service
from iscc_search_tpu_torch.parallel.service import MultihostService

REPO = Path(__file__).resolve().parents[1]
_CPU_ENTRY = re.compile(r"\b(TpuIndex(?:Manager)?)\(([^()]*)\)")
_JAX_PACKAGE = re.compile(r"\biscc_search_tpu\b")


def port_functions(name, keep, replace=()):
    """The top-level functions, classes and fixtures ``keep`` of
    ``tests/<name>.py`` (with the helpers they call) compiled against the
    port: the JAX package's name read as the port's, every
    ``TpuIndex(...)`` / ``TpuIndexManager(...)`` call given
    ``device="cpu"``. Each ``(text, new)`` of ``replace`` is put in first,
    in every place (``text`` occurs at least once). Module imports are run
    one by one; one whose module the port lacks is left out. Tests are
    renamed ``test_<name>__<test>``, classes ``Test<Name>__<class>``."""
    path = REPO / "tests" / f"{name}.py"
    source = path.read_text()
    for text, new in replace:
        assert text in source, text
        source = source.replace(text, new)
    source = _CPU_ENTRY.sub(lambda m: f'{m[1]}({m[2]}, device="cpu")', source)
    source = _JAX_PACKAGE.sub("iscc_search_tpu_torch", source)
    namespace = {"__name__": f"{__name__}.{name}", "__file__": str(path)}
    found = set()
    for node in ast.parse(source, str(path)).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            try:
                exec(compile(ast.Module([node], []), str(path), "exec"), namespace)
            except ImportError:
                pass
        elif getattr(node, "name", None) in keep:
            exec(compile(ast.Module([node], []), str(path), "exec"), namespace)
            found.add(node.name)
    assert found == set(keep), set(keep) - found
    out = {}
    for k in keep:
        if k.startswith("test_"):
            out[f"test_{name[5:]}__{k[5:]}"] = namespace[k]
        elif k.startswith("Test"):
            out[f"Test{name[5:].title().replace('_', '')}__{k[4:]}"] = namespace[k]
        else:
            out[k] = namespace[k]
    return out


SERVICE = ["_free_port", "DummyEngine", "pair", "test_ops_mirror_in_order", "test_check_mismatch_fails_follower_loudly",
           "test_unknown_op_fails_follower", "test_channel_close_releases_follower", "test_stop_is_idempotent",
           "test_follower_connect_times_out", "test_coordinator_accept_times_out", "test_oversize_message_rejected",
           "TestTpuIndexWiring", "TestServeWiring"]
COV10 = ["test_recv_exact_zero_bytes", "test_broadcast_bad_ack_raises", "test_stop_follower_closes_socket",
         "test_stop_follower_without_socket_is_noop", "test_follow_applies_add_packed_and_matching_check"]
globals().update(port_functions("test_service", SERVICE))
globals().update(port_functions("test_branch_cov10", COV10))


def test_the_loaded_cases_are_the_ports():
    cases = port_functions("test_service", ["test_ops_mirror_in_order", "TestTpuIndexWiring"])
    assert cases["test_service__ops_mirror_in_order"].__globals__["MultihostService"] is MultihostService
    text = (REPO / "tests" / "test_service.py").read_text()
    assert text.count("TpuIndex(tmp_path") == 5 and "TpuIndexManager(tmp_path)" in text
    cov10 = port_functions("test_branch_cov10", ["test_recv_exact_zero_bytes"])
    assert cov10["test_branch_cov10__recv_exact_zero_bytes"].__globals__["_recv_exact"] is service._recv_exact


def test_the_wire_constants_are_the_jax_packages():
    from iscc_search_tpu.parallel import service as jax_service

    assert (service._LEN.format, service._ACK, service._MAX_OP_BYTES) == (
        jax_service._LEN.format, jax_service._ACK, jax_service._MAX_OP_BYTES)


# ------------------------------------------------------- across the packages


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _connect(coordinator_cls, follower_cls):
    """A coordinator of ``coordinator_cls`` and a follower of
    ``follower_cls`` joined on a free loopback port."""
    port, made = _free_port(), {}
    t = threading.Thread(target=lambda: made.update(
        coord=coordinator_cls(True, n_followers=1, host="127.0.0.1", port=port, timeout=30)))
    t.start()
    follower = follower_cls(False, coordinator_host="127.0.0.1", port=port, timeout=30)
    t.join(30)
    return made["coord"], follower


def _bodies(rng, widths):
    return [rng.integers(0, 256, w, dtype=np.uint8).tobytes() for w in widths]


def _drive(coord, engine, seed=7):
    """The op sequence through ``engine``, hooked by ``coord``. Returns the
    coordinator's search answers."""
    rng = np.random.default_rng(seed)
    coord.hook("idx:DATA", engine)
    bodies = _bodies(rng, [8, 16, 32, 24, 8])
    engine.add([1, 2, 3, 4, 2], bodies)  # key 2 twice in one batch: the later row wins
    engine.add([3], _bodies(rng, [16]))  # an update: the old row is tombstoned
    keys = (np.arange(10, 30, dtype=">u8")).view(np.uint8).reshape(20, 8)
    packed = rng.integers(0, 2**32, (20, 4), dtype=np.uint32)
    nlanes = np.where(np.arange(20) % 2, 4, 2).astype(np.int32)
    packed[nlanes == 2, 2:] = 0
    engine.add_packed(keys, packed, nlanes)
    assert engine.remove([1, 12, 99]) == 2
    coord.check("idx:DATA", engine._rows, engine._live)
    queries = [bodies[1], bodies[2], packed[3].astype(">u4").tobytes()]
    return engine.search(queries, 5)


def _state(engine):
    n = engine._rows
    return (engine._keys[:n].copy(), engine._codes[:n].copy(), engine._nlanes[:n].copy(), engine._valid[:n].copy(),
            engine._rows, engine._live)


def _run(coordinator_cls, follower_cls, coord_engine, follower_engine):
    coord, follower = _connect(coordinator_cls, follower_cls)
    errors = []

    def loop():
        try:
            follower.follow(lambda name: follower_engine)
        except BaseException as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    thread = threading.Thread(target=loop)
    thread.start()
    try:
        answers = _drive(coord, coord_engine)
    finally:
        coord.stop()
        thread.join(60)
        follower.stop()
        coord_engine.control_hook = None  # the channel is closed: later calls run locally
    assert not thread.is_alive() and not errors, errors
    assert follower_engine.save_enabled is False
    return answers


def _assert_same_answers(a, b):
    assert len(a) == len(b)
    for (ka, sa), (kb, sb) in zip(a, b):
        assert np.array_equal(sa, sb)
        assert sorted(map(bytes, ka)) == sorted(map(bytes, kb))


def test_a_jax_coordinator_drives_a_port_follower_and_the_reverse(tmp_path):
    jax_coord_engine = JaxNphdIndex(tmp_path / "jax-coordinator")
    port_follower_engine = DeviceNphdIndex(None, device="cpu")
    answers_a = _run(JaxService, MultihostService, jax_coord_engine, port_follower_engine)

    port_coord_engine = DeviceNphdIndex(None, device="cpu")
    jax_follower_engine = JaxNphdIndex(tmp_path / "jax-follower")
    answers_b = _run(MultihostService, JaxService, port_coord_engine, jax_follower_engine)

    want = _state(jax_coord_engine)
    assert want[4:] == (26, 22)  # 5 + 1 + 20 rows appended; 4 superseded or removed
    for engine in (port_follower_engine, port_coord_engine, jax_follower_engine):
        got = _state(engine)
        assert all(np.array_equal(g, w) for g, w in zip(got[:4], want[:4])) and got[4:] == want[4:]
    _assert_same_answers(answers_a, answers_b)
    _assert_same_answers(port_follower_engine.search([b"\x00" * 8], 5), jax_coord_engine.search([b"\x00" * 8], 5))
    for engine in (jax_coord_engine, port_follower_engine, port_coord_engine, jax_follower_engine):
        engine.close()
    assert not (tmp_path / "jax-follower").exists()  # a follower never saves


@pytest.mark.parametrize("op", [
    ("add", "idx:DATA", [5, 6], [b"\x01\x02\x03\x04\x05\x06\x07\x08", bytes(16)]),
    ("add_packed", "idx:DATA", np.zeros((2, 8), np.uint8), np.ones((2, 2), np.uint32), np.full(2, 2, np.int32)),
    ("remove", "idx:DATA", [5]),
    ("search", "idx:DATA", [bytes(8)], 3),
    ("check", "idx:DATA", 0, 0),
    ("stop",),
])
def test_each_op_is_the_same_bytes_on_the_wire(op):
    """Both coordinators put the same frame on the socket for each op."""
    import socket

    frames = []
    for cls in (JaxService, MultihostService):
        a, b = socket.socketpair()
        svc = object.__new__(cls)
        svc._conns = [a]
        svc._broadcast(op, want_ack=False)
        a.close()
        chunks = []
        while chunk := b.recv(1 << 16):
            chunks.append(chunk)
        b.close()
        frames.append(b"".join(chunks))
    assert frames[0] == frames[1]
    (n,) = service._LEN.unpack(frames[1][:4])
    assert n == len(frames[1]) - 4
