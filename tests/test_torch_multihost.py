"""The port's multi-host serving on the CPU: the engine's control hook,
``TpuIndex.follow()``, the manager's multi-host entries and ``serve()``'s
distributed mode.

- The hook cases of ``tests/test_branch_cov16.py`` and the distributed
  ``serve()`` cases of ``tests/test_branch_cov11.py`` compiled against the
  port (``tests/test_torch_service.py``'s ``port_functions``): the patches
  of ``jax.process_count`` / ``jax.process_index`` /
  ``jax.distributed.initialize`` become patches of the port's
  ``parallel.mesh.process_count`` / ``process_index`` and
  ``parallel.distributed.init_distributed``, the patched ``get_index``
  takes the ``device`` argument, and ``make_mesh_2d(2, 4)`` is given
  ``device="cpu"``. None is left out.
- An in-process coordinator and follower: two port CPU engines, the
  follower loop on a thread. After every mirrored ``add``, ``add_packed``,
  ``remove`` and ``search`` both engines hold the same host state and
  ``check`` passes.
- The compaction hazard of the design both packages share: past 50%
  tombstones the coordinator's ``save()`` compacts its rows, a follower
  never saves, and the next ``check`` fails loudly on the follower (the
  port's engines and the JAX engines, on the same ops).
- The two-process product cluster (the sequence of
  ``tests/multihost_product_worker.py``): two processes joined by gloo
  (``init_distributed``), each a ``TpuIndexManager(device="cpu")`` in its
  own directory with ``mesh_devices=4``, a ``(2, 4)`` mesh. The
  coordinator's ``search_assets`` answers equal the JAX package's
  single-process ``TpuIndex(mesh_devices=8)`` fed the same sequence (the
  ROADMAP parity rule: matches of equal score in any order), the follower's
  replicas end equal to the coordinator's engines, and the follower exits 0
  after the stop op. This file is the worker (``python
  tests/test_torch_multihost.py RANK WORLD PORT BASE CONTROL_PORT OUT``).
- ``serve()`` distributed: ``python -m iscc_search_tpu_torch.cli --device cpu
  serve`` twice, ranks 0 and 1 of a gloo cluster, each on its own copy of
  an index directory; a search over HTTP equals the direct call; SIGTERM to
  the coordinator and both exit 0.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
INDEX = "mh"
PROCESS_TIMEOUT_S = 180  # each process of the product cluster
SERVE_TIMEOUT_S = 120  # the distributed serve() pair, start to exit


def _unit(ic, mtype, stype, body):
    header = ic.encode_header(mtype, stype, ic.VS.V0, ic.encode_length(mtype, len(body) * 8))
    return "ISCC:" + ic.encode_base32(header + body)


def _iscc_id(ic, n):
    return ic.gen_iscc_id_v1(timestamp_us=n + 1, server_id=n % 4096, realm_id=0)["iscc"]


def product_entries(ic, np):
    """The assets of ``tests/multihost_product_worker.py``: an exact, a near
    (~3% distance) and a far 256-bit DATA unit, then 256 fillers of 64, 128
    and 256 bits, each with an INSTANCE unit."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    near = bytearray(base)
    for p in rng.choice(256, size=8, replace=False):
        near[p // 8] ^= 1 << (7 - p % 8)
    near = bytes(near)
    far = bytes(255 - b for b in base)

    def data(b):
        return _unit(ic, ic.MT.DATA, 0, b)

    def inst(b):
        return _unit(ic, ic.MT.INSTANCE, 0, b)

    entries = [{"iscc_id": _iscc_id(ic, n), "units": [data(b), inst(rng.integers(0, 256, 8, np.uint8).tobytes())]}
               for n, b in ((1, base), (2, near), (3, far))]
    for n in range(4, 260):
        width = [8, 16, 32][n % 3]
        entries.append({"iscc_id": _iscc_id(ic, n), "units": [data(rng.integers(0, 256, width, np.uint8).tobytes()),
                                                            inst(rng.integers(0, 256, 8, np.uint8).tobytes())]})
    return entries, base, near, data


def product_sequence(ic, np, schema, add_assets, search_assets):
    """The product worker's sequence through ``add_assets(entries)`` and
    ``search_assets(query, limit)``: add 259 assets, search, re-add asset 3
    with the near body (an update), search, a 64-bit prefix search. Returns
    the ``model_dump()`` of every result."""
    entries, base, near, data = product_entries(ic, np)
    out = [[r.model_dump() for r in add_assets([schema.IsccEntry(**e) for e in entries])]]
    out.append(search_assets(schema.IsccQuery(units=[data(base)]), 10).model_dump())
    update = schema.IsccEntry(iscc_id=_iscc_id(ic, 3), units=[data(near), entries[2]["units"][1]])
    out.append([r.model_dump() for r in add_assets([update])])
    out.append(search_assets(schema.IsccQuery(units=[data(base)]), 10).model_dump())
    out.append(search_assets(schema.IsccQuery(units=[data(base[:8])]), 5).model_dump())
    return out


def engine_state(engine):
    n = engine._rows
    return {"keys": engine._keys[:n], "codes": engine._codes[:n], "nlanes": engine._nlanes[:n],
            "valid": engine._valid[:n], "rows": engine._rows, "live": engine._live}


def worker(rank, world, port, base_dir, ctrl_port, out):
    """One process of the product cluster: rank 0 creates the index and runs
    the sequence (its engine ops mirrored), every other rank follows."""
    os.environ["ISCC_SEARCH_MULTIHOST_CONTROL_PORT"] = str(ctrl_port)
    os.environ["ISCC_SEARCH_MULTIHOST_COORDINATOR"] = "127.0.0.1"
    os.environ["ISCC_SEARCH_FLUSH_INTERVAL"] = "0"
    os.environ["ISCC_SEARCH_MESH_DEVICES"] = "4"
    import numpy as np
    import torch

    torch.set_num_threads(1)  # the cluster's processes share the host
    from iscc_search_tpu_torch import codec as ic
    from iscc_search_tpu_torch import schema
    from iscc_search_tpu_torch.indexes.tpu import TpuIndexManager
    from iscc_search_tpu_torch.parallel.distributed import init_distributed

    init_distributed(f"127.0.0.1:{port}", world, rank)
    mgr = TpuIndexManager(Path(base_dir) / f"proc{rank}", device="cpu")
    if rank > 0:
        mgr.follow_index(INDEX)
        idx = mgr._index_cache[INDEX]
        np.savez(out, **{f"{t}/{k}": v for t, e in idx._nphd_indexes.items() for k, v in engine_state(e).items()})
        mgr.close()
        print(f"multihost-product p{rank}: OK", flush=True)
        return
    mgr.create_index(schema.IsccIndex(name=INDEX))
    idx = mgr._index_cache[INDEX]
    mesh = idx._device_mesh()
    dumps = product_sequence(ic, np, schema, lambda e: mgr.add_assets(INDEX, e),
                             lambda q, limit: mgr.search_assets(INDEX, q, limit=limit))
    np.savez(out + ".npz", **{f"{t}/{k}": v for t, e in idx._nphd_indexes.items() for k, v in engine_state(e).items()})
    Path(out).write_text(json.dumps({"dumps": dumps, "mesh": [mesh.shape, mesh.n_procs, len(mesh.devices)],
                                     "hooked": sorted(t for t, e in idx._nphd_indexes.items() if e.control_hook)}))
    mgr.close()  # broadcasts stop: the followers return from follow_index
    print(f"multihost-product p{rank}: OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5]), sys.argv[6])
    sys.exit(0)


import numpy as np  # noqa: E402
import pytest  # noqa: E402

from iscc_search_tpu.engine.device_index import DeviceNphdIndex as JaxNphdIndex  # noqa: E402
from iscc_search_tpu.parallel.service import MultihostService as JaxService  # noqa: E402
from iscc_search_tpu_torch.engine.device_index import DeviceNphdIndex  # noqa: E402
from iscc_search_tpu_torch.parallel.service import MultihostService  # noqa: E402
from tests.test_torch_service import _connect, _free_port, _state, port_functions  # noqa: E402

# ---------------------------------------------------- the JAX package's cases

_PATCH_PROCESS = ('''    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 0)''', '''    from iscc_search_tpu.parallel import mesh as _pmesh

    monkeypatch.setattr(_pmesh, "process_count", lambda: 2)
    monkeypatch.setattr(_pmesh, "process_index", lambda: 0)''')
COV16_REPLACE = [
    _PATCH_PROCESS,
    ('    monkeypatch.setattr(jax, "process_index", lambda: 1)', '    monkeypatch.setattr(_pmesh, "process_index", lambda: 1)'),
    ("    idx._mesh = make_mesh_2d(2, 4)\n", '    idx._mesh = make_mesh_2d(2, 4, device="cpu")\n'),
    ('    monkeypatch.setattr(jax, "process_count", lambda: 4)', '''    from iscc_search_tpu.parallel import mesh as _pmesh

    monkeypatch.setattr(_pmesh, "process_count", lambda: 4)'''),
]
COV16 = ["rng", "entry", "data_entry", "FakeService", "test_coordinator_service_hooks_new_indexes_and_stops_on_close",
         "test_follower_service_disables_persistence", "test_follow_requires_follower_role", "test_init_multihost_arms",
         "test_device_mesh_auto_hosts_from_process_count"]
COV11_REPLACE = [
    ('''    import jax

    monkeypatch.setattr(jax.distributed, "initialize", lambda: None)
    monkeypatch.setattr(jax, "process_index", lambda: process_index)''', '''    from iscc_search_tpu.parallel import distributed, mesh

    monkeypatch.setattr(distributed, "init_distributed", lambda: None)
    monkeypatch.setattr(mesh, "process_index", lambda: process_index)'''),
    ("lambda uri:", "lambda uri, device=None:"),
]
COV11 = ["_RecordingIndex", "_fake_jax", "test_serve_distributed_follower_path",
         "test_serve_distributed_coordinator_requires_index_name",
         "test_serve_distributed_coordinator_requires_tpu_backend",
         "test_serve_distributed_coordinator_opens_index_before_app"]
globals().update(port_functions("test_branch_cov16", COV16, replace=COV16_REPLACE))
globals().update(port_functions("test_branch_cov11", COV11, replace=COV11_REPLACE))


def test_the_loaded_cases_are_the_ports():
    from iscc_search_tpu_torch.indexes.tpu.index import TpuIndex
    from iscc_search_tpu_torch.server import httpd

    cov16 = port_functions("test_branch_cov16", ["test_init_multihost_arms"], replace=COV16_REPLACE)
    assert cov16["test_branch_cov16__init_multihost_arms"].__globals__["TpuIndex"] is TpuIndex
    cov11 = port_functions("test_branch_cov11", ["test_serve_distributed_follower_path"], replace=COV11_REPLACE)
    assert cov11["test_branch_cov11__serve_distributed_follower_path"].__globals__["httpd_mod"] is httpd


# ---------------------------------------------------------- in-process pair


def _pair(coordinator_cls, follower_cls, coord_engine, follower_engine):
    """Coordinator and follower joined, ``coord_engine`` hooked, the follow
    loop on a thread. Returns (coordinator, follower, thread, errors)."""
    coord, follower = _connect(coordinator_cls, follower_cls)
    errors = []

    def loop():
        try:
            follower.follow(lambda name: follower_engine)
        except BaseException as exc:  # noqa: BLE001 - asserted by the tests
            errors.append(exc)

    thread = threading.Thread(target=loop)
    thread.start()
    coord.hook("pair:DATA", coord_engine)
    return coord, follower, thread, errors


def _same_state(a, b):
    sa, sb = _state(a), _state(b)
    return all(np.array_equal(x, y) for x, y in zip(sa[:4], sb[:4])) and sa[4:] == sb[4:]


def test_every_mirrored_op_leaves_the_replicas_equal(tmp_path):
    rng = np.random.default_rng(3)
    coord_engine, follower_engine = DeviceNphdIndex(tmp_path / "coordinator", device="cpu"), DeviceNphdIndex(
        None, device="cpu")
    coord, follower, thread, errors = _pair(MultihostService, MultihostService, coord_engine, follower_engine)
    try:
        bodies = [rng.integers(0, 256, w, dtype=np.uint8).tobytes() for w in (8, 16, 24, 32, 8, 16)]
        keys = np.arange(100, 164, dtype=">u8").view(np.uint8).reshape(64, 8)
        packed = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
        steps = [
            lambda: coord_engine.add([1, 2, 3], bodies[:3]),
            lambda: coord_engine.add([2, 4, 4], [np.frombuffer(b, np.uint8) for b in bodies[3:]]),
            lambda: coord_engine.add_packed(keys, packed, 8),
            lambda: coord_engine.remove([1, 100, 150, 7]),
            lambda: coord_engine.search(bodies[:2], 3),
            lambda: coord_engine.add([1], bodies[:1]),
        ]
        for step in steps:
            step()
            assert _same_state(coord_engine, follower_engine)
            coord.check("pair:DATA", coord_engine._rows, coord_engine._live)
        assert (coord_engine._rows, coord_engine._live) == (71, 66)
        got = follower_engine.search(bodies[:3] + [packed[5].astype(">u4").tobytes()], 4)
        coord_engine.control_hook = None
        want = coord_engine.search(bodies[:3] + [packed[5].astype(">u4").tobytes()], 4)
        assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(got, want))
    finally:
        coord.stop()
        thread.join(60)
        follower.stop()
    assert not thread.is_alive() and not errors
    assert follower_engine.save_enabled is False and coord_engine.save_enabled is True
    coord_engine.close()
    follower_engine.close()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_compaction_on_the_coordinator_desyncs_the_followers(tmp_path, package):
    """The hazard of the design (ROADMAP.md queue 3): ``save()`` compacts past
    50% tombstones, only on the coordinator (followers never save), so the
    row spaces part and the next ``check`` fails loudly on the follower.
    The JAX engine does the same on the same ops."""
    if package == "port":
        engines = DeviceNphdIndex(tmp_path / "c", device="cpu"), DeviceNphdIndex(tmp_path / "f", device="cpu")
        services = MultihostService, MultihostService
    else:
        engines = JaxNphdIndex(tmp_path / "c"), JaxNphdIndex(tmp_path / "f")
        services = JaxService, JaxService
    coord_engine, follower_engine = engines
    coord, follower, thread, errors = _pair(*services, coord_engine, follower_engine)
    n = 9000  # above the 8,192 rows below which save() never compacts
    rng = np.random.default_rng(5)
    try:
        coord_engine.add_packed(np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8),
                                rng.integers(0, 2**32, (n, 4), dtype=np.uint32), 4)
        assert coord_engine.remove(list(range(0, n, 2))) + coord_engine.remove(list(range(1, n, 4))) == 6750
        coord.check("pair:DATA", coord_engine._rows, coord_engine._live)  # still equal: 9000 rows, 2250 live
        coord_engine.save()  # tombstones 75%: the coordinator compacts its rows
        assert (coord_engine._rows, coord_engine._live) == (2250, 2250)
        assert (follower_engine._rows, follower_engine._live) == (9000, 2250)
        with pytest.raises((RuntimeError, ConnectionError, OSError)):
            coord.check("pair:DATA", coord_engine._rows, coord_engine._live)
            # The follower closes its socket instead of acking; a second op
            # surfaces the dead channel even if the first send won the race.
            coord.check("pair:DATA", coord_engine._rows, coord_engine._live)
    finally:
        coord.stop()
        thread.join(60)
        follower.stop()
    assert not thread.is_alive()
    assert errors and "replica state mismatch" in str(errors[0])
    assert "coordinator has rows=2250 live=2250, this process has rows=9000 live=2250" in str(errors[0])
    coord_engine.control_hook = None
    coord_engine.close()
    follower_engine.close()
    assert not (tmp_path / "f").exists()  # the follower never saved


# ----------------------------------------------- the two-process product cluster


def _worker_env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("ISCC_SEARCH_")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **extra)
    return env


def _normalized(dump):
    """A result's ``model_dump()`` with matches of equal score in one order
    (the parity rule: tie order is not compared)."""
    if isinstance(dump, dict) and "global_matches" in dump:
        dump = dict(dump, global_matches=sorted(dump["global_matches"], key=lambda m: (-m["score"], m["iscc_id"])))
    return dump


def _run_cluster(cmds, timeout):
    """Start every command, wait for all; raise with the output of one that
    fails or outlives ``timeout`` (and kill the rest then)."""
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd, env in cmds]
    outs = []
    try:
        deadline = time.monotonic() + timeout
        for proc in procs:
            text, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(text)
            assert proc.returncode == 0, text[-4000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def test_two_process_product_cluster_equals_the_jax_index(tmp_path):
    from iscc_search_tpu import codec as jax_ic
    from iscc_search_tpu import schema as jax_schema
    from iscc_search_tpu.indexes.tpu import TpuIndex as JaxTpuIndex

    port, ctrl = _free_port(), _free_port()
    out = [str(tmp_path / f"rank{r}") for r in range(2)]
    cmds = [([sys.executable, __file__, str(r), "2", str(port), str(tmp_path), str(ctrl), out[r]], _worker_env())
            for r in range(2)]
    texts = _run_cluster(cmds, PROCESS_TIMEOUT_S)
    assert all(f"multihost-product p{r}: OK" in t for r, t in enumerate(texts))
    report = json.loads(Path(out[0]).read_text())
    assert report["mesh"] == [{"dcn": 2, "ici": 4}, 2, 4]
    assert report["hooked"] == ["DATA_NONE_V0"]

    jx = JaxTpuIndex(tmp_path / "jax", mesh_devices=8, flush_interval=0)
    try:
        want = product_sequence(jax_ic, np, jax_schema, jx.add_assets, lambda q, limit: jx.search_assets(q, limit=limit))
    finally:
        jx.close()
    assert [_normalized(d) for d in report["dumps"]] == [_normalized(d) for d in want]
    ids = [m["iscc_id"] for m in report["dumps"][3]["global_matches"]]
    assert ids[0] == _iscc_id(jax_ic, 1) and _iscc_id(jax_ic, 3) in ids  # the update was mirrored and found

    coordinator, replica = np.load(out[0] + ".npz"), np.load(out[1] + ".npz")
    assert sorted(coordinator.files) == sorted(replica.files) and coordinator.files
    for name in coordinator.files:
        assert np.array_equal(coordinator[name], replica[name]), name
    assert int(coordinator["DATA_NONE_V0/rows"]) == 260  # 259 assets and one update
    # The follower never saved: its directory holds no engine segment.
    assert not any((tmp_path / "proc1" / INDEX).glob("*/state.json"))


# ------------------------------------------------------ serve() distributed


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def test_serve_distributed_over_two_processes(tmp_path):
    from iscc_search_tpu_torch import codec as ic
    from iscc_search_tpu_torch import schema
    from iscc_search_tpu_torch.indexes.tpu import TpuIndexManager

    entries, base, _, data = product_entries(ic, np)
    mgr = TpuIndexManager(tmp_path / "source", device="cpu")
    mgr.create_index(schema.IsccIndex(name=INDEX))
    mgr.add_assets(INDEX, [schema.IsccEntry(**e) for e in entries[:60]])
    mgr.close()
    for copy in ("rank0", "rank1", "direct"):
        shutil.copytree(tmp_path / "source", tmp_path / copy)
    direct = TpuIndexManager(tmp_path / "direct", device="cpu")
    query = {"units": [data(base)]}
    want = direct.search_assets(INDEX, schema.IsccQuery(**query), limit=10).model_dump(
        mode="json", exclude_unset=True, exclude_none=True)
    direct.close()

    before = _files(tmp_path / "rank1")
    http, store, ctrl = _free_port(), _free_port(), _free_port()
    procs = []
    for rank in range(2):
        env = _worker_env(
            ISCC_SEARCH_DISTRIBUTED="1", ISCC_SEARCH_COORDINATOR=f"127.0.0.1:{store}", ISCC_SEARCH_NUM_HOSTS="2",
            ISCC_SEARCH_HOST_ID=str(rank), ISCC_SEARCH_MULTIHOST_INDEX=INDEX,
            ISCC_SEARCH_MULTIHOST_COORDINATOR="127.0.0.1", ISCC_SEARCH_MULTIHOST_CONTROL_PORT=str(ctrl),
            ISCC_SEARCH_INDEX_URI=f"tpu://{tmp_path / f'rank{rank}'}", ISCC_SEARCH_HOST="127.0.0.1",
            ISCC_SEARCH_PORT=str(http), HOME=str(tmp_path / "home"))
        log = open(tmp_path / f"serve{rank}.log", "wb")
        procs.append(subprocess.Popen([sys.executable, "-m", "iscc_search_tpu_torch.cli", "--device", "cpu", "serve"],
                                      cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    url = f"http://127.0.0.1:{http}"
    try:
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert all(p.poll() is None for p in procs), [(tmp_path / f"serve{r}.log").read_text()[-3000:] for r in
                                                          range(2)]
            assert time.monotonic() < deadline, "the coordinator did not answer /healthz"
            time.sleep(0.25)
        req = urllib.request.Request(f"{url}/indexes/{INDEX}/search?limit=10", data=json.dumps(query).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())
        assert _normalized(got) == _normalized(want) and got["global_matches"]
        late = entries[60:63]  # added over HTTP: mirrored to the follower, saved by the coordinator alone
        req = urllib.request.Request(f"{url}/indexes/{INDEX}/assets", data=json.dumps(late).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert [a["status"] for a in json.loads(r.read())] == ["created"] * 3
        procs[0].send_signal(signal.SIGTERM)
        codes = [p.wait(max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [(tmp_path / f"serve{r}.log").read_text() for r in range(2)]
    assert codes == [0, 0], [log[-3000:] for log in logs]
    assert "Multi-host follower: serving index 'mh'" in logs[1] and "Serving on" not in logs[1]
    assert "SIGTERM received" in logs[0]
    assert _files(tmp_path / "rank1") == before  # the follower saved no file
    reopened = TpuIndexManager(tmp_path / "rank0", device="cpu")
    assert reopened.get_index(INDEX).assets == 63
    reopened.close()


# ------------------------------------------------ chip_smoke.py [multihost]


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_multihost_engine_phase_on_the_cpu(tmp_path):
    """``[multihost]`` (a) at a tiny size on the CPU: two gloo processes, the
    coordinator making the rows from the seed and mirroring every mutation,
    the follower getting them over the channel only. The phase makes its own
    checks (the replicas' digests and every answer against the single-device
    index and brute force, the launches of both ranks, each kernel against
    its plain version on rank 0)."""
    import torch

    mod = _chip_smoke()
    assert (mod.MULTIHOST_BATCH, mod.N_ROWS) == (1_048_576, 10_485_760)
    dev, n, nq, seed, n_app = torch.device("cpu"), 3000, 8, 5, 64
    codes, lanes = mod.random_codes(np.random.default_rng(seed), n)
    app_codes, app_lanes = mod.random_codes(np.random.default_rng(seed + 1), n_app)
    single = DeviceNphdIndex(None, device="cpu")
    single.add_packed(np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8), codes, lanes)
    removed = np.arange(0, n, mod.TOMBSTONE_EVERY)
    single.remove(removed.tolist())
    single.add(list(range(n, n + n_app)), mod.bodies_of(app_codes, app_lanes))
    all_codes, all_lanes = np.concatenate([codes, app_codes]), np.concatenate([lanes, app_lanes])
    valid = np.ones(n + n_app, bool)
    valid[removed] = False
    q_rows = np.arange(nq) * (n // nq) // mod.TOMBSTONE_EVERY * mod.TOMBSTONE_EVERY + 1
    q_rows[-2:] = n + np.arange(2)  # appended rows
    queries = mod.bodies_of(all_codes[q_rows], all_lanes[q_rows])
    sample = np.arange(nq)
    ref = mod.brute_force(dev, all_codes[q_rows], all_lanes[q_rows], all_codes, all_lanes, valid)
    oracle = (q_rows, valid, ref.numpy(), torch.topk(ref, mod.K, dim=1).values.numpy(), sample)

    launches, stats = mod.phase_multihost(dev, single, queries, oracle, tmp_path, seed, n_rows=n, batch=1024,
                                          qs=(nq, 3, 1), limit=40, reps=1, timeout=120)
    assert set(launches) == set(mod.PATH_KERNELS)
    assert set(stats) == {"blockmax", "blockmax_small", "gather_rescore"}
    assert all(e["max_abs_err"] == 0.0 for entries in stats.values() for e in entries)
    coord = json.loads((tmp_path / "multihost" / "rank0.json").read_text())
    assert [e["op"] for e in coord["ops"]][:5] == ["add_packed", "add_packed", "add_packed", "remove", "add"]
    assert coord["ops"][0]["n"] == 1024 and coord["ops"][2]["n"] == n - 2048
    single.close()
