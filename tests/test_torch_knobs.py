"""The engine's scan knobs of ``iscc_search_tpu_torch`` against the JAX
engine, on the CPU: ``scan_kernel`` ``"xla"`` and ``"pallas"``, without a
mesh and on 8 shards, with and without a ``recall_target``, the int8-twin
budget ``ISCC_SEARCH_UNPACKED_MAX_BYTES`` at its edge, and a ``count`` above
32,768.

Both engines hold the same rows: a JAX ``DeviceNphdIndex`` is filled by
``add_packed`` and ``remove`` from a numpy seed, and the port's index loads
its host arrays through ``from_arrays``. The JAX ``"pallas"`` path runs in
interpret mode, as its own tests run it (JAX's 8 virtual CPU devices on a
mesh, the port's 8 CPU shards). Answers are held by the parity rule: the
same score multiset per query (to one unit in the last place), every
returned key live and carrying its brute-force NPHD score, the top scores
brute force's; tied keys in any order.

Each side's route per partition is recorded by spies set here on the route
functions (the JAX engine's fused-scan specs, ``sharded_pallas_topk`` and
``sharded_pm1_topk``; the port's kernel route and ``sharded_pallas_topk``)
and held to the table of ``engine/device_index.py``: every port route is a
kernel route, with or without a ``recall_target``. ``"xla"`` and, on one
device, ``"pallas"`` take the kernel ``auto_phase1`` names, per shard on a
mesh; on a mesh ``"pallas"`` takes the twin per shard
(``sharded_pallas_topk``) wherever it fits the budget, at any count. Where
the JAX engine takes its XLA scan the port keeps the kernel route.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import iscc_search_tpu.parallel.pallas_sharded as jax_pallas_sharded
import iscc_search_tpu.parallel.pm1_sharded as jax_pm1_sharded
from iscc_search_tpu import parallel as jax_parallel
from iscc_search_tpu.engine import device_index as jax_di
from iscc_search_tpu_torch import parallel
from iscc_search_tpu_torch.engine import DeviceNphdIndex
from iscc_search_tpu_torch.engine import device_index as di
from iscc_search_tpu_torch.ops import hopper_scan
from tests.test_torch_ops import _brute_force
from tests.test_torch_parallel import CPU8

CpuIndex = functools.partial(DeviceNphdIndex, device="cpu")
K = 10
MIXED = {2: 2000, 4: 2100, 6: 150, 8: 1900}  # rows per lane count: one 8,192-row partition each


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Test files run in parallel processes: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _make_data(rows_per_lanes, seed):
    """(keys, codes, lanes, removed): rows in random lane order, near copies
    of the first rows, every 17th row removed; key == row."""
    rng = np.random.default_rng(seed)
    lanes = np.concatenate([np.full(n, lv, np.int32) for lv, n in rows_per_lanes.items()])
    rng.shuffle(lanes)
    n = len(lanes)
    codes = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    codes[np.arange(8)[None, :] >= lanes[:, None]] = 0
    codes[20:40] = codes[:20]
    codes[20:40, 0] ^= np.uint32(1)
    lanes[20:40] = lanes[:20]
    keys = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    return keys, codes, lanes, np.arange(3, n, 17)


def _queries(codes, lanes, n_rows, n_random, seed):
    """Stored rows (one removed among them) and random codes of every width."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([[3], rng.integers(0, len(lanes), n_rows - 1)])
    r_lanes = rng.choice(np.array([2, 4, 6, 8], np.int32), n_random).astype(np.int32)
    r_codes = rng.integers(0, 2**32, (n_random, 8), dtype=np.uint32)
    r_codes[np.arange(8)[None, :] >= r_lanes[:, None]] = 0
    return np.concatenate([codes[rows], r_codes]), np.concatenate([lanes[rows], r_lanes])


def _bodies(codes, lanes):
    return [codes[i, : lanes[i]].astype(">u4").tobytes() for i in range(len(lanes))]


class Routes:
    """Spies on both engines' route functions: ``jax`` and ``port`` map a
    partition's bit width to the set of routes its scans took; ``kernel_calls``
    counts the port's calls of any kernel wrapper (``hopper_scan._route``)."""

    def __init__(self, monkeypatch):
        self.jax, self.port, self.kernel_calls = {}, {}, 0
        fused = jax_di._fused_scan_fn()

        def jax_fused(q_codes, q_lanes, buffers, specs, interpret):
            for kind, nbits, *_ in specs:
                self.jax.setdefault(nbits, set()).add(kind)
            return fused(q_codes, q_lanes, buffers, specs, interpret)

        monkeypatch.setattr(jax_di, "_FUSED_SCAN", jax_fused)
        self._spy(monkeypatch, jax_pallas_sharded, "sharded_pallas_topk", self.jax, 7)
        self._spy(monkeypatch, jax_pm1_sharded, "sharded_pm1_topk", self.jax, 6)
        self._spy(monkeypatch, di, "sharded_pallas_topk", self.port, 8)
        kernel = di.blockmax_topk_packedq_impl

        def port_kernel(*args, phase1, **kwargs):
            self.port.setdefault(args[5], set()).add(f"kernel:{phase1}")
            return kernel(*args, phase1=phase1, **kwargs)

        monkeypatch.setattr(di, "blockmax_topk_packedq_impl", port_kernel)
        route = hopper_scan._route

        def kernel_route(tensors):
            self.kernel_calls += 1
            return route(tensors)

        monkeypatch.setattr(hopper_scan, "_route", kernel_route)

    @staticmethod
    def _spy(monkeypatch, module, name, seen, nbits_at):
        real = getattr(module, name)

        def spy(*args, **kwargs):
            seen.setdefault(args[nbits_at], set()).add(name)
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)


def _jax_chunk_and_k(rows, count):
    """The JAX engine's inline (chunk, k) sizing over ``rows`` rows
    (``_search_impl``; on a mesh the per-shard rows are a power of two)."""
    chunk = min(rows, jax_di._DEFAULT_CHUNK_ROWS)
    k = jax_di._pow2ceil(max(1, count))
    if k > chunk:
        chunk = min(rows, k)
        if rows % chunk:
            chunk = rows
        k = min(k, chunk)
    return chunk, k


def _jax_route(scan_kernel, recall, mesh, cap, lanes, count, budget):
    """The JAX engine's route for one partition (``_search_impl``,
    ``_build_partition``, ``_use_pallas`` off a TPU)."""
    n_shards = 8 if mesh else 1
    chunk, _ = _jax_chunk_and_k(cap // n_shards, count)
    pallas_ok = chunk <= 32768
    if not mesh:
        twin = scan_kernel == "pallas" and cap >= jax_di._PALLAS_MIN_CHUNK
        if recall is None and pallas_ok and twin:
            return "pallas"
        return "blockmax" if recall is None else "approx"
    fits = scan_kernel == "pallas" and cap // n_shards * lanes * 32 <= budget
    return "sharded_pallas_topk" if recall is None and pallas_ok and fits else "sharded_pm1_topk"


def _port_route(scan_kernel, mesh, cap, lanes, budget, nq):
    """The port's route for one partition, by the table of the module
    docstring of ``engine/device_index.py``: the same with or without a
    ``recall_target`` and at any count."""
    if mesh and scan_kernel == "pallas" and cap // mesh * lanes * 32 <= budget:
        return "sharded_pallas_topk"
    return f"kernel:{di.auto_phase1(nq, lanes)}"


def _assert_parity(port_res, jax_res, q_codes, q_lanes, codes, lanes, valid, count):
    """Score multisets within one ulp; every port key live, once, with its
    brute-force score; the port's scores are brute force's top scores."""
    ref = _brute_force(q_codes, q_lanes, codes, lanes, valid)
    for qi, ((kp, sp), (_, sj)) in enumerate(zip(port_res, jax_res)):
        rows = kp.view(">u8").ravel().astype(np.int64)
        assert len(sp) == len(sj) == min(count, int(valid.sum()))
        np.testing.assert_array_max_ulp(np.sort(sp), np.sort(sj), maxulp=1)
        assert np.all(np.diff(sp) <= 0) and valid[rows].all() and len(set(rows.tolist())) == len(rows)
        np.testing.assert_allclose(ref[qi, rows], sp, rtol=0, atol=1e-6)
        np.testing.assert_allclose(sp, -np.sort(-ref[qi])[: len(sp)], rtol=0, atol=1e-6)


def _pair(tmp_path, data, scan_kernel, recall, mesh, **kwargs):
    """(JAX index, port index) over ``data``; ``mesh``: the shard count."""
    keys, codes, lanes, removed = data
    jx = jax_di.DeviceNphdIndex(tmp_path / "jax", scan_kernel=scan_kernel, recall_target=recall,
                                mesh=jax_parallel.make_mesh(mesh) if mesh else None, **kwargs)
    jx.add_packed(keys, codes, lanes)
    jx.remove(removed.tolist())
    n = jx._rows
    pt = DeviceNphdIndex.from_arrays(jx._keys[:n], jx._codes[:n], jx._nlanes[:n], jx._valid[:n], device="cpu",
                                     scan_kernel=scan_kernel, recall_target=recall,
                                     mesh=parallel.make_mesh(devices=[torch.device("cpu")] * mesh) if mesh else None)
    return jx, pt


def _run_case(tmp_path, monkeypatch, data, scan_kernel, recall, mesh, count, queries, budget=9 * 1024**3, **kwargs):
    """Search both engines, hold the answers by the parity rule and each
    side's route per partition to its table. Returns the routes."""
    jx, pt = _pair(tmp_path, data, scan_kernel, recall, mesh, **kwargs)
    _, codes, lanes, _ = data
    q_codes, q_lanes = queries
    bodies = _bodies(q_codes, q_lanes)
    routes = Routes(monkeypatch)
    try:
        jax_res = jx.search(bodies, count)
        port_res = pt.search(bodies, count)
        _assert_parity(port_res, jax_res, q_codes, q_lanes, codes, lanes, jx._valid[: len(lanes)], count)
        caps = {lv: p.cap for lv, p in pt._partitions.items()}
        assert caps == {lv: p.cap for lv, p in jx._partitions.items()}
        for lv, cap in caps.items():
            want_jax = _jax_route(scan_kernel, recall, mesh, cap, lv, count, budget)
            want_port = _port_route(scan_kernel, mesh, cap, lv, budget, len(bodies))
            assert routes.jax[lv * 32] == {want_jax}, (lv, routes.jax)
            assert routes.port[lv * 32] == {want_port}, (lv, routes.port)
            twin = pt._partitions[lv].unpacked_dev
            assert (twin is not None) == bool(mesh and scan_kernel == "pallas" and cap // 8 * lv * 32 <= budget)
        assert routes.kernel_calls > 0
    finally:
        jx.reset()
        jx.close()
    return routes


@pytest.fixture(scope="module")
def mixed():
    return _make_data(MIXED, seed=31)


@pytest.mark.parametrize("recall", [None, 0.95], ids=["exact", "recall0.95"])
@pytest.mark.parametrize("mesh", [0, 8], ids=["one_device", "mesh8"])
@pytest.mark.parametrize("scan_kernel", ["xla", "pallas"])
def test_knob_routes_and_answers_equal_the_jax_engine(tmp_path, monkeypatch, mixed, scan_kernel, mesh, recall):
    """Four 8,192-row partitions (64-256 bits; 8 shards of 8,192 rows each
    on a mesh), tombstones, 12 queries of every width at k=10 and 40."""
    _, codes, lanes, _ = mixed
    queries = _queries(codes, lanes, 8, 4, seed=32)
    for count in (K, 40):
        _run_case(tmp_path / f"c{count}", monkeypatch, mixed, scan_kernel, recall, mesh, count, queries)
        monkeypatch.undo()


def test_pallas_above_the_twin_tier_floor(tmp_path, monkeypatch):
    """A 256-bit partition of 9,000 rows (capacity 16,384): the JAX engine
    builds its bitplane and int8 twins and takes its fused Pallas tiers; the
    port takes the kernel routes of ``"auto"``."""
    data = _make_data({2: 300, 8: 9000}, seed=33)
    _, codes, lanes, _ = data
    routes = _run_case(tmp_path, monkeypatch, data, "pallas", None, 0, K, _queries(codes, lanes, 5, 2, seed=34))
    assert routes.jax[256] == {"pallas"} and routes.port[256] == {f"kernel:{di.auto_phase1(7, 8)}"}


@pytest.mark.parametrize("mesh", [0, 2], ids=["one_device", "mesh2"])
@pytest.mark.parametrize("scan_kernel", ["xla", "pallas"])
def test_count_above_32768(tmp_path, monkeypatch, scan_kernel, mesh):
    """A count of 40,000 grows the JAX engine's chunk past 32,768 rows: its
    fused Pallas route gives way to the XLA scan, on a mesh of 2 shards of
    65,536 rows too. The port keeps its kernel routes: the twin per shard
    under ``"pallas"`` on the mesh, else the kernel ``auto_phase1`` names."""
    data = _make_data({2: 70000, 8: 200}, seed=35)
    _, codes, lanes, _ = data
    queries = _queries(codes, lanes, 2, 0, seed=36)
    if mesh:
        jx, pt = _pair(tmp_path, data, scan_kernel, None, mesh)
        routes = Routes(monkeypatch)
        try:
            bodies = _bodies(*queries)
            jax_res, port_res = jx.search(bodies, 40000), pt.search(bodies, 40000)
            _assert_parity(port_res, jax_res, *queries, codes, lanes, jx._valid[: len(lanes)], 40000)
            assert pt._partitions[2].cap // 2 == 65536
            want = "sharded_pallas_topk" if scan_kernel == "pallas" else f"kernel:{di.auto_phase1(2, 2)}"
            assert routes.jax[64] == {"sharded_pm1_topk"} and routes.port[64] == {want}
            assert (pt._partitions[2].unpacked_dev is not None) == (scan_kernel == "pallas")
            assert routes.kernel_calls > 0
        finally:
            jx.reset()
            jx.close()
        return
    routes = _run_case(tmp_path, monkeypatch, data, scan_kernel, None, 0, 40000, queries)
    assert routes.jax[64] == {"blockmax"}


@pytest.mark.parametrize("slack", [-1, 0, 1])
def test_twin_budget_edge(tmp_path, monkeypatch, mixed, slack):
    """``ISCC_SEARCH_UNPACKED_MAX_BYTES`` one byte below, at and above one
    256-bit shard's twin (8,192 rows x 256 bytes): below, that partition
    has no twin and serves through ``sharded_pm1_topk`` in the JAX engine
    and through the kernel route per shard in the port, and the narrower
    ones keep their twins; at and above, every partition takes the twin."""
    budget = 8192 * 256 + slack
    monkeypatch.setenv("ISCC_SEARCH_UNPACKED_MAX_BYTES", str(budget))
    assert di._unpacked_budget_bytes() == budget
    _, codes, lanes, _ = mixed
    routes = _run_case(tmp_path, monkeypatch, mixed, "pallas", None, 8, K, _queries(codes, lanes, 4, 2, seed=37),
                       budget=budget)
    assert routes.jax[256] == {"sharded_pm1_topk" if slack < 0 else "sharded_pallas_topk"}
    assert routes.port[256] == {f"kernel:{di.auto_phase1(6, 8)}" if slack < 0 else "sharded_pallas_topk"}
    assert routes.port[64] == routes.jax[64] == {"sharded_pallas_topk"}


def test_the_budget_defaults_to_the_jax_engines(monkeypatch):
    monkeypatch.delenv("ISCC_SEARCH_UNPACKED_MAX_BYTES", raising=False)
    assert di._unpacked_budget_bytes() == jax_di._unpacked_budget_bytes() == 9 * 1024**3


@pytest.mark.parametrize("rows", [1, 8192, 40000, 65536, 131072, 720896])
@pytest.mark.parametrize("count", [1, 10, 100, 32768, 40000, 70000])
def test_scan_k_is_the_jax_engines(rows, count):
    """``_scan_k`` against the k of the JAX engine's inline sizing
    (``:826-839`` on one device; on a mesh the per-shard rows are a power
    of two), whatever chunk the JAX engine grows for it."""
    assert di._scan_k(rows, count) == _jax_chunk_and_k(rows, count)[1] == min(jax_di._pow2ceil(count), rows)


# ------------------------------------------ tests/test_branch_cov7.py:18-40


@pytest.mark.parametrize("scan_kernel", ["auto", "pallas", "xla"])
def test_engine_recall_target_scan_path(tmp_path, scan_kernel):
    """``test_branch_cov7.py``'s recall case on the port: a planted exact
    match at rank 0 with its true score, through the kernel route under
    every value (the JAX engine's ``"approx"`` route is exact off a TPU)."""
    rng = np.random.default_rng(77)
    idx = CpuIndex(tmp_path / "i", recall_target=0.95, scan_kernel=scan_kernel)
    assert idx.recall_target == 0.95
    bodies = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(4096)]
    idx.add(list(range(4096)), bodies)
    seen = []
    real = di.blockmax_topk_packedq_impl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(di, "blockmax_topk_packedq_impl", lambda *a, phase1, **kw: seen.append(phase1) or real(
            *a, phase1=phase1, **kw))
        keys, scores = idx.search([bodies[1234]], count=8)[0]
    assert seen == [di.auto_phase1(1, 8)]
    assert scores[0] == pytest.approx(1.0, abs=2e-3)
    assert int.from_bytes(bytes(keys[0][: idx.key_bytes]), "big") == 1234
    assert idx.search_one(bodies[1234], count=3)[1234] == pytest.approx(1.0, abs=2e-3)
    idx.close()


@pytest.mark.parametrize("recall", [1.0, 1.5, None, 0.5])
def test_recall_target_one_means_exact(tmp_path, recall):
    """``recall_target >= 1.0`` normalizes to None, as in the JAX engine."""
    idx = CpuIndex(tmp_path / "i", recall_target=recall)
    jx = jax_di.DeviceNphdIndex(tmp_path / "j", recall_target=recall)
    assert idx.recall_target == jx.recall_target == (recall if recall is not None and recall < 1.0 else None)
    idx.close()
    jx.close()


# ----------------------------------------- tests/test_branch_cov19.py:198


@pytest.mark.parametrize("scan_kernel", ["pallas", "xla"])
def test_mesh_with_recall_target_keeps_the_exact_routes(tmp_path, monkeypatch, scan_kernel):
    """``test_branch_cov19.py``'s mesh + recall case on the port (8 CPU
    shards, 32,768 256-bit rows): the JAX engine routes a recall target to
    ``sharded_pm1_topk``; the port keeps its exact routes, the twin per
    shard under ``"pallas"`` and the kernel route per shard under
    ``"xla"``. Both find the planted row."""
    rng = np.random.default_rng(96)
    n = 8 * 4096
    packed = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    keys = np.frombuffer(np.arange(n, dtype=">u8").tobytes(), np.uint8).reshape(-1, 8)
    monkeypatch.setenv("ISCC_SEARCH_UNPACKED_MAX_BYTES", str(10 * n * 256))
    idx = CpuIndex(tmp_path / "i", mesh=parallel.make_mesh(devices=CPU8), scan_kernel=scan_kernel,
                   recall_target=0.99, shard_size=1 << 30)
    idx.add_packed(keys, packed, 8)
    routes = Routes(monkeypatch)
    res = idx.search([packed[3].astype(">u4").tobytes()], 3)
    assert res[0][1][0] == pytest.approx(1.0, abs=1e-3)
    assert int.from_bytes(res[0][0][0].tobytes(), "big") == 3
    assert routes.port[256] == {f"kernel:{di.auto_phase1(1, 8)}" if scan_kernel == "xla" else "sharded_pallas_topk"}
    idx.close()


# ------------------------------------------------- options and serving


@pytest.mark.parametrize("scan_kernel", ["pallas", "xla"])
def test_tpu_index_takes_the_jax_scan_kernel_values(tmp_path, monkeypatch, scan_kernel):
    """``ISCC_SEARCH_SCAN_KERNEL`` with a JAX value reaches every unit
    engine of ``TpuIndex`` unchanged; with ``ISCC_SEARCH_MESH_DEVICES=8`` on
    the CPU the ``"pallas"`` partitions carry the twin and a search takes
    ``sharded_pallas_topk``, the ``"xla"`` ones the kernel route per shard."""
    from iscc_search_tpu_torch import options
    from iscc_search_tpu_torch.indexes.tpu import TpuIndex
    from iscc_search_tpu_torch.schema import IsccEntry, IsccQuery
    from tests.test_torch_backend import corpus, wire

    monkeypatch.setattr(options, "search_opts", options.SearchOptions.from_env({
        "ISCC_SEARCH_SCAN_KERNEL": scan_kernel, "ISCC_SEARCH_MESH_DEVICES": "8", "ISCC_SEARCH_SEARCH_BATCHING": "0"}))
    idx = TpuIndex(tmp_path / "m", device="cpu")
    entries = [IsccEntry(**wire(a)) for a in corpus(5, 12)]
    idx.add_assets(entries)
    routes = Routes(monkeypatch)
    res = idx.search_assets(IsccQuery(units=entries[7].units), limit=5)
    assert res.global_matches[0].iscc_id == entries[7].iscc_id
    engines = list(idx._nphd_indexes.values())
    assert engines and all(e.scan_kernel == scan_kernel and e.mesh.size == 8 for e in engines)
    assert all((p.unpacked_dev is not None) == (scan_kernel == "pallas") for e in engines for p in e._partitions.values())
    taken = set().union(*routes.port.values())
    if scan_kernel == "pallas":
        assert taken == {"sharded_pallas_topk"}
    else:
        assert taken and all(route.startswith("kernel:") for route in taken), taken
    idx.close()


# serve() with a counter on the engine's two mesh routes, printed at exit.
SERVE_COUNTING = (
    "import atexit, collections; from iscc_search_tpu_torch.engine import device_index as di; seen = collections.Counter()\n"
    "def counting(name, fn):\n"
    "    def call(*args, **kwargs):\n"
    "        seen[name] += 1\n"
    "        return fn(*args, **kwargs)\n"
    "    return call\n"
    "for name in ('sharded_pallas_topk', 'blockmax_topk_packedq_impl'):\n"
    "    setattr(di, name, counting(name, getattr(di, name)))\n"
    "atexit.register(lambda: print('ROUTES', dict(seen), flush=True))\n"
    "serve(device='cpu')"
)


@pytest.mark.parametrize("scan_kernel", ["pallas", "xla"])
def test_serve_starts_with_the_jax_scan_kernel_values(tmp_path, scan_kernel):
    """``serve()`` in a subprocess with ``ISCC_SEARCH_SCAN_KERNEL`` set to a
    JAX value and ``ISCC_SEARCH_MESH_DEVICES=8`` (8 CPU shards): it starts,
    answers a unit search over HTTP through the route the value names, and
    exits 0 on SIGTERM."""
    import signal

    from iscc_search_tpu_torch.remote import RemoteIndex
    from iscc_search_tpu_torch.schema import IsccEntry, IsccIndex, IsccQuery
    from tests.test_torch_server import make_assets
    from tests.test_torch_transport import _serve_process

    proc, url = _serve_process(f"tpu://{tmp_path / 'data'}", SERVE_COUNTING, ISCC_SEARCH_SCAN_KERNEL=scan_kernel,
                               ISCC_SEARCH_MESH_DEVICES="8", ISCC_SEARCH_SEARCH_BATCHING="false")
    try:
        assets = make_assets(5)
        client = RemoteIndex(url, "alpha")
        client.create_index(IsccIndex(name="alpha"))
        client.add_assets("alpha", [IsccEntry(**a) for a in assets])
        res = client.search_assets("alpha", IsccQuery(units=assets[2]["units"]), limit=5)
        assert res.global_matches[0].iscc_id == assets[2]["iscc_id"]
        client.close()
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=60)[0].decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-2000:]
    routes = eval(out[out.index("ROUTES ") + 7 :].splitlines()[0])
    assert set(routes) == {"sharded_pallas_topk" if scan_kernel == "pallas" else "blockmax_topk_packedq_impl"}, routes


# ------------------------------------------------- chip_smoke.py [knobs]


def test_chip_smoke_knobs_phase_on_the_cpu():
    """``chip_smoke.py``'s ``[knobs]`` at a tiny size on the CPU: 3,000
    rows of config 3's length mix, 1/64 removed, 8 queries. The phase makes
    its own checks (every route's answers against ``"auto"``'s and brute
    force; every route reaching the kernels ``auto_phase1`` names); on the
    CPU nothing is launched."""
    import importlib.util

    from tests.test_torch_engine_sharded import REPO

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert [r[:2] for r in mod.KNOB_ROUTES] == [("xla", None), ("xla", 0.9), ("pallas", None), ("auto", 0.9)]
    dev, n, nq = torch.device("cpu"), 3000, 8
    rng = np.random.default_rng(0)
    codes, lanes = mod.random_codes(rng, n)
    single = CpuIndex()
    single.add_packed(np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8), codes, lanes)
    removed = np.arange(0, n, mod.TOMBSTONE_EVERY)
    single.remove(removed.tolist())
    valid = np.ones(n, bool)
    valid[removed] = False
    q_rows = np.arange(nq) * (n // nq) // mod.TOMBSTONE_EVERY * mod.TOMBSTONE_EVERY + 1
    queries = mod.bodies_of(codes[q_rows], lanes[q_rows])
    sample = np.arange(nq)
    ref = mod.brute_force(dev, codes[q_rows[sample]], lanes[q_rows[sample]], codes, lanes, valid)
    oracle = (q_rows, valid, ref.numpy(), torch.topk(ref, mod.K, dim=1).values.numpy(), sample)
    routes = [(kernel, recall, tuple((min(q, nq), count) for q, count in batch))
              for kernel, recall, batch in mod.KNOB_ROUTES]
    launches = mod.phase_knobs(dev, single, queries, oracle, routes=routes, reps=1)
    assert launches == dict.fromkeys(mod.PATH_KERNELS, 0)


def test_xla_lowers_the_approx_route_to_an_exact_top_k_off_a_tpu():
    """The evidence for serving ``recall_target`` exactly: off a TPU, XLA
    lowers ``approx_max_k`` (the JAX engine's ``"approx"`` route) to its
    fallback, an exact top-k (``is_fallback = true``), equal to
    ``lax.top_k``."""
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 32768)).astype(np.float32))
    approx = jax.jit(lambda v: jax.lax.approx_max_k(v, 16, recall_target=0.9))
    assert "is_fallback = true" in approx.lower(x).as_text()
    (s, i), (ws, wi) = approx(x), jax.lax.top_k(x, 16)
    np.testing.assert_array_equal(np.asarray(s), np.asarray(ws))
    np.testing.assert_array_equal(np.asarray(i), np.asarray(wi))
