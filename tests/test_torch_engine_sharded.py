"""``DeviceNphdIndex(mesh=...)`` and ``TpuIndex(mesh_devices=...)`` of the
port against the port without a mesh and against the JAX package's mesh
path (CPU: 8 CPU shards, or a ``(2, 4)`` 2-D mesh, against JAX's 8 virtual
CPU devices).

- The cases of ``tests/test_engine_sharded.py`` compiled against the port
  (``tests/test_torch_parallel._jax_cases``; the indexes take
  ``device="cpu"``), ``scan_kernel="pallas"``'s two among them: the
  partitions carry the int8 twin per shard and searches take
  ``sharded_pallas_topk`` (``tests/test_torch_knobs.py`` holds the route).
  Left out, with its port version:
  ``test_partition_penalty_memo_reuse_and_invalidation`` (the port's kernels
  read the validity mask, there is no penalty row to memoize:
  ``test_every_sync_rebuilds_the_shards``).
- The engine with a mesh equals the engine without one (the same score
  multiset per query, every key carries its brute-force score, no removed
  key), also where ``merge_k`` exceeds the per-shard ``k`` and where shards
  hold no valid row; and the JAX engine on its mesh by the parity rule (one
  ulp where a common prefix is not a power of two).
- ``TpuIndex(device="cpu", mesh_devices=8).search_assets`` equals the JAX
  ``TpuIndex(mesh_devices=8)`` by ``model_dump()`` on one request sequence.
- ``chip_smoke.py``'s ``[mesh]`` phase at a tiny size: two gloo processes x
  4 CPU shards, each uploading only its own row block, whose
  ``hier_pm1_topk`` and engine answers equal one process's and the JAX
  ``(2, 4)`` mesh's, and a one-process group beside them (gloo here, NCCL on
  a card). Its processes are bounded by 120 s: a hang fails the test.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iscc_search_tpu import parallel as jax_parallel
from iscc_search_tpu import schema as jax_schema
from iscc_search_tpu.engine import DeviceNphdIndex as JaxNphdIndex
from iscc_search_tpu.indexes.tpu import TpuIndex as JaxTpuIndex
from iscc_search_tpu.ops import pm1_scan as jax_pm1
from iscc_search_tpu_torch import parallel, schema
from iscc_search_tpu_torch.engine import DeviceNphdIndex, device_index
from iscc_search_tpu_torch.indexes.tpu import TpuIndex
from iscc_search_tpu_torch.ops.packing import pack_codes
from tests.test_torch_backend import _answers, corpus, wire
from tests.test_torch_ops import _brute_force
from tests.test_torch_parallel import CPU8, _jax_cases

REPO = Path(__file__).resolve().parents[1]
CpuIndex = functools.partial(DeviceNphdIndex, device="cpu")

ENGINE = ["test_sharded_engine_matches_single_device", "test_sharded_engine_update_remove",
          "test_mesh_of_one_disables_sharding", "test_tpu_index_with_mesh_option",
          "test_sharded_engine_keeps_pallas_fast_path", "test_sharded_engine_tombstones_respected_on_pallas_path",
          "Test2DMesh", "mesh"]
globals().update(_jax_cases(
    "test_engine_sharded", ENGINE, overrides={"DeviceNphdIndex": CpuIndex},
    replace=[('TpuIndex(tmp_path / "m", mesh_devices=8,', 'TpuIndex(tmp_path / "m", device="cpu", mesh_devices=8,')],
))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Test files run in parallel processes: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_loaded_cases_are_the_ports():
    cases = _jax_cases("test_engine_sharded", ["test_sharded_engine_update_remove"], overrides={"DeviceNphdIndex": CpuIndex})
    body = cases["test_engine_sharded__sharded_engine_update_remove"]
    assert body.__globals__["DeviceNphdIndex"] is CpuIndex and body.__globals__["make_mesh"] is parallel.make_mesh
    text = (REPO / "tests" / "test_engine_sharded.py").read_text()
    assert all(f"def {t}(" in text or f"class {t}:" in text for t in ENGINE)


def _data(seed, n, lane_choices=(2, 4, 6, 8)):
    rng = np.random.default_rng(seed)
    bodies = [rng.integers(0, 256, 4 * int(rng.choice(lane_choices)), dtype=np.uint8).tobytes() for _ in range(n)]
    removed = sorted(set(rng.integers(0, n, n // 9).tolist()))
    queries = [bodies[i] for i in (3, 44, 100, 250)] + [bodies[3][:8], bodies[44][:12]]
    return bodies, removed, queries


def _answers_of(index, queries, count):
    return [(k.view(">u8").ravel().astype(np.int64), s) for k, s in index.search(queries, count)]


def _check_same(got, want, bodies, queries, removed):
    """Same score multiset per query; every key (its row's body) carries
    its brute-force score; no removed key; no key twice."""
    q_codes, q_lanes = pack_codes(queries)
    codes, lanes = pack_codes(bodies)
    valid = np.ones(len(bodies), bool)
    valid[removed] = False
    ref = _brute_force(q_codes, q_lanes, codes, lanes, valid)
    for qi, ((gk, gs), (wk, ws)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.sort(gs), np.sort(ws))
        assert len(set(gk.tolist())) == len(gk) and valid[gk].all()
        np.testing.assert_allclose(ref[qi, gk], gs, rtol=0, atol=1e-6)


@pytest.mark.parametrize("grid", ["1d", "2d"])
def test_mesh_engine_equals_no_mesh(monkeypatch, grid):
    """At a per-shard capacity floor of 128 rows: 1,100 rows over 8 shards
    leave shards without a valid row in every partition, and a count of 300
    takes ``merge_k`` = 512 above the per-shard ``k`` = 128 (JAX's
    ``:897-899``). Tombstones, an append, a second sync."""
    monkeypatch.setattr(device_index, "_MIN_DEVICE_ROWS", 128)
    mesh = parallel.make_mesh(devices=CPU8) if grid == "1d" else parallel.make_mesh_2d(2, 4, devices=CPU8)
    bodies, removed, queries = _data(11, 1100)
    removed = [r for r in removed if r < 1000]
    plain, meshed = CpuIndex(), CpuIndex(mesh=mesh)
    for index in (plain, meshed):
        index.add(list(range(1000)), bodies[:1000])
        index.remove(removed)
    parts = meshed._sync_device()
    assert all(len(p.packed_dev) == 8 and p.cap // 8 == 128 for p in parts.values())
    assert any(not v.any() for p in parts.values() for v in p.valid_dev)  # a shard with no valid row
    for count in (7, 300):
        _check_same(_answers_of(meshed, queries, count), _answers_of(plain, queries, count), bodies[:1000], queries,
                    removed)
    for index in (plain, meshed):
        index.add(list(range(1000, 1100)), bodies[1000:])
    got, want = _answers_of(meshed, queries, 300), _answers_of(plain, queries, 300)
    assert all(len(g[0]) == len(w[0]) == 300 for g, w in zip(got, want))
    _check_same(got, want, bodies, queries, removed)


def test_mesh_engine_equals_the_jax_mesh_engine(tmp_path):
    """Both packages' engines on 8 shards, the same adds and removes: the
    same scores by the parity rule, every key its brute-force score."""
    bodies, removed, queries = _data(12, 700)
    port = CpuIndex(mesh=parallel.make_mesh(devices=CPU8))
    jax_index = JaxNphdIndex(tmp_path / "jax", mesh=jax_parallel.make_mesh(8))
    for index in (port, jax_index):
        index.add(list(range(700)), bodies)
        index.remove(removed)
    for count in (5, 40):
        got = _answers_of(port, queries, count)
        want = _answers_of(jax_index, queries, count)
        for (gk, gs), (_, ws) in zip(got, want):
            np.testing.assert_array_max_ulp(np.sort(gs), np.sort(ws), maxulp=1)
        _check_same(got, got, bodies, queries, removed)
    jax_index.close()


def test_each_shard_runs_the_single_device_scan(monkeypatch):
    """Per partition, one call of the single-device step per shard, on that
    shard's rows, with the phase-1 kernel ``"auto"`` names for the batch."""
    monkeypatch.setattr(device_index, "_MIN_DEVICE_ROWS", 128)
    seen = []
    real = device_index.blockmax_topk_packedq_impl

    def spy(q_packed, q_lanes, packed, valid, k, nbits, phase1):
        seen.append((packed.data_ptr(), k, nbits, phase1))
        return real(q_packed, q_lanes, packed, valid, k, nbits, phase1=phase1)

    monkeypatch.setattr(device_index, "blockmax_topk_packedq_impl", spy)
    bodies, removed, queries = _data(13, 600, lane_choices=(2, 8))
    index = CpuIndex(mesh=parallel.make_mesh(devices=CPU8))
    index.add(list(range(600)), bodies)
    index.search(queries, 20)
    parts = index._sync_device()
    assert sorted(seen) == sorted(
        (shard.data_ptr(), 32, lanes * 32, device_index.auto_phase1(len(queries), lanes))
        for lanes, p in parts.items() for shard in p.packed_dev
    )


def test_every_sync_rebuilds_the_shards():
    """With a mesh, a remove or an add rebuilds every partition (equal
    blocks per shard); the rebuilt validity holds the removal."""
    index = CpuIndex(mesh=parallel.make_mesh(devices=CPU8))
    bodies, _, _ = _data(14, 300, lane_choices=(2,))
    index.add(list(range(300)), bodies)
    before = index._sync_device()[2]
    assert sum(int(v.sum()) for v in before.valid_dev) == 300
    index.remove([5])
    after = index._sync_device()[2]
    assert after is not before and sum(int(v.sum()) for v in after.valid_dev) == 299
    assert 5 not in index.search_one(bodies[5], 3)
    index.add([5], [bodies[5]])
    assert index._sync_device()[2] is not after and index.search_one(bodies[5], 1) == {5: 1.0}


def test_tpu_index_with_a_mesh_equals_the_jax_index_with_a_mesh(tmp_path):
    """One request sequence (units, INSTANCE prefixes, simprints, ISCC-IDs
    at limits 3 and 20, scan and exact) through both packages' ``TpuIndex``
    with ``mesh_devices=8``: equal by ``model_dump()``."""
    assets = corpus()
    jx = JaxTpuIndex(tmp_path / "jax", mesh_devices=8, search_batching=False)
    pt = TpuIndex(tmp_path / "port", device="cpu", mesh_devices=8, search_batching=False)
    for index, entry in ((jx, jax_schema.IsccEntry), (pt, schema.IsccEntry)):
        index.add_assets([entry(**wire(a)) for a in assets])
    assert all(p.mesh.size == 8 for p in pt._nphd_indexes.values())
    assert _answers(pt, schema.IsccQuery, assets) == _answers(jx, jax_schema.IsccQuery, assets)
    jx.close()
    pt.close()


def test_chip_smoke_mesh_phase_on_two_gloo_processes(tmp_path):
    """``[mesh]`` at a tiny size on the CPU: 8 shards in this process, 2
    gloo processes x 4 CPU shards, and a one-process group. The phase makes
    its own checks (every answer against the single-device index and brute
    force; the clusters' against one process's); here the clusters'
    answers also meet the JAX ``(2, 4)`` mesh's."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert (mod.MESH_SHARDS, mod.MESH_CHIPS, mod.MESH_QS, mod.MESH_LIMIT) == (4, 2, (512, 32, 1), 100)
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

    launches, kernel4, outs = mod.phase_mesh(dev, single, queries, oracle, tmp_path, shards=8, chips=4, qs=(nq, 3, 1),
                                             limit=40, chunk=128, timeout=120, reps=1)
    assert set(outs) == {(0, 2), (1, 2), (0, 1)} and all(report["backend"] == "gloo" for _, report in outs.values())
    assert set(launches) == {*mod.PATH_KERNELS, "blockmax_mma_unpacked"} and all(e["max_abs_err"] == 0.0 for e in kernel4)
    # The clusters' answers against the JAX (2, 4) mesh.
    data = tmp_path / "mesh"
    pm1_packed, pm1_valid = np.load(data / "pm1_packed.npy"), np.load(data / "pm1_valid.npy")
    q_codes, q_lanes = pack_codes(queries)
    jm = jax_parallel.make_mesh_2d(2, 4)
    gc, _, gv = jax_parallel.shard_database_2d(jm, jnp.asarray(pm1_packed), jnp.asarray(np.full(len(pm1_valid), 8, np.int32)),
                                               jnp.asarray(pm1_valid))
    jq = [jnp.asarray(x) for x in jax_pm1.prepare_queries(q_codes, q_lanes, 256)]
    want_s, _ = jax_parallel.hier_pm1_topk(jm, *jq, gc, gv, mod.K, 256, chunk_size=128)
    out, _ = outs[0, 2]
    np.testing.assert_array_max_ulp(np.sort(out["pm1_scores"], axis=1), np.sort(np.asarray(want_s), axis=1), maxulp=1)
    jax_index = JaxNphdIndex(tmp_path / "jax", mesh=jm)
    jax_index.add(list(range(n)), mod.bodies_of(codes, lanes))
    jax_index.remove(removed.tolist())
    for nq_, count in ((nq, mod.K), (3, mod.K), (1, mod.K), (3, 40)):
        want = jax_index.search(queries[:nq_], count)
        got = out[f"scores_{nq_}_{count}"]
        for qi, (_, ws) in enumerate(want):
            np.testing.assert_array_max_ulp(np.sort(got[qi][~np.isnan(got[qi])]), np.sort(ws), maxulp=1)
    jax_index.close()
