"""``iscc_search_tpu_torch/parallel/*`` and the scans it steps per shard
(``ops/pm1_scan.py``) against ``iscc_search_tpu/parallel/*`` (CPU).

The JAX side runs on its 8 virtual CPU devices (``tests/conftest.py``), with
Pallas in interpret mode; the port's side runs on 8 CPU shards
(``devices=[cpu] * 8``) or on a ``(2, 4)`` 2-D mesh in one process, where
every wrapper takes its plain version.

- Parity, function by function, on the same seeded numpy inputs, by the
  ROADMAP parity rule: the same score multiset per query, every returned
  row carries its brute-force score (atol 1e-6), -1 exactly where the
  score is NEG_SCORE; tie order is not compared. Where both sides merge the
  same distinct candidates (``merge_topk``) the rows are equal too.
- The in-process cases of ``tests/test_parallel.py``,
  ``test_parallel_edges.py``, ``test_pm1_sharded.py`` and
  ``test_multihost.py`` compiled against the port (``_jax_cases``):
  ``jnp.asarray`` becomes a numpy -> torch conversion and each mesh is built
  over 8 CPU shards. Left out, each with its port version here:
  ``test_init_distributed_passes_cluster_args`` and
  ``test_init_distributed_explicit_process_id_zero`` (they patch
  ``jax.distributed.initialize``: ``test_init_distributed_*`` patch
  ``TCPStore`` and ``init_process_group``), both
  ``test_global_mesh_spans_all_devices`` and
  ``test_make_mesh_defaults_to_all_devices`` (they count ``jax.devices()``:
  ``test_default_meshes``), and ``test_multihost.py``'s two slow
  multi-process cases (the two gloo processes of
  ``tests/test_torch_engine_sharded.py``, and the product cluster of
  ``tests/test_torch_multihost.py``).
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from iscc_search_tpu import parallel as jax_parallel
from iscc_search_tpu.ops import pm1_scan as jax_pm1
from iscc_search_tpu.parallel import merge as jax_merge
from iscc_search_tpu.parallel import pallas_sharded as jax_pallas_sharded
from iscc_search_tpu.parallel import pm1_sharded as jax_pm1_sharded
from iscc_search_tpu_torch import parallel
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops import pm1_scan
from iscc_search_tpu_torch.ops.nphd import NEG_SCORE
from iscc_search_tpu_torch.parallel import distributed, hier, merge, mesh as port_mesh
from iscc_search_tpu_torch.parallel import pallas_sharded, pm1_sharded
from tests.test_torch_ops import _assert_topk_parity, _brute_force, _codes, _t

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

REPO = Path(__file__).resolve().parents[1]
CPU8 = [torch.device("cpu")] * 8


class _Jnp:
    """``jnp`` of the compiled JAX cases: ``asarray`` makes the port's
    tensors (uint32 codes as their int32 bits)."""

    @staticmethod
    def asarray(a):
        if isinstance(a, torch.Tensor):
            return a
        a = np.ascontiguousarray(a)
        return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a).copy())


def _jax_cases(name, tests, overrides=None, replace=()):
    """The named tests of ``tests/<name>.py`` compiled against the port:
    ``iscc_search_tpu.`` read as ``iscc_search_tpu_torch.``, ``jnp`` as
    :class:`_Jnp`, and every ``make_mesh(...)`` / ``make_mesh_2d(...)`` call
    given ``devices=CPU8``. Each ``(text, new)`` of ``replace``, which
    occurs once, is put in first; ``overrides`` replace module globals after
    the module runs. Tests are renamed ``test_<name>__<test>``, classes
    ``Test<Name>__<class>``; fixtures keep their names."""
    path = REPO / "tests" / f"{name}.py"
    source = path.read_text()
    for text, new in replace:
        assert source.count(text) == 1, text
        source = source.replace(text, new)
    source = source.replace("import jax.numpy as jnp\n", "")
    source = re.sub(
        r"\b(make_mesh(?:_2d)?)\(([^()]*)\)",
        lambda m: f"{m[1]}({m[2]}{', ' if m[2] else ''}devices=_CPU8)",
        source,
    ).replace("iscc_search_tpu.", "iscc_search_tpu_torch.")
    namespace = {"__name__": f"{__name__}.{name}", "__file__": str(path), "jnp": _Jnp, "_CPU8": CPU8}
    exec(compile(source, str(path), "exec"), namespace)
    namespace.update(overrides or {})
    out = {}
    for t in tests:
        if t.startswith("Test"):
            out[f"Test{name[5:].title().replace('_', '')}__{t[4:]}"] = namespace[t]
        elif t.startswith("test_"):
            out[f"test_{name[5:]}__{t[5:]}"] = namespace[t]
        else:
            out[t] = namespace[t]
    return out


PARALLEL = ["test_mesh_has_8_devices", "test_sharded_topk_matches_brute_force", "test_sharded_topk_fewer_valid_than_k",
            "test_shard_database_rejects_uneven", "test_init_distributed_single_host_noop", "mesh"]
EDGES = ["test_make_mesh_too_many_devices", "test_make_mesh_2d_explicit_and_default", "test_make_mesh_2d_indivisible_hosts",
         "test_make_mesh_2d_over_capacity", "test_shard_database_2d_indivisible_rows", "test_int_env_parsing"]
PM1 = ["test_sharded_pm1_matches_brute_force", "test_sharded_pm1_variable_length", "test_sharded_pm1_blockmax_path"]
MULTIHOST = ["test_mesh2d_shape", "test_mesh2d_rejects_oversubscription", "test_hier_topk_matches_brute_force",
             "test_hier_topk_matches_flat_jax_mirror", "test_hier_pm1_topk_matches_brute_force",
             "test_hier_merge_k_wider_than_k", "test_shard_database_2d_rejects_uneven",
             "test_brute_force_mirror_agrees_with_jax_scores"]


# The fixtures `mesh` (test_parallel.py and test_pm1_sharded.py alike) and `mesh2d` come along.
globals().update(_jax_cases("test_parallel", PARALLEL))
globals().update(_jax_cases("test_parallel_edges", EDGES))
globals().update(_jax_cases("test_pm1_sharded", PM1))
globals().update(_jax_cases("test_multihost", MULTIHOST + ["mesh2d"]))


def test_the_loaded_cases_are_the_ports():
    cases = _jax_cases("test_multihost", ["test_hier_topk_matches_brute_force"])
    body = cases["test_multihost__hier_topk_matches_brute_force"]
    assert body.__globals__["hier_topk"] is parallel.hier_topk and body.__globals__["jnp"] is _Jnp
    for name, tests in (("test_parallel", PARALLEL), ("test_parallel_edges", EDGES), ("test_pm1_sharded", PM1),
                        ("test_multihost", MULTIHOST)):
        text = (REPO / "tests" / f"{name}.py").read_text()
        assert all(f"def {t}(" in text for t in tests)


# ------------------------------------------------------------------ meshes


def test_default_meshes(monkeypatch):
    """``make_mesh()`` takes every CUDA device and raises without one;
    ``device="cpu"`` gives the asked shard count on the CPU; an explicit
    list is taken as given, repeats included (several shards on one card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh_2d(2)
    assert parallel.make_mesh(device="cpu").size == 1
    assert parallel.make_mesh(8, device="cpu").devices == CPU8
    assert parallel.make_mesh(devices=CPU8).shape == {"shards": 8}
    grid = parallel.make_mesh_2d(2, 4, device="cpu")
    assert grid.shape == {"dcn": 2, "ici": 4} and grid.local_shape == (2, 4) and grid.group is None
    assert parallel.make_mesh_2d(2, device="cpu").shape == {"dcn": 2, "ici": 1}
    global_mesh = distributed.global_mesh(device="cpu")
    assert global_mesh.size == 1 and global_mesh.group is None
    with pytest.raises(ValueError, match="no mesh over device type"):
        parallel.make_mesh(2, device="meta")


def test_place_rows_and_process_row_block():
    """Host-major blocks, uint32 codes as int32 bits, bool validity as
    uint8; uneven rows raise as in JAX."""
    grid = parallel.make_mesh_2d(2, 4, device="cpu")
    codes = np.arange(64 * 8, dtype=np.uint32).reshape(64, 8) * np.uint32(2**27)
    shards = port_mesh.place_rows(grid, codes)
    assert len(shards) == 8 and all(s.dtype == torch.int32 and s.shape == (8, 8) for s in shards)
    np.testing.assert_array_equal(torch.cat(shards).numpy().view(np.uint32), codes)
    valid = port_mesh.place_rows(grid, np.arange(64) % 3 == 0)
    assert valid[1].dtype == torch.uint8 and valid[1].tolist() == [int(i % 3 == 0) for i in range(8, 16)]
    assert port_mesh.process_row_block(grid, 64) == (0, 64)
    with pytest.raises(ValueError, match="not divisible by 8 shards"):
        port_mesh.place_rows(grid, codes[:60])
    assert [s.shape[0] for s in hier.make_global_array(grid, codes, codes.shape)] == [8] * 8
    with pytest.raises(ValueError, match="local rows"):
        hier.make_global_array(grid, codes[:32], codes.shape)


# ----------------------------------------------------------- merge parity


def _jax_merge(axes, jmesh, scores, idx, local_rows, merge_k):
    """JAX ``lift_rows`` + ``merge_topk`` over the shard-stacked (n*Q, k) inputs."""
    def local(s, i):
        return jax_merge.merge_topk(s, jax_merge.lift_rows(i, local_rows, axes), axes, merge_k)

    kwargs = dict(mesh=jmesh, in_specs=(P(axes), P(axes)), out_specs=(P(), P()))
    try:
        fn = shard_map(local, check_vma=False, **kwargs)
    except TypeError:  # pragma: no cover - older jax spelling
        fn = shard_map(local, check_rep=False, **kwargs)
    return [np.asarray(x) for x in jax.jit(fn)(jnp.asarray(scores), jnp.asarray(idx))]


@pytest.mark.parametrize("shape,k,merge_k", [((8,), 6, 6), ((8,), 4, 20), ((2, 4), 6, 6), ((2, 4), 4, 20), ((2, 4), 8, 3)])
def test_merge_topk_and_lift_rows_equal_jax(shape, k, merge_k):
    """Distinct candidate scores (so rows compare too), a shard with no
    candidate at all and padded slots (-1 / NEG_SCORE) kept as in JAX."""
    rng = np.random.default_rng(sum(shape) + k + merge_k)
    n, q, local_rows = 8, 5, 1000
    scores = rng.permutation(n * q * k).astype(np.float32).reshape(n, q, k) / (n * q * k)
    scores = -np.sort(-scores, axis=2)
    idx = rng.integers(0, local_rows, (n, q, k)).astype(np.int32)
    scores[3], idx[3] = NEG_SCORE, -1  # a shard that holds no valid row
    scores[5, :, k // 2 :], idx[5, :, k // 2 :] = NEG_SCORE, -1
    if len(shape) == 1:
        jmesh, axes, port = jax_parallel.make_mesh(8), ("shards",), parallel.make_mesh(devices=CPU8)
    else:
        jmesh, axes, port = jax_parallel.make_mesh_2d(2, 4), ("dcn", "ici"), parallel.make_mesh_2d(2, 4, devices=CPU8)
    want_s, want_i = _jax_merge(axes, jmesh, scores.reshape(n * q, k), idx.reshape(n * q, k), local_rows, merge_k)
    lifted = [merge.lift_rows(torch.from_numpy(idx[i]), local_rows, merge.flat_shard_index(port, i)) for i in range(n)]
    got_s, got_i = merge.merge_topk([torch.from_numpy(s) for s in scores], lifted, port, merge_k)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert got_s.shape == (q, min(merge_k, n * k)) and (got_i.numpy() // local_rows != 3).all()


# ----------------------------------------------------------- scan parity


def _database(seed, n, lanes=None):
    rng = np.random.default_rng(seed)
    if lanes is None:
        codes, lanes_arr = _codes(rng, n)
    else:
        codes = np.zeros((n, 8), np.uint32)
        codes[:, :lanes] = rng.integers(0, 2**32, (n, lanes), dtype=np.uint32)
        lanes_arr = np.full(n, lanes, np.int32)
    valid = np.ones(n, bool)
    valid[rng.integers(0, n, n // 10)] = False
    valid[128:256] = False  # a dead block
    q_rows = rng.choice(np.flatnonzero(valid), 6, replace=False)
    q_codes, q_lanes = codes[q_rows].copy(), lanes_arr[q_rows].copy()
    q_lanes[-2:] = (1, 3)  # short queries against longer rows
    return codes, lanes_arr, valid, q_codes, q_lanes


def _assert_parity(got, want, ref, q_lanes, nbits):
    """``_assert_topk_parity``, with the parity rule's one ulp where a
    query's common prefix is not a power of two (XLA contracts the JAX
    phase-3 ``0.5 + dot * q_scale`` into one rounding in some programs)."""
    got_s, got_i = (t.numpy() for t in got)
    want_s, want_i = (np.asarray(t) for t in want)
    bits = np.minimum(q_lanes * 32, nbits)
    exact = (bits & (bits - 1)) == 0
    _assert_topk_parity(got_s[exact], got_i[exact], want_s[exact], want_i[exact], ref[exact])
    np.testing.assert_array_max_ulp(np.sort(got_s[~exact], axis=1), np.sort(want_s[~exact], axis=1), maxulp=1)
    _assert_topk_parity(got_s[~exact], got_i[~exact], got_s[~exact], got_i[~exact], ref[~exact])


@pytest.mark.parametrize("merge_k", [None, 24])
def test_sharded_topk_equals_jax(merge_k):
    codes, lanes, valid, qc, ql = _database(1, 8 * 256)
    jm = jax_parallel.make_mesh(8)
    want = jax_parallel.sharded_topk(jm, jnp.asarray(qc), jnp.asarray(ql), *jax_parallel.shard_database(
        jm, jnp.asarray(codes), jnp.asarray(lanes), jnp.asarray(valid)), 8, chunk_size=128, merge_k=merge_k)
    pm = parallel.make_mesh(devices=CPU8)
    got = parallel.sharded_topk(pm, _t(qc), _t(ql), *parallel.shard_database(pm, codes, lanes, valid), 8,
                                chunk_size=128, merge_k=merge_k)
    ref = _brute_force(qc, ql, codes, lanes, valid)
    _assert_topk_parity(got[0].numpy(), got[1].numpy(), *(np.asarray(w) for w in want), ref)


@pytest.mark.parametrize("nbits", [64, 256])
@pytest.mark.parametrize("recall_target,merge_k", [(None, None), (None, 40), (0.95, None)])
def test_sharded_pm1_topk_equals_jax(nbits, recall_target, merge_k):
    """The block-max scan per shard, and the chunked scan under a
    recall target (the port exact, JAX's approximate top-k exact on the CPU)."""
    codes, lanes, valid, qc, ql = _database(2, 8 * 1024, lanes=nbits // 32)
    packed = codes[:, : nbits // 32]
    jm, pm = jax_parallel.make_mesh(8), parallel.make_mesh(devices=CPU8)
    jq = jax_pm1.prepare_queries(qc, ql, nbits)
    want = jax_pm1_sharded.sharded_pm1_topk(
        jm, *(jnp.asarray(x) for x in jq), *jax_pm1_sharded.shard_pm1_database(jm, jnp.asarray(packed), jnp.asarray(valid)),
        10, nbits, chunk_size=256, recall_target=recall_target, merge_k=merge_k)
    q_pm1, q_scale = (torch.from_numpy(x) for x in pm1_scan.prepare_queries(qc, ql, nbits))
    got = pm1_sharded.sharded_pm1_topk(pm, q_pm1, q_scale, *pm1_sharded.shard_pm1_database(pm, packed, valid), 10, nbits,
                                       chunk_size=256, recall_target=recall_target, merge_k=merge_k)
    assert got[0].shape == (6, merge_k or 10)
    _assert_parity(got, want, _brute_force(qc, ql, codes, lanes, valid), ql, nbits)


@pytest.mark.parametrize("nbits", [64, 192])
def test_sharded_pallas_topk_equals_jax(nbits):
    """The int8-twin route per shard (TPU kernel 4 in interpret mode on the
    JAX side, ``blockmax_mma_unpacked``'s plain version here) + the merge;
    the port's twin built per shard equals JAX's."""
    codes, lanes, valid, qc, ql = _database(3, 8 * 1024, lanes=nbits // 32)
    packed = codes[:, : nbits // 32]
    jm, pm = jax_parallel.make_mesh(8), parallel.make_mesh(devices=CPU8)
    jpacked, jvalid = jax_pm1_sharded.shard_pm1_database(jm, jnp.asarray(packed), jnp.asarray(valid))
    jtwin = jax_pallas_sharded.shard_unpacked_db(jm, jpacked, nbits)
    jq = [jnp.asarray(x) for x in jax_pm1.prepare_queries(qc, ql, nbits)]
    want = jax_pallas_sharded.sharded_pallas_topk(jm, *jq, jpacked, jtwin, jvalid, 10, nbits, chunk_size=1024,
                                                  interpret=True, merge_k=16)
    ppacked, pvalid = pm1_sharded.shard_pm1_database(pm, packed, valid)
    twin = pallas_sharded.shard_unpacked_db(pm, ppacked, nbits)
    np.testing.assert_array_equal(torch.cat(twin).numpy(), np.asarray(jtwin))
    min_lanes, q_scale = pm1_scan.query_prefix(_t(ql), nbits)
    launches = hs.blockmax_mma_unpacked.launches
    got = pallas_sharded.sharded_pallas_topk(pm, _t(qc), min_lanes, q_scale, ppacked, twin, pvalid, 10, nbits, merge_k=16)
    assert hs.blockmax_mma_unpacked.launches == launches  # CPU shards: the plain version
    _assert_parity(got, want, _brute_force(qc, ql, codes, lanes, valid), ql, nbits)
    with pytest.raises(ValueError, match="needs the int8 twin"):
        pallas_sharded.sharded_pallas_topk(pm, _t(qc), min_lanes, q_scale, ppacked, None, pvalid, 10, nbits)


@pytest.mark.parametrize("merge_k", [None, 32])
def test_hier_topk_and_hier_pm1_topk_equal_jax(merge_k):
    codes, lanes, valid, qc, ql = _database(4, 8 * 256)
    jm, pm = jax_parallel.make_mesh_2d(2, 4), parallel.make_mesh_2d(2, 4, devices=CPU8)
    want = jax_parallel.hier_topk(jm, jnp.asarray(qc), jnp.asarray(ql), *jax_parallel.shard_database_2d(
        jm, jnp.asarray(codes), jnp.asarray(lanes), jnp.asarray(valid)), 10, chunk_size=128, merge_k=merge_k)
    got = parallel.hier_topk(pm, _t(qc), _t(ql), *parallel.shard_database_2d(pm, codes, lanes, valid), 10,
                             chunk_size=128, merge_k=merge_k)
    _assert_topk_parity(got[0].numpy(), got[1].numpy(), *(np.asarray(w) for w in want),
                        _brute_force(qc, ql, codes, lanes, valid))
    jq = [jnp.asarray(x) for x in jax_pm1.prepare_queries(qc, ql, 256)]
    gc, _, gv = jax_parallel.shard_database_2d(jm, jnp.asarray(codes), jnp.asarray(lanes), jnp.asarray(valid))
    want = jax_parallel.hier_pm1_topk(jm, *jq, gc, gv, 10, 256, chunk_size=128, merge_k=merge_k)
    q_pm1, q_scale = (torch.from_numpy(x) for x in pm1_scan.prepare_queries(qc, ql, 256))
    pc, _, pv = parallel.shard_database_2d(pm, codes, lanes, valid)
    got = parallel.hier_pm1_topk(pm, q_pm1, q_scale, pc, pv, 10, 256, chunk_size=128, merge_k=merge_k)
    full = _brute_force(qc, ql, codes, np.full(len(codes), 8, np.int32), valid)  # one 256-bit partition
    _assert_parity(got, want, full, ql, 256)


@pytest.mark.parametrize("nbits", [64, 128, 256])
@pytest.mark.parametrize("k,chunk", [(10, 256), (300, 128)])
def test_pm1_scans_equal_jax(nbits, k, chunk):
    """``pm1_topk_impl`` (k above the chunk: every row is a candidate) and
    the two packed-query scans, from packed queries of every length."""
    codes, lanes, valid, qc, ql = _database(5, 1024, lanes=nbits // 32)
    packed = codes[:, : nbits // 32]
    ref = _brute_force(qc, ql, codes, lanes, valid)
    q_pm1, q_scale = (torch.from_numpy(x) for x in pm1_scan.prepare_queries(qc, ql, nbits))
    jq = [jnp.asarray(x) for x in jax_pm1.prepare_queries(qc, ql, nbits)]
    pairs = [
        (pm1_scan.pm1_topk_impl(q_pm1, q_scale, _t(packed), _t(valid), k, nbits, chunk_size=chunk),
         jax_pm1.pm1_topk_impl(*jq, jnp.asarray(packed), jnp.asarray(valid), k, nbits, chunk_size=chunk)),
        (pm1_scan.pm1_topk_packedq_impl(_t(qc), _t(ql), _t(packed), _t(valid), k, nbits, chunk_size=chunk),
         jax_pm1.pm1_topk_packedq_impl(jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(packed), jnp.asarray(valid), k,
                                       nbits, chunk_size=chunk)),
        (pm1_scan.pm1_blockmax_topk_packedq_impl(_t(qc), _t(ql), _t(packed), _t(valid), k, nbits, chunk_size=chunk),
         jax_pm1.pm1_blockmax_topk_packedq_impl(jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(packed),
                                                jnp.asarray(valid), k, nbits, chunk_size=chunk)),
    ]
    for got, want in pairs:
        assert got[0].shape == (6, k)
        _assert_parity(got, want, ref, ql, nbits)


# ------------------------------------------------------------ distributed


def test_init_distributed_passes_cluster_args(monkeypatch):
    """The coordinator's address, the process count and the id reach the
    rendezvous store and ``init_process_group``; ``process_id=0`` is
    explicit and does not fall back to the environment; the backend is
    chosen from the processes' cards."""
    import torch.distributed as dist

    seen = {}

    class Store:
        def __init__(self, host, port, world, is_master, timeout):
            seen.update(host=host, port=port, world=world, master=is_master)
            self.kv = {}

        def set(self, key, value):
            self.kv[key] = value.encode()

        def get(self, key):
            return self.kv.get(key, b"")

    def init(backend, store, world_size, rank, timeout):
        seen.update(backend=backend, n=world_size, rank=rank)
        raise RuntimeError("stop before real networking")

    monkeypatch.setattr(dist, "TCPStore", Store)
    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setenv("ISCC_SEARCH_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("ISCC_SEARCH_NUM_HOSTS", "1")
    monkeypatch.setenv("ISCC_SEARCH_HOST_ID", "0")
    with pytest.raises(RuntimeError, match="stop before real networking"):
        distributed.init_distributed()
    assert seen == {"host": "10.0.0.1", "port": 1234, "world": 1, "master": True, "backend": "gloo", "n": 1, "rank": 0}
    monkeypatch.setenv("ISCC_SEARCH_HOST_ID", "3")
    monkeypatch.setattr(distributed, "_card_id", lambda: "host/card")
    with pytest.raises(RuntimeError):
        distributed.init_distributed("127.0.0.1:9999", 1, 0)
    assert (seen["rank"], seen["master"], seen["backend"]) == (0, True, "nccl")
    with pytest.raises(RuntimeError):
        distributed.init_distributed("127.0.0.1:9999", 2, 1)
    assert (seen["rank"], seen["n"], seen["master"], seen["backend"]) == (1, 2, False, "gloo")
    monkeypatch.delenv("ISCC_SEARCH_NUM_HOSTS")
    with pytest.raises(ValueError, match="process count"):
        distributed.init_distributed("127.0.0.1:9999")


@pytest.mark.parametrize("cards,want", [
    (["a/0", "b/0"], "nccl"), (["a/0", "a/0"], "gloo"), (["a/0", ""], "gloo"), (["", ""], "gloo"), (["a/0"], "nccl"),
])
def test_backend_choice(monkeypatch, cards, want):
    """NCCL only when every process has a card and no two share one (NCCL
    refuses two ranks on one card). This process is rank 0."""
    class Store(dict):
        def set(self, key, value):
            self[key] = value.encode()

        def get(self, key):
            return self[key]

    monkeypatch.setattr(distributed, "_card_id", lambda: cards[0])
    store = Store({f"iscc_card/{r}": c.encode() for r, c in enumerate(cards) if r})
    assert distributed._choose_backend(store, len(cards), 0) == want
