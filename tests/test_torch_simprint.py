"""The port's simprint stack against the JAX package's, on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages:

- the brute-force Hamming oracle (``ops/nphd.py`` ``hamming_scores``,
  ``ops/topk.py`` ``topk_scan_impl``, both metrics);
- ``DeviceHammingIndex``: the same adds, removes and searches give the same
  keys, scores and rows;
- ``SimprintEngine.search_raw_many`` with ``detailed=True`` and a real
  document-frequency function, at 64 and 128 bits: the same matches, scores
  bit for bit;
- the host store: a directory written by either package's ``HostStore``
  opens in the other.

Ties. ``torch.topk`` and ``lax.top_k`` order tied scores differently, so at
a candidate cut (``limit x oversampling_factor`` rows per chunk query) the
two packages may keep different rows of one tied score. The data here keeps
every such tie out of the results: either the count reaches every live row
(no cut), or the score at the cut lies below the match threshold, so the
rows a cut may drop never reach the asset scores. Planted near-duplicates
sit at distinct distances from their queries.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iscc_search_tpu.engine import simprint_ops as jax_ops
from iscc_search_tpu.engine.device_index import DeviceHammingIndex as JaxHammingIndex
from iscc_search_tpu.engine.simprint import SimprintEngine as JaxEngine
from iscc_search_tpu.ops import nphd as jax_nphd
from iscc_search_tpu.ops import topk as jax_topk
from iscc_search_tpu.store import HostStore as JaxStore
from iscc_search_tpu_torch.engine import DeviceHammingIndex
from iscc_search_tpu_torch.engine import simprint_ops as ops
from iscc_search_tpu_torch.engine.simprint import SimprintEngine
from iscc_search_tpu_torch.ops import nphd, topk
from iscc_search_tpu_torch.store import HostStore
from iscc_search_tpu_torch.store import kv


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs test files in parallel processes: each takes one torch
    thread, so the plain versions' CPU work does not starve the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    """numpy -> torch; uint32 codes travel as their int32 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def flip(vec, nbits, rng):
    """``vec`` (bytes) with ``nbits`` distinct bits flipped."""
    arr = np.frombuffer(vec, np.uint8).copy()
    for p in rng.choice(len(arr) * 8, nbits, replace=False):
        arr[p // 8] ^= 1 << (p % 8)
    return arr.tobytes()


def key(asset, offset, size=100):
    return ops.pack_chunk_pointer(int(asset).to_bytes(8, "big"), offset, size)


# ------------------------------------------------------------ the oracle


@pytest.mark.parametrize("ndim,lanes", [(64, 2), (128, 4), (256, 8), (128, 8)])
def test_hamming_scores_equal_jax(ndim, lanes):
    """Lanes past ``ndim`` are zero on both sides (the (N, 8) host layout)."""
    rng = np.random.default_rng(ndim + lanes)
    db = rng.integers(0, 2**32, (300, lanes), dtype=np.uint32)
    q = rng.integers(0, 2**32, (7, lanes), dtype=np.uint32)
    db[:, ndim // 32 :] = 0
    q[:, ndim // 32 :] = 0
    q[:2] = db[[3, 77]]
    valid = rng.random(300) > 0.1
    got = nphd.hamming_scores(_t(q), _t(db), ndim, _t(valid)).numpy()
    want = np.asarray(jax_nphd.hamming_scores(jnp.asarray(q), jnp.asarray(db), ndim, jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    assert got[0, 3] == 1.0 and got[1, 77] == 1.0


@pytest.mark.parametrize("metric", ["nphd", "hamming"])
def test_topk_scan_impl_equals_jax(metric):
    """Same scores per query; every returned index carries its brute-force
    score; the index sets agree above the last (possibly tied) score."""
    rng = np.random.default_rng(3)
    n, k, chunk = 1024, 24, 256
    lanes = rng.choice(np.array([2, 4, 6, 8], np.int32), n).astype(np.int32) if metric == "nphd" else np.full(n, 4, np.int32)
    db = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    db[np.arange(8)[None, :] >= lanes[:, None]] = 0
    q, q_lanes = db[[1, 50, 900, 901, 333]].copy(), lanes[[1, 50, 900, 901, 333]].copy()
    valid = rng.random(n) > 0.05
    args = (q, q_lanes, db, lanes, valid)
    got_s, got_i = topk.topk_scan_impl(*map(_t, args), k, chunk_size=chunk, metric=metric, ndim_bits=128)
    want_s, want_i = jax_topk.topk_scan_impl(*map(jnp.asarray, args), k, chunk_size=chunk, metric=metric, ndim_bits=128)
    got_s, got_i, want_s, want_i = got_s.numpy(), got_i.numpy(), np.asarray(want_s), np.asarray(want_i)
    np.testing.assert_array_equal(got_s, want_s)
    if metric == "nphd":
        ref = nphd.nphd_scores(_t(q), _t(q_lanes), _t(db), _t(lanes), _t(valid)).numpy()
    else:
        ref = nphd.hamming_scores(_t(q), _t(db), 128, _t(valid)).numpy()
    for qi in range(len(q)):
        np.testing.assert_array_equal(ref[qi, got_i[qi]], got_s[qi])
        above = got_s[qi] > got_s[qi, -1]
        assert set(got_i[qi][above]) == set(want_i[qi][above])


def test_topk_scan_impl_checks_its_arguments():
    z = torch.zeros((256, 4), dtype=torch.int32)
    lanes, valid = torch.full((256,), 4, dtype=torch.int32), torch.ones(256, dtype=torch.bool)
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        topk.topk_scan_impl(z[:2], lanes[:2], z[:200], lanes[:200], valid[:200], 4, chunk_size=128)
    with pytest.raises(ValueError, match="exceeds chunk_size"):
        topk.topk_scan_impl(z[:2], lanes[:2], z, lanes, valid, 300, chunk_size=128)
    with pytest.raises(ValueError, match="unknown metric"):
        topk.topk_scan_impl(z[:2], lanes[:2], z, lanes, valid, 4, chunk_size=128, metric="cosine")


# ------------------------------------------------------ DeviceHammingIndex


def test_device_hamming_index_equals_jax(tmp_path):
    rng = np.random.default_rng(9)
    for ndim in (64, 128):
        jx = JaxHammingIndex(tmp_path / f"jax{ndim}", ndim=ndim)
        pt = DeviceHammingIndex(tmp_path / f"port{ndim}", ndim=ndim, device="cpu")
        assert (pt.metric, pt.key_bytes, pt.ndim) == (jx.metric, jx.key_bytes, jx.ndim)
        n = 700
        keys = [key(i // 7, 100 * (i % 7)) for i in range(n)]
        vecs = [rng.bytes(ndim // 8) for _ in range(n)]
        for i in range(20):  # near-duplicates of row 0 at distinct distances
            vecs[100 + i] = flip(vecs[0], i + 1, rng)
        update = [key(3, 0)], [flip(vecs[21], 2, rng)]
        removed = keys[200:260] + [key(999, 0)]
        for idx in (jx, pt):
            idx.add(keys[:400], vecs[:400])
            idx.add(keys[400:], vecs[400:])
            idx.add(*update)
            assert idx.remove(removed) == 60
        assert (len(pt), pt._rows) == (len(jx), jx._rows)
        queries = [vecs[0], vecs[21], update[1][0], vecs[250], flip(vecs[500], 4, rng), rng.bytes(ndim // 8)]
        for count in (n, 25):
            got = pt.search(queries, count, return_rows=True)
            want = jx.search(queries, count, return_rows=True)
            for (gk, gs, gr), (wk, ws, wr) in zip(got, want):
                g = sorted(zip(-gs, [k.tobytes() for k in gk], gr))
                w = sorted(zip(-ws, [k.tobytes() for k in wk], wr))
                if count == n:  # every live row: no cut, the same rows
                    assert g == w
                else:  # a cut: the same scores, the same rows above its tie group
                    assert [x[0] for x in g] == [x[0] for x in w]
                    assert [x for x in g if x[0] < g[-1][0]] == [x for x in w if x[0] < w[-1][0]]
                assert all(k.tobytes() not in removed for k in gk)
        for i in (0, 21, 250, 500):
            assert pt.get(keys[i]) == jx.get(keys[i])
        assert pt.body_at(5) == jx.body_at(5)
        pt.close()
        jx.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_hamming_directory_saved_by_one_package_loads_in_the_other(tmp_path, writer):
    rng = np.random.default_rng(4)
    kinds = {"jax": lambda p: JaxHammingIndex(p, ndim=128), "port": lambda p: DeviceHammingIndex(p, ndim=128, device="cpu")}
    other = "port" if writer == "jax" else "jax"
    keys = [key(i, 0) for i in range(300)]
    vecs = [rng.bytes(16) for _ in range(300)]
    idx = kinds[writer](tmp_path / "idx")
    idx.add(keys, vecs)
    idx.remove(keys[:30])
    idx.close()
    a, b = kinds[writer](tmp_path / "idx"), kinds[other](tmp_path / "idx")
    assert len(a) == len(b) == 270
    for (ka, sa), (kb, sb) in zip(a.search(vecs[25:45], 300), b.search(vecs[25:45], 300)):
        assert sorted(zip(-sa, map(bytes, ka))) == sorted(zip(-sb, map(bytes, kb)))
    a.close()
    b.close()


# ---------------------------------------------------------- SimprintEngine


def _as_tuples(results):
    return [dataclasses.astuple(r) for r in results]


def _corpus(ndim, seed, n_assets=80, chunks=6):
    """Random chunk simprints, a few shared by several assets (so document
    frequencies exceed 1), and query assets copying stored assets with
    distinct numbers of flipped bits per chunk, mixed with random chunks."""
    rng = np.random.default_rng(seed)
    nbytes = ndim // 8
    vecs = {(a, c): rng.bytes(nbytes) for a in range(n_assets) for c in range(chunks)}
    for a in range(1, 5):  # asset 0's chunk 0 also stored under assets 1-4
        vecs[(a, 2)] = vecs[(0, 0)]
    freq = {}
    for v in vecs.values():
        freq[v] = freq.get(v, 0) + 1
    queries = []
    for target in (0, 7, 33, 61):
        q = [flip(vecs[(target, c)], (c * 2 + target) % (ndim // 16) + 1, rng) for c in range(chunks)]
        queries.append(q[: chunks - 1] + [rng.bytes(nbytes)])
    queries.append([rng.bytes(nbytes) for _ in range(3)])  # noise only
    queries.append([])
    return vecs, freq, queries


def _fill(engine, vecs, packed):
    items = sorted(vecs.items())
    keys = [key(a, 100 * c) for (a, c), _ in items]
    if packed:
        engine.add_packed(np.frombuffer(b"".join(keys), np.uint8).reshape(-1, 16),
                          np.frombuffer(b"".join(v for _, v in items), np.uint8).reshape(len(items), -1))
    else:
        engine.add_raw(keys, [v for _, v in items])
    engine.remove([key(7, 300), key(40, 0)])


@pytest.mark.parametrize("ndim", [64, 128])
@pytest.mark.parametrize("limit,oversampling", [(5, 200), (3, 2)], ids=["no-cut", "cut-below-threshold"])
def test_search_raw_many_equals_jax(tmp_path, ndim, limit, oversampling):
    vecs, freq, queries = _corpus(ndim, seed=ndim + limit)
    jx = JaxEngine(tmp_path / "jax", ndim=ndim, oversampling_factor=oversampling)
    pt = SimprintEngine(tmp_path / "port", ndim=ndim, oversampling_factor=oversampling, device="cpu")
    _fill(jx, vecs, packed=False)
    _fill(pt, vecs, packed=True)
    assert (pt.size, pt.dirty) == (jx.size, len(vecs) + 2)
    for detailed, doc_freq_fn in ((True, lambda sp: freq.get(sp, 1)), (False, None), (True, None)):
        kwargs = dict(limit=limit, threshold=0.75, detailed=detailed, doc_freq_fn=doc_freq_fn, total_assets=80)
        got = pt.search_raw_many(queries, **kwargs)
        want = jx.search_raw_many(queries, **kwargs)
        assert [_as_tuples(r) for r in got] == [_as_tuples(r) for r in want]
        assert [r.iscc_id_body for r in got[0]][:1] == [(0).to_bytes(8, "big")]
        assert got[1] and all(r.iscc_id_body != (7).to_bytes(8, "big") or r.matches == 4 for r in got[1])
        assert got[4] == [] and got[5] == []
        assert _as_tuples(pt.search_raw(queries[2], **kwargs)) == _as_tuples(got[2])
    pt.close()
    jx.close()


def test_search_raw_many_splits_wide_batches_into_sweeps(tmp_path, monkeypatch):
    """More chunk queries than ``max_sweep_queries``: consecutive sweeps,
    the same answers."""
    vecs, freq, queries = _corpus(128, seed=5)
    pt = SimprintEngine(tmp_path / "port", device="cpu")
    _fill(pt, vecs, packed=True)
    kwargs = dict(limit=5, threshold=0.75, detailed=True, doc_freq_fn=lambda sp: freq.get(sp, 1), total_assets=80)
    want = pt.search_raw_many(queries, **kwargs)
    sweeps = []
    search = pt._index.search
    monkeypatch.setattr(pt._index, "search", lambda b, c, **kw: sweeps.append(len(b)) or search(b, c, **kw))
    monkeypatch.setattr(SimprintEngine, "max_sweep_queries", 4)
    assert pt.search_raw_many(queries, **kwargs) == want
    assert sweeps == [4] * 6 + [3]  # 4 x 6 + 3 chunk queries
    pt.close()


def test_simprint_engine_lifecycle_equals_jax(tmp_path):
    vecs, _, _ = _corpus(128, seed=8)
    jx = JaxEngine(tmp_path / "jax", ndim=128)
    pt = SimprintEngine(tmp_path / "port", ndim=128, device="cpu")
    assert pt.search_raw_many([]) == [] and pt.search_raw_many([[b"x" * 16]]) == [[]]
    for e in (jx, pt):
        _fill(e, vecs, packed=False)
        e.add_raw([key(1, 0), key(1, 0)], [b"a" * 16, b"b" * 16])  # in-batch duplicate: the first is kept
    assert key(1, 0) in pt and key(40, 0) not in pt
    assert (pt.size, pt.dirty, pt.shard_count) == (jx.size, jx.dirty, jx.shard_count)
    with pytest.raises(ValueError, match="vectors must be"):
        pt.add_packed(np.zeros((1, 16), np.uint8), np.zeros((1, 8), np.uint8))
    for e in (jx, pt):
        e.save()
    assert pt.dirty == 0 and pt.data_size > 0
    pt.relocate(tmp_path / "moved")
    assert pt.path == tmp_path / "moved" and pt._index.path == pt.path
    pt.reset()
    assert pt.size == 0
    pt.drain_rotations()
    pt.close()
    jx.close()


# ------------------------------------------------------------ host store


def _store_contents(store):
    return (
        sorted(store.list_dbs()),
        store.range_scan("plain"),
        store.range_scan("dups"),
        store.get_dups("dups", b"k1"),
        store.entries("dups"),
        store.key_count("dups"),
        store.get("plain", b"a"),
        store.prefix_scan("plain", b"b"),
    )


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_store_written_by_one_package_opens_in_the_other(tmp_path, writer):
    kinds = {"jax": JaxStore, "port": HostStore}
    other = "port" if writer == "jax" else "jax"
    store = kinds[writer](tmp_path / "store")
    store.put("plain", b"a", b"1")
    store.putmulti("plain", [(b"b1", b"2"), (b"b2", b"x" * 5000)])
    store.dup_putmulti("dups", [(b"k1", b"v2"), (b"k1", b"v1"), (b"k2", b"v3")])
    store.dup_putmulti_arrays("dups", np.frombuffer(b"k3k3", np.uint8).reshape(2, 2), np.frombuffer(b"abcd", np.uint8).reshape(2, 2))
    store.delete("plain", b"b1")
    store.flush()
    before = _store_contents(store)
    store.close()
    for kind in (other, writer):
        reopened = kinds[kind](tmp_path / "store")
        assert _store_contents(reopened) == before
        reopened.close()
    assert before[2] == [(b"k1", b"v1"), (b"k1", b"v2"), (b"k2", b"v3"), (b"k3", b"ab"), (b"k3", b"cd")]


def test_the_store_builds_from_its_own_source_into_build(tmp_path, monkeypatch):
    """The library is keyed by its source and flags and lands under the
    build root; the JAX package's directory is never written."""
    lib = kv._build_library()
    assert lib.parent.parent == kv.BUILD_ROOT and lib.parent.name == kv.build_key()
    assert kv._build_library() == lib  # built once per key
    assert sorted(p.name for p in lib.parent.iterdir()) == ["build.log", kv.LIB_NAME]
    source = tmp_path / "store.cpp"
    source.write_bytes(kv._SOURCE.read_bytes() + b"\n// changed\n")
    monkeypatch.setattr(kv, "_SOURCE", source)
    assert kv.build_key() != lib.parent.name
    monkeypatch.setattr(kv, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises((RuntimeError, OSError)):
        kv._build_library()


def test_doc_freq_and_chunk_pointers_equal_jax(tmp_path):
    store = HostStore(tmp_path / "s")
    jstore = JaxStore(tmp_path / "j")
    pairs = [(b"s" * 16, key(i, 0)) for i in range(5)] + [(b"t" * 16, key(9, 100))]
    for s in (store, jstore):
        s.dup_putmulti("sp", pairs)
    assert ops.count_doc_freq(store, "sp", b"s" * 16) == jax_ops.count_doc_freq(jstore, "sp", b"s" * 16) == 5
    assert ops.count_doc_freq(store, "sp", b"s" * 16, dup_limit=3) == 3
    assert ops.unpack_chunk_pointer(key(9, 100, 7)) == jax_ops.unpack_chunk_pointer(key(9, 100, 7))
    store.close()
    jstore.close()
