"""The engine slice of ``iscc_search_tpu_torch`` (``DeviceNphdIndex``)
against the JAX engine, on the CPU.

The JAX index runs its Pallas path (``scan_kernel="pallas"``) in interpret
mode, with ``_PALLAS_MIN_CHUNK`` lowered to 4096 as its own tests do, so its
8192-row partitions build the twins the TPU uses: bitplane + int8 for
128/256-bit rows, perm + int8 for 64/192-bit rows. The port index loads the
same host state through ``from_arrays`` and searches it with the plain
versions of its kernels. Results are compared under the parity rule: the
same score multiset per query (to one unit in the last place, see
``_assert_parity``), every returned key carrying its brute-force NPHD score,
no tombstoned key; the order of tied keys is not compared.
"""

import inspect

import numpy as np
import pytest
import torch

from iscc_search_tpu.engine import device_index as jax_di
from iscc_search_tpu_torch.engine import DeviceNphdIndex
from iscc_search_tpu_torch.engine import device_index as di
from iscc_search_tpu_torch.ops.nphd import nphd_scores

# rows per code length: three full 8192-row partitions and a small one
ROWS = {2: 2000, 4: 2100, 6: 150, 8: 1900}
K = 10


def _bodies(codes, lanes):
    return [codes[i, : lanes[i]].astype(">u4").tobytes() for i in range(len(lanes))]


def _make_data(seed=5):
    rng = np.random.default_rng(seed)
    lanes = np.concatenate([np.full(n, lv, np.int32) for lv, n in ROWS.items()])
    rng.shuffle(lanes)
    n = len(lanes)
    codes = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    codes[np.arange(8)[None, :] >= lanes[:, None]] = 0
    # near-duplicates of row 0..19 so top-k lists hold more than noise
    codes[20:40] = codes[:20]
    codes[20:40, 0] ^= np.uint32(1)
    lanes[20:40] = lanes[:20]
    keys = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    removed = np.arange(3, n, 17)
    return keys, codes, lanes, removed


@pytest.fixture(scope="module")
def data():
    return _make_data()


@pytest.fixture(scope="module")
def pallas_engine(tmp_path_factory):
    """Factory of JAX indexes on the Pallas interpret path, loaded with
    ``data`` (bulk add_packed, then tombstones)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_di, "_PALLAS_MIN_CHUNK", 4096)
    made = []

    def make(keys, codes, lanes, removed):
        idx = jax_di.DeviceNphdIndex(tmp_path_factory.mktemp("jax") / "idx", scan_kernel="pallas")
        idx.add_packed(keys, codes, lanes)
        idx.remove(removed.tolist())
        made.append(idx)
        return idx

    yield make
    for idx in made:
        idx.reset()
        idx.close()
    mp.undo()


@pytest.fixture(scope="module")
def pair(data, pallas_engine):
    """(JAX index, port index loaded from the JAX index's host arrays)."""
    jx = pallas_engine(*data)
    return jx, _port_from(jx)


def _port_from(jx):
    n = jx._rows
    return DeviceNphdIndex.from_arrays(
        jx._keys[:n], jx._codes[:n], jx._nlanes[:n], jx._valid[:n], device="cpu"
    )


def _queries(codes, lanes, rows, rng, n_random):
    q_codes = codes[rows]
    q_lanes = lanes[rows]
    r_lanes = rng.choice(np.array([2, 4, 6, 8], np.int32), n_random).astype(np.int32)
    r_codes = rng.integers(0, 2**32, (n_random, 8), dtype=np.uint32)
    r_codes[np.arange(8)[None, :] >= r_lanes[:, None]] = 0
    return np.concatenate([q_codes, r_codes]), np.concatenate([q_lanes, r_lanes])


def _assert_parity(res_port, res_jax, q_codes, q_lanes, codes, lanes, valid, count):
    """Same score multisets; every port row (``return_rows``) is live and
    carries its brute-force score; the top scores are the brute-force top
    scores. ``codes``/``lanes``/``valid`` are the host arrays in row order."""
    ref = nphd_scores(
        torch.from_numpy(q_codes.view(np.int32)), torch.from_numpy(q_lanes),
        torch.from_numpy(codes.view(np.int32)), torch.from_numpy(lanes), torch.from_numpy(valid),
    ).numpy()
    for qi, ((kp, sp, rows), (_, sj)) in enumerate(zip(res_port, res_jax)):
        # One unit in the last place: the JAX engine's XLA program contracts
        # its phase-3 ``0.5 + dot * q_scale`` into one rounding in some
        # shapes and not in others; the two differ only where q_scale is not
        # a power of two (1/384, a 192-bit common prefix).
        np.testing.assert_array_max_ulp(np.sort(sp), np.sort(sj), maxulp=1)
        assert len(sp) == min(count, int(valid.sum()))
        assert np.all(np.diff(sp) <= 0)
        assert valid[rows].all()
        np.testing.assert_allclose(ref[qi, rows], sp, rtol=0, atol=1e-6)
        np.testing.assert_allclose(sp, -np.sort(-ref[qi])[: len(sp)], rtol=0, atol=1e-6)


def test_loaded_state_matches_the_jax_index(pair, data):
    jx, pt = pair
    keys, codes, lanes, removed = data
    assert len(pt) == len(jx) == len(lanes) - len(removed)
    assert pt.size == jx.size
    for key in (0, 1, 3, 20, int(removed[5]), len(lanes) - 1, 10**9):
        assert pt.get(key) == jx.get(key)
        assert (key in pt) == (key in jx)


def test_search_matches_the_pallas_engine(pair, data):
    jx, pt = pair
    keys, codes, lanes, removed = data
    rng = np.random.default_rng(9)
    rows = np.concatenate([np.arange(0, 40, 3), removed[:3], rng.integers(0, len(lanes), 6)])
    q_codes, q_lanes = _queries(codes, lanes, rows, rng, n_random=6)
    bodies = _bodies(q_codes, q_lanes)
    res_port = pt.search(bodies, K, return_rows=True)
    _assert_parity(res_port, jx.search(bodies, K), q_codes, q_lanes, codes, lanes, jx._valid[: len(lanes)], K)
    removed_set = set(removed.tolist())
    for qi, row in enumerate(rows):
        got = res_port[qi][0].view(">u8").ravel()
        np.testing.assert_array_equal(got, res_port[qi][2])  # key == row here
        assert not removed_set.intersection(got.tolist())
        if row not in removed_set:
            assert res_port[qi][1][0] == 1.0
            assert int(row) in got[res_port[qi][1] == 1.0]


def test_partitions_mirror_the_jax_engine(pair):
    """Same partitions, capacities and row maps as the JAX engine; each holds
    only the packed codes and a uint8 validity mask."""
    jx, pt = pair
    pt.search(_bodies(jx._codes[:2], jx._nlanes[:2]), 1)
    assert sorted(pt._partitions) == sorted(jx._partitions) == sorted(ROWS)
    for lanes, part in pt._partitions.items():
        ref = jx._partitions[lanes]
        assert (part.cap, part.count) == (ref.cap, ref.count)
        np.testing.assert_array_equal(part.row_map, ref.row_map)
        assert part.packed_dev.shape == (part.cap, lanes) and part.packed_dev.dtype == torch.int32
        np.testing.assert_array_equal(part.packed_dev.numpy(), np.asarray(ref.packed_dev).view(np.int32))
        np.testing.assert_array_equal(part.valid_dev.numpy().astype(bool), np.asarray(ref.valid_dev))


def test_return_rows_and_body_at(pair, data):
    _, pt = pair
    keys, codes, lanes, _ = data
    bodies = _bodies(codes[[0, 1, 2]], lanes[[0, 1, 2]])
    gen = pt.row_generation
    res = pt.search(bodies, 4, return_rows=True)
    for qi, (k, s, rows) in enumerate(res):
        assert len(k) == len(s) == len(rows) == 4
        assert pt.body_at(int(rows[0]), gen) == bodies[qi]
    assert pt.body_at(0, gen + 10**6) is None
    assert pt.body_at(-1) is None and pt.body_at(10**7) is None


@pytest.mark.parametrize("count", [200, 10_000])
def test_count_larger_than_a_partition(pallas_engine, count):
    """count above the 150-row partition (k=256 scans every block of every
    partition), and above every live row of a small index."""
    keys, codes, lanes, removed = _make_data(seed=6)
    if count > len(lanes):
        keep = np.flatnonzero(lanes == 6)[:100]
        keys, codes, lanes = keys[keep], codes[keep], lanes[keep]
        removed = np.frombuffer(keys[::7].tobytes(), dtype=">u8").astype(np.int64)
    jx = pallas_engine(keys, codes, lanes, removed)
    pt = _port_from(jx)
    rng = np.random.default_rng(count)
    q_codes, q_lanes = _queries(codes, lanes, np.arange(3), rng, n_random=1)
    bodies = _bodies(q_codes, q_lanes)
    valid = jx._valid[: len(lanes)]
    _assert_parity(pt.search(bodies, count, return_rows=True), jx.search(bodies, count), q_codes, q_lanes, codes, lanes, valid, count)


def test_incremental_add_and_remove_match_the_jax_engine(pallas_engine, data):
    """Appends into existing partitions (the in-place device append), a
    key update, an intra-batch duplicate, new tombstones, and an append
    that overflows a partition's capacity (rebuilt alone), on both."""
    jx = pallas_engine(*data)
    pt = _port_from(jx)
    keys, codes, lanes, removed = data
    rng = np.random.default_rng(12)
    queries = _bodies(codes[:8], lanes[:8])
    for idx in (jx, pt):
        idx.search(queries, K)  # both mirrors exist before the mutations
    caps = {lv: p.cap for lv, p in pt._partitions.items()}

    n = len(lanes)
    steps = [
        (300, np.array([2, 4, 6, 8], np.int32)),  # fits every partition
        (caps[6] - ROWS[6] + 10, np.array([6], np.int32)),  # overflows the 192-bit partition
    ]
    all_codes, all_lanes = [codes], [lanes]
    for step, (m, choices) in enumerate(steps):
        new_lanes = rng.choice(choices, m).astype(np.int32)
        new_codes = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
        new_codes[np.arange(8)[None, :] >= new_lanes[:, None]] = 0
        new_keys = list(range(n, n + m))
        new_keys[-1] = new_keys[0]  # intra-batch duplicate: the later row wins
        bodies = _bodies(new_codes, new_lanes)
        for idx in (jx, pt):
            idx.add(new_keys, bodies)
            idx.add([1], [bodies[5]])  # update of an existing key
            assert idx.remove([2 + 10 * step, 5 + 10 * step, n + 7, 10**9]) == 3
        all_codes.append(new_codes)
        all_lanes.append(new_lanes)
        n += m
        np.testing.assert_array_equal(pt._valid[: pt._rows], jx._valid[: jx._rows])
        assert len(pt) == len(jx)

        q_codes, q_lanes = _queries(new_codes, new_lanes, np.arange(6), rng, n_random=4)
        bodies_q = _bodies(q_codes, q_lanes) + queries
        q_codes = np.concatenate([q_codes, codes[:8]])
        q_lanes = np.concatenate([q_lanes, lanes[:8]])
        rows_codes = jx._codes[: jx._rows]
        rows_lanes = jx._nlanes[: jx._rows]
        _assert_parity(
            pt.search(bodies_q, K, return_rows=True), jx.search(bodies_q, K), q_codes, q_lanes,
            rows_codes, rows_lanes, jx._valid[: jx._rows], K,
        )
    assert pt._partitions[6].cap > caps[6]
    body = _bodies(codes[:1], lanes[:1])[0]
    assert sorted(pt.search_one(body, 3).values()) == sorted(jx.search_one(body, 3).values())


# ------------------------------------------------------- port-only contract


def test_cap_rows_equals_the_jax_engine():
    for n in (0, 1, 8191, 8193, 65536, 65537, 2_620_000, 4_194_304, 10_485_760):
        assert di._cap_rows(n) == jax_di._cap_rows(n)


@pytest.mark.parametrize(
    "args",
    [
        (256, 512 * 1024 * 1024, None, None),
        (128, 1 << 20, 64, 1.0),
        (64, 1000, 128, 0.9),
        (256, 7 * 1024 * 1024, None, 1.5),
    ],
)
def test_constructor_takes_the_jax_parameters_in_order(tmp_path, args):
    """``path, max_dim, shard_size, ndim, recall_target, scan_kernel, mesh``
    as in the JAX engine (the port adds ``device`` after them): the same
    positional call means the same thing on both."""
    jax_names = list(inspect.signature(jax_di.PackedCodeIndex.__init__).parameters)
    port_names = list(inspect.signature(di.PackedCodeIndex.__init__).parameters)
    assert port_names[: port_names.index("mesh") + 1] == jax_names[: jax_names.index("mesh") + 1]
    assert port_names[port_names.index("mesh") + 1 :] == ["device"]
    jx = jax_di.DeviceNphdIndex(tmp_path / "jax", *args)
    pt = DeviceNphdIndex(tmp_path / "port", *args, device="cpu")
    try:
        for attr in ("max_dim", "ndim", "shard_rows", "recall_target", "scan_kernel", "mesh"):
            assert getattr(pt, attr) == getattr(jx, attr), attr
        assert pt.ROW_BYTES == jx.ROW_BYTES
    finally:
        jx.close()
    assert DeviceNphdIndex(device="cpu").shard_rows == max(1024, 512 * 1024 * 1024 // pt.ROW_BYTES)


def test_add_packed_checks_its_inputs():
    idx = DeviceNphdIndex(device="cpu")
    keys = np.zeros((2, 8), np.uint8)
    with pytest.raises(ValueError, match="keys"):
        idx.add_packed(np.zeros((2, 4), np.uint8), np.zeros((2, 2), np.uint32), 2)
    with pytest.raises(ValueError, match="packed"):
        idx.add_packed(keys, np.zeros((2, 9), np.uint32), 2)
    with pytest.raises(ValueError, match="nlanes must be"):
        idx.add_packed(keys, np.zeros((2, 2), np.uint32), np.array([2, 2, 2]))
    with pytest.raises(ValueError, match="out of range"):
        idx.add_packed(keys, np.zeros((2, 2), np.uint32), 3)
    idx.add_packed(keys[:0], np.zeros((0, 2), np.uint32), 2)
    assert len(idx) == 0
    with pytest.raises(ValueError, match="8 bytes"):
        idx.add([b"short"], [bytes(8)])


def test_empty_index_and_empty_batch():
    idx = DeviceNphdIndex(device="cpu")
    assert idx.search([], 5) == []
    ((k, s),) = idx.search([bytes(8)], 5)
    assert k.shape == (0, 8) and s.shape == (0,)
    ((k, s, rows),) = idx.search([bytes(8)], 5, return_rows=True)
    assert rows.shape == (0,)
    idx.add([], [])
    idx.add([7], [bytes(range(8))])
    assert idx.search_one(bytes(range(8)), 3) == {7: 1.0}
    assert idx.get(7) == bytes(range(8)) and idx.get(8) is None
    idx.close()
    assert idx.search_one(bytes(range(8)), 3) == {7: 1.0}  # the mirror is rebuilt


def test_unported_features_name_their_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*parallel"):
        DeviceNphdIndex(mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*knobs"):
        DeviceNphdIndex(scan_kernel="pallas", device="cpu")
    idx = DeviceNphdIndex(tmp_path / "new", device="cpu")
    assert idx.control_hook is None
    idx.control_hook = None
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*parallel"):
        idx.control_hook = lambda *a: None
    idx.close()


@pytest.mark.parametrize("value", ["pallas", "xla", "wgmma", "", None])
def test_scan_kernel_values_the_port_lacks_raise_with_their_roadmap_words(tmp_path, value):
    """The JAX engine's ``"pallas"`` and "anything else = the XLA scan" have
    no counterpart: the port has no Pallas and no XLA scan."""
    with pytest.raises(NotImplementedError, match=r"scan_kernel=.*\('auto', 'mma', 'popc'\).*ROADMAP.md.*knobs"):
        DeviceNphdIndex(tmp_path / "i", scan_kernel=value, device="cpu")
    assert not (tmp_path / "i").exists()


@pytest.mark.parametrize("scan_kernel", di.SCAN_KERNELS)
def test_every_scan_kernel_gives_the_jax_engines_results(pair, data, scan_kernel):
    """``scan_kernel`` chooses a kernel, never a result: on the CPU all three
    run the plain version, return the same rows and scores in the same
    order, and stand in parity with the JAX engine."""
    jx, default = pair
    keys, codes, lanes, removed = data
    pt = DeviceNphdIndex.from_arrays(*[a[: jx._rows] for a in (jx._keys, jx._codes, jx._nlanes, jx._valid)],
                                     scan_kernel=scan_kernel, device="cpu")
    assert pt.scan_kernel == scan_kernel
    rng = np.random.default_rng(19)
    for nq in (1, 70):  # both sides of every "auto" threshold
        rows = rng.integers(0, len(lanes), nq - nq // 4)
        q_codes, q_lanes = _queries(codes, lanes, rows, rng, n_random=nq // 4)
        bodies = _bodies(q_codes, q_lanes)
        res = pt.search(bodies, K, return_rows=True)
        for (k1, s1, r1), (k2, s2, r2) in zip(res, default.search(bodies, K, return_rows=True)):
            np.testing.assert_array_equal(k1, k2)
            np.testing.assert_array_equal(s1, s2)
            np.testing.assert_array_equal(r1, r2)
        _assert_parity(res, jx.search(bodies, K), q_codes, q_lanes, codes, lanes, jx._valid[: len(lanes)], K)


def test_scan_kernel_reaches_phase_one(monkeypatch):
    """The engine hands ``blockmax_topk_packedq_impl`` the forced kernel, or
    under ``"auto"`` what ``auto_phase1`` names for the batch and the partition."""
    seen = []
    real = di.blockmax_topk_packedq_impl

    def spy(*args, phase1):
        seen.append((args[0].shape[0], args[5] // 32, phase1))
        return real(*args, phase1=phase1)

    monkeypatch.setattr(di, "blockmax_topk_packedq_impl", spy)
    for scan_kernel in di.SCAN_KERNELS:
        idx = DeviceNphdIndex(scan_kernel=scan_kernel, device="cpu")
        idx.add(list(range(4)), [bytes(8), bytes(16), bytes(24), bytes(32)])
        edges = sorted(set(di._AUTO_MMA_MIN_Q.values()))
        for nq in (1, *(q - 1 for q in edges), *edges):
            del seen[:]
            idx.search([bytes(8)] * nq, 2)
            want = [(nq, lanes, di.auto_phase1(nq, lanes) if scan_kernel == "auto" else scan_kernel) for lanes in (2, 4, 6, 8)]
            assert seen == want
            if scan_kernel == "auto" and nq in (1, edges[-1]):  # one kernel for every width at both ends
                assert {p for _, _, p in seen} == {"popc" if nq == 1 else "mma"}


@pytest.mark.parametrize("lanes", range(1, 9))
def test_auto_phase1_is_a_table_of_batch_size_and_width(lanes):
    """A pure function of (Q, lanes): ``"popc"`` below the width's threshold,
    ``"mma"`` from it on, whatever the batch beyond; an odd lane count reads
    the next even one's entry."""
    threshold = di._AUTO_MMA_MIN_Q[lanes + lanes % 2]
    assert di.auto_phase1(1, lanes) == "popc"
    assert di.auto_phase1(threshold - 1, lanes) == "popc"
    assert di.auto_phase1(threshold, lanes) == "mma"
    for nq in (threshold + 1, 128, 512, 513, 1024, 10**6):
        assert di.auto_phase1(nq, lanes) == "mma"
    assert {di.auto_phase1(nq, lanes) for nq in range(1, 200)} == {"popc", "mma"}
    assert sorted(di._AUTO_MMA_MIN_Q) == [2, 4, 6, 8] and all(1 < q <= 128 for q in di._AUTO_MMA_MIN_Q.values())
    assert set(di.SCAN_KERNELS) - {"auto"} <= set(di.blockmax_topk_packedq_impl.__globals__["PHASE1"])


def test_a_failed_sync_forces_a_full_rebuild(monkeypatch):
    idx = DeviceNphdIndex(device="cpu")
    idx.add([1, 2], [bytes(8), bytes(16)])
    idx.search([bytes(8)], 1)
    idx.add([3], [bytes(8)])

    def boom(*args):
        raise RuntimeError("upload failed")

    monkeypatch.setattr(idx, "_append_to_partition", boom)
    with pytest.raises(RuntimeError, match="upload failed"):
        idx.search([bytes(8)], 1)
    assert idx._partitions is None and idx._synced_rows == 0
    monkeypatch.undo()
    ((k, s),) = idx.search([bytes(8)], 3)
    assert sorted(k.view(">u8").ravel().tolist()) == [1, 2, 3]
