"""Persistence of the port's ``PackedCodeIndex`` against the JAX engine's, on
the CPU (``device="cpu"``, small sizes, numpy data from a seed).

- A directory saved by one package loads in the other, both ways: the same
  host state, the same file names and manifest, and the same searches give
  the same keys and score multisets (scores to one unit in the last place,
  the parity rule of ROADMAP.md).
- The persistence code is a copy: each copied function compiles to the same
  bytecode as its original.
- ``dirty``, ``shard_count``, ``serialized_length``, ``tombstone_fraction``
  and ``size`` equal the reference's after the same operations.
- The crash-safety and coalescing cases of ``tests/test_device_index.py``,
  ``tests/test_persistence.py``, ``tests/test_engine_durability.py`` and the
  branch tests that concern ``PackedCodeIndex``, run against the port.
"""

import json
import os
import time
import types

import numpy as np
import pytest

from iscc_search_tpu.engine import device_index as jax_di
from iscc_search_tpu_torch.engine import DeviceNphdIndex
from iscc_search_tpu_torch.engine import device_index as di

JaxIndex = jax_di.DeviceNphdIndex


def port_index(path, **kwargs):
    return DeviceNphdIndex(path, device="cpu", **kwargs)


OPEN = {"jax": JaxIndex, "port": port_index}


@pytest.fixture
def rng():
    return np.random.default_rng(21)


def rand_body(rng, nbytes=32):
    return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()


def rand_bodies(rng, n, widths=(8, 16, 24, 32)):
    return [rand_body(rng, int(rng.choice(widths))) for _ in range(n)]


def _fill(idx, rng, n=2500):
    """Variable-length rows with near-duplicates, an update, tombstones."""
    bodies = rand_bodies(rng, n)
    for i in range(20, 40):  # near-duplicates of rows 0..19: top-k lists hold more than noise
        b = bytearray(bodies[i - 20])
        b[0] ^= 1
        bodies[i] = bytes(b)
    idx.add(list(range(n)), bodies)
    bodies[7] = rand_body(rng, 16)
    idx.add([7], [bodies[7]])  # update: row 7 tombstoned, a new row appended
    idx.remove(list(range(3, n, 17)))
    return bodies


def _host_state(idx):
    n = idx._rows
    return idx._keys[:n], idx._codes[:n], idx._nlanes[:n], idx._valid[:n]


def _assert_same_answers(a, b, bodies, count=10):
    for (ka, sa), (kb, sb) in zip(a.search(bodies, count), b.search(bodies, count)):
        np.testing.assert_array_max_ulp(np.sort(sa), np.sort(sb), maxulp=1)
        # Keys may differ only among tied scores: below the last score's tie
        # group the key sets are equal.
        strict_a = {k.tobytes() for k, s in zip(ka, sa) if s > sa[-1]}
        strict_b = {k.tobytes() for k, s in zip(kb, sb) if s > sb[-1]}
        assert strict_a == strict_b
        for idx, keys, scores in ((a, kb, sb), (b, ka, sa)):
            for key in keys[:3]:
                assert idx.get(key.tobytes()) is not None  # live in the other index too


# ------------------------------------------------ one format, two packages


@pytest.mark.parametrize("shard_size", [1, 512 * 1024 * 1024], ids=["sealed-segments", "one-active-file"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_directory_saved_by_one_package_loads_in_the_other(tmp_path, rng, writer, reader, shard_size):
    path = tmp_path / "idx"
    w = OPEN[writer](path, shard_size=shard_size)
    bodies = _fill(w, rng)
    w.save(wait=True)
    saved = [a.copy() for a in _host_state(w)]
    saved_count = w.shard_count
    assert saved_count == (3 if shard_size == 1 else 1)

    r = OPEN[reader](path, shard_size=shard_size)
    try:
        assert (len(r), r.size, r.shard_count, r.dirty) == (len(w), w.size, saved_count, 0)
        for got, want in zip(_host_state(r), saved):
            np.testing.assert_array_equal(got, want)
        assert r.get(7) == bodies[7] and r.get(3) is None and 3 not in r and 8 in r
        queries = bodies[:12] + rand_bodies(rng, 4)
        _assert_same_answers(r, w, queries)
        # The reader goes on where the writer stopped: fresh file names, the
        # sealed segments kept, and the writer's package reads it back.
        r.add([10**6], [bodies[0]])
        r.remove([8])
        r.save(wait=True)
        state = json.loads((path / "state.json").read_text())
        assert state["save_seq"] == 2 and state["active"]["file"] == "active-00000002.npz"
        assert not (path / "active-00000001.npz").exists() and not (path / "valid-00000001.npz").exists()
        back = OPEN[writer](path, shard_size=shard_size)
        try:
            assert len(back) == len(r) and 10**6 in back and 8 not in back
            _assert_same_answers(back, r, queries)
        finally:
            back.close()
    finally:
        r.close()
        w.close()


@pytest.mark.parametrize("shard_size", [1, 512 * 1024 * 1024], ids=["sealed-segments", "one-active-file"])
def test_both_packages_write_the_same_files(tmp_path, shard_size):
    """The same operations give the same file names, the same manifest and
    the same arrays in every file."""
    dirs = {}
    for name, make in OPEN.items():
        idx = make(tmp_path / name, shard_size=shard_size)
        _fill(idx, np.random.default_rng(3))
        idx.save(wait=True)
        idx.add([10**6], [bytes(8)])
        idx.save(wait=True)
        idx.close()
        dirs[name] = tmp_path / name
    names = sorted(f.name for f in dirs["jax"].iterdir())
    assert names == sorted(f.name for f in dirs["port"].iterdir())
    assert json.loads((dirs["jax"] / "state.json").read_text()) == json.loads((dirs["port"] / "state.json").read_text())
    for name in names:
        if name.endswith(".npz"):
            with np.load(dirs["jax"] / name) as zj, np.load(dirs["port"] / name) as zp:
                assert sorted(zj.files) == sorted(zp.files)
                for key in zj.files:
                    assert zj[key].dtype == zp[key].dtype
                    np.testing.assert_array_equal(zj[key], zp[key])


@pytest.mark.parametrize(
    "legacy", [{"active": "active.npz", "valid": "valid.npy"}, {"active": "active.npz"}, {"valid": "valid.npy"}],
    ids=["both-legacy-names", "legacy-active", "legacy-valid"],
)
@pytest.mark.parametrize("reader", ["jax", "port"])
def test_legacy_file_names_load_and_go_with_the_next_save(tmp_path, rng, reader, legacy):
    """Stores from before the versioned names: ``active.npz`` named by the
    manifest, ``valid.npy`` implied by a manifest without ``valid_file``."""
    path = tmp_path / "idx"
    idx = port_index(path)
    bodies = rand_bodies(rng, 30)
    idx.add(list(range(30)), bodies)
    idx.remove([5])
    idx.save(wait=True)
    idx.close()
    state = json.loads((path / "state.json").read_text())
    if "active" in legacy:
        os.rename(path / state["active"]["file"], path / "active.npz")
        state["active"]["file"] = "active.npz"
    if "valid" in legacy:
        os.rename(path / state.pop("valid_file"), path / "valid.npy")
    (path / "state.json").write_text(json.dumps(state))

    r = OPEN[reader](path)
    try:
        assert len(r) == 29 and 5 not in r and r.get(7) == bodies[7]
        r.add([99], [bodies[0]])
        r.save(wait=True)
        assert not (path / "active.npz").exists() and not (path / "valid.npy").exists()
    finally:
        r.close()
    again = port_index(path)
    assert len(again) == 30 and 99 in again
    again.close()


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_reload_without_valid_file(tmp_path, rng, reader):
    """A manifest without a validity file: every loaded row is live."""
    path = tmp_path / "idx"
    idx = port_index(path)
    idx.add([1, 2], rand_bodies(rng, 2))
    idx.save()
    idx.close()
    state = json.loads((path / "state.json").read_text())
    (path / state.pop("valid_file")).unlink()
    (path / "state.json").write_text(json.dumps(state))
    r = OPEN[reader](path)
    assert len(r) == 2
    r.close()


# ------------------------------------------------------ the code is a copy


def _code_key(code, doc=None):
    """What a code object does: bytecode, names and constants, with the
    docstring left out and nested code objects keyed the same way."""
    consts = tuple(
        _code_key(c) if isinstance(c, types.CodeType) else c for c in code.co_consts if doc is None or c != doc
    )
    return code.co_code, code.co_names, code.co_varnames, consts


@pytest.mark.parametrize(
    "name",
    [
        "_fsync_dir", "_atomic_write", "PackedCodeIndex.save", "PackedCodeIndex._snapshot_locked",
        "PackedCodeIndex._segment_snapshot", "PackedCodeIndex._enqueue_save", "PackedCodeIndex._save_worker",
        "PackedCodeIndex._write_snapshot", "PackedCodeIndex.compact", "PackedCodeIndex._compact_locked",
        "PackedCodeIndex.reset", "PackedCodeIndex.drain_rotations", "PackedCodeIndex._load",
        "PackedCodeIndex._gc_unreferenced", "PackedCodeIndex.shard_count", "PackedCodeIndex.serialized_length",
        "PackedCodeIndex.tombstone_fraction",
    ],
)
def test_persistence_code_equals_the_reference(name):
    """Comments and docstrings aside, each copied function is the reference's."""

    def key(module):
        obj = module
        for part in name.split("."):
            obj = obj.__dict__[part] if isinstance(obj, type) else getattr(obj, part)
        fn = obj.fget if isinstance(obj, property) else obj
        return _code_key(fn.__code__, fn.__doc__)

    assert key(di) == key(jax_di)


def test_npz_bytes_equals_the_reference(rng):
    arrays = {"keys": rng.integers(0, 256, (5, 8), dtype=np.uint8), "nlanes": np.arange(5, dtype=np.int32)}
    assert di._npz_bytes(**arrays) == jax_di._npz_bytes(**arrays)


# ------------------------------------- counters after the same operations

_COUNTERS = ("dirty", "shard_count", "serialized_length", "tombstone_fraction", "size", "save_enabled", "_rows", "_live")


def _step_add(idx, rng):
    n = idx._rows
    idx.add(list(range(n, n + 1500)), rand_bodies(rng, 1500))


def _step_add_packed(idx, rng):
    n = idx._rows
    keys = np.arange(10**6 + n, 10**6 + n + 700, dtype=">u8").view(np.uint8).reshape(700, 8)
    idx.add_packed(keys, rng.integers(0, 2**32, (700, 4), dtype=np.uint32), 4)


def _step_update(idx, rng):
    idx.add([0, 1, 1], rand_bodies(rng, 3))  # two updates, one of them twice in the batch


_STEPS = [
    ("add", _step_add),
    ("remove", lambda idx, rng: idx.remove([3, 4, 5, 10**9])),
    ("save", lambda idx, rng: idx.save()),
    ("add_packed", _step_add_packed),
    ("update", _step_update),
    ("save-background", lambda idx, rng: (idx.save(wait=False), idx.drain_rotations())),
    ("remove-most", lambda idx, rng: idx.remove(list(range(6, 1400)))),
    ("compact", lambda idx, rng: idx.compact()),
    ("save-after-compact", lambda idx, rng: idx.save()),
    ("add-again", _step_add),
    ("reset", lambda idx, rng: idx.reset()),
    ("add-after-reset", _step_add),
    ("close", lambda idx, rng: idx.close()),
]


@pytest.mark.parametrize("shard_size", [1, 70_000, 512 * 1024 * 1024])
def test_counters_equal_the_reference_after_the_same_operations(tmp_path, shard_size):
    jx = JaxIndex(tmp_path / "jax", shard_size=shard_size)
    pt = port_index(tmp_path / "port", shard_size=shard_size)
    rngs = {id(jx): np.random.default_rng(5), id(pt): np.random.default_rng(5)}
    for label, step in _STEPS:
        gens = {}
        for idx in (jx, pt):
            gens[id(idx)] = idx.row_generation
            step(idx, rngs[id(idx)])
        for attr in _COUNTERS:
            assert getattr(pt, attr) == getattr(jx, attr), (label, attr)
        assert pt._segments == jx._segments, label
        for got, want in zip(_host_state(pt), _host_state(jx)):
            np.testing.assert_array_equal(got, want)
        # The row space is renumbered by the same steps on both.
        assert (pt.row_generation != gens[id(pt)]) == (jx.row_generation != gens[id(jx)]), label
    assert sorted(f.name for f in (tmp_path / "jax").iterdir()) == sorted(f.name for f in (tmp_path / "port").iterdir())


def test_an_index_without_a_path_never_saves(rng):
    idx = DeviceNphdIndex(device="cpu")
    assert idx.path is None and idx.save_enabled is False
    idx.add([1, 2], rand_bodies(rng, 2))
    idx.remove([2])
    assert idx.dirty == 3 and idx.shard_count == 1 and idx.tombstone_fraction == 0.5
    idx.save()
    idx.save(wait=False)
    idx.drain_rotations()
    assert idx.dirty == 3 and idx._save_thread is None
    idx.compact()
    assert idx.tombstone_fraction == 0.0 and len(idx) == 1
    idx.close()
    idx.close()


def test_from_arrays_with_a_path_is_saved_at_close(tmp_path, rng):
    src = DeviceNphdIndex(device="cpu")
    bodies = rand_bodies(rng, 40)
    src.add(list(range(40)), bodies)
    src.remove([3])
    idx = DeviceNphdIndex.from_arrays(*_host_state(src), path=tmp_path / "i", device="cpu")
    assert idx.dirty == 40 and len(idx) == 39
    idx.close()
    again = port_index(tmp_path / "i")
    assert len(again) == 39 and again.get(4) == bodies[4] and 3 not in again
    again.close()


def test_save_disabled_is_noop(tmp_path, rng):
    idx = port_index(tmp_path / "i")
    idx.add([1], rand_bodies(rng, 1))
    idx.save_enabled = False
    idx.save()
    assert not (tmp_path / "i" / "state.json").exists()
    idx.save_enabled = True
    idx.close()
    assert (tmp_path / "i" / "state.json").exists()


# ------------------------------ the device mirror after load, compact, reset


@pytest.mark.parametrize("how", ["load", "compact", "reset", "save-compacts"])
def test_the_mirror_is_rebuilt_and_the_row_generation_moves(tmp_path, rng, how):
    path = tmp_path / "i"
    idx = port_index(path)
    bodies = rand_bodies(rng, 9000)
    idx.add(list(range(9000)), bodies)
    idx.remove(list(range(0, 9000, 2)) if how != "save-compacts" else list(range(0, 6000)))
    idx.search(bodies[:2], 3)
    assert idx._partitions is not None and idx._synced_rows == 9000 and not idx._device_stale
    gen = idx.row_generation
    if how == "load":
        idx.save()
        idx.close()
        idx = port_index(path)
    elif how == "compact":
        idx.compact()
    elif how == "reset":
        idx.reset()
        idx.add([1], [bodies[1]])
    else:
        idx.save()  # tombstones dominate: save compacts first
        assert idx._rows == 3000 and idx.tombstone_fraction == 0.0
    assert idx._partitions is None and idx._synced_rows == 0 and idx._device_stale
    assert idx.row_generation != gen
    assert idx.body_at(1, gen) is None
    probe = 1 if how != "save-compacts" else 7001
    assert idx.search_one(bodies[probe], 3)[probe] == 1.0
    assert idx._partitions is not None and not idx._device_stale
    idx.close()


# ------------------- cases of tests/test_device_index.py, against the port


def test_persistence_roundtrip(tmp_path, rng):
    path = tmp_path / "i"
    idx = port_index(path)
    bodies = [rand_body(rng) for _ in range(30)]
    idx.add(list(range(30)), bodies)
    idx.remove([5])
    assert idx.dirty == 31
    idx.save()
    assert idx.dirty == 0
    idx.close()

    idx2 = port_index(path)
    assert idx2.size == 29
    assert 5 not in idx2
    assert idx2.get(7) == bodies[7]
    res = idx2.search_one(bodies[10], count=3)
    assert res[10] == pytest.approx(1.0)
    idx2.close()


def test_close_saves_dirty(tmp_path, rng):
    path = tmp_path / "i"
    idx = port_index(path)
    idx.add([1], [rand_body(rng)])
    idx.close()  # implicit save
    idx2 = port_index(path)
    assert idx2.size == 1
    idx2.close()


def test_update_persists_after_reload(tmp_path, rng):
    path = tmp_path / "i"
    idx = port_index(path)
    b1, b2 = rand_body(rng), rand_body(rng)
    idx.add([1], [b1])
    idx.save()
    idx.add([1], [b2])
    idx.save()
    idx.close()
    idx2 = port_index(path)
    assert idx2.size == 1
    assert idx2.get(1) == b2
    idx2.close()


def test_segment_sealing(tmp_path, rng):
    idx = port_index(tmp_path / "i", shard_size=1)  # floor = 1024 rows
    n = 3000
    bodies = [rand_body(rng, 8) for _ in range(n)]
    idx.add(list(range(n)), bodies)
    idx.save()
    assert idx.shard_count >= 2
    assert len(list((tmp_path / "i").glob("seg-*.npz"))) >= 2
    idx.close()
    idx2 = port_index(tmp_path / "i", shard_size=1)
    assert idx2.size == n
    assert idx2.get(2500) == bodies[2500]
    idx2.close()


def test_sealed_boundary_shard_count(tmp_path, rng):
    """Rows exactly at a seal boundary: the active segment is empty."""
    idx = port_index(tmp_path / "d", shard_size=1)  # shard_rows = 1024
    idx.add(list(range(1024)), [rand_body(rng, 8) for _ in range(1024)])
    assert idx.shard_count == 1
    idx.save()
    assert idx.shard_count == 1  # one sealed, no active rows
    idx.close()


def test_compaction(tmp_path, rng):
    idx = port_index(tmp_path / "i")
    bodies = [rand_body(rng, 8) for _ in range(100)]
    idx.add(list(range(100)), bodies)
    idx.remove(list(range(90)))
    assert idx.tombstone_fraction > 0.5
    idx.compact()
    assert idx.tombstone_fraction == 0.0
    assert idx.size == 10
    assert idx.get(95) == bodies[95]
    res = idx.search_one(bodies[95], count=3)
    assert res[95] == pytest.approx(1.0)
    idx.close()


def test_reset(tmp_path, rng):
    idx = port_index(tmp_path / "i")
    idx.add([1], [rand_body(rng)])
    idx.save()
    idx.reset()
    assert idx.size == 0
    assert 1 not in idx
    assert (tmp_path / "i" / "state.json").exists()  # files untouched
    idx.close()


def test_mismatched_key_bytes_on_load(tmp_path, rng):
    path = tmp_path / "i"
    idx = port_index(path)
    idx.add([1], [rand_body(rng, 8)])
    idx.close()

    class Wide(di.PackedCodeIndex):
        key_bytes = 16

    with pytest.raises(ValueError, match="key_bytes=8, expected 16"):
        Wide(path, device="cpu")
    # The reference's 16-byte index refuses the port's directory the same way.
    with pytest.raises(ValueError, match="key_bytes=8, expected 16"):
        jax_di.DeviceHammingIndex(path)


def test_wide_keys_persist(tmp_path, rng):
    """ROW_BYTES follows the key width, and 16-byte keys survive a reload."""

    class Wide(di.PackedCodeIndex):
        key_bytes = 16

    idx = Wide(tmp_path / "w", shard_size=53 * 2000, device="cpu")
    assert idx.ROW_BYTES == 53 and idx.shard_rows == 2000
    key = bytes(range(16))
    idx.add([key], [rand_body(rng, 8)])
    idx.close()
    idx2 = Wide(tmp_path / "w", device="cpu")
    assert key in idx2
    idx2.close()
    ref = jax_di.DeviceHammingIndex(tmp_path / "w", ndim=64)
    assert key in ref
    ref.close()


# -------------- cases of tests/test_engine_durability.py, against the port


def test_compaction_crash_window_preserves_old_state(tmp_path, rng):
    idx = port_index(tmp_path / "i", shard_size=1)
    n = 2500
    bodies = [rand_body(rng) for _ in range(n)]
    idx.add(list(range(n)), bodies)
    idx.save(wait=True)  # seals segments + commits a manifest
    assert idx.shard_count > 1
    idx.remove(list(range(0, n, 2)))  # 50% tombstones
    idx.save(wait=True)

    # Compact WITHOUT a follow-up save: a crash before the new manifest
    # lands. The committed manifest's files must all still exist.
    idx.compact()
    reopened = port_index(tmp_path / "i", shard_size=1)
    try:
        assert reopened.size == n // 2
        assert reopened.get(1) == bodies[1]
        assert reopened.get(0) is None  # tombstone persisted by the save
    finally:
        reopened.close()
    idx.close()
    # The save at close committed the compacted layout; the old segments went after it.
    final = port_index(tmp_path / "i", shard_size=1)
    assert (final.size, final._rows) == (n // 2, n // 2)
    assert len(list((tmp_path / "i").glob("seg-*.npz"))) == final.shard_count - 1
    final.close()


def test_crash_before_manifest_preserves_old_state(tmp_path, rng, monkeypatch):
    idx = port_index(tmp_path / "i")
    bodies = [rand_body(rng) for _ in range(20)]
    idx.add(list(range(20)), bodies)
    idx.save(wait=True)

    idx.add(list(range(20, 40)), [rand_body(rng) for _ in range(20)])
    real_write = di._atomic_write

    def crashing_write(path, data, **kw):
        if path.name == "state.json":
            raise OSError("power loss (simulated)")
        return real_write(path, data, **kw)

    monkeypatch.setattr(di, "_atomic_write", crashing_write)
    idx.save(wait=True)
    assert idx.dirty > 0 and idx._resave_all  # the worker's failure is on record
    monkeypatch.setattr(di, "_atomic_write", real_write)

    for make in (port_index, JaxIndex):
        reopened = make(tmp_path / "i")
        try:
            # The OLD manifest with its OWN files loads intact: exactly the
            # first 20 rows (new data files have fresh names).
            assert reopened.size == 20
            assert reopened.get(7) == bodies[7]
        finally:
            reopened.close()
    idx.close()
    final = port_index(tmp_path / "i")
    assert final.size == 40
    final.close()


@pytest.mark.parametrize("fail_at", ["seg-", "active-", "valid-", "fsync"])
def test_a_crash_at_any_write_before_the_manifest_keeps_the_old_state(tmp_path, rng, monkeypatch, fail_at):
    idx = port_index(tmp_path / "i", shard_size=1)
    bodies = [rand_body(rng, 8) for _ in range(1500)]
    idx.add(list(range(1500)), bodies)
    idx.save(wait=True)
    old_manifest = (tmp_path / "i" / "state.json").read_bytes()
    idx.add(list(range(1500, 2600)), [rand_body(rng, 8) for _ in range(1100)])  # seals a second segment
    idx.remove([1])

    real_write, real_fsync_dir = di._atomic_write, di._fsync_dir

    def crashing_write(path, data, **kw):
        if path.name.startswith(fail_at):
            raise OSError("power loss (simulated)")
        return real_write(path, data, **kw)

    def crashing_fsync(path):
        raise OSError("power loss (simulated)")

    monkeypatch.setattr(di, "_atomic_write", crashing_write)
    if fail_at == "fsync":
        monkeypatch.setattr(di, "_fsync_dir", crashing_fsync)
    idx.save(wait=True)
    assert idx.dirty > 0
    assert (tmp_path / "i" / "state.json").read_bytes() == old_manifest
    monkeypatch.setattr(di, "_atomic_write", real_write)
    monkeypatch.setattr(di, "_fsync_dir", real_fsync_dir)
    reopened = port_index(tmp_path / "i", shard_size=1)
    assert reopened.size == 1500 and reopened.get(1) == bodies[1]
    reopened.close()
    idx.save(wait=True)  # re-emits every sealed file
    assert idx.dirty == 0
    idx.close()
    final = port_index(tmp_path / "i", shard_size=1)
    assert final.size == 2599 and final.get(1) is None and final.shard_count == 3
    final.close()


def test_older_snapshot_never_replaces_newer(tmp_path, rng):
    idx = port_index(tmp_path / "i")
    idx.add([1], [rand_body(rng)])
    with idx._lock:
        s1 = idx._snapshot_locked()
    idx.add([2], [rand_body(rng)])
    with idx._lock:
        s2 = idx._snapshot_locked()
    assert s2["seq"] > s1["seq"]
    # Enqueue newer first, then the older (the descheduled-thread race)
    idx._enqueue_save(s2, wait=False)
    idx._enqueue_save(s1, wait=True)
    reopened = port_index(tmp_path / "i")
    try:
        assert reopened.size == 2  # s2 won; s1 must not have clobbered it
    finally:
        reopened.close()
    # In-flight variant: s2 already WRITTEN when the older s1 arrives: the
    # written-seq watermark must drop it.
    with idx._lock:
        s3 = idx._snapshot_locked()
    idx._enqueue_save(s3, wait=True)
    idx._enqueue_save(s1, wait=True)
    reopened = port_index(tmp_path / "i")
    try:
        assert reopened.size == 2
    finally:
        reopened.close()
    idx.close()


# ------------------ cases of tests/test_persistence.py, against the port


def test_background_save_does_not_block_mutations(tmp_path, monkeypatch):
    """add() proceeds while a save's file I/O is still in flight."""
    gate = {"slow": True}
    real_write = di._atomic_write

    def slow_write(path, data, **kw):
        if gate["slow"]:
            time.sleep(0.5)
        real_write(path, data, **kw)

    monkeypatch.setattr(di, "_atomic_write", slow_write)
    idx = port_index(tmp_path / "bg")
    idx.add([1, 2, 3], [bytes([i]) * 8 for i in range(3)])
    t0 = time.perf_counter()
    idx.save(wait=False)  # schedules; the worker sleeps inside _atomic_write
    scheduled = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.add([4], [b"\x07" * 8])  # must not wait for the 0.5 s write
    mutated = time.perf_counter() - t0
    assert scheduled < 0.3, f"save(wait=False) blocked for {scheduled:.2f}s"
    assert mutated < 0.3, f"add blocked for {mutated:.2f}s behind the background save"
    idx.drain_rotations()
    gate["slow"] = False
    idx.close()
    idx2 = port_index(tmp_path / "bg")
    assert idx2.size == 4 and 4 in idx2
    idx2.close()


def test_background_save_coalesces_and_drains(tmp_path):
    idx = port_index(tmp_path / "co")
    for burst in range(5):
        idx.add([burst * 10 + j for j in range(10)], [bytes([burst, j]) * 4 for j in range(10)])
        idx.save(wait=False)
    idx.drain_rotations()
    assert idx.dirty == 0
    assert (tmp_path / "co" / "state.json").exists()
    idx.close()
    idx2 = port_index(tmp_path / "co")
    assert idx2.size == 50
    idx2.close()
    # Only the last committed save's rewritable files are left.
    state = json.loads((tmp_path / "co" / "state.json").read_text())
    assert sorted(f.name for f in (tmp_path / "co").iterdir()) == sorted(
        [state["active"]["file"], state["valid_file"], "state.json"]
    )


def test_coalesced_seals_ride_the_next_snapshot(tmp_path, rng, monkeypatch):
    """A snapshot that sealed a segment is superseded in the queue before it
    is written: the newer snapshot carries the sealed file."""
    idx = port_index(tmp_path / "i", shard_size=1)
    gate = {"hold": True}
    real_write = di._atomic_write

    def held_write(path, data, **kw):
        while gate["hold"]:
            time.sleep(0.01)
        real_write(path, data, **kw)

    monkeypatch.setattr(di, "_atomic_write", held_write)
    idx.add([0], [rand_body(rng, 8)])
    idx.save(wait=False)  # in flight, held
    idx.add(list(range(1, 1100)), [rand_body(rng, 8) for _ in range(1099)])
    idx.save(wait=False)  # queued: seals seg-00000001
    idx.add([5000], [rand_body(rng, 8)])
    idx.save(wait=False)  # replaces the queued snapshot
    assert idx._save_queue["seq"] == 3 and "seg-00000001.npz" in idx._save_queue["sealed_files"]
    gate["hold"] = False
    idx.drain_rotations()
    assert not idx._unconfirmed_seals
    idx.close()
    idx2 = port_index(tmp_path / "i", shard_size=1)
    assert idx2.size == 1101 and idx2.shard_count == 2
    idx2.close()


def test_background_save_failure_marks_dirty_and_recovers(tmp_path, monkeypatch, caplog):
    real_write = di._atomic_write
    boom = {"on": True}

    def failing_write(path, data, **kw):
        if boom["on"]:
            raise OSError("disk on fire")
        real_write(path, data, **kw)

    monkeypatch.setattr(di, "_atomic_write", failing_write)
    idx = port_index(tmp_path / "fail")
    idx.add([1, 2], [b"\x01" * 8, b"\x02" * 8])
    with caplog.at_level("ERROR", logger=di.__name__):
        idx.save(wait=True)  # the write fails on the worker
    assert any("background save failed" in r.message for r in caplog.records)
    assert idx.dirty > 0  # the failure re-marks unsaved state
    boom["on"] = False
    idx.save(wait=True)
    assert idx.dirty == 0
    idx.close()
    idx2 = port_index(tmp_path / "fail")
    assert idx2.size == 2
    idx2.close()


def test_close_saves_what_a_failed_background_write_left(tmp_path, rng, monkeypatch):
    real_write = idx_write = di.PackedCodeIndex._write_snapshot
    calls = {"n": 0}

    def flaky(self, snapshot):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("disk full (injected)")
        return real_write(self, snapshot)

    monkeypatch.setattr(di.PackedCodeIndex, "_write_snapshot", flaky)
    idx = port_index(tmp_path / "i")
    idx.add([1, 2], rand_bodies(rng, 2))
    idx.save(wait=False)
    idx.close()  # drains (the write fails), finds the index dirty, saves again
    assert calls["n"] == 2 and idx_write is real_write
    idx2 = port_index(tmp_path / "i")
    assert idx2.size == 2
    idx2.close()


# -------------------------- cases of the branch tests, against the port


def test_failed_save_reemits_all_segments(tmp_path, rng, monkeypatch):
    """A failed background write marks _resave_all; the next save re-emits
    every sealed segment, and an unconfirmed seal without the flag re-emits
    just that file."""
    idx = port_index(tmp_path / "d", shard_size=1)
    idx.add(list(range(2100)), [rand_body(rng, 8) for _ in range(2100)])

    real_write = idx._write_snapshot
    calls = {"n": 0}
    written = []

    def flaky(snapshot):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("disk full (injected)")
        written.append([seg["file"] for seg, *_ in snapshot["writes"]])
        return real_write(snapshot)

    monkeypatch.setattr(idx, "_write_snapshot", flaky)
    idx.save()  # fails in the worker; the index is re-marked dirty
    assert idx.dirty > 0 and idx._resave_all
    idx.save()  # re-emits both sealed segments + active
    assert idx.dirty == 0 and not idx._resave_all and not idx._unconfirmed_seals
    assert written[-1] == ["seg-00000001.npz", "seg-00000002.npz", "active-00000002.npz"]
    seg_file = idx._segments[0]["file"]
    idx._unconfirmed_seals.add(seg_file)
    idx.save()
    assert seg_file not in idx._unconfirmed_seals
    assert written[-1] == ["seg-00000001.npz", "active-00000003.npz"]
    idx.save()  # confirmed seals are written once
    assert written[-1] == ["active-00000004.npz"]
    idx2 = port_index(tmp_path / "d")
    assert idx2.size == 2100
    idx2.close()
    idx.close()


def test_resave_all_after_failed_segment_write(tmp_path, rng, monkeypatch):
    idx = port_index(tmp_path / "i", shard_size=4 * 1024)
    n = idx.shard_rows
    idx.add(list(range(n)), [rand_body(rng) for _ in range(n)])
    real_write = di._atomic_write

    def failing(path, data, sync_dir=True):
        raise OSError("disk full")

    monkeypatch.setattr(di, "_atomic_write", failing)
    idx.save()
    idx.drain_rotations()  # the write failed; seals stay unconfirmed
    monkeypatch.setattr(di, "_atomic_write", real_write)
    idx.save()
    idx.drain_rotations()
    idx.close()
    idx2 = port_index(tmp_path / "i")
    assert len(idx2) == n
    idx2.close()


def test_load_truncates_at_missing_segment(tmp_path, rng):
    idx = port_index(tmp_path / "d", shard_size=1)
    idx.add(list(range(2100)), [rand_body(rng, 8) for _ in range(2100)])
    idx.save()
    seg0, seg1 = (seg["file"] for seg in idx._segments)
    idx.close()
    (tmp_path / "d" / seg1).unlink()
    idx = port_index(tmp_path / "d")
    assert idx.size == 1024 and idx._rows == 1024  # the load stops at the gap
    idx.save_enabled = False
    idx.close()
    (tmp_path / "d" / seg0).unlink()
    idx = port_index(tmp_path / "d")
    assert idx.size == 0
    idx.save_enabled = False
    idx.close()


_RESIDUE = {
    "active-00000000.npz": False,  # <= save_seq: deleted
    "valid-00000000.npz": False,
    "seg-00000000.npz": False,  # <= file_seq: deleted
    "seg-00000099.npz": True,  # > file_seq: another writer's, kept
    "seg-99999999.npz": True,
    "active-99999999.npz": True,  # > save_seq: kept
    "seg-abc.npz": True,  # unparseable: kept
    "seg-001.npz": True,  # seg with other than 8 digits: kept
    "seg-0001.npz": True,
    "bogus-xy.npz": True,
    "other-123.npz": True,  # digits but an unknown prefix: kept
    "notes.txt": True,  # a user's file: kept
    "state.json123.tmp": False,  # manifest tmp: deleted
    "active-00000000.npz.123.tmp": False,  # stale data tmp: deleted
    "seg-00000000.npz.tmp": False,
    "seg-00000099.npz.456.tmp": True,  # an in-flight writer's tmp: kept
    "seg-99999999.npz.tmp": True,
}


@pytest.mark.parametrize("name,kept", sorted(_RESIDUE.items()))
def test_gc_sequence_guard(tmp_path, rng, name, kept):
    """GC on open: files at or below the committed counters go, files above
    them (another live instance's save in flight) and files it cannot parse
    stay. The reference decides the same."""
    p = tmp_path / "d"
    idx = port_index(p, shard_size=1)
    idx.add(list(range(1100)), [rand_body(rng, 8) for _ in range(1100)])
    idx.save()
    idx.close()
    (p / name).write_bytes(b"residue")
    (p / "subdir").mkdir()
    idx = port_index(p)
    try:
        assert idx.size == 1100
        assert (p / name).exists() is kept
        assert (p / "subdir").is_dir()
    finally:
        idx.close()
    (p / name).write_bytes(b"residue")
    ref = JaxIndex(p)
    try:
        assert (p / name).exists() is kept
    finally:
        ref.close()


def test_drain_rotations_noop_and_close_idempotent(tmp_path):
    idx = port_index(tmp_path / "d")
    idx.drain_rotations()  # nothing queued
    idx.close()
    idx.close()
    idx.drain_rotations()  # after close: still a no-op
    assert not (tmp_path / "d").exists()  # nothing was dirty, nothing written


def test_close_twice_saves_once(tmp_path, rng, monkeypatch):
    idx = port_index(tmp_path / "d")
    idx.add([1], rand_bodies(rng, 1))
    calls = []
    real = idx._write_snapshot
    monkeypatch.setattr(idx, "_write_snapshot", lambda snap: (calls.append(snap["seq"]), real(snap)))
    idx.close()
    idx.close()
    assert calls == [1]
    assert idx._save_thread is not None and not idx._save_thread.is_alive()


def test_atomic_write_failure_cleans_tmp(tmp_path, monkeypatch):
    target = tmp_path / "f.bin"
    monkeypatch.setattr(os, "replace", lambda a, b: (_ for _ in ()).throw(OSError("boom")))
    with pytest.raises(OSError, match="boom"):
        di._atomic_write(target, b"data")
    assert not target.exists()
    assert not list(tmp_path.glob("*.tmp"))
    # unlink failing too must not mask the original error
    monkeypatch.setattr(os, "unlink", lambda p: (_ for _ in ()).throw(OSError("x")))
    with pytest.raises(OSError, match="boom"):
        di._atomic_write(target, b"data")


def test_atomic_write_syncs_file_then_directory(tmp_path, monkeypatch):
    """fsync of the data before the rename, of the directory after it; a
    batch writer (sync_dir=False) leaves the directory to its caller."""
    events = []
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(os, "fsync", lambda fd: (events.append("fsync"), real_fsync(fd))[1])
    monkeypatch.setattr(os, "replace", lambda a, b: (events.append("replace"), real_replace(a, b))[1])
    di._atomic_write(tmp_path / "a.bin", b"data")
    assert events == ["fsync", "replace", "fsync"]
    del events[:]
    di._atomic_write(tmp_path / "b.bin", b"data", sync_dir=False)
    assert events == ["fsync", "replace"]
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes() == b"data"


def test_save_orders_data_directory_fsync_manifest_deletes(tmp_path, rng, monkeypatch):
    """Every data file, ONE directory fsync, then the manifest (with its own
    directory fsync), and only then the superseded files go."""
    idx = port_index(tmp_path / "i", shard_size=1)
    idx.add(list(range(1100)), [rand_body(rng, 8) for _ in range(1100)])
    idx.save()
    idx.add([5000], [rand_body(rng, 8)])
    events = []
    real_write, real_fsync_dir = di._atomic_write, di._fsync_dir

    def write(path, data, sync_dir=True):
        events.append(("write", path.name, sync_dir, (tmp_path / "i" / "active-00000001.npz").exists()))
        return real_write(path, data, sync_dir=sync_dir)

    def fsync_dir(path):
        events.append(("fsync_dir",))
        return real_fsync_dir(path)

    monkeypatch.setattr(di, "_atomic_write", write)
    monkeypatch.setattr(di, "_fsync_dir", fsync_dir)
    idx.save()
    assert events == [
        ("write", "active-00000002.npz", False, True),  # the sealed segment is not written again
        ("write", "valid-00000002.npz", False, True),
        ("fsync_dir",),
        ("write", "state.json", True, True),  # the old files are still there at the commit
        ("fsync_dir",),
    ]
    assert not (tmp_path / "i" / "active-00000001.npz").exists()
    assert not (tmp_path / "i" / "valid-00000001.npz").exists()
    idx.close()


def test_enqueue_save_coalescing_arms(tmp_path, rng, monkeypatch):
    idx = port_index(tmp_path / "i")
    idx.add([1], rand_bodies(rng, 1))
    written_before = idx._written_seq
    monkeypatch.setattr(idx, "_save_worker", lambda: None)  # inert worker
    idx._written_seq = 99
    # stale + wait=True: dropped AND the wait is skipped (nothing queued)
    idx._enqueue_save({"seq": 1}, wait=True)
    assert idx._save_queue is None
    idx._enqueue_save({"seq": 100}, wait=False)
    assert idx._save_queue == {"seq": 100}
    idx._enqueue_save({"seq": 100}, wait=False)  # not newer than queued: dropped
    idx._enqueue_save({"seq": 101}, wait=False)  # newer: replaces
    assert idx._save_queue == {"seq": 101}
    idx._save_queue = None
    idx._written_seq = written_before
    monkeypatch.undo()
    idx.close()


def test_drain_rotations_waits_for_inflight(tmp_path, rng, monkeypatch):
    idx = port_index(tmp_path / "i")
    idx.add([1], rand_bodies(rng, 1))
    real_write = di._atomic_write

    def slow_write(path, data, sync_dir=True):
        time.sleep(0.3)
        return real_write(path, data, sync_dir)

    monkeypatch.setattr(di, "_atomic_write", slow_write)
    idx.save(wait=False)
    idx.drain_rotations()
    assert (tmp_path / "i" / "state.json").exists() and idx._written_seq == 1
    idx.close()


def test_second_save_skips_confirmed_seals(tmp_path, rng):
    idx = port_index(tmp_path / "i", shard_size=4 * 1024)
    n = idx.shard_rows
    idx.add(list(range(n)), [rand_body(rng) for _ in range(n)])
    idx.save()
    seg = tmp_path / "i" / "seg-00000001.npz"
    stamp = seg.stat().st_mtime_ns
    idx.add([n + 1], [rand_body(rng)])
    idx.save()
    assert seg.stat().st_mtime_ns == stamp  # sealed segments are write-once
    idx.close()


def test_saves_and_searches_from_many_threads(tmp_path, rng):
    """Adds, background saves and searches race; the last committed manifest
    loads whole, and the final save holds every key."""
    import sys
    import threading

    idx = port_index(tmp_path / "i", shard_size=1)
    bodies = rand_bodies(rng, 4000)
    errors = []
    stop = threading.Event()

    def writer(t):
        try:
            for start in range(t * 1000, (t + 1) * 1000, 100):
                idx.add(list(range(start, start + 100)), bodies[start : start + 100])
                idx.save(wait=False)
        except Exception as exc:  # the test reports it below
            errors.append(exc)

    def searcher():
        try:
            while not stop.is_set():
                for keys, scores in idx.search(bodies[:3], 2):
                    assert len(keys) == len(scores)
        except Exception as exc:
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(t,)) for t in range(4)] + [threading.Thread(target=searcher)]
        for th in threads:
            th.start()
        for th in threads[:4]:
            th.join(timeout=120)
        stop.set()
        threads[4].join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    idx.drain_rotations()
    probe = port_index(tmp_path / "i", shard_size=1)  # a committed manifest is whole at any time
    assert probe.size == probe._rows > 0
    probe.save_enabled = False
    probe.close()
    idx.close()
    final = port_index(tmp_path / "i", shard_size=1)
    assert final.size == 4000 and final.shard_count == 4
    assert final.get(3999) == bodies[3999]
    final.close()
