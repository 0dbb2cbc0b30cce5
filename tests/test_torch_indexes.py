"""The port's memory and kv backends and its backend factory against the JAX
package's, on the CPU.

- ``MemoryIndex`` and ``KvIndexManager`` of both packages take the same
  calls (index CRUD, adds and updates, reads, searches by ISCC-CODE, units
  with prefixes both ways and ISCC-ID, and the calls that fail) and answer
  the same, compared by ``model_dump()`` and by exception type and message.
- A kv directory written by either package opens in the other and answers
  the same (the store format is shared: ``native/store.cpp`` is a copy).
- ``get_index`` and ``manager_for`` take every scheme and alias as the JAX
  factory does, with its error messages; the ``tpu`` schemes open on the
  device asked for, and the default device (the card) raises without one.
"""

import numpy as np
import pytest
import torch

from iscc_search_tpu import options as jax_options
from iscc_search_tpu import schema as jax_schema
from iscc_search_tpu.indexes.kv import KvIndexManager as JaxKvManager
from iscc_search_tpu.indexes.memory import MemoryIndex as JaxMemoryIndex
from iscc_search_tpu_torch import codec as ic
from iscc_search_tpu_torch import options, schema
from iscc_search_tpu_torch.indexes.kv import KvIndex, KvIndexManager
from iscc_search_tpu_torch.indexes.memory import MemoryIndex
from iscc_search_tpu_torch.indexes.tpu import TpuIndexManager


def _unit(mtype, stype, body):
    header = ic.encode_header(mtype, stype, ic.VS.V0, ic.encode_length(mtype, len(body) * 8))
    return "ISCC:" + ic.encode_base32(header + body)


def make_assets(n=12, seed=23):
    """Wire assets with META, CONTENT and DATA units of 64, 128 or 256 bits
    and a 64-bit INSTANCE unit, their ISCC-CODE and metadata. Asset ``i``
    with ``i % 3 == 1`` stores a 64-bit prefix of asset ``i - 1``'s DATA
    body; ``i % 3 == 2`` extends asset ``i - 2``'s DATA body to 256 bits, so
    the kv backend's prefix matching works both ways."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        width = int(rng.choice([8, 16, 32]))
        meta, content, data, instance = rng.bytes(width), rng.bytes(width), rng.bytes(16), rng.bytes(8)
        if i % 3 == 1:
            data = out[-1]["_data"][:8]
        elif i % 3 == 2:
            data = out[-2]["_data"][:16] + rng.bytes(16)
        units = [_unit(ic.MT.META, ic.ST.NONE, meta), _unit(ic.MT.CONTENT, ic.ST_CC.TEXT, content),
                 _unit(ic.MT.DATA, ic.ST.NONE, data), _unit(ic.MT.INSTANCE, ic.ST.NONE, instance)]
        out.append({"_data": data, "iscc_id": ic.gen_iscc_id_v1(timestamp_us=1_650_000_000_000_000 + i,
                                                                server_id=i)["iscc"],
                    "iscc_code": ic.gen_iscc_code_v0(units)["iscc"], "units": units,
                    "metadata": {"name": f"asset {i}", "tags": [i, None]}})
    return [{k: v for k, v in a.items() if k != "_data"} for a in out]


def _plain(value):
    if isinstance(value, list):
        return [_plain(v) for v in value]
    return value.model_dump(mode="json") if hasattr(value, "model_dump") else value


def drive(backend, wire):
    """Every call of the protocol on ``backend`` with ``wire``'s (JAX or
    port) schema: [(outcome, value or message)]."""
    assets = make_assets()
    entry, query, index = wire.IsccEntry, wire.IsccQuery, wire.IsccIndex
    other_realm = ic.gen_iscc_id_v1(timestamp_us=1, server_id=1, realm_id=1)["iscc"]
    calls = [
        (backend.create_index, index(name="alpha")), (backend.create_index, index(name="alpha")),
        (backend.create_index, index(name="beta")), (backend.list_indexes,), (backend.get_index, "alpha"),
        (backend.get_index, "missing"),
        (backend.add_assets, "alpha", [entry(**a) for a in assets]),
        (backend.add_assets, "alpha", [entry(**{**a, "units": a["units"][1:]}) for a in assets[:2]]),
        (backend.add_assets, "alpha", [entry(units=assets[0]["units"])]),
        (backend.add_assets, "alpha", [entry(**{**assets[0], "iscc_id": other_realm})]),
        (backend.add_assets, "missing", [entry(**assets[0])]),
        (backend.get_index, "alpha"), (backend.list_indexes,),
        *[(backend.get_asset, "alpha", a["iscc_id"]) for a in assets[:4]],
        (backend.get_asset, "alpha", "ISCC:MAIGIIFJRDGEQQAA"), (backend.get_asset, "missing", assets[0]["iscc_id"]),
        *[(backend.search_assets, "alpha", query(**q), limit) for a in assets[:6] for limit in (1, 10) for q in (
            {"iscc_code": a["iscc_code"]}, {"units": a["units"]}, {"units": a["units"][2:3]}, {"iscc_id": a["iscc_id"]})],
        (backend.search_assets, "alpha", query()), (backend.search_assets, "missing", query(iscc_code=assets[0]["iscc_code"])),
        (backend.delete_index, "beta"), (backend.delete_index, "beta"), (backend.get_index, "beta"),
        (backend.list_indexes,),
    ]
    out = []
    for fn, *args in calls:
        try:
            out.append(("ok", _plain(fn(*args))))
        except Exception as exc:  # noqa: BLE001 - the outcome is compared
            out.append((type(exc).__name__, str(exc)))
    return out


@pytest.mark.parametrize("kind", ["memory", "kv"])
def test_the_backend_answers_as_the_jax_backend(kind, tmp_path):
    if kind == "memory":
        ours, theirs = MemoryIndex(), JaxMemoryIndex()
    else:
        ours, theirs = KvIndexManager(tmp_path / "port"), JaxKvManager(tmp_path / "jax")
    got, want = drive(ours, schema), drive(theirs, jax_schema)
    ours.close()
    theirs.close()
    assert [o for o, _ in got] == [o for o, _ in want]
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, i
    assert {o for o, _ in got} == {"ok", "FileExistsError", "FileNotFoundError", "ValueError"}
    searches = [v for o, v in got if o == "ok" and isinstance(v, dict) and "global_matches" in v]
    assert sum(len(s["global_matches"]) > 1 for s in searches) > 0  # prefixes match other assets


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_kv_directory_opens_in_the_other_package(writer, tmp_path):
    assets = make_assets()
    packages = {"jax": (JaxKvManager, jax_schema), "port": (KvIndexManager, schema)}
    (write_cls, write_wire), (read_cls, read_wire) = packages[writer], packages["port" if writer == "jax" else "jax"]
    manager = write_cls(tmp_path)
    manager.create_index(write_wire.IsccIndex(name="alpha"))
    manager.add_assets("alpha", [write_wire.IsccEntry(**a) for a in assets])

    def answers(m, wire):
        return [_plain(m.list_indexes()), _plain(m.get_index("alpha"))] + [
            _plain(m.get_asset("alpha", a["iscc_id"])) for a in assets] + [
            _plain(m.search_assets("alpha", wire.IsccQuery(units=a["units"]), 10)) for a in assets]

    before = answers(manager, write_wire)
    manager.close()
    other = read_cls(tmp_path)
    assert answers(other, read_wire) == before
    other.add_assets("alpha", [read_wire.IsccEntry(**{**assets[0], "metadata": {"name": "changed"}})])
    other.close()
    again = write_cls(tmp_path)
    assert again.get_asset("alpha", assets[0]["iscc_id"]).metadata == {"name": "changed"}
    assert again.get_index("alpha").assets == len(assets)
    again.close()


def test_the_kv_index_reports_its_realm_and_count(tmp_path):
    index = KvIndex(tmp_path / "one.kv")
    assert index.get_realm_id() is None and index.get_asset_count() == 0
    index.add_assets([schema.IsccEntry(**a) for a in make_assets(3)])
    assert index.get_realm_id() == 0 and index.get_asset_count() == 3 and index.used_bytes() > 0
    index.close()


# ------------------------------------------------------------- the factory


@pytest.mark.parametrize("uri", ["memory://", "memory://anything"])
def test_memory_uris(uri):
    assert type(options.get_index(uri)) is MemoryIndex
    assert type(jax_options.get_index(uri)) is JaxMemoryIndex


@pytest.mark.parametrize("scheme", ["kv", "lmdb"])
def test_kv_schemes(scheme, tmp_path):
    for uri in (f"{scheme}://{tmp_path}/a", f"{scheme}:///{tmp_path}/b"):  # one or two leading slashes
        ours, theirs = options.get_index(uri), jax_options.get_index(uri)
        assert type(ours) is KvIndexManager and type(theirs) is JaxKvManager
        assert ours.base_path == theirs.base_path and ours.base_path.is_dir()
        ours.close()
        theirs.close()
    manager = options.manager_for(scheme, str(tmp_path / "c"))
    assert type(manager) is KvIndexManager and manager.base_path == tmp_path / "c"


@pytest.mark.parametrize("scheme", ["tpu", "usearch"])
def test_tpu_schemes_open_on_the_device_asked_for(scheme, tmp_path):
    manager = options.get_index(f"{scheme}://{tmp_path}/a", device="cpu")
    assert type(manager) is TpuIndexManager and manager.device == torch.device("cpu")
    assert manager.base_path == tmp_path / "a"
    manager.close()
    manager = options.manager_for(scheme, str(tmp_path / "b"), device="cpu")
    assert type(manager) is TpuIndexManager and manager.base_path == tmp_path / "b"
    manager.close()


def test_the_tpu_scheme_defaults_to_the_card(tmp_path):
    """``device`` defaults to ``"cuda"``: without a card the factory raises
    and writes nothing; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device opens")
    for open_default in (lambda: options.get_index(f"tpu://{tmp_path}/a"),
                         lambda: options.manager_for("usearch", str(tmp_path / "b"))):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            open_default()
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("call", [
    lambda m: m.get_index("/no/scheme"), lambda m: m.get_index("ftp://host/x"),
    lambda m: m.get_index("postgres:///db"), lambda m: m.manager_for("bogus", "/p"),
    lambda m: m.manager_for("bogus", "/p", uri="bogus:///p"),
])
def test_refusals_read_as_the_jax_factory(call):
    with pytest.raises(ValueError) as ours:
        call(options)
    with pytest.raises(ValueError) as theirs:
        call(jax_options)
    assert str(ours.value) == str(theirs.value)


def test_no_uri_reads_the_options(monkeypatch):
    monkeypatch.setattr(options, "search_opts", options.SearchOptions(index_uri="memory://"))
    assert type(options.get_index()) is MemoryIndex


@pytest.mark.parametrize("path,want", [("/a/b", "/a/b"), ("//a/b", "/a/b"), ("a", "a")])
def test_uri_paths_normalise_as_the_jax_factory(path, want):
    assert options._normalize_uri_path(path) == jax_options._normalize_uri_path(path) == want
