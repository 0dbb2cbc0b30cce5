"""The port's asset-level entry point against the JAX package's, on the CPU.

``TpuIndex`` (``indexes/tpu/index.py``) of both packages takes the same
assets, made with numpy from a seed: ISCC-IDs, META, SEMANTIC, CONTENT and
DATA units at 64, 128 and 256 bits, INSTANCE units, simprints of two types
(128 and 64 bits) and metadata. The port runs with ``device="cpu"``.

- ``add_assets`` returns the same ``IsccAddResult`` list (created, updated,
  within-batch duplicates, the idempotent no-op, stale-INSTANCE cleanup);
- ``search_assets`` results are equal by ``model_dump()`` for units,
  INSTANCE prefixes both ways, simprints (scan and ``exact=True``) and an
  ISCC-ID query; ``get_asset`` likewise;
- a directory written by either package's ``TpuIndex`` opens in the other
  and answers the same; ``flush``/``close``/reopen answers the same;
- the wire schema and the search options hold to the JAX package's
  (pydantic) ones: field names, defaults, ``model_dump()``, env parsing;
- ``SearchBatcher`` runs cases of ``tests/test_batcher.py`` on the port's
  index.

Scores are compared bit for bit: the units are 64, 128 or 256 bits wide,
where the scale ``1 / (2 * bits)`` is a power of two (a 192-bit common
prefix may differ by one ulp, ROADMAP.md's parity rule, and is left out).
Ties: near-duplicates are planted at distinct distances, one per stored
asset, so no two candidates above a match threshold tie at a cut (see
``tests/test_torch_simprint.py``).
"""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch
from pydantic import ValidationError

import tests.test_batcher as jax_batcher_tests
from iscc_search_tpu import options as jax_options
from iscc_search_tpu import schema as jax_schema
from iscc_search_tpu.indexes import common as jax_common
from iscc_search_tpu.indexes.tpu import TpuIndex as JaxTpuIndex
from iscc_search_tpu.indexes.tpu import TpuIndexManager as JaxManager
from iscc_search_tpu_torch import codec as ic
from iscc_search_tpu_torch import options, schema
from iscc_search_tpu_torch.engine import DeviceNphdIndex
from iscc_search_tpu_torch.engine.batcher import SearchBatcher
from iscc_search_tpu_torch.indexes import common
from iscc_search_tpu_torch.indexes.tpu import TpuIndex, TpuIndexManager

SP128, SP64 = "CONTENT_TEXT_V0", "DATA_V0"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs test files in parallel processes: each takes one torch
    thread, so the plain versions' CPU work does not starve the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def unit(mtype, stype, body):
    header = ic.encode_header(mtype, stype, ic.VS.V0, ic.encode_length(mtype, len(body) * 8))
    return "ISCC:" + ic.encode_base32(header + body)


def iscc_id(n):
    return ic.gen_iscc_id_v1(timestamp_us=n + 1, server_id=n % 4096, realm_id=0)["iscc"]


def flip(body, nbits, rng):
    arr = np.frombuffer(body, np.uint8).copy()
    for p in rng.choice(len(arr) * 8, nbits, replace=False):
        arr[p // 8] ^= 1 << (p % 8)
    return arr.tobytes()


def _simprints(vecs, step=100):
    return [{"simprint": ic.encode_base64(v), "offset": i * step, "size": step} for i, v in enumerate(vecs)]


def corpus(seed=0, n=120):
    """Asset dicts: random units and simprints; assets 100-109 are near
    copies of assets 0-9 (units with i+1 bits flipped, simprints with
    distinct flips), so each target has one near-duplicate."""
    rng = np.random.default_rng(seed)
    widths = (8, 16, 32)
    assets = []
    for a in range(n):
        bodies = {
            "meta": rng.bytes(8),
            "sem": rng.bytes(int(rng.choice(widths))),
            "content": rng.bytes(int(rng.choice(widths))),
            "data": rng.bytes(int(rng.choice(widths))),
            "instance": rng.bytes(int(rng.choice(widths))),
        }
        sp128 = [rng.bytes(16) for _ in range(int(rng.integers(3, 9)))]
        sp64 = [rng.bytes(8) for _ in range(int(rng.integers(1, 4)))]
        if a >= 100:
            src = assets[a - 100]["_bodies"]
            i = a - 100
            bodies = {k: flip(src[k], i + 1, rng) for k in ("meta", "sem", "content", "data")}
            bodies["instance"] = src["instance"][:8]  # an INSTANCE prefix of the original
            sp128 = [flip(v, (i + c) % 9 + 1, rng) for c, v in enumerate(src["sp128"])]
            sp64 = src["sp64"][:1]  # an exact copy: document frequency 2
        bodies["sp128"], bodies["sp64"] = sp128, sp64
        asset = {
            "iscc_id": iscc_id(a),
            "units": [
                unit(ic.MT.META, ic.ST.NONE, bodies["meta"]),
                unit(ic.MT.SEMANTIC, ic.ST_CC.TEXT, bodies["sem"]),
                unit(ic.MT.CONTENT, ic.ST_CC.TEXT, bodies["content"]),
                unit(ic.MT.DATA, ic.ST.NONE, bodies["data"]),
                unit(ic.MT.INSTANCE, ic.ST.NONE, bodies["instance"]),
            ],
            "simprints": {SP128: _simprints(sp128), SP64: _simprints(sp64, 1000)},
            "metadata": {"name": f"asset {a}", "source": f"https://example.com/{a}", "n": a, "tags": ["x", a % 3]},
            "_bodies": bodies,
        }
        if a % 7 == 3:
            del asset["simprints"][SP64]
        if a % 11 == 5:
            asset["units"] = asset["units"][2:]  # no META, no SEMANTIC
        assets.append(asset)
    return assets


def wire(asset):
    return {k: v for k, v in asset.items() if not k.startswith("_")}


def _dump(results):
    return [r.model_dump() for r in results]


def _updates(assets, rng):
    """Changed units (an INSTANCE replaced, a unit type dropped), the same
    bytes again (idempotent), and a within-batch duplicate."""
    out = []
    for a in (20, 21, 22):  # units: META, SEMANTIC, CONTENT, DATA, INSTANCE
        changed = dict(wire(assets[a]))
        kept = changed["units"][2:4] if a == 21 else changed["units"][1:4]  # META dropped (and SEMANTIC)
        changed["units"] = kept + [unit(ic.MT.INSTANCE, ic.ST.NONE, rng.bytes(16))]  # a new INSTANCE
        out.append(changed)
    out.append(wire(assets[30]))  # unchanged: idempotent no-op, status "updated"
    dup = dict(wire(assets[40]))
    out += [dup, {**dup, "metadata": {"name": "renamed"}}]  # the last occurrence wins
    out.append(wire(corpus(seed=99, n=121)[120]))  # a new asset
    return out


def _queries(assets):
    a0, a3, a7 = assets[0], assets[3], assets[7]
    inst0 = a0["_bodies"]["instance"]
    return [
        {"units": a0["units"][:4]},
        {"units": a3["units"]},
        {"units": [unit(ic.MT.INSTANCE, ic.ST.NONE, inst0)]},
        {"units": [unit(ic.MT.INSTANCE, ic.ST.NONE, inst0[:8])]},
        {"units": [unit(ic.MT.INSTANCE, ic.ST.NONE, inst0 + bytes(32 - len(inst0)))] + a0["units"][3:4]},
        {"simprints": {SP128: [s["simprint"] for s in a7["simprints"][SP128]]}},
        {"simprints": {k: [s["simprint"] for s in v] for k, v in a3["simprints"].items()}},
        {"units": a7["units"][2:], "simprints": {SP128: [s["simprint"] for s in a7["simprints"][SP128][:2]]}},
        {"iscc_id": a3["iscc_id"]},
        {"iscc_id": assets[104]["iscc_id"]},
    ]


def _answers(index, query_cls, assets):
    out = []
    for q in _queries(assets):
        for limit, exact in ((3, False), (20, False), (20, True)):
            out.append(index.search_assets(query_cls(**q), limit=limit, exact=exact).model_dump())
    out.append([index.get_asset(assets[i]["iscc_id"]).model_dump() for i in (0, 21, 40, 104)])
    return out


@pytest.fixture(scope="module")
def assets():
    return corpus()


@pytest.fixture
def pair(tmp_path, assets):
    """Both packages' TpuIndex after the same adds and updates, with the
    add results of each step."""
    jx = JaxTpuIndex(tmp_path / "jax")
    pt = TpuIndex(tmp_path / "port", device="cpu")
    steps = [[wire(a) for a in assets[:60]], [wire(a) for a in assets[60:]], _updates(assets, np.random.default_rng(5))]
    added = []
    for batch in steps:
        added.append((_dump(jx.add_assets([jax_schema.IsccEntry(**a) for a in batch])),
                      _dump(pt.add_assets([schema.IsccEntry(**a) for a in batch]))))
    yield jx, pt, added
    jx.close()
    pt.close()


def test_add_assets_returns_what_the_jax_index_returns(pair):
    jx, pt, added = pair
    for want, got in added:
        assert got == want
    statuses = [r["status"] for r in added[2][1]]
    assert statuses == ["updated"] * 6 + ["created"]
    assert len(pt) == len(jx) == 121
    assert pt.derived_sizes == jx.derived_sizes


def test_search_assets_equals_the_jax_index(pair, assets):
    jx, pt, _ = pair
    got = _answers(pt, schema.IsccQuery, assets)
    want = _answers(jx, jax_schema.IsccQuery, assets)
    assert got == want
    # The planted near-duplicates are found: the cases are not empty.
    units0, sp7 = got[0], got[15]
    assert [m["iscc_id"] for m in units0["global_matches"][:2]] == [assets[0]["iscc_id"], assets[100]["iscc_id"]]
    assert [m["iscc_id"] for m in sp7["chunk_matches"][:2]] == [assets[7]["iscc_id"], assets[107]["iscc_id"]]
    assert sp7["chunk_matches"][1]["types"][SP128]["chunks"]
    assert all(m["iscc_id"] != assets[3]["iscc_id"] for m in got[24]["global_matches"])  # self-exclusion


def test_stale_instance_rows_go_with_an_update(pair, assets):
    jx, pt, _ = pair
    old = unit(ic.MT.INSTANCE, ic.ST.NONE, assets[20]["_bodies"]["instance"])
    for index, query in ((jx, jax_schema.IsccQuery), (pt, schema.IsccQuery)):
        hits = [m.iscc_id for m in index.search_assets(query(units=[old]), limit=10).global_matches]
        assert assets[20]["iscc_id"] not in hits


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_directory_written_by_one_package_opens_in_the_other(pair, assets, writer):
    jx, pt, _ = pair
    want = _answers(jx, jax_schema.IsccQuery, assets)
    path = (jx if writer == "jax" else pt).path
    (jx if writer == "jax" else pt).flush()
    (jx if writer == "jax" else pt).close()
    reopened = [TpuIndex(path, device="cpu"), None]
    try:
        assert _answers(reopened[0], schema.IsccQuery, assets) == want
        reopened[0].close()
        reopened[1] = JaxTpuIndex(path)
        assert _answers(reopened[1], jax_schema.IsccQuery, assets) == want
    finally:
        for index in reopened:
            if index is not None:
                index.close()


def test_rebuild_and_reopen_answer_the_same(tmp_path, assets):
    pt = TpuIndex(tmp_path / "port", device="cpu", search_batching=False)
    pt.add_assets([schema.IsccEntry(**wire(a)) for a in assets])
    want = _answers(pt, schema.IsccQuery, assets)
    assert pt.rebuild(["META_NONE_V0", "DATA_NONE_V0", "CONTENT_TEXT_V0"], [SP128, SP64, "UNKNOWN"]) == {
        "unit_types": ["META_NONE_V0", "DATA_NONE_V0", "CONTENT_TEXT_V0"], "simprint_types": [SP128, SP64]}
    assert _answers(pt, schema.IsccQuery, assets) == want
    pt.close()
    reopened = TpuIndex(tmp_path / "port", device="cpu")
    assert _answers(reopened, schema.IsccQuery, assets) == want
    reopened.close()


def test_what_is_not_ported_raises(tmp_path, assets):
    """A mesh in one process serves: ``mesh_devices=2`` (1-D) and
    ``mesh_hosts=2`` (2-D, positional) answer as without a mesh. ``follow()``
    outside a cluster raises the JAX package's ``RuntimeError`` (the control
    plane: ``tests/test_torch_multihost.py``)."""
    plain = TpuIndex(tmp_path / "one", device="cpu", search_batching=False)
    plain.add_assets([schema.IsccEntry(**wire(a)) for a in assets])
    want = _answers(plain, schema.IsccQuery, assets)
    for name, option in (("mesh", {"mesh_devices": 2}), ("hosts", {"mesh_hosts": 2})):
        meshed = TpuIndex(tmp_path / name, device="cpu", search_batching=False, **option)
        meshed.add_assets([schema.IsccEntry(**wire(a)) for a in assets])
        assert all(part.mesh is not None and part.mesh.size == 2 for part in meshed._nphd_indexes.values())
        assert _answers(meshed, schema.IsccQuery, assets) == want
        meshed.close()
    with pytest.raises(RuntimeError, match="follow\\(\\) runs only on follower processes of a multi-host cluster"):
        plain.follow()
    plain.close()


def test_a_cuda_entry_point_without_a_card_raises(tmp_path, monkeypatch):
    """Nothing falls back to the CPU: without a card, ``device="cuda"`` (the
    default) raises before the directory is touched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuIndex(tmp_path / "idx")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuIndexManager(tmp_path / "mgr")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceNphdIndex(None)
    assert not (tmp_path / "idx").exists() and not (tmp_path / "mgr").exists()


# ------------------------------------------------------------- the manager


def test_the_manager_equals_the_jax_manager(tmp_path, assets):
    jm, pm = JaxManager(tmp_path / "jax"), TpuIndexManager(tmp_path / "port", device="cpu")
    for m, s in ((jm, jax_schema), (pm, schema)):
        assert m.create_index(s.IsccIndex(name="alpha")).model_dump() == {"name": "alpha", "assets": 0, "size": 0, "sizes": None}
        m.add_assets("alpha", [s.IsccEntry(**wire(a)) for a in assets[:30]])
        with pytest.raises(FileExistsError):
            m.create_index(s.IsccIndex(name="alpha"))
    q = {"units": assets[3]["units"]}
    assert pm.search_assets("alpha", schema.IsccQuery(**q), limit=5).model_dump() == \
        jm.search_assets("alpha", jax_schema.IsccQuery(**q), limit=5).model_dump()
    assert pm.get_asset("alpha", assets[4]["iscc_id"]).model_dump() == jm.get_asset("alpha", assets[4]["iscc_id"]).model_dump()
    assert [i.name for i in pm.list_indexes()] == [i.name for i in jm.list_indexes()] == ["alpha"]
    assert pm.get_index("alpha").assets == jm.get_index("alpha").assets == 30
    pm.rebuild("alpha")
    pm.delete_index("alpha")
    with pytest.raises(FileNotFoundError):
        pm.get_index("alpha")
    pm.close()
    jm.close()


# ------------------------------------------------------- schema and options


SCHEMA_CASES = {
    "IsccIndex": [{"name": "abc"}, {"name": "a1", "assets": 3, "size": 0, "sizes": {"x": 1}}],
    "IsccSimprint": [{"simprint": "A" * 11, "offset": 0, "size": 7}],
    "IsccQuery": [{}, {"iscc_id": "ISCC:" + "A" * 16, "units": ["x"], "simprints": {"t": ["s"]}}],
    "IsccAddResult": [{"iscc_id": "ISCC:" + "B" * 16, "status": "created"}],
    "IsccMetadata": [{}, {"name": "n", "source": "s", "extra": [1, {"a": None}], "z": None}],
    "IsccMatchedChunk": [{"query": "q", "match": "m", "score": 1, "freq": 2, "offset": 3, "size": 4}],
    "IsccEntry": [
        {"iscc_id": "ISCC:" + "C" * 16, "units": ["a", "b"], "metadata": {"k": [1, None]},
         "simprints": {"t": [{"simprint": "A" * 11, "offset": 1, "size": 2}]}},
        {},
    ],
    "IsccGlobalMatch": [{"iscc_id": "ISCC:" + "D" * 16, "score": 0.5, "types": {"DATA": 1}, "metadata": {"name": "n", "x": 1}}],
    "Types": [{"score": 0, "matches": 0, "queried": 1, "chunks": [
        {"query": "q", "match": "m", "score": 0.5, "freq": 1, "offset": 0, "size": 0}]}],
    "IsccChunkMatch": [{"iscc_id": "ISCC:" + "E" * 16, "score": 0.25, "source": "s", "metadata": {"source": "s"},
                        "types": {"t": {"score": 0.5, "matches": 1, "queried": 2}}}],
    "IsccSearchResult": [
        {"query": {"units": ["u"]}, "global_matches": [{"iscc_id": "ISCC:" + "F" * 16, "score": 1.0, "types": {"X": 1.0}}]},
        {"query": {}, "global_matches": [], "chunk_matches": [
            {"iscc_id": "ISCC:" + "G" * 16, "score": 0.5, "types": {"t": {"score": 0.5, "matches": 1, "queried": 1}}}]},
    ],
    "HttpError": [{"detail": "x"}, {"detail": ["a", "b"]}],
}


@pytest.mark.parametrize("name", sorted(SCHEMA_CASES))
def test_schema_dumps_what_pydantic_dumps(name):
    ours, theirs = getattr(schema, name), getattr(jax_schema, name)
    if name != "IsccMetadata":
        assert [f.name for f in dataclasses.fields(ours)] == list(theirs.model_fields)
    for values in SCHEMA_CASES[name]:
        a, b = ours(**values), theirs(**values)
        for kwargs in ({}, {"mode": "json"}, {"mode": "json", "exclude_none": True}):
            assert a.model_dump(**kwargs) == b.model_dump(**kwargs)


SCHEMA_INVALID = [
    ("IsccIndex", {"name": "Upper"}), ("IsccIndex", {"name": "a" * 33}), ("IsccIndex", {"name": "a", "assets": -1}),
    ("IsccSimprint", {"simprint": "short", "offset": 0, "size": 0}),
    ("IsccSimprint", {"simprint": "A" * 11, "offset": -1, "size": 0}),
    ("IsccSimprint", {"simprint": "A" * 11, "offset": 0, "size": 2**32}),
    ("IsccQuery", {"iscc_id": "ISCC:short"}), ("IsccQuery", {"units": []}), ("IsccQuery", {"simprints": {"t": []}}),
    ("IsccEntry", {"units": ["only one"]}), ("IsccEntry", {"iscc_code": "nope"}),
    ("IsccEntry", {"simprints": {"t": [{"simprint": "A" * 11, "offset": 0}]}}),
    ("IsccAddResult", {"iscc_id": "ISCC:" + "A" * 16, "status": "deleted"}),
    ("IsccMatchedChunk", {"query": "q", "match": "m", "score": 1.5, "freq": 1, "offset": 0, "size": 0}),
    ("IsccMatchedChunk", {"query": "q", "match": "m", "score": 1.0, "freq": 0, "offset": 0, "size": 0}),
    ("IsccGlobalMatch", {"iscc_id": "ISCC:" + "A" * 16, "score": 0.5, "types": {}}),
    ("IsccGlobalMatch", {"iscc_id": "ISCC:" + "A" * 16, "score": 0.5, "types": {"X": 2.0}}),
    ("Types", {"score": 0.5, "matches": 0, "queried": 0}),
    ("IsccChunkMatch", {"iscc_id": "ISCC:" + "A" * 16, "score": 0.5, "types": {}}),
]


@pytest.mark.parametrize("name,values", SCHEMA_INVALID)
def test_schema_refuses_what_pydantic_refuses(name, values):
    with pytest.raises(ValidationError):
        getattr(jax_schema, name)(**values)
    with pytest.raises(ValueError):
        getattr(schema, name)(**values)


def test_serialized_assets_are_byte_identical(assets):
    for a in assets[:40]:
        ours = common.serialize_asset(schema.IsccEntry(**wire(a)))
        assert ours == jax_common.serialize_asset(jax_schema.IsccEntry(**wire(a)))
        assert common.deserialize_asset(ours).model_dump() == jax_common.deserialize_asset(ours).model_dump()
        assert common.metadata_from_asset_bytes(ours) == jax_common.metadata_from_asset_bytes(ours) == a["metadata"]


OPTION_FIELDS = [f.name for f in dataclasses.fields(options.SearchOptions)]


def test_option_defaults_equal_the_jax_options(monkeypatch):
    for name in list(os.environ):
        if name.startswith("ISCC_SEARCH_"):
            monkeypatch.delenv(name)
    ours, theirs = options.SearchOptions(), jax_options.SearchOptions()
    assert set(OPTION_FIELDS) <= set(jax_options.SearchOptions.model_fields)
    for name in OPTION_FIELDS:
        assert getattr(ours, name) == getattr(theirs, name), name
    assert options.SearchOptions.from_env({}) == ours


ENV_CASES = [
    {"ISCC_SEARCH_SHARD_SIZE_UNITS": "64", "ISCC_SEARCH_MATCH_THRESHOLD_UNITS": "0.5", "ISCC_SEARCH_SEARCH_BATCHING": "false"},
    {"ISCC_SEARCH_SCAN_RECALL_TARGET": "0.9", "ISCC_SEARCH_CONFIDENCE_EXPONENT": "2", "ISCC_SEARCH_SEARCH_BATCHING": "1",
     "ISCC_SEARCH_SEARCH_BATCHING_WINDOW_MS": "2.5", "ISCC_SEARCH_MESH_DEVICES": "0", "ISCC_SEARCH_MULTIHOST_COORDINATOR": "h"},
    {"ISCC_SEARCH_FLUSH_INTERVAL": "0", "ISCC_SEARCH_QUERY_BATCH_MAX": "7", "ISCC_SEARCH_OVERSAMPLING_FACTOR": "3",
     "ISCC_SEARCH_SEARCH_BATCHING": "no", "ISCC_SEARCH_SCAN_KERNEL": "auto", "ISCC_SEARCH_UNRELATED": "x"},
    {"ISCC_SEARCH_MATCH_THRESHOLD_SIMPRINTS": "1", "ISCC_SEARCH_MULTIHOST_CONTROL_PORT": "65535", "ISCC_SEARCH_SHARD_SIZE_SIMPRINTS": ""},
    # the server, aggregator, logging and sentry fields
    {"ISCC_SEARCH_INDEX_URI": "kv:///data/x", "ISCC_SEARCH_API_SECRET": "s", "ISCC_SEARCH_CORS_ORIGINS": "https://a, https://b",
     "ISCC_SEARCH_HOST": "127.0.0.1", "ISCC_SEARCH_PORT": "9000", "ISCC_SEARCH_WORKERS": "4",
     "ISCC_SEARCH_HTTP_BACKEND": "wsgiref", "ISCC_SEARCH_HTTP_THREADS": "1", "ISCC_SEARCH_HTTP_MAX_PENDING": "0",
     "ISCC_SEARCH_HTTP_QUEUE_DEADLINE_MS": "0", "ISCC_SEARCH_SCALEOUT_BREAKER_MS": "12.5", "ISCC_SEARCH_DISTRIBUTED": "yes"},
    {"ISCC_SEARCH_AGGREGATOR_NETWORK": "mainnet", "ISCC_SEARCH_AGGREGATOR_HUB_LIST_URL": "https://hubs.example/list.yaml",
     "ISCC_SEARCH_AGGREGATOR_POLL_INTERVAL": "1", "ISCC_SEARCH_AGGREGATOR_HUB_REFRESH_INTERVAL": "7200",
     "ISCC_SEARCH_AGGREGATOR_CONVERT_WORKERS": "8", "ISCC_SEARCH_LOG_LEVEL": "debug",
     "ISCC_SEARCH_SENTRY_DSN": "https://key@sentry.example/1", "ISCC_SEARCH_SENTRY_TRACES_SAMPLE_RATE": "1.0"},
    {"ISCC_SEARCH_AGGREGATOR_NETWORK": "testnet", "ISCC_SEARCH_HTTP_BACKEND": "pooled", "ISCC_SEARCH_DISTRIBUTED": "0",
     "ISCC_SEARCH_AGGREGATOR_CONVERT_WORKERS": "0", "ISCC_SEARCH_SENTRY_TRACES_SAMPLE_RATE": "0"},
]
PROPERTIES = ["cors_origins_list", "aggregator_mode", "aggregator_hub_list_source"]


@pytest.mark.parametrize("env", ENV_CASES)
def test_options_parse_the_environment_as_the_jax_options(env):
    ours, theirs = options.SearchOptions.from_env(env), jax_options.SearchOptions.from_env(env)
    for name in OPTION_FIELDS + PROPERTIES:
        assert getattr(ours, name) == getattr(theirs, name), name
        assert type(getattr(ours, name)) is type(getattr(theirs, name)), name
    if ours.aggregator_mode:
        assert ours.aggregator_index_name == theirs.aggregator_index_name


@pytest.mark.parametrize(
    "env",
    [{"ISCC_SEARCH_SHARD_SIZE_UNITS": "0"}, {"ISCC_SEARCH_MATCH_THRESHOLD_UNITS": "1.5"},
     {"ISCC_SEARCH_SCAN_RECALL_TARGET": "0"}, {"ISCC_SEARCH_MULTIHOST_CONTROL_PORT": "70000"},
     {"ISCC_SEARCH_SEARCH_BATCHING": "maybe"}, {"ISCC_SEARCH_QUERY_BATCH_MAX": "1.5"},
     {"ISCC_SEARCH_CONFIDENCE_EXPONENT": "two"}, {"ISCC_SEARCH_HTTP_BACKEND": "nginx"},
     {"ISCC_SEARCH_HTTP_BACKEND": "Pooled"}, {"ISCC_SEARCH_HTTP_THREADS": "0"}, {"ISCC_SEARCH_HTTP_MAX_PENDING": "-1"},
     {"ISCC_SEARCH_HTTP_QUEUE_DEADLINE_MS": "-0.5"}, {"ISCC_SEARCH_SCALEOUT_BREAKER_MS": "-1"},
     {"ISCC_SEARCH_PORT": "http"}, {"ISCC_SEARCH_WORKERS": "two"}, {"ISCC_SEARCH_DISTRIBUTED": "maybe"},
     {"ISCC_SEARCH_AGGREGATOR_NETWORK": "devnet"}, {"ISCC_SEARCH_AGGREGATOR_POLL_INTERVAL": "0"},
     {"ISCC_SEARCH_AGGREGATOR_HUB_REFRESH_INTERVAL": "0"}, {"ISCC_SEARCH_AGGREGATOR_CONVERT_WORKERS": "9"},
     {"ISCC_SEARCH_AGGREGATOR_CONVERT_WORKERS": "-1"}, {"ISCC_SEARCH_SENTRY_TRACES_SAMPLE_RATE": "1.01"}],
)
def test_options_refuse_what_the_jax_options_refuse(env):
    with pytest.raises(ValidationError):
        jax_options.SearchOptions.from_env(env)
    with pytest.raises(ValueError):
        options.SearchOptions.from_env(env)


@pytest.mark.parametrize("xdg", [None, "", "   ", "/srv/data", "relative/dir"])
def test_the_default_index_uri_is_the_jax_default(xdg, monkeypatch):
    """The platform data directory without platformdirs: $XDG_DATA_HOME (when
    not blank) or ~/.local/share, then iscc-search-tpu, as a tpu:// URI."""
    if xdg is None:
        monkeypatch.delenv("XDG_DATA_HOME", raising=False)
    else:
        monkeypatch.setenv("XDG_DATA_HOME", xdg)
    ours, theirs = options.SearchOptions().index_uri, jax_options.SearchOptions().index_uri
    assert ours == theirs and ours.startswith("tpu:///") and ours.endswith("/iscc-search-tpu")
    assert options.user_data_dir() == __import__("iscc_search_tpu").dirs.user_data_dir


def test_option_properties_equal_the_jax_options():
    for values in ({}, {"aggregator_network": "testnet"}, {"aggregator_network": "mainnet", "cors_origins": " a ,b"},
                   {"aggregator_network": "", "aggregator_hub_list_url": "https://x"}):
        ours, theirs = options.SearchOptions(**values), jax_options.SearchOptions(**values)
        for name in PROPERTIES + ["aggregator_network"]:
            assert getattr(ours, name) == getattr(theirs, name), (values, name)
        if ours.aggregator_mode:
            assert ours.aggregator_index_name == theirs.aggregator_index_name


def test_option_override():
    base = options.SearchOptions()
    new = base.override({"oversampling_factor": 5, "search_batching": "off"})
    assert (new.oversampling_factor, new.search_batching, base.oversampling_factor) == (5, False, 20)
    with pytest.raises(ValueError, match="unknown"):
        base.override({"nope": 1})
    with pytest.raises(ValueError):
        base.override({"oversampling_factor": 0})
    # scan_kernel takes the JAX values and the port's forced kernels; the
    # fields only the JAX engine reads are the JAX fields the port lacks, and
    # override() drops them, so a JAX options dict applies unchanged.
    theirs = jax_options.SearchOptions()
    for value in ("pallas", "xla"):
        assert base.override({"scan_kernel": value}).scan_kernel == theirs.override({"scan_kernel": value}).scan_kernel
    assert base.override({"scan_kernel": "popc"}).scan_kernel == "popc"
    with pytest.raises(ValueError, match="scan_kernel"):
        base.override({"scan_kernel": "wgmma"})
    assert set(jax_options.SearchOptions.model_fields) - set(OPTION_FIELDS) == set(options.JAX_ONLY)
    for update in ({"scan_chunk_rows": 128}, {"scan_chunk_rows": "4096"}, {"compile_cache_dir": "off"},
                   {"compile_cache_dir": "/tmp/cache"}, {"compile_cache_dir": None}):
        theirs.override(update)
        assert base.override(update) == base, update
        assert base.override({**update, "oversampling_factor": 5}) == new.override({"search_batching": True}), update
    assert options.SearchOptions.from_env({"ISCC_SEARCH_SCAN_CHUNK_ROWS": "4096"}) == options.SearchOptions.from_env({})


# ------------------------------------------------------------- the batcher


@pytest.fixture
def port_setup(tmp_path):
    """``tests/test_batcher.py``'s fixture over the port's index and batcher."""
    rng = np.random.default_rng(61)
    idx = DeviceNphdIndex(tmp_path / "i", device="cpu")
    bodies = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(200)]
    idx.add(list(range(200)), bodies)
    batcher = SearchBatcher(idx, max_batch=64, window_ms=1.0)
    yield idx, batcher, bodies
    batcher.close()
    idx.close()


@pytest.mark.parametrize(
    "case",
    ["test_single_request", "test_concurrent_requests_batched", "test_mixed_counts", "test_multi_query_request",
     "test_closed_batcher_rejects"],
)
def test_batcher_cases_on_the_port(port_setup, case):
    getattr(jax_batcher_tests, case)(port_setup)


def test_batcher_returns_rows_as_the_direct_search(port_setup):
    idx, _, bodies = port_setup
    batcher = SearchBatcher(idx, max_batch=8, window_ms=2.0, return_rows=True)
    results = {}

    def worker(i):
        results[i] = batcher.search([bodies[i], bodies[i + 1]], count=4)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(0, 40, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert not any(t.is_alive() for t in threads)
    batcher.close()
    for i, got in results.items():
        want = idx.search([bodies[i], bodies[i + 1]], 4, return_rows=True)
        for g, w in zip(got, want):
            assert all(np.array_equal(x, y) for x, y in zip(g, w))
