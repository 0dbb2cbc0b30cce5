"""The port's REST app against the JAX package's, on the CPU.

One scripted sequence of requests (index CRUD, assets, search by POST and
GET at limit 10 and 100, the error codes 400, 404, 405, 409 and 422, auth,
CORS, HEAD, OPTIONS, the spec and the frontend) goes through
``httpx.WSGITransport`` to the JAX app and to the port's app over the same
backend kind: the memory backend of each package, and the tpu backend
(``TpuIndexManager``; JAX on its CPU, the port with ``device="cpu"``). Every
request gives the same status, the same parsed body and the same CORS
headers from both. Known differences, normalised before the comparison:
``/status`` and ``/openapi.json`` report each package's version, app.js's
leading comment cites the reference frontend by its repository path, and
``/metrics`` counts each process registry's own requests. Neither app
answers 403: a missing or wrong API key is 401 in both.

The wire types hold to pydantic where the server relies on them: unknown
keys are ignored (``IsccMetadata`` keeps them), a failed check raises the
port's ``ValidationError`` with pydantic's ``type``, ``loc`` and ``msg``,
and ``model_dump(exclude_unset=...)`` and ``model_dump_json()`` give
pydantic's values.
"""

import contextlib
import json

import httpx
import numpy as np
import pytest
import torch
from pydantic import ValidationError as PydanticValidationError

from iscc_search_tpu import __version__ as jax_version
from iscc_search_tpu import options as jax_options
from iscc_search_tpu import schema as jax_schema
from iscc_search_tpu.indexes.memory import MemoryIndex as JaxMemoryIndex
from iscc_search_tpu.indexes.tpu import TpuIndexManager as JaxManager
from iscc_search_tpu.server.app import create_app as jax_create_app
from iscc_search_tpu.server.openapi import build_openapi as jax_build_openapi
from iscc_search_tpu_torch import __version__ as port_version
from iscc_search_tpu_torch import codec as ic
from iscc_search_tpu_torch import options, schema
from iscc_search_tpu_torch.indexes.memory import MemoryIndex
from iscc_search_tpu_torch.indexes.tpu import TpuIndexManager
from iscc_search_tpu_torch.server.app import create_app
from iscc_search_tpu_torch.server.openapi import build_openapi
from tests.test_torch_backend import SCHEMA_CASES, SCHEMA_INVALID

SP = "CONTENT_TEXT_V0"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Test files run in parallel processes: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unit(mtype, stype, body):
    header = ic.encode_header(mtype, stype, ic.VS.V0, ic.encode_length(mtype, len(body) * 8))
    return "ISCC:" + ic.encode_base32(header + body)


def _flip(body, rng, bits):
    out = bytearray(body)
    for b in rng.choice(len(body) * 8, bits, replace=False):
        out[b // 8] ^= 1 << (b % 8)
    return bytes(out)


def make_assets(n=8, seed=14):
    """Wire assets with META, CONTENT, DATA and INSTANCE units of 64 bits,
    their ISCC-CODE, three 128-bit simprints and metadata; every fourth
    asset from the second on is a near copy of the one before (1-3 bits
    flipped per unit and simprint), so searches find more than themselves."""
    rng = np.random.default_rng(seed)
    kinds = ((ic.MT.META, ic.ST.NONE), (ic.MT.CONTENT, ic.ST_CC.TEXT), (ic.MT.DATA, ic.ST.NONE),
             (ic.MT.INSTANCE, ic.ST.NONE))
    bodies, out = [], []
    for i in range(n):
        if i % 4 == 1:
            units = [_flip(b, rng, 1 + i % 3) for b in bodies[-1][0]]
            sps = [_flip(b, rng, 2) for b in bodies[-1][1]]
        else:
            units = [rng.bytes(8) for _ in kinds]
            sps = [rng.bytes(16) for _ in range(3)]
        bodies.append((units, sps))
        wire_units = [_unit(m, s, b) for (m, s), b in zip(kinds, units)]
        out.append({
            "iscc_id": ic.gen_iscc_id_v1(timestamp_us=1_700_000_000_000_000 + i, server_id=i)["iscc"],
            "iscc_code": ic.gen_iscc_code_v0(wire_units)["iscc"],
            "units": wire_units,
            "simprints": {SP: [{"simprint": ic.encode_base64(b), "offset": 100 * c, "size": 100}
                               for c, b in enumerate(sps)]},
            "metadata": {"name": f"asset {i}", "n": i},
        })
    return out


def _backends(kind, tmp_path):
    if kind == "memory":
        return JaxMemoryIndex(), MemoryIndex()
    return JaxManager(tmp_path / "jax"), TpuIndexManager(tmp_path / "port", device="cpu")


@contextlib.contextmanager
def both_apps(kind, tmp_path, **opts):
    """(JAX client, port client) over the two apps on ``kind`` backends."""
    jax_backend, port_backend = _backends(kind, tmp_path)
    jax_app = jax_create_app(index=jax_backend, opts=jax_options.SearchOptions(index_uri="memory://", **opts))
    port_app = create_app(index=port_backend, opts=options.SearchOptions(index_uri="memory://", **opts))
    try:
        with httpx.Client(transport=httpx.WSGITransport(app=jax_app), base_url="http://testserver") as jc, \
                httpx.Client(transport=httpx.WSGITransport(app=port_app), base_url="http://testserver") as pc:
            yield jc, pc
    finally:
        jax_backend.close()
        port_backend.close()


def _observe(client, step):
    """(status, content type, parsed body, CORS headers, Retry-After, and a
    HEAD's Content-Length) of one request, the known differences
    normalised."""
    method, path, body, headers = step
    kwargs = {"headers": headers or {}}
    if isinstance(body, bytes):
        kwargs["content"] = body
    elif body is not None:
        kwargs["json"] = body
    r = client.request(method, path, **kwargs)
    ctype = r.headers.get("content-type", "")
    parsed = r.json() if ctype.startswith("application/json") and r.content else r.text
    route = path.split("?")[0]
    if route == "/status":
        assert parsed.pop("version") in (jax_version, port_version)
    elif route in ("/openapi.json", "/openapi/openapi.json"):
        assert parsed["info"].pop("version") in (jax_version, port_version)
    elif route == "/static/app.js":
        assert parsed.splitlines()[5].endswith("iscc_search/server/static/js/app.js:1-2).")
        parsed = parsed.splitlines()[:5] + parsed.splitlines()[6:]
    elif route == "/metrics" and r.status_code == 200:
        parsed = "iscc_http_requests_total" in parsed
    cors = {k.lower(): v for k, v in r.headers.items() if k.lower().startswith("access-control-")}
    length = r.headers.get("content-length") if method == "HEAD" else None
    return r.status_code, ctype, parsed, cors, r.headers.get("retry-after"), length


def _run(jc, pc, script):
    """Each step through both apps; every observation equal. Returns the
    statuses seen."""
    statuses = []
    for step in script:
        ours, theirs = _observe(pc, step), _observe(jc, step)
        assert ours == theirs, step
        statuses.append(ours[0])
    return statuses


def _script(assets):
    a0, a1, a2 = assets[0], assets[1], assets[2]
    sp0 = {SP: [s["simprint"] for s in a0["simprints"][SP]]}
    origin = {"Origin": "https://app.example"}
    search = "/indexes/alpha/search"
    return [
        ("GET", "/healthz", None, None), ("GET", "/readyz", None, None), ("GET", "/status", None, None),
        ("GET", "/indexes", None, None),
        ("POST", "/indexes", {"name": "alpha"}, None),
        ("POST", "/indexes", {"name": "alpha"}, None),  # 409
        ("POST", "/indexes", {"name": "Bad-Name"}, None),  # 422
        ("POST", "/indexes", {"name": "a" * 33}, None),  # 422
        ("POST", "/indexes", {"name": "beta", "description": "ignored"}, None),  # an unknown key: 201
        ("POST", "/indexes", {}, None),  # 422, missing name
        ("POST", "/indexes", [], None),  # 422
        ("POST", "/indexes", "alpha", None),  # 422, not an object
        ("POST", "/indexes", b"{nope", None),  # 400, invalid JSON
        ("GET", "/indexes", None, None), ("GET", "/indexes/alpha", None, None),
        ("GET", "/indexes/missing", None, None),  # 404
        ("GET", "/indexes/Upper", None, None),  # 400
        ("POST", "/indexes/alpha/assets", assets, None),
        ("POST", "/indexes/alpha/assets", assets[:2], None),  # updated
        ("POST", "/indexes/alpha/assets", [{**a2, "unknown": 1}], None),
        ("POST", "/indexes/alpha/assets", {"not": "a list"}, None),  # 422
        ("POST", "/indexes/alpha/assets", [{"units": "notalist"}], None),  # 422
        ("POST", "/indexes/alpha/assets", [{"iscc_id": 5}], None),  # 422
        ("POST", "/indexes/alpha/assets", [{"iscc_id": a0["iscc_id"], "units": a0["units"][:1]}], None),  # 422
        ("POST", "/indexes/alpha/assets", [{"units": a0["units"]}], None),  # 400, no iscc_id
        ("POST", "/indexes/missing/assets", assets[:1], None),  # 404
        ("GET", f"/indexes/alpha/assets/{a0['iscc_id']}", None, None),
        ("GET", f"/indexes/alpha/assets/{a2['iscc_id']}", None, None),
        ("GET", "/indexes/alpha/assets/ISCC:MAIGIIFJRDGEQQAA", None, None),  # 404
        ("GET", "/indexes/alpha", None, None),
        *[("POST", f"{search}?limit={limit}", q, None) for limit in (10, 100) for q in (
            {"units": a0["units"]}, {"iscc_code": a0["iscc_code"]}, {"iscc_id": a1["iscc_id"]},
            {"simprints": sp0}, {"units": a0["units"], "simprints": sp0}, {"units": a2["units"], "extra": True})],
        ("POST", search, {"iscc_code": a2["iscc_code"]}, None),  # the default limit
        ("POST", search, {}, None),  # 400, an empty query
        ("POST", search, {"iscc_code": "ISCC:nope"}, None),  # 422
        ("POST", search, {"units": []}, None),  # 422
        ("POST", search, [1], None),  # 422
        ("POST", f"{search}?limit=abc", {"units": a0["units"]}, None),  # 422
        ("POST", f"{search}?limit=0", {"units": a0["units"]}, None),  # 422
        ("POST", "/indexes/missing/search", {"iscc_code": a0["iscc_code"]}, None),  # 404
        *[("GET", f"{search}?iscc_code={a.get('iscc_code')}&limit={limit}", None, None)
          for a in (a0, a2) for limit in (10, 100)],
        ("GET", search, None, None),  # 422, no iscc_code
        ("GET", "/indexes/missing/search?iscc_code=" + a0["iscc_code"], None, None),  # 404
        ("PUT", "/indexes", {"name": "x"}, None),  # 405
        ("DELETE", "/indexes/alpha/assets", None, None),  # 405
        ("GET", "/nope", None, None),  # 404
        ("HEAD", "/healthz", None, None), ("HEAD", "/indexes/alpha", None, None),
        ("OPTIONS", "/indexes", None, origin),
        ("GET", "/healthz", None, origin), ("GET", "/indexes/missing", None, origin),
        ("POST", "/indexes", {"name": "Bad-Name"}, origin),
        ("GET", "/openapi.json", None, None), ("GET", "/openapi/openapi.json", None, None),
        ("GET", "/docs", None, None), ("GET", "/", None, None),
        ("GET", "/static/style.css", None, None), ("GET", "/static/app.js", None, None),
        ("GET", "/static/index.html", None, None), ("GET", "/static/missing.js", None, None),
        ("GET", "/metrics", None, None),
        ("DELETE", "/indexes/beta", None, None), ("DELETE", "/indexes/beta", None, None),  # 204, 404
        ("GET", "/indexes", None, None),
    ]


@pytest.mark.parametrize("kind", ["memory", "tpu"])
def test_the_scripted_sequence_answers_as_the_jax_app(kind, tmp_path):
    assets = make_assets()
    with both_apps(kind, tmp_path) as (jc, pc):
        statuses = _run(jc, pc, _script(assets))
    assert {200, 201, 204, 400, 404, 405, 409, 422} <= set(statuses)
    assert 403 not in statuses and 500 not in statuses


def test_the_searches_of_the_sequence_find_assets(tmp_path):
    """The tpu backend's answers in the sequence are not empty: the POST
    searches return the asset, its near copy, and chunk matches."""
    assets = make_assets()
    with both_apps("tpu", tmp_path) as (_, pc):
        assert pc.post("/indexes", json={"name": "alpha"}).status_code == 201
        assert pc.post("/indexes/alpha/assets", json=assets).status_code == 201
        sp = {SP: [s["simprint"] for s in assets[0]["simprints"][SP]]}
        body = pc.post("/indexes/alpha/search?limit=10", json={"units": assets[0]["units"], "simprints": sp}).json()
    assert [m["iscc_id"] for m in body["global_matches"][:2]] == [assets[0]["iscc_id"], assets[1]["iscc_id"]]
    assert assets[0]["iscc_id"] in [m["iscc_id"] for m in body["chunk_matches"]]


@pytest.mark.parametrize("kind", ["memory", "tpu"])
def test_auth_answers_as_the_jax_app(kind, tmp_path):
    key = {"X-API-Key": "s3cret"}
    script = [
        ("GET", "/indexes", None, None), ("GET", "/indexes", None, {"X-API-Key": "wrong"}),
        ("GET", "/indexes", None, key),
        ("POST", "/indexes", {"name": "locked"}, None), ("POST", "/indexes", {"name": "locked"}, key),
        ("POST", "/indexes/locked/search", {"units": make_assets(1)[0]["units"]}, None),
        ("POST", "/indexes/locked/search", {"units": make_assets(1)[0]["units"]}, key),
        ("GET", "/indexes/locked/assets/ISCC:MAIGIIFJRDGEQQAA", None, None),
        ("DELETE", "/indexes/locked", None, None), ("DELETE", "/indexes/locked", None, key),
        ("GET", "/healthz", None, None), ("GET", "/status", None, None), ("GET", "/", None, None),
        ("GET", "/docs", None, None), ("GET", "/openapi.json", None, None),
    ]
    with both_apps(kind, tmp_path, api_secret="s3cret") as (jc, pc):
        statuses = _run(jc, pc, script)
    assert statuses.count(401) == 6 and 403 not in statuses


def test_cors_origins_answer_as_the_jax_app(tmp_path):
    script = [
        (method, "/indexes", None, {"Origin": origin})
        for method in ("GET", "OPTIONS")
        for origin in ("https://a.example", "https://b.example", "https://evil.example")
    ]
    with both_apps("memory", tmp_path, cors_origins="https://a.example, https://b.example") as (jc, pc):
        _run(jc, pc, script)
        r = pc.get("/indexes", headers={"Origin": "https://b.example"})
    assert r.headers["Access-Control-Allow-Origin"] == "https://b.example"


def test_aggregator_mode_answers_as_the_jax_app(tmp_path):
    """The app's aggregator mode (``serve()`` of the port refuses it, the app
    itself is a copy): hidden management routes, foreign indexes blocked,
    the status payload and the dashboard page."""
    code = make_assets(1)[0]["iscc_code"]
    script = [
        ("POST", "/indexes", {"name": "idptest"}, None),  # hidden: 404
        ("GET", "/indexes", None, None), ("DELETE", "/indexes/idptest", None, None),
        ("POST", "/indexes/idptest/assets", [], None),
        ("POST", "/indexes/other/search", {"iscc_code": code}, None),
        ("POST", "/indexes/idptest/search", {"iscc_code": code}, None),
        ("GET", "/indexes/idptest/assets/ISCC:MAIGIIFJRDGEQQAA", None, None),
        ("GET", "/status", None, None), ("GET", "/", None, None),
    ]
    with both_apps("memory", tmp_path, aggregator_network="testnet") as (jc, pc):
        for client, idx in ((jc, jax_schema.IsccIndex), (pc, schema.IsccIndex)):
            client._transport.app.state.index.create_index(idx(name="idptest"))
        statuses = _run(jc, pc, script)
    assert statuses[:5] == [404] * 5 and statuses[5:] == [200, 404, 200, 200]


def test_the_spec_is_the_jax_spec():
    """The component schemas the port serves from its data file are what
    pydantic generates from the JAX models (after a change to the JAX
    schemas, write iscc_search_tpu_torch/server/openapi_schemas.json again
    from ``build_openapi()["components"]["schemas"]`` of the JAX package)."""
    ours, theirs = build_openapi(), jax_build_openapi()
    assert (ours["info"].pop("version"), theirs["info"].pop("version")) == (port_version, jax_version)
    assert ours == theirs


# ----------------------------------------------------------- the wire types


def _valid(name):
    return SCHEMA_CASES[name][0]


@pytest.mark.parametrize("name", sorted(set(SCHEMA_CASES) - {"IsccMetadata"}))
def test_unknown_keys_are_ignored_as_pydantic_does(name):
    values = {**_valid(name), "unknown": 1, "also_unknown": {"x": None}}
    ours, theirs = getattr(schema, name)(**values), getattr(jax_schema, name)(**values)
    assert ours.model_dump() == theirs.model_dump()
    assert ours.model_fields_set == theirs.model_fields_set


def test_metadata_keeps_unknown_keys():
    values = {"source": "s", "z": [1, None], "name": "n", "a": {"b": 2}}
    ours, theirs = schema.IsccMetadata(**values), jax_schema.IsccMetadata(**values)
    for kwargs in ({}, {"exclude_unset": True}, {"exclude_none": True}, {"mode": "json"}):
        assert ours.model_dump(**kwargs) == theirs.model_dump(**kwargs)
    assert ours.model_fields_set == theirs.model_fields_set


INVALID_MORE = [
    ("IsccIndex", {"name": ""}), ("IsccIndex", {}), ("IsccIndex", {"name": 5}), ("IsccIndex", {"name": "A" * 33}),
    ("IsccIndex", {"name": "a", "assets": 1.5}), ("IsccIndex", {"name": "a", "assets": "x"}),
    ("IsccIndex", {"name": "a", "sizes": {"x": -1}}), ("IsccIndex", {"name": "a", "sizes": 3}),
    ("IsccQuery", {"units": "x"}), ("IsccQuery", {"units": [1]}), ("IsccQuery", {"simprints": 3}),
    ("IsccQuery", {"simprints": {"t": ["a", 2]}}), ("IsccQuery", {"iscc_id": 5}),
    ("IsccEntry", {"iscc_id": 5}), ("IsccEntry", {"metadata": 3}), ("IsccEntry", {"simprints": {"t": [3]}}),
    ("IsccEntry", {"simprints": {"t": "x"}}), ("IsccEntry", {"simprints": []}),
    ("IsccAddResult", {"iscc_id": "ISCC:" + "A" * 16, "status": 3}), ("IsccAddResult", {"status": "created"}),
    ("IsccMatchedChunk", {"query": "q", "match": "m", "score": "x", "freq": 1, "offset": 0, "size": 0}),
    ("IsccMatchedChunk", {"query": "q", "match": "m", "score": float("nan"), "freq": 1, "offset": 0, "size": 0}),
    ("IsccMatchedChunk", {"query": "q", "match": "m", "score": 0.5, "freq": 1, "offset": 0, "size": 0, "content": 1}),
    ("IsccGlobalMatch", {"iscc_id": "ISCC:" + "A" * 16, "score": 0.5, "types": [1]}),
    ("IsccGlobalMatch", {"iscc_id": "ISCC:" + "A" * 16, "score": 0.5, "types": {"X": 1}, "metadata": 3}),
    ("IsccGlobalMatch", {"iscc_id": "ISCC:" + "A" * 16, "score": 0.5, "types": {"X": 1}, "metadata": {"name": 3}}),
    ("IsccChunkMatch", {"iscc_id": "ISCC:" + "A" * 16, "score": 1, "types": {"X": 3}}),
    ("IsccChunkMatch", {"iscc_id": "ISCC:" + "A" * 16, "score": 1,
                        "types": {"X": {"score": 1, "matches": 0, "queried": 1, "chunks": 3}}}),
    ("IsccChunkMatch", {"iscc_id": "ISCC:" + "A" * 16, "score": 1,
                        "types": {"X": {"score": 1, "matches": 0, "queried": 1, "chunks": [{"query": "q"}]}}}),
    ("IsccSearchResult", {"query": {"iscc_id": "x"}, "global_matches": []}),
    ("IsccSearchResult", {"query": 3, "global_matches": []}),
    ("IsccSearchResult", {"query": {}, "global_matches": 3}),
    ("IsccSearchResult", {"query": {}, "global_matches": [{"iscc_id": "ISCC:" + "A" * 16, "score": 2, "types": {}}]}),
    ("IsccSearchResult", {"query": {}, "global_matches": [], "chunk_matches": None}),
    ("IsccMetadata", {"name": 3}), ("IsccMetadata", {"name": "n", "source": []}),
]


@pytest.mark.parametrize("name,values", SCHEMA_INVALID + INVALID_MORE)
def test_validation_errors_have_pydantic_locs_and_messages(name, values):
    """The port raises its ValidationError (a ValueError) where pydantic
    raises its own, with pydantic's type, loc and msg for the first failed
    field in field order (pydantic lists every failed field; the port stops
    at the first, giving every missing field at once)."""
    with pytest.raises(PydanticValidationError) as theirs:
        getattr(jax_schema, name)(**values)
    with pytest.raises(schema.ValidationError) as ours:
        getattr(schema, name)(**values)
    assert isinstance(ours.value, ValueError)
    want = [(e["type"], e["loc"], e["msg"]) for e in theirs.value.errors()]
    got = [(e["type"], e["loc"], e["msg"]) for e in ours.value.errors()]
    assert got and got == want[: len(got)]
    assert ours.value.title == theirs.value.title == name
    assert str(ours.value).startswith(f"{len(got)} validation error{'s' if len(got) > 1 else ''} for {name}\n")


def test_the_wsgi_app_maps_the_port_validation_error_to_pydantic_details():
    """What server/wsgi.py answers for a failed model: 422 with
    ``"loc.path: msg"`` details, as for pydantic's error."""
    from iscc_search_tpu.server.wsgi import WsgiApp as JaxWsgiApp
    from iscc_search_tpu_torch.server.wsgi import WsgiApp

    bad = {"query": {}, "global_matches": [{"iscc_id": "ISCC:" + "A" * 16, "score": 0.5, "types": {"X": 2}}]}
    bodies = []
    for app_cls, module in ((JaxWsgiApp, jax_schema), (WsgiApp, schema)):
        app = app_cls()
        app.route("GET", "/x")(lambda request, module=module: module.IsccSearchResult(**bad))
        with httpx.Client(transport=httpx.WSGITransport(app=app), base_url="http://t") as client:
            r = client.get("/x")
        bodies.append((r.status_code, r.json()))
    assert bodies[0] == bodies[1] == (422, {"detail": ["global_matches.0.types.X: Input should be less than or equal to 1"]})


@pytest.mark.parametrize("name", sorted(SCHEMA_CASES))
def test_exclude_unset_and_json_dump_what_pydantic_dumps(name):
    ours_cls, theirs_cls = getattr(schema, name), getattr(jax_schema, name)
    for values in SCHEMA_CASES[name]:
        ours, theirs = ours_cls(**values), theirs_cls(**values)
        assert ours.model_fields_set == theirs.model_fields_set
        for kwargs in ({"exclude_unset": True}, {"mode": "json", "exclude_unset": True},
                       {"mode": "json", "exclude_unset": True, "exclude_none": True}):
            assert ours.model_dump(**kwargs) == theirs.model_dump(**kwargs), kwargs
        for kwargs in ({}, {"exclude_none": True}, {"exclude_unset": True}):
            assert json.loads(ours.model_dump_json(**kwargs)) == json.loads(theirs.model_dump_json(**kwargs)), kwargs


def test_exclude_unset_follows_defaults_copies_and_nesting():
    cases = [
        ("IsccSearchResult", {"query": {"units": ["u"]}, "global_matches": []}),
        ("IsccSearchResult", {"query": {"units": ["u"]}, "global_matches": [], "chunk_matches": []}),
        ("IsccEntry", {"iscc_id": None, "units": None}),
        ("IsccEntry", make_assets(1)[0]),
        ("IsccGlobalMatch", {"iscc_id": "ISCC:" + "A" * 16, "score": 1, "types": {"X": 1}, "metadata": {"x": 1}}),
    ]
    for name, values in cases:
        ours, theirs = getattr(schema, name)(**values), getattr(jax_schema, name)(**values)
        assert ours.model_dump(mode="json", exclude_unset=True) == theirs.model_dump(mode="json", exclude_unset=True)
        assert ours.model_dump_json() != "" and json.loads(ours.model_dump_json()) == json.loads(theirs.model_dump_json())
    q, jq = schema.IsccQuery(units=["a"]), jax_schema.IsccQuery(units=["a"])
    for update in ({"iscc_code": "ISCC:" + "A" * 16}, {"units": ["b", "c"]}, {}):
        assert q.model_copy(update=update).model_dump(exclude_unset=True) == \
            jq.model_copy(update=update).model_dump(exclude_unset=True)
    assert q.model_dump(exclude_unset=True) == {"units": ["a"]}  # the copy left the original as it was


def test_lax_coercion_as_pydantic():
    """Numeric strings and bools become numbers, tuples lists, as in
    pydantic's lax mode."""
    cases = [
        ("IsccIndex", {"name": "a", "assets": "5", "size": True, "sizes": {"x": " 3 "}}),
        ("IsccIndex", {"name": "a", "assets": 5.0}),
        ("IsccMatchedChunk", {"query": "q", "match": "m", "score": "0.5", "freq": True, "offset": 0, "size": 0}),
        ("IsccQuery", {"units": ("a", "b")}),
        ("IsccGlobalMatch", {"iscc_id": "ISCC:" + "A" * 16, "score": 1, "types": {"X": "1"}}),
    ]
    for name, values in cases:
        ours, theirs = getattr(schema, name)(**values), getattr(jax_schema, name)(**values)
        assert ours.model_dump() == theirs.model_dump()
        assert [type(v) for v in ours.model_dump().values()] == [type(v) for v in theirs.model_dump().values()]
