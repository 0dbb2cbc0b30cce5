"""The port's CLI (``iscc_search_tpu_torch/cli``) against the JAX package's,
on the CPU.

- Every case of ``tests/test_cli.py`` runs against the port: the file is
  compiled with the JAX package's name read as the port's and click's
  ``CliRunner`` replaced by ``PortRunner``, which runs the port's
  ``main(["--device", "cpu", ...])`` and captures what it prints. One case
  stubs ``serve`` with the JAX signature and has a port version here.
- One command sequence (``index add`` of a local ``tpu``, a ``kv`` and a
  remote index; ``add`` of a file, a directory and an NDJSON file with a
  bad row; ``get``; ``search`` by code and by ISCC-ID; ``index list``,
  ``use``, ``remove --delete-data``, ``rebuild --all`` and ``rebuild``
  without a selector) goes through the JAX CLI (``CliRunner``) and the
  port's, each with its own configuration: the same exit codes, the same
  parsed JSON, the same ``add`` counts and messages, the same table rows
  and the same ``config.json``. The JAX CLI prints tables with rich, the
  port as tab-separated rows: the rows are compared, not the layout.
- ``add`` with the port's ``main`` and ``serve --workers 2`` in a
  subprocess answer over HTTP what the JAX CLI's ``add`` and
  ``serve --workers 2`` answer on the same files.
- ``serve`` dispatches to scale-out for ``--workers 2``, refuses aggregator
  mode with more than one worker (exit 1); ``hub`` and ``datasets`` work
  with a faked ``huggingface_hub`` and exit 1 without one.
"""

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time
import types
import urllib.request

import pytest
import torch
from click.testing import CliRunner
from rich.console import Console

import iscc_search_tpu.cli as jax_cli_pkg
from iscc_search_tpu import config as jax_config
from iscc_search_tpu.cli import cli as jax_cli
from iscc_search_tpu.cli import common as jax_common
from iscc_search_tpu_torch import config
from iscc_search_tpu_torch.cli import common, main
from iscc_search_tpu_torch.indexes.tpu import TpuIndexManager
from iscc_search_tpu_torch.schema import IsccQuery
from tests.test_torch_scaleout import _free_port
from tests.test_torch_transport import REPO


class PortRunner:
    """``CliRunner.invoke`` for the port: ``main(["--device", "cpu",
    *args])`` with what it prints captured."""

    def invoke(self, cli, args):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = cli(["--device", "cpu", *args])
        return types.SimpleNamespace(exit_code=code, output=out.getvalue(), stdout=out.getvalue())


def _port_cli_cases(tests, fixtures=()):
    """The named tests of ``tests/test_cli.py`` compiled against the port
    (``PortRunner`` for ``CliRunner``, ``main`` for the click group),
    renamed ``test_cli__<test>``."""
    path = REPO / "tests" / "test_cli.py"
    source = (path.read_text()
              .replace("from click.testing import CliRunner", "CliRunner = PORT_RUNNER")
              .replace("from iscc_search_tpu.cli import cli", "cli = PORT_MAIN")
              .replace("iscc_search_tpu.", "iscc_search_tpu_torch."))
    namespace = {"__name__": f"{__name__}.test_cli", "__file__": str(path), "PORT_RUNNER": PortRunner,
                 "PORT_MAIN": main}
    exec(compile(source, str(path), "exec"), namespace)
    return {**{f"test_cli__{t[5:]}": namespace[t] for t in tests}, **{f: namespace[f] for f in fixtures}}


CLI_CASES = [name for name in re.findall(r"^def (test_\w+)\(", (REPO / "tests" / "test_cli.py").read_text(), re.M)
             if name != "test_serve_multi_worker_dispatches_scaleout"]
globals().update(_port_cli_cases(CLI_CASES, fixtures=("runner",)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Test files run in parallel processes: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_loaded_cases_are_the_ports():
    cases = _port_cli_cases(["test_version"], fixtures=("runner",))
    body = cases["test_cli__version"]
    assert body.__globals__["cli"] is main and body.__globals__["CliRunner"] is PortRunner
    assert body.__globals__["ConfigManager"] is config.ConfigManager
    assert len(CLI_CASES) >= 17


def test_serve_multi_worker_dispatches_scaleout(tmp_path, monkeypatch):
    """``serve --workers 2`` hands serve() the worker count and the device
    (``httpd.serve`` then runs the scale-out topology)."""
    served = []
    monkeypatch.setattr("iscc_search_tpu_torch.server.httpd.serve",
                        lambda opts, device="cuda": served.append((opts, device)))
    assert main(["serve", "--workers", "2", "--index-uri", f"tpu://{tmp_path}/srv", "--port", "8123"]) == 0
    assert main(["--device", "cpu", "serve", "--workers", "2"]) == 0
    assert [(o.workers, o.port, d) for o, d in served] == [(2, 8123, "cuda"), (2, served[1][0].port, "cpu")]
    assert served[0][0].index_uri == f"tpu://{tmp_path}/srv"


def test_serve_aggregator_with_workers_exits_1_and_serves_nothing(monkeypatch):
    import iscc_search_tpu_torch.options as opts_mod

    monkeypatch.setattr(opts_mod, "search_opts", opts_mod.SearchOptions(index_uri="memory://",
                                                                         aggregator_network="testnet"))
    monkeypatch.setattr("iscc_search_tpu_torch.server.httpd.serve", lambda *a, **k: pytest.fail("served"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["serve", "--workers", "2"]) == 1
    assert out.getvalue() == "Aggregator mode requires a single worker (one poller).\n"


@pytest.mark.parametrize("argv", [["hub", "org/set"], ["datasets"]])
def test_hub_and_datasets_exit_1_without_huggingface_hub(argv, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # import fails
    common.set_config_manager(config.ConfigManager(config_dir=tmp_path / "cfg"))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert main(argv) == 1
    finally:
        common.set_config_manager(None)
    assert out.getvalue() == "huggingface-hub is not installed\n"


def test_hub_exits_1_without_pyarrow(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        hf_hub_download=None, list_repo_files=None))
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["hub", "org/set"]) == 1
    assert out.getvalue() == "pyarrow is not installed\n"


def test_hub_ingests_a_faked_dataset_as_the_jax_cli(tmp_path, monkeypatch, entry_factory):
    """``hub`` with a faked ``huggingface_hub`` over one local parquet file:
    the same rows ingested (with fresh ISCC-IDs) and the same message from
    both CLIs, a malformed row skipped, ``--limit`` honoured."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    entries = [entry_factory(metadata={"name": f"row {i}"}) for i in range(7)]
    rows = [{"iscc": e["iscc_code"], "units": e["units"], "name": e["metadata"]["name"]} for e in entries]
    rows.insert(3, {"iscc": "ISCC:nope", "units": None, "name": "bad"})
    parquet = tmp_path / "part-0.parquet"
    pq.write_table(pa.Table.from_pylist(rows), parquet)
    fake = types.SimpleNamespace(list_repo_files=lambda ds, repo_type: ["README.md", "part-0.parquet"],
                                 hf_hub_download=lambda ds, name, repo_type: str(parquet))
    monkeypatch.setitem(sys.modules, "huggingface_hub", fake)
    outputs = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        got = _invoke(pkg, root, ["index", "add", "main", "--path", str(root / "data")])
        assert got[0] == 0
        outputs[pkg] = [_invoke(pkg, root, ["hub", "org/set", *extra])[:2] for extra in ([], ["--limit", "3"])]
    assert outputs["jax"] == outputs["port"] == [(0, ["Ingested 7 assets from org/set"]),
                                                  (0, ["Ingested 3 assets (limit reached)"])]
    manager = TpuIndexManager(tmp_path / "port" / "data", device="cpu")
    try:
        assert manager.get_index("main").assets == 10
        got = manager.search_assets("main", IsccQuery(units=entries[5]["units"]), limit=10)
        assert got.global_matches[0].score == 1.0
    finally:
        manager.close()


# --------------------------------------------------- the two CLIs, side by side


_LOG = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\.\d{3} \| ")


@contextlib.contextmanager
def _configured(pkg, root):
    """``pkg``'s CLI with its configuration in ``root/cfg`` (and the JAX
    CLI's rich consoles wide enough never to wrap a line)."""
    common_mod, config_mod = (jax_common, jax_config) if pkg == "jax" else (common, config)
    common_mod.set_config_manager(config_mod.ConfigManager(config_dir=root / "cfg"))
    saved = {}
    if pkg == "jax":
        for name in ("add", "get", "search", "index", "serve", "hub", "datasets"):
            module = getattr(jax_cli_pkg, name)
            saved[module] = module.console
            module.console = Console(width=2000)
    try:
        yield
    finally:
        common_mod.set_config_manager(None)
        for module, console in saved.items():
            module.console = console


def _invoke(pkg, root, args):
    """(exit code, printed lines without the log lines, raw output) of one
    command of ``pkg``'s CLI, ``root`` read as ``<root>``."""
    with _configured(pkg, root):
        if pkg == "jax":
            res = CliRunner().invoke(jax_cli, args)
            if res.exception and not isinstance(res.exception, SystemExit):
                raise res.exception
        else:
            res = PortRunner().invoke(main, args)
    out = res.stdout.replace(str(root), "<root>")
    return res.exit_code, [line for line in out.splitlines() if not _LOG.match(line)], out


def _json(lines):
    text = "\n".join(lines)
    return json.loads(text[text.index("{"):])


def _rows(pkg, lines):
    """A printed table's title, header and rows: rich's box lines (JAX), or
    the title line and the tab-separated rows (port)."""
    if pkg == "jax":
        cells = [[c.strip() for c in re.split("[│┃]", line)[1:-1]] for line in lines if re.search("[│┃]", line)]
        title = [line.strip() for line in lines if line.strip() and not re.search("[│┃┏┡└━─]", line)]
        return title, cells
    return [line for line in lines if "\t" not in line], [line.split("\t") for line in lines if "\t" in line]


def _write_files(base, entry_factory):
    """One .iscc.json file, a directory of three, and an NDJSON file of five
    entries, a blank line and one bad row; returns the entries."""
    base.mkdir()
    entries = [entry_factory(with_meta=True, metadata={"name": f"asset {i}"},
                             simprints={"CONTENT_TEXT_V0": [{"simprint": "AAAAAAAAAAAAAAAAAAAAAA" if i % 2 else
                                                             "ABCDEFGHIJKLMNOPQRSTUV", "offset": 0, "size": 10}]})
               for i in range(9)]
    (base / "one.iscc.json").write_text(json.dumps(entries[0]))
    (base / "dir").mkdir()
    for i in range(1, 4):
        (base / "dir" / f"a{i}.iscc.json").write_text(json.dumps(entries[i]))
    lines = [json.dumps(e) for e in entries[4:9]]
    lines[2:2] = ["", json.dumps({"iscc_code": "ISCC:nope"})]
    (base / "bulk.ndjson").write_text("\n".join(lines) + "\n")
    return entries


def test_one_command_sequence_through_both_clis(tmp_path, entry_factory, monkeypatch):
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "xdg"))  # what `index list` discovers
    entries = _write_files(tmp_path / "files", entry_factory)
    files = tmp_path / "files"
    e0, e5 = entries[0], entries[5]
    steps = [  # (args, what is compared: "text", "json" or "table")
        (["index", "add", "main", "--path", "<root>/data"], "text"),
        (["index", "add", "kvidx", "--path", "<root>/kv", "--scheme", "kv", "--no-use"], "text"),
        (["index", "add", "prod", "--url", "https://api.example.com", "--remote-name", "remote-idx",
          "--api-key", "k", "--no-use"], "text"),
        (["index", "add", "main", "--path", "<root>/other"], "text"),  # exit 1: configured
        (["add", str(files / "one.iscc.json")], "text"),
        (["add", str(files / "dir")], "text"),
        (["add", str(files / "bulk.ndjson")], "text"),
        (["add", str(files / "one.iscc.json")], "text"),  # updated
        (["add", "--index", "kvidx", str(files / "dir")], "text"),
        (["add", str(files / "nothing-*.json")], "text"),  # exit 1
        (["get", e0["iscc_id"]], "json"),
        (["get", e5["iscc_id"]], "json"),
        (["get", "ISCC:MAIGIIFJRDGEQQAA"], "text"),  # exit 1
        (["search", e0["iscc_code"], "--json"], "json"),
        (["search", e5["iscc_id"], "--json"], "json"),
        (["search", e5["iscc_code"], "--json", "--limit", "3"], "json"),
        (["search", e0["iscc_code"]], "table"),
        (["search", "--index", "kvidx", entries[2]["iscc_code"], "--json"], "json"),
        (["search", "ISCC:nope"], "first"),  # exit 1, each package's validation message
        (["index", "list"], "table"),
        (["index", "use", "kvidx"], "text"),
        (["index", "use", "missing"], "text"),  # exit 1
        (["index", "list"], "table"),
        (["index", "rebuild", "--all"], "text"),  # the kv backend: exit 1
        (["index", "rebuild", "main", "--all"], "text"),
        (["index", "rebuild", "main", "--unit-type", "CONTENT_TEXT_V0"], "text"),
        (["index", "rebuild"], "text"),  # exit 1: no selector
        (["index", "remove", "kvidx", "--delete-data"], "text"),
        (["index", "remove", "kvidx"], "text"),  # exit 1
        (["index", "list"], "table"),
        (["search", e0["iscc_code"], "--json"], "json"),
    ]
    codes = []
    for args, kind in steps:
        seen = {}
        for pkg in ("jax", "port"):
            root = tmp_path / pkg
            code, lines, raw = _invoke(pkg, root, [a.replace("<root>", str(root)) for a in args])
            if kind == "json":
                seen[pkg] = code, _json(lines)
            elif kind == "table":
                seen[pkg] = code, _rows(pkg, lines)
            elif kind == "first":
                seen[pkg] = code, lines[:1]
            else:
                seen[pkg] = code, lines
        assert seen["jax"] == seen["port"], (args, seen)
        codes.append(seen["port"][0])
    assert [i for i, c in enumerate(codes) if c] == [3, 9, 12, 18, 21, 23, 26, 28], codes
    assert not (tmp_path / "port" / "kv" / "kvidx").exists() and (tmp_path / "port" / "data" / "main").exists()
    docs = [(tmp_path / pkg / "cfg" / "config.json").read_text().replace(str(tmp_path / pkg), "<root>")
            for pkg in ("jax", "port")]
    assert docs[0] == docs[1] and set(json.loads(docs[1])["indexes"]) == {"main", "prod"}


def test_the_sequence_compares_what_it_should(tmp_path, entry_factory):
    """The comparison above sees the outputs: add counts, the searched
    asset at rank 0, the table rows."""
    entries = _write_files(tmp_path / "files", entry_factory)
    root = tmp_path / "port"
    _invoke("port", root, ["index", "add", "main", "--path", str(root / "data")])
    assert _invoke("port", root, ["add", str(tmp_path / "files" / "bulk.ndjson")])[1] == [
        "Added 5 created, 0 updated, 0 skipped"]
    code, lines, raw = _invoke("port", root, ["search", entries[6]["iscc_code"], "--json"])
    assert code == 0 and _json(lines)["global_matches"][0]["iscc_id"] == entries[6]["iscc_id"]
    assert "open index: " in raw and "search_assets: " in raw  # the cold split, in the log
    title, rows = _rows("port", _invoke("port", root, ["search", entries[6]["iscc_code"]])[1])
    assert title[0] == "Global matches in 'main'" and rows[0] == ["ISCC-ID", "Score", "Types"]
    assert rows[1][:2] == [entries[6]["iscc_id"], "1.000"]
    jax_title, jax_rows = _rows("jax", ["Title", "┃ A ┃ B ┃", "│ x │ 1 │", "└───┴───┘"])
    assert (jax_title, jax_rows) == (["Title"], [["A", "B"], ["x", "1"]])


# ------------------------------------------------------ add, then serve


JAX_SERVE = "import sys; from iscc_search_tpu.cli import cli; sys.argv[0] = 'iscc-search-tpu'; cli()"


def _serve(argv, log):
    """A CLI's ``serve`` in a subprocess; returns (process, base URL) once
    /healthz answers."""
    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu", ISCC_SEARCH_SCALEOUT_FORCE="1", ISCC_SEARCH_HTTP_THREADS="4",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with open(log, "wb") as out:
        proc = subprocess.Popen([sys.executable, *argv, "--host", "127.0.0.1", "--port", str(port)], env=env,
                                stdout=out, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 120
    while True:
        try:
            with urllib.request.urlopen(f"{base}/healthz", timeout=2):
                return proc, base
        except OSError:
            if proc.poll() is not None or time.monotonic() > deadline:
                proc.kill()
                raise AssertionError(open(log).read()[-3000:])
            time.sleep(0.2)


def _get(base, route, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + route, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_add_then_serve_with_two_workers_answers_as_the_jax_cli(tmp_path, entry_factory):
    """The slice as a whole on the CPU: each CLI adds the same files into a
    local tpu index, then ``serve --workers 2`` on it answers every request
    alike; SIGTERM ends both with exit 0."""
    entries = _write_files(tmp_path / "files", entry_factory)
    procs = {}
    try:
        for pkg, argv in (("jax", ["-c", JAX_SERVE]), ("port", ["-m", "iscc_search_tpu_torch.cli", "--device", "cpu"])):
            root = tmp_path / pkg
            assert _invoke(pkg, root, ["index", "add", "main", "--path", str(root / "data")])[0] == 0
            for src in ("one.iscc.json", "dir", "bulk.ndjson"):
                assert _invoke(pkg, root, ["add", str(tmp_path / "files" / src)])[0] == 0
            procs[pkg] = _serve([*argv, "serve", "--workers", "2", "--index-uri", f"tpu://{root / 'data'}"],
                                tmp_path / f"{pkg}.log")
        assert len(subprocess.run(["pgrep", "-P", str(procs["port"][0].pid)], capture_output=True,
                                  text=True).stdout.split()) == 2
        requests = [("/indexes", None), ("/indexes/main", None), ("/indexes/missing", None)]
        for e in entries[:1] + entries[4:7]:
            requests += [(f"/indexes/main/assets/{e['iscc_id']}", None)]
            for limit in (10, 100):
                requests += [(f"/indexes/main/search?limit={limit}", q) for q in (
                    {"units": e["units"]}, {"iscc_code": e["iscc_code"]}, {"iscc_id": e["iscc_id"]},
                    {"simprints": {"CONTENT_TEXT_V0": [e["simprints"]["CONTENT_TEXT_V0"][0]["simprint"]]}})]
        answers = {pkg: [_get(base, route, q) for route, q in requests] for pkg, (_, base) in procs.items()}
        assert answers["jax"] == answers["port"]
        assert [s for s, _ in answers["port"]].count(200) == len(requests) - 1
        assert answers["port"][3][1]["iscc_id"] == entries[0]["iscc_id"]
    finally:
        codes = {}
        for pkg, (proc, _) in procs.items():
            proc.send_signal(signal.SIGTERM)
            try:
                codes[pkg] = proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    assert codes == {"jax": 0, "port": 0}, [open(tmp_path / f"{p}.log").read()[-2000:] for p in procs]
