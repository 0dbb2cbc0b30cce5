"""The host modules the port copies from the JAX package are copies.

The card's Python cannot import the JAX package (ROADMAP.md), so the port
keeps its own copy of each host module it needs. Every function and method
of a copy compiles to the same bytecode, names and constants as its original,
with the package name ``iscc_search_tpu_torch`` read as ``iscc_search_tpu``
and docstrings left out. Where the port changes a module on purpose (the
``device`` argument, the store's build, the ``torch.distributed`` world in
place of JAX's process count and index), the
functions that differ are listed here by name, and every other function is
still held to its original.
"""

import importlib
import inspect
import types

import pytest

PORT = "iscc_search_tpu_torch"
JAX = "iscc_search_tpu"


def _norm(value):
    return value.replace(PORT, JAX) if isinstance(value, str) else value


def _code_key(code, doc=None):
    """Bytecode, names and constants of a code object (nested code objects
    keyed the same way), the docstring left out."""
    consts = tuple(
        _code_key(c) if isinstance(c, types.CodeType) else _norm(c)
        for c in code.co_consts
        if doc is None or c != doc
    )
    return code.co_code, tuple(_norm(n) for n in code.co_names), code.co_varnames, consts


def _functions(module):
    """{qualified name: code key} of every function and method defined in
    ``module`` (properties by their getter)."""
    out = {}

    def visit(prefix, namespace):
        for name, obj in vars(namespace).items():
            if isinstance(obj, (staticmethod, classmethod)):
                obj = obj.__func__
            if isinstance(obj, property):
                obj = obj.fget
            if inspect.isfunction(obj) and obj.__module__ == module.__name__:
                out[prefix + name] = _code_key(obj.__code__, obj.__doc__)
            elif inspect.isclass(obj) and obj.__module__ == module.__name__ and not prefix:
                visit(name + ".", obj)

    visit("", module)
    return out


# module (relative to either package) -> (functions the port changes,
# functions only the JAX package has, functions only the port has)
COPIES = {
    "codec": ((), (), ()),
    "models": ((), (), ()),
    "utils": ((), (), ()),
    "engine.simprint_ops": ((), (), ()),
    "engine.batcher": ((), (), ()),
    "indexes.common": ((), (), ()),
    "server.metrics": ((), (), ()),
    "protocols.index": ((), (), ()),
    "aggregator": ((), (), ()),
    "indexes.memory.index": ((), (), ()),
    "indexes.kv.index": ((), (), ()),
    "indexes.kv.manager": ((), (), ()),
    "server.wsgi": ((), (), ()),
    "server.auth": ((), (), ()),
    "server.app": ((), (), ()),
    "server.pooled": ((), (), ()),
    "parallel.service": ((), (), ()),
    # A dataclass in place of the pydantic model (its validation in
    # __post_init__, its default directory without platformdirs); the
    # factories take the device argument.
    "options": (
        ("SearchOptions.from_env", "SearchOptions.override", "get_index", "manager_for"),
        ("SearchOptions.validate_aggregator_network",),
        ("SearchOptions.__init__", "SearchOptions.__post_init__", "SearchOptions.__eq__", "SearchOptions.__repr__",
         "_parse", "_default_convert_workers", "user_data_dir"),
    ),
    # The component schemas come from a data file, not from pydantic.
    "server.openapi": (("build_openapi",), (), ()),
    # serve(): the device argument (scale-out and the follower are dispatched
    # with it), init_distributed() and the world's rank in place of
    # jax.distributed.initialize() and jax.process_index();
    # _serve_follower(): the device argument to get_index.
    "server.httpd": (("serve", "_serve_follower"), (), ()),
    "aggregator.tlog": ((), (), ()),
    "aggregator.entry": ((), (), ()),
    "aggregator.cursors": ((), (), ()),
    "aggregator.convert_worker": ((), (), ()),
    # The hub list read by the port's parser of the hub-list YAML subset in
    # place of yaml.safe_load.
    "aggregator.hublist": (
        ("parse_hub_list",),
        (),
        ("load_hub_yaml", "_fail", "_check_plain", "_plain", "_double_quoted", "_quote_end", "_scalar", "_split_pair",
         "_is_empty", "_is_comment_or_blank", "_indent", "_starts_item", "_no_tab", "_skip_value", "_block_sequence"),
    ),
    # The client of aggregator/http.py in place of httpx.AsyncClient; the
    # card hidden from conversion workers in place of JAX_PLATFORMS="cpu".
    "aggregator.poller": (("_worker_env", "run"), (), ()),
    # The device argument; the workers' options as dataclasses.asdict (a
    # dataclass, not pydantic) and CUDA_VISIBLE_DEVICES="" in their
    # environment in place of JAX_PLATFORMS="cpu".
    "server.scaleout": (("serve_scaleout",), (), ()),
    "server.worker": ((), (), ()),
    # The models are the port's wire-type dataclasses (their checks in
    # __post_init__, the union resolved by _index_config); discover() reads
    # the port's data directory (no platformdirs).
    "config": (
        ("ConfigManager.discover",),
        (),
        tuple(f"{cls}.{fn}" for cls in ("LocalIndexConfig", "RemoteIndexConfig", "Config")
              for fn in ("__post_init__", "__eq__", "__repr__")) + ("_index_config",),
    ),
    # The device argument; the plain output in place of rich.
    "cli.common": (("get_active_index", "_local_manager"), (), ("print_json", "print_table")),
    # The click commands become argparse subcommands.
    "cli.add": ((), (), ("register", "add_command")),
    "cli.search": ((), (), ("register", "search_command")),
    "cli.hub": ((), (), ("register", "hub_command")),
    # The shared library is built with g++ into build/, never with make
    # inside the package.
    "store.kv": (("_load_library",), ("_lib_is_fresh", "_build_library"), ("build_key", "_build_library")),
    # The device argument.
    "engine.simprint": (("SimprintEngine.__init__",), (), ()),
    "indexes.tpu.index": (
        # The device argument (the index's and its engines').
        ("TpuIndex.__init__", "TpuIndex._new_nphd_index", "TpuIndex._new_simprint_index",
         # The mesh by the port's parallel/* on the index's device.
         "TpuIndex._device_mesh",
         # The torch.distributed world's size and rank in place of jax.process_count() and jax.process_index().
         "TpuIndex._init_multihost"),
        (),
        (),
    ),
    # The device argument.
    "indexes.tpu.manager": (
        ("TpuIndexManager.__init__", "TpuIndexManager.create_index", "TpuIndexManager._get_or_load_index"),
        (),
        (),
    ),
}


@pytest.mark.parametrize("module", sorted(COPIES))
def test_the_port_module_is_a_copy_of_the_reference(module):
    changed, jax_only, port_only = COPIES[module]
    ref = _functions(importlib.import_module(f"{JAX}.{module}"))
    port = _functions(importlib.import_module(f"{PORT}.{module}"))
    assert set(ref) - set(port) == set(jax_only) - set(port_only)
    assert set(port) - set(ref) == set(port_only) - set(jax_only)
    differ = sorted(name for name in set(ref) & set(port) if ref[name] != port[name])
    assert differ == sorted(set(changed) | (set(jax_only) & set(port_only)))


def test_the_store_source_is_a_copy():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    assert (root / PORT / "native" / "store.cpp").read_bytes() == (root / JAX / "native" / "store.cpp").read_bytes()


def test_the_static_files_are_copies():
    """The web frontend is served byte for byte as the JAX package serves it.
    One line differs: app.js's leading comment cites the reference frontend
    by its path in the reference repository, not by an absolute path."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    ref, port = root / JAX / "server" / "static", root / PORT / "server" / "static"
    names = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in port.iterdir()) == names == ["aggregator.html", "app.js", "index.html", "style.css"]
    for name in names:
        a, b = (ref / name).read_bytes(), (port / name).read_bytes()
        if name == "app.js":
            a_lines, b_lines = a.split(b"\n"), b.split(b"\n")
            differ = [i for i, (x, y) in enumerate(zip(a_lines, b_lines)) if x != y]
            assert len(a_lines) == len(b_lines) and differ == [5], differ
            assert b_lines[5] == b" * the reference frontend's iscc_search/server/static/js/app.js:1-2)."
            assert b'"use strict";' not in b"\n".join(b_lines[:7])  # inside the comment
        else:
            assert a == b, name
