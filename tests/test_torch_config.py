"""The port's CLI configuration (``iscc_search_tpu_torch/config.py``) against
the JAX package's, on the CPU.

- Every case of ``tests/test_config.py`` runs against the port: the file is
  compiled with the JAX package's name read as the port's.
- A ``config.json`` written by either package loads in the other, with equal
  ``model_dump(mode="json")``: both read and write ``~/.iscc-search-tpu``.
- The same documents validate alike: the same dump where pydantic accepts
  one (its smart union included), and where it refuses one the port's
  ``ValidationError`` carries pydantic's first error (``type``, ``loc``,
  ``msg``).
"""

import json
import re

import pytest
from pydantic import ValidationError as PydanticValidationError

from iscc_search_tpu import config as jax_config
from iscc_search_tpu_torch import config
from iscc_search_tpu_torch.schema import ValidationError
from tests.test_torch_transport import REPO, _port_cases

CONFIG_CASES = re.findall(r"^def (test_\w+)\(", (REPO / "tests" / "test_config.py").read_text(), re.M)
globals().update(_port_cases("test_config", CONFIG_CASES, fixtures=("manager",)))


def test_the_loaded_cases_are_the_ports():
    cases = _port_cases("test_config", ["test_empty_config"], fixtures=("manager",))
    assert cases["test_config__empty_config"].__globals__["ConfigManager"] is config.ConfigManager
    assert len(CONFIG_CASES) >= 25


def _fill(manager, base):
    manager.add_local("main", base / "data")
    manager.add_local("kvidx", base / "kv", scheme="kv", use=False)
    manager.add_remote("prod", "https://api.example.com", "remote-idx", api_key="k", use=False)
    manager.add_remote("open", "http://localhost:8000", "open", use=False)
    manager.use("kvidx")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_config_file_of_either_package_loads_in_the_other(writer, tmp_path):
    cfg_dir = tmp_path / "cfg"
    modules = {"jax": jax_config, "port": config}
    _fill(modules[writer].ConfigManager(config_dir=cfg_dir), tmp_path)
    reader = modules["port" if writer == "jax" else "jax"]
    loaded = reader.ConfigManager(config_dir=cfg_dir)
    again = modules[writer].ConfigManager(config_dir=cfg_dir)
    assert loaded.config.model_dump(mode="json") == again.config.model_dump(mode="json")
    assert loaded.get_active()[0] == "kvidx" and set(loaded.list()) == {"main", "kvidx", "prod", "open"}
    assert type(loaded.list()["prod"]).__name__ == "RemoteIndexConfig"
    text = (cfg_dir / "config.json").read_text()
    loaded.save()  # and written back, byte for byte
    assert (cfg_dir / "config.json").read_text() == text


def test_both_packages_write_the_same_file(tmp_path):
    for name, module in (("jax", jax_config), ("port", config)):
        _fill(module.ConfigManager(config_dir=tmp_path / name), tmp_path)
    assert (tmp_path / "jax" / "config.json").read_bytes() == (tmp_path / "port" / "config.json").read_bytes()


def test_the_default_directory_is_the_jax_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    assert config.default_config_dir() == jax_config.default_config_dir() == tmp_path / ".iscc-search-tpu"
    assert config.ConfigManager().config_path == jax_config.ConfigManager().config_path


def test_discover_reads_the_ports_data_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "xdg"))
    (tmp_path / "xdg" / "iscc-search-tpu" / "found" / "store").mkdir(parents=True)
    manager = config.ConfigManager(config_dir=tmp_path / "cfg")
    assert manager.discover() == ["found"]
    assert manager.list()["found"].path == str((tmp_path / "xdg" / "iscc-search-tpu").resolve())


VALID = [
    {},
    {"version": "2", "active": "a"},
    {"version": True},
    {"extra": 1, "indexes": {"l": {"path": "/p", "scheme": "kv", "zzz": 1}}},
    {"indexes": {"r": {"url": "https://x", "index_name": "i", "api_key": None}}},
    # Both members validate: the one with more fields given wins.
    {"indexes": {"a": {"path": "/x", "url": "u", "index_name": "n"}}},
    {"indexes": {"a": {"path": "/x", "scheme": "kv", "type": "local", "url": "u", "index_name": "n"}}},
    # Only one validates, whatever ``type`` says.
    {"indexes": {"b": {"type": "remote", "path": "/y"}, "c": {"type": "local", "url": "u", "index_name": "i"}}},
    {"indexes": {"d": {"path": "/p", "url": "u", "index_name": "n", "api_key": 5}}},
    {"indexes": {"e": {"path": "/p", "scheme": "bad", "url": "u", "index_name": "n"}}},
]
INVALID = [
    {"version": "x"},
    {"version": 1.5},
    {"version": None},
    {"active": 3},
    {"indexes": []},
    {"indexes": {"x": 5}},
    {"indexes": {"x": {"type": "alien"}}},
    {"indexes": {"x": {"path": "/p", "scheme": "zz"}}},
    {"indexes": {"x": {"path": 3}}},
    {"indexes": {"x": {"url": "u"}}},
    {"indexes": {"x": {"url": "u", "index_name": "n", "api_key": 5}}},
    {"indexes": {"ok": {"path": "/p"}, "x": {"path": "/p", "type": 1}}},
]


@pytest.mark.parametrize("doc", VALID, ids=range(len(VALID)))
def test_valid_documents_load_alike(doc):
    assert config.Config(**doc).model_dump(mode="json") == jax_config.Config(**doc).model_dump(mode="json")


@pytest.mark.parametrize("doc", INVALID, ids=range(len(INVALID)))
def test_invalid_documents_fail_alike(doc):
    with pytest.raises(PydanticValidationError) as want:
        jax_config.Config(**doc)
    with pytest.raises(ValidationError) as got:
        config.Config(**doc)
    first = {k: want.value.errors()[0][k] for k in ("type", "loc", "msg")}
    assert {k: got.value.errors()[0][k] for k in ("type", "loc", "msg")} == first


@pytest.mark.parametrize("doc", INVALID[:4] + [{"indexes": {"x": {"type": "alien"}}}], ids=range(5))
def test_an_invalid_file_starts_fresh_in_both(doc, tmp_path):
    for module in (jax_config, config):
        cfg_dir = tmp_path / module.__name__
        cfg_dir.mkdir()
        (cfg_dir / "config.json").write_text(json.dumps(doc))
        assert module.ConfigManager(config_dir=cfg_dir).config.model_dump(mode="json") == {
            "version": 1, "active": None, "indexes": {}}


def test_the_index_models_check_their_fields():
    with pytest.raises(ValidationError, match="scheme"):
        config.LocalIndexConfig(path="/x", scheme="nope")
    with pytest.raises(ValidationError, match="Field required"):
        config.RemoteIndexConfig(url="https://x")
    local = config.LocalIndexConfig(path="/x")
    assert local.model_dump(mode="json") == jax_config.LocalIndexConfig(path="/x").model_dump(mode="json")
    remote = config.RemoteIndexConfig(url="u", index_name="i")
    assert remote.model_dump(mode="json") == jax_config.RemoteIndexConfig(url="u", index_name="i").model_dump(
        mode="json")
