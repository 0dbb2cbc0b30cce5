"""Nothing the benchmark runs loads JAX or the JAX package."""

import json
import shutil
import subprocess
import sys
import types

from portbench import harness
from portbench.tests.conftest import ROOT, TINY

RUN_TINY = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import harness, control
spec = harness.load_json({root!r} + "/BENCHMARK.json")
for workload, (config_over, mix_over) in {tiny!r}.items():
    harness.run_cell(spec, workload, 7, 0.5, 0, "cpu", config_over=config_over, mix_over=mix_over, log=lambda *_: None)
    control.control_numbers(spec, workload, 7, "cpu", config_over, mix_over)
print(json.dumps(sorted({{name.split(".")[0] for name in sys.modules}})))
"""


def test_a_run_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", RUN_TINY.format(root=str(ROOT), tiny=TINY)], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    top = set(json.loads(out.splitlines()[-1]))
    assert "iscc_search_tpu_torch" in top  # the port ran
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "iscc_search_tpu_torch_extra", types.ModuleType("iscc_search_tpu_torch_extra"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("jaxlib.xla_client"))
    monkeypatch.setitem(sys.modules, "iscc_search_tpu.engine", types.ModuleType("iscc_search_tpu.engine"))
    assert harness.forbidden_modules() == ["iscc_search_tpu.engine", "jaxlib.xla_client"]


def test_the_references_import_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "iscc_search_tpu" not in text and "jax" not in text, path


def test_only_the_benchmark_files_give_no_result(tmp_path):
    """A checkout of BENCHMARK.json and portbench/ alone, without the
    program, exits with an error and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload", "c3_bulk512", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and not any(line.startswith("{") for line in done.stdout.splitlines())
