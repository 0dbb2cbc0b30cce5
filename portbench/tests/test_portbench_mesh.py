"""The mesh cell ``c5_mesh4`` on the CPU at a small size: four CPU shards in
place of the four cards, sound and with one shard's candidates dropped, its
configuration's cards against the cell's chips, and no JAX module loaded."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import ROOT

WORKLOAD = "c5_mesh4"
# The cell's configuration and mix at a size a test holds: the same code on four CPU shards.
SMALL = ({"rows": 20000}, {"pool_requests": 4, "queries_per_request": 64, "sample": 64})
DEVICE_SOURCES = {"device_trace"}


def run_small(spec, trace=0, seed=4_000_000_011):
    # A window of a few sweeps: a traced reading needs one that ends inside it,
    # and four shards of the CPU each scan at least 8,192 rows a partition.
    config_over, mix_over = SMALL
    return harness.run_cell(spec, WORKLOAD, seed, 3.0, trace, "cpu", config_over=config_over, mix_over=mix_over,
                            log=lambda *_: None)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_mesh_cell_runs_end_to_end(spec, trace):
    result, checks = run_small(spec, trace)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0, checks
    want = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]
            if WORKLOAD in m.get("workloads", [WORKLOAD]) and m["source"] not in DEVICE_SOURCES}
    assert set(result["metrics"]) == want
    for name in want:
        value = result["metrics"][name]["value"]
        assert isinstance(value, float) and value >= 0, name
    if trace:
        assert want == {"mesh_scan_ms_per_sweep", "mesh_merge_ms_per_sweep", "crosscard_bytes_per_query",
                        "wait_ms_per_sweep.mesh"}
        assert result["metrics"]["crosscard_bytes_per_query"]["value"] == 0.0  # four shards of one CPU: nothing moves
    else:
        assert want == {"unit_qps", "setup_s"}


def test_one_shard_dropped_before_the_merge_is_not_correct(spec, monkeypatch):
    from iscc_search_tpu_torch.engine import device_index
    from iscc_search_tpu_torch.ops.nphd import NEG_SCORE

    merge = device_index.merge_shards

    def drop_shard_zero(mesh, parts, local_rows, merge_k):
        # Shard 0: at this size a shard's floor of 8,192 rows puts most rows there.
        parts = list(parts)
        scores, rows = parts[0]
        parts[0] = (torch.full_like(scores, NEG_SCORE), torch.full_like(rows, -1))
        return merge(mesh, parts, local_rows, merge_k)

    monkeypatch.setattr(device_index, "merge_shards", drop_shard_zero)
    result, checks = run_small(spec)
    assert result["correct"] is False, checks


def test_the_configuration_holds_a_shard_a_card(spec):
    cell, config, _, _ = harness.resolve(spec, WORKLOAD)
    assert config["cards"] == cell["chips"] == 4
    assert config["system"] == "units_mesh" and config["reduced"] == []


RUN_SMALL = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import harness, control
spec = harness.load_json({root!r} + "/BENCHMARK.json")
config_over, mix_over = {small!r}
harness.run_cell(spec, {workload!r}, 7, 0.5, 0, "cpu", config_over=config_over, mix_over=mix_over, log=lambda *_: None)
control.control_numbers(spec, {workload!r}, 7, "cpu", config_over, mix_over)
print(json.dumps(sorted({{name.split(".")[0] for name in sys.modules}})))
"""


def test_the_mesh_cell_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", RUN_SMALL.format(root=str(ROOT), small=SMALL, workload=WORKLOAD)],
                         capture_output=True, text=True, timeout=600, check=True).stdout
    top = set(json.loads(out.splitlines()[-1]))
    assert "iscc_search_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)
