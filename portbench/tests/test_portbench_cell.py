"""Each cell end to end on the CPU at a small size, sound and with the timed
path broken underneath."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import ROOT, TINY

KEYS = {"correct", "attempted", "failed", "metrics", "device"}
DEVICE_SOURCES = {"device_trace"}


def run_tiny(spec, workload, trace=0, seed=4_000_000_007):
    config_over, mix_over = TINY[workload]
    return harness.run_cell(spec, workload, seed, 1.0, trace, "cpu", config_over=config_over, mix_over=mix_over,
                            log=lambda *_: None)


def test_every_name_is_a_file(spec):
    """A cell finds its configuration, mix and metrics by name alone."""
    for cell in spec["workloads"]:
        harness.resolve(spec, cell["name"])
        mix = json.loads((ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
        assert (ROOT / "portbench" / "traffic" / f"{mix['generator']}.py").is_file()
    for key in ("end_to_end", "per_layer"):
        for metric in spec[key]:
            assert callable(harness.load_reader(metric["name"])), metric["name"]
    for config in spec["configs"]:
        text = json.loads((ROOT / config["file"]).read_text())
        assert text["name"] == config["name"] and text["reduced"] == config["reduced"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", list(TINY))
def test_a_small_cell_runs_end_to_end(spec, workload, trace):
    result, checks = run_tiny(spec, workload, trace)
    assert KEYS <= set(result) and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert result["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    assert "breakdown" not in result
    device_metrics = {m["name"] for key in ("end_to_end", "per_layer") for m in spec[key]
                      if m["source"] in DEVICE_SOURCES}
    assert not device_metrics & set(result["metrics"])
    want = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])} - device_metrics
    assert set(result["metrics"]) == want
    for name, value, limit in checks:
        assert result["checks"][name] == {"value": value, "limit": limit}


def half_the_batch(impl):
    def scan(q_codes, q_lanes, *args, **kwargs):
        scores, rows = impl(q_codes, q_lanes, *args, **kwargs)
        half = q_codes.shape[0] // 2
        rows[half:] = -1
        return scores, rows
    return scan


def half_the_rows(impl):
    def scan(q_codes, q_lanes, packed, valid, *args, **kwargs):
        valid = valid.clone()
        valid[valid.shape[0] // 2 :] = 0
        return impl(q_codes, q_lanes, packed, valid, *args, **kwargs)
    return scan


def altered_scores(impl):
    def scan(*args, **kwargs):
        scores, rows = impl(*args, **kwargs)
        return scores + 2.0**-10, rows
    return scan


def altered_asset_scores(impl):
    def score(self, *args, **kwargs):
        return [dataclasses.replace(m, score=m.score + 2.0**-10) for m in impl(self, *args, **kwargs)]
    return score


FAULTS = {
    "half the batch left out": ("iscc_search_tpu_torch.engine.device_index", "blockmax_topk_packedq_impl", half_the_batch),
    "half the rows left out": ("iscc_search_tpu_torch.engine.device_index", "blockmax_topk_packedq_impl", half_the_rows),
    "scores altered where produced": (
        "iscc_search_tpu_torch.engine.device_index", "blockmax_topk_packedq_impl", altered_scores),
    "asset scores altered where produced": (
        "iscc_search_tpu_torch.engine.simprint", "SimprintEngine._score_query_asset", altered_asset_scores),
}


@pytest.mark.parametrize("workload, fault", [(w, f) for w in TINY for f in FAULTS
                                             if w.startswith("c4") or "asset" not in f])
def test_a_broken_timed_path_is_not_correct(spec, workload, fault, monkeypatch):
    module_name, attr, wrap = FAULTS[fault]
    module = __import__(module_name, fromlist=["_"])
    owner, _, name = attr.rpartition(".")
    target = getattr(module, owner) if owner else module
    monkeypatch.setattr(target, name, wrap(getattr(target, name)))
    result, checks = run_tiny(spec, workload)
    assert result["correct"] is False, checks


def test_no_result_without_a_card(monkeypatch, capsys):
    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):  # main() sets them: restored after
        monkeypatch.setenv(name, "")
    assert run.main(["--workload", "c3_bulk512", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_reader_of_nothing_returns_none():
    run = harness.Run(1.0, 0.0, 1.0, [], [], [], ([(256, 2)], 10))
    for name in ("kernels_per_sweep.units", "scan_roofline.units", "device_idle_pct.units",
                 "score_ms_per_asset", "request_p95_ms"):
        assert harness.load_reader(name)(run) is None
    assert Path(harness.HERE / "metrics" / "setup_s.py").is_file()
