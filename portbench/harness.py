"""
One run of one cell of ``BENCHMARK.json``, found by name.

A cell names a configuration (``portbench/configs/<config>.json``, which
names its kind of system, ``portbench/systems/<system>.py``, and its plain
reference, ``portbench/reference/<reference>.py``) and a traffic mix
(``portbench/traffic/<traffic>.json``, which names its generator,
``portbench/traffic/<generator>.py``, and holds its parameters); each metric
is read by ``portbench/metrics/<metric>.py``. A run: set-up (data from the seed, the
program built from it, its first search, every sweep shape of the mix
warmed), the window of ``seconds``, optionally traced, then the program's
state freed and the sampled answers compared with the reference.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import resource
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from portbench import hostwatch, tracing
from portbench.spans import Spans
from portbench.systems.units import seed_rng

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "iscc_search_tpu")  # top-level module names, compared whole
RECORD_FACTOR = 4  # answers are kept for this many times the sample, in the seed's order


@dataclass
class Run:
    """What a finished run hands the metric readers (``readers.py``)."""

    setup_s: float
    t_start: float
    t_end: float
    requests: list  # (t0, t1, items) of the requests sent in the window
    spans: list  # host spans in the window: (kind, t0, t1)
    sweeps: list  # device sweeps in the window: (queries, t0, t1)
    shapes: tuple  # (partitions [(rows, lanes)], results per query) of one sweep's work
    trace: tracing.DeviceTrace | None = None


def load_json(path):
    return json.loads(Path(path).read_text())


def load_reader(name):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name.replace('.', '__')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def resolve(spec, workload):
    """(cell, configuration, mix, metrics) of ``workload``: each metric of
    ``spec`` that the cell reports, with ``per_layer`` True for the traced
    run's."""
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = load_json(HERE.parent / entry["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    metrics = []
    for per_layer, key in ((False, "end_to_end"), (True, "per_layer")):
        metrics += [dict(m, per_layer=per_layer) for m in spec[key] if workload in m.get("workloads", [workload])]
    return cell, config, mix, metrics


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def card(device):
    """The card's name and power limit, by ``nvidia-smi``, beside every number."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i",
                               str(device.index or 0)], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc!r}"


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def log_window(outcome, sweeps, peak, cpu0, cpu1, log):
    """What the window did, beside the result: requests, failures, sweeps,
    items answered in each second, sweep sizes, the host's CPU time."""
    log(f"window: opened at unix time {time.time() - (time.perf_counter() - outcome.t_start):.3f}")
    log(f"window: {outcome.attempted} requests sent in {outcome.t_end - outcome.t_start:.3f} s, "
        f"{len(outcome.errors)} failed, {len(sweeps)} device sweeps; device memory peak {peak} bytes")
    for err in outcome.errors[:5]:
        log(f"failed request: {err}")
    per_s = [0] * max(1, round(outcome.t_end - outcome.t_start))
    for _, t1, n in outcome.requests:
        if t1 <= outcome.t_end:
            per_s[min(len(per_s) - 1, int(t1 - outcome.t_start))] += n
    sizes = sorted(nq for nq, _, _ in sweeps) or [0]
    log(f"window: items answered per second {per_s}; queries per sweep p10/p50/p90 "
        f"{sizes[len(sizes) // 10]}/{sizes[len(sizes) // 2]}/{sizes[len(sizes) * 9 // 10]}; host CPU "
        f"{cpu1.ru_utime - cpu0.ru_utime:.2f} s user, {cpu1.ru_stime - cpu0.ru_stime:.2f} s system")


def run_cell(spec, workload, seed, seconds, trace, device="cuda", t0=None, config_over=None, mix_over=None,
             log=print, marks=()):
    """Run one cell; return (result line dict, [(check, value, limit)]).
    ``config_over`` and ``mix_over`` replace keys of the configuration and
    the mix (the tests' small sizes); ``marks`` are the (stage, end time)
    of set-up before the call."""
    t0 = time.perf_counter() if t0 is None else t0
    cell, config, mix, metrics = resolve(spec, workload)
    config.update(config_over or {})
    mix.update(mix_over or {})
    system = importlib.import_module(f"portbench.systems.{config['system']}")
    reference = importlib.import_module(f"portbench.reference.{config['reference']}")
    generator = importlib.import_module(f"portbench.traffic.{mix['generator']}")
    dev = torch.device(device)
    stages, last = {}, [t0]
    for name, t in marks:
        stages[name] = t - last[0]
        last[0] = t

    def stage(name):
        sync(dev)
        now = time.perf_counter()
        stages[name] = now - last[0]
        last[0] = now

    if dev.type == "cuda":
        torch.zeros(1, device=dev)
    stage("CUDA init")
    data = system.make_data(config, seed, dev)
    pool = system.make_pool(data, config, mix, seed)
    stage("data from the seed")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    spans = Spans()
    sut = system.System(data, config, mix, dev, spans)
    stage("build")
    sut.first_search(pool)
    stage("first search")
    sut.warm_shapes(pool)
    generator.run(lambda r: sut.handle(pool, r), pool.requests, mix, 0, rounds=mix["warmup_rounds"])
    stage("warm-up")

    items = sum(len(r) for r in pool.requests)
    order = seed_rng(seed, 2).permutation(items)
    record = set(order[: RECORD_FACTOR * pool.sample].tolist())
    profiler = tracing.Profiler() if trace and dev.type == "cuda" else None
    watch = hostwatch.HostWatch()
    if profiler is not None:
        profiler.start()
    setup_s = time.perf_counter() - t0
    cpu0 = resource.getrusage(resource.RUSAGE_SELF)
    watch.start()
    outcome = generator.run(lambda r: sut.handle(pool, r), pool.requests, mix, seconds, record)
    watch.stop()
    cpu1 = resource.getrusage(resource.RUSAGE_SELF)
    if profiler is not None:
        profiler.stop()
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    records, sweeps = spans.since(outcome.t_start)
    run = Run(setup_s, outcome.t_start, outcome.t_end, outcome.requests, records, sweeps,
              system.sweep_shapes(data, config, mix))
    if profiler is not None:
        requests = [("request", a, b) for a, b, _ in outcome.requests]
        run.trace = profiler.reduce(records + requests, sut.outside_label)
    sut.close()
    del sut
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if dev.type == "cuda":
        log(f"card: {card(dev)}")
    for name, s in stages.items():
        log(f"setup: {name} {s:.3f} s")
    log_window(outcome, sweeps, peak, cpu0, cpu1, log)
    for line in watch.lines():
        log(line)

    # The comparison, after the program's state is freed.
    t_ref = time.perf_counter()
    checked = [int(i) for i in order[: RECORD_FACTOR * pool.sample] if int(i) in outcome.answers][: pool.sample]
    ref = reference.answers(data, pool, checked, config, mix, dev)
    numbers = reference.judge(data, pool, checked, outcome.answers, ref, config, mix)
    checks = [(name, numbers[name], limit) for name, limit in config["limits"].items()]
    log(f"reference: {len(checked)} sampled items, {sum(len(outcome.answers[i]) for i in checked)} answers "
        f"compared in {time.perf_counter() - t_ref:.3f} s")
    correct = bool(checked) and not outcome.errors and all(value <= limit for _, value, limit in checks)

    values = {}
    for m in metrics:
        if m["per_layer"] == bool(trace):
            value = load_reader(m["name"])(run)
            if value is not None:
                values[m["name"]] = {"value": value, "unit": m["unit"]}
    if dev.type == "cuda":
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell["chips"],
                       "memory_peak_bytes": int(peak)}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": outcome.attempted, "failed": len(outcome.errors),
              "metrics": values, "device": device_info}
    if run.trace is not None:
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = tracing.breakdown(run.trace)
        log(f"trace: {run.trace.kernels} kernels, busy {run.trace.busy_s:.6f} of {run.trace.window_s:.6f} s")
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result, checks
