"""
A copy of ``iscc_search_tpu/server/metrics.py`` (the port imports nothing of the JAX package);
``tests/test_torch_host_copies.py`` holds every function of it to the
original's bytecode, the package name aside.

Minimal Prometheus-style metrics: counters + histograms, zero dependencies.

The reference's observability is /status plus env-gated Sentry; a
production serving deployment additionally needs scrapeable counters
(request rates, latency distribution, fused-batch shapes). This registry
is process-local and thread-safe; the text exposition follows the
Prometheus 0.0.4 format so any scraper can consume GET /metrics.

Scale-out note: metrics are per-process. Workers expose their own HTTP
request metrics; engine-side scan/batch metrics live in the engine process
(scrape each worker, or front them with a load balancer that scrapes the
shared port and aggregates across whichever worker answers).
"""

from __future__ import annotations

import threading

_DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Counter:
    __slots__ = ("name", "help", "_values", "_lock")

    def __init__(self, name, help_text):
        # type: (str, str) -> None
        self.name = name
        self.help = help_text
        self._values = {}  # type: dict[tuple, float]
        self._lock = threading.Lock()

    def inc(self, amount=1.0, **labels):
        # type: (float, ...) -> None
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def render(self):
        # type: () -> list[str]
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items())
        for key, value in items:
            lines.append(f"{self.name}{_fmt_labels(key)} {_fmt_num(value)}")
        return lines


class Histogram:
    __slots__ = ("name", "help", "buckets", "_counts", "_sums", "_totals", "_lock")

    def __init__(self, name, help_text, buckets=_DEFAULT_BUCKETS):
        # type: (str, str, tuple) -> None
        self.name = name
        self.help = help_text
        self.buckets = tuple(buckets)
        self._counts = {}  # type: dict[tuple, list[int]]
        self._sums = {}  # type: dict[tuple, float]
        self._totals = {}  # type: dict[tuple, int]
        self._lock = threading.Lock()

    def observe(self, value, **labels):
        # type: (float, ...) -> None
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def render(self):
        # type: () -> list[str]
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            keys = sorted(self._counts)
            snapshot = {k: (list(self._counts[k]), self._sums[k], self._totals[k]) for k in keys}
        for key in keys:
            counts, total_sum, total = snapshot[key]
            for bound, count in zip(self.buckets, counts):
                lines.append(f'{self.name}_bucket{_fmt_labels(key, le=_fmt_num(bound))} {count}')
            lines.append(f'{self.name}_bucket{_fmt_labels(key, le="+Inf")} {total}')
            lines.append(f"{self.name}_sum{_fmt_labels(key)} {_fmt_num(total_sum)}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} {total}")
        return lines


def _fmt_num(value):
    # type: (float) -> str
    if value == int(value):
        return str(int(value))
    return repr(value)


def _fmt_labels(key, **extra):
    # type: (tuple, ...) -> str
    pairs = list(key) + sorted(extra.items())
    if not pairs:
        return ""
    body = ",".join(f'{name}="{_escape(str(value))}"' for name, value in pairs)
    return "{" + body + "}"


def _escape(value):
    # type: (str) -> str
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class Registry:
    def __init__(self):
        # type: () -> None
        self._metrics = []  # type: list
        self._lock = threading.Lock()

    def counter(self, name, help_text):
        # type: (str, str) -> Counter
        metric = Counter(name, help_text)
        with self._lock:
            self._metrics.append(metric)
        return metric

    def histogram(self, name, help_text, buckets=_DEFAULT_BUCKETS):
        # type: (str, str, tuple) -> Histogram
        metric = Histogram(name, help_text, buckets)
        with self._lock:
            self._metrics.append(metric)
        return metric

    def render(self):
        # type: () -> str
        with self._lock:
            metrics = list(self._metrics)
        lines = []
        for metric in metrics:
            lines.extend(metric.render())
        return "\n".join(lines) + "\n"


registry = Registry()

# Served-request metrics (recorded by the WSGI middleware in app.py)
http_requests = registry.counter("iscc_http_requests_total", "HTTP requests by method, route and status")
http_latency = registry.histogram("iscc_http_request_seconds", "HTTP request wall time")

# Engine scan metrics (recorded by the search batcher)
batch_queries = registry.histogram(
    "iscc_scan_batch_queries",
    "Fused queries per device sweep",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
)
sweep_seconds = registry.histogram("iscc_scan_sweep_seconds", "Device sweep wall time")
