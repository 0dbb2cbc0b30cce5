"""
Per-second readings of the run's own process through the window: logged
beside the result, read by no metric.

Where a rate moves inside a run they tell the causes apart: the process
descheduled (involuntary switches, its busiest thread's share of a core),
collecting garbage, or running on a core that does less work in the same
CPU time (the same share of a core at a lower rate).
"""

from __future__ import annotations

import gc
import os
import resource
import threading
import time

TICK = os.sysconf("SC_CLK_TCK")


def thread_ticks():
    """{thread id: user + system clock ticks} of this process."""
    out = {}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                rest = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        out[tid] = int(rest[11]) + int(rest[12])
    return out


class HostWatch:
    """Samples once a second on a thread of its own, from ``start`` to ``stop``."""

    def __init__(self, period=1.0):
        self.period = period
        self.samples = []
        self._stop = threading.Event()
        self._gc_s = 0.0
        self._gc_t0 = None
        self._thread = threading.Thread(target=self._loop, name="hostwatch", daemon=True)

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self._gc_s += time.perf_counter() - self._gc_t0
            self._gc_t0 = None

    def _sample(self):
        use = resource.getrusage(resource.RUSAGE_SELF)
        self.samples.append(dict(
            t=time.perf_counter(), cpu=use.ru_utime + use.ru_stime, nivcsw=use.ru_nivcsw,
            gc_n=sum(s["collections"] for s in gc.get_stats()), gc_s=self._gc_s, threads=thread_ticks()))

    def _loop(self):
        while not self._stop.wait(self.period):
            self._sample()

    def start(self):
        gc.callbacks.append(self._gc)
        self._sample()
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join()
        self._sample()
        gc.callbacks.remove(self._gc)

    def lines(self):
        """The log lines: one list per reading, an entry per second."""
        rows = {k: [] for k in ("process cpu s", "busiest thread share", "involuntary switches", "gc collections",
                                "gc ms")}
        for a, b in zip(self.samples, self.samples[1:]):
            dt = b["t"] - a["t"]
            rows["process cpu s"].append(round(b["cpu"] - a["cpu"], 3))
            used = [b["threads"][tid] - a["threads"][tid] for tid in b["threads"] if tid in a["threads"]]
            rows["busiest thread share"].append(round(max(used, default=0) / TICK / dt, 2))
            rows["involuntary switches"].append(b["nivcsw"] - a["nivcsw"])
            rows["gc collections"].append(b["gc_n"] - a["gc_n"])
            rows["gc ms"].append(round((b["gc_s"] - a["gc_s"]) * 1e3, 1))
        return [f"host per second: {name} {values}" for name, values in rows.items()]
