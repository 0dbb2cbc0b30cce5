"""
Generator "closed_loop": ``mix["clients"]`` closed-loop clients over a
request pool.

Client ``c`` of ``C`` sends requests ``c, c + C, c + 2C, ...`` of the pool,
cycling, each as soon as its previous one is answered. Every seed gives the
same number of requests of the same sizes; only their contents differ.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

LATE_S = 60.0  # an answer later than this after the window's close never came


@dataclass
class Outcome:
    t_start: float
    t_end: float  # the window's close: no request is sent after it
    requests: list = field(default_factory=list)  # (t0, t1, items) of answered requests
    errors: list = field(default_factory=list)  # repr of each failed request's exception
    answers: dict = field(default_factory=dict)  # sampled item -> [answer, ...]

    @property
    def attempted(self):
        return len(self.requests) + len(self.errors)


def run(handle, requests, mix, seconds, record=frozenset(), rounds=None):
    """Run the mix's clients for ``seconds`` (or, with ``rounds``, for that
    many requests each, as a warm-up) and return the :class:`Outcome`.
    ``handle(request)`` returns one answer per item of the request; the
    answers of items in ``record`` are kept."""
    clients = mix["clients"]
    lock = threading.Lock()
    stop = threading.Event()
    ready = threading.Barrier(clients + 1)
    outcome = Outcome(0.0, 0.0)

    def client(c):
        ready.wait()
        j = 0
        while not stop.is_set() and (rounds is None or j < rounds):
            request = requests[(c + j * clients) % len(requests)]
            j += 1
            t0 = time.perf_counter()
            try:
                answers = handle(request)
            except Exception as exc:  # a failed request is counted, and the client goes on
                with lock:
                    outcome.errors.append(repr(exc))
                continue
            t1 = time.perf_counter()
            with lock:
                outcome.requests.append((t0, t1, len(request)))
                for item, answer in zip(request, answers):
                    if item in record:
                        outcome.answers.setdefault(int(item), []).append(answer)

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}", daemon=True) for c in range(clients)]
    for t in threads:
        t.start()
    ready.wait()
    outcome.t_start = time.perf_counter()
    if rounds is None:
        stop.wait(seconds)
        stop.set()
    outcome.t_end = time.perf_counter()
    for t in threads:
        t.join(max(0.0, outcome.t_end + LATE_S - time.perf_counter()))
        if t.is_alive():  # its request never came: failed
            outcome.errors.append(f"{t.name}: no answer {LATE_S} s after the close")
    if rounds is not None:
        outcome.t_end = time.perf_counter()
    return outcome
