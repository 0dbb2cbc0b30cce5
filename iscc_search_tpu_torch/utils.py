"""
A copy of ``iscc_search_tpu/utils.py`` (the port imports nothing of the JAX package);
``tests/test_torch_host_copies.py`` holds every function of it to the
original's bytecode, the package name aside.

Logging and timing utilities (loguru is unavailable; stdlib logging)."""

from __future__ import annotations

import logging
import sys
import time
from contextlib import contextmanager

class OverloadedError(RuntimeError):
    """The serving stack is past its concurrency/queue bound; retry later.

    Maps to HTTP 503 + Retry-After (server/wsgi.py) and crosses the
    scale-out RPC boundary by name (server/scaleout.py _EXC_TYPES)."""


def configure_logging(level="INFO", stream=None):
    # type: (str, ...) -> None
    """Configure package logging in a production-friendly single-line format.

    Replaces any existing handlers (safe to call more than once)."""
    handler = logging.StreamHandler(stream or sys.stdout)
    handler.setFormatter(
        logging.Formatter(
            fmt="%(asctime)s.%(msecs)03d | %(levelname)-7s | %(name)s:%(funcName)s:%(lineno)d - %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S",
        )
    )
    root = logging.getLogger("iscc_search_tpu_torch")
    root.handlers = [handler]
    root.setLevel(level.upper())


def get_logger(name):
    # type: (str) -> logging.Logger
    """Namespaced logger WITHOUT configuring handlers.

    Libraries must not attach handlers as an import side effect (the host
    application would get unsolicited stdout lines and double emission once
    it configures logging itself). The CLI and server entry points call
    configure_logging() explicitly."""
    return logging.getLogger(name)


@contextmanager
def timer(message="elapsed"):
    # type: (str) -> ...
    """Context manager printing wall-clock duration (parity with utils.timer)."""
    log = get_logger("iscc_search_tpu_torch.timer")
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log.info(f"{message}: {time.perf_counter() - t0:.3f}s")
