"""
Authentication and endpoint gating.

Parity with the reference auth layer (server/auth.py): optional X-API-Key with
constant-time comparison (public mode when no secret configured), route-hiding
404s for management endpoints in aggregator mode, and foreign-index read
blocking in aggregator mode.
"""

from __future__ import annotations

import secrets

from iscc_search_tpu_torch.server.wsgi import HTTPError


def verify_api_key(request, opts):
    # type: (..., ...) -> None
    """401 unless the X-API-Key header matches the configured secret."""
    if opts.api_secret is None:
        return
    api_key = request.headers.get("x-api-key")
    # Compare bytes: compare_digest on str raises TypeError for non-ASCII
    # values (500 instead of 401). WSGI decodes headers latin-1 (PEP 3333),
    # so encode the header back to latin-1 to recover the RAW bytes the
    # client sent — UTF-8 re-encoding would make a non-ASCII secret never
    # match its own correct key.
    if api_key is None or not secrets.compare_digest(
        api_key.encode("latin-1", "replace"), opts.api_secret.encode()
    ):
        raise HTTPError(401, "Unauthorized")


def block_if_aggregator(opts):
    # type: (...) -> None
    """Route-hiding 404 for suppressed endpoints in aggregator mode (before auth)."""
    if opts.aggregator_mode:
        raise HTTPError(404, "Not Found")


def block_foreign_index_if_aggregator(name, opts):
    # type: (str, ...) -> None
    """In aggregator mode, only the derived aggregator index is readable."""
    if opts.aggregator_mode and name != opts.aggregator_index_name:
        raise HTTPError(404, "Not Found")
