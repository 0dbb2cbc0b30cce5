"""
ISCC index protocol — the backend contract.

Mirrors the reference protocol (iscc_search/protocols/index.py:20-174): eight
synchronous methods and the exception contract ValueError / FileExistsError /
FileNotFoundError. Backends are free to thread internally; the REST layer runs
them in worker threads.
"""

from typing import TYPE_CHECKING, Protocol, runtime_checkable

if TYPE_CHECKING:  # pragma: no cover
    from iscc_search_tpu_torch.schema import (  # noqa: F401
        IsccAddResult,
        IsccEntry,
        IsccIndex,
        IsccQuery,
        IsccSearchResult,
    )


@runtime_checkable
class IsccIndexProtocol(Protocol):
    """
    Protocol for ISCC index backends.

    Exception contract:
    - ValueError: invalid parameters or validation failures
    - FileExistsError: creating an index that already exists
    - FileNotFoundError: accessing a missing index or asset
    """

    def list_indexes(self):
        # type: () -> list[IsccIndex]
        """List all available indexes with metadata (name, assets, size[, sizes])."""
        ...

    def create_index(self, index):
        # type: (IsccIndex) -> IsccIndex
        """Create a new named index (name pattern ^[a-z][a-z0-9]*$)."""
        ...

    def get_index(self, name):
        # type: (str) -> IsccIndex
        """Get index metadata by name."""
        ...

    def delete_index(self, name):
        # type: (str) -> None
        """Delete an index and all its data."""
        ...

    def add_assets(self, index_name, assets):
        # type: (str, list[IsccEntry]) -> list[IsccAddResult]
        """Add assets; returns created/updated status per asset."""
        ...

    def get_asset(self, index_name, iscc_id):
        # type: (str, str) -> IsccEntry
        """Get a specific asset by ISCC-ID."""
        ...

    def search_assets(self, index_name, query, limit=100):
        # type: (str, IsccQuery, int) -> IsccSearchResult
        """Top-k similarity search aggregated across unit types."""
        ...

    def close(self):
        # type: () -> None
        """Release resources; idempotent."""
        ...
