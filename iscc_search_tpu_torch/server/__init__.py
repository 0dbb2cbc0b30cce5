"""REST API server (pure WSGI; servable via the threaded stdlib server)."""

from iscc_search_tpu_torch.server.app import create_app

__all__ = ["create_app"]
