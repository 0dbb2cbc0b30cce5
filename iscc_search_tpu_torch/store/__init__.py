"""Host-side persistent storage (the C++ tructstore and its ctypes binding)."""

from iscc_search_tpu_torch.store.kv import HostStore

__all__ = ["HostStore"]
