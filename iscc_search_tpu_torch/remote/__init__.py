from iscc_search_tpu_torch.remote.client import RemoteIndex

__all__ = ["RemoteIndex"]
