"""Search engine: device-resident packed-code indexes."""

from iscc_search_tpu_torch.engine.device_index import DeviceNphdIndex, PackedCodeIndex

__all__ = ["DeviceNphdIndex", "PackedCodeIndex"]
