"""Search engine: device-resident packed-code indexes, the simprint engine
and the cross-request search batcher."""

from iscc_search_tpu_torch.engine.device_index import DeviceHammingIndex, DeviceNphdIndex, PackedCodeIndex

__all__ = ["DeviceHammingIndex", "DeviceNphdIndex", "PackedCodeIndex"]
