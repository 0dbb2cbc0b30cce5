from iscc_search_tpu_torch.indexes.memory.index import MemoryIndex

__all__ = ["MemoryIndex"]
