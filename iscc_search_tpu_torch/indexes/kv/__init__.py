from iscc_search_tpu_torch.indexes.kv.index import KvIndex
from iscc_search_tpu_torch.indexes.kv.manager import KvIndexManager

__all__ = ["KvIndex", "KvIndexManager"]
