"""The index backend over the port's engines (``TpuIndex``) and its manager."""

from iscc_search_tpu_torch.indexes.tpu.index import TpuIndex
from iscc_search_tpu_torch.indexes.tpu.manager import TpuIndexManager

__all__ = ["TpuIndex", "TpuIndexManager"]
