"""Search ops: bit packing, NPHD scoring, the ±1 scan and its Hopper kernels."""

from iscc_search_tpu_torch.ops.nphd import nphd_scores
from iscc_search_tpu_torch.ops.packing import pack_code, pack_codes, unpack_code

__all__ = ["nphd_scores", "pack_code", "pack_codes", "unpack_code"]
