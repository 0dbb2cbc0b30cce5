"""Multi-device sharding: meshes over local devices and torch.distributed, and the hierarchical top-k merge."""

from iscc_search_tpu_torch.parallel.hier import (
    hier_pm1_topk,
    hier_topk,
    make_global_array,
    make_mesh_2d,
    shard_database_2d,
)
from iscc_search_tpu_torch.parallel.mesh import make_mesh
from iscc_search_tpu_torch.parallel.sharded import shard_database, sharded_topk

__all__ = [
    "make_mesh",
    "shard_database",
    "sharded_topk",
    "make_mesh_2d",
    "shard_database_2d",
    "make_global_array",
    "hier_topk",
    "hier_pm1_topk",
]
