"""DP x face-sharded execution of the port over a device mesh.

Counterpart of the JAX package's ``deepsphere_tpu.parallel``.  One
process per device; the caller starts the process
group (``torch.distributed.init_process_group``) and builds the mesh with
:func:`make_mesh`.  Then ``HealpyGCNN(..., shard_cfg=ShardConfig(mesh))``
runs its cface convs face-sharded over the ``pixel`` axis and its other
convs on the halo-sharded ELLPACK, and ``model.compile(...,
data_sharding=batch_sharding(mesh))`` trains on each rank's rows
(:func:`data_iterator`), gradients summed over the ``data`` axis.  A
graph transformer's edge attention runs pixel-sharded
(:func:`sharded_edge_attention`) where the pixel count divides over the
``pixel`` axis.
"""

from .attention_sharded import partition_edges_by_dst, sharded_edge_attention
from .cface_sharded import cface_model_conv, face_shard_tables, face_sharded_cfp_conv
from .collectives import all_reduce_sum, exchange_gather, shard, sum_grad, unshard
from .data import data_iterator, global_batch
from .halo import ShardedEllpack, shard_ellpack, shard_ellpack_cached
from .mesh import BatchSharding, Replicated, batch_sharding, make_mesh, replicated
from .sharded_ops import ShardConfig, sharded_poly_conv

__all__ = [
    "global_batch",
    "data_iterator",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "BatchSharding",
    "Replicated",
    "ShardConfig",
    "sharded_poly_conv",
    "ShardedEllpack",
    "shard_ellpack",
    "shard_ellpack_cached",
    "face_shard_tables",
    "face_sharded_cfp_conv",
    "cface_model_conv",
    "partition_edges_by_dst",
    "sharded_edge_attention",
    "shard",
    "unshard",
    "exchange_gather",
    "all_reduce_sum",
    "sum_grad",
]
