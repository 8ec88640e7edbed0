"""Multi-GPU training and serving on ``torch.distributed``: meshes,
launching a world, the sharded lookups (data-parallel, table-sharded, with
a replicated or a row-owned cache), the fused steps on each layout and the
data-parallel serve (counterpart of ``fbtt_embedding_tpu.parallel``)."""

from fbtt_embedding_tpu_torch.parallel.mesh import (
    default_mesh_shape,
    make_mesh,
)
from fbtt_embedding_tpu_torch.parallel.multihost import (
    host_local_slice,
    host_local_to_global,
    initialize_distributed,
    make_hybrid_mesh,
)
from fbtt_embedding_tpu_torch.parallel.sharded import (
    csr_step_adapter,
    fixed_pool_lookup,
    make_dp_cached_lookup,
    make_dp_lookup,
    make_dp_serving_fn,
    make_row_owned_cached_lookup,
    make_row_owned_fused_train_step,
    make_row_owned_populate,
    make_sharded_fused_train_step,
    make_table_sharded_fused_train_step,
    make_table_sharded_lookup,
    shard_cache_weight_by_owner,
    shard_params_for_table_parallel,
    shard_table_sharded_params,
)

__all__ = [
    "csr_step_adapter",
    "default_mesh_shape",
    "fixed_pool_lookup",
    "host_local_slice",
    "host_local_to_global",
    "initialize_distributed",
    "make_dp_cached_lookup",
    "make_dp_lookup",
    "make_dp_serving_fn",
    "make_hybrid_mesh",
    "make_mesh",
    "make_row_owned_cached_lookup",
    "make_row_owned_fused_train_step",
    "make_row_owned_populate",
    "make_sharded_fused_train_step",
    "make_table_sharded_fused_train_step",
    "make_table_sharded_lookup",
    "shard_cache_weight_by_owner",
    "shard_params_for_table_parallel",
    "shard_table_sharded_params",
]
