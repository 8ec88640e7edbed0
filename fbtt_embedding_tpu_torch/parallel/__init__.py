"""Multi-GPU training on ``torch.distributed``: meshes, launching a world,
the sharded lookups and the data-parallel fused step (counterpart of
``fbtt_embedding_tpu.parallel``; its serving and row-owned entries are not
ported yet)."""

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
    make_dp_lookup,
    make_sharded_fused_train_step,
    make_table_sharded_lookup,
    shard_params_for_table_parallel,
)

__all__ = [
    "csr_step_adapter",
    "default_mesh_shape",
    "fixed_pool_lookup",
    "host_local_slice",
    "host_local_to_global",
    "initialize_distributed",
    "make_dp_lookup",
    "make_hybrid_mesh",
    "make_mesh",
    "make_sharded_fused_train_step",
    "make_table_sharded_lookup",
    "shard_params_for_table_parallel",
]
