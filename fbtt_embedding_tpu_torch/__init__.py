"""fbtt_embedding_tpu_torch: TT-compressed EmbeddingBag in PyTorch + CUDA.

The port of ``fbtt_embedding_tpu`` (JAX, Pallas kernels for the TPU) to
PyTorch with hand-written CUDA kernels for Hopper. It imports neither JAX
nor the JAX package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU each kernel's plain PyTorch version runs.

Ported: the serving path (``make_serving_fn``) and the fused training
step (``make_fused_train_step``: the reference's SGD / Adagrad, or with
``optim_semantics="native"`` every optimizer's own update,
``native_optim_init`` / ``native_optim_step``) through the flat
sorted-run pipeline and its kernels: the segment transform (B1), the fused
last-core training pass (B2), the gradient pass (B3) and, with
``FBTT_DG0=fused``, the gradient pass with the first core's gradient folded
in (B6); with ``impl="pallas"`` the same entry points run the generic
per-lookup kernels (B4 forward, B5 backward). Both entries take the LFU
cache (``ops.cache``: counting, populate, probing, the cached rows'
updates; direct and hashed int32 keys, and the wide int64-key layout for
tables of 2^31 rows or more, keyed by ``wide_keyrows``). The modules
``TableBatchedTTEmbeddingBag`` and ``TTEmbeddingBag`` (``torch.nn.Module``:
``out = emb(indices, offsets)``, then ``emb.backward(d_out)``,
``emb.cache_populate()``, ...) run on the same kernels. Frozen-weight
serving folds the cores once (``make_folded_serving_fn``,
``emb.freeze_for_serving``: the pair table on B1, optionally int8;
``refold_cache``; ``make_bucketed_serving_fn`` for requests of any size).
The DLRM model (``models.dlrm``: ``DLRMConfig``, ``init_dlrm_params``,
``dlrm_forward``, ``make_dlrm_train_step``) trains on the same lookup
through autograd, with its walkthrough ``examples.train_dlrm``; on several
GPUs (``parallel``, on ``torch.distributed``: ``initialize_distributed``,
``make_mesh`` / ``make_hybrid_mesh``, the data-parallel and table-sharded
lookups, the data-parallel fused step ``make_sharded_fused_train_step``
with ``csr_step_adapter``, the table-owned step
``make_table_sharded_fused_train_step``, the data-parallel serve
``make_dp_serving_fn``, the replicated-cache lookup
``make_dp_cached_lookup``, the row-owned cache's lookup, populate and step
``make_row_owned_*``, the table-sharded DLRM step with
``shard_dlrm_params``), the host batches coming from the native loader
(``native``: ``generate_batch``, ``PrefetchLoader``, the CSR re-layout
``pad_csr_to_fixed``);
the tooling: ``utils.checkpoint`` (``save`` / ``restore``, npz files in
the JAX package's leaf order), ``utils.guard`` (``finite_flag``,
``assert_finite``, ``guard_step``), ``utils.profiling`` (``trace``,
``tt_flops``, ``slope_time``, ``speed_of_light``) and the benchmark CLI
``python -m fbtt_embedding_tpu_torch.benchmark``. Also the
dense-mode functions (``tt_forward``, ``tt_dense_backward``,
``tt_sgd_backward``, ...), ``tt_embedding_forward``, ``tt_matrix_to_full``
and the TT-SVD import ``tt_decompose``. The ``FBTT_*`` knobs it reads
(``FBTT_DG0``, ``FBTT_PAIR``, ``FBTT_FUSED_APPLY``: A/B overrides of the
schedule, read at every call) are listed by ``python -m
fbtt_embedding_tpu_torch.utils.knobs``.
"""

from fbtt_embedding_tpu_torch import native, parallel
from fbtt_embedding_tpu_torch.models.dlrm import (
    DLRMConfig,
    DLRMParams,
    MLPParams,
    bce_loss,
    dlrm_forward,
    dlrm_params_from_jax,
    init_dlrm_params,
    make_dlrm_train_step,
    shard_dlrm_params,
)
from fbtt_embedding_tpu_torch.models.tt_embedding import (
    FoldedServingParams,
    OptimType,
    TableBatchedTTEmbeddingBag,
    TTEmbeddingBag,
    TTEmbeddingParams,
    make_bucketed_serving_fn,
    make_folded_serving_fn,
    make_fused_train_step,
    make_serving_fn,
    params_from_jax,
    params_from_state_dict,
    refold_cache,
    tt_embedding_forward,
)
from fbtt_embedding_tpu_torch.ops.cache import (
    CacheState,
    hash_keys_wide,
    wide_cache_keys,
    cache_backward_adagrad,
    cache_backward_dense,
    cache_backward_rowwise_adagrad_approx,
    cache_backward_sgd,
    cache_forward,
    cache_lookup,
    cache_populate,
    hash_keys,
    make_cache_state,
    populate_plan,
    preprocess_indices,
    reset_cache,
    update_cache_state,
)
from fbtt_embedding_tpu_torch.ops.contraction import (
    tt_matrix_to_full,
    tt_rows,
    validate_tt_shapes,
)
from fbtt_embedding_tpu_torch.ops.indexing import (
    decompose_indices,
    decompose_indices64,
    pad_csr_to_fixed,
    rowidx_from_offsets,
    tt_strides,
    wide_keyrows,
)
from fbtt_embedding_tpu_torch.ops.fused_optim import (
    NATIVE_HPARAM_DEFAULTS,
    adagrad_step,
    native_optim_init,
    native_optim_step,
    sgd_step,
    tt_adagrad_backward,
    tt_sgd_backward,
)
from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import (
    seg_accum,
    seg_accum_plain,
)
from fbtt_embedding_tpu_torch.ops.kernels.seg_accum_dg0 import (
    seg_accum_dg0,
    seg_accum_dg0_plain,
)
from fbtt_embedding_tpu_torch.ops.kernels.seg_fused_i2 import (
    seg_fused_i2,
    seg_fused_i2_plain,
)
from fbtt_embedding_tpu_torch.ops.kernels.seg_transform import (
    seg_transform,
    seg_transform_plain,
)
from fbtt_embedding_tpu_torch.ops.kernels.tt_flat import (
    FlatLookup,
    flat_train_apply,
)
from fbtt_embedding_tpu_torch.ops.kernels.tt_bwd import tt_bwd, tt_bwd_plain
from fbtt_embedding_tpu_torch.ops.kernels.tt_fwd import (
    tt_fwd,
    tt_fwd_pivot_plain,
    tt_fwd_plain,
)
from fbtt_embedding_tpu_torch.ops.kernels.tt_kernel import (
    generic_available,
    tt_backward_kernel,
    tt_forward_kernel,
)
from fbtt_embedding_tpu_torch.ops.lookup import (
    GenericLookup,
    pool_rows,
    pooled_tt_lookup,
    tt_dense_backward,
    tt_embedding_bag_forward,
    tt_forward,
    tt_grads_from_row_cotangents,
)
from fbtt_embedding_tpu_torch.parallel import (
    csr_step_adapter,
    initialize_distributed,
    make_dp_cached_lookup,
    make_dp_lookup,
    make_dp_serving_fn,
    make_hybrid_mesh,
    make_mesh,
    make_row_owned_cached_lookup,
    make_row_owned_fused_train_step,
    make_row_owned_populate,
    make_sharded_fused_train_step,
    make_table_sharded_fused_train_step,
    make_table_sharded_lookup,
    shard_cache_weight_by_owner,
    shard_table_sharded_params,
)
from fbtt_embedding_tpu_torch.utils import checkpoint, guard, profiling
from fbtt_embedding_tpu_torch.utils.guard import (
    ReplicaDivergenceError,
    assert_replicas_agree,
)
from fbtt_embedding_tpu_torch.utils.decompose import tt_decompose
from fbtt_embedding_tpu_torch.utils.init import core_shapes, init_tt_cores
from fbtt_embedding_tpu_torch.utils.shapes import suggested_tt_shapes

__all__ = [
    "CacheState",
    "DLRMConfig",
    "DLRMParams",
    "FlatLookup",
    "FoldedServingParams",
    "GenericLookup",
    "MLPParams",
    "NATIVE_HPARAM_DEFAULTS",
    "OptimType",
    "ReplicaDivergenceError",
    "TTEmbeddingBag",
    "TTEmbeddingParams",
    "TableBatchedTTEmbeddingBag",
    "adagrad_step",
    "assert_replicas_agree",
    "bce_loss",
    "cache_backward_adagrad",
    "cache_backward_dense",
    "cache_backward_rowwise_adagrad_approx",
    "cache_backward_sgd",
    "cache_forward",
    "cache_lookup",
    "cache_populate",
    "checkpoint",
    "core_shapes",
    "csr_step_adapter",
    "decompose_indices",
    "decompose_indices64",
    "dlrm_forward",
    "dlrm_params_from_jax",
    "flat_train_apply",
    "generic_available",
    "guard",
    "hash_keys",
    "hash_keys_wide",
    "init_dlrm_params",
    "init_tt_cores",
    "initialize_distributed",
    "make_bucketed_serving_fn",
    "make_cache_state",
    "make_dlrm_train_step",
    "make_dp_cached_lookup",
    "make_dp_lookup",
    "make_dp_serving_fn",
    "make_folded_serving_fn",
    "make_fused_train_step",
    "make_hybrid_mesh",
    "make_mesh",
    "make_row_owned_cached_lookup",
    "make_row_owned_fused_train_step",
    "make_row_owned_populate",
    "make_serving_fn",
    "make_sharded_fused_train_step",
    "make_table_sharded_fused_train_step",
    "make_table_sharded_lookup",
    "native",
    "native_optim_init",
    "native_optim_step",
    "pad_csr_to_fixed",
    "parallel",
    "params_from_jax",
    "params_from_state_dict",
    "pool_rows",
    "pooled_tt_lookup",
    "populate_plan",
    "preprocess_indices",
    "profiling",
    "refold_cache",
    "reset_cache",
    "rowidx_from_offsets",
    "seg_accum",
    "seg_accum_dg0",
    "seg_accum_dg0_plain",
    "seg_accum_plain",
    "seg_fused_i2",
    "seg_fused_i2_plain",
    "seg_transform",
    "seg_transform_plain",
    "sgd_step",
    "shard_cache_weight_by_owner",
    "shard_dlrm_params",
    "shard_table_sharded_params",
    "suggested_tt_shapes",
    "tt_adagrad_backward",
    "tt_backward_kernel",
    "tt_bwd",
    "tt_bwd_plain",
    "tt_decompose",
    "tt_dense_backward",
    "tt_embedding_bag_forward",
    "tt_embedding_forward",
    "tt_forward",
    "tt_forward_kernel",
    "tt_fwd",
    "tt_fwd_pivot_plain",
    "tt_fwd_plain",
    "tt_grads_from_row_cotangents",
    "tt_matrix_to_full",
    "tt_rows",
    "tt_sgd_backward",
    "tt_strides",
    "update_cache_state",
    "validate_tt_shapes",
    "wide_cache_keys",
    "wide_keyrows",
]
