"""fbtt_embedding_tpu_torch: TT-compressed EmbeddingBag in PyTorch + CUDA.

The port of ``fbtt_embedding_tpu`` (JAX, Pallas kernels for the TPU) to
PyTorch with hand-written CUDA kernels for Hopper. It imports neither JAX
nor the JAX package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU each kernel's plain PyTorch version runs.

Ported so far: the serving path (``make_serving_fn``) through the flat
sorted-run pipeline and its segment-transform kernel.
"""

from fbtt_embedding_tpu_torch.models.tt_embedding import (
    TTEmbeddingParams,
    make_serving_fn,
    params_from_jax,
)
from fbtt_embedding_tpu_torch.ops.contraction import tt_rows, validate_tt_shapes
from fbtt_embedding_tpu_torch.ops.indexing import (
    decompose_indices,
    decompose_indices64,
    rowidx_from_offsets,
    tt_strides,
    wide_keyrows,
)
from fbtt_embedding_tpu_torch.ops.kernels.seg_transform import (
    seg_transform,
    seg_transform_plain,
)
from fbtt_embedding_tpu_torch.ops.lookup import pool_rows, pooled_tt_lookup
from fbtt_embedding_tpu_torch.utils.init import core_shapes, init_tt_cores
from fbtt_embedding_tpu_torch.utils.shapes import suggested_tt_shapes

__all__ = [
    "TTEmbeddingParams",
    "core_shapes",
    "decompose_indices",
    "decompose_indices64",
    "init_tt_cores",
    "make_serving_fn",
    "params_from_jax",
    "pool_rows",
    "pooled_tt_lookup",
    "rowidx_from_offsets",
    "seg_transform",
    "seg_transform_plain",
    "suggested_tt_shapes",
    "tt_rows",
    "tt_strides",
    "validate_tt_shapes",
    "wide_keyrows",
]
