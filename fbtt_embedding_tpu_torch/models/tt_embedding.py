"""TT-compressed embedding serving, in PyTorch.

Counterpart of the serving entry of ``fbtt_embedding_tpu.models.
tt_embedding``: ``make_serving_fn`` builds a forward-only pooled lookup
over parameters held in :class:`TTEmbeddingParams`. The trainable modules,
the optimizers and the LFU cache are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from fbtt_embedding_tpu_torch.ops.indexing import (
    rowidx_from_offsets,
    split_wide_keyrows,
)
from fbtt_embedding_tpu_torch.ops.lookup import pooled_tt_lookup


@dataclass
class TTEmbeddingParams:
    """TT cores in module layout ``[T, p_t, r_t*q_t*r_{t+1}]`` (float32),
    optimizer state, and the cache (always None until the cache is
    ported)."""

    tt_cores: Tuple[torch.Tensor, ...]
    optimizer_state: Tuple[torch.Tensor, ...] = ()
    cache: Optional[Any] = None


def params_from_jax(tt_cores_np: Sequence, optimizer_state_np: Sequence = (),
                    device="cuda") -> TTEmbeddingParams:
    """Parameters of the JAX package, as numpy arrays in module layout
    (``np.asarray`` of its ``TTEmbeddingParams`` fields), -> this
    package's :class:`TTEmbeddingParams` on ``device``."""
    def put(a):  # a copy: the params never alias the caller's arrays
        return torch.tensor(np.asarray(a), device=device)

    cores = tuple(put(c).float() for c in tt_cores_np)
    return TTEmbeddingParams(cores, tuple(put(s) for s in optimizer_state_np),
                             None)


def make_serving_fn(
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    num_tables: int,
    batch_size: int,
    probe_cache: bool = True,
    precision: Optional[str] = None,
    impl: str = "auto",
    device="cuda",
):
    """Build the serving lookup ``serve(params, indices, offsets,
    weights=None, *, bs=batch_size) -> [T, B, D]`` (float32, on
    ``device``).

    ``indices`` is ``[nnz]`` row ids, or the wide key rows ``int32
    [nnz, 2 + ndim]`` (``ops.indexing.wide_keyrows``) for tables past
    int32; ``offsets`` has ``T*bs + 1`` table-major entries. Inputs may be
    numpy arrays or tensors; they are moved to ``device``, where the
    params must already be. Forward only: no counting, no backward state.
    ``probe_cache`` with a cache in the params raises NotImplementedError:
    the cache is not ported yet."""
    shapes = (tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(tt_ranks))
    ndim = len(tt_p_shapes)
    device = torch.device(device)

    def serve(params: TTEmbeddingParams, indices, offsets, weights=None, *,
              bs: int = batch_size):
        if probe_cache and params.cache is not None:
            raise NotImplementedError(
                "cache-probing serving is not ported yet; pass "
                "probe_cache=False or params without a cache")
        indices = torch.as_tensor(indices, device=device)
        offsets = torch.as_tensor(offsets, device=device)
        if weights is not None:
            weights = torch.as_tensor(weights, device=device,
                                      dtype=torch.float32)
        parts = None
        if indices.dim() == 2:
            parts, _, nnz = split_wide_keyrows(indices, ndim)
            indices = None
        else:
            nnz = indices.shape[0]
        rowidx, tableidx = rowidx_from_offsets(offsets, nnz, num_tables, bs)
        tbl = tableidx if num_tables > 1 else None
        return pooled_tt_lookup(
            params.tt_cores, *shapes, bs, indices, rowidx, tbl,
            weights=weights, precision=precision, impl=impl,
            idx_parts=parts)

    return serve
