"""TT-core chain contraction in PyTorch: one embedding row per lookup.

Counterpart of ``fbtt_embedding_tpu.ops.contraction`` (forward only): gather
each lookup's core slices and contract the chain with batched matrix
products in float32. This is the whole-lookup plain reference the flat
pipeline and its kernel are held against.

Core storage layout: core ``t`` is ``[num_tables, p_t, r_t * q_t * r_{t+1}]``
with boundary ranks ``r_0 = r_T = 1``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from fbtt_embedding_tpu_torch.ops.indexing import decompose_indices


def validate_tt_shapes(
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
) -> List[int]:
    """Validate shapes; returns the full rank vector ``[1, *tt_ranks, 1]``."""
    ndim = len(tt_p_shapes)
    ranks = list(tt_ranks)
    if len(ranks) == ndim - 1:
        ranks = [1] + ranks + [1]
    if len(ranks) != ndim + 1 or ranks[0] != 1 or ranks[-1] != 1:
        raise ValueError(f"bad tt_ranks {tt_ranks} for tt_ndim {ndim}")
    if len(tt_q_shapes) != ndim:
        raise ValueError(f"tt_q_shapes {tt_q_shapes} must have {ndim} dims")
    if not 2 <= ndim <= 4:
        raise ValueError(f"tt_ndim must be in [2, 4], got {ndim}")
    if min(list(tt_p_shapes) + list(tt_q_shapes) + ranks) <= 0:
        raise ValueError("TT shapes and ranks must be positive")
    return ranks


def _gather_core(core: torch.Tensor, idx_t: torch.Tensor,
                 tableidx: Optional[torch.Tensor]) -> torch.Tensor:
    idx_t = idx_t.long()
    if core.shape[0] == 1 or tableidx is None:
        return core[0][idx_t]
    return core[tableidx.long(), idx_t]


def tt_rows(
    tt_cores: Sequence[torch.Tensor],
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    indices: Optional[torch.Tensor],
    tableidx: Optional[torch.Tensor] = None,
    idx_parts: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Rows ``G_0[i_0] @ G_1[i_1] @ ... @ G_{T-1}[i_{T-1}]``: ``[nnz, D]``
    float32 with ``D = prod(tt_q_shapes)``.

    The running operand ``[nnz, m_t, r_{t+1}]`` grows its row dim
    ``m_t = q_0 * .. * q_t`` by one batched product per core. ``idx_parts``
    (per-core int32 indices) replaces ``indices`` for wide row ids."""
    ranks = validate_tt_shapes(tt_p_shapes, tt_q_shapes, tt_ranks)
    if idx_parts is None:
        idx_parts = decompose_indices(indices, tt_p_shapes)
    nnz = idx_parts[0].shape[0]
    z = _gather_core(tt_cores[0], idx_parts[0], tableidx).float()
    m = tt_q_shapes[0]
    for t in range(1, len(tt_p_shapes)):
        ct = _gather_core(tt_cores[t], idx_parts[t], tableidx).float()
        ct = ct.reshape(nnz, ranks[t], tt_q_shapes[t] * ranks[t + 1])
        z = torch.bmm(z.reshape(nnz, m, ranks[t]), ct)
        m *= tt_q_shapes[t]
        z = z.reshape(nnz, m * ranks[t + 1])
    return z
