"""TT-core chain contraction in PyTorch: one embedding row per lookup.

Counterpart of ``fbtt_embedding_tpu.ops.contraction`` (forward only): gather
each lookup's core slices and contract the chain with batched matrix
products in float32. This is the whole-lookup plain reference the flat
pipeline and its kernel are held against. Also ``tt_matrix_to_full``, the
whole table as one dense matrix (a chain of large matrix products outside
any kernel, as in the JAX package).

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


def tt_matrix_to_full(
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    tt_cores: Sequence[torch.Tensor],
    table: int = 0,
) -> torch.Tensor:
    """The full ``[prod(p), prod(q)]`` matrix of table ``table``'s cores
    (module layout ``[T, p_t, r_t * q_t * r_{t+1}]``), float32 on the cores'
    device: the reference's ``tt_matrix_to_full``, a chain of matrix
    products over the ranks, then the even/odd (p, q) interleave permuted
    to ``[p_0, p_1, .., q_0, q_1, ..]``. Differentiable by torch autograd;
    call it under ``torch.no_grad()`` where no gradient is wanted (the
    headline table is 2.8 GB)."""
    ranks = validate_tt_shapes(tt_p_shapes, tt_q_shapes, tt_ranks)
    ndim = len(tt_p_shapes)
    # core t in [p, r, q, r'] storage -> canonical [r, p, q, r']
    cores = [tt_cores[t][table].reshape(
        tt_p_shapes[t], ranks[t], tt_q_shapes[t], ranks[t + 1]
    ).permute(1, 0, 2, 3).float() for t in range(ndim)]
    res = cores[0]
    for t in range(1, ndim):
        res = torch.matmul(res.reshape(-1, ranks[t]),
                           cores[t].reshape(ranks[t], -1))
    # res is [p0, q0, p1, q1, ...]; permute to [p0, p1, .., q0, q1, ..]
    interleaved = []
    for t in range(ndim):
        interleaved += [int(tt_p_shapes[t]), int(tt_q_shapes[t])]
    perm = list(range(0, 2 * ndim, 2)) + list(range(1, 2 * ndim, 2))
    res = res.reshape(interleaved).permute(perm)
    n = d = 1
    for t in range(ndim):
        n *= int(tt_p_shapes[t])
        d *= int(tt_q_shapes[t])
    return res.reshape(n, d)
