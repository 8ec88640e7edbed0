"""Deterministic row scatter-add with out-of-range targets dropped, and a
deterministic segment sum.

Counterpart of the contract of ``fbtt_embedding_tpu/ops/hot_scatter.py ::
hot_scatter_add``: ``table.at[loc].add(upd, mode="drop")``. The TPU's LFU
window and straggler chunks are scatter tuning for XLA on the TPU and are
not carried over. :func:`segment_sum` is the pools' ``segment_sum``.
"""

from __future__ import annotations

import torch


def hot_scatter_add(table: torch.Tensor, loc: torch.Tensor,
                    upd: torch.Tensor) -> torch.Tensor:
    """``table[loc[i]] += upd[i]`` for every ``i`` with ``0 <= loc[i] <
    len(table)``, **in place**; returns ``table``.

    ``index_put_(..., accumulate=True)``: on the card it sorts the targets
    and adds each target's updates in one fixed order, so float results do
    not change from run to run (``index_add_`` uses float atomics there and
    would). Selecting the kept rows reads their count back to the host:
    one synchronisation per call."""
    keep = ((loc >= 0) & (loc < table.shape[0])).nonzero().squeeze(1)
    table.index_put_((loc[keep].long(),), upd[keep].to(table.dtype),
                     accumulate=True)
    return table


def segment_sum(rows: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = sum(rows[i] for seg[i] == s)``, ``[num_segments, ...]``
    in ``rows``' dtype; rows whose ``seg`` lies outside ``[0,
    num_segments)`` are dropped (added into a spare row past the end). The
    same bits on every call, with no host synchronisation:

    * on the card, ``index_put_(accumulate=True)``, which sorts the targets
      and adds each one's rows in that order (``index_add_`` adds floats
      with atomics there, in no fixed order);
    * on the CPU, where ``index_put_`` adds with atomics across threads,
      a stable sort by segment and ``torch.segment_reduce``, each
      segment's rows added in order.

    Differentiable with respect to ``rows``."""
    seg = seg.long()
    seg = torch.where((seg >= 0) & (seg < num_segments), seg,
                      torch.full_like(seg, num_segments))
    if rows.is_cuda:
        out = rows.new_zeros((num_segments + 1,) + tuple(rows.shape[1:]))
        return out.index_put_((seg,), rows, accumulate=True)[:num_segments]
    seg_sorted, order = torch.sort(seg, stable=True)
    bounds = torch.searchsorted(seg_sorted, torch.arange(
        num_segments + 1, dtype=seg.dtype, device=seg.device))
    return torch.segment_reduce(rows[order], "sum", offsets=bounds, axis=0,
                                unsafe=True)
