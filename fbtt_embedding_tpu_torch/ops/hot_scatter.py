"""Deterministic row scatter-add with out-of-range targets dropped.

Counterpart of the contract of ``fbtt_embedding_tpu/ops/hot_scatter.py ::
hot_scatter_add``: ``table.at[loc].add(upd, mode="drop")``. The TPU's LFU
window and straggler chunks are scatter tuning for XLA on the TPU and are
not carried over.
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
