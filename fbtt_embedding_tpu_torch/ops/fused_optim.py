"""Fused optimizer updates of the TT cores, in PyTorch.

Counterpart of ``sgd_step`` and ``adagrad_step`` of
``fbtt_embedding_tpu.ops.fused_optim``: the reference semantics, a
full-element update of every core (not only the rows a batch touched).

The JAX functions return new arrays and their caller donates the old
buffers. Here the update is made **in place**, under ``torch.no_grad()``:
the cores (and the Adagrad state) passed in are overwritten and returned.
Copy them first to keep the old values.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


@torch.no_grad()
def sgd_step(tt_cores: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             learning_rate) -> Tuple[torch.Tensor, ...]:
    """``w <- w - lr * g`` over the full cores, in place; returns the
    cores."""
    for c, g in zip(tt_cores, grads):
        c.sub_(learning_rate * g)
    return tuple(tt_cores)


@torch.no_grad()
def adagrad_step(tt_cores: Sequence[torch.Tensor],
                 optimizer_state: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], learning_rate, eps
                 ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Full-element Adagrad, in place: ``s += g^2; w -= lr * g / (sqrt(s)
    + eps)`` (per-element state, not row-wise); returns ``(cores,
    state)``."""
    for c, s, g in zip(tt_cores, optimizer_state, grads):
        s.add_(g * g)
        c.sub_(learning_rate * g / (s.sqrt() + eps))
    return tuple(tt_cores), tuple(optimizer_state)
