"""Fused optimizer updates of the TT cores, in PyTorch.

Counterpart of ``sgd_step``, ``adagrad_step``, ``tt_sgd_backward`` and
``tt_adagrad_backward`` of ``fbtt_embedding_tpu.ops.fused_optim``: the
reference semantics, a full-element update of every core (not only the
rows a batch touched).

The JAX functions return new arrays and their caller donates the old
buffers. Here the update is made **in place**, under ``torch.no_grad()``:
the cores (and the Adagrad state) passed in are overwritten and returned.
Copy them first to keep the old values.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from fbtt_embedding_tpu_torch.ops.lookup import tt_dense_backward


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


def tt_sgd_backward(tt_cores: Sequence[torch.Tensor], tt_p_shapes,
                    tt_q_shapes, tt_ranks, batch_size: int,
                    indices: torch.Tensor, rowidx: torch.Tensor,
                    tableidx: Optional[torch.Tensor], d_output: torch.Tensor,
                    learning_rate) -> Tuple[torch.Tensor, ...]:
    """Backward + SGD (the reference binding ``tt_sgd_backward``): the
    dense gradients of :func:`~fbtt_embedding_tpu_torch.ops.lookup.
    tt_dense_backward`, then :func:`sgd_step`, in place; returns the
    cores. Deterministic, so this is the reference's ``EXACT_SGD``."""
    grads = tt_dense_backward(tt_cores, tt_p_shapes, tt_q_shapes, tt_ranks,
                              batch_size, indices, rowidx, tableidx,
                              d_output)
    return sgd_step(tt_cores, grads, learning_rate)


def tt_adagrad_backward(tt_cores: Sequence[torch.Tensor],
                        optimizer_state: Sequence[torch.Tensor], tt_p_shapes,
                        tt_q_shapes, tt_ranks, batch_size: int,
                        indices: torch.Tensor, rowidx: torch.Tensor,
                        tableidx: Optional[torch.Tensor],
                        d_output: torch.Tensor, learning_rate, eps
                        ) -> Tuple[Tuple[torch.Tensor, ...],
                                   Tuple[torch.Tensor, ...]]:
    """Backward + full-element Adagrad (the reference binding
    ``tt_adagrad_backward``), in place; returns ``(cores, state)``."""
    grads = tt_dense_backward(tt_cores, tt_p_shapes, tt_q_shapes, tt_ranks,
                              batch_size, indices, rowidx, tableidx,
                              d_output)
    return adagrad_step(tt_cores, optimizer_state, grads, learning_rate, eps)
