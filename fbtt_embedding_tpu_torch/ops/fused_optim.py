"""Fused optimizer updates of the TT cores, in PyTorch.

Counterpart of ``fbtt_embedding_tpu.ops.fused_optim``: ``sgd_step``,
``adagrad_step``, ``tt_sgd_backward`` and ``tt_adagrad_backward`` (the
reference semantics), and the native optimizers (``native_optim_init``,
``native_optim_step``: every ``OptimType`` with its own math). Each is a
full-element update of every core (not only the rows a batch touched).

The JAX functions return new arrays and their caller donates the old
buffers. Here the update is made **in place**, under ``torch.no_grad()``:
the cores (and the Adagrad state) passed in are overwritten and returned.
Copy them first to keep the old values. The native steps add no host
synchronisation: the step counter stays a device tensor, and the LAMB
trust ratio and the LARS local rate are chosen by ``torch.where``.
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


# --------------------------------------------------------------------------
# Native optimizer semantics (``optim_semantics="native"``).
#
# The reference declares nine OptimType names but implements two
# behaviours (SGD and full-element Adagrad). Native mode gives every name
# its own math over the full cores:
#
#   EXACT_ROWWISE_ADAGRAD   s_row += mean(g^2 over the core row);
#                           w -= lr * g / (sqrt(s_row) + eps)
#                           (a row is a core's [T, p_i] slice)
#   ADAM                    bias-corrected full-element Adam
#   PARTIAL_ROWWISE_ADAM    full-element first moment, row-wise second
#   LAMB                    the Adam direction scaled by the per-core trust
#                           ratio ||w||_F / ||direction||_F
#   PARTIAL_ROWWISE_LAMB    LAMB with the row-wise second moment
#   LARS_SGD                momentum SGD with the per-core local rate
#                           eta * ||w||_F / ||g||_F
#
# The state is a flat tuple of tensors, in the JAX package's order; the
# Adam family ends with a 0-d int32 step counter. Names are compared by
# their string values (``OptimType.value``), as the JAX package does.

NATIVE_HPARAM_DEFAULTS = {
    "beta1": 0.9,       # ADAM/LAMB first-moment decay
    "beta2": 0.999,     # ADAM/LAMB second-moment decay
    "momentum": 0.9,    # LARS momentum
    "eta": 0.001,       # LARS trust coefficient
}

_SGD_NAMES = ("sgd", "exact_sgd")
_ADAM_NAMES = ("adam", "partial_row_wise_adam")
_LAMB_NAMES = ("lamb", "partial_row_wise_lamb")
_ROWWISE_V = ("partial_row_wise_adam", "partial_row_wise_lamb")


def _optim_name(optimizer) -> str:
    return optimizer.value if hasattr(optimizer, "value") else str(optimizer)


def _row_mean_sq(g: torch.Tensor) -> torch.Tensor:
    """Mean of g^2 over a core's trailing (rank*q*rank) axis, keepdim."""
    return torch.mean(g * g, dim=-1, keepdim=True)


def native_optim_init(optimizer, tt_cores: Sequence[torch.Tensor]
                      ) -> Tuple[torch.Tensor, ...]:
    """Zero optimizer state for :func:`native_optim_step` (a flat tuple, on
    the cores' device; every entry a buffer of its own).

    Layouts: SGD ``(0,)`` placeholders; ``EXACT_ADAGRAD`` one full buffer
    per core; ``EXACT_ROWWISE_ADAGRAD`` one ``[T, p_i, 1]`` buffer per core;
    ADAM/LAMB ``(m x n, v x n, step)``; PARTIAL_ROWWISE_* ``(m x n, v_row x
    n, step)`` with ``step`` a 0-d int32 counter; LARS_SGD one momentum
    buffer per core."""
    name = _optim_name(optimizer)
    dev = tt_cores[0].device

    def full():
        return tuple(torch.zeros_like(c) for c in tt_cores)

    def row():
        return tuple(torch.zeros(tuple(c.shape[:-1]) + (1,),
                                 dtype=torch.float32, device=dev)
                     for c in tt_cores)

    if name in _SGD_NAMES:
        return tuple(torch.zeros((0,), dtype=torch.float32, device=dev)
                     for _ in tt_cores)
    if name == "exact_adagrad":
        return full()
    if name == "exact_row_wise_adagrad":
        return row()
    step0 = (torch.zeros((), dtype=torch.int32, device=dev),)
    if name in ("adam", "lamb"):
        return full() + full() + step0
    if name in _ROWWISE_V:
        return full() + row() + step0
    if name == "lars_sgd":
        return full()
    raise ValueError(f"unknown OptimType: {optimizer}")


@torch.no_grad()
def rowwise_adagrad_step(tt_cores, optimizer_state, grads, lr, eps):
    """Row-wise Adagrad over core rows, in place: one accumulator per
    ``[T, p_i]``; returns ``(cores, state)``."""
    for c, s, g in zip(tt_cores, optimizer_state, grads):
        s.add_(_row_mean_sq(g))
        c.sub_(lr * g / (s.sqrt() + eps))
    return tuple(tt_cores), tuple(optimizer_state)


def _adam_direction(m, v, g, bias1, bias2, beta1, beta2, eps, rowwise_v):
    """``m`` and ``v`` updated in place; returns the bias-corrected Adam
    direction (``bias1``, ``bias2``: ``1 - beta ** t`` in float32, after
    the step counter's increment)."""
    m.mul_(beta1).add_((1.0 - beta1) * g)
    gsq = _row_mean_sq(g) if rowwise_v else g * g
    v.mul_(beta2).add_((1.0 - beta2) * gsq)
    return (m / bias1) / (torch.sqrt(v / bias2) + eps)


def _trust(num: torch.Tensor, den: torch.Tensor, scale=1.0) -> torch.Tensor:
    """``scale * num / (den + 1e-12)`` where both norms are positive, else
    1: a device tensor (no host synchronisation)."""
    return torch.where((num > 0.0) & (den > 0.0), scale * num / (den + 1e-12),
                       torch.ones_like(num))


@torch.no_grad()
def adam_like_step(tt_cores, optimizer_state, grads, lr, eps, beta1=0.9,
                   beta2=0.999, rowwise_v=False, lamb=False):
    """The ADAM / LAMB / PARTIAL_ROWWISE_* update, in place (the step
    counter too); returns ``(cores, state)``.

    ``rowwise_v``: the second moment per core row instead of per element.
    ``lamb``: each core's Adam direction scaled by the trust ratio
    ``||w||_F / ||direction||_F`` (1 where either norm is 0)."""
    n = len(tt_cores)
    ms, vs, t = (optimizer_state[:n], optimizer_state[n:2 * n],
                 optimizer_state[2 * n])
    t.add_(1)
    tf = t.to(torch.float32)
    bias1, bias2 = 1.0 - beta1 ** tf, 1.0 - beta2 ** tf
    for c, m, v, g in zip(tt_cores, ms, vs, grads):
        u = _adam_direction(m, v, g, bias1, bias2, beta1, beta2, eps,
                            rowwise_v)
        if lamb:
            u = u * _trust(torch.linalg.vector_norm(c),
                           torch.linalg.vector_norm(u))
        c.sub_(lr * u)
    return tuple(tt_cores), tuple(optimizer_state)


@torch.no_grad()
def lars_step(tt_cores, optimizer_state, grads, lr, momentum=0.9,
              eta=0.001):
    """LARS, in place: the per-core local rate ``eta * ||w|| / ||g||``,
    momentum SGD; returns ``(cores, state)``."""
    for c, mom, g in zip(tt_cores, optimizer_state, grads):
        local = _trust(torch.linalg.vector_norm(c),
                       torch.linalg.vector_norm(g), eta)
        mom.mul_(momentum).add_(local * g)
        c.sub_(lr * mom)
    return tuple(tt_cores), tuple(optimizer_state)


def native_optim_step(optimizer, tt_cores, optimizer_state, grads, lr, eps,
                      hparams: Optional[dict] = None):
    """``optimizer``'s own update, in place; returns ``(cores, state)``.
    ``hparams`` overrides keys of ``NATIVE_HPARAM_DEFAULTS``."""
    hp = dict(NATIVE_HPARAM_DEFAULTS)
    if hparams:
        hp.update(hparams)
    name = _optim_name(optimizer)
    if name in _SGD_NAMES:
        return sgd_step(tt_cores, grads, lr), tuple(optimizer_state)
    if name == "exact_adagrad":
        return adagrad_step(tt_cores, optimizer_state, grads, lr, eps)
    if name == "exact_row_wise_adagrad":
        return rowwise_adagrad_step(tt_cores, optimizer_state, grads, lr,
                                    eps)
    if name in _ADAM_NAMES + _LAMB_NAMES:
        return adam_like_step(tt_cores, optimizer_state, grads, lr, eps,
                              beta1=hp["beta1"], beta2=hp["beta2"],
                              rowwise_v=name in _ROWWISE_V,
                              lamb=name in _LAMB_NAMES)
    if name == "lars_sgd":
        return lars_step(tt_cores, optimizer_state, grads, lr,
                         momentum=hp["momentum"], eta=hp["eta"])
    raise ValueError(f"unknown OptimType: {optimizer}")


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
