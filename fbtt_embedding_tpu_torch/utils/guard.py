"""Failure detection: fail fast, name the failure, keep the step asynchronous.

Counterpart of ``fbtt_embedding_tpu.utils.guard``. Non-finite values poison
the whole state quickly (the fused optimizers update whole cores), so:

* :func:`finite_flag` gives one 0-d bool tensor on the device: every
  floating leaf of a state tree is finite. Reading it is the only host
  synchronisation.
* :func:`assert_finite` / :func:`guard_step` are the host-side checks,
  naming the first non-finite leaf by its path as the JAX package does
  (``params.tt_cores[1]``); the wrapper reads the flag every ``every``
  calls, so the steps between run without a synchronisation.

On a mesh, :func:`assert_replicas_agree` catches the silent multi-GPU
failure: replicas of a replicated value drifting apart (a desynchronised
data pipeline, a missed all-reduce).
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from fbtt_embedding_tpu_torch.utils._tree import leaves_with_paths


class ReplicaDivergenceError(RuntimeError):
    """Replicated values disagree across a mesh axis."""


class NonFiniteError(RuntimeError):
    """A guarded state holds NaN/Inf; ``leaf_path`` names where."""

    def __init__(self, leaf_path: str, stats: str):
        self.leaf_path = leaf_path
        super().__init__(
            f"non-finite values at pytree leaf '{leaf_path}' ({stats})")


def _floating(tree):
    """(path, tensor) of every floating leaf; integer and bool leaves (index
    tables, LFU counts, step counters) are skipped."""
    out = []
    for path, leaf in leaves_with_paths(tree):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
        if t.is_floating_point():
            out.append((path, t))
    return out


def finite_flag(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every floating leaf of ``tree`` is finite. Computed
    on the device of the first floating leaf, with no host
    synchronisation."""
    leaves = [t for _, t in _floating(tree)]
    if not leaves:
        return torch.tensor(True)
    dev = leaves[0].device
    return torch.stack([torch.isfinite(t).all().to(dev)
                        for t in leaves]).all()


def assert_finite(tree: Any, what: str = "params") -> None:
    """Raise :class:`NonFiniteError` naming the first non-finite leaf by its
    path (``what + path``). Reads each leaf's flag on the host: use it in
    tests, or through :func:`guard_step` with a sampling period."""
    for path, t in _floating(tree):
        if not bool(torch.isfinite(t).all()):
            n_nan = int(torch.isnan(t).sum())
            n_inf = int(torch.isinf(t).sum())
            raise NonFiniteError(what + path,
                                 f"{n_nan} NaN, {n_inf} Inf of {t.numel()}")


def guard_step(step_fn: Callable, every: int = 1) -> Callable:
    """Wrap a train step ``(params, *args) -> (out, new_params)`` so that
    the new parameters are checked for non-finite values every ``every``
    calls: one device bool read then (:func:`finite_flag`), none between.
    On a failure the tree is walked again to name the leaf."""
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    count = {"n": 0}

    @functools.wraps(step_fn)
    def guarded(params, *args, **kwargs):
        out, new_params = step_fn(params, *args, **kwargs)
        count["n"] += 1
        if count["n"] % every == 0 and not bool(finite_flag(new_params)):
            assert_finite(new_params)  # raises with the leaf named
            raise NonFiniteError("<unlocated>", "flag tripped")
        return out, new_params

    return guarded


def assert_replicas_agree(mesh, axis: str, value, atol: float = 0.0,
                          what: str = "value") -> None:
    """Check that ``value``, replicated over mesh axis ``axis``, is the same
    on every rank of the axis: an all-gather of the ranks' values (float64)
    over the axis's group, then, on every rank, the largest ``|value_i -
    mean|`` (the JAX package's drift); above ``atol`` raises
    :class:`ReplicaDivergenceError` on every rank, naming the rank that
    drifts most. Synchronises with the host."""
    from fbtt_embedding_tpu_torch.parallel.collectives import all_gather_cat
    from fbtt_embedding_tpu_torch.parallel.mesh import axis_group

    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(value)
    if t.device.type != mesh.device_type:  # NCCL takes card tensors only
        t = t.to(mesh.device_type)
    every = all_gather_cat(t.detach().reshape(1, -1).to(torch.float64),
                           axis_group(mesh, axis))
    per_rank = (every - every.mean(dim=0)).abs().amax(dim=1) \
        if every.shape[1] else torch.zeros(every.shape[0])
    drift = float(per_rank.max())
    if drift > atol:
        raise ReplicaDivergenceError(
            f"'{what}' diverges across mesh axis '{axis}': max drift "
            f"{drift:.3e} > atol {atol:.3e} (most at rank "
            f"{int(per_rank.argmax())} of the axis)")
