"""Failure detection: fail fast, name the failure, keep the step asynchronous.

Counterpart of ``fbtt_embedding_tpu.utils.guard`` on one device. Non-finite
values poison the whole state quickly (the fused optimizers update whole
cores), so:

* :func:`finite_flag` gives one 0-d bool tensor on the device: every
  floating leaf of a state tree is finite. Reading it is the only host
  synchronisation.
* :func:`assert_finite` / :func:`guard_step` are the host-side checks,
  naming the first non-finite leaf by its path as the JAX package does
  (``params.tt_cores[1]``); the wrapper reads the flag every ``every``
  calls, so the steps between run without a synchronisation.

The cross-replica drift check (``assert_replicas_agree``) belongs with the
multi-GPU port and is not here.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from fbtt_embedding_tpu_torch.utils._tree import leaves_with_paths


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
