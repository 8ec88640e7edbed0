"""TT-compressed embedding serving and training, in PyTorch.

Counterpart of the functional entries of ``fbtt_embedding_tpu.models.
tt_embedding``: ``make_serving_fn`` builds a forward-only pooled lookup and
``make_fused_train_step`` the one-call training step (forward, backward
and the fused SGD / Adagrad update) over parameters held in
:class:`TTEmbeddingParams`. Both take the flat sorted-run pipeline by
default and the generic per-lookup kernels (B4 forward, B5 backward) with
``impl="pallas"``. The modules, the native optimizers and the LFU cache
are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum, unique
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from fbtt_embedding_tpu_torch.ops.contraction import validate_tt_shapes
from fbtt_embedding_tpu_torch.ops.fused_optim import adagrad_step, sgd_step
from fbtt_embedding_tpu_torch.ops.indexing import (
    rowidx_from_offsets,
    split_wide_keyrows,
)
from fbtt_embedding_tpu_torch.ops.kernels.tt_flat import (
    flat_available,
    flat_train_apply,
)
from fbtt_embedding_tpu_torch.ops.lookup import (
    pooled_tt_lookup,
    staging_dtype,
)


@unique
class OptimType(Enum):
    """Optimizer names (reference ``tt_embeddings_ops.py:18-33``).

    As in the reference, only two behaviours exist: SGD/EXACT_SGD run the
    fused SGD update, everything else the fused full-element Adagrad. All
    updates are deterministic, so SGD == EXACT_SGD."""

    SGD = "sgd"
    EXACT_SGD = "exact_sgd"
    LAMB = "lamb"
    ADAM = "adam"
    EXACT_ADAGRAD = "exact_adagrad"
    EXACT_ROWWISE_ADAGRAD = "exact_row_wise_adagrad"
    LARS_SGD = "lars_sgd"
    PARTIAL_ROWWISE_ADAM = "partial_row_wise_adam"
    PARTIAL_ROWWISE_LAMB = "partial_row_wise_lamb"

    def __str__(self) -> str:
        return self.value


_SGD_OPTIMS = (OptimType.SGD, OptimType.EXACT_SGD)
# above this many lookups the step differentiates the two-pass lookup
# instead of running flat_train_apply (the JAX package's crossover)
_FUSED_APPLY_NNZ_MAX = 32768


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
    ``impl`` as in ``pooled_tt_lookup``: "auto" takes the flat pipeline,
    "pallas" the generic kernel B4.
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


def _lookup_inputs(indices, ndim: int, device):
    """``(indices or None, idx_parts or None, nnz)`` from flat row ids, a
    tuple of per-core parts, or wide key rows ``int32 [nnz, 2 + ndim]``."""
    if isinstance(indices, (tuple, list)):
        parts = tuple(torch.as_tensor(p_, device=device).to(torch.int32)
                      for p_ in indices)
        return None, parts, parts[0].shape[0]
    indices = torch.as_tensor(indices, device=device)
    if indices.dim() == 2:
        parts, _, nnz = split_wide_keyrows(indices, ndim)
        return None, parts, nnz
    return indices, None, indices.shape[0]


def make_fused_train_step(
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    num_tables: int,
    batch_size: int,
    optimizer: OptimType = OptimType.SGD,
    use_cache: bool = False,
    probe_cache: bool = False,
    precision: Optional[str] = None,
    impl: str = "auto",
    count_interval: int = 1,
    optim_semantics: str = "reference",
    optim_hparams: Optional[dict] = None,
    device="cuda",
):
    """Build the training step ``step(params, indices, offsets, d_output,
    lr_eps, weights=None, *, bs=batch_size, count=True) -> (output,
    new_params)``: the pooled forward ``[T, bs, D]`` (float32), its
    backward for the given ``d_output`` and the fused SGD (``OptimType.SGD``,
    ``EXACT_SGD``) or full-element Adagrad (every other name) update.

    ``indices`` is ``[nnz]`` row ids, a tuple of per-core index parts, or
    wide key rows ``int32 [nnz, 2 + ndim]``; ``offsets`` has ``T*bs + 1``
    table-major entries; ``lr_eps`` is ``(learning_rate, eps)``;
    ``weights`` scales each lookup in the forward and in the cotangents.
    Inputs may be numpy arrays or tensors and go to ``device``, where the
    params must be.

    At nnz <= 32768 on a config the flat pipeline takes unpadded, the step
    runs ``flat_train_apply`` (kernels B1, B2, B3 on the card, their plain
    versions on the CPU); otherwise autograd through ``pooled_tt_lookup``:
    the flat ``FlatLookup``, with ``impl="pallas"`` the generic
    ``GenericLookup`` (kernel B4 forward, B5 backward, float32; it raises
    on a config those kernels cannot take), or, with ``impl="xla"`` or a
    config the flat path cannot take, the plain ``tt_rows`` chain.
    ``precision="highest"`` stages the flat path in float32 on the card
    (bfloat16 by default).

    The update is made **in place**: ``params.tt_cores`` and
    ``params.optimizer_state`` (Adagrad: one zero-initialised tensor per
    core) are overwritten and returned in ``new_params``, as the JAX step
    donates them. Copy the params first to keep them.

    Not ported yet, and raising NotImplementedError: the LFU cache
    (``use_cache``, ``probe_cache``, params with a cache) and
    ``optim_semantics="native"``. ``count`` and ``count_interval`` only
    matter with the cache and are accepted for the same signature."""
    if optim_semantics not in ("reference", "native"):
        raise ValueError(f"unknown optim_semantics {optim_semantics!r}")
    if use_cache or probe_cache:
        raise NotImplementedError(
            "the LFU cache is not ported yet; pass use_cache=False and "
            "probe_cache=False")
    if optim_semantics == "native":
        raise NotImplementedError(
            "optim_semantics='native' is not ported yet")
    del count_interval, optim_hparams
    ranks = validate_tt_shapes(tt_p_shapes, tt_q_shapes, tt_ranks)
    shapes = (tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(ranks))
    ndim = len(tt_p_shapes)
    is_sgd = optimizer in _SGD_OPTIMS
    device = torch.device(device)

    def step(params: TTEmbeddingParams, indices, offsets, d_output, lr_eps,
             weights=None, *, bs: int = batch_size, count: bool = True):
        del count
        if params.cache is not None:
            raise NotImplementedError(
                "params with a cache: the LFU cache is not ported yet")
        lr, eps = (v if isinstance(v, torch.Tensor) else float(v)
                   for v in lr_eps)
        indices, parts, nnz = _lookup_inputs(indices, ndim, device)
        offsets = torch.as_tensor(offsets, device=device)
        d_output = torch.as_tensor(d_output, device=device,
                                   dtype=torch.float32)
        if weights is not None:
            weights = torch.as_tensor(weights, device=device,
                                      dtype=torch.float32)
        rowidx, tableidx = rowidx_from_offsets(offsets, nnz, num_tables, bs)
        tbl = tableidx if num_tables > 1 else None
        cores = params.tt_cores
        if (impl in ("auto", "pallas_sorted")
                and nnz <= _FUSED_APPLY_NNZ_MAX
                and flat_available(*shapes, num_tables, bs)):
            with torch.no_grad():  # the gradients come out explicitly
                output, grads = flat_train_apply(
                    cores, *shapes, bs, indices, rowidx, tbl, weights, None,
                    d_output, compute_dtype=staging_dtype(device, precision),
                    idx_parts=parts)
        else:
            leaves = [c.detach().requires_grad_() for c in cores]
            with torch.enable_grad():
                out = pooled_tt_lookup(
                    leaves, *shapes, bs, indices, rowidx, tbl,
                    weights=weights, precision=precision, impl=impl,
                    idx_parts=parts)
                grads = torch.autograd.grad(out, leaves, d_output)
            output = out.detach()
        if is_sgd:
            new_cores = sgd_step(cores, grads, lr)
            new_opt = params.optimizer_state
        else:
            new_cores, new_opt = adagrad_step(
                cores, params.optimizer_state, grads, lr, eps)
        return output, TTEmbeddingParams(new_cores, new_opt, None)

    return step
