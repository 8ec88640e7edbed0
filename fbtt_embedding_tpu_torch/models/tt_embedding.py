"""TT-compressed embedding serving and training, in PyTorch.

Counterpart of the functional entries of ``fbtt_embedding_tpu.models.
tt_embedding``: ``make_serving_fn`` builds a forward-only pooled lookup and
``make_fused_train_step`` the one-call training step (forward, backward
and the fused SGD / Adagrad update) over parameters held in
:class:`TTEmbeddingParams`. Both take the flat sorted-run pipeline by
default and the generic per-lookup kernels (B4 forward, B5 backward) with
``impl="pallas"``. With a :class:`~fbtt_embedding_tpu_torch.ops.cache.
CacheState` in the params, the step counts row frequencies (``use_cache``)
and both entries probe the LFU cache (``probe_cache``): cache hits are
served from the decompressed rows and reach the TT kernels only as dead
lookups. The modules, the native optimizers and the wide-key (int64) cache
are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum, unique
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from fbtt_embedding_tpu_torch.ops import cache as cache_ops
from fbtt_embedding_tpu_torch.ops.cache import CacheState
from fbtt_embedding_tpu_torch.ops.contraction import validate_tt_shapes
from fbtt_embedding_tpu_torch.ops.fused_optim import adagrad_step, sgd_step
from fbtt_embedding_tpu_torch.ops.indexing import (
    rowidx_from_offsets,
    split_wide_keyrows,
)
from fbtt_embedding_tpu_torch.ops.kernels.tt_flat import (
    _POOL_ONEHOT_MAX_TB,
    flat_available,
    flat_train_apply,
)
from fbtt_embedding_tpu_torch.ops.lookup import (
    flat_servable,
    pool_rows,
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


_CACHE_FIELDS = ("keys", "freq", "slots", "weight", "opt_state")


@dataclass
class TTEmbeddingParams:
    """TT cores in module layout ``[T, p_t, r_t*q_t*r_{t+1}]`` (float32),
    optimizer state, and the LFU cache (a ``CacheState``, or None)."""

    tt_cores: Tuple[torch.Tensor, ...]
    optimizer_state: Tuple[torch.Tensor, ...] = ()
    cache: Optional[CacheState] = None


def params_from_jax(tt_cores_np: Sequence, optimizer_state_np: Sequence = (),
                    device="cuda", cache: Any = None) -> TTEmbeddingParams:
    """Parameters of the JAX package, as numpy arrays in module layout
    (``np.asarray`` of its ``TTEmbeddingParams`` fields), -> this
    package's :class:`TTEmbeddingParams` on ``device``. ``cache``: the JAX
    ``CacheState``, or any object or mapping with its five fields
    (``keys``, ``freq``, ``slots``, ``weight``, ``opt_state``) as arrays;
    the wide-key layout raises NotImplementedError."""
    def put(a):  # a copy: the params never alias the caller's arrays
        return torch.tensor(np.asarray(a), device=device)

    cores = tuple(put(c).float() for c in tt_cores_np)
    cstate = None
    if cache is not None:
        get = cache.__getitem__ if isinstance(cache, dict) else \
            lambda f: getattr(cache, f)
        cstate = CacheState(*(put(get(f)) for f in _CACHE_FIELDS))
        if cstate.wide:
            raise NotImplementedError(
                "the wide-key (int64 row id) cache is not ported yet")
    return TTEmbeddingParams(cores, tuple(put(s) for s in optimizer_state_np),
                             cstate)


def _no_wide_cache(cache, wide: bool):
    if cache is not None and wide:
        raise NotImplementedError(
            "the wide-key (int64 row id) cache is not ported yet: a cache "
            "takes flat row ids")


def _pool_cached_rows(cached_rows, rowidx, tableidx, num_tables, bs):
    """Pool per-lookup cached rows into ``[T, B, D]``: a float32 one-hot
    product up to ``_POOL_ONEHOT_MAX_TB`` pooled rows, as the flat
    pipeline pools, ``pool_rows`` above."""
    tb = num_tables * bs
    if tb <= _POOL_ONEHOT_MAX_TB:
        seg = rowidx if tableidx is None else tableidx * bs + rowidx
        iota = torch.arange(tb, dtype=seg.dtype, device=seg.device)
        oh = (seg[None, :] == iota[:, None]).to(cached_rows.dtype)
        return torch.matmul(oh, cached_rows).reshape(num_tables, bs, -1)
    return pool_rows(cached_rows, rowidx, tableidx, num_tables, bs)


def _masked_weights(mask, weights):
    """Per-lookup float32 weights: ``weights`` (1 when None) where
    ``mask``, 0 elsewhere."""
    w = mask.to(torch.float32)
    return w if weights is None else w * weights


def _cached_pool(out, cache, locations, weights, rowidx, tbl, num_tables,
                 bs):
    """``out`` plus the cache-served lookups' rows, pooled."""
    if locations is None:
        return out
    cached_w = _masked_weights(locations >= 0, weights)
    rows = cache.weight[locations.clamp(min=0).long()] * cached_w[:, None]
    return out + _pool_cached_rows(rows, rowidx, tbl, num_tables, bs)


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

    ``probe_cache`` with a cache in the params: lookups the cache holds are
    served from its rows; on the flat pipeline they are dead lookups the
    kernels skip, on the other paths they get weight 0. A cache with wide
    (int64) key rows is not ported and raises NotImplementedError."""
    shapes = (tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(tt_ranks))
    ndim = len(tt_p_shapes)
    device = torch.device(device)

    def serve(params: TTEmbeddingParams, indices, offsets, weights=None, *,
              bs: int = batch_size):
        cache = params.cache if probe_cache else None
        indices = torch.as_tensor(indices, device=device)
        _no_wide_cache(cache, indices.dim() == 2)
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
        locations = (cache_ops.cache_lookup(cache, indices)
                     if cache is not None else None)
        dead, w_p = None, weights
        if locations is not None:
            if impl in ("auto", "pallas_sorted") and flat_servable(
                    *shapes, num_tables, bs):
                dead = locations >= 0
            else:
                w_p = _masked_weights(locations < 0, weights)
        out = pooled_tt_lookup(
            params.tt_cores, *shapes, bs, indices, rowidx, tbl,
            weights=w_p, precision=precision, impl=impl, dead_mask=dead,
            idx_parts=parts)
        return _cached_pool(out, cache, locations, weights, rowidx, tbl,
                            num_tables, bs)

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

    The LFU cache (``params.cache``, single table, flat row ids): with
    ``use_cache`` each step with ``count`` (the default) adds
    ``count_interval`` to every looked-up row's count (call with ``count=
    (step % count_interval == 0)`` for sampled counting); with
    ``probe_cache`` the lookups the cache holds are served from its rows
    and updated there, by the optimizer's family (SGD; ``EXACT_ADAGRAD``
    with full ``[C, D]`` state; every other name row-wise Adagrad with
    ``[C]`` state), while the TT path skips them: dead lookups on the flat
    pipeline, packed after ``live_count`` with ``impl="pallas"``, weight 0
    with ``impl="xla"``. A tuple of index parts with ``use_cache`` or
    ``probe_cache`` raises ValueError; the wide-key (int64) cache is not
    ported and raises NotImplementedError.

    The update is made **in place**: ``params.tt_cores``,
    ``params.optimizer_state`` (Adagrad: one zero-initialised tensor per
    core) and the cache's tensors are overwritten and returned in
    ``new_params``, as the JAX step donates them. Copy the params first to
    keep them.

    Not ported yet, and raising NotImplementedError:
    ``optim_semantics="native"``."""
    if optim_semantics not in ("reference", "native"):
        raise ValueError(f"unknown optim_semantics {optim_semantics!r}")
    if optim_semantics == "native":
        raise NotImplementedError(
            "optim_semantics='native' is not ported yet")
    del optim_hparams
    ranks = validate_tt_shapes(tt_p_shapes, tt_q_shapes, tt_ranks)
    shapes = (tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(ranks))
    ndim = len(tt_p_shapes)
    is_sgd = optimizer in _SGD_OPTIMS
    exact_cache = optimizer == OptimType.EXACT_ADAGRAD
    device = torch.device(device)

    def step(params: TTEmbeddingParams, indices, offsets, d_output, lr_eps,
             weights=None, *, bs: int = batch_size, count: bool = True):
        if isinstance(indices, (tuple, list)) and (use_cache or probe_cache):
            raise ValueError(
                "cached training takes flat row ids as `indices`, not a "
                "tuple of index parts")
        cache = params.cache
        lr, eps = (v if isinstance(v, torch.Tensor) else float(v)
                   for v in lr_eps)
        indices, parts, nnz = _lookup_inputs(indices, ndim, device)
        if use_cache or probe_cache:
            _no_wide_cache(cache, parts is not None)
        offsets = torch.as_tensor(offsets, device=device)
        d_output = torch.as_tensor(d_output, device=device,
                                   dtype=torch.float32)
        if weights is not None:
            weights = torch.as_tensor(weights, device=device,
                                      dtype=torch.float32)
        rowidx, tableidx = rowidx_from_offsets(offsets, nnz, num_tables, bs)
        tbl = tableidx if num_tables > 1 else None
        if use_cache and cache is not None and count:
            cache_ops.update_cache_state(cache, indices,
                                         scale=count_interval)
        locations = (cache_ops.cache_lookup(cache, indices)
                     if probe_cache and cache is not None else None)
        # the TT path skips cache-served lookups: the flat pipeline sorts
        # them into its dead span, the generic kernels skip the blocks past
        # live_count (live lookups packed first), the plain path weighs
        # them 0
        use_flat = (impl in ("auto", "pallas_sorted")
                    and flat_servable(*shapes, num_tables, bs))
        dead = live = None
        indices_p, rowidx_p, tbl_p, w_p = indices, rowidx, tbl, weights
        if locations is not None and use_flat:
            dead = locations >= 0
        elif locations is not None and impl == "pallas" and parts is None:
            indices_p, rowidx_p, tbl_p, w_p, live = _live_first(
                locations, indices, rowidx, tbl, weights)
        elif locations is not None:
            w_p = _masked_weights(locations < 0, weights)
        cores = params.tt_cores
        if (impl in ("auto", "pallas_sorted")
                and nnz <= _FUSED_APPLY_NNZ_MAX
                and flat_available(*shapes, num_tables, bs)):
            with torch.no_grad():  # the gradients come out explicitly
                output, grads = flat_train_apply(
                    cores, *shapes, bs, indices_p, rowidx_p, tbl_p, w_p,
                    dead, d_output,
                    compute_dtype=staging_dtype(device, precision),
                    idx_parts=parts)
        else:
            leaves = [c.detach().requires_grad_() for c in cores]
            with torch.enable_grad():
                out = pooled_tt_lookup(
                    leaves, *shapes, bs, indices_p, rowidx_p, tbl_p,
                    weights=w_p, precision=precision, impl=impl,
                    live_count=live, dead_mask=dead, idx_parts=parts)
                grads = torch.autograd.grad(out, leaves, d_output)
            output = out.detach()
        output = _cached_pool(output, cache, locations, weights, rowidx, tbl,
                              num_tables, bs)
        if is_sgd:
            new_cores = sgd_step(cores, grads, lr)
            new_opt = params.optimizer_state
        else:
            new_cores, new_opt = adagrad_step(
                cores, params.optimizer_state, grads, lr, eps)
        if locations is not None:  # cache rows: the reference's families
            if is_sgd:
                cache_ops.cache_backward_sgd(cache, d_output, locations,
                                             rowidx, lr, weights=weights)
            elif exact_cache:
                cache_ops.cache_backward_adagrad(
                    cache, d_output, locations, rowidx, lr, eps,
                    weights=weights)
            else:
                cache_ops.cache_backward_rowwise_adagrad_approx(
                    cache, d_output, locations, rowidx, lr, eps,
                    weights=weights)
        return output, TTEmbeddingParams(new_cores, new_opt, cache)

    return step


def _live_first(locations, indices, rowidx, tbl, weights):
    """Lookups repacked live (not cache-served) first, for the generic
    kernels' ``live_count``: ``(indices, rowidx, tableidx, weights,
    live_count [1])``, the cache-served lookups after the live ones with
    weight 0."""
    cached = locations >= 0
    alive = ~cached
    live_count = alive.to(torch.int32).sum()
    tt_pos = torch.cumsum(alive.to(torch.int32), 0) - 1
    c_pos = live_count + torch.cumsum(cached.to(torch.int32), 0) - 1
    pos = torch.where(alive, tt_pos, c_pos).long()

    def packed(a):
        if a is None:
            return None
        out = torch.empty_like(a)
        out[pos] = a
        return out

    return (packed(indices), packed(rowidx), packed(tbl),
            packed(_masked_weights(alive, weights)), live_count.reshape(1))
