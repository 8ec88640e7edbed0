"""Sharded TT-embedding lookups, the multi-GPU fused training steps and the
data-parallel serve.

Counterpart of ``fbtt_embedding_tpu.parallel.sharded`` on
``torch.distributed``. One process per device; each entry takes and
returns this rank's block of the batch (``parallel.multihost``), and every
collective goes through ``parallel.collectives`` on the mesh axis's process
group. The lookups inside are the single-device ones, so the local work
runs the ported kernels (B1-B3, B6 under ``FBTT_DG0=fused``, B4/B5 under
``impl="pallas"``).

* **Data parallel** (:func:`make_dp_lookup`,
  :func:`make_sharded_fused_train_step`, :func:`make_dp_serving_fn`,
  :func:`make_dp_cached_lookup`): bags sharded over the batch axis, TT
  cores (and the LFU cache) replicated (they are small: the point of TT
  compression). The core gradients are summed over the axis in one
  all-reduce and every rank runs the same update; the serve needs no
  collective at all.
* **Table sharded** (:func:`make_table_sharded_lookup`,
  :func:`make_table_sharded_fused_train_step`): each rank of the ``mp``
  axis owns ``T / mp`` tables' cores (contiguous blocks) and, in the step,
  their optimizer state, and pools them over its ``dp`` block of the
  batch; an all_to_all over ``mp`` redistributes so every rank ends with
  all ``T`` tables for ``1 / (dp * mp)`` of the batch, the layout the
  data-parallel dense tower takes. The exchange's gradient is the reverse
  all_to_all; the cores' gradients are then summed over ``dp``, where the
  cores are replicated.
* **Row-owned cache** (:func:`shard_cache_weight_by_owner`,
  :func:`make_row_owned_cached_lookup`, :func:`make_row_owned_populate`,
  :func:`make_row_owned_fused_train_step`): the counting tables
  replicated, the decompressed rows owned: cache slot ``s`` lives on rank
  ``s % dp`` at local row ``s // dp``. Hits travel by a two-hop
  all_to_all (requests out, rows back) and, in the step, their
  cotangents go back to the owners by a third.

Fixed pooling: indices are ``[T, B, L]``; ragged CSR bags are padded on the
host with index -1 and weight 0 (:func:`csr_step_adapter`,
``ops.indexing.pad_csr_to_fixed``).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from fbtt_embedding_tpu_torch.models.tt_embedding import (
    FoldedServingParams,
    OptimType,
    TTEmbeddingParams,
    _cached_pool,
    _count_and_probe,
    _forward_backward,
    _frozen_params,
    _masked_weights,
    _native_semantics,
    _pool_cached_rows,
    _tt_path_inputs,
    _update_cores,
    _SGD_OPTIMS,
    make_folded_serving_fn,
    make_serving_fn,
)
from fbtt_embedding_tpu_torch.ops import cache as cache_ops
from fbtt_embedding_tpu_torch.ops.cache import (
    CacheState,
    _cache_loc,
    cache_row_grads,
)
from fbtt_embedding_tpu_torch.ops.contraction import validate_tt_shapes
from fbtt_embedding_tpu_torch.ops.hot_scatter import hot_scatter_add
from fbtt_embedding_tpu_torch.ops.indexing import (
    pad_csr_to_fixed,
    split_wide_keyrows,
)
from fbtt_embedding_tpu_torch.ops.lookup import pooled_tt_lookup
from fbtt_embedding_tpu_torch.parallel.collectives import (
    all_gather_cat,
    all_reduce_sum,
    all_to_all,
)
from fbtt_embedding_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
)
from fbtt_embedding_tpu_torch.parallel.multihost import host_local_slice

logger = logging.getLogger(__name__)


def _bag_positions(t: int, b: int, length: int, device):
    """``(rowidx, tableidx or None)`` of the ``t * b * length`` lookups of a
    fixed-pooling ``[T, B, L]`` block, table-major (``tableidx`` None for
    one table)."""
    pos = torch.arange(t * b * length, dtype=torch.int32, device=device)
    return (pos // length) % b, pos // (b * length) if t > 1 else None


def fixed_pool_lookup(
    cores: Sequence[torch.Tensor],
    indices: torch.Tensor,  # [T, B, L] int32
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    weights: Optional[torch.Tensor] = None,  # [T, B, L]
    precision: Optional[str] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Pooled lookup of ``[T, B, L]`` indices (every bag L lookups) ->
    ``[T, B, D]`` float32 through :func:`pooled_tt_lookup`, differentiable
    with respect to the cores (the JAX package's
    ``parallel.sharded._fixed_pool_lookup``)."""
    t, b, length = indices.shape
    rowidx, tableidx = _bag_positions(t, b, length, indices.device)
    return pooled_tt_lookup(
        cores, tt_p_shapes, tt_q_shapes, tt_ranks, b, indices.reshape(-1),
        rowidx, tableidx,
        weights=(None if weights is None
                 else weights.reshape(-1).to(torch.float32)),
        precision=precision, impl=impl)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class _ReplicatedGrads(torch.autograd.Function):
    """Identity on tensors replicated over a process group; the backward
    sums their gradients over the group (one all-reduce), as XLA sums a
    replicated input's gradient over the axes its batch is sharded on."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return (None, *all_reduce_sum(grads, ctx.group))


def _replicated(group, tensors):
    """``tensors`` (replicated over ``group``) for a differentiated
    computation on this rank's block of a batch: their gradients come out
    summed over the group. Tensors that need no gradient pass as they
    are."""
    tensors = tuple(tensors)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        return tensors
    return _ReplicatedGrads.apply(group, *tensors)


def _exchange(pooled, group, mp: int):
    """The pooled-embedding exchange over the table axis: ``[T_loc, B_loc,
    D]`` (this rank's tables over its batch block) -> ``[mp * T_loc,
    B_loc / mp, D]`` (every table over 1/mp of the block), the JAX
    package's ``all_to_all(split_axis=1, concat_axis=0, tiled=True)``.
    ``all_to_all_single`` splits dim 0, so the batch is cut into mp blocks
    and moved in front first; the received blocks stack rank-major, which
    is the global table order when tables are sharded in contiguous
    blocks."""
    t_loc, b_loc, d = pooled.shape
    send = pooled.reshape(t_loc, mp, b_loc // mp, d).transpose(0, 1)
    return all_to_all(send, group).reshape(mp * t_loc, b_loc // mp, d)


def _exchange_back(grad, group, mp: int):
    """The reverse of :func:`_exchange`: ``[T, B_loc / mp, D]`` -> ``[T /
    mp, B_loc, D]``, each table's rows back to its owner (the exchange's
    gradient)."""
    t, b, d = grad.shape
    back = all_to_all(grad.reshape(mp, t // mp, b, d), group)
    return back.transpose(0, 1).reshape(t // mp, mp * b, d)


class _Exchange(torch.autograd.Function):
    """:func:`_exchange`, differentiable: the backward is
    :func:`_exchange_back`."""

    @staticmethod
    def forward(ctx, pooled, group, mp):
        ctx.group, ctx.mp = group, mp
        return _exchange(pooled, group, mp)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return _exchange_back(grad, ctx.group, ctx.mp), None, None


def make_dp_lookup(mesh, tt_p_shapes: Sequence[int],
                   tt_q_shapes: Sequence[int], tt_ranks: Sequence[int],
                   batch_axes=("dp",), precision: Optional[str] = None):
    """Data-parallel lookup: ``fn(cores, indices [T, B_loc, L]) -> [T,
    B_loc, D]`` on this rank's block of the batch (sharded over
    ``batch_axes``, major first), cores replicated; differentiated, the
    cores' gradients are summed over the batch axes."""
    shapes = (tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(tt_ranks))
    group = axis_group(mesh, batch_axes)

    def lookup(cores, indices):
        return fixed_pool_lookup(_replicated(group, cores), indices,
                                 *shapes, precision=precision)

    return lookup


def make_table_sharded_lookup(mesh, tt_p_shapes: Sequence[int],
                              tt_q_shapes: Sequence[int],
                              tt_ranks: Sequence[int],
                              table_axis: str = "mp",
                              batch_axis: Optional[str] = "dp",
                              precision: Optional[str] = None,
                              impl: str = "auto"):
    """Table-sharded lookup with the all_to_all embedding exchange:
    ``fn(cores, indices) -> embeddings`` where

    * ``cores[t]``: this rank's ``[T / mp, p_t, r*q*r']`` block of tables
      (:func:`shard_params_for_table_parallel`),
    * ``indices``: its ``[T / mp, B / dp, L]`` block (tables over
      ``table_axis``, batch over ``batch_axis``),
    * the result: ``[T, B / (dp * mp), D]``, every table for the batch
      block at row-major coordinate ``(dp, mp)``, the block the
      data-parallel dense tower takes.

    Differentiated, each rank's cores get the gradient over the whole
    batch: through the reverse exchange from its ``mp`` peers, then summed
    over ``batch_axis``. ``batch_axis=None``: the batch is sharded over
    ``table_axis`` alone."""
    shapes = (tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(tt_ranks))
    mp = axis_size(mesh, table_axis)
    tgroup = axis_group(mesh, table_axis)
    # the cores' gradient sum over the batch axis, where it has ranks to sum
    bgroup = (axis_group(mesh, batch_axis) if batch_axis is not None
              and axis_size(mesh, batch_axis) > 1 else None)

    def lookup(cores, indices):
        t_loc, b_loc = indices.shape[0], indices.shape[1]
        if cores[0].shape[0] != t_loc:
            raise ValueError(f"the cores hold {cores[0].shape[0]} tables, "
                             f"the indices {t_loc}: pass this rank's block "
                             "of both")
        if b_loc % mp:
            raise ValueError(f"the local batch {b_loc} does not split over "
                             f"{table_axis}={mp}")
        if bgroup is not None:
            cores = _replicated(bgroup, cores)
        pooled = fixed_pool_lookup(cores, indices, *shapes,
                                   precision=precision, impl=impl)
        return _Exchange.apply(pooled, tgroup, mp)

    return lookup


def shard_params_for_table_parallel(mesh, cores, table_axis: str = "mp",
                                    device="cuda"):
    """This rank's block of every core along the table dim (contiguous,
    ``T / mp`` tables each), copied to ``device``; ``cores`` are the whole
    cores, numpy arrays or tensors. Raises ValueError when ``mp`` does not
    divide T."""
    return tuple(torch.tensor(host_local_slice(mesh, (table_axis,),
                                               _host(c)), device=device)
                 for c in cores)


def _cache_rows_summed(optimizer: OptimType, cache, d_output, locations,
                       rowidx, lr, eps, weights, group) -> None:
    """The cache-served lookups' rows, in place, aggregate-then-update: the
    per-row gradient sums (and, for row-wise Adagrad, the per-row mean
    squares) summed over ``group`` in one all-reduce, then one
    deterministic update on every rank. Exact for SGD and
    ``EXACT_ADAGRAD``; the aggregate form of the row-wise approximation
    (the JAX package's mesh semantics)."""
    d_rows, cached = cache_row_grads(d_output, locations, rowidx, weights)
    loc = _cache_loc(cache, locations, cached)
    g = hot_scatter_add(torch.zeros_like(cache.weight), loc, d_rows)
    rowwise = not (optimizer in _SGD_OPTIMS
                   or optimizer == OptimType.EXACT_ADAGRAD)
    if rowwise:
        gsq = torch.sum(d_rows * d_rows, dim=-1) / d_rows.shape[-1]
        g, gsq = all_reduce_sum(
            [g, hot_scatter_add(torch.zeros_like(cache.opt_state), loc,
                                gsq)], group)
        cache.opt_state.add_(gsq)
        scale = lr / (torch.sqrt(cache.opt_state) + eps)
        cache.weight.sub_(scale[:, None] * g)
        return
    (g,) = all_reduce_sum([g], group)
    if optimizer in _SGD_OPTIMS:
        cache.weight.sub_(lr * g)
    else:
        cache.opt_state.add_(g * g)
        cache.weight.sub_(lr * g / (torch.sqrt(cache.opt_state) + eps))


def make_sharded_fused_train_step(
    mesh,
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    num_tables: int,
    global_batch_size: int,
    pooling_factor: int,
    optimizer: Optional[OptimType] = None,
    use_cache: bool = False,
    probe_cache: bool = False,
    batch_axis: str = "dp",
    precision: Optional[str] = None,
    impl: str = "auto",
    count_interval: int = 1,
    optim_semantics: str = "reference",
    optim_hparams: Optional[dict] = None,
    device="cuda",
):
    """Data-parallel version of ``make_fused_train_step``: the reference's
    training semantics (fused optimizer, LFU counting, the cache's rows)
    with the batch sharded over ``batch_axis`` and the cores, optimizer
    state and cache replicated.

    ``step(params, indices, d_output, lr_eps, weights=None, *, count=True)
    -> (output [T, B_loc, D], params)`` on this rank's block: ``indices``
    ``[T, B_loc, L]`` int32 row ids (or ``[T, B_loc, L, 2 + ndim]`` wide
    key rows, with a wide-key cache), ``d_output`` ``[T, B_loc, D]``,
    ``weights`` ``[T, B_loc, L]``, with ``B_loc = global_batch_size /
    dp``. Locally the single-device step's lookup and gradients
    (``flat_train_apply``: B1, B2, B3 on the card; autograd through
    ``FlatLookup`` / ``GenericLookup`` where the flat step does not take
    the config); then one all-reduce (sum) of the core gradients over the
    axis, and the same update on every rank (reference or, with
    ``optim_semantics="native"``, each optimizer's own), **in place** as
    the single-device step.

    LFU counting (``use_cache``, on steps with ``count``; ``count_interval``
    as in the single-device step) all-gathers the ranks' keys in rank order
    and replays the insert on every rank: bitwise the single-device counting
    of the whole batch in every table mode (direct, hashed, wide). With
    ``probe_cache`` the cache-served lookups' rows are updated
    aggregate-then-update (their gradient sums all-reduced).

    Index -1 is a pad (``ops.indexing.pad_csr_to_fixed``), as is a wide key
    row with ``hi < 0``: its weight is forced to 0 (weights of 1 where none
    are given), so counting, probes and gradients never see it (the JAX
    package leaves a wide pad row's weight at 1 when no weights are given,
    ROADMAP §C). The step equals the single-device step on
    the concatenated batch (``tests/test_torch_port_parallel.py``)."""
    if optimizer is None:
        optimizer = OptimType.SGD
    if num_tables != 1 and (use_cache or probe_cache):
        # cache keys are bare row ids and the cache rows' gradient reads
        # d_output[0]: several tables would share table 0's rows
        raise ValueError("cannot use cache when num_tables != 1")
    native = _native_semantics(optim_semantics)
    hparams = dict(optim_hparams) if optim_hparams else None
    ranks = validate_tt_shapes(tt_p_shapes, tt_q_shapes, tt_ranks)
    shapes = (tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(ranks))
    ndim = len(tt_p_shapes)
    d = int(np.prod(tt_q_shapes))
    group = axis_group(mesh, batch_axis)
    dp = axis_size(mesh, batch_axis)
    if global_batch_size % dp:
        raise ValueError(f"global batch {global_batch_size} does not split "
                         f"over {batch_axis}={dp}")
    bl, length = global_batch_size // dp, pooling_factor
    nnz = num_tables * bl * length
    device = torch.device(device)

    def step(params: TTEmbeddingParams, indices, d_output, lr_eps,
             weights=None, *, count: bool = True):
        lr, eps = (v if isinstance(v, torch.Tensor) else float(v)
                   for v in lr_eps)
        indices = torch.as_tensor(indices, device=device)
        if indices.dim() not in (3, 4) or \
                tuple(indices.shape[:3]) != (num_tables, bl, length):
            raise ValueError(
                f"indices of shape {tuple(indices.shape)}: this rank's block "
                f"is [{num_tables}, {bl}, {length}] (or wide key rows "
                f"[{num_tables}, {bl}, {length}, {2 + ndim}])")
        d_output = torch.as_tensor(d_output, device=device,
                                   dtype=torch.float32)
        if tuple(d_output.shape) != (num_tables, bl, d):
            raise ValueError(f"d_output of shape {tuple(d_output.shape)}; "
                             f"expected [{num_tables}, {bl}, {d}]")
        if indices.dim() == 4:
            parts, keys, _ = split_wide_keyrows(indices.reshape(nnz, -1),
                                                ndim)
            flat = None
        else:
            flat = keys = indices.reshape(nnz)
            parts = None
        w = (None if weights is None else torch.as_tensor(
            weights, device=device, dtype=torch.float32).reshape(nnz))
        rowidx, tbl = _bag_positions(num_tables, bl, length, device)

        cache = params.cache
        if use_cache and count and cache is not None:
            _count_and_probe(cache, all_gather_cat(keys, group), True, False,
                             count_interval)
        locations = _count_and_probe(cache, keys, False, probe_cache,
                                     count_interval)
        # pads (id -1; wide rows with hi < 0): weight 0, also where no
        # weights were given, and in-range indices for the lookup (counting
        # dropped them, probes missed them)
        real = (flat if flat is not None else keys[:, 0]) >= 0
        w = real.to(torch.float32) if w is None else torch.where(
            real, w, torch.zeros((), device=device))
        if flat is not None:
            flat = flat.clamp(min=0)
        else:
            parts = tuple(torch.where(real, q, torch.zeros_like(q))
                          for q in parts)

        output, grads = _forward_backward(
            params.tt_cores, shapes, num_tables, bl, impl, precision, device,
            locations, flat, parts, rowidx, tbl, w, d_output)
        output = _cached_pool(output, cache, locations, w, rowidx, tbl,
                              num_tables, bl)
        grads = all_reduce_sum(grads, group)
        new_cores, new_opt = _update_cores(optimizer, params.tt_cores,
                                           params.optimizer_state, grads, lr,
                                           eps, native, hparams)
        if locations is not None:
            _cache_rows_summed(optimizer, cache, d_output, locations, rowidx,
                               lr, eps, w, group)
        return output, TTEmbeddingParams(new_cores, new_opt, cache)

    return step


def csr_step_adapter(step, num_tables: int, batch_size: int,
                     pooling_factor: int):
    """A fixed-pooling step of this module behind the reference's CSR
    ``(indices, offsets)`` API (``tt_embeddings_ops.py:821-874``):
    ``adapter(params, indices, offsets, d_output, lr_eps, weights=None,
    **kw)`` re-lays this rank's CSR batch on the host
    (``pad_csr_to_fixed``, the native loader: pads invisible to counting,
    probes and gradients) and calls ``step`` with the padded ``[T,
    batch_size, pooling_factor]`` batch and its pad-aware weights.
    ``batch_size`` is the rank's; bags longer than ``pooling_factor``
    raise."""
    def adapter(params, indices, offsets, d_output, lr_eps, weights=None,
                **kw):
        idx_pad, w_pad = pad_csr_to_fixed(indices, offsets, num_tables,
                                          batch_size, pooling_factor,
                                          weights=weights)
        return step(params, torch.from_numpy(idx_pad), d_output, lr_eps,
                    weights=torch.from_numpy(w_pad), **kw)

    return adapter


def _check_block(what: str, x: torch.Tensor, want: tuple) -> None:
    """ValueError unless ``x`` has this rank's block shape ``want``."""
    if tuple(x.shape) != tuple(want):
        raise ValueError(f"{what} of shape {tuple(x.shape)}: this rank's "
                         f"block is {list(want)}")


def _lookup_skipping(cores, shapes, num_tables: int, bs: int, flat, rowidx,
                     tbl, locations, precision):
    """The pooled TT lookup of every lookup the cache does not serve
    (``locations`` < 0), skipped as the single-device step skips them
    (``_tt_path_inputs``: dead lookups on the flat pipeline, weight 0
    elsewhere); differentiable with respect to ``cores``."""
    flat, rowidx, tbl, w, dead, _ = _tt_path_inputs(
        locations, "auto", shapes, num_tables, bs, flat, None, rowidx, tbl,
        None)
    return pooled_tt_lookup(cores, *shapes, bs, flat, rowidx, tbl, weights=w,
                            precision=precision, dead_mask=dead)


def make_table_sharded_fused_train_step(
    mesh,
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    num_tables: int,
    global_batch_size: int,
    pooling_factor: int,
    optimizer: Optional[OptimType] = None,
    table_axis: str = "mp",
    batch_axis: Optional[str] = "dp",
    precision: Optional[str] = None,
    impl: str = "auto",
    optim_semantics: str = "reference",
    optim_hparams: Optional[dict] = None,
    device="cuda",
):
    """Fused training with the TT cores **owned** along the table axis:
    each rank holds ``T / mp`` tables' cores and their optimizer state
    (:func:`shard_table_sharded_params`), the batch is sharded over
    ``batch_axis``.

    ``step(params, indices, d_output, lr_eps, weights=None) -> (output,
    params)`` on this rank's blocks: ``indices`` and ``weights`` ``[T / mp,
    B / dp, L]`` (tables over ``table_axis``, batch over ``batch_axis``),
    ``d_output`` and ``output`` ``[T, B / (dp * mp), D]``, the exchanged
    layout of :func:`make_table_sharded_lookup` (every table, the batch
    block at row-major coordinate ``(dp, mp)``). Locally the
    single-device step's lookup and gradients over the owned tables
    (``flat_train_apply``: B1, B2, B3 on the card) with ``d_output`` routed
    back to the owners by the reverse exchange; the pooled output goes out
    by the exchange. The owned cores' gradients are then summed over
    ``batch_axis`` only (no traffic on the table axis) and updated **in
    place** (reference semantics, or each optimizer's own with
    ``optim_semantics="native"``).

    Index -1 is a pad: weight 0 (also where no weights are given). Equals
    the single-device fused step on the whole batch for SGD, Adagrad and
    the elementwise native optimizers; native LAMB / LARS take their trust
    ratios over the owned tables only, as the JAX package's do. A
    ``params.cache`` raises ValueError (the LFU cache takes one table: use
    :func:`make_sharded_fused_train_step`), as do an ``mp`` that does not
    divide ``num_tables`` and a batch that does not split over ``dp *
    mp``."""
    if optimizer is None:
        optimizer = OptimType.SGD
    native = _native_semantics(optim_semantics)
    hparams = dict(optim_hparams) if optim_hparams else None
    ranks = validate_tt_shapes(tt_p_shapes, tt_q_shapes, tt_ranks)
    shapes = (tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(ranks))
    d = int(np.prod(tt_q_shapes))
    mp = axis_size(mesh, table_axis)
    dp = axis_size(mesh, batch_axis) if batch_axis is not None else 1
    if num_tables % mp:
        raise ValueError(f"{num_tables} tables do not split over "
                         f"{table_axis}={mp}")
    if global_batch_size % (dp * mp):
        raise ValueError(f"global batch {global_batch_size} does not split "
                         f"over dp * mp = {dp * mp}")
    tgroup = axis_group(mesh, table_axis)
    bgroup = axis_group(mesh, batch_axis) if dp > 1 else None
    t_loc, bl, length = num_tables // mp, global_batch_size // dp, \
        pooling_factor
    device = torch.device(device)

    def step(params: TTEmbeddingParams, indices, d_output, lr_eps,
             weights=None):
        if params.cache is not None:
            raise ValueError(
                "table-sharded fused training takes params.cache=None: the "
                "LFU cache takes one table; use make_sharded_fused_train_"
                "step for a cached single table")
        lr, eps = (v if isinstance(v, torch.Tensor) else float(v)
                   for v in lr_eps)
        indices = torch.as_tensor(indices, device=device)
        _check_block("indices", indices, (t_loc, bl, length))
        d_output = torch.as_tensor(d_output, device=device,
                                   dtype=torch.float32)
        _check_block("d_output", d_output, (num_tables, bl // mp, d))
        flat = indices.reshape(-1)
        rowidx, tbl = _bag_positions(t_loc, bl, length, device)
        real = flat >= 0
        w = real.to(torch.float32) if weights is None else torch.where(
            real, torch.as_tensor(weights, device=device,
                                  dtype=torch.float32).reshape(-1),
            torch.zeros((), device=device))
        d_loc = _exchange_back(d_output, tgroup, mp) if mp > 1 else d_output
        pooled, grads = _forward_backward(
            params.tt_cores, shapes, t_loc, bl, impl, precision, device,
            None, flat.clamp(min=0), None, rowidx, tbl, w, d_loc)
        output = _exchange(pooled, tgroup, mp) if mp > 1 else pooled
        if bgroup is not None:
            grads = all_reduce_sum(grads, bgroup)
        new_cores, new_opt = _update_cores(optimizer, params.tt_cores,
                                           params.optimizer_state, grads, lr,
                                           eps, native, hparams)
        return output, TTEmbeddingParams(new_cores, new_opt, None)

    return step


def shard_table_sharded_params(mesh, params, table_axis: str = "mp",
                               device="cuda") -> TTEmbeddingParams:
    """This rank's share of ``params`` for
    :func:`make_table_sharded_fused_train_step`: the block of every core
    along the table dim (contiguous, ``T / mp`` tables) and of every
    optimizer-state leaf that carries it (3-d, as the cores), the scalar
    and empty leaves (the native step counter, SGD's placeholders) whole;
    copies on ``device``, dtypes kept, ``cache`` None. ``params``' fields
    may hold numpy arrays (the JAX package's, through ``np.asarray``) or
    tensors. Raises ValueError when ``mp`` does not divide T."""
    def put(a):  # the leaf's block where it has a table dim
        a = _host(a)
        return torch.tensor(host_local_slice(mesh, (table_axis,), a)
                            if a.ndim == 3 else a, device=device)

    return TTEmbeddingParams(tuple(put(c).float() for c in params.tt_cores),
                             tuple(put(s) for s in params.optimizer_state),
                             None)


def make_dp_cached_lookup(mesh, tt_p_shapes: Sequence[int],
                          tt_q_shapes: Sequence[int],
                          tt_ranks: Sequence[int], batch_axes=("dp",),
                          precision: Optional[str] = None, device="cuda"):
    """Data-parallel lookup with a replicated LFU cache: ``fn(cores,
    cache_state, indices [T, B_loc, L]) -> [T, B_loc, D]`` on this rank's
    block of the batch (sharded over ``batch_axes``), cores and cache the
    same on every rank; no collective in the forward. Cache hits are
    served from the cache's rows; the misses take the TT lookup, where the
    hits are dead lookups the flat pipeline's kernels skip (B1 on the
    card). The JAX package computes every lookup's row by the plain
    ``tt_rows`` and substitutes the hits: the same function.
    Differentiated, the cores' gradients are summed over the batch axes.

    Counting is the caller's: replay ``update_cache_state`` on every rank
    over the gathered keys (as :func:`make_sharded_fused_train_step`
    does), then ``cache_populate`` on every rank, which is
    deterministic."""
    shapes = (tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(tt_ranks))
    group = axis_group(mesh, batch_axes)
    device = torch.device(device)

    def lookup(cores, cache_state: CacheState, indices):
        indices = torch.as_tensor(indices, device=device)
        t, b, length = indices.shape
        flat = indices.reshape(-1)
        rowidx, tbl = _bag_positions(t, b, length, device)
        locations = cache_ops.cache_lookup(cache_state, flat)
        out = _lookup_skipping(_replicated(group, cores), shapes, t, b,
                               flat, rowidx, tbl, locations, precision)
        return _cached_pool(out, cache_state, locations, None, rowidx, tbl,
                            t, b)

    return lookup


def make_dp_serving_fn(
    mesh,
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    num_tables: int,
    global_batch_size: int,
    pooling_factor: int,
    probe_cache: bool = True,
    folded: bool = True,
    batch_axis: str = "dp",
    precision: Optional[str] = None,
    impl: str = "auto",
    quantize: Optional[str] = None,
    device="cuda",
):
    """Data-parallel serving: ``(fold, serve)``, the freeze-then-serve
    contract of ``make_folded_serving_fn`` with the batch sharded over
    ``batch_axis``.

    * ``fold(params) -> FoldedServingParams``: the fold at the local batch
      ``B / dp``, on this rank (every rank folds the same params; no
      collective). ``quantize="int8"`` folds the int8 pair table and cache
      rows.
    * ``serve(fp, indices, weights=None) -> [T, B / dp, D]``: this rank's
      block of the requests, ``indices`` ``[T, B / dp, L]`` (or wide key
      rows ``[T, B / dp, L, 2 + ndim]`` for tables past 2^31 rows),
      ``weights`` ``[T, B / dp, L]``, served through the folded flat
      pipeline (B1 once a request at the headline) plus the local cache's
      hits. No collective.

    ``folded=False``: ``fold`` takes a copy of the cores and the cache and
    ``serve`` is ``make_serving_fn`` (a ``quantize`` is then ignored, with
    a warning, as in the JAX package). The JAX package's ``interpret``
    (Pallas-only) has no counterpart. Raises ValueError when ``dp`` does
    not divide the batch or a block has another shape."""
    dp = axis_size(mesh, batch_axis)
    if global_batch_size % dp:
        raise ValueError(f"global batch {global_batch_size} does not split "
                         f"over {batch_axis}={dp}")
    bl, length = global_batch_size // dp, pooling_factor
    ndim = len(tt_p_shapes)
    device = torch.device(device)
    if folded:
        fold, serve_local = make_folded_serving_fn(
            tt_p_shapes, tt_q_shapes, tt_ranks, num_tables, bl,
            probe_cache=probe_cache, precision=precision, impl=impl,
            quantize=quantize, device=device)
    else:
        if quantize is not None:
            logger.warning(
                "make_dp_serving_fn(quantize=%r, folded=False): quantization "
                "applies to the folded path only; each rank serves the "
                "unquantized parameters.", quantize)
        plain = make_serving_fn(tt_p_shapes, tt_q_shapes, tt_ranks,
                                num_tables, bl, probe_cache=probe_cache,
                                precision=precision, impl=impl,
                                device=device)

        def fold(params: TTEmbeddingParams) -> FoldedServingParams:
            return FoldedServingParams(params=_frozen_params(params))

        def serve_local(fp, indices, offsets, weights=None):
            return plain(fp.params, indices, offsets, weights)

    def serve(fp: FoldedServingParams, indices, weights=None):
        indices = torch.as_tensor(indices, device=device)
        if indices.dim() not in (3, 4) or \
                tuple(indices.shape[:3]) != (num_tables, bl, length):
            raise ValueError(
                f"indices of shape {tuple(indices.shape)}: this rank's block "
                f"is [{num_tables}, {bl}, {length}] (or wide key rows "
                f"[{num_tables}, {bl}, {length}, {2 + ndim}])")
        nnz = num_tables * bl * length
        offsets = torch.arange(0, nnz + 1, length, dtype=torch.int32,
                               device=device)
        flat = indices.reshape(nnz, -1) if indices.dim() == 4 \
            else indices.reshape(nnz)
        if weights is not None:
            weights = torch.as_tensor(weights, device=device,
                                      dtype=torch.float32).reshape(nnz)
        return serve_local(fp, flat, offsets, weights)

    return fold, serve


def shard_cache_weight_by_owner(mesh, weight, batch_axis: str = "dp",
                                device="cuda") -> torch.Tensor:
    """This rank's rows of a replicated cache table (``[C, D]`` rows, or
    any ``[C, ...]`` per-row state) in the owner-major layout of the
    row-owned cache: slot ``s`` belongs to rank ``s % dp`` at local row ``s
    // dp``, so rank ``o`` holds ``weight[o::dp]``, ``[C / dp, ...]``, a
    copy on ``device``. Interleaving (not contiguous blocks) spreads the
    hot head: populate ranks slots by count. ``weight``: a numpy array (the
    JAX package's) or a tensor. Raises ValueError when ``dp`` does not
    divide C."""
    dp = axis_size(mesh, batch_axis)
    if weight.shape[0] % dp:
        raise ValueError(f"cache of {weight.shape[0]} rows does not split "
                         f"over {batch_axis}={dp}")
    mine = weight[axis_index(mesh, batch_axis)::dp]
    if isinstance(mine, torch.Tensor):
        return mine.to(device, copy=True).contiguous()
    return torch.tensor(np.ascontiguousarray(mine), device=device)


def _owned_cache_size(mesh, batch_axis: str, cache_size: int) -> int:
    """Rows each rank owns; ValueError when ``dp`` does not divide
    ``cache_size``."""
    dp = axis_size(mesh, batch_axis)
    if cache_size % dp:
        raise ValueError(f"cache_size {cache_size} does not split over "
                         f"{batch_axis}={dp}")
    return cache_size // dp


def _a2a(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """:func:`all_to_all` over a group of ``n`` ranks (the identity at
    one)."""
    return all_to_all(x, group) if n > 1 else x


def _owned_rows(loc, weight_local, c_loc: int, dp: int, group):
    """The row-owned cache's two-hop exchange: ``(rows [nnz, D], got,
    owner)``. Each rank posts a ``[dp, nnz]`` request matrix (row ``o``:
    the local rows it wants from owner ``o``, the sentinel ``c_loc``
    elsewhere), the owners gather what they were asked (zero for the
    sentinel) and the reverse all_to_all brings the rows back; ``rows[i]``
    is ``back[owner[i], i]``, zero for a miss (``loc[i] < 0``). ``got``
    (the requests this rank served, per peer) and ``owner`` (``dp`` for a
    miss) are what the step's backward routes the cotangents by."""
    nnz = loc.shape[0]
    hit = loc >= 0
    owner = torch.where(hit, loc % dp, torch.full_like(loc, dp))
    lrow = torch.where(hit, loc // dp, torch.full_like(loc, c_loc))
    ranks = torch.arange(dp, dtype=loc.dtype, device=loc.device)
    reqs = torch.where(owner[None, :] == ranks[:, None], lrow[None, :],
                       torch.full((), c_loc, dtype=loc.dtype,
                                  device=loc.device))
    got = _a2a(reqs, group, dp)
    served = weight_local[got.clamp(max=c_loc - 1).long()]
    served = torch.where((got < c_loc)[:, :, None], served,
                         torch.zeros((), device=served.device))
    back = _a2a(served, group, dp)
    rows = back[owner.clamp(max=dp - 1).long(),
                torch.arange(nnz, device=loc.device)]
    rows = torch.where(hit[:, None], rows, torch.zeros((), device=rows.device))
    return rows, got, owner


def make_row_owned_cached_lookup(mesh, tt_p_shapes: Sequence[int],
                                 tt_q_shapes: Sequence[int],
                                 tt_ranks: Sequence[int], cache_size: int,
                                 batch_axis: str = "dp",
                                 precision: Optional[str] = None,
                                 device="cuda"):
    """Data-parallel lookup with the cache's rows **owned**:
    ``fn(cores, slots, weight_local, indices [T, B_loc, L]) -> [T, B_loc,
    D]`` on this rank's block, where ``slots`` is the replicated
    direct-mode table (row id -> cache slot, -1) and ``weight_local`` this
    rank's ``[cache_size / dp, D]`` rows (:func:`shard_cache_weight_by_
    owner`, :func:`make_row_owned_populate`).

    The hits come from their owners through the two-hop all_to_all (the
    requests padded to a fixed ``[dp, nnz]``); the misses take the TT
    lookup, where the hits are dead lookups (B1 on the card); the hits'
    rows are pooled deterministically. Differentiated, the cores'
    gradients are summed over the batch axis.

    The tradeoff against the replicated cache (:func:`make_dp_cached_
    lookup`): owning divides each rank's cache memory by ``dp`` (the
    capacity grows with the ranks) for two all_to_alls of up to ``dp * nnz
    * D`` floats a call; replicating serves every hit locally with no
    collective, at one device's capacity. Under Zipf traffic the hot head
    usually fits one device, and replication is the default. Raises
    ValueError when ``dp`` does not divide ``cache_size``."""
    shapes = (tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(tt_ranks))
    c_loc = _owned_cache_size(mesh, batch_axis, cache_size)
    dp = axis_size(mesh, batch_axis)
    group = axis_group(mesh, batch_axis)
    device = torch.device(device)

    def lookup(cores, slots, weight_local, indices):
        indices = torch.as_tensor(indices, device=device)
        t, b, length = indices.shape
        flat = indices.reshape(-1)
        rowidx, tbl = _bag_positions(t, b, length, device)
        loc = cache_ops.direct_lookup(slots, flat)
        rows, _, _ = _owned_rows(loc, weight_local, c_loc, dp, group)
        out = _lookup_skipping(_replicated(group, cores), shapes, t, b,
                               flat, rowidx, tbl, loc, precision)
        return out + _pool_cached_rows(rows, rowidx, tbl, t, b)

    return lookup


def make_row_owned_populate(mesh, tt_p_shapes: Sequence[int],
                            tt_q_shapes: Sequence[int],
                            tt_ranks: Sequence[int], cache_size: int,
                            batch_axis: str = "dp",
                            opt_state_kind: str = "none",
                            precision: Optional[str] = None,
                            populate_chunk: Optional[int] = None,
                            device="cuda"):
    """The row-owned cache's populate: ``populate(cache, cores) ->
    (new_cache, weight_owned, opt_owned)``. The winner selection
    (``populate_plan``) replays on every rank (the counting tables are
    replicated); each rank decompresses only the slots it owns, ``o + dp *
    k``, into its ``[cache_size / dp, D]`` ``weight_owned`` (the layout of
    :func:`shard_cache_weight_by_owner`), so populate's work per rank drops
    by ``dp``.

    ``new_cache``: the counting fields after populate (winners kept, losers
    evicted), ``weight`` and ``opt_state`` empty (the rows live in
    ``weight_owned``). ``opt_owned``: zeros, ``[cache_size / dp]``
    ("rowwise"), ``[cache_size / dp, D]`` ("full") or ``[0]`` ("none").
    Direct, hashed and wide layouts (wide winners decompress from their
    stored parts). Decompression is float32 (``precision`` is accepted for
    the JAX signature; ``cache_populate`` takes none either); the owned
    rows and state are on ``device``. ``cache`` is a counting state of
    ``cache_size`` rows; another size raises ValueError, as does a
    ``cache_size`` that ``dp`` does not divide."""
    c_loc = _owned_cache_size(mesh, batch_axis, cache_size)
    if opt_state_kind not in ("none", "rowwise", "full"):
        raise ValueError(f"unknown opt_state_kind {opt_state_kind!r}")
    dp = axis_size(mesh, batch_axis)
    d = int(np.prod(tt_q_shapes))
    device = torch.device(device)

    def populate(cache: CacheState, cores):
        if cache.cache_size != cache_size:
            raise ValueError(f"the cache holds {cache.cache_size} rows, "
                             f"not cache_size={cache_size}")
        new_keys, new_freq, new_slots, winner_rows, valid = \
            cache_ops.populate_plan(cache)
        o = axis_index(mesh, batch_axis)
        rows = cache_ops._decompress_rows(cores, tt_p_shapes, tt_q_shapes,
                                          tt_ranks, winner_rows[o::dp],
                                          chunk=populate_chunk)
        weight_owned = torch.where(valid[o::dp, None], rows,
                                   torch.zeros((), device=rows.device)
                                   ).to(device)
        shape = {"rowwise": (c_loc,), "full": (c_loc, d)}.get(
            opt_state_kind, (0,))
        f32 = dict(dtype=torch.float32, device=device)
        new_cache = CacheState(new_keys, new_freq, new_slots,
                               torch.zeros((0, d), **f32),
                               torch.zeros((0,), **f32))
        return new_cache, weight_owned, torch.zeros(shape, **f32)

    return populate


def make_row_owned_fused_train_step(
    mesh,
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    cache_size: int,
    global_batch_size: int,
    pooling_factor: int,
    optimizer: Optional[OptimType] = None,
    batch_axis: str = "dp",
    precision: Optional[str] = None,
    count_interval: int = 1,
    device="cuda",
):
    """Fused training with the cache's rows **owned** (one table): the
    cores, their optimizer state and the cache's counting tables
    replicated, the decompressed rows and their optimizer state owner-major
    (:func:`make_row_owned_populate`).

    ``step(params, weight_owned, opt_owned, indices, d_output, lr_eps,
    weights=None, *, count=True) -> (output, params, weight_owned,
    opt_owned)`` on this rank's blocks: ``indices`` and ``weights`` ``[1,
    B_loc, L]``, ``d_output`` and ``output`` ``[1, B_loc, D]``, ``B_loc =
    global_batch_size / dp``; ``params.cache`` the counting state (its
    ``weight`` unused: the empty one of populate). Each step:

    * counting (``count``; ``count_interval`` as in the single-device step):
      the ranks' keys all-gathered in rank order and the insert replayed on
      every rank, bitwise the single-device counting of the whole batch;
    * forward: the hits through the two-hop all_to_all, the misses through
      the single-device step's lookup (``flat_train_apply``: B1, B2, B3 on
      the card, the hits dead lookups);
    * backward: the cores' gradients summed over the batch axis and the
      reference update (SGD, or full-element Adagrad); the hits'
      cotangents go back to their owners by a third all_to_all, and each
      owner adds them (``hot_scatter_add``, deterministic) and updates its
      rows: SGD, ``EXACT_ADAGRAD`` (``[C / dp, D]`` state) or row-wise
      approximate Adagrad (``[C / dp]``: the state adds each lookup's mean
      square, then every lookup updates with the final state).

    Everything is updated **in place**. Index -1 is a pad: weight 0, a miss,
    not counted. Raises ValueError for another table count than one, a
    ``cache_size`` or batch that ``dp`` does not divide, or blocks of
    another shape."""
    if optimizer is None:
        optimizer = OptimType.SGD
    is_sgd = optimizer in _SGD_OPTIMS
    exact = optimizer == OptimType.EXACT_ADAGRAD
    ranks = validate_tt_shapes(tt_p_shapes, tt_q_shapes, tt_ranks)
    shapes = (tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(ranks))
    d = int(np.prod(tt_q_shapes))
    c_loc = _owned_cache_size(mesh, batch_axis, cache_size)
    dp = axis_size(mesh, batch_axis)
    if global_batch_size % dp:
        raise ValueError(f"global batch {global_batch_size} does not split "
                         f"over {batch_axis}={dp}")
    group = axis_group(mesh, batch_axis)
    bl, length = global_batch_size // dp, pooling_factor
    device = torch.device(device)

    def step(params: TTEmbeddingParams, weight_owned, opt_owned, indices,
             d_output, lr_eps, weights=None, *, count: bool = True):
        lr, eps = (v if isinstance(v, torch.Tensor) else float(v)
                   for v in lr_eps)
        indices = torch.as_tensor(indices, device=device)
        if indices.dim() == 3 and indices.shape[0] != 1:
            raise ValueError(
                f"the row-owned step takes one table, got {indices.shape[0]} "
                "(the cache's keys are bare row ids)")
        _check_block("indices", indices, (1, bl, length))
        d_output = torch.as_tensor(d_output, device=device,
                                   dtype=torch.float32)
        _check_block("d_output", d_output, (1, bl, d))
        flat = indices.reshape(-1)
        rowidx, _ = _bag_positions(1, bl, length, device)
        real = flat >= 0
        w = real.to(torch.float32) if weights is None else torch.where(
            real, torch.as_tensor(weights, device=device,
                                  dtype=torch.float32).reshape(-1),
            torch.zeros((), device=device))
        cache = params.cache
        if count and cache is not None:
            cache_ops.update_cache_state(
                cache, all_gather_cat(flat, group) if dp > 1 else flat,
                scale=count_interval)
        flat = flat.clamp(min=0)
        loc = torch.full(flat.shape, -1, dtype=torch.int32, device=device)
        if cache is not None:  # pads miss
            loc = torch.where(real, cache_ops.cache_lookup(cache, flat), loc)
        rows, got, owner = _owned_rows(loc, weight_owned, c_loc, dp, group)
        output, grads = _forward_backward(
            params.tt_cores, shapes, 1, bl, "auto", precision, device, loc,
            flat, None, rowidx, None, w, d_output)
        output = output + _pool_cached_rows(
            rows * _masked_weights(loc >= 0, w)[:, None], rowidx, None, 1, bl)
        if dp > 1:
            grads = all_reduce_sum(grads, group)
        new_cores, new_opt = _update_cores(optimizer, params.tt_cores,
                                           params.optimizer_state, grads, lr,
                                           eps)

        # the hits' cotangents to their owners, who add and apply them
        d_rows, _ = cache_row_grads(d_output, loc, rowidx, w)
        mine = owner[None, :] == torch.arange(dp, dtype=owner.dtype,
                                              device=device)[:, None]
        vals = torch.where(mine[:, :, None], d_rows[None],
                           torch.zeros((), device=device))
        req = got.reshape(-1)
        val = _a2a(vals, group, dp).reshape(-1, d)
        if is_sgd or exact:
            g = hot_scatter_add(torch.zeros_like(weight_owned), req, val)
            if is_sgd:
                weight_owned.sub_(lr * g)
            else:
                opt_owned.add_(g * g)
                weight_owned.sub_(lr * g / (torch.sqrt(opt_owned) + eps))
        else:
            hot_scatter_add(opt_owned, req, torch.sum(val * val, dim=-1) / d)
            scale = lr / (torch.sqrt(opt_owned) + eps)
            per = scale[req.clamp(max=c_loc - 1).long()] \
                * (req < c_loc).to(torch.float32)
            hot_scatter_add(weight_owned, req, -per[:, None] * val)
        return (output, TTEmbeddingParams(new_cores, new_opt, cache),
                weight_owned, opt_owned)

    return step
