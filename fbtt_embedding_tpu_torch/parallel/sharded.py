"""Sharded TT-embedding lookups and the data-parallel fused training step.

Counterpart of the training half of ``fbtt_embedding_tpu.parallel.sharded``
on ``torch.distributed``. One process per device; each entry takes and
returns this rank's block of the batch (``parallel.multihost``), and every
collective goes through ``parallel.collectives`` on the mesh axis's process
group. The lookups inside are the single-device ones, so the local work
runs the ported kernels (B1-B3, B6 under ``FBTT_DG0=fused``, B4/B5 under
``impl="pallas"``).

* **Data parallel** (:func:`make_dp_lookup`,
  :func:`make_sharded_fused_train_step`): bags sharded over the batch
  axis, TT cores replicated (they are small: the point of TT
  compression). The core gradients are summed over the axis in one
  all-reduce and every rank runs the same update.
* **Table sharded** (:func:`make_table_sharded_lookup`): each rank of the
  ``mp`` axis owns ``T / mp`` tables' cores (contiguous blocks) and pools
  them over its ``dp`` block of the batch; an all_to_all over ``mp``
  redistributes so every rank ends with all ``T`` tables for ``1 / (dp *
  mp)`` of the batch, the layout the data-parallel dense tower takes. The
  exchange's gradient is the reverse all_to_all; the cores' gradients are
  then summed over ``dp``, where the cores are replicated.

Fixed pooling: indices are ``[T, B, L]``; ragged CSR bags are padded on the
host with index -1 and weight 0 (:func:`csr_step_adapter`,
``ops.indexing.pad_csr_to_fixed``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from fbtt_embedding_tpu_torch.models.tt_embedding import (
    OptimType,
    TTEmbeddingParams,
    _cached_pool,
    _count_and_probe,
    _forward_backward,
    _native_semantics,
    _update_cores,
    _SGD_OPTIMS,
)
from fbtt_embedding_tpu_torch.ops.cache import _cache_loc, cache_row_grads
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
from fbtt_embedding_tpu_torch.parallel.mesh import axis_group, axis_size
from fbtt_embedding_tpu_torch.parallel.multihost import host_local_slice


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
    nnz = t * b * length
    pos = torch.arange(nnz, dtype=torch.int32, device=indices.device)
    rowidx = (pos // length) % b
    tableidx = pos // (b * length)
    return pooled_tt_lookup(
        cores, tt_p_shapes, tt_q_shapes, tt_ranks, b, indices.reshape(nnz),
        rowidx, tableidx if t > 1 else None,
        weights=(None if weights is None
                 else weights.reshape(nnz).to(torch.float32)),
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


class _Exchange(torch.autograd.Function):
    """The pooled-embedding exchange over the table axis: ``[T_loc, B_loc,
    D]`` (this rank's tables over its batch block) -> ``[mp * T_loc,
    B_loc / mp, D]`` (every table over 1/mp of the block), the JAX
    package's ``all_to_all(split_axis=1, concat_axis=0, tiled=True)``.
    ``all_to_all_single`` splits dim 0, so the batch is cut into mp blocks
    and moved in front first; the received blocks stack rank-major, which
    is the global table order when tables are sharded in contiguous
    blocks. The backward is the reverse exchange."""

    @staticmethod
    def forward(ctx, pooled, group, mp):
        t_loc, b_loc, d = pooled.shape
        ctx.group, ctx.mp = group, mp
        send = pooled.reshape(t_loc, mp, b_loc // mp, d).transpose(0, 1)
        return all_to_all(send, group).reshape(mp * t_loc, b_loc // mp, d)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        mp = ctx.mp
        t, b, d = grad.shape
        back = all_to_all(grad.reshape(mp, t // mp, b, d), ctx.group)
        return back.transpose(0, 1).reshape(t // mp, mp * b, d), None, None


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
        pos = torch.arange(nnz, dtype=torch.int32, device=device)
        rowidx = (pos // length) % bl
        tbl = pos // (bl * length) if num_tables > 1 else None

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
