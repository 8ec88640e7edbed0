"""Pooled TT-embedding lookup, in PyTorch.

Counterpart of ``fbtt_embedding_tpu.ops.lookup``: sum pooling, the
odd-rank padding that lets any tt_ndim 2-4 config take the flat pipeline,
:func:`route`, which picks the TT path of a call (the flat sorted-run
pipeline, ``ops/kernels/tt_flat.py``: kernel B1 forward, B3 backward; the
generic per-lookup kernels, :class:`GenericLookup`: B4 forward, B5
backward; or the plain ``tt_rows`` path) and :func:`tt_path_inputs`, how
cache-served lookups skip it; ``pooled_tt_lookup``, differentiable with
respect to the cores; and the dense-mode exports (``tt_forward``,
``tt_embedding_bag_forward``, ``tt_grads_from_row_cotangents``,
``tt_dense_backward``), torch autograd through ``tt_rows`` as the JAX
package's are XLA autodiff.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fbtt_embedding_tpu_torch.ops.contraction import tt_rows, validate_tt_shapes
from fbtt_embedding_tpu_torch.ops.hot_scatter import segment_sum
from fbtt_embedding_tpu_torch.ops.indexing import (
    decompose_indices,
    rowidx_from_offsets,
)
from fbtt_embedding_tpu_torch.ops.kernels.tt_flat import (
    flat_available,
    flat_forward,
)
from fbtt_embedding_tpu_torch.ops.kernels.tt_kernel import (
    backward_lookups,
    block_inputs,
    core1_order,
    forward_lookups,
    generic_available,
)


def pool_rows(rows: torch.Tensor, rowidx: torch.Tensor,
              tableidx: Optional[torch.Tensor], num_tables: int,
              batch_size: int) -> torch.Tensor:
    """Sum-pool per-lookup rows into ``[num_tables, B, D]`` bags, by the
    deterministic :func:`~fbtt_embedding_tpu_torch.ops.hot_scatter.
    segment_sum` (the JAX package's ``segment_sum``)."""
    seg = rowidx.long()
    if num_tables > 1 and tableidx is not None:
        seg = tableidx.long() * batch_size + seg
    return segment_sum(rows, seg, num_tables * batch_size).reshape(
        num_tables, batch_size, rows.shape[-1])


def tt_forward(tt_cores: Sequence[torch.Tensor], tt_p_shapes, tt_q_shapes,
               tt_ranks, batch_size: int, indices: Optional[torch.Tensor],
               rowidx: torch.Tensor, tableidx: Optional[torch.Tensor] = None,
               weights: Optional[torch.Tensor] = None,
               idx_parts: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
    """Pooled forward ``[num_tables, B, D]`` (float32) by the plain
    ``tt_rows`` chain, differentiable with respect to the cores by torch
    autograd (dense-grad mode; the reference binding ``tt_forward``).
    ``weights`` scales each lookup."""
    rows = tt_rows(tt_cores, tt_p_shapes, tt_q_shapes, tt_ranks, indices,
                   tableidx, idx_parts=idx_parts)
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    return pool_rows(rows, rowidx, tableidx, tt_cores[0].shape[0],
                     batch_size)


def tt_embedding_bag_forward(tt_cores: Sequence[torch.Tensor], tt_p_shapes,
                             tt_q_shapes, tt_ranks, indices: torch.Tensor,
                             offsets: torch.Tensor, batch_size: int,
                             weights: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """EmbeddingBag-style entry: ``(indices, offsets)`` -> ``[T, B, D]``;
    ``offsets`` has ``T * batch_size + 1`` table-major entries."""
    num_tables = tt_cores[0].shape[0]
    rowidx, tableidx = rowidx_from_offsets(offsets, indices.shape[0],
                                           num_tables, batch_size)
    return tt_forward(tt_cores, tt_p_shapes, tt_q_shapes, tt_ranks,
                      batch_size, indices, rowidx,
                      tableidx if num_tables > 1 else None, weights=weights)


def _core_grads(fn, tt_cores, cotangent):
    """Gradients of the cores through ``fn(leaves)`` for ``cotangent``."""
    leaves = [c.detach().requires_grad_() for c in tt_cores]
    with torch.enable_grad():
        out = fn(leaves)
        grads = torch.autograd.grad(out, leaves,
                                    cotangent.to(out.dtype))
    return list(grads)


def tt_grads_from_row_cotangents(
        tt_cores: Sequence[torch.Tensor], tt_p_shapes, tt_q_shapes, tt_ranks,
        indices: Optional[torch.Tensor], tableidx: Optional[torch.Tensor],
        d_rows: torch.Tensor,
        idx_parts: Optional[Sequence[torch.Tensor]] = None
) -> List[torch.Tensor]:
    """Core gradients for per-lookup row cotangents ``d_rows [nnz, D]``."""
    return _core_grads(
        lambda cs: tt_rows(cs, tt_p_shapes, tt_q_shapes, tt_ranks, indices,
                           tableidx, idx_parts=idx_parts),
        tt_cores, d_rows)


def tt_dense_backward(tt_cores: Sequence[torch.Tensor], tt_p_shapes,
                      tt_q_shapes, tt_ranks, batch_size: int,
                      indices: torch.Tensor, rowidx: torch.Tensor,
                      tableidx: Optional[torch.Tensor],
                      d_output: torch.Tensor) -> List[torch.Tensor]:
    """Dense core gradients for an output cotangent ``[T, B, D]`` (the
    reference binding ``tt_dense_backward``): the gradient of
    :func:`tt_forward`, with no optimizer state touched."""
    return _core_grads(
        lambda cs: tt_forward(cs, tt_p_shapes, tt_q_shapes, tt_ranks,
                              batch_size, indices, rowidx, tableidx),
        tt_cores, d_output)


class GenericLookup(torch.autograd.Function):
    """The pooled lookup through the generic per-lookup kernels: the JAX
    package's ``_make_pooled_pallas_vjp``. Forward runs kernel B4
    (:func:`forward_lookups`), backward kernel B5
    (:func:`backward_lookups`); indices, weights and the live count get
    no gradient. The backward recomputes the chain (the reference's
    recompute strategy); of the forward it keeps the lookups as the
    kernels take them (:func:`block_inputs`) and B4's pivot orders (core
    1's, and at tt_ndim 4 core 2's: :func:`core1_order`), built once for
    both kernels.

    ``apply(cfg, idx_parts, rowidx, tableidx, weights, live, dead, *cores)``
    with ``cfg = (p, q, ranks, batch_size)`` and ``idx_parts`` a tuple of
    per-core int32 indices."""

    @staticmethod
    def forward(ctx, cfg, idx_parts, rowidx, tableidx, weights, live, dead,
                *cores):
        p, q, r, batch_size = cfg
        t = cores[0].shape[0]
        lookups = block_inputs(idx_parts, rowidx, tableidx, weights, live, p,
                               t, batch_size, dead)
        core1 = None
        if any(ctx.needs_input_grad[7:]):
            core1 = core1_order(*lookups[:2], [t * p_ for p_ in p])
            ctx.save_for_backward(*cores)
            ctx.cfg, ctx.lookups, ctx.core1 = cfg, lookups, core1
        return forward_lookups(cores, p, q, r, batch_size, lookups, core1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_output):
        p, q, r, batch_size = ctx.cfg
        grads = backward_lookups(ctx.saved_tensors, p, q, r, batch_size,
                                 ctx.lookups, d_output, ctx.core1)
        return (None,) * 7 + tuple(grads)


def _pad_up(x: int, m: int) -> int:
    return -(-x // m) * m


def flat_pad_plan(tt_p_shapes, tt_q_shapes, ranks, batch_size):
    """Padded ``(full_ranks, q_last, B)`` meeting the flat pipeline's
    multiple-of-8 width gates, or None when no padding is needed.

    Zero-padding ranks, the last q-dim and the batch is exact. Core t's
    input is staged as q0 lane-blocks of width ``mm_t * r_t``
    (``mm_t = q1*..*q_{t-1}``); padding ``r_t`` to ``ceil8(mm_t*r_t)/mm_t``
    fixes pass t's input and pass t-1's output, and padding the last q-dim
    fixes the final pass's output."""
    ndim = len(tt_p_shapes)
    q = list(tt_q_shapes)
    r = list(ranks)  # full boundary ranks, len ndim + 1
    rp = list(r)
    mm = 1
    for t in range(1, ndim):
        rp[t] = _pad_up(r[t], 8 // math.gcd(mm, 8))
        mm *= q[t]
    mm_last = mm // q[ndim - 1]
    qlp = _pad_up(q[ndim - 1], 8 // math.gcd(mm_last, 8))
    bp = _pad_up(batch_size, 8)
    if (tuple(rp), qlp, bp) == (tuple(r), q[ndim - 1], batch_size):
        return None
    return tuple(rp), qlp, bp


def pad_cores_for_flat(tt_cores, tt_p_shapes, tt_q_shapes, ranks, plan):
    """Zero-pad cores (module layout ``[T, p_t, r_t*q_t*r_{t+1}]``) to a
    :func:`flat_pad_plan`'s ranks and last q-dim."""
    rp, qlp, _ = plan
    ndim = len(tt_p_shapes)
    t = tt_cores[0].shape[0]
    out = []
    for ti in range(ndim):
        q_t = tt_q_shapes[ti] if ti < ndim - 1 else qlp
        c = tt_cores[ti].reshape(t, tt_p_shapes[ti], ranks[ti],
                                 tt_q_shapes[ti], ranks[ti + 1])
        # F.pad lists (before, after) pairs from the last dim backwards
        c = F.pad(c, (0, rp[ti + 1] - ranks[ti + 1], 0, q_t - tt_q_shapes[ti],
                      0, rp[ti] - ranks[ti]))
        out.append(c.reshape(t, tt_p_shapes[ti], rp[ti] * q_t * rp[ti + 1]))
    return tuple(out)


def flat_servable(tt_p_shapes, tt_q_shapes, ranks, num_tables,
                  batch_size) -> bool:
    """Whether the flat pipeline takes this config, padded if need be."""
    return _route(tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(ranks),
                  num_tables, batch_size, "pallas_sorted") is not None


def unpad_flat_output(out: torch.Tensor, batch_size: int, padded_q,
                      q_last: int) -> torch.Tensor:
    """A flat lookup's ``[T, B', prod(padded_q)]`` output cut to the real
    bags and the real last q-dim: ``[T, batch_size, D]`` (views where
    nothing was padded)."""
    t = out.shape[0]
    return out[:, :batch_size].reshape(
        (t, batch_size) + tuple(padded_q))[..., :q_last].reshape(
            t, batch_size, -1)


def staging_dtype(device: torch.device, precision: Optional[str]):
    """float32 staging on the CPU or when ``precision == "highest"``,
    bfloat16 otherwise (float32 master cores and accumulation either
    way)."""
    if torch.device(device).type == "cpu" or precision == "highest":
        return torch.float32
    return torch.bfloat16


class Route(NamedTuple):
    """A lookup's TT path (:func:`route`): ``kind`` "flat", "generic" or
    "plain"; the widths ``q``, full ranks ``r`` and batch ``b`` its
    kernels run at, padded by ``pad`` (a :func:`flat_pad_plan`, or None)."""

    kind: str
    q: Tuple[int, ...]
    r: Tuple[int, ...]
    b: int
    pad: Optional[tuple] = None


@functools.lru_cache(maxsize=256)
def _route(p, q, r, t: int, b: int, impl: str) -> Optional[Route]:
    if impl == "pallas":
        return (Route("generic", q, r, b)
                if generic_available(p, q, r, t, b) else None)
    if impl in ("auto", "pallas_sorted"):
        if flat_available(p, q, r, t, b):
            return Route("flat", q, r, b)
        pad = flat_pad_plan(p, q, r, b)
        qp = q[:-1] + (pad[1],) if pad is not None else q
        if pad is not None and flat_available(p, qp, pad[0], t, pad[2]):
            return Route("flat", qp, pad[0], pad[2], pad)
        if impl == "pallas_sorted":
            return None
    return Route("plain", q, r, b)


def route(tt_p_shapes, tt_q_shapes, tt_ranks, num_tables: int,
          batch_size: int, impl: str) -> Route:
    """Which TT path serves ``num_tables`` tables of ``batch_size`` bags
    under ``impl`` (names as in the JAX package): "auto" and
    "pallas_sorted" the flat sorted-run pipeline, zero-padding odd ranks,
    the last q-dim and the batch to its width gates; where even padding
    cannot serve the config, "auto" the plain path and "pallas_sorted" a
    ValueError. "pallas" the generic kernels (float32), or a ValueError;
    "xla" the plain ``tt_rows`` chain. Unlike the JAX package's, "auto"
    never picks the generic kernels: the flat pipeline here has no span
    cap or VMEM budget, so it takes every tt_ndim 2-4 config they would.
    An unknown ``impl`` or invalid shapes raise ValueError too."""
    ranks = validate_tt_shapes(tt_p_shapes, tt_q_shapes, tt_ranks)
    if impl not in ("auto", "pallas_sorted", "pallas", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    rt = _route(tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(ranks),
                num_tables, batch_size, impl)
    if rt is None:
        raise ValueError(
            ("impl='pallas': the generic kernels cannot serve this config "
             if impl == "pallas" else "impl='pallas_sorted' cannot serve "
             "this config even with rank/dim padding ")
            + f"(p={tt_p_shapes}, q={tt_q_shapes}, ranks={ranks}, "
            f"T={num_tables}, B={batch_size})")
    return rt


def masked_weights(mask, weights):
    """Per-lookup float32 weights: ``weights`` (1 when None) where
    ``mask``, 0 elsewhere."""
    w = mask.to(torch.float32)
    return w if weights is None else w * weights


def _live_first(locations, indices, rowidx, tbl, weights):
    """Lookups repacked live (not cache-served) first, for the generic
    kernels' ``live_count``: ``(indices, rowidx, tableidx, weights, None,
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
            packed(masked_weights(alive, weights)), None,
            live_count.reshape(1))


def tt_path_inputs(rt: Route, locations, indices, parts, rowidx, tbl,
                   weights):
    """The lookups the TT path on route ``rt`` takes: ``(indices, rowidx,
    tableidx, weights, dead_mask, live_count)``, the cache-served ones
    (``locations >= 0``; None: no cache) skipped: the flat pipeline sorts
    them into its dead span, the generic kernels (flat row ids) skip the
    blocks past ``live_count`` (live lookups packed first), else weight
    0."""
    if locations is None:
        return indices, rowidx, tbl, weights, None, None
    if rt.kind == "flat":
        return indices, rowidx, tbl, weights, locations >= 0, None
    if rt.kind == "generic" and parts is None:
        return _live_first(locations, indices, rowidx, tbl, weights)
    return (indices, rowidx, tbl, masked_weights(locations < 0, weights),
            None, None)


def pooled_tt_lookup(
    tt_cores: Sequence[torch.Tensor],
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    batch_size: int,
    indices: Optional[torch.Tensor],
    rowidx: torch.Tensor,
    tableidx: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    precision: Optional[str] = None,
    impl: str = "auto",
    live_count: Optional[torch.Tensor] = None,
    dead_mask: Optional[torch.Tensor] = None,
    idx_parts: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Pooled TT-embedding lookup ``[num_tables, B, D]`` (float32),
    differentiable with respect to ``tt_cores`` (the flat path through
    ``FlatLookup``, padding included; the generic path through
    ``GenericLookup``; the plain path through torch's own autograd).

    ``impl`` as :func:`route` resolves it: the flat pipeline's kernels on a
    CUDA tensor, their plain versions on a CPU tensor.

    ``precision``: None stages the flat path's intermediates in bfloat16 on
    the card; "highest" stages them in float32 (the generic kernels always
    run in float32). ``live_count`` ([1]) and ``dead_mask`` ([nnz] bool)
    mark cache-served lookups, which the flat path sorts into its
    zero-filled sentinel span and the generic kernels skip; the plain path
    ignores them (its caller zeroes such lookups' weights)."""
    ranks = validate_tt_shapes(tt_p_shapes, tt_q_shapes, tt_ranks)
    num_tables = tt_cores[0].shape[0]
    rt = route(tt_p_shapes, tt_q_shapes, ranks, num_tables, batch_size, impl)
    if rt.kind == "plain":
        return tt_forward(tt_cores, tt_p_shapes, tt_q_shapes, ranks,
                          batch_size, indices, rowidx, tableidx, weights,
                          idx_parts)
    if rt.kind == "generic":
        parts = tuple(idx_parts) if idx_parts is not None else tuple(
            decompose_indices(indices, tt_p_shapes))
        cfg = (tuple(tt_p_shapes), rt.q, rt.r, batch_size)
        return GenericLookup.apply(cfg, parts, rowidx, tableidx, weights,
                                   live_count, dead_mask, *tt_cores)

    cores_use = tuple(tt_cores) if rt.pad is None else pad_cores_for_flat(
        tt_cores, tt_p_shapes, tt_q_shapes, ranks, rt.pad)
    key_in = tuple(idx_parts) if idx_parts is not None else indices
    out = flat_forward(
        cores_use, key_in, rowidx, tableidx, weights,
        dead_mask if dead_mask is not None else live_count, tt_p_shapes,
        rt.q, rt.r, num_tables, rt.b,
        compute_dtype=staging_dtype(rowidx.device, precision),
        live_is_mask=dead_mask is not None,
        parts_mode=idx_parts is not None)
    if rt.pad is not None:
        out = unpad_flat_output(out, batch_size, rt.q, tt_q_shapes[-1])
    return out
