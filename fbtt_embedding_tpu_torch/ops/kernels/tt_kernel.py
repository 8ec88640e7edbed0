"""Core layouts and the generic per-lookup path (kernels B4, B5).

Counterpart of ``fbtt_embedding_tpu/ops/pallas/tt_kernel.py``: the layout
helpers, shared with the flat pipeline, and the host drivers of the
generic kernels, :func:`tt_forward_kernel` (forward, kernel B4:
``ops/kernels/tt_fwd.py``) and :func:`tt_backward_kernel` (core
gradients, kernel B5: ``ops/kernels/tt_bwd.py``), for tt_ndim 2-4 and any
ranks. They run behind ``pooled_tt_lookup(impl="pallas")``.

Both prepare what the kernels take (:func:`block_inputs`, the
counterpart of the JAX ``_block_inputs``): per-core rows offset by table
(``t*p_t + i_t``), the pooled row ``t*B + b`` of every lookup, -1 for a
dead lookup, float32 weights. The TPU's padding of nnz to whole blocks is
not carried over (the kernels take any nnz), nor are its multiple-of-8 and
VMEM gates: :func:`generic_available` asks only that a lookup's chain fit
the kernels' shared memory. The kernels' schedules are stable sorts on
the device: lookups grouped by bag for the forward (:func:`bag_order`),
sorted by core 1's row (and at tt_ndim 4 by core 2's) for its pivot path
(:func:`core1_order`) and, for the backward, sorted by each core's row
into fixed segments (:func:`core_orders`). In a training step ``GenericLookup`` prepares the
lookups once (:func:`forward_lookups`, :func:`backward_lookups`) and the
backward takes the forward's pivot orders (core 1's, and at tt_ndim 4
core 2's: :func:`core1_order`), so a step sorts once per core and once by
bag.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from fbtt_embedding_tpu_torch.ops.kernels.tt_bwd import bwd_chunk, tt_bwd
from fbtt_embedding_tpu_torch.ops.kernels.tt_fwd import fwd_chunk, tt_fwd

SEG = 64  # lookups per segment of the backward kernel: one CTA each
_I32_MAX = 2 ** 31 - 1


def kernel_core_layouts(tt_cores: Sequence[torch.Tensor], tt_p_shapes,
                        tt_q_shapes, tt_ranks) -> Tuple[torch.Tensor, ...]:
    """Module storage ``[T, p, r*q*r']`` -> kernel layouts (pure reshapes):
    core 0 ``[T*p0, q0, r1]``, middle cores ``[T*p, r, q*r']``, the last
    core ``[T*p, r, q]``."""
    ndim = len(tt_p_shapes)
    t = tt_cores[0].shape[0]
    out = []
    for i in range(ndim):
        p, qq = tt_p_shapes[i], tt_q_shapes[i]
        ra, rb = tt_ranks[i], tt_ranks[i + 1]
        if i == 0:
            out.append(tt_cores[0].reshape(t * p, qq, rb))
        elif i == ndim - 1:
            out.append(tt_cores[i].reshape(t * p, ra, qq))
        else:
            out.append(tt_cores[i].reshape(t * p, ra, qq * rb))
    return tuple(out)


def grads_to_module_layout(dgs: Sequence[torch.Tensor], tt_p_shapes,
                           tt_q_shapes, tt_ranks,
                           num_tables: int) -> Tuple[torch.Tensor, ...]:
    """Kernel-layout gradients -> module storage ``[T, p_t, r_t*q_t*r_{t+1}]``
    (pure reshapes)."""
    return tuple(
        dgs[i].reshape(num_tables, tt_p_shapes[i],
                       tt_ranks[i] * tt_q_shapes[i] * tt_ranks[i + 1])
        for i in range(len(tt_p_shapes)))


def full_ranks(p, r):
    """The boundary ranks ``[1, *r, 1]`` from inner or full ranks."""
    r = list(r)
    return [1] + r + [1] if len(r) == len(p) - 1 else r


def segment_spans(runs: torch.Tensor, nseg: int, seg: int):
    """``(first, cnt)`` int32 ``[..., nseg]``: the first span (``runs[...,
    j] .. runs[..., j+1]``) that meets each ``seg``-row segment, and how
    many do, for each row of ``runs [..., rstride]``."""
    seg_starts = (torch.arange(nseg, dtype=torch.int32, device=runs.device)
                  * seg).expand(*runs.shape[:-1], nseg).contiguous()
    first = torch.searchsorted(runs, seg_starts, right=True,
                               out_int32=True) - 1
    last = torch.searchsorted(runs, seg_starts + (seg - 1), right=True,
                              out_int32=True) - 1
    return first, last - first + 1


def generic_available(tt_p_shapes, tt_q_shapes, tt_ranks, num_tables: int,
                      batch_size: int) -> bool:
    """Whether the generic kernels take this config: tt_ndim 2-4, one
    lookup's chain (its states and largest gradient tile) within the
    kernels' shared memory, and core rows and pooled rows within int32."""
    ndim = len(tt_p_shapes)
    if ndim not in (2, 3, 4) or len(tt_q_shapes) != ndim:
        return False
    q = tuple(tt_q_shapes)
    r = tuple(full_ranks(tt_p_shapes, tt_ranks))
    if len(r) != ndim + 1:
        return False
    if num_tables * batch_size > _I32_MAX or \
            num_tables * max(tt_p_shapes) + 2 > _I32_MAX:
        return False
    return fwd_chunk(q, r) is not None and bwd_chunk(q, r) is not None


def block_inputs(idx_parts, rowidx, tableidx, weights, live_count,
                 tt_p_shapes, num_tables: int, batch_size: int,
                 dead_mask: Optional[torch.Tensor] = None):
    """``(idx [ndim, nnz] int32, rowv [nnz] int32, weights float32 or
    None)`` for the kernels: core rows ``t*p_t + i_t`` and pooled rows
    ``t*B + b``; a lookup at a position ``>= live_count`` or marked in
    ``dead_mask`` gets ``rowv = -1``."""
    i32 = torch.int32
    parts = [p_.to(i32) for p_ in idx_parts]
    if tableidx is not None and num_tables > 1:
        t32 = tableidx.to(i32)
        parts = [p_ + t32 * p for p_, p in zip(parts, tt_p_shapes)]
        rowv = rowidx.to(i32) + t32 * batch_size
    else:
        rowv = rowidx.to(i32)
    dev = rowv.device
    dead = None
    if dead_mask is not None:
        dead = dead_mask.to(device=dev, dtype=torch.bool)
    elif live_count is not None:
        pos = torch.arange(rowv.shape[0], dtype=i32, device=dev)
        dead = pos >= live_count.to(device=dev, dtype=i32).reshape(())
    if dead is not None:
        rowv = torch.where(dead, torch.full_like(rowv, -1), rowv)
    wv = None if weights is None else weights.to(torch.float32).contiguous()
    return torch.stack(parts).contiguous(), rowv.contiguous(), wv


def key_dtype(top: int) -> torch.dtype:
    """The narrowest sort key type that holds ``0 .. top``: the card's radix
    sort passes over every bit of the key's type, so a narrow key takes
    fewer passes."""
    if top < 2 ** 8:
        return torch.uint8
    return torch.int16 if top < 2 ** 15 else torch.int32


def bag_order(rowv: torch.Tensor, tb: int):
    """``(order, starts)`` int32: the lookups grouped by pooled row, each
    bag in lookup order (one stable sort; dead lookups last, in no bag),
    and bag ``b``'s range ``starts[b] .. starts[b+1]`` of ``order``."""
    kd = key_dtype(tb)
    key = torch.where(rowv >= 0, rowv, tb).to(kd)
    ks, order = torch.sort(key, stable=True)
    edges = torch.arange(tb + 1, dtype=kd, device=rowv.device)
    starts = torch.searchsorted(ks.contiguous(), edges, out_int32=True)
    return order.to(torch.int32), starts


def core_order(key: torch.Tensor, rowv: torch.Tensor, rows_t: int,
               rstride: Optional[int] = None, seg: int = SEG):
    """One core's sorted order: the lookups sorted stably by their core row
    ``key [nnz]`` (dead lookups and the padding up to whole segments take
    the sentinel row ``rows_t``), one stable sort. Returns ``order [nza]``
    and ``runs [rstride]`` (default ``rows_t + 2``; span j is ``runs[j] ..
    runs[j+1]``, the live lookups are ``order[:runs[rows_t]]``), int32."""
    nnz = key.shape[0]
    nza = -(-nnz // seg) * seg
    dev = key.device
    rstride = rstride or rows_t + 2
    kd = key_dtype(rstride - 1)
    k = torch.full((nza,), rows_t, dtype=kd, device=dev)
    k[:nnz] = torch.where(rowv >= 0, key, rows_t)
    ks, order = torch.sort(k, stable=True)
    edges = torch.arange(rstride, dtype=kd, device=dev)
    runs = torch.searchsorted(ks.contiguous(), edges, out_int32=True)
    return order.to(torch.int32), runs


def core1_order(idx: torch.Tensor, rowv: torch.Tensor, rows: Sequence[int],
                seg: int = SEG):
    """The orders of kernel B4's pivot cores, for its pivot path and, in a
    training step, kernel B5: core 1's :func:`core_order` with
    :func:`core_orders`' stride (``order [nza]``, ``runs [rstride]``); at
    tt_ndim 4 core 1's and core 2's, stacked (``[2, nza]``, ``[2,
    rstride]``)."""
    rstride = max(rows) + 2
    if idx.shape[0] == 4:
        per_core = [core_order(idx[t], rowv, rows[t], rstride, seg)
                    for t in (1, 2)]
        return tuple(torch.stack(x) for x in zip(*per_core))
    return core_order(idx[1], rowv, rows[1], rstride, seg)


def core_orders(idx: torch.Tensor, rowv: torch.Tensor, rows: Sequence[int],
                seg: int = SEG, core1=None):
    """The backward kernel's schedule: :func:`core_order` of every core t
    (sentinel row ``rows[t]``), stacked, and each core's segment spans:
    ``orders [ndim, nza]``, ``runs [ndim, max(rows) + 2]``, ``first``,
    ``cnt [ndim, nseg]`` (:func:`segment_spans`). ``core1``: the
    forward's orders and runs from :func:`core1_order` (core 1's, and at
    tt_ndim 4 core 2's), taken in place of their sorts."""
    rstride = max(rows) + 2
    given = {}
    if core1 is not None:
        ord1, runs1 = core1
        if ord1.dim() == 1:
            given[1] = core1
        else:
            given = {1 + k: (ord1[k], runs1[k])
                     for k in range(ord1.shape[0])}
    per_core = [given[t] if t in given
                else core_order(idx[t], rowv, rows[t], rstride, seg)
                for t in range(idx.shape[0])]
    orders, runs = (torch.stack(x) for x in zip(*per_core))
    return (orders, runs) + segment_spans(runs, orders.shape[1] // seg, seg)


def _kernel_cores(tt_cores, p, q, r):
    return tuple(g.to(torch.float32).contiguous()
                 for g in kernel_core_layouts(tt_cores, p, q, r))


def forward_lookups(tt_cores: Sequence[torch.Tensor], tt_p_shapes,
                    tt_q_shapes, tt_ranks, batch_size: int, lookups,
                    core1=None) -> torch.Tensor:
    """:func:`tt_forward_kernel` on the lookups :func:`block_inputs`
    prepared, ``(idx, rowv, weights)``; ``core1`` from :func:`core1_order`
    (else B4's wrapper sorts core 1 itself where its pivot pass runs)."""
    p, q = tuple(tt_p_shapes), tuple(tt_q_shapes)
    r = tuple(full_ranks(p, tt_ranks))
    t = tt_cores[0].shape[0]
    idx, rowv, wv = lookups
    order, starts = bag_order(rowv, t * batch_size)
    out = tt_fwd(_kernel_cores(tt_cores, p, q, r), idx, rowv, wv, order,
                 starts, core1=core1)
    return out.reshape(t, batch_size, math.prod(q))


def backward_lookups(tt_cores: Sequence[torch.Tensor], tt_p_shapes,
                     tt_q_shapes, tt_ranks, batch_size: int, lookups,
                     d_output: torch.Tensor,
                     core1=None) -> Tuple[torch.Tensor, ...]:
    """:func:`tt_backward_kernel` on the lookups :func:`block_inputs`
    prepared; ``core1`` from :func:`core1_order`, taken in place of
    sorting core 1 again."""
    p, q = tuple(tt_p_shapes), tuple(tt_q_shapes)
    r = tuple(full_ranks(p, tt_ranks))
    t = tt_cores[0].shape[0]
    idx, rowv, wv = lookups
    rows = [t * p_ for p_ in p]
    orders, runs, first, cnt = core_orders(idx, rowv, rows, SEG, core1)
    dout = d_output.reshape(t * batch_size, -1).to(torch.float32).contiguous()
    dgs = tt_bwd(_kernel_cores(tt_cores, p, q, r), idx, rowv, wv, dout,
                 orders, runs, first, cnt, seg=SEG)
    return grads_to_module_layout(dgs, p, q, r, t)


def tt_forward_kernel(tt_cores: Sequence[torch.Tensor], tt_p_shapes,
                      tt_q_shapes, tt_ranks, batch_size: int,
                      idx_parts: Sequence[torch.Tensor], rowidx: torch.Tensor,
                      tableidx: Optional[torch.Tensor] = None,
                      weights: Optional[torch.Tensor] = None,
                      live_count: Optional[torch.Tensor] = None,
                      dead_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Pooled forward ``[num_tables, B, D]`` (float32) through kernel B4
    (its plain version on CPU tensors). ``live_count`` ([1]): lookups at
    later positions add nothing; ``dead_mask`` ([nnz] bool) marks such
    lookups in place."""
    lookups = block_inputs(idx_parts, rowidx, tableidx, weights, live_count,
                           tt_p_shapes, tt_cores[0].shape[0], batch_size,
                           dead_mask)
    return forward_lookups(tt_cores, tt_p_shapes, tt_q_shapes, tt_ranks,
                           batch_size, lookups)


def tt_backward_kernel(tt_cores: Sequence[torch.Tensor], tt_p_shapes,
                       tt_q_shapes, tt_ranks, batch_size: int,
                       idx_parts: Sequence[torch.Tensor],
                       rowidx: torch.Tensor, d_output: torch.Tensor,
                       tableidx: Optional[torch.Tensor] = None,
                       weights: Optional[torch.Tensor] = None,
                       live_count: Optional[torch.Tensor] = None,
                       dead_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """Core gradients in module layout for ``d_output [T, B, D]``, through
    kernel B5 (its plain version on CPU tensors); ``live_count`` and
    ``dead_mask`` as in :func:`tt_forward_kernel`."""
    lookups = block_inputs(idx_parts, rowidx, tableidx, weights, live_count,
                           tt_p_shapes, tt_cores[0].shape[0], batch_size,
                           dead_mask)
    return backward_lookups(tt_cores, tt_p_shapes, tt_q_shapes, tt_ranks,
                            batch_size, lookups, d_output)
