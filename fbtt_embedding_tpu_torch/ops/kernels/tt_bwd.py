"""Per-lookup TT core gradients: the generic backward kernel (B5).

Counterpart of ``fbtt_embedding_tpu/ops/pallas/tt_kernel.py ::
_make_bwd_call`` (through ``tt_backward_pallas``). Every lookup ``l`` with
a pooled row ``rowv[l] >= 0`` takes the cotangent ``w_l * dout[rowv[l]]``
of its row back through its TT chain and adds, for every core ``t``, the
slab ``z_{t-1}^T dz_t`` into row ``i_t`` of that core's gradient
(float32, ``[T*p_t, r_t*q_t*r_{t+1}]``: the module layout with the table
dim folded in). Lookups with ``rowv = -1`` add nothing; a core row no
lookup touched gets zeros.

Arguments: those of ``tt_fwd`` (``gk``, ``idx``, ``rowv``, ``weights``),
``dout [tb, D]`` float32, and the schedule, per core ``t``: ``orders
[ndim, nza]`` the lookups sorted stably by their core-``t`` row (dead ones
last, padded to ``nza = nseg * seg``), ``runs [ndim, rstride]`` the span
starts and ``first`` / ``cnt [ndim, nseg]`` the spans of each ``seg``-row
segment (``tt_kernel.core_orders``).

On a CUDA tensor :func:`tt_bwd` launches the two hand-written kernels of
``csrc/tt_bwd.cu`` (segment-parallel partial gradient tiles, added per
core row in segment order: no float atomics, bitwise repeatable; one
count in ``tt_bwd.launches`` per call), after making the transposed core
copies its backward steps read, or raises. On a CPU tensor it runs
:func:`tt_bwd_plain`, which ignores the schedule.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from fbtt_embedding_tpu_torch.ops.kernels.tt_fwd import (
    _SMEM_MAX,
    chain_rows,
    chunk_for,
    check_device,
    check_int32,
    check_lookups,
    live_inputs,
    state_floats,
)


def bwd_chunk(q, r) -> Optional[int]:
    """The backward kernel's chunk: three states per lookup and the largest
    gradient tile."""
    tile = max(r[t] * q[t] * r[t + 1] for t in range(len(q)))
    return chunk_for(3 * state_floats(q, r), tile)


def tt_bwd_plain(gk, idx, rowv, weights, dout, orders, runs, first, cnt, *,
                 seg):
    """Plain PyTorch version: the chain's states from gathered slabs, the
    cotangents back through batched ``torch.matmul``, and every core's
    per-lookup slabs reduced by row with ``index_add_``, float32."""
    del orders, runs, first, cnt, seg  # the kernel's schedule
    q, r = check_lookups("tt_bwd_plain", gk, idx, rowv, weights)
    ndim, nnz = len(q), idx.shape[1]
    live, idx = live_inputs(idx, rowv)
    scale = live.float()
    if weights is not None:
        scale = scale * weights.float()
    dz = dout.float()[rowv.clamp(min=0).long()] * scale[:, None]
    states = chain_rows(gk, idx, q, r)
    grads = [None] * ndim
    m = [1]
    for qq in q:
        m.append(m[-1] * qq)  # m[t + 1] = q_0 * .. * q_t
    for t in range(ndim - 1, 0, -1):
        w = q[t] * r[t + 1]
        x = states[t - 1].reshape(nnz, m[t], r[t])
        y = dz.reshape(nnz, m[t], w)
        slab = torch.bmm(x.transpose(1, 2), y).reshape(nnz, r[t] * w)
        grads[t] = torch.zeros((gk[t].shape[0], r[t] * w),
                               dtype=torch.float32, device=dz.device)
        grads[t].index_add_(0, idx[t].long(), slab)
        g = gk[t][idx[t].long()].reshape(nnz, r[t], w).float()
        dz = torch.bmm(y, g.transpose(1, 2))  # [nnz, m_{t-1}, r_t]
    grads[0] = torch.zeros((gk[0].shape[0], q[0] * r[1]), dtype=torch.float32,
                           device=dz.device)
    grads[0].index_add_(0, idx[0].long(), dz.reshape(nnz, q[0] * r[1]))
    return tuple(grads)


def _check(gk, idx, rowv, weights, dout, orders, runs, first, cnt, seg):
    q, r = check_lookups("tt_bwd", gk, idx, rowv, weights)
    ndim, nnz = len(q), idx.shape[1]
    d = math.prod(q)
    if dout.dtype != torch.float32 or dout.dim() != 2 or dout.shape[1] != d:
        raise ValueError(f"tt_bwd: dout must be float32 [tb, {d}], got "
                         f"{dout.dtype} {tuple(dout.shape)}")
    nseg = first.shape[1] if first.dim() == 2 else -1
    check_int32("tt_bwd", "first", first, (ndim, max(nseg, 0)))
    check_int32("tt_bwd", "cnt", cnt, (ndim, nseg))
    if seg < 1 or nseg * seg < nnz:
        raise ValueError(f"tt_bwd: {nseg} segments of {seg} rows cannot hold "
                         f"{nnz} lookups")
    check_int32("tt_bwd", "orders", orders, (ndim, nseg * seg))
    need = max(g.shape[0] for g in gk) + 2
    if (runs.dtype != torch.int32 or runs.dim() != 2 or runs.shape[0] != ndim
            or runs.shape[1] < need):
        raise ValueError(f"tt_bwd: runs must be int32 [{ndim}, >= {need}], "
                         f"got {runs.dtype} {tuple(runs.shape)}")
    tensors = [*gk, idx, rowv, dout, orders, runs, first, cnt] + (
        [weights] if weights is not None else [])
    check_device("tt_bwd", tensors)
    return q, r, nseg


def tt_bwd(gk, idx, rowv, weights, dout, orders, runs, first, cnt, *, seg):
    """Core gradients, one ``[T*p_t, r_t*q_t*r_{t+1}]`` float32 tensor per
    core — see the module docstring."""
    q, r, nseg = _check(gk, idx, rowv, weights, dout, orders, runs, first,
                        cnt, seg)
    dev = idx.device
    if dev.type == "cpu":
        return tt_bwd_plain(gk, idx, rowv, weights, dout, orders, runs, first,
                            cnt, seg=seg)
    lc = bwd_chunk(q, r)
    if lc is None:
        raise ValueError(f"tt_bwd: q={q}, ranks={r}: one lookup's states "
                         f"pass the kernel's {_SMEM_MAX} bytes of shared "
                         "memory")
    ndim = len(q)
    rows = [int(g.shape[0]) for g in gk]
    tiles = [r[t] * q[t] * r[t + 1] for t in range(ndim)]
    partial = torch.empty(sum((nseg + rows[t]) * tiles[t]
                              for t in range(ndim)), dtype=torch.float32,
                          device=dev)
    flat = torch.empty(sum(rows[t] * tiles[t] for t in range(ndim)),
                       dtype=torch.float32, device=dev)
    g = [t.data_ptr() for t in gk] + [None] * (4 - ndim)
    # the backward steps read each core transposed, [T*p, q*r', r]
    gts = [t.transpose(1, 2).contiguous() for t in gk[1:]]
    gt = [t.data_ptr() for t in gts] + [None] * (4 - ndim)
    qa = list(q) + [1] * (4 - ndim)
    ra = list(r[1:-1]) + [1] * (4 - ndim)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fbtt_tt_bwd(
            *g, *gt, idx.data_ptr(),
            weights.data_ptr() if weights is not None else None,
            rowv.data_ptr(), dout.data_ptr(), orders.data_ptr(),
            runs.data_ptr(), first.data_ptr(), cnt.data_ptr(),
            partial.data_ptr(), flat.data_ptr(), ndim, idx.shape[1],
            orders.shape[1], nseg, seg, runs.shape[1], *qa, *ra,
            *(rows + [0] * (4 - ndim)), lc, state_floats(q, r), stream)
    if err != 0:
        raise RuntimeError("tt_bwd launch failed: "
                           + lib.fbtt_error_string(err).decode())
    tt_bwd.launches += 1
    return tuple(t.reshape(rows[i], tiles[i]) for i, t in enumerate(
        flat.split([rows[i] * tiles[i] for i in range(ndim)])))


tt_bwd.launches = 0


def _lib():
    from fbtt_embedding_tpu_torch.ops.kernels._build import library

    lib = library("tt_bwd")
    if lib.fbtt_tt_bwd.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.fbtt_tt_bwd.argtypes = [p] * 17 + [i] * 19 + [p]
        lib.fbtt_tt_bwd.restype = ctypes.c_int
        lib.fbtt_error_string.argtypes = [ctypes.c_int]
        lib.fbtt_error_string.restype = ctypes.c_char_p
    return lib
