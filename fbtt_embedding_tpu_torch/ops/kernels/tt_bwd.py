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

On a CUDA tensor :func:`tt_bwd` launches the hand-written kernels of
``csrc/tt_bwd.cu`` on one of two paths (:func:`bwd_path` with ``card``:
the library's ``fbtt_tt_bwd_path``), or raises. The pivot pass (tt_ndim 2
and 3, where the middle core's slab stages in shared memory) runs over
core 1's sorted order in even shares, one CTA each, stages each span's
slab ``G_1[j]`` once and runs the span's three products with it as 3xTF32
tensor-core GEMMs (float32 accuracy); the end cores' per-lookup slabs go
through a scratch buffer and are added per 32-row chunk of their own
core's order. The chain pass (tt_ndim 4, and configs the pivot pass
cannot stage) runs each lookup's chain once per core. Both write one
partial gradient tile per (chunk of a core's order, span), added per core
row in chunk order: no float atomics, bitwise repeatable. One count in
``tt_bwd.launches`` per call. On a CPU tensor it runs :func:`tt_bwd_plain`, which ignores the schedule;
:func:`tt_bwd_pivot_plain` follows the pivot pass's schedule step by step
(for the tests).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from fbtt_embedding_tpu_torch.ops.kernels.tt_fwd import (
    _SMEM_MAX,
    _aligned,
    _sm_count,
    chain_dims,
    chain_rows,
    chunk_for,
    check_device,
    check_int32,
    check_lookups,
    live_inputs,
    pivot_sub,
    state_floats,
)


# the pivot pass's rule in Python, for code that runs on the CPU (the
# library's fbtt_tt_bwd_path decides on the card): sub-chunks of at most
# PIVOT_CHUNK_MAX lookups, the largest multiple of 4 whose shared memory is
# within _PIVOT_SMEM_PREF, else 4 within _SMEM_MAX, and whose loop indices
# stay below _INDEX_MAX (the kernel's fast division); dG_1 in 16 x 8 tensor-core
# tiles, at most _TILES_MAX a warp of the _WARPS of a CTA
PIVOT_CHUNK_MAX = 16
END_CHUNK = 32  # kEndChunk: rows per chunk of the end cores' sums
_PIVOT_SMEM_PREF = 100 * 1024
_TILES_MAX = 16
_INDEX_MAX = 1 << 16
_THREADS = 256
_WARPS = _THREADS // 32
_RED_FLOATS = _WARPS * 128


def _tiles_per_warp(q, r) -> int:
    """16 x 8 tiles of dG_1 per warp of the pivot pass (a power of two)."""
    tiles = (r[1] // 16) * (q[1] * r[2] // 8)
    tpw = 1
    while tpw * _WARPS < tiles:
        tpw *= 2
    return tpw


def pivot_chunk(q, r) -> int:
    """Lookups per sub-chunk of the pivot pass for chain dims ``q`` and full
    ranks ``r``, or 0 where it does not take them (the rule of the library's
    ``fbtt_tt_bwd_path``, for code that runs on the CPU):
    tt_ndim 2 or 3, ``r_1`` a multiple of 16 and ``q_1 r_2`` of 8 (the
    tensor cores' tiles), D and at tt_ndim 3 ``r_2`` multiples of 4, and the
    pivot slab within the warps' registers (a warp's tiles in one row of
    tiles) and shared memory."""
    ndim = len(q)
    if ndim not in (2, 3):
        return 0
    m0, rk, w, d = q[0], r[1], q[1] * r[2], math.prod(q)
    r2, q2 = (r[2], q[2]) if ndim == 3 else (1, 1)
    if rk % 16 or w % 8 or d % 4 or (ndim == 3 and r2 % 4):
        return 0
    gs, zs = w + 4, rk + 4
    tpw = _tiles_per_warp(q, r)
    if tpw > _TILES_MAX or (w // 8) % tpw or rk * gs >= _INDEX_MAX:
        return 0

    def fits(lc, limit):
        rows = -(-lc * m0 // 16) * 16
        per = d + r2 * q2 if ndim == 3 else 0
        smem = 4 * (rk * gs + rows * (zs + gs) + _RED_FLOATS + lc * per)
        return (smem <= limit and rows * gs < _INDEX_MAX
                and lc * (d + r2 * q2) < _INDEX_MAX)

    for lc in range(PIVOT_CHUNK_MAX, 0, -4):
        if fits(lc, _PIVOT_SMEM_PREF):
            return lc
    return 4 if fits(4, _SMEM_MAX) else 0


@functools.lru_cache(maxsize=None)
def _bwd_path(q, r, card) -> Optional[Tuple[str, int, int]]:
    if card:
        per_sm = ctypes.c_int(0)
        pad = [1] * (4 - len(q))
        lc = _lib().fbtt_tt_bwd_path(len(q), *q, *pad, *r[1:-1], *pad,
                                     ctypes.byref(per_sm))
        per_sm = per_sm.value
    else:
        lc = pivot_chunk(q, r)
        per_sm = 2 if _tiles_per_warp(q, r) <= 4 else 1
    if lc:
        return "pivot", lc, per_sm
    tile = max(r[t] * q[t] * r[t + 1] for t in range(len(q)))
    lc = chunk_for(3 * state_floats(q, r), tile)
    return None if lc is None else ("chain", lc, 0)


def bwd_path(q, r, card: bool = False) -> Optional[Tuple[str, int, int]]:
    """``("pivot", lc, ctas_per_sm)`` or ``("chain", lc, 0)``: the path the
    kernel takes on these chain dims and full ranks, its chunk of lookups
    and the pivot CTAs an SM holds at once, or None where neither stages
    one lookup in shared memory. With ``card`` the pivot pass's terms come
    from the kernel library (``fbtt_tt_bwd_path``, asked once per shape),
    as the launch uses them; without, from :func:`pivot_chunk`, the same
    rule in Python for code that runs on the CPU."""
    return _bwd_path(tuple(q), tuple(r), card)


def bwd_chunk(q, r) -> Optional[int]:
    """The backward kernel's chunk on the path it takes: the pivot pass's
    sub-chunk, else the chain pass's (three states per lookup and the
    largest gradient tile)."""
    path = bwd_path(q, r)
    return None if path is None else path[1]


def core_chunks(pivot: bool, ndim: int, seg: int, sub: int):
    """Rows of each core's sorted order per chunk of its partial tiles
    (tile ``c + j`` is chunk ``c``'s sum of span ``j``): on the pivot pass
    ``sub`` for core 1 and END_CHUNK for the end cores, else ``seg``."""
    if not pivot:
        return [seg] * ndim
    return [sub if t == 1 else END_CHUNK for t in range(ndim)]


def partial_floats(pivot: bool, nza: int, rows, tiles, seg: int,
                   sub: int) -> int:
    """Floats of the kernels' partial tiles: ``ceil(nza / chunk_t) + rows_t``
    tiles per core (:func:`core_chunks`)."""
    return sum((-(-nza // ch) + n) * tile for ch, n, tile in zip(
        core_chunks(pivot, len(rows), seg, sub), rows, tiles))


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


def tt_bwd_pivot_plain(gk, idx, rowv, weights, dout, orders, runs, first,
                       cnt, *, seg, lc=None, sub=None):
    """Plain PyTorch model of the pivot pass's schedule (tt_ndim 2 and 3),
    step by step, for the tests: core 1's order is cut into chunks of
    ``sub`` rows (default ``seg // 2``); chunk ``c`` takes each span ``j``
    that meets it in sub-chunks of ``lc`` lookups and writes the sum of
    ``z_0^T dz_1`` as partial tile ``c + j``; the end cores' per-lookup
    slabs (dz_0, and ``z_1^T dz_2`` at tt_ndim 3) are summed per span in
    each chunk of END_CHUNK rows of their own core's order, into tile ``c +
    j`` of that core; each core row's tiles are then added in chunk order.
    Dead lookups (the sentinel span) are never visited. Raises
    AssertionError where a tile is written twice, or a tile the reduction
    reads, or a slab an end core reads, was never written."""
    del first, cnt  # the chain pass's span tables
    q, r = chain_dims(gk)
    ndim, nnz, nza = len(q), idx.shape[1], orders.shape[1]
    if ndim not in (2, 3):
        raise ValueError(f"the pivot pass takes tt_ndim 2 and 3, got {ndim}")
    lc = lc or pivot_chunk(q, r) or PIVOT_CHUNK_MAX
    chunks = core_chunks(True, ndim, seg, sub or max(1, seg // 2))
    rows = [int(g.shape[0]) for g in gk]
    tiles = [r[t] * q[t] * r[t + 1] for t in range(ndim)]
    m0, rk, w = q[0], r[1], q[1] * r[2]
    wts = (weights.float() if weights is not None
           else torch.ones(nnz, dtype=torch.float32, device=idx.device))
    dout = dout.float()
    idx_l, row_l = idx.long(), rowv.long()
    orders_l, runs_l = orders.long(), runs.long()
    nan = float("nan")
    scratch = {0: torch.full((nnz, m0 * rk), nan)}
    if ndim == 3:
        scratch[2] = torch.full((nnz, r[2] * q[2]), nan)
    part = {t: {} for t in range(ndim)}

    def put(t, slot, tile):
        assert slot not in part[t], f"core {t}: tile {slot} written twice"
        part[t][slot] = tile

    def pieces(t):
        """(c, j, st, en): span j's rows in chunk c of core t's order."""
        rn, cs = runs_l[t], chunks[t]
        for c in range(-(-nza // cs)):
            lo, hi = c * cs, min(c * cs + cs, nza)
            for j in range(rows[t]):
                st, en = max(int(rn[j]), lo), min(int(rn[j + 1]), hi)
                if en > st:
                    yield c, j, st, en

    for c, j, st, en in pieces(1):
        g = gk[1][j].reshape(rk, w).float()
        acc = torch.zeros((rk, w), dtype=torch.float32)
        for cb in range(st, en, lc):
            lk = orders_l[1][cb:min(cb + lc, en)]
            n = lk.numel()
            z0 = gk[0][idx_l[0, lk]].reshape(n * m0, rk).float()
            rowcot = wts[lk, None] * dout[row_l[lk]]
            if ndim == 3:
                dz2 = rowcot.reshape(n, q[0] * q[1], q[2])
                g2 = gk[2][idx_l[2, lk]].reshape(n, r[2], q[2]).float()
                dz1 = torch.bmm(dz2, g2.transpose(1, 2))
            else:
                dz1 = rowcot
            dz1 = dz1.reshape(n * m0, w)
            acc = acc + z0.T @ dz1
            scratch[0][lk] = (dz1 @ g.T).reshape(n, m0 * rk)
            if ndim == 3:
                z1 = (z0 @ g).reshape(n, q[0] * q[1], r[2])
                scratch[2][lk] = torch.bmm(z1.transpose(1, 2),
                                           dz2).reshape(n, -1)
        put(1, c + j, acc)
    for t in scratch:
        for c, j, st, en in pieces(t):
            slabs = scratch[t][orders_l[t][st:en]]
            assert not torch.isnan(slabs).any(), \
                f"core {t}: a slab of span {j} was never written"
            put(t, c + j, slabs.sum(0))
    grads = []
    for t in range(ndim):
        cs = chunks[t]
        out = torch.zeros((rows[t], tiles[t]), dtype=torch.float32)
        for j in range(rows[t]):
            st, en = int(runs_l[t][j]), int(runs_l[t][j + 1])
            for c in range(st // cs, (en - 1) // cs + 1 if en > st else 0):
                assert c + j in part[t], f"core {t}: tile {c + j} never written"
                out[j] += part[t][c + j].reshape(tiles[t])
        grads.append(out)
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


def tt_bwd(gk, idx, rowv, weights, dout, orders, runs, first, cnt, *, seg):
    """Core gradients, one ``[T*p_t, r_t*q_t*r_{t+1}]`` float32 tensor per
    core — see the module docstring."""
    _check(gk, idx, rowv, weights, dout, orders, runs, first, cnt, seg)
    dev = idx.device
    if dev.type == "cpu":
        return tt_bwd_plain(gk, idx, rowv, weights, dout, orders, runs, first,
                            cnt, seg=seg)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        grads = _launch(gk, idx, rowv, weights, dout, orders, runs, first,
                        cnt, seg, stream)
    tt_bwd.launches += 1
    return grads


def _launch(gk, idx, rowv, weights, dout, orders, runs, first, cnt, seg,
            stream):
    """Allocate the outputs and scratch, launch the kernels of
    ``csrc/tt_bwd.cu`` on ``stream`` and return the core gradients; raises
    on a refused launch. The inputs are checked by :func:`tt_bwd`."""
    q, r = chain_dims(gk)
    path = bwd_path(q, r, card=True)
    if path is None:
        raise ValueError(f"tt_bwd: q={q}, ranks={r}: one lookup's states "
                         f"pass the kernel's {_SMEM_MAX} bytes of shared "
                         "memory")
    pivot = path[0] == "pivot"
    ndim, nnz, nseg = len(q), idx.shape[1], first.shape[1]
    dev = idx.device
    rows = [int(g.shape[0]) for g in gk]
    tiles = [r[t] * q[t] * r[t + 1] for t in range(ndim)]
    nza = orders.shape[1]
    sub = (pivot_sub(nza, path[2], _sm_count(dev.index or 0)) if pivot
           else seg)
    partial = torch.empty(partial_floats(pivot, nza, rows, tiles, seg, sub),
                          dtype=torch.float32, device=dev)
    flat = torch.empty(sum(rows[t] * tiles[t] for t in range(ndim)),
                       dtype=torch.float32, device=dev)
    if pivot:
        gk = [_aligned(t) for t in gk]
        dout = _aligned(dout)
        # the end cores' per-lookup slabs: core 0, then the last at tt_ndim 3
        scratch = torch.empty(nnz * (tiles[0] + (tiles[2] if ndim == 3
                                                 else 0)),
                              dtype=torch.float32, device=dev)
        gts = []
    else:
        scratch = None
        # the backward steps read each core transposed, [T*p, q*r', r]
        gts = [t.transpose(1, 2).contiguous() for t in gk[1:]]
    g = [t.data_ptr() for t in gk] + [None] * (4 - ndim)
    gt = [t.data_ptr() for t in gts] + [None] * (3 - len(gts))
    qa = list(q) + [1] * (4 - ndim)
    ra = list(r[1:-1]) + [1] * (4 - ndim)
    lib = _lib()
    err = lib.fbtt_tt_bwd(
        *g, *gt, idx.data_ptr(),
        weights.data_ptr() if weights is not None else None,
        rowv.data_ptr(), dout.data_ptr(), orders.data_ptr(), runs.data_ptr(),
        first.data_ptr(), cnt.data_ptr(), partial.data_ptr(), flat.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, ndim, nnz,
        nza, nseg, seg, runs.shape[1], *qa, *ra,
        *(rows + [0] * (4 - ndim)), path[1], state_floats(q, r), int(pivot),
        sub, stream)
    if err != 0:
        raise RuntimeError("tt_bwd launch failed: "
                           + lib.fbtt_error_string(err).decode())
    return tuple(t.reshape(rows[i], tiles[i]) for i, t in enumerate(
        flat.split([rows[i] * tiles[i] for i in range(ndim)])))


tt_bwd.launches = 0


def _lib():
    from fbtt_embedding_tpu_torch.ops.kernels._build import library

    lib = library("tt_bwd")
    if lib.fbtt_tt_bwd.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.fbtt_tt_bwd.argtypes = [p] * 18 + [i] * 21 + [p]
        lib.fbtt_tt_bwd.restype = ctypes.c_int
        lib.fbtt_tt_bwd_path.argtypes = [i] * 8 + [ctypes.POINTER(i)]
        lib.fbtt_tt_bwd_path.restype = ctypes.c_int
        lib.fbtt_error_string.argtypes = [ctypes.c_int]
        lib.fbtt_error_string.restype = ctypes.c_char_p
    return lib
