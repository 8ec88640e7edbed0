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
the library's ``fbtt_tt_bwd_path``), or raises. The pivot path (tt_ndim 2
and 3 where the middle core's slab stages, tt_ndim 4 where both its
passes do) runs over core 1's sorted order in even shares, one CTA each,
stages each span's slab ``G_1[j]`` once and runs the span's three
products with it as 3xTF32 tensor-core GEMMs (float32 accuracy); the end
cores' per-lookup slabs go through a scratch buffer and are added per
32-row chunk of their own core's order. At tt_ndim 4 the forward's head
pass first writes ``z_1`` by lookup, a pass over core 2's order takes it
(``dG_2`` in tiles, ``dz_1`` by lookup, the last core's slabs), and the
pass over core 1's order takes its ``dz_1`` from there. The chain pass
(configs the pivot path cannot stage, e.g. tt_ndim 4 with ranks not
multiples of 16) runs each lookup's chain once per core. Both write one
partial gradient tile per (chunk of a core's order, span), added per core
row in chunk order: no float atomics, bitwise repeatable. One count in
``profiling``'s ``launches.tt_bwd`` per call. On a CPU tensor it runs
:func:`tt_bwd_plain`, which ignores the schedule; :func:`tt_bwd_pivot_plain`
follows the pivot path's schedule step by step (for the tests).
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
    fwd_pivot_chunk,
    live_inputs,
    pivot_passes,
    pivot_sub,
    state_floats,
)
from fbtt_embedding_tpu_torch.utils import profiling


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
    """16 x 8 tiles of dG_1 per warp of the pivot pass (a power of two); at
    tt_ndim 4 the most of its two passes'."""
    if len(q) == 4:
        return max(_tiles_per_warp(*pq) for pq in pivot_passes(q, r))
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
    tiles) and shared memory; at tt_ndim 4 the same of both passes
    (``tt_fwd.pivot_passes``: the tail over core 2's order, the head over
    core 1's), at the least of their sub-chunks, and the forward's rule of
    the head (whose pass writes ``z_1``)."""
    ndim = len(q)
    if ndim == 4:
        head, tail = pivot_passes(q, r)
        if not fwd_pivot_chunk(*head):
            return 0
        return min(pivot_chunk(*head), pivot_chunk(*tail))
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
    (tile ``c + j`` is chunk ``c``'s sum of span ``j``): on the pivot path
    ``sub`` for the pivot cores (core 1, and core 2 at tt_ndim 4) and
    END_CHUNK for the end cores, else ``seg``."""
    if not pivot:
        return [seg] * ndim
    return [sub if t == 1 or 1 < t < ndim - 1 else END_CHUNK
            for t in range(ndim)]


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
    """Plain PyTorch model of the pivot path's schedule, step by step, for
    the tests: core 1's order is cut into chunks of ``sub`` rows (default
    ``seg // 2``); chunk ``c`` takes each span ``j`` that meets it in
    sub-chunks of ``lc`` lookups and writes the sum of ``z_0^T dz_1`` as
    partial tile ``c + j``; the end cores' per-lookup slabs (dz_0, and the
    last core's ``z^T dz`` at tt_ndim 3 and 4) are summed per span in each
    chunk of END_CHUNK rows of their own core's order, into tile ``c + j``
    of that core; each core row's tiles are then added in chunk order. At
    tt_ndim 4 the forward's head pass first writes ``z_1`` by lookup; a
    pass over core 2's order (chunks of ``sub`` rows) takes it, adds
    ``z_1^T dz_2`` into core 2's tiles and writes ``dz_1`` by lookup and
    the last core's slabs; the pass over core 1's order then takes its
    ``dz_1`` from there. Dead lookups (the sentinel span) are never
    visited. Raises AssertionError where a tile or a buffer row is written
    twice, or a tile the reduction reads, a slab an end core reads, or a
    buffer row a pass reads, was never written."""
    del first, cnt  # the chain pass's span tables
    q, r = chain_dims(gk)
    ndim, nnz, nza = len(q), idx.shape[1], orders.shape[1]
    lc = lc or pivot_chunk(q, r) or PIVOT_CHUNK_MAX
    chunks = core_chunks(True, ndim, seg, sub or max(1, seg // 2))
    rows = [int(g.shape[0]) for g in gk]
    tiles = [r[t] * q[t] * r[t + 1] for t in range(ndim)]
    wts = (weights.float() if weights is not None
           else torch.ones(nnz, dtype=torch.float32, device=idx.device))
    dout = dout.float()
    idx_l, row_l = idx.long(), rowv.long()
    orders_l, runs_l = orders.long(), runs.long()
    nan = float("nan")
    last = ndim - 1
    scratch = {0: torch.full((nnz, q[0] * r[1]), nan)}
    if ndim > 2:
        scratch[last] = torch.full((nnz, tiles[last]), nan)
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

    def gather(t, lk, shape):
        return gk[t][idx_l[t, lk]].reshape(shape).float()

    def by_lookup(buf, lk, shape):
        got = buf[lk]
        assert not torch.isnan(got).any(), "a buffer row read unwritten"
        return got.reshape(shape)

    def pivot_pass(t, m_in, z_in, dz_piv, dz_in_out):
        """Core t's pass: for each piece, ``dG_t[j] += z_{t-1}^T dz_t`` over
        its sub-chunks (``z_in(lk)``: ``[n m_in, r_t]``; ``dz_piv(lk, z)``:
        ``[n m_in, q_t r_{t+1}]``, given ``z_t`` by items where a last core
        follows), and ``dz_{t-1} = dz_t G_t[j]^T`` by lookup into
        ``dz_in_out``."""
        rk, w = r[t], q[t] * r[t + 1]
        for c, j, st, en in pieces(t):
            g = gk[t][j].reshape(rk, w).float()
            acc = torch.zeros((rk, w), dtype=torch.float32)
            for cb in range(st, en, lc):
                lk = orders_l[t][cb:min(cb + lc, en)]
                n = lk.numel()
                z = z_in(lk)
                dz = dz_piv(lk, z @ g).reshape(n * m_in, w)
                acc = acc + z.T @ dz
                out = (dz @ g.T).reshape(n, m_in * rk)
                assert torch.isnan(dz_in_out[lk]).all(), \
                    f"core {t}: a buffer row written twice"
                dz_in_out[lk] = out
            put(t, c + j, acc)

    def through_last(lk, z):
        """``dz`` before the last core from ``w * dout[b]``, and the last
        core's slab ``z^T dz_last`` by lookup (``z``: the pivot's product,
        ``[n m_{n-2}, ...]``)."""
        n = lk.numel()
        m = math.prod(q[:last])
        dzl = (wts[lk, None] * dout[row_l[lk]]).reshape(n, m, q[last])
        gl = gather(last, lk, (n, r[last], q[last]))
        scratch[last][lk] = torch.bmm(z.reshape(n, m, r[last]).transpose(
            1, 2), dzl).reshape(n, -1)
        return torch.bmm(dzl, gl.transpose(1, 2))

    m0 = q[0]

    def z0_of(lk):
        return gather(0, lk, (lk.numel() * m0, r[1]))

    if ndim == 4:
        m1, zf = q[0] * q[1], q[0] * q[1] * r[2]
        z1buf = torch.full((nnz, zf), nan)
        for c, j, st, en in pieces(1):  # the forward's head pass
            lk = orders_l[1][st:en]
            assert torch.isnan(z1buf[lk]).all(), "z_1 written twice"
            z1buf[lk] = (z0_of(lk) @ gk[1][j].reshape(r[1], -1).float()
                         ).reshape(lk.numel(), zf)
        dz1buf = torch.full((nnz, zf), nan)
        pivot_pass(2, m1, lambda lk: by_lookup(z1buf, lk,
                                               (lk.numel() * m1, r[2])),
                   through_last, dz1buf)
        pivot_pass(1, m0, z0_of,
                   lambda lk, z: by_lookup(dz1buf, lk, (lk.numel(), -1)),
                   scratch[0])
    elif ndim == 3:
        pivot_pass(1, m0, z0_of, through_last, scratch[0])
    else:
        pivot_pass(1, m0, z0_of,
                   lambda lk, z: wts[lk, None] * dout[row_l[lk]], scratch[0])
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
    profiling.count("launches.tt_bwd")
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
        # the end cores' per-lookup slabs: core 0, then the last at tt_ndim
        # 3 and 4; at tt_ndim 4 then z_1 and dz_1 by lookup
        per = tiles[0] + (tiles[-1] if ndim > 2 else 0)
        if ndim == 4:
            per += 2 * q[0] * q[1] * r[2]
        scratch = torch.empty(nnz * per, dtype=torch.float32, device=dev)
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
