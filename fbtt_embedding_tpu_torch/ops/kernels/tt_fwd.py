"""Pooled per-lookup TT forward: the generic forward kernel (B4).

Counterpart of ``fbtt_embedding_tpu/ops/pallas/tt_kernel.py ::
_make_fwd_call`` (through ``tt_forward_pallas``). Every lookup ``l`` with a
pooled row ``rowv[l] >= 0`` adds ``w_l * G_0[i_0] G_1[i_1] ... G_{n-1}[
i_{n-1}]`` (its TT chain, d-index in canonical digit order) into row
``rowv[l]`` of ``out [tb, D]`` (float32); lookups with ``rowv = -1``
(padding, dead) add nothing and an empty bag is exact zeros.

Arguments, shared by the kernel and its plain version: ``gk``, the kernel
core layouts (``kernel_core_layouts``: ``[T*p0, q0, r1]``, middle cores
``[T*p, r, q*r']``, the last ``[T*p, r, q]``, float32); ``idx [ndim, nnz]``
int32 core rows (offset by table); ``rowv [nnz]`` int32; ``weights [nnz]``
float32 or None; ``order [nnz]`` and ``starts [tb + 1]`` int32, the
lookups grouped by bag (``tt_kernel.bag_order``).

On a CUDA tensor :func:`tt_fwd` launches the hand-written kernels of
``csrc/tt_fwd.cu`` (its pivot passes in ``csrc/tt_fwd_pivot.cuh``) on one
of two paths (:func:`fwd_path` with ``card``: the library's
``fbtt_tt_fwd_path``), or raises. The pivot path (wherever the middle
cores' slabs stage in shared memory: tt_ndim 2 and 3, and tt_ndim 4 where
both its passes do) runs over the live rows of core 1's sorted order (the
keyword ``core1``: its order and span starts from
``tt_kernel.core1_order``, built by the wrapper where they are not given)
in even shares, one CTA each; a CTA takes its rows in groups of a few
spans, stages each span's slab ``G_1[j]`` and multiplies the span's
gathered ``z_0`` rows by it as 3xTF32 tensor-core GEMMs (float32
accuracy), writes each lookup's weighted row to a scratch buffer, and a
pool kernel adds each bag's rows in ``order``. At tt_ndim 4 that pass
runs on the head (cores 0-1) and writes ``z_1`` by lookup; a second pass
over core 2's order (``core1`` then holds cores 1 and 2) reads it, stages
``G_2[j]`` and fuses the last core (:func:`pivot_passes`). The chain pass
(configs the pivot path cannot stage, e.g. tt_ndim 4 with ``r_1`` not a
multiple of 8) runs one CTA per bag, which walks its lookups in chunks,
runs their chains in shared memory and sums the rows. Either way each
output row is written once, no atomics: bitwise repeatable. On a CPU
tensor it runs :func:`tt_fwd_plain`, which derives the bags from ``rowv``
and ignores ``order`` / ``starts`` / ``core1``; :func:`tt_fwd_pivot_plain`
follows the pivot path's schedule step by step (for the tests). Launches
are counted in ``tt_fwd.launches``, one per call.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

# the kernel picks its chunk of lookups within this much shared memory and
# takes one lookup at a time up to _SMEM_MAX (B2 and B3's limit)
_SMEM_BUDGET = 64 * 1024
_SMEM_MAX = 200 * 1024
MAX_CHUNK = 32  # kMaxChunk of csrc/tt_chain.cuh


def chain_dims(gk: Sequence[torch.Tensor]) -> Tuple[Tuple[int, ...],
                                                    Tuple[int, ...]]:
    """``(q, full ranks)`` read off the kernel core layouts; raises
    ValueError on layouts that do not chain."""
    ndim = len(gk)
    if not 2 <= ndim <= 4:
        raise ValueError(f"the generic kernels take tt_ndim 2-4, got {ndim}")
    if any(g.dim() != 3 for g in gk):
        raise ValueError("kernel core layouts must be 3-D, got "
                         f"{[tuple(g.shape) for g in gk]}")
    q, r = [int(gk[0].shape[1])], [1, int(gk[0].shape[2])]
    for t in range(1, ndim):
        if gk[t].shape[1] != r[t]:
            raise ValueError(f"core {t} has rank {gk[t].shape[1]}, the "
                             f"chain needs {r[t]}")
        r_next = int(gk[t + 1].shape[1]) if t + 1 < ndim else 1
        if gk[t].shape[2] % r_next:
            raise ValueError(f"core {t}'s width {gk[t].shape[2]} is not a "
                             f"multiple of the next rank {r_next}")
        q.append(int(gk[t].shape[2]) // r_next)
        r.append(r_next)
    return tuple(q), tuple(r)


def state_floats(q, r) -> int:
    """Floats of the largest per-lookup state, ``max_t m_t * r_{t+1}``."""
    m, zs = 1, 1
    for t in range(len(q)):
        m *= q[t]
        zs = max(zs, m * r[t + 1])
    return zs


def chunk_for(per_lookup: int, fixed: int) -> Optional[int]:
    """Lookups per chunk for a kernel whose shared memory is ``per_lookup *
    lc + fixed`` floats: the most within ``_SMEM_BUDGET`` (at most
    ``MAX_CHUNK``), else 1 within ``_SMEM_MAX``, else None."""
    lc = min(MAX_CHUNK, (_SMEM_BUDGET // 4 - fixed) // per_lookup)
    if lc >= 1:
        return lc
    return 1 if (per_lookup + fixed) * 4 <= _SMEM_MAX else None


# the pivot path's rule in Python, for code that runs on the CPU (the
# library's fbtt_tt_fwd_path decides on the card): groups of at most
# FWD_CHUNK_MAX lookups, the largest multiple of 4 whose shared memory is
# within _FWD_SMEM_PREF, else 4 within _SMEM_MAX, and whose loop indices
# stay below _INDEX_MAX (the constants of csrc/tt_fwd_pivot.cuh)
FWD_CHUNK_MAX = 16
_FWD_SMEM_PREF = 100 * 1024
_FWD_SMEM_THREE = 72 * 1024  # a CTA's shared memory where three fit an SM
_INDEX_MAX = 1 << 16  # kIndexMax of csrc/tt_mma.cuh: the kernels' fast division
_SLAB_BUDGET = 40 * 1024  # shared memory for a group's staged slabs
_SLABS_MAX = 8            # slabs (spans) a group holds at most
_GROUP_TILES = 64         # 16-row tiles of a group's product at most


def _slab_cols(w):
    """``(wp, gs)``: a staged slab's ``w = q_1 r_2`` columns padded to 8,
    and its row stride in shared memory (an odd number of 8-float blocks)."""
    wp = -(-w // 8) * 8
    return wp, wp if (wp // 8) % 2 else wp + 8


def fwd_pivot_slabs(q, r) -> int:
    """Slabs (spans) a group of one pivot pass (tt_ndim 2 or 3) stages at
    most: 40 KB of them, 1-8 (kSlabBudget and kSlabsMax of
    csrc/tt_fwd_pivot.cuh)."""
    gs = _slab_cols(q[1] * r[2])[1]
    return min(_SLABS_MAX, max(1, _SLAB_BUDGET // (4 * r[1] * gs)))


def sub_dims(q, r, t0: int, t1: int):
    """``(q, r)`` of cores ``t0 .. t1`` of a chain as a chain of their own
    (``sub_chain`` of csrc/tt_chain.cuh): where ``t0 > 0`` its core 0 is a
    per-lookup buffer of ``z_{t0-1}`` (``q_0 = m_{t0-1}``, rank
    ``r_{t0}``); where ``t1`` is not the last core, core ``t1``'s ``q_{t1}
    r_{t1+1}`` columns are its last q, so that its row is ``z_{t1}``."""
    qs, rs = [], [1]
    if t0 > 0:
        qs.append(math.prod(q[:t0]))
        rs.append(r[t0])
    for t in range(t0, t1 + 1):
        qs.append(q[t])
        rs.append(r[t + 1])
    if t1 < len(q) - 1:
        qs[-1] *= r[t1 + 1]
        rs[-1] = 1
    return tuple(qs), tuple(rs)


def pivot_passes(q, r):
    """The chains the pivot paths of B4 and B5 run passes on, as ``(q, r)``
    pairs: the chain itself at tt_ndim 2 and 3; at tt_ndim 4 its head
    (cores 0-1, whose row is ``z_1``) and its tail (``z_1`` by lookup, then
    cores 2-3)."""
    if len(q) == 4:
        return [sub_dims(q, r, 0, 1), sub_dims(q, r, 2, 3)]
    return [(tuple(q), tuple(r))]


def _fwd_pivot_fits(q, r):
    """``fits(lc, limit)`` of one pivot pass for chain dims ``q`` and full
    ranks ``r`` (tt_ndim 2 or 3; a group of lc lookups within ``limit``
    bytes of shared memory and the fast division's range), or None where
    the pass does not take the shapes (see :func:`fwd_pivot_chunk`); with
    ``limit`` None, the group's bytes."""
    ndim = len(q)
    if ndim not in (2, 3):
        return None
    m0, rk, w, d = q[0], r[1], q[1] * r[2], math.prod(q)
    r2q2 = r[2] * q[2] if ndim == 3 else 0
    if rk % 8 or w % 4 or d % 4 or r2q2 % 4:
        return None
    wp, gs = _slab_cols(w)
    zs = rk + 4
    m1 = m0 * q[1]
    # tt_ndim 3: the last core's product fused into z_1's (no z_1 staged),
    # on the tensor cores (its slabs' rows padded to 8 columns, z_1's items
    # to r_2 + 4) or on the CUDA cores (kLastFused, kLastTc, kLastCuda)
    fused = ndim == 3 and r[2] == 32 and q[2] % 4 == 0 and q[2] <= 8
    last_tc = (ndim == 3 and not fused and m1 % 16 == 0 and r[2] % 8 == 0
               and q[2] % 4 == 0)
    q2s = -(-q[2] // 8) * 8 if last_tc else (q[2] if ndim == 3 else 1)
    zs1 = 0 if ndim == 2 or fused else r[2] + (4 if last_tc else 1)
    slabs = fwd_pivot_slabs(q, r)

    def fits(lc, limit):
        rows = -(-lc * m0 // 16) * 16
        f = slabs * rk * gs + rows * zs
        most = max(rows * rk // 4, rk * wp // 4, wp)
        if ndim == 3:
            f += lc * (r[2] * q2s + m1 * zs1)
            most = max(most, lc * m1 * -(-q[2] // 4), lc * r[2] * q2s)
        if limit is None:
            return 4 * f
        return (4 * f <= limit and most < _INDEX_MAX
                and rows // 16 <= _GROUP_TILES)

    return fits


def fwd_pivot_chunk(q, r) -> int:
    """Lookups per group of the forward's pivot path for chain dims ``q``
    and full ranks ``r``, or 0 where it does not take them (the rule of
    the library's ``fbtt_tt_fwd_path``, for code that runs on the CPU):
    tt_ndim 2 or 3, ``r_1`` a multiple of 8 (the tensor cores' depth),
    ``q_1 r_2``, D and at tt_ndim 3 ``r_2 q_2`` multiples of 4 (16-byte
    rows), and a group's slabs ``[r_1, q_1 r_2]`` (columns padded to 8, rows
    to an odd number of 8-float blocks; up to 40 KB of them, 1-8) with its
    ``z_0`` rows (and at tt_ndim 3 its last-core slabs and ``z_1`` by
    items) within shared memory and the kernel's fast division; at tt_ndim
    4 the same of both passes (:func:`pivot_passes`), at the least of their
    chunks."""
    if len(q) == 4:
        lcs = [fwd_pivot_chunk(*pq) for pq in pivot_passes(q, r)]
        return min(lcs)
    fits = _fwd_pivot_fits(q, r)
    if fits is None:
        return 0
    for lc in range(FWD_CHUNK_MAX, 0, -4):
        if fits(lc, _FWD_SMEM_PREF):
            return lc
    return 4 if fits(4, _SMEM_MAX) else 0


def fwd_pivot_ctas(q, r) -> int:
    """Pivot CTAs an SM holds at once (the library's rule): three at
    tt_ndim 2 where a group's shared memory is within _FWD_SMEM_THREE, else
    two (at tt_ndim 4 the tail pass's, which the head's launch shares); 0
    where the pivot path does not take the shapes."""
    lc = fwd_pivot_chunk(q, r)
    if not lc:
        return 0
    three = len(q) == 2 and _fwd_pivot_fits(q, r)(lc, None) <= _FWD_SMEM_THREE
    return 3 if three else 2


@functools.lru_cache(maxsize=None)
def _fwd_path(q, r, card) -> Optional[Tuple[str, int, int]]:
    if card:
        per_sm = ctypes.c_int(0)
        pad = [1] * (4 - len(q))
        lc = _lib().fbtt_tt_fwd_path(len(q), *q, *pad, *r[1:-1], *pad,
                                     ctypes.byref(per_sm))
        per_sm = per_sm.value
    else:
        lc = fwd_pivot_chunk(q, r)
        per_sm = fwd_pivot_ctas(q, r)
    if lc:
        return "pivot", lc, per_sm
    lc = chunk_for(2 * state_floats(q, r), math.prod(q))
    return None if lc is None else ("chain", lc, 0)


def fwd_path(q, r, card: bool = False) -> Optional[Tuple[str, int, int]]:
    """``("pivot", lc, ctas_per_sm)`` or ``("chain", lc, 0)``: the path the
    forward kernel takes on these chain dims and full ranks, its chunk of
    lookups and the pivot CTAs an SM holds at once, or None where neither
    stages one lookup in shared memory (the chain pass keeps two states per
    lookup and the bag's ``[D]`` sum). With ``card`` the pivot pass's terms
    come from the kernel library (``fbtt_tt_fwd_path``, asked once per
    shape), as the launch uses them; without, from
    :func:`fwd_pivot_chunk`, the same rule in Python for code that runs on
    the CPU."""
    return _fwd_path(tuple(q), tuple(r), card)


def fwd_chunk(q, r) -> Optional[int]:
    """The forward kernel's chunk on the path it takes (:func:`fwd_path`)."""
    path = fwd_path(q, r)
    return None if path is None else path[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pivot_sub(nza: int, per_sm: int, sms: int) -> int:
    """Rows of core 1's order per CTA of a pivot pass (B4's or B5's): the
    lookups spread evenly over the CTAs the card holds at once (``per_sm``
    on each of ``sms`` SMs), so that they run in one wave."""
    return max(1, -(-nza // (sms * per_sm)))


def _aligned(t):
    """``t``, or a copy of it where its data does not start on 16 bytes (the
    pivot passes read rows as float4)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def chain_rows(gk, idx, q, r):
    """Plain per-lookup chain: the states ``z_0 .. z_{n-1}``, each
    ``[nnz, m_t * r_{t+1}]`` float32 (the last is the row), from gathered
    slabs and batched products."""
    nnz = idx.shape[1]
    z = gk[0][idx[0].long()].reshape(nnz, -1).float()
    states = [z]
    m = q[0]
    for t in range(1, len(q)):
        g = gk[t][idx[t].long()].reshape(nnz, r[t], q[t] * r[t + 1]).float()
        z = torch.bmm(z.reshape(nnz, m, r[t]), g)
        m *= q[t]
        z = z.reshape(nnz, m * r[t + 1])
        states.append(z)
    return states


def live_inputs(idx, rowv):
    """(live mask, ``idx`` with dead lookups' rows set to 0, so that every
    gather stays in range)."""
    live = rowv >= 0
    return live, torch.where(live[None, :], idx, torch.zeros_like(idx))


def tt_fwd_plain(gk, idx, rowv, weights, order, starts, *, core1=None):
    """Plain PyTorch version: gathered slabs, batched ``torch.matmul``
    chain, rows pooled by ``index_add_`` in lookup order, float32."""
    del order, core1  # the kernel's schedule; the bags come from rowv
    q, r = chain_dims(gk)
    tb = starts.shape[0] - 1
    live, idx = live_inputs(idx, rowv)
    rows = chain_rows(gk, idx, q, r)[-1]
    if weights is not None:
        rows = rows * weights[:, None].float()
    seg = torch.where(live, rowv, torch.full_like(rowv, tb)).long()
    out = torch.zeros((tb + 1, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    out.index_add_(0, seg, rows)
    return out[:tb]


def _core1_schedule(gk, idx, rowv):
    """Core 1's order and span starts (``tt_kernel.core1_order``), for a
    caller that gave none."""
    from fbtt_embedding_tpu_torch.ops.kernels.tt_kernel import core1_order

    return core1_order(idx, rowv, [int(g.shape[0]) for g in gk])


def _pivot_groups(runs, rows_t, nza, lc, sub, slabs, m0):
    """The groups of one forward pivot pass over a core's sorted order
    (span starts ``runs``, ``rows_t`` rows), as the kernel forms them: the
    live rows cut into even shares, one per CTA (``ceil(nza / sub)`` of
    them), each share's rows in groups of up to ``lc`` lookups from up to
    ``slabs`` spans, each span's piece taking whole 16-row tiles of the
    product (``m0`` rows a lookup); yields each group's pieces ``(span j,
    first row, lookups)``. Dead lookups (the sentinel span) are in none."""
    nlive = int(runs[rows_t])
    rows_cap = -(-lc * m0 // 16) * 16
    ctas = -(-nza // sub)
    share = -(-nlive // ctas) if ctas else 0
    for lo in range(0, nlive, share or 1):
        hi = min(lo + share, nlive)
        group, gn, gr = [], 0, 0
        for j in range(rows_t):
            cb, en = max(int(runs[j]), lo), min(int(runs[j + 1]), hi)
            while cb < en:
                n = min(en - cb, lc - gn, (rows_cap - gr) // m0)
                if n <= 0 or len(group) == slabs:
                    yield group
                    group, gn, gr = [], 0, 0
                    continue
                group.append((j, cb, n))
                gn += n
                gr += -(-n * m0 // 16) * 16
                cb += n
        if group:
            yield group


def tt_fwd_pivot_plain(gk, idx, rowv, weights, order, starts, *, core1=None,
                       lc=None, sub=None, slabs=None):
    """Plain PyTorch model of the pivot path's schedule, step by step, for
    the tests: the live rows of core 1's order (``core1``, as
    ``tt_kernel.core1_order`` builds it) are cut into even shares, one per
    CTA (``ceil(nza / sub)`` of them, ``sub`` default 32); each share's rows
    run in groups of up to ``lc`` lookups (default the kernel's) from up to
    ``slabs`` spans (default each pass's), each span's piece taking whole
    16-row tiles of the product (:func:`_pivot_groups`); per piece ``z_0 =
    G_0[i_0]``, ``z_1 = z_0 G_1[j]`` (tt_ndim 3: then each lookup's ``z_1``
    by its ``G_2[i_2]``), and ``w * row`` into the lookup's scratch row. At
    tt_ndim 4 that pass (weight 1) writes ``z_1`` into a buffer by lookup,
    and a second one over core 2's order (``core1``'s second row) takes
    ``z_1`` from it: ``z_2 = z_1 G_2[j]``, then each lookup's ``z_2`` by its
    ``G_3[i_3]``, and ``w * row``. Then each bag adds its lookups' scratch
    rows in ``order`` from zero. Dead lookups (the sentinel span) are never
    visited. Raises AssertionError where a scratch or buffer row is written
    twice, or a bag or the second pass reads one never written."""
    q, r = chain_dims(gk)
    ndim, nnz, d = len(q), idx.shape[1], math.prod(q)
    rows_all = [int(g.shape[0]) for g in gk]
    if core1 is None:
        core1 = _core1_schedule(gk, idx, rowv)
    ords, runs = (x.long().reshape(-1, x.shape[-1]) for x in core1)
    nza = ords.shape[1]
    lc = lc or fwd_pivot_chunk(q, r) or FWD_CHUNK_MAX
    sub = sub or 32
    dev = idx.device
    wts = (weights.float() if weights is not None
           else torch.ones(nnz, dtype=torch.float32, device=dev))
    idx_l = idx.long()

    def gather(t, lk, shape):
        return gk[t][idx_l[t, lk]].reshape(shape).float()

    def run(k, m0, piece_rows, out, weighted):
        """One pass over the order of core k + 1 (row k of core1): each
        piece's lookups' rows (``piece_rows(j, lk)``) into ``out``."""
        pq = pivot_passes(q, r)[k]
        for group in _pivot_groups(runs[k], rows_all[k + 1], nza, lc, sub,
                                   slabs or fwd_pivot_slabs(*pq), m0):
            for j, cb, n in group:
                lk = ords[k, cb:cb + n]
                rows = piece_rows(j, lk).reshape(n, -1)
                assert not written[k][lk].any(), "a row written twice"
                written[k][lk] = True
                out[lk] = (wts[lk, None] * rows) if weighted else rows

    scratch = torch.full((nnz, d), float("nan"), device=dev)
    written = [torch.zeros(nnz, dtype=torch.bool, device=dev)
               for _ in range(2)]
    m0, rk = q[0], r[1]

    def head(j, lk):  # z_1 = z_0 G_1[j]; tt_ndim 3: the lookup's last core
        n = lk.numel()
        z1 = gather(0, lk, (n * m0, rk)) @ gk[1][j].reshape(
            rk, q[1] * r[2]).float()
        if ndim != 3:
            return z1
        return torch.bmm(z1.reshape(n, m0 * q[1], r[2]),
                         gather(2, lk, (n, r[2], q[2])))

    if ndim == 4:
        zbuf = torch.full((nnz, q[0] * q[1] * r[2]), float("nan"),
                          device=dev)
        run(0, m0, head, zbuf, False)

        def tail(j, lk):  # z_2 = z_1 G_2[j], then the lookup's last core
            n = lk.numel()
            assert written[0][lk].all(), "z_1 read before it was written"
            m1 = q[0] * q[1]
            z2 = zbuf[lk].reshape(n * m1, r[2]) @ gk[2][j].reshape(
                r[2], q[2] * r[3]).float()
            return torch.bmm(z2.reshape(n, m1 * q[2], r[3]),
                             gather(3, lk, (n, r[3], q[3])))

        run(1, q[0] * q[1], tail, scratch, True)
        done = written[1]
    else:
        run(0, m0, head, scratch, True)
        done = written[0]
    starts_l = starts.long()
    lens = starts_l[1:] - starts_l[:-1]
    out = torch.zeros((lens.shape[0], d), dtype=torch.float32, device=dev)
    # position i of every bag at once: each bag's rows added in its order
    for i in range(int(lens.max()) if lens.numel() else 0):
        bags = torch.nonzero(lens > i).flatten()
        lk = order.long()[starts_l[bags] + i]
        assert done[lk].all(), "a bag reads a scratch row never written"
        out[bags] += scratch[lk]
    return out


def check_lookups(name, gk, idx, rowv, weights):
    """Raise ValueError on lookup inputs the generic kernels do not take."""
    q, r = chain_dims(gk)
    if any(g.dtype != torch.float32 for g in gk):
        raise ValueError(f"{name}: cores must be float32, got "
                         f"{[g.dtype for g in gk]}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != len(gk):
        raise ValueError(f"{name}: idx must be int32 [ndim={len(gk)}, nnz], "
                         f"got {idx.dtype} {tuple(idx.shape)}")
    nnz = idx.shape[1]
    if rowv.dtype != torch.int32 or tuple(rowv.shape) != (nnz,):
        raise ValueError(f"{name}: rowv must be int32 [{nnz}], got "
                         f"{rowv.dtype} {tuple(rowv.shape)}")
    if weights is not None and (weights.dtype != torch.float32
                                or tuple(weights.shape) != (nnz,)):
        raise ValueError(f"{name}: weights must be float32 [{nnz}], got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    return q, r


def check_int32(name, what, t, shape):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} must be int32 {list(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def check_device(name, tensors):
    """Raise ValueError unless every input lies on one device, the CPU or a
    CUDA card; on a card they must also be contiguous."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: all inputs must be on one device, got "
                         f"{devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")


def _pivot_orders(core1, nnz, rows, ndim):
    """``core1`` (``tt_kernel.core1_order``: an order ``[nza]`` or ``[k,
    nza]`` and span starts ``[rstride]`` or ``[k, rstride]``) as 2-D int32
    tensors of the pivot path's cores, core 1 and at tt_ndim 4 core 2;
    raises ValueError on shapes the kernels cannot read."""
    npiv = 2 if ndim == 4 else 1
    ord1, runs1 = core1[0], core1[1]
    if ord1.dim() == 1 and runs1.dim() == 1:
        ord1, runs1 = ord1[None], runs1[None]
    need = max(rows[1:npiv + 1]) + 2
    if (ord1.dtype != torch.int32 or ord1.dim() != 2
            or ord1.shape[0] < npiv or ord1.shape[1] < nnz
            or runs1.dtype != torch.int32 or runs1.dim() != 2
            or runs1.shape[0] < npiv or runs1.shape[1] < need):
        raise ValueError(
            f"tt_fwd: core1 must hold int32 [{npiv}, >= {nnz}] and "
            f"[{npiv}, >= {need}] (the orders of cores 1 .. {npiv}; one core "
            f"may be 1-D), got {ord1.dtype} {tuple(ord1.shape)}, "
            f"{runs1.dtype} {tuple(runs1.shape)}")
    return ord1, runs1


def tt_fwd(gk, idx, rowv, weights, order, starts, *, core1=None):
    """``out [tb, D]`` float32 — see the module docstring. ``core1``: the
    pivot path's sorted orders and span starts from
    ``tt_kernel.core1_order`` (core 1's, and at tt_ndim 4 core 2's too),
    built here where they are not given."""
    q, r = check_lookups("tt_fwd", gk, idx, rowv, weights)
    nnz = idx.shape[1]
    check_int32("tt_fwd", "order", order, (nnz,))
    if starts.dtype != torch.int32 or starts.dim() != 1 or not starts.numel():
        raise ValueError(f"tt_fwd: starts must be 1-D int32 [tb + 1], got "
                         f"{starts.dtype} {tuple(starts.shape)}")
    tensors = [*gk, idx, rowv, order, starts] + (
        [weights] if weights is not None else [])
    check_device("tt_fwd", tensors)
    dev = idx.device
    if dev.type == "cpu":
        return tt_fwd_plain(gk, idx, rowv, weights, order, starts)
    path = fwd_path(q, r, card=True)
    if path is None:
        raise ValueError(f"tt_fwd: q={q}, ranks={r}: one lookup's states "
                         f"pass the kernel's {_SMEM_MAX} bytes of shared "
                         "memory")
    pivot = path[0] == "pivot"
    tb = starts.shape[0] - 1
    d = math.prod(q)
    ndim = len(q)
    rows = [int(g.shape[0]) for g in gk] + [0]
    out = torch.empty((tb, d), dtype=torch.float32, device=dev)
    ord1 = runs1 = scratch = None
    nza = sub = rstride = 0
    with torch.cuda.device(dev):
        if pivot:
            if core1 is None:
                core1 = _core1_schedule(gk, idx, rowv)
            ord1, runs1 = _pivot_orders(core1, nnz, rows, ndim)
            nza, rstride = ord1.shape[1], runs1.shape[1]
            check_device("tt_fwd", [idx, ord1, runs1])
            gk = [_aligned(t) for t in gk]
            # w * row by lookup, and at tt_ndim 4 z_1 by lookup after it
            zf = q[0] * q[1] * r[2] if ndim == 4 else 0
            scratch = torch.empty(nnz * (d + zf), dtype=torch.float32,
                                  device=dev)
            sub = pivot_sub(nza, path[2], _sm_count(dev.index or 0))
        g = [t.data_ptr() for t in gk] + [None] * (4 - len(gk))
        qa = list(q) + [1] * (4 - len(q))
        ra = list(r[1:-1]) + [1] * (3 - (len(r) - 2))
        lib = _lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fbtt_tt_fwd(
            *g, idx.data_ptr(),
            weights.data_ptr() if weights is not None else None,
            order.data_ptr(), starts.data_ptr(), out.data_ptr(),
            *(t.data_ptr() if t is not None else None
              for t in (ord1, runs1, scratch)),
            len(gk), nnz, tb, nza, *qa, *ra, rows[1], rows[2], rstride,
            path[1], state_floats(q, r), int(pivot), sub, stream)
    if err != 0:
        raise RuntimeError("tt_fwd launch failed: "
                           + lib.fbtt_error_string(err).decode())
    tt_fwd.launches += 1
    return out


tt_fwd.launches = 0


def _lib():
    from fbtt_embedding_tpu_torch.ops.kernels._build import library

    lib = library("tt_fwd")
    if lib.fbtt_tt_fwd.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.fbtt_tt_fwd.argtypes = [p] * 12 + [i] * 18 + [p]
        lib.fbtt_tt_fwd.restype = ctypes.c_int
        lib.fbtt_tt_fwd_path.argtypes = [i] * 8 + [ctypes.POINTER(i)]
        lib.fbtt_tt_fwd_path.restype = ctypes.c_int
        lib.fbtt_error_string.argtypes = [ctypes.c_int]
        lib.fbtt_error_string.restype = ctypes.c_char_p
    return lib
