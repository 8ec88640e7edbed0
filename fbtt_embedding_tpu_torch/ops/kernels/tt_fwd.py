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
``csrc/tt_fwd.cu`` on one of two paths (:func:`fwd_path` with ``card``:
the library's ``fbtt_tt_fwd_path``), or raises. The pivot pass (tt_ndim 2
and 3, where core 1's slab stages in shared memory) runs over the live
rows of core 1's sorted order (the keyword ``core1``: its order and span
starts from ``tt_kernel.core1_order``, built by the wrapper where they are
not given) in even shares, one CTA each; a CTA takes its rows in
groups of a few spans, stages each span's slab ``G_1[j]`` and multiplies
the span's gathered ``z_0`` rows by it as 3xTF32 tensor-core GEMMs
(float32 accuracy), writes each lookup's weighted row to a scratch
buffer, and a second kernel adds each bag's rows in ``order``. The chain pass (tt_ndim
4, and configs the pivot pass cannot stage) runs one CTA per bag, which
walks its lookups in chunks, runs their chains in shared memory and sums
the rows. Either way each output row is written once, no atomics:
bitwise repeatable. On a CPU tensor it runs :func:`tt_fwd_plain`, which
derives the bags from ``rowv`` and ignores ``order`` / ``starts`` /
``core1``; :func:`tt_fwd_pivot_plain` follows the pivot pass's schedule
step by step (for the tests). Launches are counted in ``tt_fwd.launches``,
one per call.
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


# the pivot pass's rule in Python, for code that runs on the CPU (the
# library's fbtt_tt_fwd_path decides on the card): groups of at most
# FWD_CHUNK_MAX lookups, the largest multiple of 4 whose shared memory is
# within _FWD_SMEM_PREF, else 4 within _SMEM_MAX, and whose loop indices
# stay below _INDEX_MAX (the constants of csrc/tt_fwd.cu)
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
    """Slabs (spans) a group of the pivot pass stages at most: 40 KB of
    them, 1-8 (kSlabBudget and kSlabsMax of csrc/tt_fwd.cu)."""
    gs = _slab_cols(q[1] * r[2])[1]
    return min(_SLABS_MAX, max(1, _SLAB_BUDGET // (4 * r[1] * gs)))


def _fwd_pivot_fits(q, r):
    """``fits(lc, limit)`` of the pivot pass for chain dims ``q`` and full
    ranks ``r`` (a group of lc lookups within ``limit`` bytes of shared
    memory and the fast division's range), or None where the pass does not
    take the shapes (see :func:`fwd_pivot_chunk`); with ``limit`` None,
    the group's bytes."""
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
    """Lookups per group of the forward's pivot pass for chain dims ``q``
    and full ranks ``r``, or 0 where it does not take them (the rule of
    the library's ``fbtt_tt_fwd_path``, for code that runs on the CPU):
    tt_ndim 2 or 3, ``r_1`` a multiple of 8 (the tensor cores' depth),
    ``q_1 r_2``, D and at tt_ndim 3 ``r_2 q_2`` multiples of 4 (16-byte
    rows), and a group's slabs ``[r_1, q_1 r_2]`` (columns padded to 8, rows
    to an odd number of 8-float blocks; up to 40 KB of them, 1-8) with its
    ``z_0`` rows (and at tt_ndim 3 its last-core slabs and ``z_1`` by
    items) within shared memory and the kernel's fast division."""
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
    two; 0 where the pivot pass does not take the shapes."""
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


def tt_fwd_pivot_plain(gk, idx, rowv, weights, order, starts, *, core1=None,
                       lc=None, sub=None, slabs=None):
    """Plain PyTorch model of the pivot pass's schedule (tt_ndim 2 and 3),
    step by step, for the tests: the live rows of core 1's order (``core1``,
    as ``tt_kernel.core1_order`` builds it) are cut into even shares, one per
    CTA (``ceil(nza / sub)`` of them, ``sub`` default 32); each share's rows
    run in groups of up to ``lc``
    lookups (default the kernel's) from up to ``slabs`` spans, each span's
    piece taking whole 16-row tiles of the product; per piece ``z_0 =
    G_0[i_0]``, ``z_1 = z_0 G_1[j]`` (tt_ndim 3: then each lookup's ``z_1``
    by its ``G_2[i_2]``), and ``w * row`` into the lookup's scratch row;
    then each bag adds its lookups' scratch rows in ``order`` from zero.
    Dead lookups (the sentinel span) are never visited. Raises
    AssertionError where a scratch row is written twice or a bag reads one
    never written."""
    q, r = chain_dims(gk)
    ndim, nnz, d = len(q), idx.shape[1], math.prod(q)
    if ndim not in (2, 3):
        raise ValueError(f"the pivot pass takes tt_ndim 2 and 3, got {ndim}")
    rows1 = int(gk[1].shape[0])
    if core1 is None:
        core1 = _core1_schedule(gk, idx, rowv)
    ord1, runs1 = core1[0].long(), core1[1].long()
    nza, nlive = ord1.shape[0], int(runs1[rows1])
    lc = lc or fwd_pivot_chunk(q, r) or FWD_CHUNK_MAX
    sub = sub or 32
    slabs = slabs or fwd_pivot_slabs(q, r)
    m0, rk, w = q[0], r[1], q[1] * r[2]
    rows_cap = -(-lc * m0 // 16) * 16
    dev = idx.device
    wts = (weights.float() if weights is not None
           else torch.ones(nnz, dtype=torch.float32, device=dev))
    idx_l = idx.long()
    scratch = torch.full((nnz, d), float("nan"), device=dev)
    written = torch.zeros(nnz, dtype=torch.bool, device=dev)
    group = []  # (span, first row, lookups) of each piece

    def flush():
        for j, cb, n in group:
            lk = ord1[cb:cb + n]
            g = gk[1][j].reshape(rk, w).float()
            z1 = gk[0][idx_l[0, lk]].reshape(n * m0, rk).float() @ g
            if ndim == 3:
                g2 = gk[2][idx_l[2, lk]].reshape(n, r[2], q[2]).float()
                rows = torch.bmm(z1.reshape(n, m0 * q[1], r[2]), g2)
            else:
                rows = z1
            assert not written[lk].any(), "a scratch row written twice"
            written[lk] = True
            scratch[lk] = wts[lk, None] * rows.reshape(n, d)
        group.clear()

    ctas = -(-nza // sub)
    share = -(-nlive // ctas) if ctas else 0
    for lo in range(0, nlive, share or 1):
        hi = min(lo + share, nlive)
        gn = gr = 0
        for j in range(rows1):
            cb, en = max(int(runs1[j]), lo), min(int(runs1[j + 1]), hi)
            while cb < en:
                n = min(en - cb, lc - gn, (rows_cap - gr) // m0)
                if n <= 0 or len(group) == slabs:
                    flush()
                    gn = gr = 0
                    continue
                group.append((j, cb, n))
                gn += n
                gr += -(-n * m0 // 16) * 16
                cb += n
        flush()
    starts_l = starts.long()
    lens = starts_l[1:] - starts_l[:-1]
    out = torch.zeros((lens.shape[0], d), dtype=torch.float32, device=dev)
    # position i of every bag at once: each bag's rows added in its order
    for i in range(int(lens.max()) if lens.numel() else 0):
        bags = torch.nonzero(lens > i).flatten()
        lk = order.long()[starts_l[bags] + i]
        assert written[lk].all(), "a bag reads a scratch row never written"
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


def tt_fwd(gk, idx, rowv, weights, order, starts, *, core1=None):
    """``out [tb, D]`` float32 — see the module docstring. ``core1``: core
    1's sorted order and span starts from ``tt_kernel.core1_order`` (the
    pivot pass reads them), built here where they are not given."""
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
    rows1 = int(gk[1].shape[0])
    out = torch.empty((tb, d), dtype=torch.float32, device=dev)
    ord1 = runs1 = scratch = None
    nza = sub = 0
    with torch.cuda.device(dev):
        if pivot:
            if core1 is None:
                core1 = _core1_schedule(gk, idx, rowv)
            ord1, runs1 = core1[0], core1[1]
            nza = ord1.shape[0]
            if (ord1.dtype != torch.int32 or ord1.dim() != 1 or nza < nnz
                    or runs1.dtype != torch.int32 or runs1.dim() != 1
                    or runs1.shape[0] < rows1 + 2):
                raise ValueError(
                    f"tt_fwd: core1 must hold int32 [>= {nnz}] and "
                    f"[>= {rows1 + 2}], got {ord1.dtype} "
                    f"{tuple(ord1.shape)}, {runs1.dtype} "
                    f"{tuple(runs1.shape)}")
            check_device("tt_fwd", [idx, ord1, runs1])
            gk = [_aligned(t) for t in gk]
            scratch = torch.empty(nnz * d, dtype=torch.float32, device=dev)
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
            len(gk), nnz, tb, nza, *qa, *ra, rows1, path[1],
            state_floats(q, r), int(pivot), sub, stream)
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
        lib.fbtt_tt_fwd.argtypes = [p] * 12 + [i] * 16 + [p]
        lib.fbtt_tt_fwd.restype = ctypes.c_int
        lib.fbtt_tt_fwd_path.argtypes = [i] * 8 + [ctypes.POINTER(i)]
        lib.fbtt_tt_fwd_path.restype = ctypes.c_int
        lib.fbtt_error_string.argtypes = [ctypes.c_int]
        lib.fbtt_error_string.restype = ctypes.c_char_p
    return lib
