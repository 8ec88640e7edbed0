"""Flat sorted-run TT lookup pipeline (tt_ndim 2-4), in PyTorch.

Counterpart of the host glue of ``fbtt_embedding_tpu/ops/pallas/tt_flat.py``.
For tt_ndim == 3 (2 and 4 generalise: one sort and one kernel pass per
middle/last core)::

  sort lookups by i1 and by i2             stable sorts of the keys
  span tables = searchsorted(keys, j)      core row j <-> span of rows
  z0   = G0f[i0_s1]                        gather [nza, q0*r1]
  Z1   = seg_transform(z0, G1)             [nza, q0*q1*r2]      (kernel B1)
  Z1'  = Z1[perm12]                        gather, s1 -> s2 order
  rows = seg_transform(Z1', G2bd)          [nza, D]   (kernel B1, folded by mm)
  out  = onehot(rowidx_s2) @ rows          pooling, float32

  backward (FlatLookup, the JAX package's make_flat_vjp):
  dr   = dout[rowidx_s2] * w               gather [nza, D]
  dZ1', dG2 = seg_accum(Z1', dr, G2bd)     (kernel B3, folded by mm)
  dZ1  = dZ1'[perm21]                      gather, s2 -> s1 order
  dz0, dG1 = seg_accum(z0, dZ1, G1)        (kernel B3, float32 dz0)
  dG0  = onehot(i0_s1)^T @ dz0             float32 product

  with FBTT_DG0=fused (``_dg0_fused_gate``; off by default, as in the JAX
  package) the last two lines are one pass, and dz0 never leaves it:
  dG1, dG0 = seg_accum_dg0(z0, dZ1, i0c, G1)   (kernel B6)

``flat_train_apply`` (the fused training step, ``d_output`` known up front)
runs the last core's forward and backward as one pass instead
(``seg_fused_i2``, kernel B2: rows, dZ1 and dG2 together).

``G2bd`` is the last core expanded block-diagonally over the accumulated
middle digits (``_bd_widths``). The kernels B1, B2 and B3 fold it
(``mm``): they read only its first diagonal block, ``G2[j]``; B2 and B3 give
``dG2`` as the sum of the diagonal blocks (what ``_extract_bd_grad``
takes of an unfolded gradient). In pair mode (``_pair_gate``: nza >= 16384
or ``FBTT_PAIR=1``, and the pair table fits) a ``[T*p0*p1 + 1, q0*q1*r2]``
table of ``G0[i0] @ G1[i1]`` replaces the z0 gather, the first pass and the
s1 -> s2 permute: ``Z1' = G01[pair_s2]``, and only the last pass runs
forward; the backward recomputes z0 by the gather.

Dead lookups (cache-served: ``dead_mask`` or positions past
``live_count``) and padding get a sentinel key ``T*p_t``; they sort into the
final span, which the kernel fills with zeros.

Frozen-weight serving (``make_serving_fold``) builds every weight-derived
array of the forward once: g0f, the pass tables and, at tt_ndim >= 3, the
pair table, which it then uses at any batch size (no ``_pair_gate``).
``flat_lookup_forward(..., setup=fold)`` takes them in place of the cores,
so a serve runs the plan, the pair-table gather, kernel B1 on the last
core (and the middle core before it at tt_ndim 4) and the pool.
``quantize="int8"`` keeps the pair table as per-row int8 with float32
scales (``quantize_rows_int8``), dequantized after the gather
(``_dequant_gather``) and rounded to the staging dtype before B1.

Numerics: float32 master cores; intermediates staged in ``compute_dtype``
(bfloat16 by default on the card, float32 on the CPU or when asked);
products accumulate in float32, and pooling, core gradients and dz0 are
float32. The one-hot products (pooling, dG0) are float32 ``torch.matmul``
calls: nothing here turns TF32 on, so on the card they run in full float32
as long as the caller leaves ``torch.backends.cuda.matmul.allow_tf32`` at
its default (False).

The segment length ``SEG`` is this port's choice for Hopper (one CTA of
the kernel per segment); the TPU's seg/sb/spp grid policies and knobs are
not carried over. ``jax.lax.sort`` over several operands becomes a stable
``torch.sort`` of the key plus gathers of the carried operands.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from fbtt_embedding_tpu_torch.ops.hot_scatter import segment_sum
from fbtt_embedding_tpu_torch.ops.indexing import tt_strides
from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import (
    diag_block_sum,
    seg_accum,
)
from fbtt_embedding_tpu_torch.ops.kernels.seg_accum_dg0 import (
    dg0_fits,
    seg_accum_dg0,
)
from fbtt_embedding_tpu_torch.ops.kernels.seg_fused_i2 import seg_fused_i2
from fbtt_embedding_tpu_torch.ops.kernels.seg_transform import seg_transform
from fbtt_embedding_tpu_torch.ops.kernels.tt_kernel import (
    full_ranks,
    grads_to_module_layout,
    kernel_core_layouts,
    segment_spans,
)
from fbtt_embedding_tpu_torch.utils import knobs

SEG = 64  # lookups per segment: one CTA of the transform kernel each
# empty spans appended to every span table (and zero slabs to every pass
# table), kept from the JAX package so plans compare entry for entry
SPAN_BLOCK = 4
# cap on the G0xG1 pair-product table (rebuilt per call from the cores,
# or built once by a serving fold)
_PAIR_TABLE_BYTES = 96 * 1024 * 1024
# one-hot pooling up to this many pooled rows, segment_sum above
_POOL_ONEHOT_MAX_TB = 4096


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pair_structural_ok(num_tables: int, p, q, r, itemsize: int) -> bool:
    """Whether a G0xG1 pair-product table is buildable: tt_ndim >= 3, pair
    ids fit int32, table under ``_PAIR_TABLE_BYTES``."""
    if len(p) < 3:
        return False
    r = full_ranks(p, r)
    rows = num_tables * p[0] * p[1]
    width = q[0] * q[1] * r[2]
    return rows + 1 < 2 ** 31 and \
        (rows + 1) * width * itemsize <= _PAIR_TABLE_BYTES


def _pair_gate(nza: int, num_tables: int, p, q, r, itemsize: int) -> bool:
    """Pair mode when structurally possible and nza >= 16384, where the
    per-call table build amortises (the JAX package's threshold).
    ``FBTT_PAIR`` "0" / "1", read at every call, overrides the nza
    threshold for an A/B, never the structural gate."""
    if not pair_structural_ok(num_tables, p, q, r, itemsize):
        return False
    env = knobs.get_str("FBTT_PAIR")
    if env in ("0", "1"):
        return env == "1"
    return nza >= 16384


def _bd_widths(tt_q_shapes, ranks):
    """Per-core (mm, bw_in, bw_out): the state before core t has q0
    lane-blocks of width mm_t * r_t (mm_t = q1*..*q_{t-1}); core t applies
    as the block-diagonal expansion of shape [mm_t*r_t, mm_t*q_t*r_{t+1}]."""
    out = []
    mm = 1
    for t in range(1, len(tt_q_shapes)):
        out.append((mm, mm * ranks[t], mm * tt_q_shapes[t] * ranks[t + 1]))
        mm *= tt_q_shapes[t]
    return out


def _dg0_fused_gate(dtype: torch.dtype, blocks: int, bw_x: int,
                    bw_y: int) -> bool:
    """Whether the innermost gradient pass folds dG0 in (kernel B6):
    ``FBTT_DG0=fused`` and widths (``blocks = q0``, ``bw_x = r1``, ``bw_y
    = q1*r2``) staged in ``dtype`` that one of B6's paths takes
    (:func:`dg0_fits`). Default "onehot": off, as in the JAX package. The
    TPU's span-row and VMEM limits do not apply."""
    return knobs.get_str("FBTT_DG0") == "fused" and dg0_fits(
        dtype == torch.bfloat16, SEG, blocks, bw_x, bw_y)


def flat_available(tt_p_shapes, tt_q_shapes, tt_ranks, num_tables: int,
                   batch_size: int) -> bool:
    """Whether the flat pipeline takes this config unpadded: tt_ndim 2-4
    and every staged lane-block width a multiple of 8 (16-byte rows in
    bfloat16). The TPU's VMEM budget and span-count cap do not apply: the
    kernel streams spans and slabs from device memory."""
    ndim = len(tt_p_shapes)
    if ndim not in (2, 3, 4):
        return False
    q = list(tt_q_shapes)
    r = full_ranks(tt_p_shapes, tt_ranks)
    if (q[0] * r[1]) % 8 != 0:
        return False
    for _, bw_in, bw_out in _bd_widths(q, r):
        if bw_in % 8 != 0 or bw_out % 8 != 0:
            return False
    return (num_tables * batch_size) % 8 == 0


@dataclass
class FlatPlan:
    """Sorted orders, span tables and permutations of one batch. Every
    per-lookup array has nza entries (nnz padded to whole segments; pad
    rows carry sentinel keys).

    Pass t (1-based core index) lives in sort space ``s_t``; entry ``t-1``
    of ``runs``/``first``/``cnt`` is its span table. ``perm_fwd[t-1]``
    maps positions of ``s_{t+1}`` to positions of ``s_t``; ``perm_bwd`` is
    the inverse chain."""

    i0_s1: torch.Tensor                 # [nza] first-core rows (combined)
    alive1: torch.Tensor                # [nza] bool, real and live, s1
    runs: Tuple[torch.Tensor, ...]      # per pass [T*p_t + 1 + SPAN_BLOCK]
    first: Tuple[torch.Tensor, ...]     # per pass [nseg]
    cnt: Tuple[torch.Tensor, ...]       # per pass [nseg]
    perm_fwd: Tuple[Optional[torch.Tensor], ...]
    perm_bwd: Tuple[torch.Tensor, ...]
    rowidx_last: torch.Tensor           # [nza] pooled rows, last space
    w_last: Optional[torch.Tensor]
    pair_s2: Optional[torch.Tensor] = None  # pair mode: (i0, i1) ids, s2


def _span_table(key_sorted: torch.Tensor, p_rows: int, nseg: int, seg=SEG):
    """(span starts by core row, first span of each segment, span count of
    each segment) from the sorted keys, all by searchsorted. ``runs``
    carries ``SPAN_BLOCK`` extra empty spans at its tail."""
    dev = key_sorted.device
    edges = torch.arange(p_rows + SPAN_BLOCK + 1, dtype=torch.int32,
                         device=dev)
    runs = torch.searchsorted(key_sorted.to(torch.int32).contiguous(), edges,
                              out_int32=True)
    return (runs,) + segment_spans(runs, nseg, seg)


def _invert_perm(perm: torch.Tensor) -> torch.Tensor:
    """Inverse permutation by one scatter."""
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                    device=perm.device)
    return inv


def _stable_sort(key, *carry):
    """``jax.lax.sort([key, *carry], num_keys=1, is_stable=True)``."""
    k_s, order = torch.sort(key, stable=True)
    return (k_s,) + tuple(c[order] for c in carry)


def _pad(a: torch.Tensor, n: int, value) -> torch.Tensor:
    if n == a.shape[0]:
        return a
    return torch.cat([a, torch.full((n - a.shape[0],), value, dtype=a.dtype,
                                    device=a.device)])


def _build_plan(indices, rowidx, tableidx, weights, live_count, tt_p_shapes,
                num_tables, batch_size, dead_mask=None, idx_parts=None,
                seg=SEG, pair=False):
    """-> (FlatPlan, nza). Same arrays as the JAX package's ``_build_plan``
    at the same ``seg``."""
    p = list(tt_p_shapes)
    ndim = len(p)
    nnz = rowidx.shape[0]
    nza = _cdiv(nnz, seg) * seg
    nseg = nza // seg
    dev = rowidx.device
    i32 = torch.int32

    if idx_parts is not None:
        parts = [p_.to(i32) for p_ in idx_parts]
    else:
        strides = tt_strides(p)
        idx32 = indices.to(i32)
        parts = [torch.div(idx32, int(strides[t]), rounding_mode="floor")
                 % p[t] for t in range(ndim)]
    # (i0, i1) pair id: the flat [T, p0, p1] index
    pairc = parts[0] * p[1] + parts[1] if pair else None
    if tableidx is not None and num_tables > 1:
        t32 = tableidx.to(i32)
        parts = [p_ + t32 * p[t] for t, p_ in enumerate(parts)]
        rowc = rowidx.to(i32) + t32 * batch_size
        if pair:
            pairc = pairc + t32 * (p[0] * p[1])
    else:
        rowc = rowidx.to(i32)

    sents = [num_tables * p_ for p_ in p]
    if dead_mask is not None:
        dead = dead_mask.to(device=dev, dtype=torch.bool)
    elif live_count is not None:
        pos = torch.arange(nnz, dtype=i32, device=dev)
        dead = pos >= live_count.to(device=dev, dtype=i32).reshape(())
    else:
        dead = None
    pairp = None
    if pair:
        sent_pair = num_tables * p[0] * p[1]
        if dead is not None:
            pairc = torch.where(dead, torch.full_like(pairc, sent_pair),
                                pairc)
        pairp = _pad(pairc, nza, sent_pair)
    keys = []
    for t in range(1, ndim):
        k = parts[t]
        if dead is not None:
            k = torch.where(dead, torch.full_like(k, sents[t]), k)
        keys.append(_pad(k, nza, sents[t]))

    i0p = _pad(parts[0], nza, 0)
    rowp = _pad(rowc, nza, -1)
    posp = torch.arange(nza, dtype=i32, device=dev)
    wp = (_pad(weights.to(torch.float32), nza, 0.0)
          if weights is not None else None)

    if pair and ndim == 3:
        # one sort fewer: sort by i2 first carrying pair ids, pooling
        # arrays and positions, invert the positions once (orig -> s2
        # slot), and let the i1 sort carry those slots: perm_bwd falls
        # out sorted
        carry = [pairp, rowp] + ([wp] if wp is not None else []) + [posp]
        res2 = _stable_sort(keys[1], *carry)
        k2_s, pair_s2, row_s = res2[0], res2[1], res2[2]
        w_s = res2[3] if wp is not None else None
        slot2_of_orig = _invert_perm(res2[-1])
        runs2, first2, cnt2 = _span_table(k2_s, sents[2], nseg, seg=seg)
        k1_s, i0_s1, perm_bwd0 = _stable_sort(keys[0], i0p, slot2_of_orig)
        runs1, first1, cnt1 = _span_table(k1_s, sents[1], nseg, seg=seg)
        return FlatPlan(
            i0_s1=i0_s1, alive1=k1_s < sents[1],
            runs=(runs1, runs2), first=(first1, first2), cnt=(cnt1, cnt2),
            perm_fwd=(None,), perm_bwd=(perm_bwd0,),
            rowidx_last=row_s, w_last=w_s, pair_s2=pair_s2,
        ), nza

    # chain of stable sorts, one per middle/last core, each on the
    # original-order keys; each carries the previous space's orig -> slot
    # map (so the gap permutation falls out sorted) and the positions;
    # the last carries the pooling arrays
    runs_l, first_l, cnt_l, perm_fwd, perm_bwd = [], [], [], [], []
    i0_s1 = alive1 = row_s = w_s = pair_s2 = None
    inv_prev = None  # orig position -> slot in the previous space
    for t in range(1, ndim):
        is_last = t == ndim - 1
        carry = [i0p if t == 1 else inv_prev]
        if not is_last:
            carry.append(posp)
        else:
            carry.append(rowp)
            if wp is not None:
                carry.append(wp)
        if pair and t == 2:
            carry.append(pairp)
        res = _stable_sort(keys[t - 1], *carry)
        if pair and t == 2:
            pair_s2 = res[-1]
            res = res[:-1]
        k_s, second = res[0], res[1]
        if t == 1:
            i0_s1 = second
            alive1 = k_s < sents[1]
        else:
            perm_fwd.append(second)  # slot_t -> slot_{t-1}
            perm_bwd.append(_invert_perm(second))
        if is_last:
            row_s = res[2]
            w_s = res[3] if wp is not None else None
        else:
            inv_prev = _invert_perm(res[2])  # orig -> slot_t
        r_, f_, c_ = _span_table(k_s, sents[t], nseg, seg=seg)
        runs_l.append(r_)
        first_l.append(f_)
        cnt_l.append(c_)

    return FlatPlan(
        i0_s1=i0_s1, alive1=alive1,
        runs=tuple(runs_l), first=tuple(first_l), cnt=tuple(cnt_l),
        perm_fwd=tuple(perm_fwd), perm_bwd=tuple(perm_bwd),
        rowidx_last=row_s, w_last=w_s, pair_s2=pair_s2,
    ), nza


def _bd_table(gk_t: torch.Tensor, mm: int, dt) -> torch.Tensor:
    """Core t ``[tp, r_t, q_t*r_{t+1}]`` -> block-diagonal expansion over
    the ``mm`` accumulated middle digits, ``[tp, mm*r_t, mm*q_t*r_{t+1}]``."""
    if mm == 1:
        return gk_t.to(dt)
    tp, r_t, w_t = gk_t.shape
    eye = torch.eye(mm, dtype=dt, device=gk_t.device)
    bd = eye[None, :, None, :, None] * gk_t.to(dt)[:, None, :, None, :]
    return bd.reshape(tp, mm * r_t, mm * w_t)


def _extract_bd_grad(dgbd: torch.Tensor, mm: int, r_t: int, w_t: int):
    """Gradient of a block-diagonal expansion ``[tp, mm*r_t, mm*w_t]`` ->
    the core's ``[tp, r_t, w_t]``: the sum of the ``mm`` diagonal blocks,
    in block order (the JAX package's signature; the kernels B2 and B3 fold
    the table and give this sum themselves)."""
    assert dgbd.shape[1:] == (mm * r_t, mm * w_t)
    return diag_block_sum(dgbd, mm)


def _pool_flat(rows: torch.Tensor, plan: FlatPlan, tb: int, dt):
    """Pool per-lookup rows (last sort space) into float32 ``[tb, d]``: a
    one-hot product for small batches, the deterministic ``segment_sum``
    above ``_POOL_ONEHOT_MAX_TB`` (pad rows, ``rowidx_last`` -1, dropped).
    The one-hot weights are rounded to the staging dtype and the product is
    float32, as in the JAX package."""
    if tb <= _POOL_ONEHOT_MAX_TB:
        iota_b = torch.arange(tb, dtype=torch.int32, device=rows.device)
        hit = plan.rowidx_last[None, :] == iota_b[:, None]
        if plan.w_last is not None:
            w = plan.w_last.to(dt).float()
            oh = torch.where(hit, w[None, :],
                             torch.zeros((), device=rows.device))
        else:
            oh = hit.float()
        return torch.matmul(oh, rows.float())
    rows_f = rows.float()
    if plan.w_last is not None:
        rows_f = rows_f * plan.w_last[:, None]
    return segment_sum(rows_f, plan.rowidx_last, tb)


def _flat_setup(cores, p, q, r, dt):
    """(g0f with a zero row appended, kernel layouts, per-pass stacked
    tables ``[(T*p_t + SPAN_BLOCK) * bw_in, bw_out]``, widths)."""
    t = cores[0].shape[0]
    gk = kernel_core_layouts(cores, p, q, r)
    dev = cores[0].device
    g0f = torch.cat([
        gk[0].reshape(t * p[0], q[0] * r[1]).float(),
        torch.zeros((1, q[0] * r[1]), dtype=torch.float32, device=dev),
    ]).to(dt)
    widths = _bd_widths(list(q), list(r))
    tables = []
    for ti in range(1, len(p)):
        mm, bw_in, bw_out = widths[ti - 1]
        bd = _bd_table(gk[ti], mm, dt)
        tables.append(torch.cat([
            bd.reshape(bd.shape[0] * bw_in, bw_out),
            torch.zeros((SPAN_BLOCK * bw_in, bw_out), dtype=dt, device=dev),
        ]))
    return g0f, gk, tables, widths


def _pair_table(gk, p, q, r, t, dt):
    """Pair-product table ``[T*p0*p1 + 1, q0*q1*r2]`` (zero sentinel row
    last): ``G01[(t, k, j)] = G0[t, k] @ G1[t, j]`` per q0 lane-block, with
    inputs rounded to the staging dtype, a float32 product and the result
    rounded once, like a kernel pass."""
    w1 = q[1] * r[2]
    g0 = gk[0].reshape(t, p[0], q[0], r[1]).to(dt).float()
    g1 = gk[1].reshape(t, p[1], r[1], w1).to(dt).float()
    g01 = torch.einsum("tkar,tjrw->tkjaw", g0, g1)
    g01 = g01.reshape(t * p[0] * p[1], q[0] * w1).to(dt)
    return torch.cat([g01, torch.zeros((1, q[0] * w1), dtype=dt,
                                       device=g01.device)])


def quantize_rows_int8(tbl: torch.Tensor):
    """Per-row symmetric int8: ``(q8, scale)`` with ``tbl ~= q8.float() *
    scale[:, None]``, ``scale = absmax / 127`` (float32). All-zero rows, such
    as the pair table's sentinel row, get scale 0 and dequantize to exact
    zeros. Rounding is half to even, as the JAX package's ``jnp.round``."""
    x = tbl.float()
    scale = x.abs().amax(dim=1) / 127.0
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale,
                                             torch.ones_like(scale)),
                      torch.zeros_like(scale))
    q8 = torch.clamp(torch.round(x * inv[:, None]), -127, 127)
    return q8.to(torch.int8), scale


def _dequant_gather(qtbl, rows: torch.Tensor) -> torch.Tensor:
    """Rows ``rows`` of a ``(q8, scale)`` pair, dequantized to float32 (the
    int8 rows promote inside the product: one pass, no float32 copy)."""
    q8, scale = qtbl
    return q8[rows] * scale[rows][:, None]


def make_serving_fold(cores, tt_p_shapes, tt_q_shapes, tt_ranks,
                      compute_dtype=torch.float32, pair: bool = True,
                      quantize: Optional[str] = None):
    """Every weight-derived array of the flat forward, built once for
    frozen-weight serving: ``(g0f, g01f, tables)``.

    ``g01f`` is the G0xG1 pair table (:func:`_pair_table`) where ``pair``
    and :func:`pair_structural_ok` allow, else None; a serve uses it at any
    batch size (the build is paid here, not per call). ``quantize="int8"``
    stores it as a per-row ``(q8, scale)`` pair (:func:`quantize_rows_int8`),
    half the bytes of bfloat16; g0f and the pass tables stay in
    ``compute_dtype``."""
    p, q, r = tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(tt_ranks)
    t = cores[0].shape[0]
    dt = compute_dtype
    g0f, gk, tables, _ = _flat_setup(cores, p, q, r, dt)
    itemsize = torch.empty((), dtype=dt).element_size()
    g01f = (_pair_table(gk, p, q, r, t, dt)
            if pair and pair_structural_ok(t, p, q, r, itemsize) else None)
    if quantize == "int8" and g01f is not None:
        g01f = quantize_rows_int8(g01f)
    return g0f, g01f, tuple(tables)


def _i0c(plan: FlatPlan, tp0: int) -> torch.Tensor:
    """First-core row of every lookup in s1 order; dead and pad lookups get
    the sentinel ``tp0``."""
    return torch.where(plan.alive1, plan.i0_s1,
                       torch.full_like(plan.i0_s1, tp0))


def _z0(plan: FlatPlan, g0f: torch.Tensor, tp0: int) -> torch.Tensor:
    """First-core rows of every lookup in s1 order, ``[nza, q0*r1]``; dead
    and pad lookups gather the zero row ``tp0``."""
    return g0f[_i0c(plan, tp0).long()]


def _row_cotangents(d_output, plan: FlatPlan, tb: int, d: int, dt):
    """Per-lookup cotangents in the last sort space, ``[nza, D]`` in the
    staging dtype and weighted; pad rows gather an appended zero row."""
    dflat = torch.cat([d_output.reshape(tb, d).to(dt),
                       torch.zeros((1, d), dtype=dt, device=d_output.device)])
    rowc = torch.where(plan.rowidx_last >= 0, plan.rowidx_last,
                       torch.full_like(plan.rowidx_last, tb))
    dz = dflat[rowc.long()]
    if plan.w_last is not None:
        dz = dz * plan.w_last[:, None].to(dt)
    return dz


def _dg0(plan: FlatPlan, dz0: torch.Tensor, tp0: int, q0: int, r1: int):
    """dG0 ``[tp0, q0, r1]``: the float32 one-hot product of the live
    lookups' first-core rows (s1 order) with dz0."""
    i0m = torch.where(plan.alive1, plan.i0_s1,
                      torch.full_like(plan.i0_s1, -1))
    iota = torch.arange(tp0, dtype=i0m.dtype, device=i0m.device)
    oh0 = (i0m[:, None] == iota[None, :]).float()
    return torch.matmul(oh0.t(), dz0.float()).reshape(tp0, q0, r1)


def _pass_inputs(plan: FlatPlan, g0f, gk, tables, widths, p, q, r, t, dt,
                 seg, g01f=None):
    """The input of every core pass 1 .. ndim-1, each in its own sort
    space: z0 (or, in pair mode, None for the skipped pass 1 and
    ``G01[pair_s2]`` as pass 2's input), then kernel B1 and the s_t ->
    s_t+1 permute for every pass before the last. In pair mode the pair
    table is ``g01f`` where a fold gives it (a ``(q8, scale)`` pair when
    quantized), else it is built here from ``gk``."""
    ndim = len(p)
    if plan.pair_s2 is not None:
        stages = [None]
        if g01f is None:
            g01f = _pair_table(gk, p, q, r, t, dt)
        rows = plan.pair_s2.long()
        state = (_dequant_gather(g01f, rows).to(dt)
                 if isinstance(g01f, tuple) else g01f[rows])
    else:
        stages = []
        state = _z0(plan, g0f, t * p[0])
    for ti in range(len(stages) + 1, ndim):
        stages.append(state)
        if ti == ndim - 1:
            break
        mm, bw_in, bw_out = widths[ti - 1]
        state = seg_transform(
            plan.runs[ti - 1], plan.first[ti - 1], plan.cnt[ti - 1], state,
            tables[ti - 1], blocks=q[0], bw_in=bw_in, bw_out=bw_out,
            p_rows=t * p[ti], seg=seg, out_dtype=dt, mm=mm)
        state = state[plan.perm_fwd[ti - 1].long()]  # s_ti -> s_ti+1
    return stages


def _grad_passes(plan: FlatPlan, stages, dz, top, g0f, tables, widths, p, q,
                 r, t, dt, seg, dgs):
    """Kernel B3 for the passes ``top`` .. 1 from ``dz`` in s_top order,
    then dG0: fills ``dgs[top..0]``. Each pass folds its block-diagonal
    table (``mm``), so B3 gives the core's gradient as it is. dz stays in
    the staging dtype between passes; z0 is recomputed by the gather where
    pair mode skipped pass 1.
    The float32 dz0 of pass 1 meets a float32 one-hot product, or, under
    :func:`_dg0_fused_gate`, pass 1 runs kernel B6 and gives dG0 itself."""
    tp0 = t * p[0]
    for ti in range(top, 0, -1):
        mm, bw_in, bw_out = widths[ti - 1]
        x_stage = stages[ti - 1]
        if x_stage is None:
            x_stage = _z0(plan, g0f, tp0)
        span = (plan.runs[ti - 1], plan.first[ti - 1], plan.cnt[ti - 1])
        kw = dict(blocks=q[0], bw_x=bw_in, bw_y=bw_out, p_rows=t * p[ti],
                  seg=seg)
        if ti == 1 and _dg0_fused_gate(dt, q[0], bw_in, bw_out):
            dgs[1], dg0 = seg_accum_dg0(*span, x_stage, dz, _i0c(plan, tp0),
                                        tables[0], tp0=tp0, **kw)
            dgs[0] = dg0.reshape(tp0, q[0], r[1])
        else:
            dgs[ti], dz = seg_accum(
                *span, x_stage, dz, tables[ti - 1], mm=mm,
                z_dtype=dt if ti > 1 else torch.float32, **kw)
        if ti > 1:
            dz = dz[plan.perm_bwd[ti - 2].long()]  # s_ti -> s_ti-1
    if dgs[0] is None:
        dgs[0] = _dg0(plan, dz, tp0, q[0], r[1])


def flat_lookup_forward(cores, tt_p_shapes, tt_q_shapes, tt_ranks,
                        batch_size, plan: FlatPlan, nza,
                        compute_dtype=torch.float32, seg=SEG, setup=None,
                        num_tables: Optional[int] = None):
    """Pooled forward -> (``[T, B, D]`` float32, staged states). The staged
    states (each pass's input, in its sort space; None for a pass that
    pair mode skipped) are what a backward would reuse.

    ``setup``: a :func:`make_serving_fold` triple. Then ``cores`` may be
    None (give ``num_tables``) and no weight-derived array is rebuilt: the
    frozen-weight serve."""
    p, q, r = tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(tt_ranks)
    t = cores[0].shape[0] if cores is not None else num_tables
    tb = t * batch_size
    d = int(np.prod(q))
    dt = compute_dtype
    if setup is None:
        g0f, gk, tables, widths = _flat_setup(cores, p, q, r, dt)
        g01f = None
    else:
        (g0f, g01f, tables), gk = setup, None
        widths = _bd_widths(list(q), list(r))

    stages = _pass_inputs(plan, g0f, gk, tables, widths, p, q, r, t, dt,
                          seg, g01f=g01f)
    mm, bw_in, bw_out = widths[-1]
    state = seg_transform(
        plan.runs[-1], plan.first[-1], plan.cnt[-1], stages[-1], tables[-1],
        blocks=q[0], bw_in=bw_in, bw_out=bw_out, p_rows=t * p[-1], seg=seg,
        out_dtype=dt, mm=mm)
    out = _pool_flat(state, plan, tb, dt)
    return out.reshape(t, batch_size, d), tuple(stages)


def flat_lookup_backward(cores, tt_p_shapes, tt_q_shapes, tt_ranks,
                         batch_size, plan: FlatPlan, nza, stages, d_output,
                         compute_dtype=torch.float32, seg=SEG):
    """Backward of the flat lookup -> core gradients in module layout:
    kernel B3 pass by pass from the last core down, on the forward's staged
    states, then dG0 (see :func:`_grad_passes`)."""
    del nza  # the plan's arrays carry it
    p, q, r = tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(tt_ranks)
    ndim = len(p)
    t = cores[0].shape[0]
    d = int(np.prod(q))
    dt = compute_dtype
    g0f, _, tables, widths = _flat_setup(cores, p, q, r, dt)

    dz = _row_cotangents(d_output, plan, t * batch_size, d, dt)
    dgs = [None] * ndim
    _grad_passes(plan, stages, dz, ndim - 1, g0f, tables, widths, p, q, r, t,
                 dt, seg, dgs)
    return grads_to_module_layout(dgs, p, q, r, t)


def _lookup_plan(indices, rowidx, tableidx, weights, live, p, q, r,
                 num_tables, batch_size, compute_dtype, live_is_mask,
                 parts_mode):
    """Plan of one lookup (pair mode when ``_pair_gate`` allows)."""
    nza_est = _cdiv(rowidx.shape[0], SEG) * SEG
    itemsize = torch.empty((), dtype=compute_dtype).element_size()
    pair = _pair_gate(nza_est, num_tables, p, q, r, itemsize)
    return _build_plan(
        None if parts_mode else indices, rowidx, tableidx, weights,
        None if live_is_mask else live, p, num_tables, batch_size,
        dead_mask=live if live_is_mask else None,
        idx_parts=indices if parts_mode else None, seg=SEG, pair=pair)


class FlatLookup(torch.autograd.Function):
    """The pooled flat lookup with its gradient: the JAX package's
    ``make_flat_vjp``. Forward builds the plan and runs
    :func:`flat_lookup_forward`; the plan and the staged states are kept
    for :func:`flat_lookup_backward`, which gives the cores' gradients.
    Indices, weights and the live mask get none.

    ``apply(cfg, indices, rowidx, tableidx, weights, live, *cores)`` with
    ``cfg = (p, q, r, num_tables, batch_size, compute_dtype, live_is_mask,
    parts_mode)``."""

    @staticmethod
    def forward(ctx, cfg, indices, rowidx, tableidx, weights, live, *cores):
        p, q, r, num_tables, batch_size, cdt, live_is_mask, parts_mode = cfg
        plan, nza = _lookup_plan(indices, rowidx, tableidx, weights, live,
                                 p, q, r, num_tables, batch_size, cdt,
                                 live_is_mask, parts_mode)
        out, stages = flat_lookup_forward(cores, p, q, r, batch_size, plan,
                                          nza, compute_dtype=cdt, seg=SEG)
        if any(ctx.needs_input_grad[6:]):
            ctx.save_for_backward(*cores)
            ctx.cfg, ctx.plan, ctx.nza, ctx.stages = cfg, plan, nza, stages
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_output):
        p, q, r, _, batch_size, cdt, _, _ = ctx.cfg
        grads = flat_lookup_backward(
            ctx.saved_tensors, p, q, r, batch_size, ctx.plan, ctx.nza,
            ctx.stages, d_output.contiguous(), compute_dtype=cdt, seg=SEG)
        return (None,) * 6 + tuple(grads)


def flat_forward(cores: Sequence[torch.Tensor], indices, rowidx, tableidx,
                 weights, live, tt_p_shapes, tt_q_shapes, tt_ranks,
                 num_tables: int, batch_size: int,
                 compute_dtype=torch.float32, live_is_mask: bool = False,
                 parts_mode: bool = False) -> torch.Tensor:
    """Pooled flat lookup ``[T, B, D]`` through :class:`FlatLookup`, so
    cores that require grad get gradients.

    ``indices`` is a tuple of per-core parts when ``parts_mode``; ``live``
    is a ``[nnz]`` dead mask when ``live_is_mask``, else a ``[1]`` live
    count (or None)."""
    cfg = (tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(tt_ranks),
           num_tables, batch_size, compute_dtype, live_is_mask, parts_mode)
    return FlatLookup.apply(cfg, indices, rowidx, tableidx, weights, live,
                            *cores)


def flat_train_apply(cores, tt_p_shapes, tt_q_shapes, tt_ranks, batch_size,
                     indices, rowidx, tableidx, weights, dead_mask,
                     d_output, compute_dtype=torch.float32, idx_parts=None):
    """Forward and backward of the flat lookup in one pass structure, for
    the fused training step, where ``d_output`` is an input: one plan and
    one set of staged states serve both, and the last core runs as one
    fused pass (kernel B2: output rows, dZ and dG together). Returns
    (pooled output ``[T, B, D]`` float32, core gradients in module
    layout)."""
    p, q, r = tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(tt_ranks)
    ndim = len(p)
    t = cores[0].shape[0]
    tb = t * batch_size
    d = int(np.prod(q))
    dt = compute_dtype
    seg = SEG
    plan, _ = _lookup_plan(
        indices if idx_parts is None else idx_parts, rowidx, tableidx,
        weights, dead_mask, p, q, r, t, batch_size, dt, True,
        idx_parts is not None)
    g0f, gk, tables, widths = _flat_setup(cores, p, q, r, dt)
    stages = _pass_inputs(plan, g0f, gk, tables, widths, p, q, r, t, dt, seg)

    dz = _row_cotangents(d_output, plan, tb, d, dt)
    li = ndim - 1
    mm, bw_in, bw_out = widths[li - 1]
    dgs = [None] * ndim
    dgs[li], dz, rows = seg_fused_i2(
        plan.runs[li - 1], plan.first[li - 1], plan.cnt[li - 1],
        stages[li - 1], dz, tables[li - 1], blocks=q[0], bw_x=bw_in,
        bw_y=bw_out, p_rows=t * p[li], seg=seg, mm=mm)
    out = _pool_flat(rows, plan, tb, dt).reshape(t, batch_size, d)

    if li > 1:
        dz = dz[plan.perm_bwd[li - 2].long()]  # s_li -> s_li-1
    _grad_passes(plan, stages, dz, li - 1, g0f, tables, widths, p, q, r, t,
                 dt, seg, dgs)
    return out, grads_to_module_layout(dgs, p, q, r, t)
