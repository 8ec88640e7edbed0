"""Bag-order pool: per-lookup rows summed into their bags, from the flat
pipeline's rows and the cache's rows at once.

Replaces no Pallas kernel: the JAX package pools with a one-hot product on
the TPU's matrix unit up to ``_POOL_ONEHOT_MAX_TB`` bags and with
``segment_sum`` above (``ops/pallas/tt_flat.py :: _pool_flat``,
``models/tt_embedding.py :: _pool_cached_rows``). For every bag ``b``, over
its lookups ``j`` in lookup order::

    out[b] = sum_j  w_j * scale[loc_j] * cache[loc_j]   where loc_j >= 0
                  | round(w_j) * rows[slot_j]           where slot_j < live
                  | nothing                             otherwise

``bag`` is each lookup's bag id (table-major ``tableidx * B + rowidx``),
in any order; ids outside ``[0, tb)`` are dropped. Ids that never
decrease, as :func:`~fbtt_embedding_tpu_torch.ops.indexing.
rowidx_from_offsets` gives them, are the kernel's fast route; others cost
it a grouping pass, and pool to the same sums. ``rows`` (bfloat16 or float32) are read at ``slot`` (a map from
lookup to row, e.g. the flat plan's last sort space; None: ``rows[j]``);
slots at or past ``live`` (a device scalar: the plan's dead and pad span)
add nothing. ``cache`` (:class:`CacheRows`: the cache's rows, float32 or
int8 with per-row scales, and each lookup's row, -1 where not cached) takes
precedence for the lookups it serves. ``w_j`` is 1 where no weights are
given; for the ``rows`` source it is rounded to the rows' dtype up to
``_POOL_ONEHOT_MAX_TB`` bags, as the one-hot product rounds it. The output
is float32 ``[tb, D]``.

On a CUDA tensor :func:`bag_pool` launches the hand-written kernels of
``csrc/bag_pool.cu`` (bag starts, a grouping pass that runs only on ids
out of order, then eight lanes a bag summing its rows in lookup order: no
atomics on the sums, bitwise repeatable, each row read once) at
every ``tb``, or raises; the kernel route is not differentiable, so rows
that require grad raise there. On a CPU tensor it runs
:func:`bag_pool_plain`: the lookups' terms gathered, then the one-hot
product up to ``_POOL_ONEHOT_MAX_TB`` bags and the deterministic
``segment_sum`` above. Launches are counted in ``profiling``'s
``launches.bag_pool``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from fbtt_embedding_tpu_torch.ops.hot_scatter import segment_sum
from fbtt_embedding_tpu_torch.utils import profiling

# the plain route's one-hot product up to this many bags, segment_sum above;
# also where the rows' weights stop being rounded to their dtype
_POOL_ONEHOT_MAX_TB = 4096
_ROW_DTYPES = (torch.float32, torch.bfloat16)
_CACHE_DTYPES = (torch.float32, torch.int8)


class CacheRows(NamedTuple):
    """The cache-served lookups of a pool: the cache's rows ``[C, D]``
    (float32, or int8 with ``scale``, their per-row float32 scales) and
    each lookup's row in lookup order (``locations``; -1: not cached)."""

    rows: torch.Tensor
    locations: torch.Tensor
    scale: Optional[torch.Tensor] = None


def _check(bag, tb, rows, slot, live, weights, cache):
    """-> (n lookups, D). Raises ValueError on inputs of the wrong shape."""
    if bag.dim() != 1:
        raise ValueError(f"bag_pool: bag must be [n], got {tuple(bag.shape)}")
    n = bag.shape[0]
    if rows is None and cache is None:
        raise ValueError("bag_pool: give rows, cache or both")
    widths = set()
    if rows is not None:
        if rows.dim() != 2:
            raise ValueError("bag_pool: rows must be [*, D]")
        widths.add(rows.shape[1])
        if slot is None and rows.shape[0] < n:
            raise ValueError("bag_pool: rows without slot need one per lookup")
        if slot is not None and (slot.dim() != 1 or slot.shape[0] < n):
            raise ValueError("bag_pool: slot must hold one entry per lookup")
        if live is not None and live.numel() != 1:
            raise ValueError("bag_pool: live must be one number")
    if cache is not None:
        if cache.rows.dim() != 2:
            raise ValueError("bag_pool: cache rows must be [C, D]")
        widths.add(cache.rows.shape[1])
        if cache.locations.shape != (n,):
            raise ValueError("bag_pool: cache locations must be [n]")
        if cache.scale is not None and \
                cache.scale.shape != cache.rows.shape[:1]:
            raise ValueError("bag_pool: cache scale must be [C]")
    if len(widths) != 1:
        raise ValueError(f"bag_pool: rows and cache rows differ in width "
                         f"{sorted(widths)}")
    if weights is not None and (weights.dim() != 1 or weights.shape[0] < n):
        raise ValueError("bag_pool: weights must hold one per lookup")
    if tb < 0:
        raise ValueError(f"bag_pool: tb {tb} < 0")
    return n, widths.pop()


def bag_pool_plain(bag, tb: int, *, rows=None, slot=None, live=None,
                   weights=None, cache: Optional[CacheRows] = None):
    """Plain PyTorch version: each lookup's term (its row and its factor)
    gathered in lookup order, then the one-hot product up to
    ``_POOL_ONEHOT_MAX_TB`` bags, ``segment_sum`` above."""
    n, d = _check(bag, tb, rows, slot, live, weights, cache)
    dev = bag.device
    w = (weights[:n].float() if weights is not None
         else torch.ones(n, dtype=torch.float32, device=dev))
    terms = None
    f = torch.zeros(n, dtype=torch.float32, device=dev)
    if rows is not None:
        s = (torch.arange(n, device=dev) if slot is None
             else slot[:n].long())
        terms = rows[s].float()
        f = w.to(rows.dtype).float() if tb <= _POOL_ONEHOT_MAX_TB else w
        if live is not None:
            f = torch.where(s < live.reshape(()), f,
                            torch.zeros((), device=dev))
    if cache is not None:
        hit = cache.locations >= 0
        loc = cache.locations.clamp(min=0).long()
        crows = cache.rows[loc].float()
        fc = w if cache.scale is None else cache.scale[loc] * w
        terms = crows if terms is None else torch.where(hit[:, None], crows,
                                                        terms)
        f = torch.where(hit, fc, f)
    seg = bag.long()
    if tb <= _POOL_ONEHOT_MAX_TB:
        iota = torch.arange(tb, dtype=seg.dtype, device=dev)
        oh = torch.where(seg[None, :] == iota[:, None], f[None, :],
                         torch.zeros((), device=dev))
        return torch.matmul(oh, terms)
    return segment_sum(terms * f[:, None], seg, tb)


def bag_pool(bag, tb: int, *, rows=None, slot=None, live=None, weights=None,
             cache: Optional[CacheRows] = None) -> torch.Tensor:
    """Float32 ``[tb, D]``: the lookups' rows summed into their bags in
    lookup order — see the module docstring."""
    if bag.device.type == "cpu":
        return bag_pool_plain(bag, tb, rows=rows, slot=slot, live=live,
                              weights=weights, cache=cache)
    if bag.device.type != "cuda":
        raise ValueError(f"bag_pool runs on cpu or cuda, not {bag.device}")
    n, d = _check(bag, tb, rows, slot, live, weights, cache)
    sources = [t for t in (rows, None if cache is None else cache.rows)
               if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in sources):
        raise ValueError("bag_pool: the kernel route is not differentiable; "
                         "its rows must not require grad")
    if rows is not None and rows.dtype not in _ROW_DTYPES:
        raise ValueError(f"bag_pool: rows must be float32 or bfloat16, not "
                         f"{rows.dtype}")
    if cache is not None and cache.rows.dtype not in _CACHE_DTYPES:
        raise ValueError(f"bag_pool: cache rows must be float32 or int8, not "
                         f"{cache.rows.dtype}")
    if max(n, tb + 1) >= 2 ** 31:
        raise ValueError(f"bag_pool: {n} lookups, {tb} bags: past int32")
    # the inputs, contiguous copies in the kernel's dtypes where they are
    # not (kept alive until the launch is queued), and their pointers
    held = {}
    for name, t, dtype in (
            ("bag", bag, torch.int32), ("slot", slot, torch.int32),
            ("live", live, torch.int32), ("w", weights, torch.float32),
            ("rows", rows, None if rows is None else rows.dtype),
            ("cache", None if cache is None else cache.rows,
             None if cache is None else cache.rows.dtype),
            ("loc", None if cache is None else cache.locations, torch.int32),
            ("scale", None if cache is None else cache.scale,
             torch.float32)):
        if t is None:
            continue
        if t.device != bag.device:
            raise ValueError(f"bag_pool: {name} on {t.device}, bag on "
                             f"{bag.device}")
        if t.dtype != dtype or not t.is_contiguous():
            t = t.to(dtype=dtype).contiguous()
        held[name] = t
    ptr = {k: (held[k].data_ptr() if k in held else 0) for k in (
        "bag", "slot", "live", "w", "rows", "cache", "loc", "scale")}
    # eight adjacent columns a lane, one vector load, where widths and
    # alignment allow
    vec = d % 8 == 0 and all(held[k].data_ptr() % 16 == 0
                             for k in ("rows", "cache") if k in held)
    rows_bf16 = rows is not None and rows.dtype == torch.bfloat16
    # the bags' starts and the out-of-order flag; the grouping's order
    start = torch.empty(tb + 2, dtype=torch.int32, device=bag.device)
    order = torch.empty(n, dtype=torch.int32, device=bag.device)
    out = torch.empty((tb, d), dtype=torch.float32, device=bag.device)
    lib = _lib()
    with torch.cuda.device(bag.device):
        stream = torch.cuda.current_stream(bag.device).cuda_stream
        err = lib.fbtt_bag_pool(
            ptr["bag"], n, tb, d, start.data_ptr(), order.data_ptr(),
            ptr["rows"], int(rows_bf16), ptr["slot"], ptr["live"], ptr["w"],
            int(rows_bf16 and tb <= _POOL_ONEHOT_MAX_TB), ptr["cache"],
            int(cache is not None and cache.rows.dtype == torch.int8),
            ptr["loc"], ptr["scale"], out.data_ptr(), int(vec), stream)
    if err != 0:
        raise RuntimeError("bag_pool launch failed: "
                           + lib.fbtt_error_string(err).decode())
    profiling.count("launches.bag_pool")
    return out


def _lib():
    from fbtt_embedding_tpu_torch.ops.kernels._build import library

    lib = library("bag_pool")
    if lib.fbtt_bag_pool.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.fbtt_bag_pool.argtypes = [p, i, i, i, p, p, p, i, p, p, p, i, p,
                                      i, p, p, p, i, p]
        lib.fbtt_bag_pool.restype = ctypes.c_int
        lib.fbtt_error_string.argtypes = [ctypes.c_int]
        lib.fbtt_error_string.restype = ctypes.c_char_p
    return lib
