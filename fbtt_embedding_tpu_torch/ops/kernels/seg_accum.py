"""Sorted-run gradient pass: the backward kernel of the flat pipeline (B3).

Counterpart of ``fbtt_embedding_tpu/ops/pallas/tt_flat.py ::
_seg_accum_call`` (through ``_seg_accum``). Lookups sorted by one core index
j form spans ``runs[j] .. runs[j+1]`` of the sorted order; for every span
``j < p_rows`` and each of ``blocks`` lane-blocks ``b``::

    acc[j]         += sum_b x_b[rows of j]^T @ y_b[rows of j]    (float32)
    z_b[rows of j]  = y_b[rows of j] @ T[j]^T

where ``T[j]`` is the ``[bw_x, bw_y]`` slab at rows ``j * bw_x`` of the
stacked table. ``acc`` comes back in the canonical ``[p_rows, bw_x, bw_y]``
float32 layout (the TPU kernel's transposed accumulator and scratch tail
are not carried over); ``z`` is rounded once to ``z_dtype``. Rows of the
sentinel span and the ``acc`` of an empty span are exact zeros.

The block-diagonal fold, ``mm > 1``: the table is ``kron(I_mm, G[j])``
with ``G[j]`` its first diagonal block ``[bw_x/mm, bw_y/mm]``, which is all
that is read. Each lane-block of x and y is ``mm`` sub-blocks of widths
``bw_x/mm`` and ``bw_y/mm``; ``z`` is the same tensor as unfolded, and
``acc`` comes back as ``[p_rows, bw_x/mm, bw_y/mm]``, the sum of the
diagonal blocks in block order (what ``_extract_bd_grad`` gives of the
unfolded ``acc``). Widths that are not multiples of ``mm`` raise.

On a CUDA tensor :func:`seg_accum` launches the hand-written kernels of
``csrc/seg_accum.cu`` (segment-parallel partial gradient tiles, added per
span in a fixed order: no float atomics, bitwise repeatable) or raises. On
a CPU tensor it runs :func:`seg_accum_plain`, the same contract in plain
PyTorch. Launches are counted in ``profiling``'s ``launches.seg_accum``.

Kernel 2, the span reduce that B2, B3 and B6 share (``csrc/seg_span.cuh``),
adds span j's partial tiles (one per segment the span meets) into
``acc[j]``. A span of more than :func:`span_chunk` tiles (a hot core row
under Zipf traffic meets most segments) is added in chunks of that many
consecutive tiles, one CTA a chunk, and then its chunk sums in chunk
order; :func:`span_reduce_sched_plain` models that order, and
:func:`span_reduce` runs the kernel alone. While spans are on, each call
that launches it adds its split spans to the counter
``span_reduce.split_spans`` (on the CPU route, those the kernel would
split).

Widths the kernels take, after folding (``kx = bw_x/mm``, ``ky =
bw_y/mm``; every dense width a multiple of 8 up to 2048): ``kx`` a
multiple of 8, and either ``ky <= 8`` with ``kx <= 256`` (the narrow
path) or ``ky`` a multiple of 8 (the CUDA-core path); in bfloat16, where
a segment's rows fit 227 KB of shared memory, B3 passes with ``kx`` and
``ky`` multiples of 16 run on the tensor cores, and B2 and B3 passes with
``kx`` 16, 32 or 64 and ``ky`` 2, 4 or 8 on the narrow tensor cores. Where the
full fold is not taken, the wrapper folds by the largest divisor of
``mm`` that is and adds the remaining diagonal blocks of ``acc`` itself;
it raises when even ``mm = 1`` is not taken.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from fbtt_embedding_tpu_torch.utils import profiling

_DTYPES = (torch.float32, torch.bfloat16)
# the CUDA-core path stages slabs in 64 KB float chunks of at least 8 rows
# or columns, so no width may pass 64 KB / (8 * 4 bytes)
_MAX_WIDTH = 2048
# what each value of the library's path query means
PATH_NAMES = {3: "narrow tensor cores", 2: "tensor cores", 1: "narrow",
              0: "CUDA cores"}
_THREADS = 256  # a CTA of kernel 2
SPLIT_SPANS = "span_reduce.split_spans"


def span_of_rows(runs: torch.Tensor, nza: int, p_rows: int):
    """(span index of every sorted row, clamped to a live span; live mask):
    each row finds its span in ``runs`` by searchsorted."""
    rows = torch.arange(nza, dtype=runs.dtype, device=runs.device)
    span = torch.searchsorted(runs, rows, right=True) - 1
    live = span < p_rows
    return span.clamp(max=max(p_rows - 1, 0)).long(), live


def span_outer_sum(x, y, span, live, blocks, bw_x, bw_y, p_rows):
    """Plain ``acc[j] = sum over live rows of j and blocks of x_b^T y_b``:
    per-row outer products, then one float32 one-hot product by span."""
    nza = x.shape[0]
    xb = x.reshape(nza, blocks, bw_x).float()
    yb = y.reshape(nza, blocks, bw_y).float()
    outer = torch.bmm(xb.transpose(1, 2), yb).reshape(nza, bw_x * bw_y)
    iota = torch.arange(p_rows, device=x.device)
    oh = ((span[None, :] == iota[:, None]) & live[None, :]).float()
    return torch.matmul(oh, outer).reshape(p_rows, bw_x, bw_y)


def folded_slabs(table, p_rows, bw_x, bw_y, mm):
    """``G[j]``, the first ``[bw_x/mm, bw_y/mm]`` diagonal block of every
    slab ``T[j] = kron(I_mm, G[j])``: ``[p_rows, bw_x/mm, bw_y/mm]``."""
    slabs = table[:p_rows * bw_x].reshape(p_rows, bw_x, bw_y)
    return slabs[:, :bw_x // mm, :bw_y // mm]


def diag_block_sum(acc: torch.Tensor, n: int) -> torch.Tensor:
    """``[p, n*a, n*b]`` -> the sum of its ``n`` diagonal ``[a, b]``
    blocks, in block order."""
    if n == 1:
        return acc
    a, b = acc.shape[1] // n, acc.shape[2] // n
    out = acc[:, :a, :b]
    for i in range(1, n):
        out = out + acc[:, i * a:(i + 1) * a, i * b:(i + 1) * b]
    return out.contiguous()


def seg_accum_plain(runs, first, cnt, x, y, table, *, blocks, bw_x, bw_y,
                    p_rows, seg, z_dtype: Optional[torch.dtype] = None,
                    mm: int = 1):
    """Plain PyTorch version: each row finds its span in ``runs``; the
    products run batched in float32 on the folded sub-blocks. It derives
    everything from ``runs``; ``first``/``cnt``/``seg`` are the kernel's
    schedule and are accepted only so that both versions take the same
    arguments."""
    del first, cnt, seg
    z_dtype = z_dtype or x.dtype
    nza = x.shape[0]
    nb, kx, ky = blocks * mm, bw_x // mm, bw_y // mm
    span, live = span_of_rows(runs, nza, p_rows)
    slabs = folded_slabs(table, p_rows, bw_x, bw_y, mm)[span].float()
    z = torch.bmm(y.reshape(nza, nb, ky).float(), slabs.transpose(1, 2))
    z = torch.where(live[:, None, None], z, torch.zeros((), device=z.device))
    acc = span_outer_sum(x, y, span, live, nb, kx, ky, p_rows)
    return acc, z.reshape(nza, blocks * bw_x).to(z_dtype)


def span_chunk(nseg: int, p_rows: int) -> int:
    """Tiles of one span that a CTA of kernel 2 adds, for ``nseg``
    segments and ``p_rows`` spans; 0 for one chunk a span (kernel 2's
    single pass). A span has at most ``nseg``
    tiles; chunks of C take C tiles in the first pass and at most nseg / C
    chunk sums in the second, in chains of loads that a thread group adds
    in order. So C = ceil(sqrt(nseg + p_rows)) keeps both chains of the
    largest span a batch can have near its square root, whatever the
    tile's width (which sets the thread groups, dividing both alike); where
    C reaches nseg no span splits. On the H100, kernel 2 alone over the
    spans of Zipf(1.05) ids at pooling 20 (``check_dg0_kernel.py
    --chunks``), device us at chunk 0 (one a span) / the rule's / the best
    of 8 to 512: B=65536 (nseg 20480), tile 4096: 1331 / 140 (C 144) /
    140 (128); tile 8192: 1396 / 262 / 260 (128); tile 128 (p_rows 250):
    15.7 / 8.8 / 8.8 (128); B=4096 (nseg 1280): 48.6 / 15.4 (C 39) / 14.6
    (32); B=512 (nseg 160): 7.6 / 9.3 (C 20) / 9.1 (16), uniform core rows
    3.9 / 7.5: the two more launches cost ~3.6 us, and inside B6 at B=512
    the split reads 9.9 against the single pass's 10.8."""
    chunk = math.isqrt(max(nseg + p_rows - 1, 0)) + 1
    return chunk if chunk < nseg else 0


def reduce_sched_ints(nseg: int, p_rows: int, chunk: int) -> int:
    """Ints of kernel 2's schedule at ``chunk`` (``sched`` of
    ``csrc/seg_span.cuh``): span j's first chunk (p_rows + 1), the split
    spans' count and p_rows less it, the split spans (p_rows), each chunk's
    span (at most ceil((nseg + p_rows) / chunk) + p_rows chunks)."""
    return 2 * p_rows + 3 + -(-(nseg + p_rows) // chunk) + p_rows


def reduce_schedule(nseg: int, p_rows: int, device):
    """``(chunk, sched)`` for a launch of kernel 2: :func:`span_chunk`'s
    chunk and an int32 scratch for its schedule on ``device`` (None at
    chunk 0)."""
    chunk = span_chunk(nseg, p_rows)
    if chunk == 0:
        return 0, None
    return chunk, torch.empty((reduce_sched_ints(nseg, p_rows, chunk),),
                              dtype=torch.int32, device=device)


def span_tiles(runs: torch.Tensor, p_rows: int, seg: int):
    """(partial tiles of each span j < p_rows, one per segment it meets;
    the slot of its first, s + j for its first segment s): int64 [p_rows]
    each."""
    st = runs[:p_rows].long()
    en = runs[1:p_rows + 1].long()
    n = torch.where(en > st, (en - 1) // seg - st // seg + 1,
                    torch.zeros_like(st))
    return n, st // seg + torch.arange(p_rows, device=runs.device)


def count_split_spans(runs, nseg: int, p_rows: int, seg: int,
                      sched: Optional[torch.Tensor] = None) -> None:
    """While spans are on, add to ``span_reduce.split_spans`` the spans
    whose tiles kernel 2 adds in more than one chunk: p_rows less the
    count of the others that the card's schedule pass wrote to ``sched``
    (one device operation, no synchronisation), or without ``sched`` (the
    CPU route) the same count from ``runs``."""
    chunk = span_chunk(nseg, p_rows)
    if chunk == 0 or not profiling.enabled():
        return
    if sched is None:
        unsplit = (span_tiles(runs, p_rows, seg)[0] <= chunk).sum()
    else:
        unsplit = sched[p_rows + 2]
    profiling.count(SPLIT_SPANS, p_rows, less=unsplit)


def span_reduce_sched_plain(runs, partial, *, p_rows, seg,
                            chunk: Optional[int] = None):
    """Kernel 2's schedule in plain PyTorch (the tests hold it against a
    plain per-span sum and the card against it; no path runs it on the
    card). ``partial`` is ``[nseg + p_rows, tile]``, span j's tiles at the
    slots of :func:`span_tiles`; ``chunk`` defaults to :func:`span_chunk`'s.
    Each CTA's sum, per float32 column: ``_THREADS // min(tile/4,
    _THREADS)`` thread groups each add a contiguous range of its tiles in
    slot order, and the groups' sums are added in group order. At chunk 0
    one CTA adds a span's tiles into acc[j]. Else a span's tiles are cut
    into chunks of ``chunk`` consecutive tiles: a span of one chunk (or
    none) gets acc[j] so; a split span's chunk sums are written over each
    chunk's first tile, then added, one CTA a span, in chunk order. Returns
    ``(acc [p_rows, tile] float32, chunks of each span [p_rows])``."""
    tile = partial.shape[1]
    nseg = partial.shape[0] - p_rows
    if chunk is None:
        chunk = span_chunk(nseg, p_rows)
    groups = _THREADS // min(tile // 4, _THREADS)
    part = partial.float().clone()

    def ordered(slots):
        total = None
        for g in range(groups):
            s = torch.zeros(tile, dtype=torch.float32)
            for slot in slots[len(slots) * g // groups:
                              len(slots) * (g + 1) // groups]:
                s = s + part[slot]
            total = s if total is None else total + s
        return total

    n, first = span_tiles(runs.cpu(), p_rows, seg)
    acc = torch.zeros((p_rows, tile), dtype=torch.float32)
    nch = torch.ones(p_rows, dtype=torch.int64)
    for j in range(p_rows):
        nj, fj = int(n[j]), int(first[j])
        size = chunk if chunk > 0 else max(nj, 1)
        heads = list(range(fj, fj + max(nj, 1), size))
        sums = [ordered(list(range(h, min(fj + nj, h + size))))
                for h in heads]
        nch[j] = len(heads)
        if len(heads) == 1:
            acc[j] = sums[0]
            continue
        for h, chunk_sum in zip(heads, sums):
            part[h] = chunk_sum
        acc[j] = ordered(heads)
    return acc, nch


def check_pass(name, runs, first, cnt, x, y, table, blocks, bw_x, bw_y,
               p_rows, seg, out_dtypes, mm=1):
    """Raise ValueError on inputs the gradient kernels do not take."""
    nseg = first.shape[0]
    for tname, t in (("runs", runs), ("first", first), ("cnt", cnt)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name}: {tname} must be 1-D int32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if cnt.shape[0] != nseg:
        raise ValueError(f"{name}: first and cnt need one entry per segment")
    if runs.shape[0] < p_rows + 2:
        raise ValueError(f"{name}: runs needs >= p_rows + 2 = {p_rows + 2} "
                         f"entries, got {runs.shape[0]}")
    if mm < 1 or bw_x % mm or bw_y % mm:
        raise ValueError(f"{name}: the fold mm={mm} must divide both widths "
                         f"{bw_x} and {bw_y}")
    if x.dtype not in _DTYPES or y.dtype != x.dtype or table.dtype != x.dtype:
        raise ValueError(f"{name}: x, y and table must share float32 or "
                         f"bfloat16, got {x.dtype}, {y.dtype}, {table.dtype}")
    for dt in out_dtypes:
        if dt not in _DTYPES:
            raise ValueError(f"{name}: output dtype must be float32 or "
                             f"bfloat16, got {dt}")
    nza = nseg * seg
    if x.dim() != 2 or tuple(x.shape) != (nza, blocks * bw_x):
        raise ValueError(f"{name}: x must be [nseg*seg, blocks*bw_x] = "
                         f"[{nza}, {blocks * bw_x}], got {tuple(x.shape)}")
    if y.dim() != 2 or tuple(y.shape) != (nza, blocks * bw_y):
        raise ValueError(f"{name}: y must be [nseg*seg, blocks*bw_y] = "
                         f"[{nza}, {blocks * bw_y}], got {tuple(y.shape)}")
    if (table.dim() != 2 or table.shape[1] != bw_y
            or table.shape[0] < p_rows * bw_x):
        raise ValueError(f"{name}: table must be [>= {p_rows * bw_x}, "
                         f"{bw_y}], got {tuple(table.shape)}")
    devs = {t.device for t in (runs, first, cnt, x, y, table)}
    if len(devs) != 1:
        raise ValueError(f"{name}: all inputs must be on one device, got "
                         f"{devs}")


def check_cuda(name, tensors, bw_x, bw_y):
    """Raise ValueError on CUDA inputs the kernel's layout does not take:
    contiguous, 16-byte aligned rows, widths multiples of 8 up to
    2048."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    if bw_x % 8 or bw_y % 8 or max(bw_x, bw_y) > _MAX_WIDTH:
        raise ValueError(f"{name}: widths {bw_x}, {bw_y} must be multiples "
                         f"of 8 up to {_MAX_WIDTH}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs 16-byte aligned inputs")


def kernel_fold(name, path_fn, in_bf16, seg, blocks, bw_x, bw_y, mm):
    """``(mm', path)``: the largest divisor ``mm'`` of ``mm`` whose folded
    widths the kernel stages, and the path it takes there (see
    :data:`PATH_NAMES`). Raises ValueError when not even ``mm' = 1``
    stages."""
    for d in range(mm, 0, -1):
        if mm % d == 0:
            path = path_fn(int(in_bf16), seg, blocks, bw_x, bw_y, d)
            if path >= 0:
                return d, path
    raise ValueError(f"{name}: no kernel path stages widths {bw_x} x {bw_y} "
                     f"at any fold of mm={mm}")


_FOLDS = {}


def cached_fold(name, path_fn, *args):
    """:func:`kernel_fold` of kernel ``name``'s library, asked once per
    arguments (the wrappers run on every training step)."""
    key = (name, *args)
    if key not in _FOLDS:
        _FOLDS[key] = kernel_fold(name, path_fn, *args)
    return _FOLDS[key]


def seg_accum(runs, first, cnt, x, y, table, *, blocks, bw_x, bw_y, p_rows,
              seg, z_dtype: Optional[torch.dtype] = None, mm: int = 1):
    """``(acc [p_rows, bw_x/mm, bw_y/mm] float32, z [nseg*seg,
    blocks*bw_x])`` — see the module docstring."""
    z_dtype = z_dtype or x.dtype
    check_pass("seg_accum", runs, first, cnt, x, y, table, blocks, bw_x,
               bw_y, p_rows, seg, (z_dtype,), mm)
    nseg = first.shape[0]
    if x.device.type == "cpu":
        count_split_spans(runs, nseg, p_rows, seg)
        return seg_accum_plain(
            runs, first, cnt, x, y, table, blocks=blocks, bw_x=bw_x,
            bw_y=bw_y, p_rows=p_rows, seg=seg, z_dtype=z_dtype, mm=mm)
    if x.device.type != "cuda":
        raise ValueError(f"seg_accum runs on cpu or cuda, not {x.device}")
    check_cuda("seg_accum", (runs, first, cnt, x, y, table), bw_x, bw_y)
    lib = _lib()
    in_bf16 = x.dtype == torch.bfloat16
    fold, _ = cached_fold("seg_accum", lib.fbtt_seg_accum_path, in_bf16, seg,
                          blocks, bw_x, bw_y, mm)
    kx, ky = bw_x // fold, bw_y // fold
    dev = x.device
    z = torch.empty((nseg * seg, blocks * bw_x), dtype=z_dtype, device=dev)
    acc = torch.empty((p_rows, kx, ky), dtype=torch.float32, device=dev)
    partial = torch.empty((nseg + p_rows, kx * ky), dtype=torch.float32,
                          device=dev)
    chunk, sched = reduce_schedule(nseg, p_rows, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fbtt_seg_accum(
            runs.data_ptr(), first.data_ptr(), cnt.data_ptr(), x.data_ptr(),
            y.data_ptr(), table.data_ptr(), z.data_ptr(), partial.data_ptr(),
            acc.data_ptr(), _ptr(sched), nseg, seg, blocks, bw_x, bw_y, fold,
            p_rows, chunk, int(in_bf16), int(z_dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError("seg_accum launch failed: "
                           + lib.fbtt_error_string(err).decode())
    profiling.count("launches.seg_accum")
    count_split_spans(runs, nseg, p_rows, seg, sched)
    return diag_block_sum(acc, mm // fold), z


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's address for ctypes, None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def span_reduce(runs, partial, *, p_rows, seg):
    """Kernel 2 alone: ``acc [p_rows, tile]`` float32, span j's partial
    tiles of ``partial`` (``[nseg + p_rows, tile]`` float32, contiguous;
    the tiles of :func:`span_tiles`) added as B2, B3 and B6 add them. On
    the card the chunk sums of split spans overwrite tiles of ``partial``;
    on the CPU it runs :func:`span_reduce_sched_plain`. Not on the lookup
    path: for the tests and for timing the kernel."""
    if (partial.dtype != torch.float32 or partial.dim() != 2
            or partial.shape[0] < p_rows or partial.shape[1] % 4
            or runs.dtype != torch.int32 or runs.shape[0] < p_rows + 1):
        raise ValueError("span_reduce: partial must be [nseg + p_rows, tile] "
                         "float32 with tile a multiple of 4 and runs int32 "
                         f"with > p_rows entries, got {partial.dtype} "
                         f"{tuple(partial.shape)}, {runs.dtype} "
                         f"{tuple(runs.shape)}")
    nseg, tile = partial.shape[0] - p_rows, partial.shape[1]
    if partial.device.type == "cpu":
        count_split_spans(runs, nseg, p_rows, seg)
        return span_reduce_sched_plain(runs, partial, p_rows=p_rows,
                                       seg=seg)[0]
    if not (runs.is_contiguous() and partial.is_contiguous()) \
            or partial.data_ptr() % 16 or runs.device != partial.device:
        raise ValueError("span_reduce needs contiguous inputs on one device "
                         "and 16-byte aligned tiles")
    dev = partial.device
    acc = torch.empty((p_rows, tile), dtype=torch.float32, device=dev)
    chunk, sched = reduce_schedule(nseg, p_rows, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.fbtt_span_reduce(
            runs.data_ptr(), partial.data_ptr(), acc.data_ptr(), _ptr(sched),
            nseg, seg, tile, p_rows, chunk,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("span_reduce launch failed: "
                           + lib.fbtt_error_string(err).decode())
    count_split_spans(runs, nseg, p_rows, seg, sched)
    return acc



def _lib():
    from fbtt_embedding_tpu_torch.ops.kernels._build import library

    lib = library("seg_accum")
    if lib.fbtt_seg_accum.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.fbtt_seg_accum.argtypes = [p] * 10 + [i] * 10 + [p]
        lib.fbtt_seg_accum.restype = ctypes.c_int
        lib.fbtt_span_reduce.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.fbtt_span_reduce.restype = ctypes.c_int
        lib.fbtt_seg_accum_path.argtypes = [i] * 6
        lib.fbtt_seg_accum_path.restype = ctypes.c_int
        lib.fbtt_error_string.argtypes = [ctypes.c_int]
        lib.fbtt_error_string.restype = ctypes.c_char_p
    return lib
