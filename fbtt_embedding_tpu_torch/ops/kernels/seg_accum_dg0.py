"""Innermost gradient pass with the first-core gradient fused (kernel B6).

Counterpart of ``fbtt_embedding_tpu/ops/pallas/tt_flat.py ::
_seg_accum_dg0_call`` (through ``_seg_accum_i1``). On the i1 pass of the
flat pipeline's backward it computes what :func:`seg_accum` does there and
adds the first core's gradient::

    acc[j]          += sum_b x_b[rows of j]^T @ y_b[rows of j]   (float32)
    dz0[rows of j]   = y[rows of j] @ T[j]^T                      (float32)
    dG0[i0c[r]]     += dz0[r]                                     (float32)

``acc`` comes back as ``[p_rows, bw_x, bw_y]`` and ``dG0`` as
``[tp0, blocks*bw_x]``, both float32; ``dz0`` itself is never returned.
Rows whose ``i0c`` is the sentinel ``tp0`` (dead and padded lookups) are
dropped from ``dG0``.

On a CUDA tensor :func:`seg_accum_dg0` launches the hand-written kernels of
``csrc/seg_accum_dg0.cu`` (per-segment partial rows keyed by i0, added in
a fixed order: no float atomics, bitwise repeatable) or raises. On a CPU
tensor it runs :func:`seg_accum_dg0_plain`: B3's plain version and the
float32 one-hot product of the port's ``_dg0``. Launches are counted in
``seg_accum_dg0.launches`` (one per call, whatever the kernel's own launch
count). :func:`seg_accum_dg0_sched_plain` models the kernels' schedule in
plain PyTorch, for the tests.

The kernel's first pass takes one of three paths (:func:`dg0_path`, the
rule of the library's ``fbtt_seg_accum_dg0_path``): in bfloat16 with
``bw_x`` and ``bw_y`` multiples of 16, B3's tensor-core pass with each
segment's float32 dz0 rows written over its own y rows in shared memory
(``bw_x <= 64`` and ``2*bw_x <= bw_y + 8``) or in a tile of their own;
else the CUDA-core pass, whose dz0 tile ``[seg, blocks*bw_x]`` must fit
128 KB (``blocks*bw_x <= 512`` at ``seg = 64``). Every path needs
``blocks*bw_x <= 1024``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import (
    check_cuda,
    check_pass,
    seg_accum_plain,
    span_of_rows,
)

# what each value of the library's path query means
PATH_NAMES = {2: "tensor cores, dz0 over y", 1: "tensor cores, dz0 tile",
              0: "CUDA cores"}
# the library's limits (csrc/seg_accum_dg0.cu, csrc/seg_span.cuh)
_THREADS = 256
_SMEM_MAX = 227 * 1024
_MAX_WIDTH = 2048
_MAX_ZTILE = 128 * 1024         # the CUDA-core path's dz0 tile, bytes
_TC_PAD = 8                     # bf16 elements of padding per staged row
_IN_PLACE_PASSES = 2            # 32-column z passes held: bw_x <= 64
_RED_FLOATS = _THREADS * 16
_CHUNK_FLOATS = 64 * 1024 // 4
_NO_KEY = 2 ** 31 - 1


def _key_bytes(seg):
    """Kernel 1's key arrays: four of ``seg`` ints and two counts a warp."""
    return (4 * seg + 2 * _THREADS // 32) * 4


def _tc_smem(seg, blocks, bw_x, bw_y):
    """B3's tensor-core staging: x and y rows and two slabs, padded bf16."""
    items = seg * blocks
    return 2 * (items * (bw_x + _TC_PAD) + items * (bw_y + _TC_PAD)
                + 2 * bw_x * (bw_y + _TC_PAD))


def dg0_takes(path: int, in_bf16: bool, seg: int, blocks: int, bw_x: int,
              bw_y: int) -> bool:
    """Whether the kernel's first pass on ``path`` (see :data:`PATH_NAMES`)
    takes these widths: the library's rule, for code that runs on the
    CPU."""
    if (min(seg, blocks, bw_x, bw_y) <= 0 or bw_x % 8 or bw_y % 8
            or max(bw_x, bw_y) > _MAX_WIDTH
            or blocks * bw_x > 4 * _THREADS):
        return False
    if path == 0:
        kc = min(bw_x, max(8, _CHUNK_FLOATS // bw_y // 8 * 8))
        smem = (kc * bw_y + _RED_FLOATS + seg * blocks * bw_x) * 4
        return (seg * blocks * bw_x * 4 <= _MAX_ZTILE
                and smem + _key_bytes(seg) <= _SMEM_MAX)
    if path not in (1, 2) or not in_bf16 or bw_x % 16 or bw_y % 16 \
            or (seg * blocks) % 16:
        return False
    tc = _tc_smem(seg, blocks, bw_x, bw_y) + _key_bytes(seg)
    if path == 2:
        return (bw_x <= 32 * _IN_PLACE_PASSES and 2 * bw_x <= bw_y + _TC_PAD
                and tc <= _SMEM_MAX)
    return tc + seg * blocks * (bw_x + 8) * 4 <= _SMEM_MAX


def dg0_path(in_bf16: bool, seg: int, blocks: int, bw_x: int, bw_y: int,
             card: bool = False) -> int:
    """The path the kernel's first pass takes on these widths (2, 1 or 0,
    see :data:`PATH_NAMES`), or -1 where none does. With ``card`` the
    library answers (``fbtt_seg_accum_dg0_path``, asked once per shape),
    as the launch uses it; without, its Python copy, :func:`dg0_takes`."""
    if card:
        return _card_path(bool(in_bf16), seg, blocks, bw_x, bw_y)
    for path in (2, 1, 0):
        if dg0_takes(path, in_bf16, seg, blocks, bw_x, bw_y):
            return path
    return -1


@functools.lru_cache(maxsize=None)
def _card_path(in_bf16, seg, blocks, bw_x, bw_y):
    return _lib().fbtt_seg_accum_dg0_path(int(in_bf16), seg, blocks, bw_x,
                                          bw_y)


def dg0_fits(in_bf16: bool, seg: int, blocks: int, bw_x: int,
             bw_y: int) -> bool:
    """Whether kernel B6 takes these widths on one of its paths."""
    return dg0_path(in_bf16, seg, blocks, bw_x, bw_y) >= 0


def seg_accum_dg0_plain(runs, first, cnt, x, y, i0c, table, *, blocks, bw_x,
                        bw_y, p_rows, tp0, seg):
    """Plain PyTorch version: :func:`seg_accum_plain` with a float32 z,
    then ``dG0 = onehot(i0c)^T @ z`` in float32."""
    acc, dz0 = seg_accum_plain(runs, first, cnt, x, y, table, blocks=blocks,
                               bw_x=bw_x, bw_y=bw_y, p_rows=p_rows, seg=seg,
                               z_dtype=torch.float32)
    iota = torch.arange(tp0, dtype=i0c.dtype, device=i0c.device)
    oh0 = (i0c[:, None] == iota[None, :]).float()
    return acc, torch.matmul(oh0.t(), dz0)


def seg_accum_dg0_sched_plain(runs, first, cnt, x, y, i0c, table, *,
                              blocks, bw_x, bw_y, p_rows, tp0, seg):
    """The kernels' schedule in plain PyTorch (the tests hold it against
    :func:`seg_accum_dg0_plain`; no path runs it). Kernel 1: each segment
    writes an acc partial tile per span that meets it (its rows in row
    order), keys its rows by i0c (the sentinel span's rows, and keys
    outside ``[0, tp0)``, dropped), orders them by (key, row) and writes
    one partial row per distinct key, its rows' float32 dz0 added in row
    order, keys ascending. Kernel 2: acc[j] = span j's tiles in segment
    order. Kernel 3: dG0[r] = the partials keyed r in segment order.
    Returns ``(acc, dG0, partial rows [nseg, seg, blocks*bw_x], their keys
    [nseg, seg] with unused slots INT_MAX)``."""
    nseg = first.shape[0]
    nza, x_w = nseg * seg, blocks * bw_x
    span, live = span_of_rows(runs, nza, p_rows)
    slabs = table[:p_rows * bw_x].reshape(p_rows, bw_x, bw_y)[span].float()
    yb = y.reshape(nza, blocks, bw_y).float()
    xb = x.reshape(nza, blocks, bw_x).float()
    dz0 = torch.bmm(yb, slabs.transpose(1, 2)).reshape(nza, x_w)
    outer = torch.bmm(xb.transpose(1, 2), yb)  # [nza, bw_x, bw_y]
    keep = live & (i0c >= 0) & (i0c < tp0)
    key = torch.where(keep, i0c, torch.full_like(i0c, _NO_KEY))
    part = torch.zeros((nseg, seg, x_w), dtype=torch.float32)
    part_key = torch.full((nseg, seg), _NO_KEY, dtype=torch.int32)
    tiles = {}
    for s in range(nseg):
        base = s * seg
        for j in range(int(first[s]), int(first[s]) + int(cnt[s])):
            st, en = max(int(runs[j]), base), min(int(runs[j + 1]), base + seg)
            if j < p_rows and en > st:
                tile = torch.zeros((bw_x, bw_y), dtype=torch.float32)
                for r in range(st, en):
                    tile = tile + outer[r]
                tiles[(s, j)] = tile
        ks = key[base:base + seg]
        order = torch.sort(ks, stable=True).indices  # (key, row) order
        slot = 0
        for i in range(seg):
            k = int(ks[order[i]])
            if k == _NO_KEY:
                break
            if i > 0 and k != int(ks[order[i - 1]]):
                slot += 1
            part[s, slot] = part[s, slot] + dz0[base + int(order[i])]
            part_key[s, slot] = k
    acc = torch.zeros((p_rows, bw_x, bw_y), dtype=torch.float32)
    for j in range(p_rows):
        for s in range(nseg):
            if (s, j) in tiles:
                acc[j] = acc[j] + tiles[(s, j)]
    dg0 = torch.zeros((tp0, x_w), dtype=torch.float32)
    for s in range(nseg):
        for slot in range(seg):
            k = int(part_key[s, slot])
            if k != _NO_KEY:
                dg0[k] = dg0[k] + part[s, slot]
    return acc, dg0, part, part_key


def seg_accum_dg0(runs, first, cnt, x, y, i0c, table, *, blocks, bw_x, bw_y,
                  p_rows, tp0, seg, path: Optional[int] = None):
    """``(acc [p_rows, bw_x, bw_y], dG0 [tp0, blocks*bw_x])``, float32 —
    see the module docstring. ``path`` names the first pass's path on the
    card (default: :func:`dg0_path`'s); one that does not take the widths
    raises."""
    check_pass("seg_accum_dg0", runs, first, cnt, x, y, table, blocks, bw_x,
               bw_y, p_rows, seg, ())
    if (i0c.dtype != torch.int32 or i0c.dim() != 1
            or i0c.shape[0] != x.shape[0] or i0c.device != x.device):
        raise ValueError("seg_accum_dg0: i0c must be 1-D int32 with one entry "
                         f"per row of x, got {i0c.dtype} {tuple(i0c.shape)} "
                         f"on {i0c.device}")
    if tp0 < 0:
        raise ValueError(f"seg_accum_dg0: tp0 must be >= 0, got {tp0}")
    if x.device.type == "cpu":
        return seg_accum_dg0_plain(
            runs, first, cnt, x, y, i0c, table, blocks=blocks, bw_x=bw_x,
            bw_y=bw_y, p_rows=p_rows, tp0=tp0, seg=seg)
    if x.device.type != "cuda":
        raise ValueError(f"seg_accum_dg0 runs on cpu or cuda, not {x.device}")
    check_cuda("seg_accum_dg0", (runs, first, cnt, x, y, i0c, table), bw_x,
               bw_y)
    x_w = blocks * bw_x
    in_bf16 = x.dtype == torch.bfloat16
    if path is None:
        path = dg0_path(in_bf16, seg, blocks, bw_x, bw_y, card=True)
    if not dg0_takes(path, in_bf16, seg, blocks, bw_x, bw_y):
        raise ValueError(f"seg_accum_dg0: no kernel path takes {x.dtype} "
                         f"widths blocks={blocks}, {bw_x} x {bw_y} at seg "
                         f"{seg} (asked for path {path})")
    nseg = first.shape[0]
    dev = x.device
    f32 = torch.float32
    acc = torch.empty((p_rows, bw_x, bw_y), dtype=f32, device=dev)
    dg0 = torch.empty((tp0, x_w), dtype=f32, device=dev)
    partial = torch.empty((nseg + p_rows, bw_x * bw_y), dtype=f32, device=dev)
    dg0_part = torch.empty((nseg * seg, x_w), dtype=f32, device=dev)
    dg0_key = torch.empty((nseg * seg,), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fbtt_seg_accum_dg0(
            runs.data_ptr(), first.data_ptr(), cnt.data_ptr(), x.data_ptr(),
            y.data_ptr(), i0c.data_ptr(), table.data_ptr(),
            partial.data_ptr(), acc.data_ptr(), dg0_part.data_ptr(),
            dg0_key.data_ptr(), dg0.data_ptr(), nseg, seg, blocks, bw_x, bw_y,
            p_rows, tp0, int(in_bf16), path, stream)
    if err != 0:
        raise RuntimeError("seg_accum_dg0 launch failed: "
                           + lib.fbtt_error_string(err).decode())
    seg_accum_dg0.launches += 1
    return acc, dg0


seg_accum_dg0.launches = 0


def _lib():
    from fbtt_embedding_tpu_torch.ops.kernels._build import library

    lib = library("seg_accum_dg0")
    if lib.fbtt_seg_accum_dg0.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.fbtt_seg_accum_dg0.argtypes = [p] * 12 + [i] * 9 + [p]
        lib.fbtt_seg_accum_dg0.restype = ctypes.c_int
        lib.fbtt_seg_accum_dg0_path.argtypes = [i] * 5
        lib.fbtt_seg_accum_dg0_path.restype = ctypes.c_int
        lib.fbtt_error_string.argtypes = [ctypes.c_int]
        lib.fbtt_error_string.restype = ctypes.c_char_p
    return lib
