"""Fused last-core training pass of the flat pipeline (B2).

Counterpart of ``fbtt_embedding_tpu/ops/pallas/tt_flat.py ::
_seg_fused_i2_call``. In the training step ``d_output`` is an input, so the
last core's forward and backward share one pass: for every span ``j <
p_rows`` of the sorted order and each of ``blocks`` lane-blocks ``b``::

    rows_b[rows of j] = x_b[rows of j] @ T[j]            (output rows)
    z_b[rows of j]    = y_b[rows of j] @ T[j]^T          (dZ1)
    acc[j]           += sum_b x_b^T @ y_b                (dG2, float32)

``rows`` and ``z`` are rounded once to the staging dtype (that of ``x``);
``acc`` comes back in the canonical ``[p_rows, bw_x, bw_y]`` float32
layout. Rows of the sentinel span and the ``acc`` of an empty span are
exact zeros. ``mm > 1`` folds a block-diagonal table ``kron(I_mm, G[j])``
as in ``seg_accum``: only ``G[j]`` is read, ``z`` and ``rows`` are the
same tensors, and ``acc`` comes back as ``[p_rows, bw_x/mm, bw_y/mm]``,
the sum of its diagonal blocks in block order.

On a CUDA tensor :func:`seg_fused_i2` launches the hand-written kernels of
``csrc/seg_fused_i2.cu`` (the design of ``seg_accum``, with the forward
product fused in; the widths it takes are ``seg_accum``'s, without the
tensor-core path) or raises. On a CPU tensor it runs
:func:`seg_fused_i2_plain`. Launches are counted in
``profiling``'s ``launches.seg_fused_i2``.
"""

from __future__ import annotations

import ctypes

import torch

from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import (
    _ptr,
    cached_fold,
    check_cuda,
    check_pass,
    count_split_spans,
    diag_block_sum,
    folded_slabs,
    reduce_schedule,
    span_of_rows,
    span_outer_sum,
)
from fbtt_embedding_tpu_torch.utils import profiling


def seg_fused_i2_plain(runs, first, cnt, x, y, table, *, blocks, bw_x, bw_y,
                       p_rows, seg, mm: int = 1):
    """Plain PyTorch version: each row finds its span in ``runs``; the
    products run batched in float32 on the folded sub-blocks.
    ``first``/``cnt``/``seg`` are the kernel's schedule, accepted only so
    that both versions take the same arguments."""
    del first, cnt, seg
    nza = x.shape[0]
    nb, kx, ky = blocks * mm, bw_x // mm, bw_y // mm
    span, live = span_of_rows(runs, nza, p_rows)
    slabs = folded_slabs(table, p_rows, bw_x, bw_y, mm)[span].float()
    keep = live[:, None, None]
    zero = torch.zeros((), device=x.device)
    rows = torch.bmm(x.reshape(nza, nb, kx).float(), slabs)
    rows = torch.where(keep, rows, zero)
    z = torch.bmm(y.reshape(nza, nb, ky).float(), slabs.transpose(1, 2))
    z = torch.where(keep, z, zero)
    acc = span_outer_sum(x, y, span, live, nb, kx, ky, p_rows)
    return (acc, z.reshape(nza, blocks * bw_x).to(x.dtype),
            rows.reshape(nza, blocks * bw_y).to(x.dtype))


def seg_fused_i2(runs, first, cnt, x, y, table, *, blocks, bw_x, bw_y,
                 p_rows, seg, mm: int = 1):
    """``(acc [p_rows, bw_x/mm, bw_y/mm] float32, z [nseg*seg,
    blocks*bw_x], rows [nseg*seg, blocks*bw_y])`` — see the module
    docstring."""
    check_pass("seg_fused_i2", runs, first, cnt, x, y, table, blocks, bw_x,
               bw_y, p_rows, seg, (), mm)
    nseg = first.shape[0]
    if x.device.type == "cpu":
        count_split_spans(runs, nseg, p_rows, seg)
        return seg_fused_i2_plain(
            runs, first, cnt, x, y, table, blocks=blocks, bw_x=bw_x,
            bw_y=bw_y, p_rows=p_rows, seg=seg, mm=mm)
    if x.device.type != "cuda":
        raise ValueError(f"seg_fused_i2 runs on cpu or cuda, not {x.device}")
    check_cuda("seg_fused_i2", (runs, first, cnt, x, y, table), bw_x, bw_y)
    lib = _lib()
    in_bf16 = x.dtype == torch.bfloat16
    fold, _ = cached_fold("seg_fused_i2", lib.fbtt_seg_fused_i2_path, in_bf16,
                          seg, blocks, bw_x, bw_y, mm)
    kx, ky = bw_x // fold, bw_y // fold
    dev = x.device
    nza = nseg * seg
    z = torch.empty((nza, blocks * bw_x), dtype=x.dtype, device=dev)
    rows = torch.empty((nza, blocks * bw_y), dtype=x.dtype, device=dev)
    acc = torch.empty((p_rows, kx, ky), dtype=torch.float32, device=dev)
    partial = torch.empty((nseg + p_rows, kx * ky), dtype=torch.float32,
                          device=dev)
    chunk, sched = reduce_schedule(nseg, p_rows, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fbtt_seg_fused_i2(
            runs.data_ptr(), first.data_ptr(), cnt.data_ptr(), x.data_ptr(),
            y.data_ptr(), table.data_ptr(), z.data_ptr(), rows.data_ptr(),
            partial.data_ptr(), acc.data_ptr(), _ptr(sched), nseg, seg,
            blocks, bw_x, bw_y, fold, p_rows, chunk, int(in_bf16), stream)
    if err != 0:
        raise RuntimeError("seg_fused_i2 launch failed: "
                           + lib.fbtt_error_string(err).decode())
    profiling.count("launches.seg_fused_i2")
    count_split_spans(runs, nseg, p_rows, seg, sched)
    return diag_block_sum(acc, mm // fold), z, rows



def _lib():
    from fbtt_embedding_tpu_torch.ops.kernels._build import library

    lib = library("seg_fused_i2")
    if lib.fbtt_seg_fused_i2.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.fbtt_seg_fused_i2.argtypes = [p] * 11 + [i] * 9 + [p]
        lib.fbtt_seg_fused_i2.restype = ctypes.c_int
        lib.fbtt_seg_fused_i2_path.argtypes = [i] * 6
        lib.fbtt_seg_fused_i2_path.restype = ctypes.c_int
        lib.fbtt_error_string.argtypes = [ctypes.c_int]
        lib.fbtt_error_string.restype = ctypes.c_char_p
    return lib
