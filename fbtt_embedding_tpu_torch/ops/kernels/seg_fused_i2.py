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
exact zeros.

On a CUDA tensor :func:`seg_fused_i2` launches the hand-written kernels of
``csrc/seg_fused_i2.cu`` (the design of ``seg_accum``, with the forward
product fused in) or raises. On a CPU tensor it runs
:func:`seg_fused_i2_plain`. Launches are counted in
``seg_fused_i2.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import (
    check_cuda,
    check_pass,
    span_of_rows,
    span_outer_sum,
)


def seg_fused_i2_plain(runs, first, cnt, x, y, table, *, blocks, bw_x, bw_y,
                       p_rows, seg):
    """Plain PyTorch version: each row finds its span in ``runs``; the
    products run batched in float32. ``first``/``cnt``/``seg`` are the
    kernel's schedule, accepted only so that both versions take the same
    arguments."""
    del first, cnt, seg
    nza = x.shape[0]
    span, live = span_of_rows(runs, nza, p_rows)
    slabs = table[:p_rows * bw_x].reshape(p_rows, bw_x, bw_y)[span].float()
    keep = live[:, None, None]
    zero = torch.zeros((), device=x.device)
    rows = torch.bmm(x.reshape(nza, blocks, bw_x).float(), slabs)
    rows = torch.where(keep, rows, zero)
    z = torch.bmm(y.reshape(nza, blocks, bw_y).float(), slabs.transpose(1, 2))
    z = torch.where(keep, z, zero)
    acc = span_outer_sum(x, y, span, live, blocks, bw_x, bw_y, p_rows)
    return (acc, z.reshape(nza, blocks * bw_x).to(x.dtype),
            rows.reshape(nza, blocks * bw_y).to(x.dtype))


def seg_fused_i2(runs, first, cnt, x, y, table, *, blocks, bw_x, bw_y,
                 p_rows, seg):
    """``(acc [p_rows, bw_x, bw_y] float32, z [nseg*seg, blocks*bw_x],
    rows [nseg*seg, blocks*bw_y])`` — see the module docstring."""
    check_pass("seg_fused_i2", runs, first, cnt, x, y, table, blocks, bw_x,
               bw_y, p_rows, seg, ())
    if x.device.type == "cpu":
        return seg_fused_i2_plain(
            runs, first, cnt, x, y, table, blocks=blocks, bw_x=bw_x,
            bw_y=bw_y, p_rows=p_rows, seg=seg)
    if x.device.type != "cuda":
        raise ValueError(f"seg_fused_i2 runs on cpu or cuda, not {x.device}")
    check_cuda("seg_fused_i2", (runs, first, cnt, x, y, table), bw_x, bw_y)
    nseg = first.shape[0]
    dev = x.device
    nza = nseg * seg
    z = torch.empty((nza, blocks * bw_x), dtype=x.dtype, device=dev)
    rows = torch.empty((nza, blocks * bw_y), dtype=x.dtype, device=dev)
    acc = torch.empty((p_rows, bw_x, bw_y), dtype=torch.float32, device=dev)
    partial = torch.empty((nseg + p_rows, bw_x * bw_y), dtype=torch.float32,
                          device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fbtt_seg_fused_i2(
            runs.data_ptr(), first.data_ptr(), cnt.data_ptr(), x.data_ptr(),
            y.data_ptr(), table.data_ptr(), z.data_ptr(), rows.data_ptr(),
            partial.data_ptr(), acc.data_ptr(), nseg, seg, blocks, bw_x, bw_y,
            p_rows, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError("seg_fused_i2 launch failed: "
                           + lib.fbtt_error_string(err).decode())
    seg_fused_i2.launches += 1
    return acc, z, rows


seg_fused_i2.launches = 0


def _lib():
    from fbtt_embedding_tpu_torch.ops.kernels._build import library

    lib = library("seg_fused_i2")
    if lib.fbtt_seg_fused_i2.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.fbtt_seg_fused_i2.argtypes = [p] * 10 + [i] * 7 + [p]
        lib.fbtt_seg_fused_i2.restype = ctypes.c_int
        lib.fbtt_error_string.argtypes = [ctypes.c_int]
        lib.fbtt_error_string.restype = ctypes.c_char_p
    return lib
