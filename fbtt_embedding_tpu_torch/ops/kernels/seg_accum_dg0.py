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
count).
"""

from __future__ import annotations

import ctypes

import torch

from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import (
    check_cuda,
    check_pass,
    seg_accum_plain,
)

# the kernel keeps a segment's float32 dz0 rows in shared memory
_MAX_ZTILE_BYTES = 128 * 1024


def dg0_fits(x_w: int, seg: int) -> bool:
    """Whether kernel B6 takes a z0 width ``x_w = blocks*bw_x`` at segment
    length ``seg``: the segment's ``[seg, x_w]`` float32 dz0 tile must fit
    its 128 KB of shared memory (``x_w <= 512`` at ``seg = 64``)."""
    return seg * x_w * 4 <= _MAX_ZTILE_BYTES


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


def seg_accum_dg0(runs, first, cnt, x, y, i0c, table, *, blocks, bw_x, bw_y,
                  p_rows, tp0, seg):
    """``(acc [p_rows, bw_x, bw_y], dG0 [tp0, blocks*bw_x])``, float32 —
    see the module docstring."""
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
    if not dg0_fits(x_w, seg):
        raise ValueError(f"seg_accum_dg0: a segment's dz0 tile ({seg} x {x_w} "
                         f"float32) passes {_MAX_ZTILE_BYTES} bytes of shared "
                         "memory")
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
            p_rows, tp0, int(x.dtype == torch.bfloat16), stream)
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
        lib.fbtt_seg_accum_dg0.argtypes = [p] * 12 + [i] * 8 + [p]
        lib.fbtt_seg_accum_dg0.restype = ctypes.c_int
        lib.fbtt_error_string.argtypes = [ctypes.c_int]
        lib.fbtt_error_string.restype = ctypes.c_char_p
    return lib
