"""Sorted-run segment transform: the kernel of the flat forward (B1).

Counterpart of ``fbtt_embedding_tpu/ops/pallas/tt_flat.py ::
_seg_transform_call``. Lookups sorted by one core index j form spans
``runs[j] .. runs[j+1]`` of the sorted order; for every span ``j < p_rows``
and each of ``blocks`` lane-blocks ``b``::

    y[rows of j, b] = x[rows of j, b] @ T[j]

where ``T[j]`` is the ``[bw_in, bw_out]`` slab at rows ``j * bw_in`` of the
stacked table. Rows of the sentinel span (dead or padded lookups) and of
any span past ``p_rows`` are exact zeros. Accumulation is float32; the
output is rounded once to ``out_dtype``.

On a CUDA tensor :func:`seg_transform` launches the hand-written kernel of
``csrc/seg_transform.cu`` (one CTA per ``seg``-row segment, slab staged in
shared memory, 4x8 register tiles per thread; memory-bound: x read once, y
written once) or raises. On a CPU tensor it runs
:func:`seg_transform_plain`, the same contract in plain PyTorch. Launches
are counted in ``seg_transform.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_DTYPES = (torch.float32, torch.bfloat16)


def seg_transform_plain(runs, first, cnt, x, table, *, blocks, bw_in, bw_out,
                        p_rows, seg, out_dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version: each row finds its span in ``runs`` and is
    multiplied by its own gathered slab in float32. It derives everything
    from ``runs``; ``first``/``cnt``/``seg`` are the kernel's schedule and
    are accepted only so that both versions take the same arguments."""
    del first, cnt, seg
    out_dtype = out_dtype or x.dtype
    nza = x.shape[0]
    rows = torch.arange(nza, dtype=runs.dtype, device=x.device)
    span = torch.searchsorted(runs, rows, right=True) - 1
    live = span < p_rows
    slabs = table[:p_rows * bw_in].reshape(p_rows, bw_in, bw_out)
    slabs = slabs[span.clamp(max=p_rows - 1)].float()
    y = torch.bmm(x.reshape(nza, blocks, bw_in).float(), slabs)
    y = torch.where(live[:, None, None], y, torch.zeros((), device=y.device))
    return y.reshape(nza, blocks * bw_out).to(out_dtype)


def _check(runs, first, cnt, x, table, blocks, bw_in, bw_out, p_rows, seg,
           out_dtype):
    nseg = first.shape[0]
    for name, t in (("runs", runs), ("first", first), ("cnt", cnt)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D int32, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if cnt.shape[0] != nseg:
        raise ValueError("first and cnt must have one entry per segment")
    if runs.shape[0] < p_rows + 2:
        raise ValueError(f"runs needs >= p_rows + 2 = {p_rows + 2} entries, "
                         f"got {runs.shape[0]}")
    if x.dtype not in _DTYPES or table.dtype != x.dtype:
        raise ValueError(f"x and table must share float32 or bfloat16, got "
                         f"{x.dtype} and {table.dtype}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    if x.dim() != 2 or tuple(x.shape) != (nseg * seg, blocks * bw_in):
        raise ValueError(f"x must be [nseg*seg, blocks*bw_in] = "
                         f"[{nseg * seg}, {blocks * bw_in}], got "
                         f"{tuple(x.shape)}")
    if (table.dim() != 2 or table.shape[1] != bw_out
            or table.shape[0] < p_rows * bw_in):
        raise ValueError(f"table must be [>= {p_rows * bw_in}, {bw_out}], "
                         f"got {tuple(table.shape)}")
    devs = {t.device for t in (runs, first, cnt, x, table)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def seg_transform(runs, first, cnt, x, table, *, blocks, bw_in, bw_out,
                  p_rows, seg, out_dtype: Optional[torch.dtype] = None):
    """``y [nseg*seg, blocks*bw_out]`` — see the module docstring."""
    out_dtype = out_dtype or x.dtype
    _check(runs, first, cnt, x, table, blocks, bw_in, bw_out, p_rows, seg,
           out_dtype)
    if x.device.type == "cpu":
        return seg_transform_plain(
            runs, first, cnt, x, table, blocks=blocks, bw_in=bw_in,
            bw_out=bw_out, p_rows=p_rows, seg=seg, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"seg_transform runs on cpu or cuda, not {x.device}")
    tensors = (runs, first, cnt, x, table)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("seg_transform needs contiguous inputs")
    if bw_in % 8 or bw_out % 8 or bw_in * 8 * 4 > 48 * 1024:
        raise ValueError(f"widths {bw_in}->{bw_out}: the kernel takes "
                         "multiples of 8, bw_in <= 1536")
    if x.data_ptr() % 16:
        raise ValueError("seg_transform needs 16-byte aligned x rows")
    nseg = first.shape[0]
    y = torch.empty((nseg * seg, blocks * bw_out), dtype=out_dtype,
                    device=x.device)
    if nseg == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fbtt_seg_transform(
            runs.data_ptr(), first.data_ptr(), cnt.data_ptr(), x.data_ptr(),
            table.data_ptr(), y.data_ptr(), nseg, seg, blocks, bw_in, bw_out,
            p_rows, int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            "seg_transform launch failed: "
            + lib.fbtt_error_string(err).decode())
    seg_transform.launches += 1
    return y


seg_transform.launches = 0


def _lib():
    from fbtt_embedding_tpu_torch.ops.kernels._build import library

    lib = library("seg_transform")
    if lib.fbtt_seg_transform.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.fbtt_seg_transform.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                           i, i, i, p]
        lib.fbtt_seg_transform.restype = ctypes.c_int
        lib.fbtt_error_string.argtypes = [ctypes.c_int]
        lib.fbtt_error_string.restype = ctypes.c_char_p
    return lib
