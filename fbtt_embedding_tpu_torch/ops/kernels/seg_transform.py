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

The block-diagonal fold, ``mm > 1``: the table is ``kron(I_mm, G[j])``
with ``G[j]`` its first diagonal block ``[bw_in/mm, bw_out/mm]``, which is
all that is read. Each lane-block of x is ``mm`` sub-blocks of width
``bw_in/mm``, each giving ``bw_out/mm`` columns of y; y is the same tensor
as unfolded. Widths that are not multiples of ``mm`` raise.

On a CUDA tensor :func:`seg_transform` launches the hand-written kernels of
``csrc/seg_transform.cu`` or raises; on a CPU tensor it runs
:func:`seg_transform_plain`, the same contract in plain PyTorch. Launches
are counted in ``seg_transform.launches``. The pass is memory-bound on the
H100 (x read once, y written once; the headline first-core pass moves ~13
MB in bfloat16, ~4 us at 3.35 TB/s, and does ~25 FLOP per byte, above the
CUDA cores' ridge). Paths, after folding (``kx = bw_in/mm``, ``ky =
bw_out/mm``; every dense width a multiple of 8):

- tensor cores (bfloat16 x and table; ``kx`` a multiple of 16, ``ky`` a
  multiple of 8 above 8): one CTA per 32-row chunk of a segment runs
  ``mma.sync`` on the chunk's staged x rows and a batch of up to 4 live
  spans' staged ``G[j]``; y goes through a per-warp shared tile and leaves
  in 16-byte coalesced pieces (the headline first-core pass, 32 x 128);
- narrow tensor cores (the same kernel with ``ky`` 2, 4 or 8, padded to
  16 columns of zeros; 16-row chunks, up to 8 spans a batch; the headline
  last-core pass folded by 4, 32 x 4);
- CUDA cores (float32, other widths; fold 1 only: the dense slab as it
  lies in the table, ``bw_in <= 1536``).

Where the full fold does not stage, the wrapper folds by the largest
divisor of ``mm`` that does (asked of the library once per widths; its
answers mean what ``seg_accum.PATH_NAMES`` says); B1 has no gradient to
sum, so a partial fold gives the same y.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import (
    cached_fold,
    folded_slabs,
    span_of_rows,
)

_DTYPES = (torch.float32, torch.bfloat16)


def seg_transform_plain(runs, first, cnt, x, table, *, blocks, bw_in, bw_out,
                        p_rows, seg, out_dtype: Optional[torch.dtype] = None,
                        mm: int = 1):
    """Plain PyTorch version: each row finds its span in ``runs`` and each
    of its sub-blocks is multiplied by its span's (folded) slab in float32.
    It derives everything from ``runs``; ``first``/``cnt``/``seg`` are the
    kernel's schedule and are accepted only so that both versions take the
    same arguments."""
    del first, cnt, seg
    out_dtype = out_dtype or x.dtype
    nza = x.shape[0]
    nb, kx = blocks * mm, bw_in // mm
    span, live = span_of_rows(runs, nza, p_rows)
    slabs = folded_slabs(table, p_rows, bw_in, bw_out, mm)[span].float()
    y = torch.bmm(x.reshape(nza, nb, kx).float(), slabs)
    y = torch.where(live[:, None, None], y, torch.zeros((), device=y.device))
    return y.reshape(nza, blocks * bw_out).to(out_dtype)


def _check(runs, first, cnt, x, table, blocks, bw_in, bw_out, p_rows, seg,
           out_dtype, mm):
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
    if mm < 1 or bw_in % mm or bw_out % mm:
        raise ValueError(f"the fold mm={mm} must divide both widths {bw_in} "
                         f"and {bw_out}")
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
                  p_rows, seg, out_dtype: Optional[torch.dtype] = None,
                  mm: int = 1):
    """``y [nseg*seg, blocks*bw_out]`` — see the module docstring."""
    out_dtype = out_dtype or x.dtype
    _check(runs, first, cnt, x, table, blocks, bw_in, bw_out, p_rows, seg,
           out_dtype, mm)
    if x.device.type == "cpu":
        return seg_transform_plain(
            runs, first, cnt, x, table, blocks=blocks, bw_in=bw_in,
            bw_out=bw_out, p_rows=p_rows, seg=seg, out_dtype=out_dtype,
            mm=mm)
    if x.device.type != "cuda":
        raise ValueError(f"seg_transform runs on cpu or cuda, not {x.device}")
    tensors = (runs, first, cnt, x, table)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("seg_transform needs contiguous inputs")
    if bw_in % 8 or bw_out % 8:
        raise ValueError(f"widths {bw_in}->{bw_out}: the kernels take "
                         "multiples of 8")
    if x.data_ptr() % 16 or table.data_ptr() % 16:
        raise ValueError("seg_transform needs 16-byte aligned x and table")
    lib = _lib()
    fold, _ = cached_fold("seg_transform", lib.fbtt_seg_transform_path,
                          x.dtype == torch.bfloat16, seg, blocks, bw_in,
                          bw_out, mm)
    nseg = first.shape[0]
    y = torch.empty((nseg * seg, blocks * bw_out), dtype=out_dtype,
                    device=x.device)
    if nseg == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fbtt_seg_transform(
            runs.data_ptr(), first.data_ptr(), cnt.data_ptr(), x.data_ptr(),
            table.data_ptr(), y.data_ptr(), nseg, seg, blocks, bw_in, bw_out,
            fold, p_rows, int(x.dtype == torch.bfloat16),
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
        lib.fbtt_seg_transform.argtypes = [p] * 6 + [i] * 9 + [p]
        lib.fbtt_seg_transform.restype = ctypes.c_int
        lib.fbtt_seg_transform_path.argtypes = [i] * 6
        lib.fbtt_seg_transform_path.restype = ctypes.c_int
        lib.fbtt_error_string.argtypes = [ctypes.c_int]
        lib.fbtt_error_string.restype = ctypes.c_char_p
    return lib
