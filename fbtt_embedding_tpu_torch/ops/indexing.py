"""Index preprocessing for TT embedding lookups, in PyTorch.

Counterpart of ``fbtt_embedding_tpu.ops.indexing``:

- mixed-radix decomposition of row ids into per-core indices
  (``(idx // L) % p`` on the device, or in int64 numpy on the host for
  tables with ``prod(p) >= 2**31``);
- CSR offsets -> per-lookup (rowidx, tableidx), by marking bag starts
  and prefix-summing (no host synchronisation, empty bags allowed);
- the per-lookup (rowidx, tableidx) of fixed multi-hot bags, one bag size
  per table (``multi_hot_positions``);
- the wide int64 key-row layout ``(hi, lo, part_0..part_{ndim-1})`` that
  serving takes for big tables;
- the host-side CSR -> fixed-pooling re-layout of the multi-GPU steps
  (``pad_csr_to_fixed``, on the native loader).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def tt_strides(tt_p_shapes: Sequence[int]) -> np.ndarray:
    """Mixed-radix stride vector L with L[t] = prod(p[t+1:])."""
    ndim = len(tt_p_shapes)
    strides = np.ones(ndim, dtype=np.int64)
    for t in range(ndim - 2, -1, -1):
        strides[t] = strides[t + 1] * tt_p_shapes[t + 1]
    return strides


def decompose_indices(
    indices: torch.Tensor, tt_p_shapes: Sequence[int]
) -> List[torch.Tensor]:
    """Per-core int32 indices ``(indices // L[t]) % p_t``.

    Requires ``prod(p) < 2**31``; larger tables decompose on the host with
    :func:`decompose_indices64` (or arrive as wide key rows)."""
    if int(np.prod([int(p) for p in tt_p_shapes])) > np.iinfo(np.int32).max:
        raise ValueError(
            "prod(tt_p_shapes) exceeds int32; decompose row ids on the "
            "host with decompose_indices64 and pass idx_parts explicitly")
    strides = tt_strides(tt_p_shapes)
    idx = indices.to(torch.int32)
    return [
        torch.div(idx, int(strides[t]), rounding_mode="floor") % int(p)
        for t, p in enumerate(tt_p_shapes)
    ]


def decompose_indices64(indices, tt_p_shapes: Sequence[int]) -> List[np.ndarray]:
    """Host int64 decomposition into per-core int32 parts (any table size:
    every part fits int32 although the row id may not)."""
    idx = np.asarray(indices, dtype=np.int64).reshape(-1)
    strides = tt_strides(tt_p_shapes)
    return [((idx // strides[t]) % p).astype(np.int32)
            for t, p in enumerate(tt_p_shapes)]


def wide_keyrows(indices64, tt_p_shapes: Sequence[int]) -> np.ndarray:
    """Host-side wide key rows ``int32 [nnz, 2 + ndim]``: columns
    ``(hi, lo, part_0..part_{ndim-1})`` with ``hi = id >> 31`` and
    ``lo = id & 0x7FFFFFFF`` — the layout of the JAX package's
    ``wide_cache_keys``, so int64 row ids never reach the device."""
    idx = np.asarray(indices64, dtype=np.int64).reshape(-1)
    hi = (idx >> 31).astype(np.int32)
    lo = (idx & 0x7FFFFFFF).astype(np.int32)
    return np.stack([hi, lo, *decompose_indices64(idx, tt_p_shapes)], axis=1)


def split_wide_keyrows(keyrows: torch.Tensor, ndim: int):
    """``(idx_parts, keyrows, nnz)`` from a wide key-row array."""
    if keyrows.dim() != 2 or keyrows.shape[1] != 2 + ndim:
        raise ValueError(
            f"wide key rows must be [nnz, 2 + ndim] = [*, {2 + ndim}] int32 "
            f"(hi, lo, part_0..part_{ndim - 1}); got shape "
            f"{tuple(keyrows.shape)}")
    parts = tuple(keyrows[:, 2 + t].to(torch.int32) for t in range(ndim))
    return parts, keyrows, keyrows.shape[0]


def pad_csr_to_fixed(indices, offsets, num_tables: int, batch_size: int,
                     pooling_factor: int,
                     weights=None) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side CSR -> fixed-pooling re-layout for the multi-GPU steps
    (``parallel.sharded``), which take ``[T, B, L]`` bags: ``(idx [T, B, L]
    int32, w [T, B, L] float32)``, pad slots index -1 (dropped by LFU
    counting in every cache mode, missed by probes) and weight 0 (nothing
    forward or backward), so the padded batch trains as the CSR batch does
    on one device. Runs on the native loader (``native.csr_to_padded_np``);
    raises ValueError for a bag longer than ``pooling_factor`` or offsets
    that decrease. Inputs may be numpy arrays or CPU tensors."""
    from fbtt_embedding_tpu_torch import native

    def host(a):
        return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    return native.csr_to_padded_np(
        host(indices), host(offsets), num_tables, batch_size, pooling_factor,
        None if weights is None else host(weights))


def rowidx_from_offsets(
    offsets: torch.Tensor, nnz: int, num_tables: int, batch_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand table-major CSR offsets (``num_tables * batch_size + 1``
    entries) into per-lookup ``(rowidx, tableidx)``, both int32.

    Bag ``b`` covers ``offsets[b]:offsets[b+1]``; the bag id of a lookup
    is the number of interior bag starts at or before it. Starts outside
    ``[0, nnz)`` are dropped (they go to a spare slot that is cut off),
    as the JAX package's ``mode="drop"`` scatter does."""
    offs = offsets.to(device=offsets.device, dtype=torch.int64)
    inner = offs[1:-1]
    inner = torch.where((inner >= 0) & (inner < nnz), inner,
                        torch.full_like(inner, nnz))
    marks = torch.zeros(nnz + 1, dtype=torch.int32, device=offs.device)
    marks.index_add_(0, inner, torch.ones_like(inner, dtype=torch.int32))
    bag = torch.cumsum(marks[:nnz], 0, dtype=torch.int32)
    bag = bag.clamp(0, num_tables * batch_size - 1)
    return bag % batch_size, torch.div(bag, batch_size, rounding_mode="floor")


def multi_hot_positions(batch_size: int, pooling: Sequence[int], device
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lookup ``(rowidx, tableidx)``, both int32, of tables whose bags
    hold ``pooling[t]`` lookups each: table-major, each table's ``[B,
    pooling[t]]`` block bag by bag, as a multi-hot batch lays out."""
    lengths = torch.tensor([int(n) for n in pooling], dtype=torch.int64,
                           device=device).repeat_interleave(batch_size)
    bag = torch.repeat_interleave(
        torch.arange(lengths.shape[0], dtype=torch.int32, device=device),
        lengths, output_size=batch_size * sum(int(n) for n in pooling))
    return bag % batch_size, torch.div(bag, batch_size, rounding_mode="floor")
