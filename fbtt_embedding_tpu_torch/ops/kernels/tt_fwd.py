"""Pooled per-lookup TT forward: the generic forward kernel (B4).

Counterpart of ``fbtt_embedding_tpu/ops/pallas/tt_kernel.py ::
_make_fwd_call`` (through ``tt_forward_pallas``). Every lookup ``l`` with a
pooled row ``rowv[l] >= 0`` adds ``w_l * G_0[i_0] G_1[i_1] ... G_{n-1}[
i_{n-1}]`` (its TT chain, d-index in canonical digit order) into row
``rowv[l]`` of ``out [tb, D]`` (float32); lookups with ``rowv = -1``
(padding, dead) add nothing and an empty bag is exact zeros.

Arguments, shared by the kernel and its plain version: ``gk``, the kernel
core layouts (``kernel_core_layouts``: ``[T*p0, q0, r1]``, middle cores
``[T*p, r, q*r']``, the last ``[T*p, r, q]``, float32); ``idx [ndim, nnz]``
int32 core rows (offset by table); ``rowv [nnz]`` int32; ``weights [nnz]``
float32 or None; ``order [nnz]`` and ``starts [tb + 1]`` int32, the
lookups grouped by bag (``tt_kernel.bag_order``).

On a CUDA tensor :func:`tt_fwd` launches the hand-written kernel of
``csrc/tt_fwd.cu`` (one CTA per bag walks its lookups in chunks, runs
their chains in shared memory and sums the rows; each output row is
written once, no atomics) or raises. On a CPU tensor it runs
:func:`tt_fwd_plain`, which derives the bags from ``rowv`` and ignores
``order`` / ``starts``. Launches are counted in ``tt_fwd.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

# the kernel picks its chunk of lookups within this much shared memory and
# takes one lookup at a time up to _SMEM_MAX (B2 and B3's limit)
_SMEM_BUDGET = 64 * 1024
_SMEM_MAX = 200 * 1024
MAX_CHUNK = 32  # kMaxChunk of csrc/tt_chain.cuh


def chain_dims(gk: Sequence[torch.Tensor]) -> Tuple[Tuple[int, ...],
                                                    Tuple[int, ...]]:
    """``(q, full ranks)`` read off the kernel core layouts; raises
    ValueError on layouts that do not chain."""
    ndim = len(gk)
    if not 2 <= ndim <= 4:
        raise ValueError(f"the generic kernels take tt_ndim 2-4, got {ndim}")
    if any(g.dim() != 3 for g in gk):
        raise ValueError("kernel core layouts must be 3-D, got "
                         f"{[tuple(g.shape) for g in gk]}")
    q, r = [int(gk[0].shape[1])], [1, int(gk[0].shape[2])]
    for t in range(1, ndim):
        if gk[t].shape[1] != r[t]:
            raise ValueError(f"core {t} has rank {gk[t].shape[1]}, the "
                             f"chain needs {r[t]}")
        r_next = int(gk[t + 1].shape[1]) if t + 1 < ndim else 1
        if gk[t].shape[2] % r_next:
            raise ValueError(f"core {t}'s width {gk[t].shape[2]} is not a "
                             f"multiple of the next rank {r_next}")
        q.append(int(gk[t].shape[2]) // r_next)
        r.append(r_next)
    return tuple(q), tuple(r)


def state_floats(q, r) -> int:
    """Floats of the largest per-lookup state, ``max_t m_t * r_{t+1}``."""
    m, zs = 1, 1
    for t in range(len(q)):
        m *= q[t]
        zs = max(zs, m * r[t + 1])
    return zs


def chunk_for(per_lookup: int, fixed: int) -> Optional[int]:
    """Lookups per chunk for a kernel whose shared memory is ``per_lookup *
    lc + fixed`` floats: the most within ``_SMEM_BUDGET`` (at most
    ``MAX_CHUNK``), else 1 within ``_SMEM_MAX``, else None."""
    lc = min(MAX_CHUNK, (_SMEM_BUDGET // 4 - fixed) // per_lookup)
    if lc >= 1:
        return lc
    return 1 if (per_lookup + fixed) * 4 <= _SMEM_MAX else None


def fwd_chunk(q, r) -> Optional[int]:
    """The forward kernel's chunk: two states per lookup and the bag's
    ``[D]`` sum."""
    return chunk_for(2 * state_floats(q, r), math.prod(q))


def chain_rows(gk, idx, q, r):
    """Plain per-lookup chain: the states ``z_0 .. z_{n-1}``, each
    ``[nnz, m_t * r_{t+1}]`` float32 (the last is the row), from gathered
    slabs and batched products."""
    nnz = idx.shape[1]
    z = gk[0][idx[0].long()].reshape(nnz, -1).float()
    states = [z]
    m = q[0]
    for t in range(1, len(q)):
        g = gk[t][idx[t].long()].reshape(nnz, r[t], q[t] * r[t + 1]).float()
        z = torch.bmm(z.reshape(nnz, m, r[t]), g)
        m *= q[t]
        z = z.reshape(nnz, m * r[t + 1])
        states.append(z)
    return states


def live_inputs(idx, rowv):
    """(live mask, ``idx`` with dead lookups' rows set to 0, so that every
    gather stays in range)."""
    live = rowv >= 0
    return live, torch.where(live[None, :], idx, torch.zeros_like(idx))


def tt_fwd_plain(gk, idx, rowv, weights, order, starts):
    """Plain PyTorch version: gathered slabs, batched ``torch.matmul``
    chain, rows pooled by ``index_add_`` in lookup order, float32."""
    del order  # the kernel's schedule; the bags come from rowv
    q, r = chain_dims(gk)
    tb = starts.shape[0] - 1
    live, idx = live_inputs(idx, rowv)
    rows = chain_rows(gk, idx, q, r)[-1]
    if weights is not None:
        rows = rows * weights[:, None].float()
    seg = torch.where(live, rowv, torch.full_like(rowv, tb)).long()
    out = torch.zeros((tb + 1, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    out.index_add_(0, seg, rows)
    return out[:tb]


def check_lookups(name, gk, idx, rowv, weights):
    """Raise ValueError on lookup inputs the generic kernels do not take."""
    q, r = chain_dims(gk)
    if any(g.dtype != torch.float32 for g in gk):
        raise ValueError(f"{name}: cores must be float32, got "
                         f"{[g.dtype for g in gk]}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != len(gk):
        raise ValueError(f"{name}: idx must be int32 [ndim={len(gk)}, nnz], "
                         f"got {idx.dtype} {tuple(idx.shape)}")
    nnz = idx.shape[1]
    if rowv.dtype != torch.int32 or tuple(rowv.shape) != (nnz,):
        raise ValueError(f"{name}: rowv must be int32 [{nnz}], got "
                         f"{rowv.dtype} {tuple(rowv.shape)}")
    if weights is not None and (weights.dtype != torch.float32
                                or tuple(weights.shape) != (nnz,)):
        raise ValueError(f"{name}: weights must be float32 [{nnz}], got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    return q, r


def check_int32(name, what, t, shape):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} must be int32 {list(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def check_device(name, tensors):
    """Raise ValueError unless every input lies on one device, the CPU or a
    CUDA card; on a card they must also be contiguous."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: all inputs must be on one device, got "
                         f"{devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")


def tt_fwd(gk, idx, rowv, weights, order, starts):
    """``out [tb, D]`` float32 — see the module docstring."""
    q, r = check_lookups("tt_fwd", gk, idx, rowv, weights)
    nnz = idx.shape[1]
    check_int32("tt_fwd", "order", order, (nnz,))
    if starts.dtype != torch.int32 or starts.dim() != 1 or not starts.numel():
        raise ValueError(f"tt_fwd: starts must be 1-D int32 [tb + 1], got "
                         f"{starts.dtype} {tuple(starts.shape)}")
    tensors = [*gk, idx, rowv, order, starts] + (
        [weights] if weights is not None else [])
    check_device("tt_fwd", tensors)
    dev = idx.device
    if dev.type == "cpu":
        return tt_fwd_plain(gk, idx, rowv, weights, order, starts)
    lc = fwd_chunk(q, r)
    if lc is None:
        raise ValueError(f"tt_fwd: q={q}, ranks={r}: one lookup's states "
                         f"pass the kernel's {_SMEM_MAX} bytes of shared "
                         "memory")
    tb = starts.shape[0] - 1
    out = torch.empty((tb, math.prod(q)), dtype=torch.float32, device=dev)
    g = [t.data_ptr() for t in gk] + [None] * (4 - len(gk))
    qa = list(q) + [1] * (4 - len(q))
    ra = list(r[1:-1]) + [1] * (3 - (len(r) - 2))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fbtt_tt_fwd(
            *g, idx.data_ptr(),
            weights.data_ptr() if weights is not None else None,
            order.data_ptr(), starts.data_ptr(), out.data_ptr(), len(gk), nnz,
            tb, *qa, *ra, lc, state_floats(q, r), stream)
    if err != 0:
        raise RuntimeError("tt_fwd launch failed: "
                           + lib.fbtt_error_string(err).decode())
    tt_fwd.launches += 1
    return out


tt_fwd.launches = 0


def _lib():
    from fbtt_embedding_tpu_torch.ops.kernels._build import library

    lib = library("tt_fwd")
    if lib.fbtt_tt_fwd.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.fbtt_tt_fwd.argtypes = [p] * 9 + [i] * 12 + [p]
        lib.fbtt_tt_fwd.restype = ctypes.c_int
        lib.fbtt_error_string.argtypes = [ctypes.c_int]
        lib.fbtt_error_string.restype = ctypes.c_char_p
    return lib
