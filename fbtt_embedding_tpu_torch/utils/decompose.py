"""TT-SVD: decompose a trained dense embedding table into TT cores.

Counterpart of ``fbtt_embedding_tpu.utils.decompose`` (this package keeps its
own copy: it imports nothing of the JAX package). :func:`tt_decompose`
computes a tensor-train approximation of a dense ``[E, D]`` matrix in the
module's storage layout (``[p_t, r_t * q_t * r_{t+1}]`` per core, the
inverse of ``ops/contraction.py::tt_matrix_to_full``'s even/odd
interleave), so that::

    emb.import_full_weight(weight)

drops a pretrained table into a ``TTEmbeddingBag``. Standard TT-SVD
(Oseledets 2011): reshape to the interleaved ``[p0, q0, p1, q1, ...]``
tensor, then a left-to-right sweep of truncated SVDs.

Host-side numpy, a one-time migration cost: the first unfolding of an 11M x
64 table is ~[800, 880k], seconds of LAPACK. Where the requested rank
exceeds an unfolding's true rank the cores are zero-padded to the requested
shape and the decomposition is exact.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def tt_decompose(
    weight,
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
) -> List[np.ndarray]:
    """TT cores (storage layout, float32 numpy) approximating ``weight [E,
    D]`` (a numpy array or a tensor).

    ``E <= prod(tt_p_shapes)`` (extra rows are zero), ``D ==
    prod(tt_q_shapes)``; ``tt_ranks`` may be the internal ranks (len =
    ndim-1) or the full ``[1, ..., 1]`` vector. Returns one ``[p_t, r_t *
    q_t * r_{t+1}]`` array per core, without the leading ``num_tables``
    axis."""
    p = [int(v) for v in tt_p_shapes]
    q = [int(v) for v in tt_q_shapes]
    r = [int(v) for v in tt_ranks]
    if len(r) == len(p) - 1:
        r = [1] + r + [1]
    assert len(r) == len(p) + 1 and r[0] == 1 and r[-1] == 1, (p, r)
    if hasattr(weight, "detach"):  # a tensor, on any device
        weight = weight.detach().cpu().numpy()
    w = np.asarray(weight, dtype=np.float32)
    e_full, d = int(np.prod(p)), int(np.prod(q))
    assert w.ndim == 2 and w.shape[1] == d, (w.shape, d)
    assert w.shape[0] <= e_full, (w.shape, e_full)
    if w.shape[0] < e_full:
        w = np.concatenate(
            [w, np.zeros((e_full - w.shape[0], d), np.float32)], axis=0)

    ndim = len(p)
    # [prod(p), prod(q)] -> [p0..pn, q0..qn] -> interleaved [p0,q0,p1,q1,..]
    t = w.reshape(p + q)
    perm = []
    for i in range(ndim):
        perm += [i, ndim + i]
    t = np.transpose(t, perm)

    cores: List[np.ndarray] = []
    carry = t.reshape(1, -1)  # [r0, everything]
    for i in range(ndim - 1):
        m = carry.reshape(r[i] * p[i] * q[i], -1)
        u, s, vt = np.linalg.svd(m, full_matrices=False)
        k = min(r[i + 1], u.shape[1])
        u, s, vt = u[:, :k], s[:k], vt[:k]
        if k < r[i + 1]:  # the requested rank exceeds the unfolding's:
            # zero-pad to the storage shape; the product is unchanged
            u = np.pad(u, ((0, 0), (0, r[i + 1] - k)))
            sv = np.pad(s[:, None] * vt, ((0, r[i + 1] - k), (0, 0)))
        else:
            sv = s[:, None] * vt
        # canonical [r, p, q, r'] -> storage [p, r*q*r']
        core = u.reshape(r[i], p[i], q[i], r[i + 1])
        cores.append(
            np.ascontiguousarray(core.transpose(1, 0, 2, 3))
            .reshape(p[i], r[i] * q[i] * r[i + 1]))
        carry = sv
    core = carry.reshape(r[ndim - 1], p[-1], q[-1], r[ndim])
    cores.append(
        np.ascontiguousarray(core.transpose(1, 0, 2, 3))
        .reshape(p[-1], r[ndim - 1] * q[-1] * r[ndim]))
    return cores
