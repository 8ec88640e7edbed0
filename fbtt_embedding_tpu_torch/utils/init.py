"""Weight initialization schemes for TT cores.

Re-implements the five distributions of the reference's ``reset_parameters``
(``tt_embeddings_ops.py:613-792``) as pure functions producing numpy arrays
(host-side one-time generation, then a copy to the device — same flow as
the reference, which generates approx-* on CPU/numpy and copies).

A copy of ``fbtt_embedding_tpu.utils.init``: it stays numpy so that one
``np.random.default_rng(seed)`` feeds the same cores to both packages.

Core storage layout: ``[num_tables, p_t, r_t * q_t * r_{t+1}]``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

WEIGHT_DISTS = (
    "uniform",
    "naive-uniform",
    "normal",
    "approx-normal",
    "approx-uniform",
)


def core_shapes(
    num_tables: int,
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
) -> List[tuple]:
    """Storage shapes of the TT cores; tt_ranks is the full [1,..,1] vector."""
    return [
        (num_tables, tt_p_shapes[t], tt_ranks[t] * tt_q_shapes[t] * tt_ranks[t + 1])
        for t in range(len(tt_p_shapes))
    ]


def init_tt_cores(
    rng: np.random.Generator,
    weight_dist: str,
    num_tables: int,
    num_embeddings: int,
    embedding_dim: int,
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
) -> List[np.ndarray]:
    """Generate initial TT cores per the named distribution (float32)."""
    assert weight_dist in WEIGHT_DISTS, weight_dist
    ndim = len(tt_p_shapes)
    shapes = core_shapes(num_tables, tt_p_shapes, tt_q_shapes, tt_ranks)

    if weight_dist == "uniform":
        # Core scale such that the reconstructed table has Xavier-ish
        # variance (reference formula, tt_embeddings_ops.py:621-629).
        lamb = 2.0 / (num_embeddings + embedding_dim)
        stddev = np.sqrt(lamb)
        ranks = np.array(tt_ranks, dtype=np.float64)
        cr_exponent = -1.0 / (2 * ndim)
        var = np.prod(ranks**cr_exponent)
        core_stddev = stddev ** (1.0 / ndim) * var
        return [
            rng.uniform(0.0, core_stddev, size=s).astype(np.float32)
            for s in shapes
        ]

    if weight_dist == "naive-uniform":
        hi = 1.0 / np.sqrt(num_embeddings)
        return [rng.uniform(0.0, hi, size=s).astype(np.float32) for s in shapes]

    if weight_dist == "normal":
        sigma = 1.0 / np.sqrt(num_embeddings)
        scale = 1.0 / tt_ranks[0]
        return [
            (rng.normal(0.0, sigma, size=s) * scale).astype(np.float32)
            for s in shapes
        ]

    if weight_dist == "approx-normal":
        # N(0,1) conditioned on |w| >= 2, then scaled so the product of
        # ndim cores reconstructs ~N(0, 1/sqrt(E)) rows
        # (tt_embeddings_ops.py:642-659). Vectorized rejection sampling in
        # place of the reference's per-element Python loop.
        scale = np.power(1.0 / np.sqrt(3.0 * num_embeddings), 1.0 / 3.0)
        out = []
        for s in shapes:
            w = rng.normal(0.0, 1.0, size=s)
            bad = np.abs(w) < 2.0
            while bad.any():
                w[bad] = rng.normal(0.0, 1.0, size=int(bad.sum()))
                bad = np.abs(w) < 2.0
            out.append((w * scale).astype(np.float32))
        return out

    # approx-uniform: head/mid/tail "flat saw tooth" construction so the
    # *reconstructed* rows are approximately uniform
    # (tt_embeddings_ops.py:660-792). Requires tt_ndim == 3, num_tables == 1.
    assert ndim == 3, "approx-uniform requires tt_ndim == 3"
    assert num_tables == 1, "approx-uniform requires num_tables == 1"
    return _approx_uniform_cores(
        rng, num_embeddings, tt_p_shapes, tt_q_shapes, tt_ranks
    )


def _flat_saw_tooth(
    rng: np.random.Generator, nb_gridpts: int, width: float, nb_samples: int
) -> np.ndarray:
    """Sum of a uniform grid offset and a narrow uniform: a train of flat
    teeth that convolves to ~uniform when multiplied through the TT chain."""
    n = nb_gridpts
    delta = 1.0 / n
    j = rng.integers(-(n - 1), n, size=nb_samples)
    x = -width / 2.0 + width * rng.random(nb_samples)
    return j * delta + x


def _approx_uniform_cores(
    rng: np.random.Generator,
    num_embeddings: int,
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    sigma: float = 0.01,
    nb_gridpts: int = 15,
    width: float = 0.7 / 30.0,
) -> List[np.ndarray]:
    scale = 1.0 / (np.sqrt(num_embeddings) ** (1.0 / 3.0))
    dims = [
        (tt_ranks[t], tt_p_shapes[t], tt_q_shapes[t], tt_ranks[t + 1])
        for t in range(3)
    ]

    # Head (1, p0, q0, r1): rows ~ N(1/sqrt(r1), sigma) so that the product
    # with the mid core stays near the saw-tooth values.
    r1 = dims[0][-1]
    head = rng.normal(1.0 / np.sqrt(r1), sigma, size=dims[0])

    # Mid (r1, p1, q1, r2): background ~ N(1/sqrt(r1), sigma); for each
    # (p, q) position pick a random even r2-lane, zero its column except one
    # random r1-row which carries a saw-tooth sample.
    r1m, p1, q1, r2 = dims[1]
    mid_scale = 1.0 / np.sqrt(r1m)
    mid = rng.normal(mid_scale, sigma, size=dims[1]).reshape(r1m, p1 * q1, r2)
    values = _flat_saw_tooth(rng, nb_gridpts, width, p1 * q1) / mid_scale
    lanes = rng.integers(0, (r2 + 1) // 2, size=p1 * q1) * 2  # random even lane
    lanes = np.minimum(lanes, r2 - 1)
    rows = rng.integers(0, r1m, size=p1 * q1)
    cols = np.arange(p1 * q1)
    mid[:, cols, lanes] = rng.normal(0.0, sigma * sigma / mid_scale,
                                     size=(r1m, p1 * q1))
    mid[rows, cols, lanes] = values
    mid = mid.reshape(dims[1])

    # Tail (r2, p2, q2, 1): small background; one random odd lane per (p, q)
    # position carries a saw-tooth sample.
    r2t = dims[2][0]
    tail = rng.normal(0.0, sigma, size=dims[2]).reshape(r2t, -1)
    nb = tail.shape[1]
    values = _flat_saw_tooth(rng, nb_gridpts, width, nb)
    odd = rng.integers(0, max(1, r2t // 2), size=nb) * 2 + 1
    odd = np.minimum(odd, r2t - 1)
    tail[odd, np.arange(nb)] = values
    tail = tail.reshape(dims[2])

    out = []
    for t, core in enumerate((head, mid, tail)):
        c = (core * scale).astype(np.float32)
        # canonical [r, p, q, r'] -> storage [1, p, r*q*r'].
        c = c.transpose(1, 0, 2, 3).reshape(1, tt_p_shapes[t], -1)
        out.append(np.ascontiguousarray(c))
    return out
