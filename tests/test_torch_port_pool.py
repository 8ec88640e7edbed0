"""PyTorch port vs the JAX package: the pools on both sides of 4096 rows.

On the CPU, up to ``bag_pool._POOL_ONEHOT_MAX_TB`` = 4096 pooled rows the
flat pipeline pools by a one-hot product (``bag_pool``'s plain route; the
card runs its kernel at every size); above it, and always in
``pool_rows``, by the
deterministic segment sum (``ops.hot_scatter.segment_sum``: a stable sort
by bag, then each bag's rows added in order). On numpy-seeded inputs at
narrow widths (p = [8, 9, 10], q = [2, 2, 4], ranks [8, 8], D = 16):

- ``pool_rows`` at 4096 and 4100 bags, one and two tables, against the
  JAX package's ``pool_rows`` (its ``segment_sum``), rtol = atol = 1e-5;
- the serve (``make_serving_fn``: the flat forward) and the fused step
  (``flat_train_apply``) at 4096 and 4104 bags (the flat pipeline takes
  multiples of 8) against JAX's ``make_serving_fn`` and
  ``make_fused_train_step``, outputs and updated cores within rtol 1e-5;
- every one of them twice, bitwise equal;
- ``segment_sum`` itself: pad rows (-1, past the end) dropped, empty bags
  zero, against a float64 sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbtt_embedding_tpu import TTEmbeddingParams as JParams
from fbtt_embedding_tpu.models.tt_embedding import (
    OptimType as JOptimType,
    make_fused_train_step as j_make_step,
    make_serving_fn as j_make_serving,
)
from fbtt_embedding_tpu.ops.lookup import pool_rows as j_pool_rows
from fbtt_embedding_tpu.utils.init import init_tt_cores
from fbtt_embedding_tpu_torch import (
    make_fused_train_step,
    make_serving_fn,
    params_from_jax,
    pool_rows,
)
from fbtt_embedding_tpu_torch.ops.hot_scatter import segment_sum
from fbtt_embedding_tpu_torch.ops.kernels import bag_pool
from fbtt_embedding_tpu_torch.ops.kernels import tt_flat as tflat

P, Q, R = [8, 9, 10], [2, 2, 4], [1, 8, 8, 1]
E, D, L = 8 * 9 * 10, 16, 2
TIGHT = dict(rtol=1e-5, atol=1e-5)
UPD = dict(rtol=1e-5, atol=1e-6)
LR = 0.05


def test_threshold_is_4096():
    assert bag_pool._POOL_ONEHOT_MAX_TB == 4096


def test_segment_sum_drops_pads_and_matches_float64():
    rng = np.random.default_rng(0)
    n, segs = 5000, 300
    rows = rng.normal(size=(n, 3)).astype(np.float32)
    seg = rng.integers(-1, segs + 2, size=n)  # -1 and past the end: pads
    seg[seg == 7] = 8  # bag 7 stays empty
    got = segment_sum(torch.as_tensor(rows), torch.as_tensor(seg), segs)
    want = np.zeros((segs, 3))
    keep = (seg >= 0) & (seg < segs)
    np.add.at(want, seg[keep], rows[keep].astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not got[7].any()
    again = segment_sum(torch.as_tensor(rows), torch.as_tensor(seg), segs)
    assert torch.equal(got, again)


@pytest.mark.parametrize("tables,bags", [(1, 4096), (1, 4100), (2, 2050)])
def test_pool_rows_matches_jax(tables, bags):
    rng = np.random.default_rng(bags + tables)
    nnz = tables * bags * L
    rows = rng.normal(size=(nnz, D)).astype(np.float32)
    rowidx = rng.integers(0, bags, size=nnz).astype(np.int32)
    tbl = rng.integers(0, tables, size=nnz).astype(np.int32)
    jt = None if tables == 1 else jnp.asarray(tbl)
    want = j_pool_rows(jnp.asarray(rows), jnp.asarray(rowidx), jt, tables,
                       bags)
    tt = None if tables == 1 else torch.as_tensor(tbl)
    got = pool_rows(torch.as_tensor(rows), torch.as_tensor(rowidx), tt,
                    tables, bags)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    again = pool_rows(torch.as_tensor(rows), torch.as_tensor(rowidx), tt,
                      tables, bags)
    assert torch.equal(got, again)


def _case(bags, seed):
    rng = np.random.default_rng(seed)
    cores = [np.asarray(c, np.float32) for c in init_tt_cores(
        rng, "uniform", 1, E, D, P, Q, R)]
    nnz = bags * L
    idx = rng.integers(0, E, size=nnz).astype(np.int32)
    offs = np.arange(0, nnz + 1, L, dtype=np.int32)
    w = rng.random(nnz).astype(np.float32)
    d_out = (rng.normal(size=(1, bags, D)) * 0.1).astype(np.float32)
    return cores, idx, offs, w, d_out


@pytest.mark.parametrize("bags", [4096, 4104])
def test_flat_serve_across_threshold_matches_jax(bags):
    cores, idx, offs, w, _ = _case(bags, 3)
    assert tflat.flat_available(P, Q, R, 1, bags)
    jparams = JParams(tuple(jnp.asarray(c) for c in cores), (), None)
    want = j_make_serving(P, Q, R, 1, bags)(
        jparams, jnp.asarray(idx), jnp.asarray(offs), jnp.asarray(w))
    serve = make_serving_fn(P, Q, R, 1, bags, device="cpu")
    params = params_from_jax(cores, device="cpu")
    got = serve(params, idx, offs, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    assert torch.equal(got, serve(params, idx, offs, w))


@pytest.mark.parametrize("bags", [4096, 4104])
def test_flat_step_across_threshold_matches_jax(bags):
    cores, idx, offs, w, d_out = _case(bags, 5)
    opt = [np.zeros(0, np.float32)] * len(cores)
    jstep = j_make_step(P, Q, R, 1, bags, optimizer=JOptimType.SGD)
    jout, jnew = jstep(JParams(tuple(jnp.asarray(c) for c in cores),
                               tuple(jnp.asarray(o) for o in opt), None),
                       jnp.asarray(idx), jnp.asarray(offs),
                       jnp.asarray(d_out),
                       (jnp.float32(LR), jnp.float32(1.0)),
                       weights=jnp.asarray(w))
    step = make_fused_train_step(P, Q, R, 1, bags, device="cpu")
    runs = []
    for _ in range(2):
        out, new = step(params_from_jax(cores, opt, device="cpu"), idx, offs,
                        d_out, (LR, 1.0), weights=w)
        runs.append((out, new.tt_cores))
    np.testing.assert_allclose(runs[0][0].numpy(), np.asarray(jout), **TIGHT)
    for a, b, c in zip(runs[0][1], jnew.tt_cores, cores):
        np.testing.assert_allclose(a.numpy() - c, np.asarray(b) - c, **UPD)
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
