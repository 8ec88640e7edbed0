"""PyTorch port vs the JAX package: the generic per-lookup path (CPU).

- the generic forward kernel (B4) and backward kernel (B5): their plain
  versions ``tt_fwd_plain`` / ``tt_bwd_plain`` against the Pallas kernels
  ``tt_forward_pallas`` / ``tt_backward_pallas`` in interpret mode, over
  the cases of ``tests/test_pallas_kernel.py`` and a live-count case
  (live-first packing, zero tail weights), forward rtol = atol = 1e-5,
  gradients rtol 1e-4, atol 1e-5 (the JAX suite's tolerances);
- ``pooled_tt_lookup(impl="pallas")``, output and autograd gradients,
  against the JAX ``impl="pallas", interpret=True`` VJP;
- ``make_serving_fn(impl="pallas")`` against JAX's serve (``impl="xla"``:
  its entry points expose no ``interpret``), rtol = atol = 2e-4;
- three SGD and three Adagrad steps of ``make_fused_train_step(impl=
  "pallas")`` against JAX's ``impl="xla"`` step, rtol 1e-4, atol 1e-5;
- a small tt_ndim-4 model of the billion-row model's widths (q = [2, 4,
  2, 4], ranks 16: B4's and B5's pivot rules take it): three SGD steps of
  the ``impl="pallas"`` step without and with LFU counting (a hashed
  table, uniform and Zipf ids), then its serve, against JAX's, rtol 1e-4;
- the dense-mode exports and ``tt_{sgd,adagrad}_backward`` against their
  JAX counterparts;
- the errors: tt_ndim 5, bad dtypes and shapes;
- a fresh process that serves and trains with ``impl="pallas"`` without
  importing JAX.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbtt_embedding_tpu import TTEmbeddingParams as JParams
from fbtt_embedding_tpu.models.tt_embedding import OptimType as JOptimType
from fbtt_embedding_tpu.models.tt_embedding import (
    make_fused_train_step as j_make_step,
)
from fbtt_embedding_tpu.models.tt_embedding import (
    make_serving_fn as j_make_serving_fn,
)
from fbtt_embedding_tpu.ops import cache as jcache
from fbtt_embedding_tpu.ops import fused_optim as joptim
from fbtt_embedding_tpu.ops import lookup as jlookup
from fbtt_embedding_tpu.ops.indexing import decompose_indices as j_decompose
from fbtt_embedding_tpu.ops.pallas import tt_kernel as jkernel
from fbtt_embedding_tpu.ops.pallas.tt_kernel import (
    tt_backward_pallas,
    tt_forward_pallas,
)
from fbtt_embedding_tpu_torch import (
    OptimType,
    decompose_indices,
    generic_available,
    init_tt_cores,
    make_fused_train_step,
    make_serving_fn,
    params_from_jax,
    pooled_tt_lookup,
    tt_adagrad_backward,
    tt_backward_kernel,
    tt_bwd,
    tt_bwd_plain,
    tt_dense_backward,
    tt_embedding_bag_forward,
    tt_forward,
    tt_forward_kernel,
    tt_fwd,
    tt_fwd_plain,
    tt_grads_from_row_cotangents,
    tt_sgd_backward,
)
from fbtt_embedding_tpu_torch.ops.kernels import tt_bwd as tbwd
from fbtt_embedding_tpu_torch.ops.kernels import tt_fwd as tfwd
from fbtt_embedding_tpu_torch.ops.kernels import tt_kernel as tkernel

ROOT = Path(__file__).resolve().parents[1]
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BLOCK_N = 16  # as tests/test_pallas_kernel.py: small interpreted blocks

# the cases of tests/test_pallas_kernel.py, and one with a live count
CASES = [
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=2),
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=2, weights=True),
    dict(p=[16, 16, 16], q=[4, 4, 4], ranks=[8, 8], b=8, L=2, T=2),
    dict(p=[30, 40], q=[8, 8], ranks=[8], b=16, L=2),
    dict(p=[8, 9, 10, 11], q=[2, 2, 2, 2], ranks=[8, 8, 8], b=16, L=2),
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=2, weights=True,
         live=21),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread keeps this module from crowding
    the other test workers' cores, and is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def make_case(p, q, ranks, b, L, T=1, weights=False, live=None, seed=0):
    """numpy inputs of one case; with ``live``, the first ``live`` lookups
    are live and the tail has weight 0 (the caller's live-first
    packing)."""
    rfull = [1] + list(ranks) + [1]
    E, D = int(np.prod(p)), int(np.prod(q))
    nnz = T * b * L
    rng = np.random.default_rng(seed)
    cores = init_tt_cores(rng, "uniform", T, E, D, p, q, rfull)
    indices = rng.integers(0, E, size=nnz).astype(np.int32)
    rowidx = (np.arange(nnz) % b).astype(np.int32)
    tableidx = ((np.arange(nnz) // (nnz // T)).astype(np.int32)
                if T > 1 else None)
    w = rng.random(nnz).astype(np.float32) if weights else None
    live_count = None
    if live is not None:
        w[live:] = 0.0
        live_count = np.array([live], np.int32)
    d_out = rng.normal(size=(T, b, D)).astype(np.float32)
    return rfull, D, cores, indices, rowidx, tableidx, w, live_count, d_out


def _unpack(case):
    case = dict(case)
    return case.pop("p"), case.pop("q"), case.pop("ranks"), case


def _kernel_args(cores, p, q, rfull, b, indices, rowidx, tableidx, w, live):
    """The kernels' exact arguments, as the host drivers build them."""
    T = cores[0].shape[0]
    gk = tkernel._kernel_cores([torch.as_tensor(c) for c in cores], p, q,
                               rfull)
    parts = decompose_indices(torch.as_tensor(indices), p)
    idx, rowv, wv = tkernel.block_inputs(parts, _t(rowidx), _t(tableidx),
                                         _t(w), _t(live), p, T, b)
    return T, gk, idx, rowv, wv


@pytest.mark.parametrize("case", CASES)
def test_tt_fwd_plain_matches_pallas_kernel(case):
    p, q, ranks, kw = _unpack(case)
    b = kw["b"]
    rfull, D, cores, idx_np, rowidx, tableidx, w, live, _ = make_case(
        p, q, ranks, **kw)
    want = tt_forward_pallas(
        [jnp.asarray(c) for c in cores], p, q, rfull, b,
        j_decompose(jnp.asarray(idx_np), p), jnp.asarray(rowidx),
        _j(tableidx), _j(w), block_n=BLOCK_N, interpret=True,
        live_count=_j(live))
    T, gk, idx, rowv, wv = _kernel_args(cores, p, q, rfull, b, idx_np,
                                        rowidx, tableidx, w, live)
    order, starts = tkernel.bag_order(rowv, T * b)
    got = tt_fwd_plain(gk, idx, rowv, wv, order, starts)
    assert got.dtype == torch.float32 and got.shape == (T * b, D)
    np.testing.assert_allclose(got.reshape(T, b, D).numpy(),
                               np.asarray(want), **FWD_TOL)
    # the wrapper and the host driver take the plain version on the CPU
    before = tt_fwd.launches
    assert torch.equal(tt_fwd(gk, idx, rowv, wv, order, starts), got)
    drv = tt_forward_kernel(
        [torch.as_tensor(c) for c in cores], p, q, rfull, b,
        decompose_indices(torch.as_tensor(idx_np), p), _t(rowidx),
        _t(tableidx), _t(w), _t(live))
    assert tt_fwd.launches == before
    assert torch.equal(drv, got.reshape(T, b, D))


@pytest.mark.parametrize("case", CASES)
def test_tt_bwd_plain_matches_pallas_kernel(case):
    p, q, ranks, kw = _unpack(case)
    b = kw["b"]
    rfull, D, cores, idx_np, rowidx, tableidx, w, live, d_out = make_case(
        p, q, ranks, **kw)
    want = tt_backward_pallas(
        [jnp.asarray(c) for c in cores], p, q, rfull, b,
        j_decompose(jnp.asarray(idx_np), p), jnp.asarray(rowidx),
        jnp.asarray(d_out), _j(tableidx), _j(w), block_n=BLOCK_N,
        interpret=True, live_count=_j(live))
    T, gk, idx, rowv, wv = _kernel_args(cores, p, q, rfull, b, idx_np,
                                        rowidx, tableidx, w, live)
    sched = tkernel.core_orders(idx, rowv, [T * p_ for p_ in p])
    dout = torch.as_tensor(d_out).reshape(T * b, D)
    got = tt_bwd_plain(gk, idx, rowv, wv, dout, *sched, seg=tkernel.SEG)
    mod = tkernel.grads_to_module_layout(got, p, q, rfull, T)
    for a, b_ in zip(mod, want):
        assert a.dtype == torch.float32 and a.shape == b_.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **GRAD_TOL)
    before = tt_bwd.launches
    again = tt_bwd(gk, idx, rowv, wv, dout, *sched, seg=tkernel.SEG)
    drv = tt_backward_kernel(
        [torch.as_tensor(c) for c in cores], p, q, rfull, b,
        decompose_indices(torch.as_tensor(idx_np), p), _t(rowidx),
        torch.as_tensor(d_out), _t(tableidx), _t(w), _t(live))
    assert tt_bwd.launches == before
    assert all(torch.equal(a, c) for a, c in zip(again, got))
    assert all(torch.equal(a, c) for a, c in zip(drv, mod))


def test_core_orders_schedule():
    """Every live lookup sits in the span of its core row, dead ones in
    the sentinel span, and each segment's spans are the ones it meets."""
    rng = np.random.default_rng(3)
    rows = [7, 5]
    idx = torch.as_tensor(np.stack([rng.integers(0, r, 150) for r in rows])
                          .astype(np.int32))
    rowv = torch.as_tensor(np.where(rng.random(150) < 0.2, -1, 0)
                           .astype(np.int32))
    orders, runs, first, cnt = tkernel.core_orders(idx, rowv, rows, seg=64)
    assert orders.shape == (2, 192) and runs.shape == (2, 9)
    for t, r in enumerate(rows):
        for j in range(r + 1):
            span = orders[t, runs[t, j]:runs[t, j + 1]]
            for lk in span.tolist():
                if lk >= 150 or rowv[lk] < 0:
                    assert j == r
                else:
                    assert idx[t, lk] == j
            assert span.tolist() == sorted(span.tolist())  # stable
        for s in range(3):
            met = [j for j in range(r + 1)
                   if runs[t, j] < min(runs[t, j + 1], (s + 1) * 64)
                   and runs[t, j + 1] > s * 64]
            assert met == list(range(int(first[t, s]),
                                     int(first[t, s] + cnt[t, s])))


def test_bag_order_groups_lookups_by_bag():
    rowv = torch.tensor([3, 0, -1, 3, 1, 0, -1, 3], dtype=torch.int32)
    order, starts = tkernel.bag_order(rowv, 5)
    assert order.tolist()[:6] == [1, 5, 4, 0, 3, 7]
    assert starts.tolist() == [0, 2, 3, 3, 6, 6]


@pytest.mark.parametrize("case", [CASES[1], CASES[2], CASES[3]])
def test_pooled_lookup_pallas_vjp_matches_jax(case, monkeypatch):
    # the JAX lookup picks its block size itself; small interpreted blocks
    # keep the unrolled graph tractable, as BLOCK_N does above
    monkeypatch.setattr(jkernel, "choose_block_n",
                        lambda *a, **k: BLOCK_N)
    p, q, ranks, kw = _unpack(case)
    b = kw["b"]
    rfull, D, cores, idx_np, rowidx, tableidx, w, _, d_out = make_case(
        p, q, ranks, **kw)

    def f_jax(cs):
        return jlookup.pooled_tt_lookup(
            cs, p, q, rfull, b, jnp.asarray(idx_np), jnp.asarray(rowidx),
            _j(tableidx), _j(w), impl="pallas", interpret=True)

    jout, vjp = jax.vjp(f_jax, tuple(jnp.asarray(c) for c in cores))
    (jgrads,) = vjp(jnp.asarray(d_out))
    leaves = [torch.tensor(c, requires_grad=True) for c in cores]
    out = pooled_tt_lookup(leaves, p, q, rfull, b, torch.as_tensor(idx_np),
                           _t(rowidx), _t(tableidx), weights=_t(w),
                           impl="pallas")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    out.backward(torch.as_tensor(d_out))
    for c, g in zip(leaves, jgrads):
        np.testing.assert_allclose(c.grad.numpy(), np.asarray(g), **GRAD_TOL)


def test_pooled_lookup_pallas_live_count_and_dead_mask():
    """A live count and the equivalent dead mask skip the same lookups."""
    p, q, ranks, kw = _unpack(CASES[5])
    b = kw["b"]
    rfull, D, cores, idx_np, rowidx, _, w, live, d_out = make_case(
        p, q, ranks, **kw)
    dead = np.arange(idx_np.shape[0]) >= live[0]
    outs = []
    for extra in (dict(live_count=_t(live)),
                  dict(dead_mask=torch.as_tensor(dead))):
        leaves = [torch.tensor(c, requires_grad=True) for c in cores]
        out = pooled_tt_lookup(leaves, p, q, rfull, b,
                               torch.as_tensor(idx_np), _t(rowidx),
                               weights=_t(w), impl="pallas", **extra)
        out.backward(torch.as_tensor(d_out))
        outs.append((out.detach(), [c.grad for c in leaves]))
    leaves = [torch.tensor(c, requires_grad=True) for c in cores]
    ref = pooled_tt_lookup(leaves, p, q, rfull, b, torch.as_tensor(idx_np),
                           _t(rowidx), weights=_t(w), impl="xla")
    ref.backward(torch.as_tensor(d_out))
    for out, grads in outs:
        np.testing.assert_allclose(out.numpy(), ref.detach().numpy(),
                                   **FWD_TOL)
        for g, c in zip(grads, leaves):
            np.testing.assert_allclose(g.numpy(), c.grad.numpy(), **GRAD_TOL)


SERVE_CASES = [
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=3, weights=True),
    dict(p=[16, 16, 16], q=[4, 4, 4], ranks=[8, 8], b=8, L=2, T=2),
    dict(p=[7, 9, 11], q=[3, 4, 5], ranks=[13, 12], b=8, L=4),
    dict(p=[30, 40], q=[8, 8], ranks=[8], b=16, L=2),
    dict(p=[8, 9, 10, 11], q=[2, 2, 2, 2], ranks=[8, 8, 8], b=16, L=2),
]


def _entry_setup(case, seed=7):
    p, q, ranks = case["p"], case["q"], case["ranks"]
    b, L, T = case["b"], case["L"], case.get("T", 1)
    rfull = [1] + list(ranks) + [1]
    E, D = int(np.prod(p)), int(np.prod(q))
    nnz = T * b * L
    rng = np.random.default_rng(seed)
    cores = init_tt_cores(rng, "uniform", T, E, D, p, q, rfull)
    batches = []
    for _ in range(3):
        idx = rng.integers(0, E, size=nnz).astype(np.int32)
        offs = np.arange(0, nnz + 1, L, dtype=np.int32)
        w = (rng.random(nnz).astype(np.float32) if case.get("weights")
             else None)
        batches.append((idx, offs, rng.normal(size=(T, b, D)).astype(
            np.float32), w))
    return p, q, rfull, T, b, cores, batches


@pytest.mark.parametrize("case", SERVE_CASES)
def test_serve_pallas_matches_jax(case):
    p, q, rfull, T, b, cores, batches = _entry_setup(case)
    jparams = JParams(tuple(jnp.asarray(c) for c in cores),
                      tuple(jnp.zeros((0,), jnp.float32) for _ in cores),
                      None)
    jserve = j_make_serving_fn(p, q, rfull, num_tables=T, batch_size=b,
                               probe_cache=False, impl="xla")
    params = params_from_jax(cores, device="cpu")
    serve = make_serving_fn(p, q, rfull, num_tables=T, batch_size=b,
                            impl="pallas", device="cpu")
    before = tt_fwd.launches
    for idx, offs, _, w in batches[:2]:
        want = np.asarray(jserve(jparams, jnp.asarray(idx),
                                 jnp.asarray(offs), _j(w)))
        got = serve(params, idx, offs, w)
        assert got.device.type == "cpu" and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert tt_fwd.launches == before


STEP_CASES = [
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=3,
         weights=True),
    dict(p=[16, 16, 16], q=[4, 4, 4], ranks=[8, 8], b=8, L=2, T=2),
    dict(p=[30, 40], q=[8, 8], ranks=[8], b=16, L=2),
    dict(p=[8, 9, 10, 11], q=[2, 4, 2, 2], ranks=[8, 8, 8], b=8, L=3),
    dict(p=[7, 9, 11], q=[3, 4, 5], ranks=[13, 12], b=8, L=4),
]
# as tests/test_torch_port_train.py: eps = 1e-3 keeps Adagrad's first-step
# magnification of summation-order noise below the tolerance
LR, EPS = 0.01, 1e-3


@pytest.mark.parametrize("optimizer", ["SGD", "EXACT_ADAGRAD"])
@pytest.mark.parametrize("case", STEP_CASES)
def test_train_step_pallas_matches_jax(case, optimizer):
    p, q, rfull, T, b, cores, batches = _entry_setup(case, seed=17)
    sgd = optimizer == "SGD"
    state = [] if sgd else [np.zeros_like(c) for c in cores]
    jstep = j_make_step(p, q, rfull, T, b, impl="xla",
                        optimizer=getattr(JOptimType, optimizer))
    tstep = make_fused_train_step(p, q, rfull, T, b, impl="pallas",
                                  optimizer=getattr(OptimType, optimizer),
                                  device="cpu")
    jparams = JParams(tuple(jnp.asarray(c) for c in cores),
                      tuple(jnp.asarray(s) for s in state), None)
    params = params_from_jax(cores, state, device="cpu")
    for idx, offs, d_out, w in batches:
        jout, jparams = jstep(jparams, jnp.asarray(idx), jnp.asarray(offs),
                              jnp.asarray(d_out),
                              (jnp.float32(LR), jnp.float32(EPS)), _j(w))
        out, params = tstep(params, idx, offs, d_out, (LR, EPS), w)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                                   atol=1e-5)
        for a, b_ in zip(list(params.tt_cores) + list(params.optimizer_state),
                         list(jparams.tt_cores)
                         + list(jparams.optimizer_state)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-4,
                                       atol=1e-5)


# the billion-row model's widths at a small E (q = [2, 4, 2, 4], D = 64)
NDIM4 = dict(p=[5, 6, 7, 8], q=[2, 4, 2, 4], ranks=[16, 16, 16], b=16, L=4)


@pytest.mark.parametrize("counting", [False, True])
@pytest.mark.parametrize("zipf", [False, True])
def test_tt_ndim4_pallas_step_and_serve_match_jax(counting, zipf):
    """The tt_ndim-4 impl="pallas" step (fused SGD, with and without LFU
    counting into a hashed table) and serve against JAX's, rtol 1e-4: on
    the CPU the kernels' plain versions run, on the path the card's pivot
    rules give B4 and B5 at these widths."""
    p, q, b, L = NDIM4["p"], NDIM4["q"], NDIM4["b"], NDIM4["L"]
    rfull = [1] + NDIM4["ranks"] + [1]
    assert tfwd.fwd_path(q, rfull)[0] == tbwd.bwd_path(q, rfull)[0] == "pivot"
    E, D, nnz = int(np.prod(p)), int(np.prod(q)), b * L
    rng = np.random.default_rng(23)
    cores = init_tt_cores(rng, "uniform", 1, E, D, p, q, rfull)
    jstate = tstate = None
    if counting:  # 256 slots for 1680 ids: a hashed table
        jstate = jcache.make_cache_state(256, 32, D)
    jparams = JParams(tuple(jnp.asarray(c) for c in cores), (), jstate)
    params = params_from_jax(cores, device="cpu", cache=jstate)
    kw = dict(use_cache=counting)
    jstep = j_make_step(p, q, rfull, 1, b, impl="xla", **kw)
    tstep = make_fused_train_step(p, q, rfull, 1, b, impl="pallas",
                                  device="cpu", **kw)
    offs = np.arange(0, nnz + 1, L, dtype=np.int32)
    for _ in range(3):
        idx = ((rng.zipf(1.05, size=nnz) - 1) % E if zipf
               else rng.integers(0, E, size=nnz)).astype(np.int32)
        d_out = rng.normal(size=(1, b, D)).astype(np.float32)
        jout, jparams = jstep(jparams, jnp.asarray(idx), jnp.asarray(offs),
                              jnp.asarray(d_out),
                              (jnp.float32(LR), jnp.float32(EPS)))
        out, params = tstep(params, idx, offs, d_out, (LR, EPS))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                                   atol=1e-5)
        for a, c in zip(params.tt_cores, jparams.tt_cores):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4,
                                       atol=1e-5)
        if counting:
            tstate = params.cache
            for f in ("keys", "freq", "slots"):
                np.testing.assert_array_equal(
                    getattr(tstate, f).numpy(),
                    np.asarray(getattr(jparams.cache, f)), err_msg=f)
    if counting:  # counted (ids past MAX_PROBES of their hash are not)
        assert 0 < int(tstate.freq.sum()) <= 3 * nnz
    serve = make_serving_fn(p, q, rfull, 1, b, impl="pallas", device="cpu")
    jserve = j_make_serving_fn(p, q, rfull, num_tables=1, batch_size=b,
                               probe_cache=False, impl="xla")
    got = serve(params_from_jax([c.numpy() for c in params.tt_cores],
                                device="cpu"), idx, offs)
    want = jserve(JParams(jparams.tt_cores, (), None), jnp.asarray(idx),
                  jnp.asarray(offs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def _dense_inputs(case):
    p, q, ranks, kw = _unpack(case)
    b = kw["b"]
    rfull, D, cores, idx_np, rowidx, tableidx, w, _, d_out = make_case(
        p, q, ranks, **kw)
    return p, q, rfull, b, D, cores, idx_np, rowidx, tableidx, w, d_out


@pytest.mark.parametrize("case", [CASES[1], CASES[2], CASES[4]])
def test_dense_exports_match_jax(case):
    p, q, rfull, b, D, cores, idx_np, rowidx, tableidx, w, d_out = \
        _dense_inputs(case)
    jc = [jnp.asarray(c) for c in cores]
    tc = [torch.as_tensor(c) for c in cores]
    idx, rows = torch.as_tensor(idx_np), torch.as_tensor(rowidx)
    want = jlookup.tt_forward(jc, p, q, rfull, b, jnp.asarray(idx_np),
                              jnp.asarray(rowidx), _j(tableidx), _j(w))
    got = tt_forward(tc, p, q, rfull, b, idx, rows, _t(tableidx), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)

    want = jlookup.tt_dense_backward(jc, p, q, rfull, b, jnp.asarray(idx_np),
                                     jnp.asarray(rowidx), _j(tableidx),
                                     jnp.asarray(d_out))
    got = tt_dense_backward(tc, p, q, rfull, b, idx, rows, _t(tableidx),
                            torch.as_tensor(d_out))
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **GRAD_TOL)

    d_rows = np.random.default_rng(5).normal(
        size=(idx_np.shape[0], D)).astype(np.float32)
    want = jlookup.tt_grads_from_row_cotangents(
        jc, p, q, rfull, jnp.asarray(idx_np), _j(tableidx),
        jnp.asarray(d_rows))
    got = tt_grads_from_row_cotangents(tc, p, q, rfull, idx, _t(tableidx),
                                       torch.as_tensor(d_rows))
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **GRAD_TOL)


@pytest.mark.parametrize("T", [1, 2])
def test_embedding_bag_forward_matches_jax(T):
    p, q, rfull = [20, 22, 25], [4, 4, 4], [1, 8, 8, 1]
    rng = np.random.default_rng(11)
    cores = init_tt_cores(rng, "uniform", T, 11000, 64, p, q, rfull)
    nnz = 40 * T
    idx = rng.integers(0, 11000, nnz).astype(np.int32)
    offs = np.sort(rng.integers(0, nnz, 8 * T + 1)).astype(np.int32)
    offs[0], offs[-1] = 0, nnz
    w = rng.random(nnz).astype(np.float32)
    want = jlookup.tt_embedding_bag_forward(
        [jnp.asarray(c) for c in cores], p, q, rfull, jnp.asarray(idx),
        jnp.asarray(offs), 8, jnp.asarray(w))
    got = tt_embedding_bag_forward([torch.as_tensor(c) for c in cores], p, q,
                                   rfull, torch.as_tensor(idx),
                                   torch.as_tensor(offs), 8,
                                   torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[2]])
def test_backward_optimizers_match_jax(case):
    p, q, rfull, b, D, cores, idx_np, rowidx, tableidx, _, d_out = \
        _dense_inputs(case)
    args_j = (p, q, rfull, b, jnp.asarray(idx_np), jnp.asarray(rowidx),
              _j(tableidx), jnp.asarray(d_out))
    args_t = (p, q, rfull, b, torch.as_tensor(idx_np),
              torch.as_tensor(rowidx), _t(tableidx), torch.as_tensor(d_out))
    want = joptim.tt_sgd_backward([jnp.asarray(c) for c in cores], *args_j,
                                  0.05)
    tc = [torch.tensor(c) for c in cores]
    got = tt_sgd_backward(tc, *args_t, 0.05)
    assert all(a is c for a, c in zip(got, tc))  # in place
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **GRAD_TOL)

    state = [np.full_like(c, 0.1) for c in cores]
    want_c, want_s = joptim.tt_adagrad_backward(
        [jnp.asarray(c) for c in cores], [jnp.asarray(s) for s in state],
        *args_j, 0.05, 1e-3)
    got_c, got_s = tt_adagrad_backward(
        [torch.tensor(c) for c in cores], [torch.tensor(s) for s in state],
        *args_t, 0.05, 1e-3)
    for a, b_ in zip(list(got_c) + list(got_s), list(want_c) + list(want_s)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **GRAD_TOL)


def test_generic_path_errors():
    p5, q5, r5 = [4] * 5, [2] * 5, [1, 4, 4, 4, 4, 1]
    assert not generic_available(p5, q5, r5, 1, 8)
    assert generic_available([20, 22, 25], [4, 4, 4], [1, 8, 8, 1], 1, 8)
    cores5 = [torch.zeros(1, 4, 32)] * 5
    with pytest.raises(ValueError):  # tt_ndim 5: validated, never served
        pooled_tt_lookup(cores5, p5, q5, r5, 8, torch.arange(16),
                         torch.arange(16) // 2, impl="pallas")
    with pytest.raises(ValueError):  # the chain's states pass shared memory
        pooled_tt_lookup([torch.zeros(1, 4, 256 * 64),
                          torch.zeros(1, 4, 64 * 256)], [4, 4], [256, 256],
                         [1, 64, 1], 8, torch.arange(16),
                         torch.arange(16) // 2, impl="pallas")
    with pytest.raises(ValueError):
        make_fused_train_step(p5, q5, r5, 1, 8, impl="pallas", device="cpu")


def test_wrappers_check_inputs():
    p, q, ranks, kw = _unpack(CASES[1])
    b = kw["b"]
    rfull, D, cores, idx_np, rowidx, _, w, _, d_out = make_case(
        p, q, ranks, **kw)
    T, gk, idx, rowv, wv = _kernel_args(cores, p, q, rfull, b, idx_np,
                                        rowidx, None, w, None)
    order, starts = tkernel.bag_order(rowv, b)
    sched = tkernel.core_orders(idx, rowv, [p_ for p_ in p])
    dout = torch.as_tensor(d_out).reshape(b, D)
    bad_fwd = [
        (tuple(g.double() for g in gk), idx, rowv, wv),    # float64 cores
        (gk, idx.long(), rowv, wv),                        # int64 ids
        (gk, idx[:2], rowv, wv),                           # ids of 2 cores
        (gk, idx, rowv[:-1], wv),                          # short rowv
        (gk, idx, rowv, wv.double()),                      # float64 weights
        (gk[:1], idx[:1], rowv, wv),                       # tt_ndim 1
        ((gk[0], gk[1][:, :4], gk[2]), idx, rowv, wv),     # ranks disagree
    ]
    for args in bad_fwd:
        with pytest.raises(ValueError):
            tt_fwd(*args, order, starts)
        with pytest.raises(ValueError):
            tt_bwd(*args, dout, *sched, seg=tkernel.SEG)
    with pytest.raises(ValueError):  # int64 schedule
        tt_fwd(gk, idx, rowv, wv, order.long(), starts)
    with pytest.raises(ValueError):  # dout of the wrong width
        tt_bwd(gk, idx, rowv, wv, dout[:, :8].contiguous(), *sched,
               seg=tkernel.SEG)
    with pytest.raises(ValueError):  # segments too short for the lookups
        tt_bwd(gk, idx, rowv, wv, dout, *sched, seg=8)
    with pytest.raises(ValueError):  # runs too short for the core rows
        tt_bwd(gk, idx, rowv, wv, dout, sched[0], sched[1][:, :5],
               *sched[2:], seg=tkernel.SEG)
    meta = [t.to("meta") for t in (idx, rowv, wv, order, starts)]
    with pytest.raises(ValueError):  # neither cpu nor cuda: no fallback
        tt_fwd(tuple(g.to("meta") for g in gk), *meta)
    with pytest.raises(ValueError):  # inputs on two devices
        tt_fwd(tuple(g.to("meta") for g in gk), idx, rowv, wv, order, starts)


def test_port_serves_and_trains_pallas_without_jax():
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "import fbtt_embedding_tpu_torch as m\n"
        "p, q, r = [20, 22, 25], [4, 4, 4], [1, 8, 8, 1]\n"
        "cores = m.init_tt_cores(np.random.default_rng(0), 'uniform', 1,"
        " 11000, 64, p, q, r)\n"
        "rng = np.random.default_rng(1)\n"
        "params = m.params_from_jax(cores, device='cpu')\n"
        "serve = m.make_serving_fn(p, q, r, 1, 8, impl='pallas',"
        " device='cpu')\n"
        "assert serve(params, rng.integers(0, 11000, 16),"
        " np.arange(0, 17, 2)).shape == (1, 8, 64)\n"
        "step = m.make_fused_train_step(p, q, r, 1, 8, impl='pallas',"
        " device='cpu')\n"
        "for _ in range(2):\n"
        "    out, params = step(params, rng.integers(0, 11000, 16),"
        " np.arange(0, 17, 2), rng.normal(size=(1, 8, 64)), (0.01, 0.1))\n"
        "    assert out.shape == (1, 8, 64)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'"
        " or k.startswith('jax.') or k.startswith('fbtt_embedding_tpu.')"
        " or k == 'fbtt_embedding_tpu')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
