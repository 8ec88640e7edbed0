"""PyTorch port vs the JAX package: the schedule of kernel B4's pivot pass (CPU).

- ``tt_fwd_pivot_plain``, the plain model of the pivot pass's schedule
  (the live rows of core 1's sorted order cut into even shares, each
  share's rows in groups of pieces of a few spans, each piece through its
  span's slab, each lookup's weighted row to a scratch row, then each
  bag's rows added in bag order; dead lookups never visited), against
  ``tt_fwd_plain`` and against the Pallas kernel ``tt_forward_pallas`` in
  interpret mode, rtol = atol = 1e-5, on the tt_ndim-2 and -3 cases of
  ``test_torch_port_generic.py``, a Zipf batch with a hot row, and
  tt_ndim-4 cases (ranks 16: uniform, Zipf, weights, two tables, a
  live-count tail; the head pass's ``z_1`` by lookup, then the tail pass
  over core 2's order), at the kernel's groups and at small groups and
  shares that cut every span;
- the path query ``fwd_path``: the pivot path where the middle cores'
  slabs stage (at tt_ndim 4 both passes), the chain pass where they do
  not, neither where one lookup does not fit;
- core 1's sorted order (``core1_order``, the one-core ``core_order``)
  against ``core_orders``' row for core 1, and the backward taking the
  forward's: the same gradients, and the ``impl="pallas"`` step sorting
  once per core and once by bag;
- the sorts' keys in the narrowest type (``key_dtype``) against stable
  sorts on the full keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbtt_embedding_tpu.ops.indexing import decompose_indices as j_decompose
from fbtt_embedding_tpu.ops.pallas.tt_kernel import tt_forward_pallas
from fbtt_embedding_tpu_torch import (
    decompose_indices,
    generic_available,
    init_tt_cores,
    make_fused_train_step,
    params_from_jax,
    tt_backward_kernel,
    tt_forward_kernel,
    tt_fwd_pivot_plain,
    tt_fwd_plain,
)
from fbtt_embedding_tpu_torch.ops.kernels import tt_fwd as tfwd
from fbtt_embedding_tpu_torch.ops.kernels import tt_kernel as tkernel

TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_N = 16  # as tests/test_pallas_kernel.py: small interpreted blocks

# the tt_ndim-2 and -3 cases of test_torch_port_generic.py, and a Zipf
# batch whose hot row owns many lookups of core 1
CASES = [
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=2),
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=2, weights=True),
    dict(p=[16, 16, 16], q=[4, 4, 4], ranks=[8, 8], b=8, L=2, T=2,
         weights=True),
    dict(p=[30, 40], q=[8, 8], ranks=[8], b=16, L=2),
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=2, weights=True,
         live=21),
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=8, zipf=True),
]
# tt_ndim 4 at ranks 16 (B5's pivot rule takes them too)
CASES4 = [
    dict(p=[5, 6, 7, 8], q=[2, 4, 2, 4], ranks=[16, 16, 16], b=16, L=3),
    dict(p=[5, 6, 7, 8], q=[2, 4, 2, 4], ranks=[16, 16, 16], b=16, L=8,
         zipf=True),
    dict(p=[8, 9, 10, 11], q=[2, 2, 2, 2], ranks=[16, 16, 16], b=8, L=3,
         weights=True),
    dict(p=[4, 5, 6, 7], q=[2, 2, 2, 2], ranks=[16, 16, 16], b=8, L=2, T=2,
         weights=True),
    dict(p=[5, 6, 7, 8], q=[2, 4, 2, 4], ranks=[16, 16, 16], b=16, L=3,
         weights=True, live=29),
]
CASES += CASES4
# (group, rows per CTA, slabs): the kernel's, and small groups and shares
# that cut every span, one span a group
SCHEDULES = [(None, None, None), (3, 5, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def make_case(p, q, ranks, b, L, T=1, weights=False, live=None, zipf=False,
              seed=0):
    """numpy inputs; with ``live`` the first ``live`` lookups are live and
    the tail has weight 0, with ``zipf`` the ids are Zipf(1.05)."""
    rfull = [1] + list(ranks) + [1]
    E, D = int(np.prod(p)), int(np.prod(q))
    nnz = T * b * L
    rng = np.random.default_rng(seed)
    cores = init_tt_cores(rng, "uniform", T, E, D, p, q, rfull)
    ids = ((rng.zipf(1.05, size=nnz) - 1) % E if zipf
           else rng.integers(0, E, size=nnz)).astype(np.int32)
    rowidx = (np.arange(nnz) % b).astype(np.int32)
    tableidx = ((np.arange(nnz) // (nnz // T)).astype(np.int32)
                if T > 1 else None)
    w = rng.random(nnz).astype(np.float32) if weights else None
    live_count = None
    if live is not None:
        w[live:] = 0.0
        live_count = np.array([live], np.int32)
    d_out = rng.normal(size=(T, b, D)).astype(np.float32)
    return rfull, D, cores, ids, rowidx, tableidx, w, live_count, d_out


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _kernel_args(case):
    """(p, q, rfull, T, b, D, numpy case, the kernels' arguments)."""
    case = dict(case)
    p, q, ranks = case.pop("p"), case.pop("q"), case.pop("ranks")
    b = case["b"]
    rfull, D, cores, ids, rowidx, tableidx, w, live, d_out = make_case(
        p, q, ranks, **case)
    T = cores[0].shape[0]
    gk = tkernel._kernel_cores([torch.as_tensor(c) for c in cores], p, q,
                               rfull)
    parts = decompose_indices(torch.as_tensor(ids), p)
    idx, rowv, wv = tkernel.block_inputs(parts, _t(rowidx), _t(tableidx),
                                         _t(w), _t(live), p, T, b)
    order, starts = tkernel.bag_order(rowv, T * b)
    raw = (cores, ids, rowidx, tableidx, w, live, d_out)
    return p, q, rfull, T, b, D, raw, (gk, idx, rowv, wv, order, starts)


@pytest.mark.parametrize("schedule", SCHEDULES,
                         ids=[f"lc{lc}-sub{sub}-slabs{sl}"
                              for lc, sub, sl in SCHEDULES])
@pytest.mark.parametrize("case", CASES)
def test_pivot_schedule_matches_plain_and_pallas(case, schedule):
    lc, sub, slabs = schedule
    p, q, rfull, T, b, D, raw, args = _kernel_args(case)
    cores, ids, rowidx, tableidx, w, live, _ = raw
    gk, idx, rowv = args[:3]
    core1 = tkernel.core1_order(idx, rowv, [T * p_ for p_ in p])
    got = tt_fwd_pivot_plain(*args, core1=core1, lc=lc, sub=sub,
                             slabs=slabs)
    assert got.dtype == torch.float32 and got.shape == (T * b, D)
    np.testing.assert_allclose(got.numpy(), tt_fwd_plain(*args).numpy(),
                               **TOL)
    want = tt_forward_pallas(
        [jnp.asarray(c) for c in cores], p, q, rfull, b,
        j_decompose(jnp.asarray(ids), p), jnp.asarray(rowidx), _j(tableidx),
        _j(w), block_n=BLOCK_N, interpret=True, live_count=_j(live))
    np.testing.assert_allclose(got.reshape(T, b, D).numpy(), np.asarray(want),
                               **TOL)
    # the model builds core 1's order itself where it is not given
    assert torch.equal(
        tt_fwd_pivot_plain(*args, lc=lc, sub=sub, slabs=slabs), got)


def test_pivot_schedule_dead_lookups_add_nothing():
    """A batch whose lookups are all dead pools exact zeros, and the model
    never computes or reads their rows."""
    p, q, rfull, T, b, D, raw, args = _kernel_args(
        dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=8, L=2,
             weights=True, live=0))
    rowv = args[2]
    assert bool((rowv < 0).all())
    got = tt_fwd_pivot_plain(*args, lc=4)
    assert got.shape == (b, D) and bool((got == 0).all())


def test_pivot_schedule_rejects_tt_ndim_4():
    """The schedule rejects what chain_dims rejects: tt_ndim 4 runs its two
    passes and matches the plain forward; tt_ndim 5 raises ValueError."""
    p, q, rfull, T, b, D, raw, args = _kernel_args(
        dict(p=[8, 9, 10, 11], q=[2, 2, 2, 2], ranks=[8, 8, 8], b=16, L=2))
    np.testing.assert_allclose(tt_fwd_pivot_plain(*args).numpy(),
                               tt_fwd_plain(*args).numpy(), **TOL)
    gk, idx = args[0], args[1]
    with pytest.raises(ValueError, match="tt_ndim 2-4"):
        tt_fwd_pivot_plain(list(gk) + [gk[-1]], torch.cat([idx, idx[:1]]),
                           *args[2:])


def test_pivot_schedule_dead_lookups_add_nothing_tt_ndim_4():
    """At tt_ndim 4 a batch of dead lookups pools exact zeros: neither pass
    visits them, and no z_1 row is read."""
    p, q, rfull, T, b, D, raw, args = _kernel_args(
        dict(p=[5, 6, 7, 8], q=[2, 4, 2, 4], ranks=[16, 16, 16], b=8, L=2,
             weights=True, live=0))
    assert bool((args[2] < 0).all())
    got = tt_fwd_pivot_plain(*args, lc=4)
    assert got.shape == (b, D) and bool((got == 0).all())


@pytest.mark.parametrize("q, ranks, want", [
    ([8, 8], [32], "pivot"),                  # tt_ndim 2
    ([4, 4], [16], "pivot"),                  # tt_ndim 2, 4 columns (padded)
    ([4, 4, 4], [32, 32], "pivot"),           # the headline
    ([4, 4, 4], [64, 64], "pivot"),           # rank 64: 64 KB slab
    ([2, 4, 2], [8, 8], "pivot"),             # q_0 not a multiple of 4
    ([4, 4, 4], [12, 8], "chain"),            # r_1 not a multiple of 8
    ([4, 3, 4], [8, 5], "chain"),             # q_1 r_2 not a multiple of 4
    ([4, 4, 4, 4], [32, 32, 32], "pivot"),    # tt_ndim 4: two passes
    ([4, 8, 4], [128, 128], "chain"),         # a 514 KB slab: not staged
    ([256, 256], [64], None),                 # one lookup does not fit
    ([2, 4, 2, 4], [32, 32, 32], "pivot"),    # the billion-row model
    ([2, 2, 2, 2], [8, 8, 8], "pivot"),       # tt_ndim 4, ranks 8
    ([4, 4, 4, 4], [12, 8, 8], "chain"),      # the head's r_1 not of 8
    ([4, 4, 3, 3], [8, 8, 5], "chain"),       # the tail's q_2 r_3 not of 4
])
def test_fwd_path_choice(q, ranks, want):
    r = tkernel.full_ranks(q, ranks)
    path = tfwd.fwd_path(q, r)
    assert (path and path[0]) == want
    assert tfwd.fwd_chunk(q, r) == (path and path[1])
    if want is None:
        assert not generic_available([10] * len(q), q, ranks, 1, 8)
    if want == "pivot":
        lc, per_sm = path[1:]
        assert lc % 4 == 0 and 4 <= lc <= tfwd.FWD_CHUNK_MAX
        assert tfwd.fwd_pivot_chunk(q, r) == lc
        assert per_sm == tfwd.fwd_pivot_ctas(q, r) == (3 if len(q) == 2
                                                        else 2)
    else:
        assert tfwd.fwd_pivot_chunk(q, r) == 0


def test_fwd_pivot_groups_shrink_with_the_slab():
    """The largest group within the preferred shared memory and its slabs:
    16 lookups from 2 spans at the headline, from 8 of the small tt_ndim-2
    slabs, and 4 lookups of one span where the rank-64 slab leaves less
    room."""
    for q, r, lc, slabs in (([4, 4, 4], [1, 32, 32, 1], 16, 2),
                            ([8, 8], [1, 32, 1], 16, 8),
                            ([4, 4, 4], [1, 64, 64, 1], 4, 1)):
        assert tfwd.fwd_pivot_chunk(q, r) == lc
        assert tfwd.fwd_pivot_slabs(q, r) == slabs


def test_core_order_matches_core_orders():
    """The factored one-core order is core_orders' row for that core, its
    segment spans those of the row's runs alone, and core_orders takes a
    given core-1 order in place of its sort."""
    rng = np.random.default_rng(3)
    rows = [7, 5, 9]
    idx = torch.as_tensor(np.stack([rng.integers(0, r, 150) for r in rows])
                          .astype(np.int32))
    rowv = torch.as_tensor(np.where(rng.random(150) < 0.2, -1, 0)
                           .astype(np.int32))
    stacked = tkernel.core_orders(idx, rowv, rows, seg=64)
    for t in range(3):
        order, runs = tkernel.core_order(idx[t], rowv, rows[t],
                                         max(rows) + 2, 64)
        first, cnt = tkernel.segment_spans(runs, order.shape[0] // 64, 64)
        assert all(torch.equal(a, s[t]) for a, s in
                   zip((order, runs, first, cnt), stacked))
    core1 = tkernel.core1_order(idx, rowv, rows, 64)
    given = tkernel.core_orders(idx, rowv, rows, seg=64, core1=core1)
    assert all(torch.equal(a, s) for a, s in zip(given, stacked))
    # the live lookups lead the order, in stable order of their rows
    order, runs = core1
    live = int((rowv >= 0).sum())
    assert int(runs[rows[1]]) == live
    assert sorted(order[:live].tolist()) == torch.nonzero(
        rowv >= 0).flatten().tolist()


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[4], CASES4[2]])
def test_backward_takes_the_forward_core1(case):
    """Forward and backward on lookups prepared once, with core 1's order
    built once for both, give what tt_forward_kernel and
    tt_backward_kernel give on the raw lookups, sorting core 1 themselves."""
    p, q, rfull, T, b, D, raw, _ = _kernel_args(case)
    cores, ids, rowidx, tableidx, w, live, d_out = raw
    tc = [torch.as_tensor(c) for c in cores]
    lookups = (decompose_indices(torch.as_tensor(ids), p), _t(rowidx),
               _t(tableidx), _t(w), _t(live))
    parts, rows_, tables, wts, lc_ = lookups
    prepared = tkernel.block_inputs(parts, rows_, tables, wts, lc_, p, T, b)
    core1 = tkernel.core1_order(*prepared[:2], [T * p_ for p_ in p])
    out = tkernel.forward_lookups(tc, p, q, rfull, b, prepared, core1)
    assert torch.equal(out, tt_forward_kernel(tc, p, q, rfull, b, *lookups))
    want = tt_backward_kernel(tc, p, q, rfull, b, parts, rows_,
                              torch.as_tensor(d_out), tables, wts, lc_)
    got = tkernel.backward_lookups(tc, p, q, rfull, b, prepared,
                                   torch.as_tensor(d_out), core1)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


@pytest.mark.parametrize("q, ranks, sorts", [
    ([4, 4, 4], [8, 8], 4),   # by bag, then cores 0, 1, 2
    ([8, 8], [8], 3),         # by bag, then cores 0, 1
    ([2, 4, 2, 4], [16, 16, 16], 5),  # by bag, then cores 0-3 (1, 2 shared)
])
def test_pallas_step_sorts_once_per_core(q, ranks, sorts, monkeypatch):
    """The impl="pallas" step's backward takes the forward's pivot orders
    (core 1's; at tt_ndim 4 cores 1 and 2): one stable sort by bag and one
    per core."""
    p = [20, 22, 25, 9][:len(q)]
    rfull = [1] + ranks + [1]
    E, D, b, L = int(np.prod(p)), int(np.prod(q)), 8, 3
    rng = np.random.default_rng(5)
    cores = init_tt_cores(rng, "uniform", 1, E, D, p, q, rfull)
    params = params_from_jax(cores, device="cpu")
    step = make_fused_train_step(p, q, rfull, 1, b, impl="pallas",
                                 device="cpu")
    calls = []
    real_sort = torch.sort

    def counting_sort(*a, **k):
        calls.append(k.get("stable"))
        return real_sort(*a, **k)

    monkeypatch.setattr(torch, "sort", counting_sort)
    step(params, rng.integers(0, E, b * L), np.arange(0, b * L + 1, L),
         rng.normal(size=(1, b, D)).astype(np.float32), (0.01, 0.1))
    assert calls == [True] * sorts


@pytest.mark.parametrize("rows_t", [5, 254, 300, 40000])
def test_core_and_bag_order_keys_in_a_narrow_type(rows_t):
    """The sorts take their keys in the narrowest type that holds them
    (uint8, int16, int32); the orders and span starts are those of a
    stable sort on the full keys, on each side of the types' limits."""
    rng = np.random.default_rng(rows_t)
    n = 300
    key = rng.integers(0, rows_t, n).astype(np.int32)
    rowv = np.where(rng.random(n) < 0.2, -1, rng.integers(0, rows_t, n))
    full = np.where(rowv >= 0, key, rows_t)
    full = np.concatenate([full, np.full((-n) % 64, rows_t)])
    order, runs = tkernel.core_order(torch.as_tensor(key),
                                     torch.as_tensor(rowv.astype(np.int32)),
                                     rows_t)
    want = np.argsort(full, kind="stable")
    assert order.tolist() == want.tolist()
    assert runs.tolist() == np.searchsorted(
        full[want], np.arange(rows_t + 2)).tolist()
    border, starts = tkernel.bag_order(
        torch.as_tensor(rowv.astype(np.int32)), rows_t)
    bkey = np.where(rowv >= 0, rowv, rows_t)
    bwant = np.argsort(bkey, kind="stable")
    assert border.tolist() == bwant.tolist()
    assert starts.tolist() == np.searchsorted(
        bkey[bwant], np.arange(rows_t + 1)).tolist()
