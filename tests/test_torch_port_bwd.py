"""PyTorch port vs the JAX package: the schedule of kernel B5's pivot pass (CPU).

- ``tt_bwd_pivot_plain``, the plain model of the pivot pass's schedule
  (core 1's span tiles added per chunk of its order, the end cores'
  per-lookup slabs summed per chunk of their own order and then per row,
  dead lookups never visited), against ``tt_bwd_plain`` and against the
  Pallas kernel ``tt_backward_pallas`` in interpret mode, rtol = atol =
  1e-5, on the tt_ndim-2 and -3 cases of ``test_torch_port_generic.py``,
  a Zipf batch with a hot row, and tt_ndim-4 cases (ranks 16: uniform,
  Zipf, weights, two tables, a live-count tail; ``z_1`` by lookup, core
  2's pass writing ``dz_1`` by lookup, then core 1's), at the kernel's
  segment and sub-chunk and at small ones that cut every span;
- the path query ``bwd_path``: the pivot path where the middle cores'
  slabs stage (at tt_ndim 4 both passes), the chain pass where they do not,
  neither where one lookup does not fit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbtt_embedding_tpu.ops.indexing import decompose_indices as j_decompose
from fbtt_embedding_tpu.ops.pallas.tt_kernel import tt_backward_pallas
from fbtt_embedding_tpu_torch import (
    decompose_indices,
    generic_available,
    init_tt_cores,
    tt_bwd_plain,
)
from fbtt_embedding_tpu_torch.ops.kernels import tt_bwd as tbwd
from fbtt_embedding_tpu_torch.ops.kernels import tt_kernel as tkernel

TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_N = 16  # as tests/test_pallas_kernel.py: small interpreted blocks

# the tt_ndim-2 and -3 cases of test_torch_port_generic.py, and a Zipf
# batch whose hot row owns many lookups of every core
CASES = [
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=2),
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=2, weights=True),
    dict(p=[16, 16, 16], q=[4, 4, 4], ranks=[8, 8], b=8, L=2, T=2,
         weights=True),
    dict(p=[30, 40], q=[8, 8], ranks=[8], b=16, L=2),
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=2, weights=True,
         live=21),
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=8, zipf=True),
    # tt_ndim 4 at ranks 16, which the pivot rule takes
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
# (segment, pivot chunk, sub-chunk): the kernel's sub-chunk, and small
# chunks and sub-chunks that cut every span
SCHEDULES = [(tkernel.SEG, None, None), (8, 5, 4)]


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


@pytest.mark.parametrize("schedule", SCHEDULES,
                         ids=[f"seg{s}-sub{c}-lc{lc}"
                              for s, c, lc in SCHEDULES])
@pytest.mark.parametrize("case", CASES)
def test_pivot_schedule_matches_plain_and_pallas(case, schedule):
    seg, sub, lc = schedule
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
    sched = tkernel.core_orders(idx, rowv, [T * p_ for p_ in p], seg)
    dout = torch.as_tensor(d_out).reshape(T * b, D)
    got = tbwd.tt_bwd_pivot_plain(gk, idx, rowv, wv, dout, *sched, seg=seg,
                                  lc=lc, sub=sub)
    want = tt_bwd_plain(gk, idx, rowv, wv, dout, *sched, seg=seg)
    for a, c in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == c.shape
        np.testing.assert_allclose(a.numpy(), c.numpy(), **TOL)
    jax_grads = tt_backward_pallas(
        [jnp.asarray(c) for c in cores], p, q, rfull, b,
        j_decompose(jnp.asarray(ids), p), jnp.asarray(rowidx),
        jnp.asarray(d_out), _j(tableidx), _j(w), block_n=BLOCK_N,
        interpret=True, live_count=_j(live))
    mod = tkernel.grads_to_module_layout(got, p, q, rfull, T)
    for a, c in zip(mod, jax_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **TOL)


def test_pivot_schedule_dead_lookups_add_nothing():
    """A batch whose lookups are all dead gets zero gradients, and the
    model never reads their (unwritten) slabs."""
    _dead_batch_grads_are_zero([20, 22, 25], [4, 4, 4], [8, 8])


def test_pivot_schedule_dead_lookups_add_nothing_tt_ndim_4():
    """The same at tt_ndim 4: no pass visits a dead lookup, and no z_1 or
    dz_1 row is read."""
    _dead_batch_grads_are_zero([5, 6, 7, 8], [2, 4, 2, 4], [16, 16, 16])


def _dead_batch_grads_are_zero(p, q, ranks):
    rfull, D, cores, ids, rowidx, _, w, _, d_out = make_case(
        p, q, ranks, 8, 2, weights=True)
    gk = tkernel._kernel_cores([torch.as_tensor(c) for c in cores], p, q,
                               rfull)
    parts = decompose_indices(torch.as_tensor(ids), p)
    idx, rowv, wv = tkernel.block_inputs(
        parts, _t(rowidx), None, _t(w), torch.tensor([0], dtype=torch.int32),
        p, 1, 8)
    assert bool((rowv < 0).all())
    sched = tkernel.core_orders(idx, rowv, p, 8)
    got = tbwd.tt_bwd_pivot_plain(gk, idx, rowv, wv,
                                  torch.as_tensor(d_out).reshape(8, D),
                                  *sched, seg=8, lc=4)
    assert all(bool((g == 0).all()) for g in got)


@pytest.mark.parametrize("q, ranks, want", [
    ([8, 8], [32], "pivot"),                  # tt_ndim 2
    ([4, 4, 4], [32, 32], "pivot"),           # the headline
    ([4, 4, 4], [64, 64], "pivot"),           # rank 64: 64 KB slab
    ([2, 4, 2], [16, 8], "pivot"),            # q_0 not a multiple of 4
    ([2, 4, 2], [12, 8], "chain"),            # r_1 not a multiple of 16
    ([4, 4, 4, 4], [32, 32, 32], "pivot"),    # tt_ndim 4: two passes
    ([4, 8, 4], [64, 64], "chain"),           # a 128 KB slab: not staged
    ([4, 4, 4], [30, 30], "chain"),           # ranks not multiples of 4
    ([4, 4, 4], [256, 256], None),            # one lookup does not fit
    ([2, 4, 2, 4], [32, 32, 32], "pivot"),    # the billion-row model
    ([2, 2, 2, 2], [16, 16, 16], "pivot"),    # tt_ndim 4, ranks 16
    ([2, 2, 2, 2], [8, 8, 8], "chain"),       # tt_ndim 4, ranks not of 16
    ([4, 4, 4, 4], [32, 32, 10], "chain"),    # the tail's r_3 not of 4
])
def test_bwd_path_choice(q, ranks, want):
    r = tkernel.full_ranks(q, ranks)
    path = tbwd.bwd_path(q, r)
    assert (path and path[0]) == want
    assert tbwd.bwd_chunk(q, r) == (path and path[1])
    p = [10] * len(q)
    assert generic_available(p, q, ranks, 1, 8) == (want is not None)
    if want == "pivot":
        lc = path[1]
        assert lc % 4 == 0 and 4 <= lc <= tbwd.PIVOT_CHUNK_MAX
        assert tbwd.pivot_chunk(q, r) == lc
    else:
        assert tbwd.pivot_chunk(q, r) == 0


def test_partial_floats():
    """Core 1's tiles by chunk of the pivot pass, the end cores' by chunks
    of END_CHUNK rows, one per segment on the chain pass."""
    rows, tiles = [5, 7, 9], [8, 64, 128]
    assert tbwd.core_chunks(False, 3, 64, 40) == [64, 64, 64]
    assert tbwd.core_chunks(True, 3, 64, 40) == [tbwd.END_CHUNK, 40,
                                                 tbwd.END_CHUNK]
    assert tbwd.partial_floats(False, 128, rows, tiles, 64, 40) == sum(
        (2 + n) * t for n, t in zip(rows, tiles))
    assert tbwd.partial_floats(True, 128, rows, tiles, 64, 40) == (
        (4 + 5) * 8 + (4 + 7) * 64 + (4 + 9) * 128)
    # tt_ndim 4: both middle cores take tiles by chunks of `sub` rows
    assert tbwd.core_chunks(True, 4, 64, 40) == [tbwd.END_CHUNK, 40, 40,
                                                 tbwd.END_CHUNK]


def test_pivot_sub_fills_one_wave():
    """The pivot pass spreads the lookups over two CTAs per SM (one where a
    warp holds more than four tiles of dG_1)."""
    r = [1, 32, 32, 1]

    def sub(nza, q, r):
        return tbwd.pivot_sub(nza, tbwd.bwd_path(q, r)[2], 132)

    assert sub(10240, [4, 4, 4], r) == 39
    assert sub(10240, [4, 4, 4], [1, 64, 64, 1]) == 78
    assert sub(10240, [8, 8], [1, 32, 1]) == 39
    assert sub(10240, [2, 4, 2, 4], [1, 32, 32, 32, 1]) == 39
    assert sub(64, [4, 4, 4], r) == 1
