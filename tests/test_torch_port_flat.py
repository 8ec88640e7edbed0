"""PyTorch port vs the JAX package: the flat sorted-run pipeline (CPU).

- plan arrays (span tables, permutations, pooling arrays) equal entry for
  entry at the same segment length, for plain, pair, dead-mask and
  live-count plans;
- the segment-transform kernel's plain version against the Pallas kernel
  ``_seg_transform_call`` in interpret mode, float32, rtol = atol = 1e-5,
  on dense slabs and, folded by ``mm``, on block-diagonal tables;
- the flat forward against JAX ``pooled_tt_lookup(impl="pallas_sorted",
  interpret=True)``, float32, rtol = atol = 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbtt_embedding_tpu.ops.lookup import pooled_tt_lookup as j_lookup
from fbtt_embedding_tpu.ops.pallas import tt_flat as jflat
from fbtt_embedding_tpu_torch.ops.kernels import tt_flat as tflat
from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import kernel_fold
from fbtt_embedding_tpu_torch.ops.kernels.seg_transform import (
    seg_transform,
    seg_transform_plain,
)
from fbtt_embedding_tpu_torch.ops.lookup import pooled_tt_lookup as t_lookup
from fbtt_embedding_tpu_torch.utils import profiling as tprof
from fbtt_embedding_tpu_torch.utils.init import init_tt_cores

# the flat-pipeline cases of the JAX suite (tests/test_flat_pipeline.py)
CASES = [
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=2),
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=3, weights=True),
    dict(p=[16, 16, 16], q=[4, 4, 4], ranks=[8, 8], b=8, L=2, T=2),
    dict(p=[7, 220, 11], q=[2, 4, 4], ranks=[8, 16], b=16, L=5),
    dict(p=[20, 22, 25], q=[2, 8, 4], ranks=[16, 8], b=8, L=7),
    dict(p=[30, 40], q=[8, 8], ranks=[8], b=16, L=2),
    dict(p=[30, 40], q=[8, 8], ranks=[16], b=8, L=3, weights=True),
    dict(p=[8, 9, 10, 11], q=[2, 2, 2, 2], ranks=[8, 8, 8], b=16, L=2),
    dict(p=[8, 9, 10, 11], q=[2, 4, 2, 2], ranks=[8, 8, 8], b=8, L=3, T=2),
    # odd ranks and dims, zero-padded to the width gates (reference shapes)
    dict(p=[7, 9, 11], q=[3, 4, 5], ranks=[13, 12], b=8, L=4),
]


def make_case(p, q, ranks, b, L, T=1, weights=False, seed=0, **_):
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
    return rfull, cores, indices, rowidx, tableidx, w


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _assert_plan_equal(jp, tp):
    for name in ("i0_s1", "alive1", "rowidx_last", "w_last", "pair_s2"):
        a, b = getattr(jp, name), getattr(tp, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=name)
    for name in ("runs", "first", "cnt", "perm_fwd", "perm_bwd"):
        ja, ta = getattr(jp, name), getattr(tp, name)
        assert len(ja) == len(ta), name
        for a, b in zip(ja, ta):
            assert (a is None) == (b is None), name
            if a is not None:
                assert b.dtype == torch.int32, name
                np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                              err_msg=name)


PLAN_CASES = [
    dict(case=0, mode="plain"), dict(case=1, mode="plain"),
    dict(case=2, mode="plain"), dict(case=5, mode="plain"),
    dict(case=8, mode="plain"), dict(case=0, mode="pair"),
    dict(case=2, mode="pair"), dict(case=7, mode="pair"),
    dict(case=0, mode="dead"), dict(case=1, mode="live"),
    dict(case=8, mode="dead"), dict(case=0, mode="pair_dead"),
]


@pytest.mark.parametrize("seg", [64, 128])
@pytest.mark.parametrize("pc", PLAN_CASES)
def test_build_plan_arrays_equal(pc, seg):
    case = CASES[pc["case"]]
    mode = pc["mode"]
    rfull, cores, idx, rowidx, tab, w = make_case(**case, seed=3)
    T, b = case.get("T", 1), case["b"]
    nnz = idx.shape[0]
    rng = np.random.default_rng(9)
    dead = rng.random(nnz) < 0.3 if "dead" in mode else None
    live = np.asarray([nnz // 2], np.int32) if mode == "live" else None
    pair = "pair" in mode
    jp, jn = jflat._build_plan(
        _j(idx), _j(rowidx), _j(tab), _j(w), _j(live), case["p"], T, b,
        dead_mask=_j(dead), seg=seg, pair=pair)
    tp, tn = tflat._build_plan(
        _t(idx), _t(rowidx), _t(tab), _t(w), _t(live), case["p"], T, b,
        dead_mask=_t(dead), seg=seg, pair=pair)
    assert jn == tn
    _assert_plan_equal(jp, tp)


def test_build_plan_parts_mode_equals_indices_mode():
    case = CASES[3]
    rfull, cores, idx, rowidx, tab, w = make_case(**case, seed=4)
    p = case["p"]
    strides = [p[1] * p[2], p[2], 1]
    parts = [torch.as_tensor((idx // s) % p_).to(torch.int32)
             for s, p_ in zip(strides, p)]
    a, _ = tflat._build_plan(_t(idx), _t(rowidx), None, None, None, p, 1,
                             case["b"])
    b, _ = tflat._build_plan(None, _t(rowidx), None, None, None, p, 1,
                             case["b"], idx_parts=parts)
    for x, y in zip(a.runs + a.perm_fwd, b.runs + b.perm_fwd):
        assert torch.equal(x, y)


def _span_inputs(rng, nza, blocks, bw_in, bw_out, p_rows, seg):
    keys = np.sort((rng.zipf(1.3, size=nza) - 1) % (p_rows + 1))
    runs, first, cnt = jflat._span_table(
        jnp.asarray(keys.astype(np.int32)), p_rows, nza // seg, seg=seg)
    x = rng.normal(size=(nza, blocks * bw_in)).astype(np.float32)
    table = rng.normal(
        size=((p_rows + jflat.SPAN_BLOCK) * bw_in, bw_out)).astype(np.float32)
    table[p_rows * bw_in:] = 0
    return keys, runs, first, cnt, x, table


# (blocks, bw_in, bw_out, p_rows, nza, seg): the headline passes cut down,
# tt_ndim-2 and -4 passes, a table with more rows than spans
KERNEL_SHAPES = [
    (4, 32, 128, 22, 512, 128),
    (4, 128, 16, 25, 512, 128),
    (8, 8, 8, 40, 256, 64),
    (2, 16, 64, 11, 384, 128),
    (4, 8, 8, 300, 256, 128),
]


@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_seg_transform_plain_matches_pallas_kernel(shape):
    blocks, bw_in, bw_out, p_rows, nza, seg = shape
    rng = np.random.default_rng(sum(shape))
    keys, runs, first, cnt, x, table = _span_inputs(
        rng, nza, blocks, bw_in, bw_out, p_rows, seg)
    truns, tfirst, tcnt = tflat._span_table(
        torch.as_tensor(keys.astype(np.int32)), p_rows, nza // seg, seg=seg)
    for a, b in ((runs, truns), (first, tfirst), (cnt, tcnt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = jflat._seg_transform_call(
        nza // seg, blocks, bw_in, bw_out, p_rows, "float32", "float32",
        True, sb=jflat.SPAN_BLOCK, trip="concat", seg=seg)(
        runs, first, cnt, jnp.asarray(x), jnp.asarray(table))
    kw = dict(blocks=blocks, bw_in=bw_in, bw_out=bw_out, p_rows=p_rows,
              seg=seg)
    got = seg_transform_plain(truns, tfirst, tcnt, torch.as_tensor(x),
                              torch.as_tensor(table), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    dead = int(truns[p_rows])
    assert not got[dead:].any()  # sentinel rows are exact zeros
    # the wrapper takes the plain version on the CPU and launches nothing
    before = tprof.counter("launches.seg_transform")
    got2 = seg_transform(truns, tfirst, tcnt, torch.as_tensor(x),
                         torch.as_tensor(table), **kw)
    assert tprof.counter("launches.seg_transform") == before
    assert torch.equal(got, got2)
    bf = seg_transform(truns, tfirst, tcnt, torch.as_tensor(x),
                       torch.as_tensor(table), out_dtype=torch.bfloat16, **kw)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), got.numpy(), rtol=8e-3,
                               atol=1e-5)


# (blocks, bw_in, bw_out, p_rows, nza, seg): block-diagonal passes cut
# down: the headline last core (q 4, ranks 32 -> 8) and a tt_ndim-4 pass 2
# (q 4, ranks 8)
BD_SHAPES = [(4, 128, 16, 25, 512, 128), (4, 32, 128, 9, 256, 64)]


@pytest.mark.parametrize("mm", [2, 4])
@pytest.mark.parametrize("shape", BD_SHAPES)
def test_seg_transform_plain_folds_block_diagonal_table(shape, mm):
    blocks, bw_in, bw_out, p_rows, nza, seg = shape
    rng = np.random.default_rng(sum(shape) + mm)
    keys, runs, first, cnt, x, _ = _span_inputs(
        rng, nza, blocks, bw_in, bw_out, p_rows, seg)
    g = rng.normal(size=(p_rows + jflat.SPAN_BLOCK, bw_in // mm,
                         bw_out // mm)).astype(np.float32)
    g[p_rows:] = 0
    table = tflat._bd_table(torch.as_tensor(g), mm, torch.float32).reshape(
        -1, bw_out)
    want = jflat._seg_transform_call(
        nza // seg, blocks, bw_in, bw_out, p_rows, "float32", "float32",
        True, sb=jflat.SPAN_BLOCK, trip="concat", seg=seg)(
        runs, first, cnt, jnp.asarray(x), jnp.asarray(table.numpy()))
    truns, tfirst, tcnt = tflat._span_table(
        torch.as_tensor(keys.astype(np.int32)), p_rows, nza // seg, seg=seg)
    kw = dict(blocks=blocks, bw_in=bw_in, bw_out=bw_out, p_rows=p_rows,
              seg=seg)
    args = (truns, tfirst, tcnt, torch.as_tensor(x), table)
    got = seg_transform_plain(*args, mm=mm, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    dead = int(truns[p_rows])
    assert not got[dead:].any()  # sentinel rows are exact zeros
    # the dense slab (mm = 1) and the wrapper on the CPU agree
    np.testing.assert_allclose(seg_transform_plain(*args, **kw).numpy(),
                               got.numpy(), rtol=1e-5, atol=1e-5)
    before = tprof.counter("launches.seg_transform")
    assert torch.equal(seg_transform(*args, mm=mm, **kw), got)
    assert tprof.counter("launches.seg_transform") == before


def test_seg_transform_wrapper_raises_on_a_fold_that_does_not_divide():
    rng = np.random.default_rng(1)
    keys, runs, first, cnt, x, table = _span_inputs(rng, 128, 2, 24, 16, 10,
                                                    64)
    args = [torch.as_tensor(np.array(a)) for a in (runs, first, cnt)]
    kw = dict(blocks=2, bw_in=24, bw_out=16, p_rows=10, seg=64)
    x, table = torch.as_tensor(x), torch.as_tensor(table)
    assert seg_transform(*args, x, table, mm=8, **kw).shape == (128, 32)
    for mm in (16, 3, 0):  # not a divisor of bw_in (24), of bw_out (16), < 1
        with pytest.raises(ValueError):
            seg_transform(*args, x, table, mm=mm, **kw)


def test_kernel_fold_takes_fold_1_for_seg_transform_when_refused():
    calls = []

    def path_fn(in_bf16, seg, blocks, bw_in, bw_out, d):  # the library's
        calls.append(d)  # query: only the dense slab stages (CUDA cores)
        return 0 if d == 1 else -1

    assert kernel_fold("seg_transform", path_fn, False, 64, 4, 128, 16,
                       4) == (1, 0)
    assert calls == [4, 2, 1]


def test_seg_transform_wrapper_checks_inputs():
    rng = np.random.default_rng(0)
    keys, runs, first, cnt, x, table = _span_inputs(rng, 128, 2, 8, 8, 10, 64)
    args = [torch.as_tensor(np.array(a)) for a in (runs, first, cnt)]
    kw = dict(blocks=2, bw_in=8, bw_out=8, p_rows=10, seg=64)
    with pytest.raises(ValueError):  # wrong x width
        seg_transform(*args, torch.as_tensor(x[:, :8]),
                      torch.as_tensor(table), **kw)
    with pytest.raises(ValueError):  # mixed dtypes
        seg_transform(*args, torch.as_tensor(x).double(),
                      torch.as_tensor(table), **kw)
    with pytest.raises(ValueError):  # int64 span tables
        seg_transform(args[0].long(), *args[1:], torch.as_tensor(x),
                      torch.as_tensor(table), **kw)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):  # neither cpu nor cuda: no fallback
        seg_transform(*meta, torch.as_tensor(x).to("meta"),
                      torch.as_tensor(table).to("meta"), **kw)


@pytest.mark.parametrize("case", CASES)
def test_flat_forward_matches_jax_interpret(case):
    rfull, cores, idx, rowidx, tab, w = make_case(**case)
    p, q, T, b = case["p"], case["q"], case.get("T", 1), case["b"]
    want = j_lookup(tuple(jnp.asarray(c) for c in cores), p, q, rfull, b,
                    _j(idx), _j(rowidx), _j(tab), weights=_j(w),
                    impl="pallas_sorted", interpret=True)
    got = t_lookup([torch.as_tensor(c) for c in cores], p, q, rfull, b,
                   _t(idx), _t(rowidx), _t(tab), weights=_t(w),
                   impl="pallas_sorted")
    assert got.dtype == torch.float32 and got.shape == (T, b, np.prod(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    plain = t_lookup([torch.as_tensor(c) for c in cores], p, q, rfull, b,
                     _t(idx), _t(rowidx), _t(tab), weights=_t(w), impl="xla")
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["pair", "dead", "live", "pair_dead"])
def test_flat_lookup_forward_plans_match_jax(mode):
    case = CASES[1]
    rfull, cores, idx, rowidx, tab, w = make_case(**case, seed=6)
    p, q, b = case["p"], case["q"], case["b"]
    nnz = idx.shape[0]
    dead = (np.random.default_rng(2).random(nnz) < 0.4
            if "dead" in mode else None)
    live = np.asarray([nnz // 3], np.int32) if mode == "live" else None
    pair = "pair" in mode
    seg = 64
    jp, nza = jflat._build_plan(_j(idx), _j(rowidx), None, _j(w), _j(live),
                                p, 1, b, dead_mask=_j(dead), seg=seg,
                                pair=pair)
    want, _ = jflat.flat_lookup_forward(
        tuple(jnp.asarray(c) for c in cores), p, q, rfull, b, jp, nza,
        compute_dtype=jnp.float32, interpret=True, seg=seg)
    tp, _ = tflat._build_plan(_t(idx), _t(rowidx), None, _t(w), _t(live),
                              p, 1, b, dead_mask=_t(dead), seg=seg,
                              pair=pair)
    got, stages = tflat.flat_lookup_forward(
        [torch.as_tensor(c) for c in cores], p, q, rfull, b, tp, nza,
        compute_dtype=torch.float32, seg=seg)
    assert (stages[0] is None) == pair
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_pair_gate_matches_jax_at_headline_shape():
    p, q, r = [200, 220, 250], [4, 4, 4], [1, 32, 32, 1]
    for nza in (10240, 16384, 20480):
        for itemsize in (2, 4):
            assert tflat._pair_gate(nza, 1, p, q, r, itemsize) == \
                jflat._pair_gate(nza, 1, p, q, r, itemsize)
    assert tflat._bd_widths(q, r) == jflat._bd_widths(q, r)
    assert tflat.flat_available(p, q, r, 1, 512)
