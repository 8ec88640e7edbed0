"""PyTorch port vs the JAX package: the weight-folded serve (CPU).

The port's ``make_folded_serving_fn(device="cpu")`` (flat pipeline, kernel
B1's plain version, float32 staging) against the JAX package's
(``interpret=True``, float32) on the same numpy-seeded cores and requests,
on ``tests/test_serving.py``'s cases:

- ``quantize_rows_int8`` and ``_dequant_gather`` bit for bit (zero rows,
  rounding ties);
- ``make_serving_fold``'s g0f, pair table and pass tables within 1e-6 on
  all six FOLD_CASES, and its int8 pair table within one step where the two
  einsums' float32 sums round a tie apart;
- the folded serve within rtol = atol = 1e-5 on all six FOLD_CASES, the
  ``bs`` override and a batch padded to a multiple of 8, with a populated
  cache, int8 (within 1e-2 x max|out| of the exact fold and of JAX's int8
  serve), ``refold_cache`` (a fresh fold's output bitwise; flat and
  fallback mode; a quantized fold frozen before the cache existed);
- the configuration fallback (``impl`` "xla" / "pallas"), its warning and
  the flat serve's ValueError on a fallback fold;
- the bucketed front-end at odd (B, nnz) against ``make_serving_fn`` on
  the exact shapes (T=1, T=2, weighted, wide key rows, the overflow
  ValueError) and against JAX's;
- ``freeze_for_serving`` against the port module's forward and JAX's
  module fold, both modules loaded with one state dict;
- a ``torch.save`` / ``torch.load`` round trip of an int8 fold;
- the serving walkthrough ``fbtt_embedding_tpu_torch.examples.
  serve_embedding --tiny`` with and without ``--quantize``.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fbtt_embedding_tpu as J
from fbtt_embedding_tpu import TTEmbeddingParams as JParams
from fbtt_embedding_tpu.models.tt_embedding import (
    make_bucketed_serving_fn as j_make_bucketed,
    make_folded_serving_fn as j_make_folded,
    refold_cache as j_refold_cache,
)
from fbtt_embedding_tpu.ops import lookup as jlookup
from fbtt_embedding_tpu.ops.pallas import tt_flat as jflat
import fbtt_embedding_tpu_torch as T
from fbtt_embedding_tpu_torch.ops import lookup as tlookup
from fbtt_embedding_tpu_torch.ops.kernels import tt_flat as tflat
from tests.utils import generate_sparse_feature, tt_test_shapes

TIGHT = dict(rtol=1e-5, atol=1e-5)

# tests/test_serving.py's FOLD_CASES: tt_ndim 3 (the pair table), weighted,
# two tables, odd ranks padded (the reference's own shapes), tt_ndim 2 and 4
FOLD_CASES = [
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=3),
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=3,
         weights=True),
    dict(p=[16, 16, 16], q=[4, 4, 4], ranks=[8, 8], b=8, L=2, T=2),
    dict(p=[7, 9, 11], q=[3, 4, 5], ranks=[13, 12], b=8, L=4),
    dict(p=[30, 40], q=[8, 8], ranks=[8], b=16, L=2),
    dict(p=[8, 9, 10, 11], q=[2, 2, 2, 2], ranks=[8, 8, 8], b=16, L=2),
]
HEAD = dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _params(cores):
    """The same cores (numpy) as the JAX package's params and the port's
    (``device="cpu"``)."""
    jp = JParams(tuple(jnp.asarray(c) for c in cores),
                 tuple(jnp.zeros((0,), jnp.float32) for _ in cores), None)
    tp = T.params_from_jax([np.asarray(c) for c in cores], device="cpu")
    return jp, tp


def _requests(rng, e, t, b, L, weights=False):
    nnz = t * b * L
    idx = rng.integers(0, e, size=nnz).astype(np.int32)
    offs = np.arange(0, nnz + 1, L, dtype=np.int32)
    w = rng.random(nnz).astype(np.float32) if weights else None
    return idx, offs, w


def _case(case, seed=7):
    p, q, ranks = case["p"], case["q"], case["ranks"]
    t = case.get("T", 1)
    rfull = [1] + list(ranks) + [1]
    cores = T.init_tt_cores(np.random.default_rng(seed), "uniform", t,
                            int(np.prod(p)), int(np.prod(q)), p, q, rfull)
    return p, q, rfull, t, cores


def _cached_jax_module(seed=2):
    """tests/test_serving.py's cached module: counted on one batch and
    populated; returns (module, indices, offsets, b)."""
    p, q, r, e, d = tt_test_shapes(3)
    emb = J.TTEmbeddingBag(
        num_embeddings=e, embedding_dim=d, tt_p_shapes=p, tt_q_shapes=q,
        tt_ranks=r, use_cache=True, cache_size=16, hashtbl_size=e,
        weight_dist="uniform", seed=seed)
    rng = np.random.default_rng(3)
    b = 8
    indices, offsets = generate_sparse_feature(rng, b, e, 4, 2)
    emb(indices, offsets)
    emb.cache_populate()
    return emb, indices, offsets, b


def _jax_module_params(emb):
    """The JAX module's params (cores and cache) in the port, on the CPU."""
    prm = emb.params
    return T.params_from_jax([np.asarray(c) for c in prm.tt_cores],
                             device="cpu", cache=prm.cache)


# ------------------------------------------------------------ int8 rows


def test_quantize_rows_int8_matches_jax():
    rng = np.random.default_rng(0)
    tbl = rng.standard_normal((40, 24)).astype(np.float32)
    tbl[3] = 0.0                                   # all-zero rows: scale 0
    tbl[-1] = 0.0
    tbl[5, :5] = [127.0, 0.5, 1.5, 2.5, -0.5]      # ties at scale 1
    tbl[5, 5:] = 0.0
    jq8, jscale = jflat.quantize_rows_int8(jnp.asarray(tbl))
    q8, scale = tflat.quantize_rows_int8(torch.as_tensor(tbl))
    assert q8.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(_np(q8), np.asarray(jq8))
    np.testing.assert_array_equal(_np(scale), np.asarray(jscale))
    assert _np(q8)[5, :5].tolist() == [127, 0, 2, 2, 0]  # half to even
    assert float(scale[3]) == 0.0 and float(scale[-1]) == 0.0
    rows = np.array([3, 5, 0, 39, 3, 17], np.int32)
    got = tflat._dequant_gather((q8, scale), torch.as_tensor(rows).long())
    want = jflat._dequant_gather((jq8, jscale), jnp.asarray(rows))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert not _np(got)[0].any() and not _np(got)[3].any()
    # within half a step of the row's scale
    err = np.abs(_np(q8).astype(np.float32) * _np(scale)[:, None] - tbl)
    assert (err <= 0.5 * _np(scale)[:, None] + 1e-7).all()


def _padded(p, q, rfull, t, b, cores):
    """Each package's cores padded by its own pad plan, and the widths the
    fold takes."""
    use_q, use_r = tuple(q), tuple(rfull)
    tc = [torch.as_tensor(np.asarray(c)) for c in cores]
    jc = [jnp.asarray(c) for c in cores]
    if not tflat.flat_available(p, q, rfull, t, b):
        pad = tlookup.flat_pad_plan(p, q, rfull, b)
        assert pad == jlookup.flat_pad_plan(p, q, rfull, b)
        tc = tlookup.pad_cores_for_flat(tc, p, q, rfull, pad)
        jc = jlookup.pad_cores_for_flat(jc, p, q, rfull, pad)
        use_q, use_r = tuple(q[:-1]) + (pad[1],), tuple(pad[0])
    return tc, jc, use_q, use_r


@pytest.mark.parametrize("case", FOLD_CASES)
def test_serving_fold_tables_match_jax(case):
    p, q, rfull, t, cores = _case(case)
    tc, jc, use_q, use_r = _padded(p, q, rfull, t, case["b"], cores)
    got = tflat.make_serving_fold(tc, p, use_q, use_r,
                                  compute_dtype=torch.float32)
    want = jflat.make_serving_fold(jc, p, use_q, use_r,
                                   compute_dtype=jnp.float32)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=1e-6,
                               atol=1e-6)
    if len(p) >= 3:
        assert got[1].shape == (t * p[0] * p[1] + 1,
                                use_q[0] * use_q[1] * use_r[2])
        np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]),
                                   rtol=1e-6, atol=1e-6)
        assert not _np(got[1])[-1].any()  # the sentinel row
    else:
        assert got[1] is None and want[1] is None
    assert len(got[2]) == len(want[2]) == len(p) - 1
    for a, w in zip(got[2], want[2]):
        np.testing.assert_allclose(_np(a), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)

    # int8: each package quantizes its own pair table. Their float32
    # products may differ in the last place, which moves an entry by one
    # step where it lands on a rounding tie: at most one in 10^4 entries
    # (0 on these cases when this test was written)
    gq = tflat.make_serving_fold(tc, p, use_q, use_r,
                                 compute_dtype=torch.float32,
                                 quantize="int8")
    wq = jflat.make_serving_fold(jc, p, use_q, use_r,
                                 compute_dtype=jnp.float32, quantize="int8")
    if len(p) < 3:
        assert gq[1] is None and wq[1] is None
        return
    d8 = np.abs(_np(gq[1][0]).astype(np.int32)
                - np.asarray(wq[1][0]).astype(np.int32))
    assert d8.max() <= 1
    assert (d8 > 0).sum() <= max(1, d8.size // 10_000), (d8 > 0).sum()
    np.testing.assert_allclose(_np(gq[1][1]), np.asarray(wq[1][1]),
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------------- the folded serve


@pytest.mark.parametrize("case", FOLD_CASES)
def test_folded_serve_matches_jax(case):
    p, q, rfull, t, cores = _case(case)
    b, L = case["b"], case["L"]
    jp, tp = _params(cores)
    idx, offs, w = _requests(np.random.default_rng(8), int(np.prod(p)), t,
                             b, L, case.get("weights", False))
    jfold, jserve = j_make_folded(p, q, rfull, num_tables=t, batch_size=b,
                                  probe_cache=False, interpret=True)
    want = np.asarray(jserve(jfold(jp), jnp.asarray(idx), jnp.asarray(offs),
                             None if w is None else jnp.asarray(w)))
    fold, serve = T.make_folded_serving_fn(p, q, rfull, num_tables=t,
                                           batch_size=b, probe_cache=False,
                                           device="cpu")
    fp = fold(tp)
    assert fp.setup is not None and fp.params is None
    if len(p) >= 3:
        assert fp.setup[1] is not None  # the pair table at any batch
    got = serve(fp, idx, offs, w)
    assert got.shape == want.shape == (t, b, int(np.prod(q)))
    np.testing.assert_allclose(_np(got), want, **TIGHT)
    # and the unfolded serve on the same request
    plain = T.make_serving_fn(p, q, rfull, t, b, probe_cache=False,
                              device="cpu")(tp, idx, offs, w)
    np.testing.assert_allclose(_np(got), _np(plain), **TIGHT)


@pytest.mark.parametrize("t,bs", [(1, 8), (1, 6), (1, 5), (2, 5)])
def test_folded_serve_bs_override(t, bs):
    """A per-call batch below the folded one; 6 and 5 (and T=2 x 5) leave
    T*bs off a multiple of 8: padded inside, sliced after."""
    p, q, ranks = HEAD["p"], HEAD["q"], HEAD["ranks"]
    rfull = [1] + ranks + [1]
    cores = T.init_tt_cores(np.random.default_rng(13), "uniform", t, 11000,
                            64, p, q, rfull)
    jp, tp = _params(cores)
    jfold, jserve = j_make_folded(p, q, rfull, num_tables=t, batch_size=16,
                                  probe_cache=False, interpret=True)
    fold, serve = T.make_folded_serving_fn(p, q, rfull, num_tables=t,
                                           batch_size=16, probe_cache=False,
                                           device="cpu")
    fp = fold(tp)
    idx, offs, _ = _requests(np.random.default_rng(bs), 11000, t, bs, 3)
    got = serve(fp, idx, offs, bs=bs)
    assert got.shape == (t, bs, 64)
    want = jserve(jfold(jp), jnp.asarray(idx), jnp.asarray(offs), bs=bs)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TIGHT)
    exact = T.make_serving_fn(p, q, rfull, t, bs, probe_cache=False,
                              device="cpu")(tp, idx, offs)
    np.testing.assert_allclose(_np(got), _np(exact), **TIGHT)


def test_folded_serving_with_cache():
    """tests/test_serving.py's cached case in both packages: the fold
    probes the populated cache (dead lookups in pair mode)."""
    emb, indices, offsets, b = _cached_jax_module()
    expect = np.asarray(emb(indices, offsets))
    assert emb.cache_hit_rate() > 0
    p, q, r = emb.tt_p_shapes, emb.tt_q_shapes, emb.tt_ranks
    idx, offs = indices.astype(np.int32), offsets.astype(np.int32)
    jfold, jserve = j_make_folded(p, q, r, num_tables=1, batch_size=b,
                                  probe_cache=True, interpret=True)
    want = np.asarray(jserve(jfold(emb.params), jnp.asarray(idx),
                             jnp.asarray(offs)))
    fold, serve = T.make_folded_serving_fn(p, q, r, num_tables=1,
                                           batch_size=b, probe_cache=True,
                                           device="cpu")
    fp = fold(_jax_module_params(emb))
    assert fp.setup is not None and fp.setup[1] is not None
    assert fp.cache is not None and fp.cache_scale is None
    got = serve(fp, idx, offs)
    np.testing.assert_allclose(_np(got), want, **TIGHT)
    np.testing.assert_allclose(_np(got)[0], expect, rtol=2e-4, atol=2e-4)


def test_fold_is_a_snapshot():
    """Training the cache's rows in place after the fold leaves it as it
    was: the fold holds copies."""
    emb, indices, offsets, b = _cached_jax_module()
    tp = _jax_module_params(emb)
    p, q, r = emb.tt_p_shapes, emb.tt_q_shapes, emb.tt_ranks
    fold, serve = T.make_folded_serving_fn(p, q, r, 1, b, device="cpu")
    fp = fold(tp)
    before = _np(serve(fp, indices, offsets)).copy()
    tp.cache.weight.add_(1.0)
    tp.tt_cores[2].mul_(2.0)
    np.testing.assert_array_equal(_np(serve(fp, indices, offsets)), before)
    ffold, fserve = T.make_folded_serving_fn(p, q, r, 1, b, impl="xla",
                                             device="cpu")
    fb = ffold(tp)
    first = _np(fserve(fb, indices, offsets)).copy()
    tp.tt_cores[1].mul_(3.0)
    np.testing.assert_array_equal(_np(fserve(fb, indices, offsets)), first)


# --------------------------------------------------------------- int8


def test_quantized_fold_close_to_exact_and_to_jax():
    p, q, ranks = HEAD["p"], HEAD["q"], HEAD["ranks"]
    rfull = [1] + ranks + [1]
    cores = T.init_tt_cores(np.random.default_rng(17), "uniform", 1, 11000,
                            64, p, q, rfull)
    jp, tp = _params(cores)
    b, L = 16, 3
    idx, offs, _ = _requests(np.random.default_rng(18), 11000, 1, b, L)
    fold, serve = T.make_folded_serving_fn(p, q, rfull, 1, b,
                                           probe_cache=False, device="cpu")
    exact = _np(serve(fold(tp), idx, offs))
    foldq, serveq = T.make_folded_serving_fn(p, q, rfull, 1, b,
                                             probe_cache=False,
                                             quantize="int8", device="cpu")
    fpq = foldq(tp)
    assert isinstance(fpq.setup[1], tuple)
    assert fpq.setup[1][0].dtype == torch.int8
    assert fpq.setup[1][1].dtype == torch.float32
    got = _np(serveq(fpq, idx, offs))
    scale = float(np.abs(exact).max())
    np.testing.assert_allclose(got, exact, rtol=0, atol=0.01 * scale + 1e-6)
    jfold, jserve = j_make_folded(p, q, rfull, num_tables=1, batch_size=b,
                                  probe_cache=False, interpret=True,
                                  quantize="int8")
    want = np.asarray(jserve(jfold(jp), jnp.asarray(idx), jnp.asarray(offs)))
    np.testing.assert_allclose(got, want, rtol=0, atol=0.01 * scale + 1e-6)


def test_quantized_folded_serving_with_cache_and_refold():
    """JAX's case: an int8 fold frozen before counting, refolded after
    populate; its cache rows are int8 with scales, within 1.5e-2 x
    max|out| of the module forward, and within 1e-2 of JAX's refolded
    int8 serve."""
    p, q, r, e, d = tt_test_shapes(3)
    emb = J.TTEmbeddingBag(
        num_embeddings=e, embedding_dim=d, tt_p_shapes=p, tt_q_shapes=q,
        tt_ranks=r, use_cache=True, cache_size=16, hashtbl_size=e,
        weight_dist="uniform", seed=2)
    rng = np.random.default_rng(3)
    b = 8
    indices, offsets = generate_sparse_feature(rng, b, e, 4, 2)
    idx, offs = indices.astype(np.int32), offsets.astype(np.int32)
    jfold, jserve = j_make_folded(p, q, r, num_tables=1, batch_size=b,
                                  probe_cache=True, interpret=True,
                                  quantize="int8")
    fold, serve = T.make_folded_serving_fn(p, q, r, 1, b, quantize="int8",
                                           device="cpu")
    jstale, stale = jfold(emb.params), fold(_jax_module_params(emb))
    emb(indices, offsets)
    emb.cache_populate()
    expect = np.asarray(emb(indices, offsets))
    assert emb.cache_hit_rate() > 0
    fp = T.refold_cache(stale, _jax_module_params(emb))
    assert fp.setup is stale.setup
    assert fp.cache.weight.dtype == torch.int8
    assert fp.cache_scale is not None
    got = _np(serve(fp, idx, offs))
    scale = float(np.abs(expect).max())
    np.testing.assert_allclose(got[0], expect, rtol=0,
                               atol=0.015 * scale + 1e-6)
    want = np.asarray(jserve(j_refold_cache(jstale, emb.params),
                             jnp.asarray(idx), jnp.asarray(offs)))
    np.testing.assert_allclose(got, want, rtol=0, atol=0.01 * scale + 1e-6)


def test_refold_quantizes_cache_populated_after_freeze():
    """A quantized fold made before the cache existed (``cache_scale``
    None): the ``(q8, scale)`` pair table marks it, and refold quantizes
    the new cache."""
    p, q, r, e, d = tt_test_shapes(3)
    rfull = [1] + r + [1]
    cores = T.init_tt_cores(np.random.default_rng(37), "uniform", 1, e, d,
                            p, q, rfull)
    _, tp = _params(cores)
    fold, _ = T.make_folded_serving_fn(p, q, rfull, 1, 8, quantize="int8",
                                       device="cpu")
    fp0 = fold(tp)
    assert fp0.cache is None and fp0.cache_scale is None
    emb, _, _, _ = _cached_jax_module()
    fp = T.refold_cache(fp0, _jax_module_params(emb))
    assert fp.cache.weight.dtype == torch.int8
    assert fp.cache_scale is not None
    q8, scale = tflat.quantize_rows_int8(
        torch.tensor(np.asarray(emb.params.cache.weight)))
    assert torch.equal(fp.cache.weight, q8) and torch.equal(fp.cache_scale,
                                                            scale)


# ---------------------------------------------------------- refold_cache


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_refold_cache_equals_a_fresh_fold(impl):
    """Folded before counting, refolded after populate: the same output as
    a fold of the populated params, bitwise, the tables kept (flat mode)
    or the params swapped (fallback mode); and JAX's refold's output."""
    p, q, r, e, d = tt_test_shapes(3)
    emb = T.TTEmbeddingBag(
        num_embeddings=e, embedding_dim=d, tt_p_shapes=p, tt_q_shapes=q,
        tt_ranks=r, use_cache=True, cache_size=16, hashtbl_size=e,
        weight_dist="uniform", seed=2, impl=impl, device="cpu")
    rng = np.random.default_rng(3)
    b = 8
    indices, offsets = generate_sparse_feature(rng, b, e, 4, 2)
    fold, serve = T.make_folded_serving_fn(p, q, r, 1, b, impl=impl,
                                           device="cpu")
    stale = fold(emb.params)
    emb(indices, offsets)
    emb.cache_populate()
    expect = _np(emb(indices, offsets))
    assert emb.cache_hit_rate() > 0
    fp = T.refold_cache(stale, emb.params)
    fresh = fold(emb.params)
    got = _np(serve(fp, indices, offsets))
    np.testing.assert_array_equal(got, _np(serve(fresh, indices, offsets)))
    np.testing.assert_allclose(got[0], expect, rtol=2e-4, atol=2e-4)
    if impl == "auto":
        assert fp.setup is stale.setup and fp.params is None
    else:
        assert fp.setup is None and fp.params is not None
    # the JAX package's refold on the same state
    jm = J.TTEmbeddingBag(
        num_embeddings=e, embedding_dim=d, tt_p_shapes=p, tt_q_shapes=q,
        tt_ranks=r, use_cache=True, cache_size=16, hashtbl_size=e,
        weight_dist="uniform", seed=2)
    jfold, jserve = j_make_folded(p, q, r, num_tables=1, batch_size=b,
                                  impl=impl, interpret=True)
    jstale = jfold(jm.params)
    jm(indices, offsets)
    jm.cache_populate()
    want = jserve(j_refold_cache(jstale, jm.params),
                  jnp.asarray(indices, jnp.int32),
                  jnp.asarray(offsets, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want), **TIGHT)


# ------------------------------------------------------------ fallback


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_fallback_fold_serves_like_make_serving_fn(impl, caplog):
    p, q, ranks = HEAD["p"], HEAD["q"], HEAD["ranks"]
    rfull = [1] + ranks + [1]
    cores = T.init_tt_cores(np.random.default_rng(5), "uniform", 1, 11000,
                            64, p, q, rfull)
    jp, tp = _params(cores)
    b = 8
    idx, offs, w = _requests(np.random.default_rng(6), 11000, 1, b, 3, True)
    fold, serve = T.make_folded_serving_fn(p, q, rfull, 1, b,
                                           probe_cache=False, impl=impl,
                                           device="cpu")
    fp = fold(tp)
    assert fp.setup is None and fp.params is not None
    got = _np(serve(fp, idx, offs, w))
    want = T.make_serving_fn(p, q, rfull, 1, b, probe_cache=False,
                             impl=impl, device="cpu")(tp, idx, offs, w)
    np.testing.assert_array_equal(got, _np(want))
    if impl == "xla":
        jfold, jserve = j_make_folded(p, q, rfull, num_tables=1,
                                      batch_size=b, probe_cache=False,
                                      impl="xla")
        jfp = jfold(jp)
        assert jfp.setup is None
        np.testing.assert_allclose(
            got, np.asarray(jserve(jfp, jnp.asarray(idx), jnp.asarray(offs),
                                   jnp.asarray(w))), **TIGHT)
    with caplog.at_level(logging.WARNING):
        qfold, _ = T.make_folded_serving_fn(p, q, rfull, 1, b, impl=impl,
                                            quantize="int8", device="cpu")
    assert "fallback fold" in caplog.text
    assert qfold(tp).setup is None


def test_flat_serve_rejects_a_fallback_fold_and_unknown_modes():
    p, q, ranks = HEAD["p"], HEAD["q"], HEAD["ranks"]
    rfull = [1] + ranks + [1]
    cores = T.init_tt_cores(np.random.default_rng(1), "uniform", 1, 11000,
                            64, p, q, rfull)
    _, tp = _params(cores)
    _, serve = T.make_folded_serving_fn(p, q, rfull, 1, 8,
                                        probe_cache=False, device="cpu")
    bad = T.FoldedServingParams(params=tp)
    with pytest.raises(ValueError, match="fallback-mode fold"):
        serve(bad, np.zeros(8, np.int32), np.arange(9, dtype=np.int32))
    with pytest.raises(ValueError, match="int8"):
        T.make_folded_serving_fn(p, q, rfull, 1, 8, quantize="fp4",
                                 device="cpu")
    with pytest.raises(ValueError, match="int8"):
        T.make_bucketed_serving_fn(p, q, rfull, 1, [8], [32],
                                   quantize="fp4", device="cpu")


# ---------------------------------------------------------- bucketed


@pytest.mark.parametrize("t,impl", [(1, "auto"), (2, "auto"), (1, "xla")])
def test_bucketed_serving_matches_exact_shapes(t, impl):
    p, q, ranks = HEAD["p"], HEAD["q"], HEAD["ranks"]
    rfull = [1] + ranks + [1]
    cores = T.init_tt_cores(np.random.default_rng(23), "uniform", t, 11000,
                            64, p, q, rfull)
    jp, tp = _params(cores)
    fold, serve = T.make_bucketed_serving_fn(
        p, q, rfull, num_tables=t, batch_buckets=[8, 16],
        nnz_buckets=[32, 96], probe_cache=False, impl=impl, device="cpu")
    fp = fold(tp)
    assert (fp.setup is None) == (impl == "xla")
    jfold, jserve = j_make_bucketed(
        p, q, rfull, num_tables=t, batch_buckets=[8, 16],
        nnz_buckets=[32, 96], probe_cache=False, interpret=True)
    jfp = jfold(jp)
    rng = np.random.default_rng(24)
    for b, L in [(5, 3), (8, 4), (11, 2)]:
        idx, offs, _ = _requests(rng, 11000, t, b, L)
        got = serve(fp, idx, offs)
        assert got.shape == (t, b, 64)
        exact = T.make_serving_fn(p, q, rfull, t, b, probe_cache=False,
                                  device="cpu")(tp, idx, offs)
        np.testing.assert_allclose(_np(got), _np(exact), **TIGHT)
        want = jserve(jfp, jnp.asarray(idx), jnp.asarray(offs))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TIGHT)


def test_bucketed_serving_weighted_wide_and_overflow():
    p, q, ranks = HEAD["p"], HEAD["q"], HEAD["ranks"]
    rfull = [1] + ranks + [1]
    cores = T.init_tt_cores(np.random.default_rng(29), "uniform", 1, 11000,
                            64, p, q, rfull)
    jp, tp = _params(cores)
    fold, serve = T.make_bucketed_serving_fn(
        p, q, rfull, num_tables=1, batch_buckets=[8], nnz_buckets=[32],
        probe_cache=False, device="cpu")
    fp = fold(tp)
    b = 6
    idx, offs, w = _requests(np.random.default_rng(30), 11000, 1, b, 4, True)
    exact = T.make_serving_fn(p, q, rfull, 1, b, probe_cache=False,
                              device="cpu")(tp, idx, offs, w)
    got = serve(fp, torch.as_tensor(idx), torch.as_tensor(offs),
                torch.as_tensor(w))
    np.testing.assert_allclose(_np(got), _np(exact), **TIGHT)
    jfold, jserve = j_make_bucketed(
        p, q, rfull, num_tables=1, batch_buckets=[8], nnz_buckets=[32],
        probe_cache=False, interpret=True)
    want = jserve(jfold(jp), jnp.asarray(idx), jnp.asarray(offs),
                  jnp.asarray(w))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TIGHT)
    # wide key rows: the pad rows' (hi, lo) = -1 and weight 0
    wide = serve(fp, T.wide_keyrows(idx.astype(np.int64), p), offs, w)
    np.testing.assert_allclose(_np(wide), _np(got), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="exceeds the largest"):
        serve(fp, np.zeros((40,), np.int32),
              np.arange(0, 41, 5, dtype=np.int32))
    with pytest.raises(ValueError, match="exceeds the largest"):
        serve(fp, np.zeros((20,), np.int32), np.arange(0, 21, 2,
                                                       dtype=np.int32))


# ------------------------------------------------------------ the module


@pytest.mark.parametrize("use_cache", [False, True])
def test_module_freeze_for_serving(use_cache):
    """The JAX module's state dict in both modules: the port's fold against
    its own forward and against the JAX module's fold (on the CPU that one
    takes its fallback mode: it passes no ``interpret``)."""
    p, q, r, e, d = tt_test_shapes(3)
    kw = dict(num_embeddings=e, embedding_dim=d, tt_p_shapes=p,
              tt_q_shapes=q, tt_ranks=r, use_cache=use_cache, cache_size=16,
              hashtbl_size=e, weight_dist="uniform", seed=9)
    jm = J.TTEmbeddingBag(**kw)
    rng = np.random.default_rng(11)
    b = 8
    indices, offsets = generate_sparse_feature(rng, b, e, 4, 2)
    if use_cache:
        jm(indices, offsets)
        jm.cache_populate()
    tm = T.TTEmbeddingBag(device="cpu", **kw)
    tm.load_state_dict({k: np.asarray(v) for k, v in
                        jm.state_dict().items()})
    tm.warmup = jm.warmup
    folded, serve = tm.freeze_for_serving(batch_size=b)
    assert folded.setup is not None and folded.setup[1] is not None
    assert (folded.cache is not None) == use_cache
    idx, offs = indices.astype(np.int32), offsets.astype(np.int32)
    got = _np(serve(folded, idx, offs))
    assert got.shape == (1, b, d)
    np.testing.assert_allclose(got[0], _np(tm(indices, offsets)), **TIGHT)
    jfolded, jserve = jm.freeze_for_serving(batch_size=b)
    want = jserve(jfolded, jnp.asarray(idx), jnp.asarray(offs))
    np.testing.assert_allclose(got, np.asarray(want), **TIGHT)
    qfolded, qserve = tm.freeze_for_serving(batch_size=b, quantize="int8")
    assert isinstance(qfolded.setup[1], tuple)
    scale = float(np.abs(got).max())
    np.testing.assert_allclose(_np(qserve(qfolded, idx, offs)), got, rtol=0,
                               atol=0.01 * scale + 1e-6)
    # probe_cache=False, or a module without a cache, folds no cache
    nfolded, _ = tm.freeze_for_serving(batch_size=b, probe_cache=False)
    assert nfolded.cache is None


def test_folded_params_torch_save_roundtrip(tmp_path):
    """An int8 fold saved and loaded serves identically (the JAX package's
    checkpoint round trip, until its checkpoint module is ported)."""
    p, q, r, e, d = tt_test_shapes(3)
    emb, indices, offsets, b = _cached_jax_module()
    fold, serve = T.make_folded_serving_fn(p, q, [1] + r + [1], 1, b,
                                           quantize="int8", device="cpu")
    fp = fold(_jax_module_params(emb))
    path = tmp_path / "folded.pt"
    torch.save(fp, path)
    fp2 = torch.load(path, weights_only=False)
    assert isinstance(fp2, T.FoldedServingParams)
    assert fp2.setup[1][0].dtype == torch.int8
    assert fp2.cache.weight.dtype == torch.int8
    np.testing.assert_array_equal(_np(serve(fp, indices, offsets)),
                                  _np(serve(fp2, indices, offsets)))


# ------------------------------------------------------ the walkthrough


@pytest.mark.parametrize("quantize", [False, True])
def test_serve_embedding_walkthrough_tiny(quantize):
    from fbtt_embedding_tpu_torch.examples import serve_embedding

    argv = ["--tiny", "--train-steps", "20", "--device", "cpu"]
    res = serve_embedding.main(argv + (["--quantize"] if quantize else []))
    assert res["served"] == 126
    assert res["max_rel_err"] < (0.06 if quantize else 5e-3)
