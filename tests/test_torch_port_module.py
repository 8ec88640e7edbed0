"""PyTorch port vs the JAX package: the modules (CPU).

``TableBatchedTTEmbeddingBag`` / ``TTEmbeddingBag`` of
``fbtt_embedding_tpu_torch`` (``torch.nn.Module``, ``device="cpu"``: every
kernel runs its plain version) against the JAX package's modules on the same
numpy-seeded inputs, on the cases of ``tests/test_table_batched.py``,
``test_forward.py``, ``test_backward.py``, ``test_weighted.py``,
``test_functional_api.py`` and ``test_edge_cases.py``:

- the constructor's cores bit for bit for each ``weight_dist``, the
  optimizer state and the cache's default sizes;
- forward within rtol 1e-5 (tt_ndim 2-4, T=2, empty bags, weights, a table
  past int32 rows);
- three SGD and three Adagrad ``backward`` steps within rtol 1e-4 / atol
  1e-5, dense gradients and ``d_cache_weight``;
- the cached module after ``cache_populate``: counts, keys and slots exact,
  the cache rows' update within 1e-6 x max|update| (SGD, ``EXACT_ADAGRAD``,
  row-wise; flat, ``impl="pallas"`` and ``impl="xla"`` paths; direct and
  hashed tables), ``cache_count_interval`` and the ``warmup`` override;
- ``tt_embedding_forward`` with ``cache_locations`` and its gradients;
- ``state_dict`` from JAX (numpy) into ``load_state_dict``, and the
  truncated-state KeyError;
- the backward-before-forward assertion, determinism, the options once
  not ported (native semantics, a cached table past int32,
  ``freeze_for_serving``: each now builds), and that ``backward`` takes the gradient from the
  forward's kernel graph (``FlatLookup``, ``GenericLookup``);
- ``tests/test_property.py``'s hypothesis ranges (forward, an SGD step,
  several tables), the port's module against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import fbtt_embedding_tpu as J
from fbtt_embedding_tpu.models.tt_embedding import (
    TTEmbeddingParams as JParams,
    tt_embedding_forward as j_tt_embedding_forward,
)
from fbtt_embedding_tpu.ops import cache as jcache
from fbtt_embedding_tpu.ops.indexing import rowidx_from_offsets as j_rowidx
import fbtt_embedding_tpu_torch as T
from fbtt_embedding_tpu_torch.ops import lookup as tlookup
from fbtt_embedding_tpu_torch.ops.cache import CacheState
from tests.utils import generate_sparse_feature, tt_test_shapes

TIGHT = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread keeps this module from crowding
    the other test workers' cores, and is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pair(nd=3, num_tables=1, optimizer="sgd", impl="auto", **kw):
    """The JAX module and the port's (``device="cpu"``) on the same
    arguments; ``tt_test_shapes(nd)`` unless ``kw`` gives shapes."""
    p, q, r, e, d = tt_test_shapes(nd)
    args = dict(num_embeddings=e, embedding_dim=d, tt_p_shapes=p,
                tt_q_shapes=q, tt_ranks=r, weight_dist="uniform",
                use_cache=False)
    args.update(kw)
    jopt, topt = J.OptimType(optimizer), T.OptimType(optimizer)
    if num_tables == 1:
        jm = J.TTEmbeddingBag(optimizer=jopt, **args)
        tm = T.TTEmbeddingBag(optimizer=topt, impl=impl, device="cpu",
                              **args)
    else:
        jm = J.TableBatchedTTEmbeddingBag(num_tables, optimizer=jopt, **args)
        tm = T.TableBatchedTTEmbeddingBag(num_tables, optimizer=topt,
                                          impl=impl, device="cpu", **args)
    return jm, tm


def fixed_bags(rng, b, e, pool, num_tables=1, zipf=False):
    """``b`` bags (per table) of ``pool`` ids each: one shape per call, so
    the JAX module compiles once."""
    n = num_tables * b * pool
    idx = ((rng.zipf(1.3, size=n) - 1) % e) if zipf else rng.integers(
        0, e, size=n)
    return idx.astype(np.int64), np.arange(0, n + 1, pool, dtype=np.int64)


def assert_cores(jm, tm, tol=STEP):
    for a, b in zip(jm.tt_cores, tm.tt_cores):
        np.testing.assert_allclose(_np(b), np.asarray(a), **tol)


# ------------------------------------------------------------ constructor


@pytest.mark.parametrize("weight_dist", ["uniform", "naive-uniform",
                                         "normal", "approx-normal",
                                         "approx-uniform"])
def test_constructor_cores_bitwise(weight_dist):
    jm, tm = pair(3, weight_dist=weight_dist, seed=5)
    assert isinstance(tm, torch.nn.Module)
    assert isinstance(tm.tt_cores, torch.nn.ParameterList)
    for a, b in zip(jm.tt_cores, tm.tt_cores):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    assert tm.tt_p_shapes == jm.tt_p_shapes
    assert tm.tt_q_shapes == jm.tt_q_shapes
    assert tm.tt_ranks == jm.tt_ranks


@pytest.mark.parametrize("optimizer", ["sgd", "exact_adagrad", "adam"])
def test_constructor_state_and_cache_defaults(optimizer):
    """Suggested shapes, optimizer state, the cache's default sizes
    (0.1 E rows, an E-row table) and its state kind by optimizer; the state
    dict has the JAX module's names, shapes and dtypes."""
    kw = dict(num_embeddings=1000, embedding_dim=16, tt_ranks=[8, 8],
              use_cache=True, weight_dist="uniform")
    jm = J.TTEmbeddingBag(optimizer=J.OptimType(optimizer), **kw)
    tm = T.TTEmbeddingBag(optimizer=T.OptimType(optimizer), device="cpu",
                          **kw)
    assert tm.tt_p_shapes == jm.tt_p_shapes
    assert tm.tt_q_shapes == jm.tt_q_shapes
    js, ts = jm.state_dict(), tm.state_dict()
    assert list(ts) == list(js)
    for k in js:
        assert tuple(ts[k].shape) == tuple(np.shape(js[k])), k
        assert str(ts[k].dtype).split(".")[-1] == str(
            np.asarray(js[k]).dtype), k
        np.testing.assert_array_equal(_np(ts[k]), np.asarray(js[k]))
    assert tm.cache.weight.shape[0] == 100 and tm.cache.freq.shape[0] == 1000


def test_modules_default_to_cuda():
    import inspect

    for cls in (T.TableBatchedTTEmbeddingBag, T.TTEmbeddingBag):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    assert inspect.signature(T.TTEmbeddingBag).parameters[
        "use_cache"].default is True


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("nd", [2, 3, 4])
def test_forward_matches_jax(nd):
    jm, tm = pair(nd)
    rng = np.random.default_rng(nd)
    idx, offs = generate_sparse_feature(rng, 24, jm.num_embeddings, 4, 3)
    out = tm(idx, offs)
    assert out.shape == (24, jm.embedding_dim) and not out.requires_grad
    np.testing.assert_allclose(_np(out), np.asarray(jm(idx, offs)), **TIGHT)


@pytest.mark.parametrize("nd", [2, 3])
def test_forward_table_batched_matches_jax(nd):
    jm, tm = pair(nd, num_tables=2)
    rng = np.random.default_rng(10 + nd)
    idx, offs = generate_sparse_feature(rng, 16, jm.num_embeddings, 3, 2,
                                        num_tables=2)
    out = tm(idx, offs)
    assert out.shape == (2, 16, jm.embedding_dim)
    np.testing.assert_allclose(_np(out), np.asarray(jm(idx, offs)), **TIGHT)


def test_forward_empty_bags_and_weights_match_jax():
    jm, tm = pair(3)
    idx = np.array([5, 7, 7, 600, 3], np.int64)
    offs = np.array([0, 0, 2, 2, 5, 5], np.int64)  # bags 0, 2, 4 empty
    out = _np(tm(idx, offs))
    np.testing.assert_allclose(out, np.asarray(jm(idx, offs)), **TIGHT)
    assert (out[[0, 2, 4]] == 0).all()
    w = np.random.default_rng(3).standard_normal(5).astype(np.float32)
    np.testing.assert_allclose(_np(tm(idx, offs, weights=w)),
                               np.asarray(jm(idx, offs, weights=w)), **TIGHT)


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_sorted"])
def test_forward_impls_match_jax(impl):
    jm, tm = pair(3, impl=impl)
    idx, offs = fixed_bags(np.random.default_rng(4), 16, jm.num_embeddings,
                           3)
    np.testing.assert_allclose(_np(tm(idx, offs)), np.asarray(jm(idx, offs)),
                               **TIGHT)


def test_edge_cases_match_jax():
    """tests/test_edge_cases.py's module: a single lookup, boundary ids
    (E < prod(p)), a batch on one row, and a zero cotangent."""
    kw = dict(num_embeddings=500, embedding_dim=16, tt_p_shapes=[8, 8, 8],
              tt_q_shapes=[4, 2, 2], tt_ranks=[8, 8], learning_rate=0.1)
    jm, tm = pair(**kw)
    for idx, offs in ((np.array([499]), np.array([0, 1])),
                      (np.array([0, 499, 499, 0]), np.array([0, 2, 4]))):
        np.testing.assert_allclose(_np(tm(idx, offs)),
                                   np.asarray(jm(idx, offs)), **TIGHT)
    idx, offs = np.full(64, 123, np.int64), np.arange(0, 65, 4)
    d = np.ones((16, 16), np.float32)
    jm(idx, offs), tm(idx, offs)
    jm.backward(d), tm.backward(d)
    assert_cores(jm, tm)
    before = [_np(c).copy() for c in tm.tt_cores]
    tm(np.arange(10), np.arange(0, 11, 2))
    tm.backward(np.zeros((5, 16), np.float32))
    for b, a in zip(before, tm.tt_cores):
        np.testing.assert_array_equal(b, _np(a))


def test_big_table_forward_and_sgd_match_jax():
    """A table past int32 rows (prod(p) > 2**31, no cache): ids decompose
    on the host in int64 (tests/test_int64.py's shapes)."""
    kw = dict(num_embeddings=2048 * 2048 * 513, embedding_dim=64,
              tt_p_shapes=[2048, 2048, 513], tt_q_shapes=[4, 4, 4],
              tt_ranks=[8, 8], learning_rate=0.1)
    jm, tm = pair(**kw)
    assert tm._big_e
    rng = np.random.default_rng(1)
    idx = rng.integers(0, kw["num_embeddings"], size=12, dtype=np.int64)
    idx[0], idx[1] = kw["num_embeddings"] - 1, 2**31 + 999
    offs = np.arange(0, 13, 3, dtype=np.int64)
    np.testing.assert_allclose(_np(tm(idx, offs)), np.asarray(jm(idx, offs)),
                               **TIGHT)
    d = rng.standard_normal((4, 64)).astype(np.float32)
    jm.backward(d), tm.backward(d)
    assert_cores(jm, tm)


# --------------------------------------------------------------- backward


@pytest.mark.parametrize("nd,num_tables,optimizer", [
    (2, 1, "sgd"), (3, 1, "sgd"), (4, 1, "sgd"), (3, 2, "sgd"),
    (2, 1, "exact_adagrad"), (3, 1, "exact_adagrad"), (4, 1, "exact_adagrad"),
    (3, 2, "exact_adagrad"),
])
def test_three_backward_steps_match_jax(nd, num_tables, optimizer):
    jm, tm = pair(nd, num_tables, optimizer, learning_rate=0.05)
    rng = np.random.default_rng(7 * nd + num_tables)
    for _ in range(3):
        idx, offs = fixed_bags(rng, 16, jm.num_embeddings, 4, num_tables)
        d = rng.standard_normal(
            (num_tables, 16, jm.embedding_dim)).astype(np.float32)
        np.testing.assert_allclose(_np(tm(idx, offs)),
                                   np.asarray(jm(idx, offs)), **TIGHT)
        assert jm.backward(d) is None and tm.backward(d) is None
        assert_cores(jm, tm)
        for a, b in zip(jm.optimizer_state, tm.optimizer_state):
            np.testing.assert_allclose(_np(b), np.asarray(a), **STEP)


def test_weighted_backward_matches_jax_and_the_fused_step():
    """Weights scale the cotangents (tests/test_weighted.py): the port's
    module against JAX's, and against the port's fused step."""
    jm, tm = pair(3, learning_rate=0.05, seed=9)
    rng = np.random.default_rng(4)
    idx, offs = generate_sparse_feature(rng, 8, jm.num_embeddings, 4, 2)
    w = rng.standard_normal(len(idx)).astype(np.float32)
    d = (rng.standard_normal((1, 8, jm.embedding_dim)) * 0.1).astype(
        np.float32)
    params0 = T.params_from_jax([_np(c) for c in tm.tt_cores], device="cpu")
    jm(idx, offs, weights=w), tm(idx, offs, weights=w)
    jm.backward(d), tm.backward(d)
    assert_cores(jm, tm)
    step = T.make_fused_train_step(tm.tt_p_shapes, tm.tt_q_shapes,
                                   tm.tt_ranks, 1, 8, device="cpu")
    _, params1 = step(params0, idx, offs, d, (0.05, 1e-10), weights=w)
    for a, b in zip(params1.tt_cores, tm.tt_cores):
        np.testing.assert_allclose(_np(b), _np(a), **TIGHT)


@pytest.mark.parametrize("nd,num_tables", [(2, 1), (4, 1), (3, 2)])
def test_dense_grads_match_jax(nd, num_tables):
    jm, tm = pair(nd, num_tables, sparse=False)
    rng = np.random.default_rng(nd + 5 * num_tables)
    idx, offs = generate_sparse_feature(rng, 20, jm.num_embeddings, 4, 2,
                                        num_tables=num_tables)
    d = rng.standard_normal(
        (num_tables, 20, jm.embedding_dim)).astype(np.float32)
    jm(idx, offs), tm(idx, offs)
    (jg, jc), (tg, tc) = jm.backward(d), tm.backward(d)
    assert jc is None and tc is None
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(_np(b), np.asarray(a), **STEP)
    # dense mode leaves the cores as they were
    for a, b in zip(jm.tt_cores, tm.tt_cores):
        np.testing.assert_array_equal(_np(b), np.asarray(a))


def test_dense_grads_with_cache_match_jax():
    """Dense mode on a populated cache: the cores' gradients skip the
    cache-served lookups, and ``d_cache_weight`` sums theirs."""
    p, q, r, e, d = tt_test_shapes(3)
    jm, tm = pair(3, sparse=False, use_cache=True, cache_size=16,
                  hashtbl_size=e)
    hot = np.array([3] * 9 + [5] * 7 + list(range(20, 40)), np.int64)
    for m in (jm, tm):
        m.update_cache(hot)
        m.cache_populate()
    rng = np.random.default_rng(2)
    idx, offs = fixed_bags(rng, 12, e, 4, zipf=True)
    w = rng.standard_normal(len(idx)).astype(np.float32)
    dout = rng.standard_normal((12, d)).astype(np.float32)
    np.testing.assert_allclose(_np(tm(idx, offs, weights=w)),
                               np.asarray(jm(idx, offs, weights=w)), **TIGHT)
    assert 0 < tm.cache_hit_rate() == pytest.approx(jm.cache_hit_rate())
    (jg, jc), (tg, tc) = jm.backward(dout), tm.backward(dout)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(_np(b), np.asarray(a), **STEP)
    assert np.abs(np.asarray(jc)).max() > 0
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **TIGHT)


def test_backward_before_forward_asserts():
    _, tm = pair(2)
    with pytest.raises(AssertionError, match="forward"):
        tm.backward(np.zeros((4, tm.embedding_dim), np.float32))


def test_determinism_across_runs():
    """Same seed and data: bitwise-equal cores after five steps
    (tests/test_edge_cases.py)."""
    results = []
    for _ in range(2):
        _, tm = pair(3, learning_rate=0.05, seed=7)
        rng = np.random.default_rng(3)
        for _ in range(5):
            idx = rng.integers(0, tm.num_embeddings, 40)
            tm(idx, np.arange(0, 41, 4))
            tm.backward(rng.standard_normal((10, tm.embedding_dim)))
        results.append([_np(c).copy() for c in tm.tt_cores])
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)


def _graph_nodes(fn):
    """Names of the autograd nodes reachable from ``fn``."""
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is None or type(f).__name__ in seen:
            continue
        seen.add(type(f).__name__)
        todo += [g for g, _ in f.next_functions]
    return seen


@pytest.mark.parametrize("impl,graph", [("auto", "FlatLookupBackward"),
                                        ("pallas", "GenericLookupBackward")])
def test_backward_runs_through_the_forward_graph(monkeypatch, impl, graph):
    """The forward keeps its kernel lookup's autograd graph and backward
    differentiates it: no plain chain (``tt_forward``) on the way. Without
    the graph (a forward under no_grad) backward runs the lookup again."""
    jm, tm = pair(3, impl=impl, learning_rate=0.05)
    rng = np.random.default_rng(8)
    idx, offs = fixed_bags(rng, 16, jm.num_embeddings, 4)
    d = rng.standard_normal((16, jm.embedding_dim)).astype(np.float32)

    def no_plain(*a, **k):
        raise AssertionError("the plain lookup ran")

    monkeypatch.setattr(tlookup, "tt_forward", no_plain)
    tm(idx, offs)
    assert graph in _graph_nodes(tm._saved_ctx["graph"][0].grad_fn)
    jm(idx, offs)
    tm.backward(d), jm.backward(d)
    assert_cores(jm, tm)
    with torch.no_grad():
        tm(idx, offs)
    assert tm._saved_ctx["graph"] is None
    jm(idx, offs)
    tm.backward(d), jm.backward(d)
    assert_cores(jm, tm)
    tm.backward(d), jm.backward(d)  # a second backward on the same forward
    assert_cores(jm, tm)


# ------------------------------------------------------------------ cache


def _cache_fields(m):
    return {f: _np(getattr(m.cache, f)).copy()
            for f in ("keys", "freq", "slots", "weight", "opt_state")}


def _hold_cache(jm, tm, jbefore, tbefore):
    """Counts, keys, slots exact; the rows' (and optimizer state's) update
    within 1e-6 x max|update|."""
    ja, ta = _cache_fields(jm), _cache_fields(tm)
    for f in ("keys", "freq", "slots"):
        np.testing.assert_array_equal(ta[f], ja[f], err_msg=f)
    for f in ("weight", "opt_state"):
        if not ja[f].size:
            continue
        jupd, tupd = ja[f] - jbefore[f], ta[f] - tbefore[f]
        assert np.abs(jupd).max() > 0, f
        assert np.abs(tupd - jupd).max() <= 1e-6 * np.abs(jupd).max(), f


@pytest.mark.parametrize("optimizer,impl,hashed", [
    ("sgd", "auto", False), ("sgd", "pallas", False), ("sgd", "xla", False),
    ("sgd", "auto", True), ("exact_adagrad", "auto", False),
    ("exact_adagrad", "pallas", False), ("adam", "auto", False),
])
def test_cached_module_matches_jax(optimizer, impl, hashed):
    """Warm-up steps (counting), ``cache_populate``, then steps that probe
    the cache: outputs, hit rates, cores and the cache against JAX's."""
    p, q, r, e, d = tt_test_shapes(3)
    jm, tm = pair(3, optimizer=optimizer, impl=impl, use_cache=True,
                  cache_size=16, hashtbl_size=512 if hashed else e,
                  learning_rate=0.05, seed=2)
    rng = np.random.default_rng(5)
    for step in range(4):
        if step == 2:
            jm.cache_populate(), tm.cache_populate()
            assert not tm.warmup
            ja, ta = _cache_fields(jm), _cache_fields(tm)
            for f in ("keys", "freq", "slots"):
                np.testing.assert_array_equal(ta[f], ja[f], err_msg=f)
            np.testing.assert_allclose(ta["weight"], ja["weight"], **TIGHT)
        idx, offs = fixed_bags(rng, 16, e, 4, zipf=True)
        dout = rng.standard_normal((16, d)).astype(np.float32)
        np.testing.assert_allclose(_np(tm(idx, offs)),
                                   np.asarray(jm(idx, offs)), **TIGHT)
        assert tm.cache_hit_rate() == pytest.approx(jm.cache_hit_rate())
        assert (tm.cache_hit_rate() > 0) == (step >= 2)
        jb, tb = _cache_fields(jm), _cache_fields(tm)
        jm.backward(dout), tm.backward(dout)
        assert_cores(jm, tm)
        if step >= 2:
            _hold_cache(jm, tm, jb, tb)
        else:
            np.testing.assert_array_equal(_cache_fields(tm)["freq"],
                                          _cache_fields(jm)["freq"])


def test_weighted_cache_backward_scales_cache_update():
    """tests/test_weighted.py: cache rows hit by weighted lookups get
    w-scaled SGD updates."""
    p, q, r, e, d = tt_test_shapes(3)
    _, tm = pair(3, use_cache=True, cache_size=8, hashtbl_size=e,
                 learning_rate=1.0, seed=5)
    hot = np.array([3] * 40 + [5] * 30, np.int64)
    tm(hot, np.array([0, len(hot)]))
    tm.cache_populate()
    tm(np.array([3, 5]), np.array([0, 1, 2]),
       weights=np.array([2.0, 0.0], np.float32))
    assert tm.cache_hit_rate() == 1.0
    before = _np(tm.cache.weight).copy()
    tm.backward(np.ones((2, d), np.float32))
    after = _np(tm.cache.weight)
    loc3, loc5 = int(tm.cache.slots[3]), int(tm.cache.slots[5])
    np.testing.assert_allclose(after[loc3], before[loc3] - 2.0, rtol=1e-6)
    np.testing.assert_array_equal(after[loc5], before[loc5])


def test_cache_count_interval_matches_jax():
    p, q, r, e, d = tt_test_shapes(3)
    jm, tm = pair(3, use_cache=True, cache_size=8, hashtbl_size=e,
                  cache_count_interval=2)
    rng = np.random.default_rng(6)
    for _ in range(5):
        idx, offs = fixed_bags(rng, 8, e, 3, zipf=True)
        jm(idx, offs), tm(idx, offs)
    np.testing.assert_array_equal(_np(tm.cache.freq), np.asarray(jm.cache.freq))
    assert _np(tm.cache.freq).sum() == 3 * 2 * 24  # calls 0, 2 and 4 counted


def test_warmup_override_matches_jax():
    """``warmup=False`` probes during the warm-up, ``warmup=True`` skips the
    probe after populate (tests/test_cache.py)."""
    p, q, r, e, d = tt_test_shapes(3)
    jm, tm = pair(3, use_cache=True, cache_size=16, hashtbl_size=512, seed=3)
    rng = np.random.default_rng(11)
    idx, offs = generate_sparse_feature(rng, 16, e, 5, 2)
    for kw in ({}, {"warmup": False}):
        np.testing.assert_allclose(_np(tm(idx, offs, **kw)),
                                   np.asarray(jm(idx, offs, **kw)), **TIGHT)
        assert tm.cache_hit_rate() == jm.cache_hit_rate() == 0.0
    jm.cache_populate(), tm.cache_populate()
    for kw in ({}, {"warmup": True}):
        np.testing.assert_allclose(_np(tm(idx, offs, **kw)),
                                   np.asarray(jm(idx, offs, **kw)), **TIGHT)
        assert tm.cache_hit_rate() == pytest.approx(jm.cache_hit_rate())
    assert tm.cache_hit_rate() == 0.0  # the last call skipped the probe


def test_cache_methods_match_jax():
    """``update_cache``, ``reset_cache``, ``get_params``,
    ``set_learning_rate`` and ``full_weight``."""
    p, q, r, e, d = tt_test_shapes(3)
    jm, tm = pair(3, use_cache=True, cache_size=8, hashtbl_size=300)
    ids = np.array([3, 3, 9, 600, 41, 3], np.int64)
    jm.update_cache(jnp.asarray(ids, jnp.int32)), tm.update_cache(ids)
    for f in ("keys", "freq"):
        np.testing.assert_array_equal(_np(getattr(tm.cache, f)),
                                      np.asarray(getattr(jm.cache, f)))
    assert len(tm.get_params()) == 4 and tm.get_params()[-1] is tm.cache.weight
    assert len(list(tm.parameters())) == 3  # get_params changed nothing
    tm.set_learning_rate(0.25)
    assert tm.learning_rate == 0.25
    tm.reset_cache()
    assert int(tm.cache.freq.sum()) == 0 and (_np(tm.cache.keys) == -1).all()
    np.testing.assert_allclose(_np(tm.full_weight()),
                               np.asarray(jm.full_weight()), **TIGHT)


# ------------------------------------------------------ functional forward


def test_tt_embedding_forward_with_cache_locations_and_grads():
    """tests/test_functional_api.py's case, and the gradients: cache-served
    lookups send theirs to ``cache.weight``, the rest to the cores."""
    p, q, r, e, d = tt_test_shapes(3)
    jm, tm = pair(3, use_cache=True, cache_size=8, hashtbl_size=e)
    ids = np.array([3] * 9 + [17] * 4, np.int64)
    for m in (jm, tm):
        m.update_cache(ids)
        m.cache_populate()
    rng = np.random.default_rng(0)
    idx, offs = generate_sparse_feature(rng, 16, e, 4, 1)
    idx[:6] = 3
    w = rng.standard_normal(len(idx)).astype(np.float32)
    dout = rng.standard_normal((1, 16, d)).astype(np.float32)
    nnz = len(idx)
    jrow, _ = j_rowidx(jnp.asarray(offs), nnz, 1, 16)
    _, _, _, jloc = jcache.preprocess_indices(
        jnp.asarray(idx), jnp.asarray(offs), 1, 16, warmup=False,
        cache_state=jm.cache)

    def jf(cores, cw):
        prm = JParams(cores, tuple(jm.optimizer_state),
                      jm.cache.replace(weight=cw))
        return j_tt_embedding_forward(prm, p, q, jm.tt_ranks, 16,
                                      jnp.asarray(idx), jrow, None,
                                      cache_locations=jloc,
                                      weights=jnp.asarray(w))

    jout, vjp = jax.vjp(jf, tuple(jm.tt_cores), jm.cache.weight)
    jgc, jgw = vjp(jnp.asarray(dout))

    cores = [c.detach().clone().requires_grad_() for c in tm.tt_cores]
    cs = tm.params.cache
    cw = cs.weight.clone().requires_grad_()
    prm = T.TTEmbeddingParams(tuple(cores), (), CacheState(
        cs.keys, cs.freq, cs.slots, cw, cs.opt_state))
    trow, _ = T.rowidx_from_offsets(torch.as_tensor(offs), nnz, 1, 16)
    tidx = torch.as_tensor(idx)
    _, _, _, tloc = T.preprocess_indices(tidx, torch.as_tensor(offs), 1, 16,
                                         False, prm.cache)
    np.testing.assert_array_equal(_np(tloc), np.asarray(jloc))
    assert (_np(tloc) >= 0).any() and (_np(tloc) < 0).any()
    tout = T.tt_embedding_forward(prm, p, q, tm.tt_ranks, 16, tidx, trow,
                                  None, cache_locations=tloc,
                                  weights=torch.as_tensor(w))
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TIGHT)
    tgc = torch.autograd.grad(tout, cores + [cw], torch.as_tensor(dout))
    for a, b in zip(list(jgc) + [jgw], tgc):
        np.testing.assert_allclose(_np(b), np.asarray(a), **STEP)
    assert np.abs(_np(tgc[-1])).max() > 0


# ------------------------------------------------------------------ state


def test_state_dict_from_jax_loads_into_the_port():
    """JAX's state dict as numpy -> ``load_state_dict``: the same forward
    and the same next step; then port -> port."""
    p, q, r, e, d = tt_test_shapes(3)
    jm, _ = pair(3, optimizer="exact_adagrad", use_cache=True, cache_size=16,
                 hashtbl_size=e, learning_rate=0.2)
    rng = np.random.default_rng(12)
    for step in range(3):
        if step == 2:
            jm.cache_populate()
        idx, offs = fixed_bags(rng, 16, e, 4, zipf=True)
        jm(idx, offs)
        jm.backward(rng.standard_normal((16, d)).astype(np.float32))
    _, tm = pair(3, optimizer="exact_adagrad", use_cache=True, cache_size=16,
                 hashtbl_size=e, learning_rate=0.2, seed=99)
    tm.load_state_dict({k: np.asarray(v) for k, v in jm.state_dict().items()})
    tm.warmup = jm.warmup
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(_np(v), np.asarray(jm.state_dict()[k]))
    idx, offs = fixed_bags(rng, 16, e, 4, zipf=True)
    dout = rng.standard_normal((16, d)).astype(np.float32)
    np.testing.assert_allclose(_np(tm(idx, offs)), np.asarray(jm(idx, offs)),
                               **TIGHT)
    jm.backward(dout), tm.backward(dout)
    assert_cores(jm, tm)
    _, tm2 = pair(3, optimizer="exact_adagrad", use_cache=True,
                  cache_size=16, hashtbl_size=e, seed=98)
    tm2.load_state_dict(tm.state_dict())
    for (k, a), b in zip(tm.state_dict().items(), tm2.state_dict().values()):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=k)
        assert a.data_ptr() != b.data_ptr() or not a.numel(), k


def test_truncated_state_dict_raises_key_error():
    jm, tm = pair(3)
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    del state["optimizer_state.2"]
    with pytest.raises(KeyError, match="optimizer_state"):
        tm.load_state_dict(state)
    with pytest.raises(KeyError, match="optimizer_state"):
        T.params_from_state_dict(state, 3, False, device="cpu")


def test_params_and_load_params_round_trip_with_the_fused_step():
    """``params`` views the module's tensors (the fused step updates the
    module in place); ``load_params`` copies."""
    _, tm = pair(3, optimizer="exact_adagrad", learning_rate=0.05)
    before = [_np(c).copy() for c in tm.tt_cores]
    step = T.make_fused_train_step(tm.tt_p_shapes, tm.tt_q_shapes,
                                   tm.tt_ranks, 1, 8,
                                   optimizer=T.OptimType.EXACT_ADAGRAD,
                                   device="cpu")
    rng = np.random.default_rng(1)
    idx, offs = fixed_bags(rng, 8, tm.num_embeddings, 3)
    step(tm.params, idx, offs, rng.standard_normal((1, 8, 60)), (0.05, 1e-10))
    assert not np.allclose(before[0], _np(tm.tt_cores[0]))
    assert float(tm.optimizer_state[0].abs().max()) > 0
    _, tm2 = pair(3, optimizer="exact_adagrad", seed=4)
    tm2.load_params(tm.params)
    for a, b in zip(tm.state_dict().values(), tm2.state_dict().values()):
        np.testing.assert_array_equal(_np(a), _np(b))
        assert a.data_ptr() != b.data_ptr()


def test_parts_not_ported_raise():
    """The options the port once refused now build: native semantics (the
    JAX module's state layout), ``freeze_for_serving``, and a cached table
    past int32 rows (the wide-key cache); an unknown semantics raises."""
    jm, tm = pair(3, optimizer="adam", optim_semantics="native")
    assert len(tm.optimizer_state) == 2 * 3 + 1
    for a, b in zip(tm.optimizer_state, jm.optimizer_state):
        assert _np(a).shape == np.asarray(b).shape
        assert _np(a).dtype == np.asarray(b).dtype
    with pytest.raises(ValueError):  # JAX's module asserts instead
        T.TTEmbeddingBag(num_embeddings=1000, embedding_dim=16,
                         tt_ranks=[8, 8], optim_semantics="other",
                         device="cpu")
    _, tm = pair(3)
    folded, _ = tm.freeze_for_serving(8)  # ported: it folds now
    assert folded.setup is not None
    big = T.TTEmbeddingBag(num_embeddings=2048 * 2048 * 513, embedding_dim=64,
                           tt_p_shapes=[2048, 2048, 513],
                           tt_q_shapes=[4, 4, 4], tt_ranks=[8, 8],
                           use_cache=True, cache_size=64, hashtbl_size=1024,
                           device="cpu")
    assert big.cache.state().wide
    assert tuple(big.cache.keys.shape) == (1024, 2 + 3)


# ------------------------------------------- tests/test_property.py ranges


def _property_pair(tt_ndim, num_tables=1, **kw):
    """tests/test_property.py's module (ranks 8) on both packages."""
    p, q = [7, 9, 11, 5][:tt_ndim], [3, 4, 5, 7][:tt_ndim]
    return pair(num_tables=num_tables, num_embeddings=int(np.prod(p)),
                embedding_dim=int(np.prod(q)), tt_p_shapes=p, tt_q_shapes=q,
                tt_ranks=[8] * (tt_ndim - 1), **kw)


@settings(max_examples=5, deadline=None)
@given(batch_size=st.integers(20, 50), pooling_factor=st.integers(1, 10),
       pooling_std=st.integers(0, 5), tt_ndim=st.integers(2, 4),
       seed=st.integers(0, 2**16))
def test_forward_property_matches_jax(batch_size, pooling_factor,
                                      pooling_std, tt_ndim, seed):
    jm, tm = _property_pair(tt_ndim, seed=seed % 97)
    rng = np.random.default_rng(seed)
    idx, offs = generate_sparse_feature(rng, batch_size, jm.num_embeddings,
                                        pooling_factor, pooling_std)
    np.testing.assert_allclose(_np(tm(idx, offs)), np.asarray(jm(idx, offs)),
                               **TIGHT)


@settings(max_examples=5, deadline=None)
@given(batch_size=st.integers(20, 40), pooling_factor=st.integers(1, 6),
       tt_ndim=st.integers(2, 4), lr=st.floats(0.01, 0.3),
       seed=st.integers(0, 2**16))
def test_backward_sgd_property_matches_jax(batch_size, pooling_factor,
                                           tt_ndim, lr, seed):
    jm, tm = _property_pair(tt_ndim, learning_rate=lr, seed=seed % 89)
    rng = np.random.default_rng(seed)
    idx, offs = generate_sparse_feature(rng, batch_size, jm.num_embeddings,
                                        pooling_factor, 2)
    d = rng.normal(size=(batch_size, jm.embedding_dim)).astype(np.float32)
    jm(idx, offs), tm(idx, offs)
    jm.backward(d), tm.backward(d)
    assert_cores(jm, tm)


@settings(max_examples=5, deadline=None)
@given(batch_size=st.integers(20, 40), pooling_factor=st.integers(1, 6),
       tt_ndim=st.integers(2, 3), num_tables=st.integers(2, 4),
       seed=st.integers(0, 2**16))
def test_table_batched_forward_property_matches_jax(
        batch_size, pooling_factor, tt_ndim, num_tables, seed):
    jm, tm = _property_pair(tt_ndim, num_tables, seed=seed % 83)
    rng = np.random.default_rng(seed)
    idx, offs = generate_sparse_feature(rng, batch_size, jm.num_embeddings,
                                        pooling_factor, 2,
                                        num_tables=num_tables)
    out = _np(tm(idx, offs))
    assert out.shape == (num_tables, batch_size, jm.embedding_dim)
    np.testing.assert_allclose(out, np.asarray(jm(idx, offs)), **TIGHT)
