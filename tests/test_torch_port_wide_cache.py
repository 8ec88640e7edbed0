"""PyTorch port vs the JAX package: the wide int64-key LFU cache (CPU).

The wide layout (``make_cache_state(..., wide_keys=tt_ndim)``) of
``fbtt_embedding_tpu_torch`` against the JAX package's on the same
numpy-seeded inputs, at ``tests/test_cache_int64.py``'s table
(p = [1300, 1300, 1300], E = 2.197e9 > 2^31), the JAX side on its XLA
path on the CPU (Pallas in interpret mode for the folded serve), the port's
kernels on their plain versions:

- ``hash_keys_wide`` bit for bit on edge values;
- counting (keys and freq exactly): duplicates, negative ids, both pad
  forms, ``scale > 1``, and a tiny table that forces the second tournament
  round and drops keys; two counts of one batch bitwise equal;
- ``cache_lookup`` exactly, with both pad forms a miss; ``populate_plan``
  exactly and the populated rows within 1e-6;
- the cached fused step (SGD, ``EXACT_ADAGRAD``, a row-wise optimizer, and
  native LAMB), ``make_serving_fn``, the folded serve (bf16 staging off on
  the CPU; int8), ``refold_cache`` and the bucketed front-end, and the
  big-E cached module against JAX's;
- ``params_from_jax`` with a wide cache, and the layout mismatches
  (ValueError, where the JAX package raises other errors or miscounts).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fbtt_embedding_tpu as J
from fbtt_embedding_tpu.models.tt_embedding import (
    make_bucketed_serving_fn as j_make_bucketed,
    make_folded_serving_fn as j_make_folded,
    make_fused_train_step as j_make_step,
    make_serving_fn as j_make_serving_fn,
)
from fbtt_embedding_tpu.ops import cache as jc
from fbtt_embedding_tpu.ops import fused_optim as jopt
import fbtt_embedding_tpu_torch as T

P_SHAPES = [1300, 1300, 1300]           # E = 2.197e9 > 2**31
Q_SHAPES = [4, 2, 2]
RANKS = [1, 8, 8, 1]
E = int(np.prod(P_SHAPES))
D = 16
FIELDS = ("keys", "freq", "slots", "weight", "opt_state")
LR, EPS = 0.01, 1e-3
STEP = dict(rtol=1e-4, atol=1e-5)


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


def _rows(ids):
    return np.array(jc.wide_cache_keys(np.asarray(ids, np.int64),
                                       P_SHAPES))


def _assert_state(state, jstate, tol=1e-6):
    for f in FIELDS:
        got, want = _np(getattr(state, f)), np.asarray(getattr(jstate, f))
        assert got.shape == want.shape and got.dtype == want.dtype, f
        if f in ("keys", "freq", "slots"):
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                       err_msg=f)


def _cores(seed=0):
    return T.init_tt_cores(np.random.default_rng(seed), "uniform", 1, E, D,
                           P_SHAPES, Q_SHAPES, RANKS)


def test_hash_keys_wide_bit_for_bit():
    rng = np.random.default_rng(0)
    edge = [-1, 0, 1, 2 ** 31 - 1, -(2 ** 31), 2 ** 30 + 7, -2]
    hi = np.concatenate([np.repeat(edge, len(edge)), rng.integers(
        -(2 ** 31), 2 ** 31, size=2000)]).astype(np.int32)
    lo = np.concatenate([np.tile(edge, len(edge)), rng.integers(
        -(2 ** 31), 2 ** 31, size=2000)]).astype(np.int32)
    for size in (1, 7, 256, 1000, 2 ** 24, 2 ** 31 - 1):
        want = np.asarray(jc.hash_keys_wide(jnp.asarray(hi), jnp.asarray(lo),
                                            size))
        got = T.hash_keys_wide(torch.as_tensor(hi), torch.as_tensor(lo),
                               size)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["none", "rowwise", "full"])
def test_make_cache_state_wide_layout(kind):
    want = jc.make_cache_state(128, 8, D, kind, wide_keys=3)
    got = T.make_cache_state(128, 8, D, kind, num_embeddings=E, wide_keys=3,
                             device="cpu")
    assert got.wide and not got.direct and got.hashtbl_size == 128
    _assert_state(got, want, tol=0)
    assert T.wide_cache_keys is T.wide_keyrows
    np.testing.assert_array_equal(T.wide_cache_keys([5, 2 ** 40], P_SHAPES),
                                  _rows([5, 2 ** 40]))


def _count_batches(seed, n=3, size=96, negative=True):
    """Ids over [0, E), most at 2^31 or above, with duplicates and pad rows
    of both forms, (hi, lo) = (-1, -1) and id -1's (hi, lo) = (-1, 2^31 -
    1), over the part columns of valid ids; with ``negative``, negative ids
    too (their part columns are the JAX package's, which the TT path of
    neither package defines, so only the counting tests take them)."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(2 ** 31, E, size=12, dtype=np.int64)
    out = []
    for _ in range(n):
        ids = np.where(rng.random(size) < 0.6,
                       hot[rng.integers(0, 12, size=size)],
                       rng.integers(0, E, size=size, dtype=np.int64))
        if negative:
            ids[rng.random(size) < 0.05] = -1
            ids[rng.random(size) < 0.03] = -(2 ** 33) - 5
        rows = _rows(ids)
        rows[rng.random(size) < 0.05, :2] = -1
        rows[rng.random(size) < 0.05, :2] = (-1, 2 ** 31 - 1)
        out.append(rows)
    return out


# hashtbl sizes: roomy, and one below the distinct ids (collisions, the
# second claim round, dropped keys)
@pytest.mark.parametrize("h_size,scale", [(1024, 1), (1024, 3), (16, 1)])
def test_wide_counting_matches_jax(h_size, scale):
    jstate = jc.make_cache_state(h_size, 8, D, wide_keys=3)
    state = T.make_cache_state(h_size, 8, D, wide_keys=3, device="cpu")
    for rows in _count_batches(h_size + scale):
        jstate = jc.update_cache_state(jstate, jnp.asarray(rows),
                                       scale=scale)
        assert T.update_cache_state(state, torch.as_tensor(rows),
                                    scale=scale) is state
        _assert_state(state, jstate)
    occupied = _np(state.keys)[:, 0] != -1
    assert occupied.any() and (_np(state.keys)[occupied, 0] >= 0).all()
    if h_size == 16:
        assert occupied.all()  # full: later keys were dropped


def test_wide_counting_deterministic_and_drops_negative_ids():
    rows = _count_batches(4, n=1)[0]
    outs = []
    for _ in range(2):
        s = T.make_cache_state(128, 8, D, wide_keys=3, device="cpu")
        T.update_cache_state(s, torch.as_tensor(rows))
        T.update_cache_state(s, torch.as_tensor(rows))
        outs.append(s)
    assert torch.equal(outs[0].keys, outs[1].keys)
    assert torch.equal(outs[0].freq, outs[1].freq)
    valid = rows[rows[:, 0] >= 0]
    clean = T.make_cache_state(128, 8, D, wide_keys=3, device="cpu")
    T.update_cache_state(clean, torch.as_tensor(valid))
    T.update_cache_state(clean, torch.as_tensor(valid))
    assert torch.equal(clean.keys, outs[0].keys)
    assert torch.equal(clean.freq, outs[0].freq)


def _populated(h_size=512, c_size=16, kind="none", seed=1):
    """Cores (numpy) and a JAX wide cache counted on three batches."""
    cores = _cores(seed)
    jstate = jc.make_cache_state(h_size, c_size, D, kind, wide_keys=3)
    for rows in _count_batches(seed):
        jstate = jc.update_cache_state(jstate, jnp.asarray(rows))
    return cores, jstate


def test_wide_populate_and_lookup_match_jax():
    cores, jstate = _populated()
    state = T.params_from_jax(cores, device="cpu", cache=jstate).cache
    want_plan = jc.populate_plan(jstate)
    got_plan = T.populate_plan(state)
    for a, b in zip(got_plan, want_plan):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert got_plan[3].shape == (16, 3)  # winners' parts
    jpop = jc.cache_populate(jstate, [jnp.asarray(c) for c in cores],
                             P_SHAPES, Q_SHAPES, RANKS)
    pop = T.cache_populate(state, [torch.as_tensor(c) for c in cores],
                           P_SHAPES, Q_SHAPES, RANKS, populate_chunk=5)
    _assert_state(pop, jpop)
    # rows: the plain float32 tt_rows of each winner's parts
    parts = [torch.as_tensor(_np(got_plan[3])[:, t]) for t in range(3)]
    want_rows = T.tt_rows([torch.as_tensor(c) for c in cores], P_SHAPES,
                          Q_SHAPES, RANKS, None, idx_parts=parts)
    valid = _np(got_plan[4])
    np.testing.assert_allclose(_np(pop.weight)[valid],
                               _np(want_rows)[valid],
                               atol=1e-6 * float(want_rows.abs().max()),
                               rtol=0)
    rows = np.concatenate(_count_batches(1) + [_rows([2 ** 32 + 99, 3])])
    loc = T.cache_lookup(pop, torch.as_tensor(rows))
    np.testing.assert_array_equal(
        _np(loc), np.asarray(jc.cache_lookup(jpop, jnp.asarray(rows))))
    assert (_np(loc)[rows[:, 0] < 0] == -1).all()  # both pad forms miss
    assert (_np(loc) >= 0).any()


@pytest.mark.parametrize("name,semantics", [
    ("sgd", "reference"), ("exact_adagrad", "reference"),
    ("exact_row_wise_adagrad", "reference"), ("lamb", "native")])
def test_wide_cached_fused_step_matches_jax(name, semantics):
    kind = ("none" if name == "sgd" else
            "full" if name == "exact_adagrad" else "rowwise")
    cores, jstate = _populated(kind=kind)
    jstate = jc.cache_populate(jstate, [jnp.asarray(c) for c in cores],
                               P_SHAPES, Q_SHAPES, RANKS)
    jcores = [jnp.asarray(c) for c in cores]
    if semantics == "native":
        jopt_state = jopt.native_optim_init(J.OptimType(name), jcores)
    else:
        jopt_state = [jnp.zeros_like(c) for c in jcores] \
            if name != "sgd" else []
    kw = dict(use_cache=True, probe_cache=True, optim_semantics=semantics)
    jstep = j_make_step(P_SHAPES, Q_SHAPES, RANKS, 1, 8,
                        optimizer=J.OptimType(name), **kw)
    tstep = T.make_fused_train_step(P_SHAPES, Q_SHAPES, RANKS, 1, 8,
                                    optimizer=T.OptimType(name),
                                    device="cpu", **kw)
    jparams = J.TTEmbeddingParams(tuple(jcores), tuple(jopt_state), jstate)
    params = T.params_from_jax(cores, [np.asarray(s) for s in jopt_state],
                               device="cpu", cache=jstate)
    rng = np.random.default_rng(2)
    hits = 0
    for rows in _count_batches(1, size=32, negative=False):
        offs = np.arange(0, 33, 4, dtype=np.int32)
        d_out = rng.normal(size=(1, 8, D)).astype(np.float32)
        hits += int((np.asarray(jc.cache_lookup(
            jparams.cache, jnp.asarray(rows))) >= 0).sum())
        jout, jparams = jstep(jparams, jnp.asarray(rows), jnp.asarray(offs),
                              jnp.asarray(d_out),
                              (jnp.float32(LR), jnp.float32(EPS)))
        out, params = tstep(params, rows, offs, d_out, (LR, EPS))
        np.testing.assert_allclose(_np(out), np.asarray(jout), **STEP)
        for a, b in zip(list(params.tt_cores) + list(params.optimizer_state),
                        list(jparams.tt_cores)
                        + list(jparams.optimizer_state)):
            np.testing.assert_allclose(_np(a), np.asarray(b), **STEP)
        _assert_state(params.cache, jparams.cache, tol=1e-5)
    assert hits > 0


def _serving_setup():
    cores, jstate = _populated(seed=3)
    jstate = jc.cache_populate(jstate, [jnp.asarray(c) for c in cores],
                               P_SHAPES, Q_SHAPES, RANKS)
    jparams = J.TTEmbeddingParams(tuple(jnp.asarray(c) for c in cores), (),
                                  jstate)
    params = T.params_from_jax(cores, device="cpu", cache=jstate)
    rows = _count_batches(3, n=1, size=32, negative=False)[0]
    offs = np.arange(0, 33, 4, dtype=np.int32)
    w = np.random.default_rng(5).random(32).astype(np.float32)
    return jparams, params, rows, offs, w


def test_wide_serve_matches_jax():
    jparams, params, rows, offs, w = _serving_setup()
    jserve = j_make_serving_fn(P_SHAPES, Q_SHAPES, RANKS, 1, 8)
    serve = T.make_serving_fn(P_SHAPES, Q_SHAPES, RANKS, 1, 8, device="cpu")
    assert (_np(T.cache_lookup(params.cache, torch.as_tensor(rows)))
            >= 0).any()
    for wts in (None, w):
        want = jserve(jparams, jnp.asarray(rows), jnp.asarray(offs),
                      None if wts is None else jnp.asarray(wts))
        got = serve(params, rows, offs, wts)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_wide_folded_and_bucketed_serves_match_jax():
    jparams, params, rows, offs, w = _serving_setup()
    want = np.asarray(j_make_serving_fn(P_SHAPES, Q_SHAPES, RANKS, 1, 8)(
        jparams, jnp.asarray(rows), jnp.asarray(offs), jnp.asarray(w)))
    jfold, jserve = j_make_folded(P_SHAPES, Q_SHAPES, RANKS, 1, 8,
                                  interpret=True)
    jfolded = np.asarray(jserve(jfold(jparams), jnp.asarray(rows),
                                jnp.asarray(offs), jnp.asarray(w)))
    fold, serve = T.make_folded_serving_fn(P_SHAPES, Q_SHAPES, RANKS, 1, 8,
                                           device="cpu")
    fp = fold(params)
    assert fp.setup is not None and fp.setup[1] is None  # no pair table
    assert fp.cache.wide and fp.cache.freq.numel() == 0
    got = _np(serve(fp, rows, offs, w))
    np.testing.assert_allclose(got, jfolded, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the bucketed front-end pads wide rows with (hi, lo) = -1
    jbfold, jbserve = j_make_bucketed(P_SHAPES, Q_SHAPES, RANKS, 1, [16],
                                      [64], interpret=True)
    bfold, bserve = T.make_bucketed_serving_fn(P_SHAPES, Q_SHAPES, RANKS, 1,
                                               [16], [64], device="cpu")
    np.testing.assert_allclose(
        _np(bserve(bfold(params), rows, offs, w)),
        np.asarray(jbserve(jbfold(jparams), rows, offs, w)), rtol=1e-5,
        atol=1e-6)
    # refold_cache takes a newly populated wide cache, bitwise as a fold
    T.update_cache_state(params.cache, torch.as_tensor(rows))
    params.cache = T.cache_populate(params.cache, params.tt_cores, P_SHAPES,
                                    Q_SHAPES, RANKS)
    refolded = _np(serve(T.refold_cache(fp, params), rows, offs, w))
    np.testing.assert_array_equal(refolded, _np(serve(fold(params), rows,
                                                      offs, w)))
    # int8: the cache's rows per-row int8
    qfold, qserve = T.make_folded_serving_fn(P_SHAPES, Q_SHAPES, RANKS, 1, 8,
                                             quantize="int8", device="cpu")
    qfp = qfold(params)
    assert qfp.cache.weight.dtype == torch.int8 and qfp.cache.wide
    scale = float(np.abs(refolded).max())
    np.testing.assert_allclose(_np(qserve(qfp, rows, offs, w)), refolded,
                               rtol=0, atol=1e-2 * scale)


def _big_e_modules(jax_module, optimizer, seed):
    # eps 1e-3: Adagrad's first step lr*g/(|g|+eps) would magnify the two
    # sides' summation-order noise on near-zero g by 1/eps
    kw = dict(num_embeddings=E, embedding_dim=D, tt_ranks=[8, 8],
              tt_p_shapes=P_SHAPES, tt_q_shapes=Q_SHAPES, learning_rate=0.1,
              eps=EPS, use_cache=True, cache_size=16, hashtbl_size=512,
              weight_dist="uniform", seed=seed)
    if jax_module:
        return J.TTEmbeddingBag(optimizer=J.OptimType(optimizer), **kw)
    return T.TTEmbeddingBag(optimizer=T.OptimType(optimizer), device="cpu",
                            **kw)


@pytest.mark.parametrize("optimizer", ["sgd", "exact_row_wise_adagrad"])
def test_big_e_cached_module_matches_jax(optimizer):
    jm = _big_e_modules(True, optimizer, 2)
    tm = _big_e_modules(False, optimizer, 2)
    assert tm.cache.state().wide and tm.cache.keys.shape == (512, 5)
    rng = np.random.default_rng(5)
    b, pool = 8, 4
    hot = rng.integers(2 ** 31, E, size=4, dtype=np.int64)
    offs = np.arange(0, b * pool + 1, pool, dtype=np.int64)
    for i in range(4):
        idx = np.where(rng.random(b * pool) < 0.6,
                       hot[rng.integers(0, 4, size=b * pool)],
                       rng.integers(0, E, size=b * pool, dtype=np.int64))
        np.testing.assert_allclose(_np(tm(idx, offs)),
                                   np.asarray(jm(idx, offs)), **STEP)
        d = rng.normal(size=(b, D)).astype(np.float32)
        jm.backward(jnp.asarray(d))
        tm.backward(d)
        if i == 1:
            jm.cache_populate()
            tm.cache_populate()
            assert not tm.warmup
        if i >= 2:
            assert tm.cache_hit_rate() == pytest.approx(jm.cache_hit_rate())
            assert tm.cache_hit_rate() > 0
        for a, b_ in zip(tm.tt_cores, jm.tt_cores):
            np.testing.assert_allclose(_np(a), np.asarray(b_), **STEP)
        _assert_state(tm.cache.state(), jm.cache, tol=1e-5)
    tm.update_cache(hot)
    jm.update_cache(hot)
    _assert_state(tm.cache.state(), jm.cache, tol=1e-5)
    # a second module loaded with the state serves the same
    tm2 = _big_e_modules(False, optimizer, 9)
    tm2.load_state_dict(tm.state_dict())
    tm2.warmup = False
    np.testing.assert_array_equal(_np(tm2(idx, offs)), _np(tm(idx, offs,
                                                              warmup=False)))


def test_big_e_cache_requires_explicit_sizes():
    with pytest.raises(AssertionError):
        T.TTEmbeddingBag(num_embeddings=E, embedding_dim=D, tt_ranks=[8, 8],
                         tt_p_shapes=P_SHAPES, tt_q_shapes=Q_SHAPES,
                         use_cache=True, device="cpu")


def test_params_from_jax_with_a_wide_cache():
    cores, jstate = _populated(kind="rowwise")
    params = T.params_from_jax(cores, device="cpu", cache=jstate)
    _assert_state(params.cache, jstate, tol=0)
    assert params.cache.wide and params.cache.keys.shape == (512, 5)
    as_dict = T.params_from_jax(cores, device="cpu", cache={
        f: np.asarray(getattr(jstate, f)) for f in FIELDS})
    _assert_state(as_dict.cache, jstate, tol=0)
    params.cache.keys[0] = 7  # a copy: the source does not move
    assert not np.array_equal(_np(params.cache.keys),
                              np.asarray(jstate.keys))


def _mismatches():
    rows = _rows([5, 2 ** 31 + 7, 99])
    flat = torch.as_tensor([5, 7, 99], dtype=torch.int32)
    wide = T.make_cache_state(64, 4, D, wide_keys=3, device="cpu")
    hashed = T.make_cache_state(64, 4, D, device="cpu")
    direct = T.make_cache_state(100, 4, D, num_embeddings=100, device="cpu")
    return [("flat ids, wide cache", wide, flat),
            ("wide rows, hashed cache", hashed, torch.as_tensor(rows)),
            ("wide rows, direct cache", direct, torch.as_tensor(rows))]


@pytest.mark.parametrize("case", range(3))
def test_cache_layout_mismatch_raises(case):
    """The JAX package raises ValueError / IndexError / TypeError on some of
    these and silently miscounts or probes garbage on others; the port
    raises ValueError naming both layouts on each."""
    label, state, keys = _mismatches()[case]
    for fn in (T.update_cache_state, T.cache_lookup):
        with pytest.raises(ValueError, match="wide"):
            fn(state, keys)


def test_entries_reject_a_layout_mismatch():
    p, q, r = [20, 22, 25], [4, 4, 4], [1, 8, 8, 1]
    cores = T.params_from_jax(
        T.init_tt_cores(np.random.default_rng(0), "uniform", 1, 11000, 64, p,
                        q, r), device="cpu").tt_cores
    ids = np.arange(16)
    offs = np.arange(0, 17, 2)
    narrow = T.make_cache_state(11000, 4, 64, num_embeddings=11000,
                                device="cpu")
    wide = T.make_cache_state(64, 4, 64, wide_keys=3, device="cpu")
    args = (np.zeros((1, 8, 64), np.float32), (0.1, 0.1))
    step = T.make_fused_train_step(p, q, r, 1, 8, use_cache=True,
                                   probe_cache=True, device="cpu")
    serve = T.make_serving_fn(p, q, r, 1, 8, device="cpu")
    fold, fserve = T.make_folded_serving_fn(p, q, r, 1, 8, device="cpu")
    for cache, keys in ((narrow, T.wide_keyrows(ids, p)), (wide, ids)):
        prm = T.TTEmbeddingParams(cores, (), cache)
        with pytest.raises(ValueError, match="wide"):
            step(prm, keys, offs, *args)
        with pytest.raises(ValueError, match="wide"):
            serve(prm, keys, offs)
        with pytest.raises(ValueError, match="wide"):
            fserve(fold(prm), keys, offs)
