"""PyTorch port vs the JAX package: the native optimizers (CPU).

``optim_semantics="native"`` of ``fbtt_embedding_tpu_torch`` against the
JAX package's on the same numpy-seeded inputs, the JAX side on its XLA path
on the CPU, the port's kernels on their plain versions (the oracle cases of
``tests/test_native_optim.py`` and ``test_optimizer_matrix.py``):

- ``native_optim_init``'s layouts (shapes, dtypes, a buffer of its own per
  entry) and ``native_optim_step`` for all nine ``OptimType`` names over
  three steps, cores and state within rtol 1e-6, the 0-d int32 step
  counter exact; ``optim_hparams`` overrides;
- ``make_fused_train_step(optim_semantics="native")`` against JAX's over
  three steps, rtol 1e-4: every name without a cache, with LFU counting,
  and probing a populated cache (the cache rows keep the reference's
  update family); native SGD and ``EXACT_ADAGRAD`` bitwise equal to the
  reference semantics;
- the module's forward + ``backward`` against the JAX module, a JAX native
  ``state_dict`` loaded into the port and back, ``load_params``,
  ``params_from_jax`` and ``import_full_weight`` with the step counter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fbtt_embedding_tpu as J
from fbtt_embedding_tpu.models.tt_embedding import (
    make_fused_train_step as j_make_step,
)
from fbtt_embedding_tpu.ops import cache as jc
from fbtt_embedding_tpu.ops import fused_optim as jopt
import fbtt_embedding_tpu_torch as T
from fbtt_embedding_tpu_torch.ops import fused_optim as topt
from tests.utils import generate_sparse_feature, tt_test_shapes

NAMES = [o.value for o in J.OptimType]
MOMENTS = ["adam", "lamb", "partial_row_wise_adam", "partial_row_wise_lamb"]
TIGHT = dict(rtol=1e-6, atol=1e-7)
STEP = dict(rtol=1e-4, atol=1e-5)
P, Q, RANKS = [20, 22, 25], [4, 4, 4], [1, 8, 8, 1]
E, D = 11000, 64
LR, EPS = 0.01, 1e-3


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


def _cores(seed=0, tables=1):
    return T.init_tt_cores(np.random.default_rng(seed), "uniform", tables, E,
                           D, P, Q, RANKS)


def _assert_state(got, want, tol=TIGHT):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        if a.dtype == np.int32:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("name", NAMES)
def test_native_optim_init_layouts(name):
    cores = _cores(tables=2)
    want = jopt.native_optim_init(J.OptimType(name),
                                  [jnp.asarray(c) for c in cores])
    got = topt.native_optim_init(T.OptimType(name),
                                 [torch.as_tensor(c) for c in cores])
    _assert_state(got, want)
    ptrs = [s.data_ptr() for s in got if s.numel()]
    assert len(set(ptrs)) == len(ptrs)  # no two entries share a buffer
    if name in MOMENTS:
        assert got[-1].dim() == 0 and got[-1].dtype == torch.int32


def _native_run(name, hparams=None, steps=3):
    rng = np.random.default_rng(3)
    cores = _cores(seed=2, tables=2)
    jc_ = [jnp.asarray(c) for c in cores]
    js = jopt.native_optim_init(J.OptimType(name), jc_)
    tc_ = [torch.tensor(c) for c in cores]
    ts = topt.native_optim_init(T.OptimType(name), tc_)
    counter = ts[-1] if name in MOMENTS else None
    for _ in range(steps):
        grads = [rng.normal(size=c.shape).astype(np.float32) * 0.1
                 for c in cores]
        jc_, js = jopt.native_optim_step(
            J.OptimType(name), jc_, js, [jnp.asarray(g) for g in grads],
            jnp.float32(LR), jnp.float32(EPS), hparams=hparams)
        out_c, out_s = topt.native_optim_step(
            T.OptimType(name), tc_, ts, [torch.as_tensor(g) for g in grads],
            LR, EPS, hparams=hparams)
        assert all(a is b for a, b in zip(out_c, tc_))  # in place
        assert all(a is b for a, b in zip(out_s, ts))
        _assert_state(out_c, jc_)
        _assert_state(out_s, js)
    if counter is not None:  # incremented in place, never copied
        assert ts[-1] is counter and int(counter) == steps
    return tc_


@pytest.mark.parametrize("name", NAMES)
def test_native_optim_step_matches_jax(name):
    _native_run(name)


@pytest.mark.parametrize("name,hparams", [
    ("adam", {"beta1": 0.5, "beta2": 0.9}),
    ("partial_row_wise_lamb", {"beta1": 0.8}),
    ("lars_sgd", {"momentum": 0.5, "eta": 0.01}),
])
def test_native_optim_hparams_override(name, hparams):
    changed = _native_run(name, hparams)
    default = _native_run(name)
    assert not np.allclose(_np(changed[1]), _np(default[1]))


def test_native_optim_rejects_unknown_names():
    cores = [torch.zeros(1, 2, 3)]
    with pytest.raises(ValueError):
        topt.native_optim_init("nope", cores)
    with pytest.raises(ValueError):
        topt.native_optim_step("nope", cores, (), cores, LR, EPS)
    with pytest.raises(ValueError):
        T.make_fused_train_step(P, Q, RANKS, 1, 8, optim_semantics="other",
                                device="cpu")


def _batches(seed, b=8, pool=4, zipf=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        n = b * pool
        idx = ((rng.zipf(1.2, size=n) - 1) % E) if zipf else rng.integers(
            0, E, size=n)
        out.append((idx.astype(np.int32),
                    np.arange(0, n + 1, pool, dtype=np.int32),
                    rng.normal(size=(1, b, D)).astype(np.float32),
                    rng.random(n).astype(np.float32)))
    return out


def _cache(name, seed=5):
    """A JAX direct-mode cache counted on Zipf traffic and populated."""
    rng = np.random.default_rng(seed)
    kind = ("full" if name == "exact_adagrad" else
            "none" if name in ("sgd", "exact_sgd") else "rowwise")
    jstate = jc.make_cache_state(E, 64, D, kind, num_embeddings=E)
    for _ in range(3):
        warm = ((rng.zipf(1.2, size=200) - 1) % E).astype(np.int32)
        jstate = jc.update_cache_state(jstate, jnp.asarray(warm))
    return jc.cache_populate(jstate, [jnp.asarray(c) for c in _cores()], P,
                             Q, RANKS)


def _fused_native(name, mode):
    cores = _cores()
    jcores = [jnp.asarray(c) for c in cores]
    jstate = jopt.native_optim_init(J.OptimType(name), jcores)
    jcache = _cache(name) if mode != "plain" else None
    kw = dict(use_cache=mode != "plain", probe_cache=mode == "probing")
    jstep = j_make_step(P, Q, RANKS, 1, 8, optimizer=J.OptimType(name),
                        optim_semantics="native", **kw)
    tstep = T.make_fused_train_step(P, Q, RANKS, 1, 8,
                                    optimizer=T.OptimType(name),
                                    optim_semantics="native", device="cpu",
                                    **kw)
    jparams = J.TTEmbeddingParams(tuple(jcores), tuple(jstate), jcache)
    params = T.params_from_jax(cores, [np.asarray(s) for s in jstate],
                               device="cpu", cache=jcache)
    for idx, offs, d_out, w in _batches(7, zipf=mode == "probing"):
        jout, jparams = jstep(jparams, jnp.asarray(idx), jnp.asarray(offs),
                              jnp.asarray(d_out),
                              (jnp.float32(LR), jnp.float32(EPS)),
                              jnp.asarray(w))
        out, params = tstep(params, idx, offs, d_out, (LR, EPS), w)
        np.testing.assert_allclose(_np(out), np.asarray(jout), **STEP)
        _assert_state(params.tt_cores, jparams.tt_cores, STEP)
        _assert_state(params.optimizer_state, jparams.optimizer_state, STEP)
        if jcache is not None:
            for f in ("keys", "freq", "slots"):
                np.testing.assert_array_equal(
                    _np(getattr(params.cache, f)),
                    np.asarray(getattr(jparams.cache, f)), err_msg=f)
            for f in ("weight", "opt_state"):
                np.testing.assert_allclose(
                    _np(getattr(params.cache, f)),
                    np.asarray(getattr(jparams.cache, f)), rtol=1e-5,
                    atol=1e-6, err_msg=f)
    return params


@pytest.mark.parametrize("name", NAMES)
def test_fused_native_step_matches_jax(name):
    _fused_native(name, "plain")


@pytest.mark.parametrize("name", ["adam", "exact_row_wise_adagrad"])
def test_fused_native_step_counting_matches_jax(name):
    params = _fused_native(name, "counting")
    assert int(params.cache.freq.sum()) > 0


@pytest.mark.parametrize("name", ["lamb", "partial_row_wise_adam",
                                  "exact_adagrad"])
def test_fused_native_step_probing_matches_jax(name):
    _fused_native(name, "probing")


@pytest.mark.parametrize("name", ["sgd", "exact_adagrad"])
def test_native_sgd_and_adagrad_equal_reference_bitwise(name):
    cores = _cores()
    results = []
    for semantics in ("reference", "native"):
        step = T.make_fused_train_step(P, Q, RANKS, 1, 8,
                                       optimizer=T.OptimType(name),
                                       optim_semantics=semantics,
                                       device="cpu")
        state = topt.native_optim_init(name, [torch.as_tensor(c)
                                              for c in cores])
        params = T.params_from_jax(cores, [_np(s) for s in state],
                                   device="cpu")
        for idx, offs, d_out, w in _batches(9):
            out, params = step(params, idx, offs, d_out, (LR, EPS), w)
        results.append((out, params))
    (o1, p1), (o2, p2) = results
    assert torch.equal(o1, o2)
    for a, b in zip(p1.tt_cores + p1.optimizer_state,
                    p2.tt_cores + p2.optimizer_state):
        assert torch.equal(a, b)


def _module_pair(name, **kw):
    p, q, r, e, d = tt_test_shapes(3)
    args = dict(num_embeddings=e, embedding_dim=d, tt_p_shapes=p,
                tt_q_shapes=q, tt_ranks=r, weight_dist="uniform",
                learning_rate=0.01, optim_semantics="native", seed=3)
    args.update(kw)
    jm = J.TTEmbeddingBag(optimizer=J.OptimType(name), **args)
    tm = T.TTEmbeddingBag(optimizer=T.OptimType(name), device="cpu", **args)
    return jm, tm


@pytest.mark.parametrize("name", ["adam", "partial_row_wise_lamb",
                                  "lars_sgd", "exact_row_wise_adagrad"])
def test_module_native_matches_jax(name):
    jm, tm = _module_pair(name, use_cache=False)
    _assert_state(tm.optimizer_state, jm.optimizer_state)
    rng = np.random.default_rng(4)
    for _ in range(3):
        idx, offs = generate_sparse_feature(rng, 8, jm.num_embeddings, 4, 2)
        d = rng.normal(size=(8, jm.embedding_dim)).astype(np.float32)
        np.testing.assert_allclose(_np(tm(idx, offs)),
                                   np.asarray(jm(idx, offs)), **STEP)
        jm.backward(jnp.asarray(d))
        assert tm.backward(d) is None
        _assert_state(list(tm.tt_cores), jm.tt_cores, STEP)
        _assert_state(list(tm.optimizer_state), jm.optimizer_state, STEP)


def test_module_native_cached_matches_jax():
    """LAMB on the cores, row-wise Adagrad on the populated cache's rows."""
    jm, tm = _module_pair("lamb", use_cache=True, cache_size=32)
    rng = np.random.default_rng(6)
    for i in range(4):
        idx, offs = generate_sparse_feature(rng, 8, jm.num_embeddings, 4, 2)
        idx = ((rng.zipf(1.2, size=idx.shape[0]) - 1)
               % jm.num_embeddings).astype(np.int64)
        d = rng.normal(size=(8, jm.embedding_dim)).astype(np.float32)
        np.testing.assert_allclose(_np(tm(idx, offs)),
                                   np.asarray(jm(idx, offs)), **STEP)
        jm.backward(jnp.asarray(d))
        tm.backward(d)
        if i == 1:
            jm.cache_populate()
            tm.cache_populate()
    assert tm.cache_hit_rate() == pytest.approx(jm.cache_hit_rate())
    assert tm.cache_hit_rate() > 0
    _assert_state(list(tm.tt_cores), jm.tt_cores, STEP)
    _assert_state(list(tm.optimizer_state), jm.optimizer_state, STEP)
    for f in ("freq", "slots"):
        np.testing.assert_array_equal(_np(getattr(tm.cache, f)),
                                      np.asarray(getattr(jm.cache, f)))
    np.testing.assert_allclose(_np(tm.cache.weight),
                               np.asarray(jm.cache.weight), rtol=1e-5,
                               atol=1e-6)


def test_native_state_dict_from_jax_and_back():
    jm, tm = _module_pair("adam", use_cache=False)
    rng = np.random.default_rng(8)
    idx, offs = generate_sparse_feature(rng, 8, jm.num_embeddings, 4, 2)
    jm(idx, offs)
    jm.backward(jnp.asarray(rng.normal(size=(8, jm.embedding_dim)),
                            jnp.float32))
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    n = jm.tt_ndim
    assert len([k for k in state if k.startswith("optimizer_state.")]) \
        == 2 * n + 1
    tm.load_state_dict(state)
    counter = tm.optimizer_state[2 * n]
    assert counter.dim() == 0 and counter.dtype == torch.int32
    assert int(counter) == 1
    back = tm.state_dict()
    assert list(back) == list(state)
    for k, v in state.items():
        np.testing.assert_array_equal(_np(back[k]), v, err_msg=k)
        assert _np(back[k]).dtype == v.dtype, k
    jm2, _ = _module_pair("adam", use_cache=False, seed=11)
    jm2.load_state_dict({k: _np(v) for k, v in back.items()})
    # both take the same next step from the carried state
    idx, offs = generate_sparse_feature(rng, 8, jm.num_embeddings, 4, 2)
    d = rng.normal(size=(8, jm.embedding_dim)).astype(np.float32)
    for m in (jm2, tm):
        m(idx, offs)
    jm2.backward(jnp.asarray(d))
    tm.backward(d)
    _assert_state(list(tm.tt_cores), jm2.tt_cores, STEP)
    assert int(tm.optimizer_state[2 * n]) == int(jm2.optimizer_state[2 * n]) \
        == 2


def test_native_counter_through_params_load_and_import():
    _, tm = _module_pair("partial_row_wise_adam", use_cache=False)
    n = tm.tt_ndim
    rng = np.random.default_rng(12)
    idx, offs = generate_sparse_feature(rng, 8, tm.num_embeddings, 4, 2)
    tm(idx, offs)
    tm.backward(rng.normal(size=(8, tm.embedding_dim)).astype(np.float32))
    # params_from_jax copies the 0-d int32 counter as it is
    prm = T.params_from_jax([_np(c) for c in tm.tt_cores],
                            [_np(s) for s in tm.optimizer_state],
                            device="cpu")
    c = prm.optimizer_state[2 * n]
    assert c.dim() == 0 and c.dtype == torch.int32 and int(c) == 1
    _, tm2 = _module_pair("partial_row_wise_adam", use_cache=False, seed=9)
    tm2.load_params(prm)
    c2 = tm2.optimizer_state[2 * n]
    assert c2.dtype == torch.int32 and int(c2) == 1
    assert c2.data_ptr() != c.data_ptr()
    # import_full_weight zeroes the table's moments, not the counter
    tm2.import_full_weight(np.asarray(
        rng.normal(size=(tm2.num_embeddings, tm2.embedding_dim)),
        np.float32))
    assert int(tm2.optimizer_state[2 * n]) == 1
    assert not tm2.optimizer_state[0].abs().max() and \
        not tm2.optimizer_state[n].abs().max()
