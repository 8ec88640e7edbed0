"""PyTorch port vs the JAX package: the LFU cache (CPU).

- ``hash_keys`` bit for bit (negative ids, large ids, ``EMPTY_KEY``);
- ``update_cache_state`` keys / freq / slots exactly, direct and hashed,
  with duplicates, ``-1`` pads, out-of-range ids, ``scale=3`` and a small
  hash table that forces collisions and the second claim round;
- ``cache_lookup`` and ``populate_plan`` exactly (tied counts included),
  the rows of ``cache_populate`` at 1e-5, chunked or not;
  ``preprocess_indices`` exactly;
- ``cache_forward`` and the four cache backwards at 1e-6, with and
  without weights;
- the cached fused step (``use_cache``, ``probe_cache``) against JAX's CPU
  step over three steps at rtol 1e-4, cores, optimizer state and cache
  compared: flat pipeline, ``impl="pallas"`` and ``impl="xla"``; SGD,
  ``EXACT_ADAGRAD`` and a row-wise optimizer; ``count=False`` and
  ``count_interval``; a hashed cache;
- cache-probing serving against JAX's;
- ``params_from_jax`` with a cache (a wide-key one too), and a fresh
  process that trains with a cache, and counts into a wide-key one, without
  importing JAX.
"""

import os
import subprocess
import sys
from pathlib import Path

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
from fbtt_embedding_tpu.ops import cache as jc
from fbtt_embedding_tpu_torch import (
    OptimType,
    init_tt_cores,
    make_fused_train_step,
    make_serving_fn,
    params_from_jax,
)
from fbtt_embedding_tpu_torch.ops import cache as tc

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("keys", "freq", "slots", "weight", "opt_state")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_state(jstate):
    """The JAX state's arrays as a port state (copies)."""
    return tc.CacheState(*(torch.tensor(np.asarray(getattr(jstate, f)))
                           for f in FIELDS))


def _assert_state(state, jstate, exact=("keys", "freq", "slots"), tol=1e-6):
    for f in FIELDS:
        got, want = getattr(state, f).numpy(), np.asarray(getattr(jstate, f))
        assert got.shape == want.shape, f
        if f in exact:
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                       err_msg=f)


def test_hash_keys_bit_for_bit():
    rng = np.random.default_rng(0)
    keys = np.concatenate([
        [jc.EMPTY_KEY, -2, -(2 ** 31), 0, 1, 2 ** 31 - 1, 2 ** 30 + 7],
        rng.integers(-(2 ** 31), 2 ** 31, size=2000)]).astype(np.int32)
    for size in (1, 7, 64, 1000, 2 ** 20 + 3, 2 ** 31 - 1):
        want = np.asarray(jc.hash_keys(jnp.asarray(keys), size))
        got = tc.hash_keys(torch.as_tensor(keys), size)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


E_SMALL = 500


def _count_batches(seed, mode):
    """Three batches of ids: Zipf duplicates, -1 pads and (direct mode)
    ids past the table."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        idx = (rng.zipf(1.3, size=300) - 1) % E_SMALL
        idx[rng.random(300) < 0.05] = -1
        if mode == "direct":
            idx[rng.random(300) < 0.03] = E_SMALL + 17
        out.append(idx.astype(np.int32))
    return out


# (name, hashtbl_size, num_embeddings): direct, a roomy hash table, and one
# smaller than the distinct ids (collisions, second round, dropped ids)
COUNT_MODES = [("direct", E_SMALL, E_SMALL), ("hashed", 2048, None),
               ("hashed_small", 64, None)]


@pytest.mark.parametrize("scale", [1, 3])
@pytest.mark.parametrize("mode,h_size,n_emb", COUNT_MODES)
def test_update_cache_state_matches_jax(mode, h_size, n_emb, scale):
    jstate = jc.make_cache_state(h_size, 16, 8, num_embeddings=n_emb)
    state = tc.make_cache_state(h_size, 16, 8, num_embeddings=n_emb,
                                device="cpu")
    assert state.direct == jstate.direct == (mode == "direct")
    _assert_state(state, jstate)
    for idx in _count_batches(7 + scale, mode):
        jstate = jc.update_cache_state(jstate, jnp.asarray(idx),
                                       scale=scale)
        got = tc.update_cache_state(state, torch.as_tensor(idx),
                                    scale=scale)
        assert got is state  # in place
        _assert_state(state, jstate)
    if mode == "hashed_small":  # the table filled up and dropped ids
        assert (state.keys != tc.EMPTY_KEY).all()


@pytest.mark.parametrize("mode,h_size,n_emb", COUNT_MODES)
def test_lookup_and_populate_match_jax(mode, h_size, n_emb):
    p, q, r = [5, 10, 10], [2, 2, 2], [1, 4, 4, 1]
    cores = init_tt_cores(np.random.default_rng(3), "uniform", 1, E_SMALL,
                          8, p, q, r)
    jstate = jc.make_cache_state(h_size, 24, 8, "rowwise",
                                 num_embeddings=n_emb)
    # tied counts: ids 0..39 once each, 40..49 twice
    ties = np.concatenate([np.arange(40), np.repeat(np.arange(40, 50), 2)])
    for idx in [ties.astype(np.int32)] + _count_batches(5, mode)[:1]:
        jstate = jc.update_cache_state(jstate, jnp.asarray(idx))
    state = _port_state(jstate)
    want = jc.populate_plan(jstate)
    got = tc.populate_plan(state)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jnew = jc.cache_populate(jstate, [jnp.asarray(c) for c in cores], p, q,
                             r)
    tcores = [torch.as_tensor(c) for c in cores]
    new = tc.cache_populate(state, tcores, p, q, r)
    _assert_state(new, jnew, tol=1e-5)
    chunked = tc.cache_populate(state, tcores, p, q, r, populate_chunk=5)
    for f in FIELDS:
        assert torch.equal(getattr(chunked, f), getattr(new, f))
    probe = np.concatenate([np.arange(-3, 60), [E_SMALL + 5, 2 ** 31 - 1]])
    probe = probe.astype(np.int32)
    want_loc = np.asarray(jc.cache_lookup(jnew, jnp.asarray(probe)))
    got_loc = tc.cache_lookup(new, torch.as_tensor(probe))
    assert (want_loc >= 0).sum() > 10  # hits and misses both
    np.testing.assert_array_equal(got_loc.numpy(), want_loc)
    tc.reset_cache(new)
    jreset = jc.reset_cache(jnew)
    _assert_state(new, jreset, tol=1e-5)


def test_preprocess_indices_matches_jax():
    """Locations probe the cache only with one table, out of warmup."""
    jstate = jc.make_cache_state(E_SMALL, 24, 8, num_embeddings=E_SMALL)
    for idx in _count_batches(4, "direct"):
        jstate = jc.update_cache_state(jstate, jnp.asarray(idx))
    jstate = jc.cache_populate(jstate, init_tt_cores(
        np.random.default_rng(3), "uniform", 1, E_SMALL, 8, [5, 10, 10],
        [2, 2, 2], [1, 4, 4, 1]), [5, 10, 10], [2, 2, 2], [1, 4, 4, 1])
    state = _port_state(jstate)
    idx = _count_batches(9, "direct")[0][:40]
    offs = np.arange(0, 41, 5, dtype=np.int32)
    for tables, warmup, with_cache in [(1, False, True), (1, True, True),
                                       (1, False, False), (2, False, True)]:
        want = jc.preprocess_indices(jnp.asarray(idx), jnp.asarray(offs),
                                     tables, 8 // tables, warmup,
                                     jstate if with_cache else None)
        got = tc.preprocess_indices(torch.as_tensor(idx),
                                    torch.as_tensor(offs), tables,
                                    8 // tables, warmup,
                                    state if with_cache else None)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        hits = int((got[3] >= 0).sum())
        assert hits > 0 if (tables, warmup, with_cache) == (1, False, True) \
            else hits == 0


def _row_grad_case(weighted, seed=2):
    rng = np.random.default_rng(seed)
    c, d, b, nnz = 12, 8, 6, 40
    jstate = jc.make_cache_state(64, c, d, "full")
    jstate = jstate.replace(
        weight=jnp.asarray(rng.normal(size=(c, d)).astype(np.float32)),
        opt_state=jnp.asarray(rng.random((c, d)).astype(np.float32)))
    loc = rng.integers(-1, c, size=nnz).astype(np.int32)
    loc[::7] = 3  # a row hit many times
    rowidx = rng.integers(0, b, size=nnz).astype(np.int32)
    d_out = rng.normal(size=(1, b, d)).astype(np.float32)
    w = rng.random(nnz).astype(np.float32) if weighted else None
    return jstate, loc, rowidx, d_out, w, b


def _tj(a):
    return None if a is None else (torch.as_tensor(a), jnp.asarray(a))


@pytest.mark.parametrize("weighted", [False, True])
def test_cache_forward_and_backwards_match_jax(weighted):
    jstate, loc, rowidx, d_out, w, b = _row_grad_case(weighted)
    tl, jl = _tj(loc)
    tr, jr = _tj(rowidx)
    td, jd = _tj(d_out)
    tw, jw = _tj(w) if w is not None else (None, None)
    tight = dict(rtol=1e-6, atol=1e-6)
    out0 = np.random.default_rng(0).normal(size=(1, b, 8)).astype(np.float32)
    want = jc.cache_forward(jstate, jl, jr, b, jnp.asarray(out0))
    got = tc.cache_forward(_port_state(jstate), tl, tr, b,
                           torch.as_tensor(out0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tight)
    want = jc.cache_backward_dense(jstate, jd, jl, jr, weights=jw)
    got = tc.cache_backward_dense(_port_state(jstate), td, tl, tr,
                                  weights=tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tight)
    jnew = jc.cache_backward_sgd(jstate, jd, jl, jr, 0.1, weights=jw)
    new = tc.cache_backward_sgd(_port_state(jstate), td, tl, tr, 0.1,
                                weights=tw)
    _assert_state(new, jnew)
    jnew = jc.cache_backward_adagrad(jstate, jd, jl, jr, 0.1, 1e-2,
                                     weights=jw)
    new = tc.cache_backward_adagrad(_port_state(jstate), td, tl, tr, 0.1,
                                    1e-2, weights=tw)
    _assert_state(new, jnew)
    jrow = jstate.replace(opt_state=jnp.asarray(
        np.random.default_rng(1).random(12).astype(np.float32)))
    jnew = jc.cache_backward_rowwise_adagrad_approx(jrow, jd, jl, jr, 0.1,
                                                    1e-2, weights=jw)
    new = tc.cache_backward_rowwise_adagrad_approx(
        _port_state(jrow), td, tl, tr, 0.1, 1e-2, weights=tw)
    _assert_state(new, jnew)
    with pytest.raises(ValueError):  # rowwise update on full state
        tc.cache_backward_rowwise_adagrad_approx(_port_state(jstate), td, tl,
                                                 tr, 0.1, 1e-2)
    with pytest.raises(ValueError):  # full update on rowwise state
        tc.cache_backward_adagrad(_port_state(jrow), td, tl, tr, 0.1, 1e-2)


P, Q, RANKS = [10, 11, 12], [2, 2, 2], [1, 8, 8, 1]
E, D = 10 * 11 * 12, 8
STEP_LR, STEP_EPS = 0.05, 1e-3


def _cached_setup(optimizer, h_size=E, seed=11, b=8, pool=4):
    """Cores, a JAX cache counted on Zipf traffic and populated, and three
    Zipf batches with weights (the JAX test setup of a populated cache)."""
    rng = np.random.default_rng(seed)
    cores = init_tt_cores(rng, "uniform", 1, E, D, P, Q, RANKS)
    kind = ("full" if optimizer == "EXACT_ADAGRAD" else
            "none" if optimizer == "SGD" else "rowwise")
    jstate = jc.make_cache_state(h_size, 64, D, kind,
                                 num_embeddings=E if h_size >= E else None)
    for _ in range(3):
        warm = ((rng.zipf(1.2, size=200) - 1) % E).astype(np.int32)
        jstate = jc.update_cache_state(jstate, jnp.asarray(warm))
    jstate = jc.cache_populate(jstate, [jnp.asarray(c) for c in cores], P, Q,
                               RANKS)
    opt_state = ([] if optimizer == "SGD"
                 else [np.zeros_like(c) for c in cores])
    batches = []
    for _ in range(3):
        idx = ((rng.zipf(1.2, size=b * pool) - 1) % E).astype(np.int32)
        offs = np.arange(0, b * pool + 1, pool, dtype=np.int32)
        batches.append((idx, offs,
                        rng.normal(size=(1, b, D)).astype(np.float32),
                        rng.random(b * pool).astype(np.float32)))
    return cores, opt_state, jstate, batches, b


def _run_cached_steps(optimizer, impl, h_size=E, counts=(True,) * 3,
                      count_interval=1):
    cores, opt_state, jstate, batches, b = _cached_setup(optimizer, h_size)
    jparams = JParams(tuple(jnp.asarray(c) for c in cores),
                      tuple(jnp.asarray(s) for s in opt_state), jstate)
    params = params_from_jax(cores, opt_state, device="cpu", cache=jstate)
    kw = dict(use_cache=True, probe_cache=True,
              count_interval=count_interval)
    jstep = j_make_step(P, Q, RANKS, 1, b,
                        optimizer=getattr(JOptimType, optimizer), **kw)
    tstep = make_fused_train_step(P, Q, RANKS, 1, b,
                                  optimizer=getattr(OptimType, optimizer),
                                  impl=impl, device="cpu", **kw)
    hits = 0
    for (idx, offs, d_out, w), count in zip(batches, counts):
        hits += int((np.asarray(jc.cache_lookup(
            jparams.cache, jnp.asarray(idx))) >= 0).sum())
        jout, jparams = jstep(jparams, jnp.asarray(idx), jnp.asarray(offs),
                              jnp.asarray(d_out),
                              (jnp.float32(STEP_LR), jnp.float32(STEP_EPS)),
                              jnp.asarray(w), count=count)
        out, params = tstep(params, idx, offs, d_out, (STEP_LR, STEP_EPS),
                            w, count=count)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                                   atol=1e-5)
        for a, b_ in zip(list(params.tt_cores) + list(params.optimizer_state),
                         list(jparams.tt_cores)
                         + list(jparams.optimizer_state)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-4,
                                       atol=1e-5)
        _assert_state(params.cache, jparams.cache, tol=1e-5)
    assert hits > 0  # the cache served part of every run
    return params, jparams


@pytest.mark.parametrize("optimizer",
                         ["SGD", "EXACT_ADAGRAD", "EXACT_ROWWISE_ADAGRAD"])
@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_cached_fused_step_matches_jax(impl, optimizer):
    _run_cached_steps(optimizer, impl)


def test_cached_fused_step_hashed_cache_matches_jax():
    _run_cached_steps("SGD", "auto", h_size=512)


def test_cached_fused_step_sampled_counting():
    """``count=False`` skips the count; ``count_interval=3`` scales it."""
    params, _ = _run_cached_steps("SGD", "auto", counts=(True, False, True),
                                  count_interval=3)
    _, _, jstate, batches, _ = _cached_setup("SGD")
    counted = np.concatenate([batches[0][0], batches[2][0]])
    want = np.asarray(jstate.freq) + 3 * np.bincount(counted, minlength=E)
    np.testing.assert_array_equal(params.cache.freq.numpy(), want)


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_cache_probing_serve_matches_jax(impl):
    cores, _, jstate, batches, b = _cached_setup("SGD")
    jparams = JParams(tuple(jnp.asarray(c) for c in cores), (), jstate)
    params = params_from_jax(cores, device="cpu", cache=jstate)
    jserve = j_make_serving_fn(P, Q, RANKS, 1, b, probe_cache=True)
    serve = make_serving_fn(P, Q, RANKS, 1, b, impl=impl, device="cpu")
    for idx, offs, _, w in batches:
        for wts in (None, w):
            want = jserve(jparams, jnp.asarray(idx), jnp.asarray(offs),
                          None if wts is None else jnp.asarray(wts))
            got = serve(params, idx, offs, wts)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)


def test_params_from_jax_with_a_cache():
    cores, _, jstate, _, _ = _cached_setup("EXACT_ADAGRAD")
    params = params_from_jax(cores, device="cpu", cache=jstate)
    _assert_state(params.cache, jstate, exact=FIELDS)
    assert params.cache.direct and params.cache.cache_size == 64
    as_dict = params_from_jax(cores, device="cpu", cache={
        f: np.asarray(getattr(jstate, f)) for f in FIELDS})
    _assert_state(as_dict.cache, jstate, exact=FIELDS)
    params.cache.freq += 1  # copies: the source arrays do not move
    assert not np.array_equal(params.cache.freq.numpy(),
                              np.asarray(jstate.freq))
    wide = jc.make_cache_state(64, 4, D, wide_keys=3)
    got = params_from_jax(cores, device="cpu", cache=wide)
    _assert_state(got.cache, wide, exact=FIELDS)
    assert got.cache.wide and not got.cache.direct


def test_port_cache_trains_without_jax():
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "import fbtt_embedding_tpu_torch as m\n"
        "from fbtt_embedding_tpu_torch.ops import cache, hot_scatter\n"
        "from fbtt_embedding_tpu_torch.utils import knobs\n"
        "from fbtt_embedding_tpu_torch.ops.kernels import seg_accum_dg0\n"
        "p, q, r = [20, 22, 25], [4, 4, 4], [1, 8, 8, 1]\n"
        "cores = m.init_tt_cores(np.random.default_rng(0), 'uniform', 1,"
        " 11000, 64, p, q, r)\n"
        "c = m.make_cache_state(11000, 32, 64, num_embeddings=11000,"
        " device='cpu')\n"
        "params = m.params_from_jax(cores, device='cpu')\n"
        "params.cache = c\n"
        "rng = np.random.default_rng(1)\n"
        "step = m.make_fused_train_step(p, q, r, 1, 8, use_cache=True,"
        " probe_cache=True, device='cpu')\n"
        "for i in range(3):\n"
        "    idx = (rng.zipf(1.2, 16) - 1) % 11000\n"
        "    out, params = step(params, idx, np.arange(0, 17, 2),"
        " rng.normal(size=(1, 8, 64)), (0.01, 0.1))\n"
        "    if i == 0:\n"
        "        params.cache = m.cache_populate(params.cache,"
        " params.tt_cores, p, q, r)\n"
        "assert out.shape == (1, 8, 64) and int(params.cache.freq.sum()) > 0\n"
        "pw = [1300, 1300, 1300]\n"
        "wide = m.make_cache_state(256, 8, 64, wide_keys=3, device='cpu')\n"
        "ids = np.array([5, 2**31 + 7, 5, 2**31 + 7, -1], np.int64)\n"
        "m.update_cache_state(wide, torch.as_tensor(m.wide_keyrows(ids,"
        " pw)))\n"
        "assert int(wide.freq.sum()) == 4 and int(wide.freq.max()) == 2\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'"
        " or k.startswith('jax.') or k.startswith('fbtt_embedding_tpu.')"
        " or k == 'fbtt_embedding_tpu')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["FBTT_DG0"] = "fused"
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
