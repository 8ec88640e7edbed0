"""PyTorch port vs the JAX package: the rest of the multi-GPU layer (CPU,
gloo worlds).

The data-parallel serve (folded, int8, not folded, wide key rows), the
replicated-cache lookup, the table-owned fused step and the row-owned cache
family (the owner-major layout, lookup, populate and step), each on
``tests/test_sharding.py``'s cases. As in ``test_torch_port_parallel.py``
(whose launcher this module reuses), the port runs as gloo worlds of 2 and
4 CPU processes (``examples.multihost_smoke --inputs``), launched once for
the module with every case in one file, and JAX runs the same cases on its
CPU mesh of the same shape (the first 2 or 4 of its 8 devices). Every
rank's result is its block; the blocks are assembled here.

Tolerances are the JAX tests' own: outputs and updates rtol 1e-5 (the
float32 plain versions, only the summation order differs), the int8 serve
within 0.015 x max|out|, counts and keys exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fbtt_embedding_tpu.models.tt_embedding import (
    OptimType,
    TTEmbeddingParams,
)
from fbtt_embedding_tpu.ops import cache as jc
from fbtt_embedding_tpu.ops.fused_optim import native_optim_init
from fbtt_embedding_tpu.parallel.sharded import (
    make_dp_cached_lookup as j_dp_cached,
    make_dp_serving_fn as j_dp_serving,
    make_row_owned_cached_lookup as j_owned_lookup,
    make_row_owned_fused_train_step as j_owned_step,
    make_row_owned_populate as j_owned_populate,
    make_table_sharded_fused_train_step as j_table_step,
    shard_cache_weight_by_owner as j_by_owner,
    shard_table_sharded_params as j_shard_table,
)
from fbtt_embedding_tpu.utils.init import init_tt_cores
from test_torch_port_parallel import (
    D,
    E,
    LR_EPS,
    OUT,
    P,
    P_BIG,
    Q,
    R,
    UPD,
    _cat,
    _cores,
    _jmesh,
    _same_on_every_rank,
    _seq,
    _World,
)

Q16, D16 = [4, 2, 2], 16
CACHE_FIELDS = ("keys", "freq", "slots", "weight", "opt_state")


def _put_cache(arrays, name, cache, field="cache"):
    _seq(arrays, name, field, [np.asarray(getattr(cache, f))
                               for f in CACHE_FIELDS])


def _counted(cores, p, q, kind, cache_size, hot, hashtbl_size=E, d=D,
             populate=True, **kw):
    """A JAX cache (``d`` wide) counted on ``hot``, populated from
    ``cores`` where ``populate``."""
    cache = jc.make_cache_state(hashtbl_size, cache_size, d, kind, **kw)
    cache = jc.update_cache_state(cache, jnp.asarray(hot))
    if populate:
        cache = jc.cache_populate(cache, tuple(jnp.asarray(c) for c in cores),
                                  p, q, R)
    return cache


def _jcores(cores):
    return tuple(jnp.asarray(c) for c in cores)


# ------------------------------------------------------------- the cases

def _row_owned_lookup_case():
    """``test_row_owned_cached_lookup_matches_uncached``."""
    e, c, b, length = 512, 64, 16, 4
    rng = np.random.default_rng(7)
    cores = [np.asarray(x, np.float32) for x in init_tt_cores(
        rng, "uniform", 1, e, D16, P, Q16, R)]
    cache = _counted(cores, P, Q16, "none", c,
                     np.tile(np.arange(c), 5).astype(np.int32), d=D16,
                     num_embeddings=e)
    idx = np.where(rng.random((1, b, length)) < 0.6,
                   rng.integers(0, c, size=(1, b, length)),
                   rng.integers(0, e, size=(1, b, length))).astype(np.int32)
    arrays = {"owned_lookup/indices": idx}
    _seq(arrays, "owned_lookup", "cores", cores)
    _put_cache(arrays, "owned_lookup", cache)
    return dict(name="owned_lookup", kind="row_owned_lookup", mesh=None,
                axes=["dp"], p=P, q=Q16, r=R, C=c), arrays


def _dp_cached_case():
    """``test_dp_cached_lookup_matches_uncached``: the cache of table 0,
    a one-table lookup."""
    e, b, length = 512, 16, 4
    rng = np.random.default_rng(0)
    cores = [np.asarray(x, np.float32) for x in init_tt_cores(
        rng, "uniform", 2, e, D16, P, Q16, R)]
    cores1 = [x[0:1] for x in cores]
    cache = _counted(cores1, P, Q16, "none", 32,
                     np.tile(np.arange(32), 10).astype(np.int32), d=D16,
                     num_embeddings=e)
    idx = rng.integers(0, 64, size=(1, b, length)).astype(np.int32)
    arrays = {"dp_cached/indices": idx}
    _seq(arrays, "dp_cached", "cores", cores1)
    _put_cache(arrays, "dp_cached", cache)
    return dict(name="dp_cached", kind="dp_cached_lookup", mesh=None,
                axes=["dp"], p=P, q=Q16, r=R), arrays


SERVE_B, SERVE_L = 64, 4


def _serve_inputs(seed):
    """``test_dp_serving_matches_local``'s params (seeds 11 and 13) and
    requests."""
    cores, rng = _cores(1, seed)
    cache = _counted(cores, P, Q, "none", 32,
                     np.tile(np.arange(32), 8).astype(np.int32),
                     num_embeddings=E)
    nnz = SERVE_B * SERVE_L
    idx = np.where(rng.random(nnz) < 0.5, rng.integers(0, 32, size=nnz),
                   rng.integers(0, E, size=nnz)).astype(np.int32)
    w = rng.random(nnz).astype(np.float32)
    return cores, cache, idx.reshape(1, SERVE_B, SERVE_L), \
        w.reshape(1, SERVE_B, SERVE_L)


def _serve_cases():
    out = []
    for name, seed, folded, quantize in (
            ("serve_folded", 11, True, None),
            ("serve_unfolded", 11, False, None),
            ("serve_int8", 13, True, "int8"),
            ("serve_exact", 13, True, None)):
        cores, cache, idx, w = _serve_inputs(seed)
        arrays = {f"{name}/indices": idx, f"{name}/weights": w}
        _seq(arrays, name, "cores", cores)
        _put_cache(arrays, name, cache)
        calls = [{"weights": False}] if seed == 13 else [
            {"weights": True}, {"weights": False}]
        out.append((dict(name=name, kind="dp_serve", mesh=None, axes=["dp"],
                         p=P, q=Q, r=R, T=1, B=SERVE_B, L=SERVE_L,
                         folded=folded, quantize=quantize, calls=calls),
                    arrays))
    return out


WIDE_B = 16


def _wide_serve_inputs():
    """``test_dp_serving_wide_keys_big_e``."""
    e_big = int(np.prod(P_BIG))
    nnz = WIDE_B * SERVE_L
    rng = np.random.default_rng(71)
    cores = [np.asarray(c, np.float32) for c in init_tt_cores(
        rng, "uniform", 1, e_big, D, P_BIG, Q, R)]
    cache = jc.make_cache_state(256, 8, D, "none", wide_keys=3)
    hot = rng.integers(2**31, e_big, size=4, dtype=np.int64)
    cache = jc.update_cache_state(cache, jc.wide_cache_keys(np.tile(hot, 8),
                                                            P_BIG))
    cache = jc.cache_populate(cache, _jcores(cores), P_BIG, Q, R)
    ids = np.where(rng.random(nnz) < 0.5, hot[rng.integers(0, 4, size=nnz)],
                   rng.integers(0, e_big, size=nnz, dtype=np.int64))
    keyrows = np.asarray(jc.wide_cache_keys(ids, P_BIG))
    return cores, cache, keyrows.reshape(1, WIDE_B, SERVE_L, -1)


def _wide_serve_case():
    cores, cache, keyrows = _wide_serve_inputs()
    arrays = {"serve_wide/indices": keyrows}
    _seq(arrays, "serve_wide", "cores", cores)
    _put_cache(arrays, "serve_wide", cache)
    return dict(name="serve_wide", kind="dp_serve", mesh=None, axes=["dp"],
                p=P_BIG, q=Q, r=R, T=1, B=WIDE_B, L=SERVE_L, folded=False,
                calls=[{"weights": False}]), arrays


TABLE_T, TABLE_B, TABLE_L = 4, 16, 3
TABLE_OPTIMS = {"sgd": ("SGD", "reference"),
                "exact_adagrad": ("EXACT_ADAGRAD", "reference"),
                "adam": ("ADAM", "native"),
                "rowwise": ("EXACT_ROWWISE_ADAGRAD", "native")}


def _table_inputs(optim_name):
    """``test_table_sharded_fused_train_step_matches_single_device``."""
    optim, semantics = TABLE_OPTIMS[optim_name]
    cores, rng = _cores(TABLE_T, 21)
    if semantics == "native":
        opt = [np.asarray(s) for s in native_optim_init(OptimType[optim],
                                                        _jcores(cores))]
    elif optim == "SGD":
        opt = [np.zeros(0, np.float32)] * len(cores)
    else:
        opt = [np.zeros_like(c) for c in cores]
    nnz = TABLE_T * TABLE_B * TABLE_L
    shape = (TABLE_T, TABLE_B, TABLE_L)
    idx = rng.integers(0, E, size=nnz).astype(np.int32).reshape(shape)
    d_out = (rng.normal(size=(TABLE_T, TABLE_B, D)) * 0.1).astype(np.float32)
    w = rng.random(nnz).astype(np.float32).reshape(shape)
    return cores, opt, idx, d_out, w


def _table_case(optim_name, shape):
    name = f"table_{optim_name}_{shape[0]}x{shape[1]}"
    cores, opt, idx, d_out, w = _table_inputs(optim_name)
    arrays = {f"{name}/indices": idx, f"{name}/d_out": d_out,
              f"{name}/weights": w, f"{name}/lr": np.float32(LR_EPS[0]),
              f"{name}/eps": np.float32(LR_EPS[1])}
    _seq(arrays, name, "cores", cores)
    _seq(arrays, name, "opt", opt)
    optim, semantics = TABLE_OPTIMS[optim_name]
    return dict(name=name, kind="table_step", mesh=list(shape), p=P, q=Q,
                r=R, T=TABLE_T, B=TABLE_B, L=TABLE_L, optimizer=optim,
                optim_semantics=semantics), arrays


def _table_cache_case(world):
    """``test_table_sharded_fused_step_rejects_cache``."""
    name = "table_cache"
    cores, _ = _cores(4, 3)
    cache = jc.make_cache_state(E, 8, D, "none", num_embeddings=E)
    arrays = {f"{name}/indices": np.zeros((4, 16, 3), np.int32),
              f"{name}/d_out": np.zeros((4, 16, D), np.float32),
              f"{name}/lr": np.float32(0.1), f"{name}/eps": np.float32(1e-10)}
    _seq(arrays, name, "cores", cores)
    _seq(arrays, name, "opt", [np.zeros(0, np.float32)] * 3)
    _put_cache(arrays, name, cache)
    return dict(name=name, kind="table_step", mesh=[world // 2, 2], p=P,
                q=Q, r=R, T=4, B=16, L=3, optimizer="SGD",
                cache_error=True), arrays


POP_C = 16


def _populate_inputs(mode):
    """``test_row_owned_populate_matches_replicated`` (direct and hashed)
    and the wide layout at p = [1300] * 3."""
    if mode == "wide":
        e_big = int(np.prod(P_BIG))
        rng = np.random.default_rng(53)
        cores = [np.asarray(c, np.float32) for c in init_tt_cores(
            rng, "uniform", 1, e_big, D, P_BIG, Q, R)]
        ids = np.concatenate([np.tile(rng.integers(2**31, e_big, size=24),
                                      6),
                              rng.integers(0, e_big, size=64)])
        cache = jc.update_cache_state(
            jc.make_cache_state(256, POP_C, D, "none", wide_keys=3),
            jc.wide_cache_keys(ids, P_BIG))
        return cores, cache, P_BIG
    cores, rng = _cores(1, 51)
    cache = (jc.make_cache_state(E, POP_C, D, "none", num_embeddings=E)
             if mode == "direct" else
             jc.make_cache_state(128, POP_C, D, "none"))
    traffic = np.concatenate([np.tile(np.arange(24), 6),
                              rng.integers(0, E, 64)]).astype(np.int32)
    return cores, jc.update_cache_state(cache, jnp.asarray(traffic)), P


def _populate_case(mode):
    name = f"populate_{mode}"
    cores, cache, p = _populate_inputs(mode)
    arrays = {}
    _seq(arrays, name, "cores", cores)
    _put_cache(arrays, name, cache)
    return dict(name=name, kind="row_owned_populate", mesh=None,
                axes=["dp"], p=p, q=Q, r=R, C=POP_C,
                opt_kind="rowwise"), arrays


OWNED_B, OWNED_L, OWNED_C = 32, 4, 16
OWNED_OPTIMS = {"sgd": ("SGD", "none"), "rowwise": (
    "EXACT_ROWWISE_ADAGRAD", "rowwise"), "exact_adagrad": (
    "EXACT_ADAGRAD", "full")}


def _owned_step_inputs(optim_name):
    """``test_row_owned_fused_train_step_matches_replicated``."""
    optim, kind = OWNED_OPTIMS[optim_name]
    nnz = OWNED_B * OWNED_L
    cores, rng = _cores(1, 61)
    opt = ([np.zeros(0, np.float32)] * len(cores) if optim == "SGD"
           else [np.zeros_like(c) for c in cores])
    cache = _counted(cores, P, Q, kind, OWNED_C,
                     np.tile(np.arange(24), 8).astype(np.int32),
                     populate=False, num_embeddings=E)
    shape = (1, OWNED_B, OWNED_L)
    idx = np.where(rng.random(nnz) < 0.5, rng.integers(0, 24, size=nnz),
                   rng.integers(0, E, size=nnz)).astype(np.int32)
    d_out = (rng.normal(size=(1, OWNED_B, D)) * 0.1).astype(np.float32)
    w = rng.random(nnz).astype(np.float32).reshape(shape)
    return cores, opt, cache, idx.reshape(shape), d_out, w


def _owned_step_case(optim_name):
    name = f"owned_step_{optim_name}"
    cores, opt, cache, idx, d_out, w = _owned_step_inputs(optim_name)
    arrays = {f"{name}/indices": idx, f"{name}/d_out": d_out,
              f"{name}/weights": w, f"{name}/lr": np.float32(LR_EPS[0]),
              f"{name}/eps": np.float32(LR_EPS[1])}
    _seq(arrays, name, "cores", cores)
    _seq(arrays, name, "opt", opt)
    _put_cache(arrays, name, cache)
    optim, kind = OWNED_OPTIMS[optim_name]
    return dict(name=name, kind="row_owned_step", mesh=None, axes=["dp"],
                p=P, q=Q, r=R, C=OWNED_C, B=OWNED_B, L=OWNED_L,
                optimizer=optim, opt_kind=kind), arrays


def _serve_world_cases(world):
    parts = [_row_owned_lookup_case(), _dp_cached_case(),
             _table_case("sgd", (world // 2, 2)),
             _table_case("adam", (world // 2, 2)), _table_cache_case(world)]
    if world == 4:
        parts += (_serve_cases() + [_wide_serve_case()]
                  + [_table_case(o, (2, 2)) for o in ("exact_adagrad",
                                                      "rowwise")]
                  + [_populate_case(m) for m in ("direct", "hashed", "wide")]
                  + [_owned_step_case(o) for o in OWNED_OPTIMS])
    specs = [dict(name="value_errors", kind="value_errors", mesh=[1, world],
                  p=P, q=Q, r=R)]
    arrays = {}
    for spec, a in parts:
        if spec.get("mesh") is None:
            spec["mesh"] = [world]
        specs.append(spec)
        arrays.update(a)
    return specs, arrays


# ------------------------------------------------------------- the worlds

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds of 2 and 4 ranks running this module's cases, both
    launched at once."""
    made = {n: _World(n, tmp_path_factory.mktemp(f"serve_world{n}"),
                      _serve_world_cases) for n in (2, 4)}
    yield made
    for w in made.values():
        for proc in w.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _owner_major(x, dp):
    """The owner-major layout of a replicated ``[C, ...]`` table, as the
    ranks' blocks concatenate: slot ``s`` at ``(s % dp) * C / dp + s //
    dp``."""
    c = x.shape[0]
    return np.asarray(x)[np.arange(c).reshape(c // dp, dp).T.reshape(c)]


# ------------------------------------------------------------- the tests

def test_workers_import_only_the_port(worlds):
    for n in (2, 4):
        logs, ranks = worlds[n].result()
        for rc, out, err in logs:
            assert "MULTIHOST_OK" in out, (out, err[-2000:])
        for r in ranks:
            assert int(r["__worker__/jax_imported"]) == 0


@pytest.mark.parametrize("world", [2, 4])
def test_row_owned_cached_lookup_matches_jax(worlds, world):
    """``test_row_owned_cached_lookup_matches_uncached``: the owner-major
    rows round-trip against JAX's ``shard_cache_weight_by_owner`` and the
    owned lookup equals JAX's (and so its plain dp lookup)."""
    ranks = worlds[world].ranks()
    spec, arrays = _row_owned_lookup_case()
    mesh = _jmesh((world,), ("dp",))
    cores = [arrays[f"owned_lookup/cores/{i}"] for i in range(3)]
    weight = arrays["owned_lookup/cache/3"]
    slots = arrays["owned_lookup/cache/2"]
    w_owned = np.asarray(j_by_owner(mesh, jnp.asarray(weight)))
    np.testing.assert_array_equal(_cat(ranks, "owned_lookup/w_owned", 0),
                                  w_owned)
    np.testing.assert_array_equal(w_owned, _owner_major(weight, world))
    fn = j_owned_lookup(mesh, P, Q16, R, cache_size=spec["C"])
    want = fn(_jcores(cores), jnp.asarray(slots), jnp.asarray(w_owned),
              jnp.asarray(arrays["owned_lookup/indices"]))
    np.testing.assert_allclose(_cat(ranks, "owned_lookup/out"),
                               np.asarray(want), **OUT)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_cached_lookup_matches_jax(worlds, world):
    ranks = worlds[world].ranks()
    _, arrays = _dp_cached_case()
    cores = [arrays[f"dp_cached/cores/{i}"] for i in range(3)]
    cache = jc.CacheState(*(jnp.asarray(arrays[f"dp_cached/cache/{i}"])
                            for i in range(5)))
    fn = j_dp_cached(_jmesh((world,), ("dp",)), P, Q16, R)
    want = fn(_jcores(cores), cache, jnp.asarray(arrays["dp_cached/indices"]))
    np.testing.assert_allclose(_cat(ranks, "dp_cached/out"),
                               np.asarray(want), **OUT)


def _j_serve(world, cores, cache, idx, w, folded, quantize=None, p=P,
             b=SERVE_B):
    fold, serve = j_dp_serving(
        _jmesh((world,), ("dp",)), p, Q, R, 1, b, SERVE_L, probe_cache=True,
        folded=folded, interpret=folded, quantize=quantize)
    fp = fold(TTEmbeddingParams(_jcores(cores),
                                tuple(jnp.zeros((0,)) for _ in cores), cache))
    return np.asarray(serve(fp, jnp.asarray(idx),
                            None if w is None else jnp.asarray(w)))


@pytest.mark.parametrize("folded", [True, False])
def test_dp_serving_matches_jax(worlds, folded):
    """``test_dp_serving_matches_local``: weighted and unweighted
    requests, cache hits included."""
    ranks = worlds[4].ranks()
    name = "serve_folded" if folded else "serve_unfolded"
    cores, cache, idx, w = _serve_inputs(11)
    assert int(_same_on_every_rank(ranks, f"{name}/flat_mode")) == folded
    for k, weights in enumerate((w, None)):
        want = _j_serve(4, cores, cache, idx, weights, folded)
        np.testing.assert_allclose(_cat(ranks, f"{name}/{k}/out"), want,
                                   **OUT)


def test_dp_serving_quantized_close_to_exact(worlds):
    """``test_dp_serving_quantized_close_to_exact``: the int8 fold's cache
    rows are int8, and its serve lies within 0.015 x max|out| of the exact
    dp serve (the port's and JAX's) and of JAX's int8 serve."""
    ranks = worlds[4].ranks()
    cores, cache, idx, _ = _serve_inputs(13)
    assert int(_same_on_every_rank(ranks, "serve_int8/cache_int8")) == 1
    got = _cat(ranks, "serve_int8/0/out")
    exact = _cat(ranks, "serve_exact/0/out")
    want = _j_serve(4, cores, cache, idx, None, True)
    np.testing.assert_allclose(exact, want, **OUT)
    scale = float(np.abs(want).max())
    for ref in (exact, want, _j_serve(4, cores, cache, idx, None, True,
                                      "int8")):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=0.015 * scale + 1e-6)


def test_dp_serving_wide_keys_matches_jax(worlds):
    """``test_dp_serving_wide_keys_big_e``: wide key rows past 2^31 through
    the unfolded dp serve and a wide-key cache."""
    ranks = worlds[4].ranks()
    cores, cache, keyrows = _wide_serve_inputs()
    want = _j_serve(4, cores, cache, keyrows, None, False, p=P_BIG,
                    b=WIDE_B)
    np.testing.assert_allclose(_cat(ranks, "serve_wide/0/out"), want, **OUT)


@pytest.mark.parametrize("optim_name,world", [
    ("sgd", 4), ("exact_adagrad", 4), ("adam", 4), ("rowwise", 4),
    ("sgd", 2), ("adam", 2)])
def test_table_sharded_fused_step_matches_jax(worlds, optim_name, world):
    """``test_table_sharded_fused_train_step_matches_single_device`` at
    (dp, mp) = (2, 2) and (1, 2): each rank's output block, owned cores and
    owned optimizer state against JAX's step on the same mesh shape."""
    ranks = worlds[world].ranks()
    shape = (world // 2, 2)
    name = f"table_{optim_name}_{shape[0]}x{shape[1]}"
    optim, semantics = TABLE_OPTIMS[optim_name]
    cores, opt, idx, d_out, w = _table_inputs(optim_name)
    mesh = _jmesh(shape, ("dp", "mp"))
    step = j_table_step(mesh, P, Q, R, TABLE_T, TABLE_B, TABLE_L,
                        optimizer=OptimType[optim], optim_semantics=semantics)
    prm = j_shard_table(mesh, TTEmbeddingParams(
        _jcores(cores), tuple(jnp.asarray(o) for o in opt), None))
    out, new = step(prm, jnp.asarray(idx), jnp.asarray(d_out),
                    (jnp.float32(LR_EPS[0]), jnp.float32(LR_EPS[1])),
                    weights=jnp.asarray(w))
    np.testing.assert_allclose(_cat(ranks, f"{name}/out"), np.asarray(out),
                               **OUT)
    mp, tl = shape[1], TABLE_T // shape[1]
    for rank, res in enumerate(ranks):
        m = rank % mp
        for i, (c, c0) in enumerate(zip(new.tt_cores, cores)):
            want = np.asarray(c)[m * tl:(m + 1) * tl]
            np.testing.assert_allclose(
                res[f"{name}/core/{i}"] - c0[m * tl:(m + 1) * tl],
                want - c0[m * tl:(m + 1) * tl], **UPD)
        for i, s in enumerate(new.optimizer_state):
            s = np.asarray(s)
            want = s[m * tl:(m + 1) * tl] if s.ndim == 3 else s
            np.testing.assert_allclose(res[f"{name}/opt/{i}"], want, **UPD)


@pytest.mark.parametrize("world", [2, 4])
def test_table_sharded_fused_step_rejects_cache(worlds, world):
    for r in worlds[world].ranks():
        assert "cache" in str(r["table_cache/raised"])


@pytest.mark.parametrize("mode", ["direct", "hashed", "wide"])
def test_row_owned_populate_matches_jax(worlds, mode):
    """``test_row_owned_populate_matches_replicated`` (and the wide
    layout): counting fields exact, the owned rows against JAX's owned
    populate and the replicated populate's rows laid out by owner."""
    ranks = worlds[4].ranks()
    name = f"populate_{mode}"
    cores, cache, p = _populate_inputs(mode)
    mesh = _jmesh((4,), ("dp",))
    new, w_owned, opt_owned = j_owned_populate(
        mesh, p, Q, R, POP_C, opt_state_kind="rowwise")(cache,
                                                        _jcores(cores))
    for f in ("keys", "freq", "slots"):
        np.testing.assert_array_equal(
            _same_on_every_rank(ranks, f"{name}/cache/{f}"),
            np.asarray(getattr(new, f)))
    for f in ("weight", "opt_state"):
        assert _same_on_every_rank(ranks, f"{name}/cache/{f}").shape[0] == 0
    got = _cat(ranks, f"{name}/w_owned", 0)
    np.testing.assert_allclose(got, np.asarray(w_owned), **UPD)
    ref = jc.cache_populate(cache, _jcores(cores), p, Q, R)
    np.testing.assert_allclose(got, _owner_major(ref.weight, 4), **UPD)
    assert _cat(ranks, f"{name}/opt_owned", 0).shape == (POP_C,)
    assert not _cat(ranks, f"{name}/opt_owned", 0).any()


@pytest.mark.parametrize("optim_name", list(OWNED_OPTIMS))
def test_row_owned_fused_step_matches_jax(worlds, optim_name):
    """``test_row_owned_fused_train_step_matches_replicated``: populate on
    the owners, then one step; output, cores, counts, owned rows and owned
    optimizer state against JAX's owned step."""
    ranks = worlds[4].ranks()
    name = f"owned_step_{optim_name}"
    optim, kind = OWNED_OPTIMS[optim_name]
    cores, opt, cache, idx, d_out, w = _owned_step_inputs(optim_name)
    mesh = _jmesh((4,), ("dp",))
    cache_cnt, w_owned, opt_owned = j_owned_populate(
        mesh, P, Q, R, OWNED_C, opt_state_kind=kind)(cache, _jcores(cores))
    step = j_owned_step(mesh, P, Q, R, OWNED_C, OWNED_B, OWNED_L,
                        optimizer=OptimType[optim])
    out, new, w2, o2 = step(
        TTEmbeddingParams(_jcores(cores), tuple(jnp.asarray(o) for o in opt),
                          cache_cnt), w_owned, opt_owned, jnp.asarray(idx),
        jnp.asarray(d_out), (jnp.float32(LR_EPS[0]),
                             jnp.float32(LR_EPS[1])), weights=jnp.asarray(w))
    np.testing.assert_allclose(_cat(ranks, f"{name}/out"), np.asarray(out),
                               **OUT)
    for i, (c, c0) in enumerate(zip(new.tt_cores, cores)):
        np.testing.assert_allclose(
            _same_on_every_rank(ranks, f"{name}/core/{i}") - c0,
            np.asarray(c) - c0, **UPD)
    np.testing.assert_array_equal(_same_on_every_rank(ranks, f"{name}/freq"),
                                  np.asarray(new.cache.freq))
    np.testing.assert_allclose(_cat(ranks, f"{name}/w_owned", 0),
                               np.asarray(w2), **UPD)
    got_opt = _cat(ranks, f"{name}/opt_owned", 0)
    if kind == "none":
        assert got_opt.size == 0
    else:
        np.testing.assert_allclose(got_opt, np.asarray(o2), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_new_entries_raise_value_error(worlds, world):
    """An mp that does not divide T; a cache_size the ranks do not divide
    (the row-owned lookup, populate and step); a two-table row-owned
    step: each raises ValueError (JAX asserts)."""
    for r in worlds[world].ranks():
        np.testing.assert_array_equal(r["value_errors/raised"],
                                      [1, 1, 1, 1, 1])
