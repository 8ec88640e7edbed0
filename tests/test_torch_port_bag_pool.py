"""The bag-order pool (``ops/kernels/bag_pool.py``) on the CPU: its plain
route against the two pools it replaces and against the JAX package's.

``bag_pool`` sums each lookup's row into its bag in lookup order: the flat
pipeline's rows read at the plan's ``slot_last`` (dead and pad slots
skipped), the cache-served lookups' rows from the cache (float32, or int8
with per-row scales), one pass for both. On the CPU it runs its plain
route: the terms gathered, a one-hot product up to ``_POOL_ONEHOT_MAX_TB``
= 4096 bags, ``segment_sum`` above. On numpy-seeded inputs at narrow
widths (p = [8, 9, 10], q = [2, 2, 4], ranks [8, 8], D = 16):

- ``tt_flat._pool_flat`` with the cache's rows, T = 1 and 2, 4096, 4104
  and 8200 bags, weights given and None, no cache, a float32 and an int8
  cache, float32 and bfloat16 rows, against the pools it replaces (the
  flat rows pooled in the last sort space, then the weighted cache rows
  pooled and added) and against the JAX package's ``_pool_flat`` and
  ``_pool_cached_rows``, rtol = atol = 1e-5, and twice, bitwise equal;
- the same on batches with CSR pad ids (-1), empty bags and an offset
  past nnz (dropped), and on lookups in a random order (bag ids that rise
  and fall, which the kernel groups before it pools);
- ``FlatPlan.slot_last`` inverts the last sort (a stable numpy argsort of
  the last core's keys) on the pair path at tt_ndim 3, the chain at
  tt_ndim 3 and at tt_ndim 4, and carries each lookup's bag and weight;
- ``_pool_cached_rows``, per-lookup rows and cache rows, against the JAX
  package's;
- the folded serve with a populated cache (one pass for both sources)
  and the unfolded serve (the cache's rows in a second pass) against the
  plain serve;
- ``bag_pool``'s argument checks.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbtt_embedding_tpu.models.tt_embedding import (
    _pool_cached_rows as j_pool_cached_rows,
)
from fbtt_embedding_tpu.ops.pallas import tt_flat as jflat
import fbtt_embedding_tpu_torch as T
from fbtt_embedding_tpu_torch.models.tt_embedding import _pool_cached_rows
from fbtt_embedding_tpu_torch.ops.hot_scatter import segment_sum
from fbtt_embedding_tpu_torch.ops.indexing import (
    rowidx_from_offsets,
    tt_strides,
)
from fbtt_embedding_tpu_torch.ops.kernels import tt_flat as tflat
from fbtt_embedding_tpu_torch.ops.kernels.bag_pool import (
    _POOL_ONEHOT_MAX_TB,
    CacheRows,
    bag_pool,
)

P, Q, R = [8, 9, 10], [2, 2, 4], [1, 8, 8, 1]
E, D, L = 8 * 9 * 10, 16, 2
C = 96  # cache rows
TIGHT = dict(rtol=1e-5, atol=1e-5)
# (T, B): T*B = 4096 (the one-hot product), 4104 and 8200 (segment_sum)
SIZES = [(1, 4096), (1, 4104), (1, 8200), (2, 2048), (2, 2052), (2, 4100)]


def _offsets(rng, tb, edges):
    """CSR offsets of ``tb`` bags of ``L`` lookups; with ``edges``, bags of
    0 to 2L lookups (every seventh empty) and one interior start past
    nnz."""
    if not edges:
        return np.arange(0, tb * L + 1, L, dtype=np.int64)
    lengths = rng.integers(0, 2 * L + 1, size=tb)
    lengths[::7] = 0
    offs = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    offs[tb // 3] = offs[-1] + 5
    return offs


def _case(t, b, weighted, cache, dt, seed, edges=False, pair=True,
          shuffled=False):
    """A batch, its plan with the cache-served lookups dead, last-space
    rows (zero on dead and pad slots, as kernel B1 leaves them) and the
    cache: a namespace of torch tensors. ``shuffled``: the lookups in a
    random order, so that bag ids rise and fall."""
    rng = np.random.default_rng(seed)
    tb = t * b
    offs = _offsets(rng, tb, edges)
    nnz = int(offs[-1])
    idx = rng.integers(0, E, size=nnz).astype(np.int32)
    if edges:
        idx[rng.random(nnz) < 0.05] = -1  # CSR pads: probes miss them
    rowidx, tbl = rowidx_from_offsets(torch.as_tensor(offs), nnz, t, b)
    if shuffled:
        perm = torch.as_tensor(rng.permutation(nnz))
        rowidx, tbl = rowidx[perm], tbl[perm]
    tbl = tbl if t > 1 else None
    w = torch.as_tensor(rng.random(nnz).astype(np.float32)) \
        if weighted else None
    loc = torch.full((nnz,), -1, dtype=torch.int32)
    crows = scale = None
    if cache is not None:
        hit = (rng.random(nnz) < 0.5) & (idx >= 0)
        loc = torch.as_tensor(np.where(hit, rng.integers(0, C, size=nnz),
                                       -1).astype(np.int32))
        crows = torch.as_tensor(rng.normal(size=(C, D)).astype(np.float32))
        if cache == "int8":
            crows, scale = tflat.quantize_rows_int8(crows)
    plan, nza = tflat._build_plan(
        torch.as_tensor(idx), rowidx, tbl, w, None, P, t, b,
        dead_mask=loc >= 0 if cache is not None else None, pair=pair)
    live = int(tflat.live_lookups(plan))
    rows = torch.as_tensor(rng.normal(size=(nza, D)).astype(np.float32))
    rows[live:] = 0
    return SimpleNamespace(
        t=t, b=b, tb=tb, nnz=nnz, idx=idx, offs=offs, rowidx=rowidx,
        tbl=tbl, w=w, loc=loc, crows=crows, scale=scale, plan=plan,
        rows=rows.to(dt),
        cache=(CacheRows(crows, loc, scale) if cache is not None else None))


def _cached_weighted(c):
    """Per-lookup cache rows times each lookup's weight and scale, zero
    where not cached (what the cache pool summed before)."""
    loc = c.loc.clamp(min=0).long()
    w = (c.loc >= 0).float() * (c.w if c.w is not None else 1.0)
    if c.scale is not None:
        w = c.scale[loc] * w
    return c.crows[loc] * w[:, None]


def _old_pools(c):
    """The two pools the bag-order pool replaces: the flat rows pooled in
    the last sort space (one-hot product up to 4096 bags, weights rounded
    to the rows' dtype; segment_sum above), plus the weighted cache rows
    pooled apart."""
    plan, tb = c.plan, c.tb
    if tb <= _POOL_ONEHOT_MAX_TB:
        hit = plan.rowidx_last[None, :] == torch.arange(tb)[:, None]
        w = (plan.w_last.to(c.rows.dtype).float() if plan.w_last is not None
             else torch.ones(plan.rowidx_last.shape[0]))
        out = torch.matmul(torch.where(hit, w[None, :], torch.zeros(())),
                           c.rows.float())
    else:
        rows_f = c.rows.float()
        if plan.w_last is not None:
            rows_f = rows_f * plan.w_last[:, None]
        out = segment_sum(rows_f, plan.rowidx_last, tb)
    if c.cache is None:
        return out
    seg = c.rowidx if c.tbl is None else c.tbl * c.b + c.rowidx
    return out + segment_sum(_cached_weighted(c), seg, tb)


def _jax_pools(c):
    """The JAX package's ``_pool_flat`` on the plan's last-space arrays,
    plus its ``_pool_cached_rows`` on the weighted cache rows."""
    jdt = jnp.bfloat16 if c.rows.dtype == torch.bfloat16 else jnp.float32
    jplan = SimpleNamespace(
        rowidx_last=jnp.asarray(c.plan.rowidx_last.numpy()),
        w_last=(None if c.plan.w_last is None
                else jnp.asarray(c.plan.w_last.numpy())))
    out = np.asarray(jflat._pool_flat(
        jnp.asarray(c.rows.float().numpy()).astype(jdt), jplan, c.tb, jdt))
    if c.cache is None:
        return out
    tbl = None if c.tbl is None else jnp.asarray(c.tbl.numpy())
    cached = j_pool_cached_rows(
        jnp.asarray(_cached_weighted(c).numpy()),
        jnp.asarray(c.rowidx.numpy()), tbl, c.t, c.b)
    return out + np.asarray(cached).reshape(c.tb, D)


def _check_pool(c):
    got = tflat._pool_flat(c.rows, c.plan, c.tb, cache=c.cache)
    assert got.shape == (c.tb, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _old_pools(c).numpy(), **TIGHT)
    np.testing.assert_allclose(got.numpy(), _jax_pools(c), **TIGHT)
    again = tflat._pool_flat(c.rows, c.plan, c.tb, cache=c.cache)
    assert torch.equal(got, again)
    return got


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cache", [None, "f32", "int8"])
@pytest.mark.parametrize("weighted", [True, False], ids=["w", "now"])
@pytest.mark.parametrize("t,b", SIZES)
def test_pool_matches_old_pools_and_jax(t, b, weighted, cache, dt):
    c = _case(t, b, weighted, cache, dt, seed=t * b + 3 * weighted)
    _check_pool(c)


@pytest.mark.parametrize("cache", [None, "f32", "int8"])
@pytest.mark.parametrize("t,b", [(1, 4096), (1, 4104), (2, 4100)])
def test_pool_pads_empty_bags_and_dropped_starts(t, b, cache):
    c = _case(t, b, True, cache, torch.float32, seed=7 + t * b, edges=True)
    assert (c.idx == -1).any() and c.offs[c.tb // 3] > c.nnz
    got = _check_pool(c)
    # the empty bags pool to zero rows
    bags = np.bincount(np.asarray(c.plan.bag), minlength=c.tb)
    assert (bags == 0).any()
    assert not got[torch.as_tensor(bags == 0)].any()


@pytest.mark.parametrize("cache", [None, "f32", "int8"])
@pytest.mark.parametrize("t,b", [(1, 4096), (1, 4104), (2, 4100)])
def test_pool_takes_bags_in_any_order(t, b, cache):
    c = _case(t, b, True, cache, torch.bfloat16, seed=5 + t * b,
              shuffled=True)
    bag = c.plan.bag
    assert (bag[1:] < bag[:-1]).any()
    _check_pool(c)


def _last_keys(idx, tbl, dead, p, t, nza):
    """The last core's sort keys in lookup order, dead lookups and pads
    at the sentinel ``T * p[-1]``."""
    strides = tt_strides(p)
    key = (idx.astype(np.int64) // strides[-1]) % p[-1]
    if tbl is not None:
        key = key + tbl.numpy() * p[-1]
    if dead is not None:
        key = np.where(dead, t * p[-1], key)
    return np.concatenate([key, np.full(nza - key.shape[0], t * p[-1])])


@pytest.mark.parametrize("path", ["pair3", "chain3", "chain4", "pair4"])
@pytest.mark.parametrize("t", [1, 2])
def test_slot_map_inverts_the_last_sort(path, t):
    p = [4, 5, 6, 7] if path.endswith("4") else P
    rng = np.random.default_rng(11 + t)
    b, e = 40, int(np.prod(p))
    nnz = t * b * 3 - 5  # not a whole segment: pads at the end
    idx = rng.integers(0, e, size=nnz).astype(np.int32)
    offs = np.concatenate([np.arange(0, nnz, 3), [nnz]])
    offs = np.concatenate([offs, np.full(t * b + 1 - offs.shape[0], nnz)])
    rowidx, tbl = rowidx_from_offsets(torch.as_tensor(offs), nnz, t, b)
    tbl = tbl if t > 1 else None
    w = torch.as_tensor(rng.random(nnz).astype(np.float32))
    dead = torch.as_tensor(rng.random(nnz) < 0.3)
    plan, nza = tflat._build_plan(
        torch.as_tensor(idx), rowidx, tbl, w, None, p, t, b, dead_mask=dead,
        pair=path.startswith("pair"))
    assert (plan.pair_s2 is not None) == path.startswith("pair")
    slot = plan.slot_last.numpy()
    assert plan.slot_last.dtype == torch.int32 and slot.shape == (nza,)
    key = _last_keys(idx, tbl, dead.numpy(), p, t, nza)
    order = np.argsort(key, kind="stable")
    want = np.empty(nza, np.int64)
    want[order] = np.arange(nza)
    np.testing.assert_array_equal(slot, want)
    bag = (rowidx + (0 if tbl is None else tbl * b)).numpy()
    np.testing.assert_array_equal(plan.bag.numpy(), bag)
    np.testing.assert_array_equal(plan.rowidx_last.numpy()[slot[:nnz]], bag)
    np.testing.assert_array_equal(plan.w_last.numpy()[slot[:nnz]], w.numpy())
    np.testing.assert_array_equal(plan.w_lookup.numpy(), w.numpy())
    assert (plan.rowidx_last.numpy()[slot[nnz:]] == -1).all()


@pytest.mark.parametrize("source", ["rows", "cache_f32", "cache_int8"])
@pytest.mark.parametrize("t,b", [(1, 4096), (2, 4100)])
def test_pool_cached_rows_matches_jax(t, b, source):
    c = _case(t, b, True, source[6:] or "f32", torch.float32, seed=t + b)
    per_lookup = _cached_weighted(c)
    if source == "rows":
        got = _pool_cached_rows(per_lookup, c.rowidx, c.tbl, t, b)
    else:
        got = _pool_cached_rows(None, c.rowidx, c.tbl, t, b, c.w,
                                cache=c.cache)
    tbl = None if c.tbl is None else jnp.asarray(c.tbl.numpy())
    want = j_pool_cached_rows(jnp.asarray(per_lookup.numpy()),
                              jnp.asarray(c.rowidx.numpy()), tbl, t, b)
    assert got.shape == (t, b, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


def _cached_params(rng, b):
    """Cores and an LFU cache counted on and populated from Zipf batches."""
    cores = [torch.as_tensor(np.asarray(c, np.float32)) for c in
             T.init_tt_cores(rng, "uniform", 1, E, D, P, Q, R)]
    cache = T.make_cache_state(E, C, D, num_embeddings=E, device="cpu")
    for _ in range(3):
        T.update_cache_state(cache, torch.as_tensor(
            (rng.zipf(1.2, size=b * L) - 1) % E))
    cache = T.cache_populate(cache, cores, P, Q, R)
    return T.TTEmbeddingParams(tuple(cores), (), cache)


@pytest.mark.parametrize("edges", [False, True], ids=["full", "edges"])
@pytest.mark.parametrize("b", [512, 4104])
def test_serves_pool_cache_rows_in_one_pass(b, edges):
    rng = np.random.default_rng(b + edges)
    params = _cached_params(rng, b)
    offs = _offsets(rng, b, edges)
    nnz = int(offs[-1])
    idx = ((rng.zipf(1.2, size=nnz) - 1) % E).astype(np.int32)
    w = rng.random(nnz).astype(np.float32)
    want = T.make_serving_fn(P, Q, R, 1, b, impl="xla", device="cpu")(
        params, idx, offs, w)
    got = T.make_serving_fn(P, Q, R, 1, b, device="cpu")(params, idx, offs,
                                                         w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TIGHT)
    fold, serve = T.make_folded_serving_fn(P, Q, R, 1, b, device="cpu")
    fp = fold(params)
    folded = serve(fp, idx, offs, w)
    np.testing.assert_allclose(folded.numpy(), want.numpy(), **TIGHT)
    assert torch.equal(folded, serve(fp, idx, offs, w))


def test_bag_pool_checks_its_arguments():
    bag = torch.zeros(4, dtype=torch.int32)
    rows = torch.ones(4, D)
    loc = torch.full((4,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="give rows, cache or both"):
        bag_pool(bag, 2)
    with pytest.raises(ValueError, match="differ in width"):
        bag_pool(bag, 2, rows=rows,
                 cache=CacheRows(torch.ones(3, D + 1), loc))
    with pytest.raises(ValueError, match="one entry per lookup"):
        bag_pool(bag, 2, rows=rows, slot=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="locations must be"):
        bag_pool(bag, 2, cache=CacheRows(torch.ones(3, D), loc[:3]))
    out = bag_pool(bag, 2, rows=rows)
    assert torch.equal(out, torch.stack([torch.full((D,), 4.0),
                                         torch.zeros(D)]))
