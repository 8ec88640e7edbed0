"""The port's lookup route (CPU): ``ops.lookup.route`` and its readers.

- ``route`` for six configs (the headline, odd ranks that need padding,
  tt_ndim 2, the billion-row tt_ndim-4 table, two tables, and a chain too
  wide for the generic kernels) under every ``impl`` at a batch of 512 and
  at 509: the kind, and the widths, ranks and batch the kernels run at,
  padded exactly where JAX's ``flat_pad_plan`` pads; with the flat
  pipeline refused (``flat_available`` patched), "auto" falls back to the
  plain path and "pallas_sorted" raises;
- the skip rule ``tt_path_inputs`` per route kind;
- the readers agree with the route: the path ``pooled_tt_lookup`` runs and
  the widths it gives the flat pipeline, the cache-served lookups of
  ``make_serving_fn`` (dead on the flat route, weight 0 elsewhere), the
  mode of ``make_folded_serving_fn``'s fold, and whether the fused step
  takes ``flat_train_apply``;
- each ValueError is raised when the call runs, not when it is built: the
  lookup, the serve, the folded serve (its fallback is built and raises
  when it serves) and the step.
"""

import numpy as np
import pytest
import torch

from fbtt_embedding_tpu.ops import lookup as jlook
from fbtt_embedding_tpu_torch import (
    init_tt_cores,
    make_cache_state,
    make_folded_serving_fn,
    make_fused_train_step,
    make_serving_fn,
    params_from_jax,
)
from fbtt_embedding_tpu_torch.models import tt_embedding as tmodel
from fbtt_embedding_tpu_torch.ops import lookup as tlook
from fbtt_embedding_tpu_torch.ops.indexing import rowidx_from_offsets

CONFIGS = {
    "headline": ([200, 220, 250], [4, 4, 4], [32, 32], 1),
    "odd_ranks": ([7, 9, 11], [3, 4, 5], [13, 12], 1),
    "ndim2": ([30, 40], [8, 8], [8], 1),
    "ndim4": ([125, 200, 200, 200], [2, 4, 2, 4], [32, 32, 32], 1),
    "t2": ([16, 16, 16], [4, 4, 4], [8, 8], 2),
    "no_generic": ([4, 4], [256, 256], [64], 1),
}
# the configs the flat pipeline takes unpadded at a batch of 512
UNPADDED_AT_512 = {"headline", "ndim2", "ndim4", "t2", "no_generic"}
IMPLS = ["auto", "pallas_sorted", "pallas", "xla"]
BATCHES = [512, 509]
# the configs run end to end here: small tables of the same widths (the
# route does not read p); no_generic's rows are 65536 wide
RUN_CONFIGS = ["headline", "odd_ranks", "ndim2", "ndim4", "t2"]


def _shapes(name, small=False):
    p, q, ranks, t = CONFIGS[name]
    if small:
        p = [min(x, 6) for x in p]
    return list(p), list(q), [1] + list(ranks) + [1], t


def _expected(name, impl, b):
    """``(kind, q, r, b, pad)`` the route must give, or None where it
    raises."""
    p, q, rfull, _ = _shapes(name)
    if impl == "pallas":
        if name == "no_generic":
            return None
        return "generic", tuple(q), tuple(rfull), b, None
    if impl == "xla":
        return "plain", tuple(q), tuple(rfull), b, None
    if b == 512 and name in UNPADDED_AT_512:
        return "flat", tuple(q), tuple(rfull), b, None
    pad = jlook.flat_pad_plan(p, q, rfull, b)
    assert pad is not None
    return "flat", tuple(q[:-1]) + (pad[1],), tuple(pad[0]), pad[2], pad


@pytest.fixture
def no_flat(monkeypatch):
    """The flat pipeline refuses every config (the route's cache is
    emptied before and after, so no refused route outlives the test)."""
    tlook._route.cache_clear()
    monkeypatch.setattr(tlook, "flat_available", lambda *a: False)
    yield
    tlook._route.cache_clear()


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_route_kind_and_padding(name, impl, b):
    p, q, rfull, t = _shapes(name)
    want = _expected(name, impl, b)
    if want is None:
        with pytest.raises(ValueError, match="the generic kernels cannot"):
            tlook.route(p, q, rfull, t, b, impl)
        return
    rt = tlook.route(p, q, rfull, t, b, impl)
    assert (rt.kind, rt.q, rt.r, rt.b, rt.pad) == want
    # inner ranks resolve the same, and the answer is the same each call
    assert tlook.route(p, q, rfull[1:-1], t, b, impl) == rt
    assert tlook.flat_servable(p, q, rfull, t, b)  # padded if need be


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("impl", IMPLS)
def test_route_without_the_flat_pipeline(no_flat, impl, b):
    p, q, rfull, t = _shapes("headline")
    assert not tlook.flat_servable(p, q, rfull, t, b)
    if impl == "pallas_sorted":
        with pytest.raises(ValueError,
                           match="impl='pallas_sorted' cannot serve"):
            tlook.route(p, q, rfull, t, b, impl)
        return
    kind = {"auto": "plain", "pallas": "generic", "xla": "plain"}[impl]
    assert tlook.route(p, q, rfull, t, b, impl) == tlook.Route(
        kind, tuple(q), tuple(rfull), b)


def test_route_refuses_bad_impl_and_shapes():
    p, q, rfull, t = _shapes("headline")
    with pytest.raises(ValueError, match="unknown impl 'bogus'"):
        tlook.route(p, q, rfull, t, 512, "bogus")
    with pytest.raises(ValueError, match="bad tt_ranks"):
        tlook.route(p, q, [1, 32, 1], t, 512, "auto")


@pytest.mark.parametrize("parts", [False, True])
@pytest.mark.parametrize("kind", ["flat", "generic", "plain"])
def test_tt_path_inputs_per_kind(kind, parts):
    rng = np.random.default_rng(3)
    n = 24
    loc = torch.as_tensor(rng.integers(-1, 3, size=n), dtype=torch.int32)
    idx = torch.arange(n, dtype=torch.int32) * 7
    rowidx = torch.arange(n, dtype=torch.int32) // 3
    w = torch.as_tensor(rng.random(n), dtype=torch.float32)
    rt = tlook.Route(kind, (4, 4), (1, 8, 1), 8)
    ids = None if parts else idx
    part = (idx % 5, idx // 5) if parts else None
    assert tlook.tt_path_inputs(rt, None, ids, part, rowidx, None, w) == (
        ids, rowidx, None, w, None, None)
    got_i, got_r, got_t, got_w, dead, live = tlook.tt_path_inputs(
        rt, loc, ids, part, rowidx, None, w)
    hit = loc >= 0
    if kind == "flat":
        assert got_w is w and live is None
        torch.testing.assert_close(dead, hit)
    elif kind == "generic" and not parts:
        alive = ~hit
        assert dead is None and int(live) == int(alive.sum())
        order = torch.cat([torch.nonzero(alive)[:, 0],
                           torch.nonzero(hit)[:, 0]])
        torch.testing.assert_close(got_i, idx[order])
        torch.testing.assert_close(got_r, rowidx[order])
        torch.testing.assert_close(got_w, torch.where(alive, w, 0.0)[order])
    else:
        assert dead is None and live is None and got_r is rowidx
        torch.testing.assert_close(got_w, torch.where(hit, 0.0, w))


def _params(name, seed=0):
    p, q, rfull, t = _shapes(name, small=True)
    rng = np.random.default_rng(seed)
    cores = init_tt_cores(rng, "uniform", t, int(np.prod(p)),
                          int(np.prod(q)), p, q, rfull)
    return p, q, rfull, t, params_from_jax(cores, device="cpu")


def _request(p, t, b, seed=1):
    """One lookup a bag: ``t * b`` row ids and their offsets."""
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(0, int(np.prod(p)), size=t * b),
                          dtype=torch.int32)
    return idx, torch.arange(t * b + 1, dtype=torch.int32)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", RUN_CONFIGS)
def test_pooled_lookup_takes_the_route(monkeypatch, name, impl, b):
    p, q, rfull, t, params = _params(name)
    rt = tlook.route(p, q, rfull, t, b, impl)
    ran = []
    flat_forward, tt_forward = tlook.flat_forward, tlook.tt_forward
    generic = tlook.GenericLookup.apply

    def flat_spy(*a, **k):
        ran.append(("flat", tuple(a[7]), tuple(a[8]), a[10]))
        return flat_forward(*a, **k)

    def plain_spy(*a, **k):
        ran.append(("plain",))
        return tt_forward(*a, **k)

    def generic_spy(*a):
        ran.append(("generic",))
        return generic(*a)

    monkeypatch.setattr(tlook, "flat_forward", flat_spy)
    monkeypatch.setattr(tlook, "tt_forward", plain_spy)
    monkeypatch.setattr(tlook.GenericLookup, "apply", generic_spy)
    idx, offs = _request(p, t, b)
    rowidx, tableidx = rowidx_from_offsets(offs, t * b, t, b)
    out = tlook.pooled_tt_lookup(params.tt_cores, p, q, rfull, b, idx,
                                 rowidx, tableidx if t > 1 else None,
                                 impl=impl)
    assert out.shape == (t, b, int(np.prod(q)))
    assert ran == [(rt.kind, rt.q, rt.r, rt.b) if rt.kind == "flat"
                   else (rt.kind,)]


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", ["headline", "odd_ranks", "ndim2",
                                  "ndim4"])
def test_serve_skips_cached_lookups_by_the_route(monkeypatch, name, impl, b):
    """The serve's cache-served lookups (an empty cache: every lookup
    probed, none a hit) are dead lookups on the flat route and weight 0
    on the others, which pack nothing (the JAX serve's rule)."""
    p, q, rfull, t, params = _params(name)
    e = int(np.prod(p))
    params.cache = make_cache_state(e, e // 4, int(np.prod(q)),
                                    num_embeddings=e, device="cpu")
    seen = []
    lookup = tmodel.pooled_tt_lookup

    def spy(*a, **k):
        seen.append((k["dead_mask"], k["weights"], k.get("live_count")))
        return lookup(*a, **k)

    monkeypatch.setattr(tmodel, "pooled_tt_lookup", spy)
    serve = make_serving_fn(p, q, rfull, t, b, impl=impl, device="cpu")
    serve(params, *_request(p, t, b))
    (dead, w, live), = seen
    assert live is None
    if tlook.route(p, q, rfull, t, b, impl).kind == "flat":
        assert w is None and dead.dtype == torch.bool and not dead.any()
    else:
        assert dead is None
        torch.testing.assert_close(w, torch.ones(t * b))


@pytest.mark.parametrize("name", ["headline", "odd_ranks"])
def test_cached_serve_takes_inner_ranks(name):
    """Inner ranks (``[r1, r2]``) serve a cached request the flat pipeline
    pads (a batch of 509, or odd ranks) as the full ranks do: the route
    validates the ranks before it pads them."""
    p, q, rfull, t, params = _params(name)
    e = int(np.prod(p))
    params.cache = make_cache_state(e, e // 4, int(np.prod(q)),
                                    num_embeddings=e, device="cpu")
    req = _request(p, t, 509)
    want = make_serving_fn(p, q, rfull, t, 509, device="cpu")(params, *req)
    got = make_serving_fn(p, q, rfull[1:-1], t, 509, device="cpu")(params,
                                                                   *req)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", RUN_CONFIGS)
def test_fold_mode_and_fused_apply_follow_the_route(monkeypatch, name, impl,
                                                    b):
    p, q, rfull, t, params = _params(name)
    rt = tlook.route(p, q, rfull, t, b, impl)
    fold, _ = make_folded_serving_fn(p, q, rfull, t, b, impl=impl,
                                     device="cpu")
    assert (fold(params).setup is not None) == (rt.kind == "flat")

    monkeypatch.delenv("FBTT_FUSED_APPLY", raising=False)
    applied = []
    apply = tmodel.flat_train_apply

    def spy(*a, **k):
        applied.append(1)
        return apply(*a, **k)

    monkeypatch.setattr(tmodel, "flat_train_apply", spy)
    step = make_fused_train_step(p, q, rfull, t, b, impl=impl, device="cpu")
    idx, offs = _request(p, t, b)
    out, _ = step(params, idx, offs, torch.zeros(t, b, int(np.prod(q))),
                  (0.01, 1e-8))
    assert out.shape == (t, b, int(np.prod(q)))
    assert bool(applied) == (rt.kind == "flat" and rt.pad is None)


def _raises_everywhere(name, impl, match):
    """Each entry raises ``match``: the lookup, the serves and the step
    when they run, none when they are built (the folded serve builds its
    fallback)."""
    p, q, rfull, t = _shapes(name, small=True)
    b = 8
    cores = init_tt_cores(np.random.default_rng(0), "uniform", t,
                          int(np.prod(p)), int(np.prod(q)), p, q, rfull)
    params = params_from_jax(cores, device="cpu")
    idx, offs = _request(p, t, b)
    rowidx, _ = rowidx_from_offsets(offs, t * b, t, b)
    with pytest.raises(ValueError, match=match):
        tlook.pooled_tt_lookup(params.tt_cores, p, q, rfull, b, idx, rowidx,
                               impl=impl)
    serve = make_serving_fn(p, q, rfull, t, b, impl=impl, device="cpu")
    with pytest.raises(ValueError, match=match):
        serve(params, idx, offs)
    fold, fserve = make_folded_serving_fn(p, q, rfull, t, b, impl=impl,
                                          device="cpu")
    fp = fold(params)
    assert fp.setup is None and fp.params is not None
    with pytest.raises(ValueError, match=match):
        fserve(fp, idx, offs)
    step = make_fused_train_step(p, q, rfull, t, b, impl=impl, device="cpu")
    with pytest.raises(ValueError, match=match):
        step(params, idx, offs, torch.zeros(t, b, int(np.prod(q))),
             (0.01, 1e-8))


def test_errors_generic_refused():
    _raises_everywhere("no_generic", "pallas",
                       r"impl='pallas': the generic kernels cannot serve "
                       r"this config \(p=")


def test_errors_unknown_impl():
    _raises_everywhere("headline", "bogus", r"^unknown impl 'bogus'$")


def test_errors_flat_refused(no_flat):
    _raises_everywhere("headline", "pallas_sorted",
                       r"impl='pallas_sorted' cannot serve this config even "
                       r"with rank/dim padding \(p=")
