"""The folded serve's CUDA graphs (``utils/graphs.py``,
``make_folded_serving_fn``).

On the CPU (no card needed): the engagement rule of ``ShapeGraphs`` with a
stand-in capture (first call eager, second captures, then replays; a new
owner or signature captures anew; the ninth signature evicts the least
recently used; no capture while spans are on; a dead owner's graphs go;
the counters and the launches a capture counts), a CPU folded serve that
never captures and answers as its helpers called in one sequence, and the
benchmark's reader ``graph_replay_share.serve``.

On the card (``card``; skips inside the test without one): replayed
answers against the same serve's eager route (``serve._eager``), bitwise,
bf16 and int8 folds, with and without weights; fresh answers; a refolded
cache; a bucketed serve; launch counts; the stage spans under a profiler.
Run there without the JAX conftest:
``python -m pytest --noconftest tests/test_torch_port_serve_graph.py``.
"""

import gc

import numpy as np
import pytest
import torch

import fbtt_embedding_tpu_torch as fbt
from fbtt_embedding_tpu_torch.ops import cache as cache_ops
from fbtt_embedding_tpu_torch.ops.indexing import rowidx_from_offsets
from fbtt_embedding_tpu_torch.ops.kernels import tt_flat
from fbtt_embedding_tpu_torch.ops.kernels.bag_pool import CacheRows
from fbtt_embedding_tpu_torch.ops.lookup import unpad_flat_output
from fbtt_embedding_tpu_torch.utils import graphs, profiling


@pytest.fixture(autouse=True)
def _empty_record():
    profiling.reset()
    yield
    profiling.reset()


class _Owner:
    """A stand-in for the state a serve's graphs read."""


class _Fake:
    """Stand-in eager and capture functions that log what ran; a capture
    counts one launch, as a kernel wrapper would under capture."""

    def __init__(self):
        self.log = []

    def eager(self, x):
        profiling.count("launches.fake")
        self.log.append(("eager", x))
        return ("eager", x)

    def capture(self, x):
        profiling.count("launches.fake")
        self.log.append(("capture", x))

        def replay(y):
            self.log.append(("replay", y))
            return ("replay", y)

        return replay


def _counts():
    return {k: profiling.counter(k) for k in (
        "serve_graph.captures", "serve_graph.replays",
        "serve_graph.spanned_replays", "launches.fake")}


def test_first_call_eager_second_captures_third_replays():
    g, f, owner = graphs.ShapeGraphs(), _Fake(), _Owner()
    got = [g(("sig",), owner, f.eager, f.capture, k) for k in range(3)]
    assert got == [("eager", 0), ("replay", 1), ("replay", 2)]
    assert f.log == [("eager", 0), ("capture", 1), ("replay", 1),
                     ("replay", 2)]
    assert len(g) == 1
    # one launch a call: the capture's own is taken out, each replay adds it
    assert _counts() == {"serve_graph.captures": 1,
                         "serve_graph.replays": 2,
                         "serve_graph.spanned_replays": 0,
                         "launches.fake": 3}


@pytest.mark.parametrize("change", ["owner", "nnz"])
def test_new_owner_or_signature_captures_anew(change):
    g, f = graphs.ShapeGraphs(), _Fake()
    owners = [_Owner(), _Owner()]
    for _ in range(3):
        g((81920,), owners[0], f.eager, f.capture, 0)
    other = (owners[1], (81920,)) if change == "owner" else (
        owners[0], (40960,))
    got = [g(other[1], other[0], f.eager, f.capture, 1) for _ in range(3)]
    assert [r[0] for r in got] == ["eager", "replay", "replay"]
    assert profiling.counter("serve_graph.captures") == 2
    assert len(g) == 2
    # the first signature still replays without a new capture
    assert g((81920,), owners[0], f.eager, f.capture, 2)[0] == "replay"
    assert profiling.counter("serve_graph.captures") == 2


def test_ninth_signature_evicts_the_least_recently_used():
    g, f, owner = graphs.ShapeGraphs(), _Fake(), _Owner()
    assert graphs.MAX_GRAPHS == 8
    for s in range(9):
        for _ in range(2):
            g((s,), owner, f.eager, f.capture, s)
        if s == 7:  # touch signature 0: 1 is now the least recently used
            g((0,), owner, f.eager, f.capture, 0)
    assert len(g) == 8
    assert profiling.counter("serve_graph.captures") == 9
    assert g((0,), owner, f.eager, f.capture, 0)[0] == "replay"
    # 1 was evicted: it starts again from an eager call
    assert g((1,), owner, f.eager, f.capture, 1)[0] == "eager"
    assert g((1,), owner, f.eager, f.capture, 1)[0] == "replay"
    assert profiling.counter("serve_graph.captures") == 10


def test_no_capture_while_spans_are_on(monkeypatch):
    g, f, owner = graphs.ShapeGraphs(), _Fake(), _Owner()
    monkeypatch.setattr(profiling, "enabled", lambda: True)
    got = [g(("a",), owner, f.eager, f.capture, k)[0] for k in range(3)]
    assert got == ["eager"] * 3
    assert profiling.counter("serve_graph.captures") == 0
    assert "serve_graph.spanned_replays" in profiling.span_totals()[
        "counters"]  # read as 0, not absent
    # spans off: the signature was warmed up, so the next call captures
    monkeypatch.setattr(profiling, "enabled", lambda: False)
    assert g(("a",), owner, f.eager, f.capture, 3)[0] == "replay"
    # a captured signature replays under the spans too, and says so
    monkeypatch.setattr(profiling, "enabled", lambda: True)
    assert g(("a",), owner, f.eager, f.capture, 4)[0] == "replay"
    assert _counts() == {"serve_graph.captures": 1,
                         "serve_graph.replays": 2,
                         "serve_graph.spanned_replays": 1,
                         "launches.fake": 5}


def test_a_dead_owners_graphs_go_with_it():
    g, f = graphs.ShapeGraphs(), _Fake()
    keep, drop = _Owner(), _Owner()
    for owner in (keep, drop):
        for _ in range(2):
            g(("s",), owner, f.eager, f.capture, 0)
    g(("once",), drop, f.eager, f.capture, 0)
    assert len(g) == 2
    del drop, owner
    gc.collect()
    assert len(g) == 1
    assert all(k[0] == id(keep) for k in list(g._kept) + list(g._seen))
    assert g(("s",), keep, f.eager, f.capture, 1)[0] == "replay"


def test_counted_apart_restores_the_counters():
    profiling.count("launches.a", 2)
    with profiling.counted_apart() as made:
        profiling.count("launches.a")
        profiling.count("launches.b", 3)
    assert made == {"launches.a": 1, "launches.b": 3}
    assert profiling.counter("launches.a") == 2
    assert profiling.counter("launches.b") == 0


# ------------------------------------------------- the folded serve, CPU

P, Q, R = [10, 11, 12], [4, 4, 4], [8, 8]
E, D = 10 * 11 * 12, 64


def _model(seed, b, pooling, quantize=None, device="cpu"):
    """``(serve, fp, requests, offsets, cores)``: a folded model with a
    cache of E/8 rows filled from hot ids, and three requests of one
    shape with different ids."""
    rng = np.random.default_rng(seed)
    cores = fbt.params_from_jax(fbt.init_tt_cores(
        rng, "uniform", 1, E, D, P, Q, [1] + R + [1]),
        device=device).tt_cores
    hot = rng.choice(E, 40, replace=False)
    reqs = [torch.as_tensor(np.where(
        rng.random(b * pooling) < 0.6, rng.choice(hot, b * pooling),
        rng.integers(0, E, b * pooling)), device=device) for _ in range(3)]
    offs = torch.arange(0, b * pooling + 1, pooling, device=device)
    cache = fbt.make_cache_state(E, E // 8, D, num_embeddings=E,
                                 device=device)
    fbt.update_cache_state(cache, reqs[0])
    cache = fbt.cache_populate(cache, cores, P, Q, R)
    fold, serve = fbt.make_folded_serving_fn(
        P, Q, R, 1, b, probe_cache=True, quantize=quantize, device=device)
    fp = fold(fbt.TTEmbeddingParams(tuple(cores), (), cache))
    return serve, fp, reqs, offs, cores


def _straight_serve(fp, indices, offsets, b, weights=None):
    """The folded serve as one straight sequence of the same helpers, at
    T = 1, unpadded widths, the cache probed."""
    nnz = indices.shape[0]
    rowidx, _ = rowidx_from_offsets(offsets, nnz, 1, b)
    loc = cache_ops.cache_lookup(fp.cache, indices)
    plan, nza = tt_flat._build_plan(
        indices, rowidx, None, weights, None, P, 1, b, dead_mask=loc >= 0,
        seg=tt_flat.SEG, pair=fp.setup[1] is not None)
    out, _ = tt_flat.flat_lookup_forward(
        None, P, Q, [1] + R + [1], b, plan, nza, compute_dtype=torch.float32,
        seg=tt_flat.SEG, setup=fp.setup, num_tables=1,
        cache=CacheRows(fp.cache.weight, loc, fp.cache_scale))
    return unpad_flat_output(out, b, Q, Q[-1])


@pytest.mark.parametrize("weighted", [False, True], ids=["now", "w"])
def test_cpu_folded_serve_never_captures_and_answers_as_the_helpers(
        weighted):
    b, pooling = 16, 3
    serve, fp, reqs, offs, _ = _model(3, b, pooling)
    assert serve._graphs is None
    w = (torch.as_tensor(np.random.default_rng(4).random(b * pooling),
                         dtype=torch.float32) if weighted else None)
    for _ in range(2):
        for idx in reqs:
            got = serve(fp, idx, offs, w)
            assert torch.equal(got, _straight_serve(fp, idx, offs, b, w))
            assert torch.equal(got, serve._eager(fp, idx, offs, w))
    counters = profiling.span_totals()["counters"]
    assert not any(k.startswith("serve_graph.") for k in counters)


# ------------------------------------------------- the benchmark's reader


def _read(monkeypatch, totals, kind="serve"):
    from h100_bench import spec

    monkeypatch.setattr(profiling, "span_totals", lambda: totals,
                        raising=False)
    return spec.metric_reader("graph_replay_share.serve").read({"kind": kind})


def _totals(serves, counters):
    span = {"count": serves, "host_s": 1.0, "host_self_s": 0.5,
            "device_s": 1e-3, "device_self_s": 5e-4}
    return {"calls": serves, "dropped": 0, "spans": {"fbtt.serve": span},
            "counters": counters}


@pytest.mark.parametrize("replays,want", [(40, 100.0), (30, 75.0),
                                          (0, 0.0)])
def test_replay_share_reader(monkeypatch, replays, want):
    got = _read(monkeypatch, _totals(
        40, {"serve_graph.spanned_replays": replays,
             "serve_graph.replays": 103}))
    assert got == pytest.approx(want)


def test_replay_share_reader_none_without_its_counter_or_spans(monkeypatch):
    # a program with spans and counters but no graphs
    assert _read(monkeypatch, _totals(40, {"lookups": 10})) is None
    assert _read(monkeypatch, {"calls": 0, "dropped": 0, "spans": {},
                               "counters": {}}) is None
    assert _read(monkeypatch, _totals(
        40, {"serve_graph.spanned_replays": 40}), kind="train") is None
    monkeypatch.delattr(profiling, "span_totals")
    from h100_bench import spec
    assert spec.metric_reader("graph_replay_share.serve").read(
        {"kind": "serve"}) is None


# ------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return torch.device("cuda")


CARD_B, CARD_L = 512, 8


@pytest.mark.card
@pytest.mark.parametrize("weighted", [False, True], ids=["now", "w"])
@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bf16", "int8"])
def test_replays_are_bitwise_the_eager_route(card, quantize, weighted):
    serve, fp, reqs, offs, _ = _model(11, CARD_B, CARD_L,
                                         quantize=quantize, device=card)
    w = (torch.rand(CARD_B * CARD_L, device=card) if weighted else None)
    want = [serve._eager(fp, idx, offs, w) for idx in reqs]
    got = [serve(fp, idx, offs, w) for idx in reqs]   # eager, capture, replay
    got += [serve(fp, idx, offs, w) for idx in reqs]  # three replays
    assert profiling.counter("serve_graph.captures") == 1
    assert profiling.counter("serve_graph.replays") == 5
    for k, out in enumerate(got):
        assert torch.equal(out, want[k % 3]), k
    assert len({out.data_ptr() for out in got}) == len(got)  # no aliasing


@pytest.mark.card
def test_consecutive_answers_do_not_alias(card):
    serve, fp, reqs, offs, _ = _model(12, CARD_B, CARD_L, device=card)
    for idx in reqs[:2]:
        serve(fp, idx, offs)
    first = serve(fp, reqs[0], offs)
    kept = first.clone()
    second = serve(fp, reqs[1], offs)
    assert profiling.counter("serve_graph.replays") == 3
    assert second.data_ptr() != first.data_ptr()
    assert torch.equal(first, kept) and not torch.equal(first, second)


@pytest.mark.card
def test_refold_cache_captures_anew_and_serves_the_new_rows(card):
    serve, fp, reqs, offs, cores = _model(13, CARD_B, CARD_L,
                                             device=card)
    for idx in reqs:
        serve(fp, idx, offs)
    cache = fbt.make_cache_state(E, E // 8, D, num_embeddings=E,
                                 device=card)
    fbt.update_cache_state(cache, reqs[2])  # other hot rows
    fp2 = fbt.refold_cache(fp, fbt.TTEmbeddingParams(tuple(cores), (),
                                                     cache=fbt.cache_populate(
                                                         cache, cores, P, Q,
                                                         R)))
    want = [serve._eager(fp2, idx, offs) for idx in reqs]
    got = [serve(fp2, idx, offs) for idx in reqs]
    assert profiling.counter("serve_graph.captures") == 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(fp.cache.slots, fp2.cache.slots)
    del fp
    gc.collect()
    assert len(serve._graphs) == 1


@pytest.mark.card
def test_bucketed_serve_replays_per_bucket(card):
    rng = np.random.default_rng(14)
    cores = fbt.params_from_jax(fbt.init_tt_cores(
        rng, "uniform", 1, E, D, P, Q, [1] + R + [1]), device=card).tt_cores
    params = fbt.TTEmbeddingParams(tuple(cores), ())

    def bucketed():
        fold, serve = fbt.make_bucketed_serving_fn(
            P, Q, R, 1, batch_buckets=[64, 128], nnz_buckets=[256, 1024],
            probe_cache=False, device=card)
        return fold(params), serve

    fp, serve = bucketed()
    for b, pooling in [(50, 4), (100, 8)]:   # two buckets
        for _ in range(3):
            idx = torch.as_tensor(rng.integers(0, E, b * pooling),
                                  device=card)
            offs = torch.arange(0, b * pooling + 1, pooling, device=card)
            got = serve(fp, idx, offs)
            # a fresh serve's first call of a signature runs eagerly
            fresh_fp, fresh = bucketed()
            assert torch.equal(got, fresh(fresh_fp, idx, offs))
    assert profiling.counter("serve_graph.captures") == 2
    assert profiling.counter("serve_graph.replays") == 4


@pytest.mark.card
def test_replayed_call_counts_the_launches_of_an_eager_call(card):
    serve, fp, reqs, offs, _ = _model(15, CARD_B, CARD_L, device=card)

    def launches(fn):
        before = {k: v for k, v in profiling.span_totals()[
            "counters"].items() if k.startswith("launches.")}
        fn()
        after = profiling.span_totals()["counters"]
        return {k: after[k] - before.get(k, 0) for k in after
                if k.startswith("launches.")
                and after[k] != before.get(k, 0)}

    eager = launches(lambda: serve._eager(fp, reqs[0], offs))
    assert eager["launches.bag_pool"] == 1 and eager["launches.seg_transform"]
    assert launches(lambda: serve(fp, reqs[0], offs)) == eager  # eager
    assert launches(lambda: serve(fp, reqs[1], offs)) == eager  # capture
    assert launches(lambda: serve(fp, reqs[2], offs)) == eager  # replay


@pytest.mark.card
def test_stage_spans_of_replays_under_the_profiler(card, tmp_path):
    serve, fp, reqs, offs, _ = _model(16, CARD_B, CARD_L, device=card)
    for idx in reqs[:2]:
        serve(fp, idx, offs)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        outs = [serve(fp, reqs[k % 3], offs) for k in range(6)]
    totals = profiling.span_totals()
    spans = totals["spans"]
    assert spans["fbtt.serve"]["count"] == totals["calls"] == 6
    for name in ("fbtt.cache", "fbtt.plan", "fbtt.fwd", "fbtt.pool"):
        assert spans[name]["count"] == 6, name
        assert spans[name]["device_s"] > 0, name
    assert totals["counters"]["serve_graph.spanned_replays"] == 6
    assert totals["counters"]["lookups"] == 6 * CARD_B * CARD_L
    hits = sum(int(fp.cache.slots[reqs[k % 3]].ge(0).sum())
               for k in range(6))
    assert totals["counters"]["cache_hits"] == hits
    for k, out in enumerate(outs):
        assert torch.equal(out, serve._eager(fp, reqs[k % 3], offs))
