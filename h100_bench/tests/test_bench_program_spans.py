"""The readers of the program's own spans and counters
(``metrics/<metric>.py`` over ``fbtt_embedding_tpu_torch.utils.profiling.
span_totals``), on hand-made totals; and on the card (``card``), the spans
of a training step and of a folded serve under the profiler."""

import pytest

from fbtt_embedding_tpu_torch.utils import profiling
from h100_bench import spec


def _span(count, device_s, host_s=1.0):
    return {"count": count, "host_s": host_s, "host_self_s": host_s / 2,
            "device_s": device_s,
            "device_self_s": None if device_s is None else device_s / 2}


def _totals(root, dev=True, counters=None):
    """Four calls: 8 ms of device time in the root, 2 ms in each layer
    span, 0.5 s of host time in the root."""
    d = (lambda s: s) if dev else (lambda s: None)
    spans = {root: _span(4, d(8e-3), host_s=0.5)}
    for layer in ("pool", "optim", "plan", "cache"):
        spans[f"fbtt.{layer}"] = _span(8, d(2e-3))
    return {"calls": 4, "dropped": 0, "spans": spans,
            "counters": counters or {"lookups": 400, "cache_hits": 216}}


# metric -> (root span, value read off _totals)
WANT = {
    "pool_us_per_request.serve": ("fbtt.serve", 500.0),
    "pool_us_per_step.train": ("fbtt.step", 500.0),
    "optim_us_per_step.train": ("fbtt.step", 500.0),
    "plan_us_per_step.train": ("fbtt.step", 500.0),
    "cache_us_per_step.train": ("fbtt.step", 500.0),
    "cache_hit_share.serve": ("fbtt.serve", 54.0),
    "host_us_per_request.serve": ("fbtt.serve", 125000.0),
}


def _read(metric, monkeypatch, totals, kind=None):
    monkeypatch.setattr(profiling, "span_totals", lambda: totals,
                        raising=False)
    kind = kind or metric.rsplit(".", 1)[1]
    return spec.metric_reader(metric).read({"kind": kind})


@pytest.mark.parametrize("metric", list(WANT))
def test_reader_on_hand_made_totals(metric, monkeypatch):
    root, want = WANT[metric]
    assert _read(metric, monkeypatch, _totals(root)) == pytest.approx(want)


@pytest.mark.parametrize("metric", list(WANT))
def test_reader_none_off_its_kind_or_record(metric, monkeypatch):
    root, _ = WANT[metric]
    other = "train" if metric.endswith(".serve") else "serve"
    assert _read(metric, monkeypatch, _totals(root), kind=other) is None
    empty = {"calls": 0, "dropped": 0, "spans": {}, "counters": {}}
    assert _read(metric, monkeypatch, empty) is None
    assert _read(metric, monkeypatch, _totals(root, dev=False)) is None


@pytest.mark.parametrize("metric", list(WANT))
def test_reader_none_for_a_program_without_spans(metric, monkeypatch):
    """The parent of the spans' change has no ``span_totals``."""
    monkeypatch.delattr(profiling, "span_totals")
    kind = metric.rsplit(".", 1)[1]
    assert spec.metric_reader(metric).read({"kind": kind}) is None


def _card_calls(fbt, torch):
    """A training step through the autograd ``FlatLookup`` (its backward
    runs on the autograd engine's device thread) with LFU counting, and a
    folded serve with a populated cache, at a small size on the card."""
    import numpy as np

    p, q, r = [40, 44, 50], [4, 4, 4], [32, 32]
    e, b, pool = 40 * 44 * 50, 4096, 20
    rng = np.random.default_rng(5)
    cores = fbt.params_from_jax(fbt.init_tt_cores(
        rng, "uniform", 1, e, 64, p, q, [1] + r + [1]), device="cuda")
    ids = [torch.as_tensor(rng.zipf(1.2, b * pool) % e, device="cuda")
           for _ in range(4)]
    offs = torch.arange(0, b * pool + 1, pool, device="cuda")
    dout = torch.randn((1, b, 64), device="cuda")
    train = fbt.TTEmbeddingParams(
        tuple(c.clone() for c in cores.tt_cores), (),
        fbt.make_cache_state(e, e // 10, 64, num_embeddings=e,
                             device="cuda"))
    step = fbt.make_fused_train_step(p, q, r, 1, b, use_cache=True,
                                     device="cuda")
    cache = fbt.make_cache_state(e, e // 10, 64, num_embeddings=e,
                                 device="cuda")
    for x in ids[:2]:
        fbt.update_cache_state(cache, x)
    cache = fbt.cache_populate(cache, cores.tt_cores, p, q, r)
    fold, serve = fbt.make_folded_serving_fn(p, q, r, 1, b, device="cuda")
    fp = fold(fbt.TTEmbeddingParams(cores.tt_cores, (), cache))
    k = {"n": 0}

    def train_call():
        step(train, ids[k["n"] % 4], offs, dout, (1e-4, 0.0))
        k["n"] += 1

    def serve_call():
        serve(fp, ids[k["n"] % 4], offs)
        k["n"] += 1

    return {"train": (train_call, "fbtt.step", 0),
            "serve": (serve_call, "fbtt.serve", 1)}


@pytest.mark.card
@pytest.mark.parametrize("kind", ["train", "serve"])
def test_spans_on_the_card(kind, monkeypatch):
    """Every span has device seconds, a root's children take no more than
    the root, and the spans add no device operation to the trace's count
    (the serve one at most, the ``cache_hits`` count)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    import fbtt_embedding_tpu_torch as fbt
    from h100_bench import trace

    monkeypatch.setenv("FBTT_FUSED_APPLY", "0")
    call, root, extra_ops = _card_calls(fbt, torch)[kind]
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    profiling.reset()
    on = trace.traced_window(call, 0.3)
    totals = profiling.span_totals()
    monkeypatch.setattr(profiling, "enabled", lambda: False)
    off = trace.traced_window(call, 0.3)
    spans = totals["spans"]
    assert totals["dropped"] == 0
    assert spans[root]["count"] == totals["calls"] >= on["calls"]
    want = {"fbtt.cache", "fbtt.plan", "fbtt.fwd", "fbtt.pool"}
    if kind == "train":
        want |= {"fbtt.bwd", "fbtt.optim"}
        assert spans["fbtt.bwd"]["count"] == spans[root]["count"]
    assert want <= set(spans)
    for name, s in spans.items():
        assert s["device_s"] is not None and s["device_s"] > 0, name
        assert s["device_self_s"] >= -1e-6 * s["count"], name
    assert sum(s["device_self_s"] for s in spans.values()) == \
        pytest.approx(spans[root]["device_s"], rel=1e-3)
    per_on = on["device_ops"] / on["calls"]
    per_off = off["device_ops"] / off["calls"]
    assert per_on - per_off == pytest.approx(extra_ops), (per_on, per_off)
