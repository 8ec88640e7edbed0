"""The port's layer spans and counters (``utils/profiling.py``), on the CPU.

- With no profiler recording, the record stays empty and a call's outputs
  are bitwise those of the same call under the profiler.
- Under ``profiling.trace()`` a flat training step with LFU counting (the
  fused apply, and the autograd ``FlatLookup`` as
  ``FBTT_FUSED_APPLY=0`` makes it), a generic step (``impl="pallas"``)
  and a folded serve with a populated cache each leave one root span per
  call, with the layer spans of that call under the same call id.
- ``lookups`` counts the lookups; ``cache_hits`` the lookups the cache
  held, ``(locations >= 0).sum()``, read off the plan (folded serve) or
  off the probe (unfolded serve, probing step).
- The Chrome trace that ``trace()`` writes holds each span; self time is
  the duration less the child spans'; the cap drops spans and counts them;
  ``kernels_by_span`` puts each kernel under its innermost span; the
  benchmark's readers of the spans return None on the CPU, whose spans
  have no device seconds.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import fbtt_embedding_tpu_torch as fbt
from fbtt_embedding_tpu_torch.ops import cache as cache_ops
from fbtt_embedding_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
P, Q, R = [10, 11, 12], [4, 4, 4], [8, 8]
E, D, B, L = 10 * 11 * 12, 64, 16, 3
LAYERS = {"cache", "plan", "fwd", "bwd", "pool", "optim"}
SPANS_OF = {  # case -> (root, the layer spans every call opens)
    "flat_step": ("fbtt.step", LAYERS),
    "flat_step_autograd": ("fbtt.step", LAYERS),
    "generic_step": ("fbtt.step", {"plan", "fwd", "bwd", "optim"}),
    "folded_serve": ("fbtt.serve", {"cache", "plan", "fwd", "pool"}),
}
CASES = list(SPANS_OF)
READERS = ["pool_us_per_request.serve", "pool_us_per_step.train",
           "optim_us_per_step.train", "plan_us_per_step.train",
           "cache_us_per_step.train", "cache_hit_share.serve",
           "host_us_per_request.serve"]


@pytest.fixture(autouse=True)
def _empty_record():
    profiling.reset()
    yield
    profiling.reset()


def _batches(seed, n):
    """``n`` batches of Zipf-like ids (a few hot rows, so a cache filled
    from them serves some lookups) and their offsets."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(E, 24, replace=False)
    out = []
    for _ in range(n):
        ids = np.where(rng.random(B * L) < 0.6, rng.choice(hot, B * L),
                       rng.integers(0, E, B * L))
        out.append(torch.as_tensor(ids, dtype=torch.int64))
    return out, torch.arange(0, B * L + 1, L)


def _cores(seed):
    rng = np.random.default_rng(seed)
    return fbt.params_from_jax(
        fbt.init_tt_cores(rng, "uniform", 1, E, D, P, Q, [1] + R + [1]),
        device="cpu").tt_cores


def _populated_cache(cores, batches):
    """A cache of 16 rows, filled from the first batch's counts: it holds
    some of the hot rows, so it serves part of every batch."""
    cache = fbt.make_cache_state(E, 16, D, num_embeddings=E, device="cpu")
    fbt.update_cache_state(cache, batches[0])
    return fbt.cache_populate(cache, cores, P, Q, R)


def _case(name, seed=7, monkeypatch=None):
    """``(call, batches, state)``: ``call(k)`` runs the case on batch ``k``
    and returns what it produced (a step's output and its cores after)."""
    batches, offs = _batches(seed, 3)
    cores = _cores(seed)
    if name == "folded_serve":
        fold, serve = fbt.make_folded_serving_fn(P, Q, R, 1, B,
                                                 probe_cache=True,
                                                 device="cpu")
        fp = fold(fbt.TTEmbeddingParams(
            tuple(cores), (), _populated_cache(cores, batches)))
        return (lambda k: (serve(fp, batches[k], offs),)), batches, fp
    if name == "flat_step_autograd":
        monkeypatch.setenv("FBTT_FUSED_APPLY", "0")
    counting = name != "generic_step"
    params = fbt.TTEmbeddingParams(tuple(c.clone() for c in cores), (), (
        fbt.make_cache_state(E, E // 10, D, num_embeddings=E, device="cpu")
        if counting else None))
    step = fbt.make_fused_train_step(
        P, Q, R, 1, B, use_cache=counting,
        impl="pallas" if name == "generic_step" else "auto", device="cpu")
    dout = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (1, B, D)), dtype=torch.float32)
    state = {"params": params}

    def call(k):
        out, state["params"] = step(state["params"], batches[k], offs, dout,
                                    (0.05, 0.0))
        return (out,) + tuple(c.clone() for c in state["params"].tt_cores)

    return call, batches, state


@pytest.mark.parametrize("case", CASES)
def test_no_profiler_no_record_and_outputs_bitwise(case, monkeypatch,
                                                   tmp_path):
    call, _, _ = _case(case, monkeypatch=monkeypatch)
    plain = [call(k) for k in range(2)]
    totals = profiling.span_totals()
    assert totals["spans"] == {} and totals["calls"] == 0
    assert not {"lookups", "cache_hits"} & set(totals["counters"])
    call, _, _ = _case(case, monkeypatch=monkeypatch)
    with profiling.trace(str(tmp_path)):
        traced = [call(k) for k in range(2)]
    assert profiling.span_totals()["spans"]
    for a, b in zip(plain, traced):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("case", CASES)
def test_one_root_per_call_with_its_layers(case, monkeypatch, tmp_path):
    call, _, _ = _case(case, monkeypatch=monkeypatch)
    with profiling.trace(str(tmp_path)):
        for k in range(3):
            call(k)
    root, layers = SPANS_OF[case]
    spans = profiling._REC.spans
    ids = [e[1] for e in spans]
    assert sorted(set(ids)) == [1, 2, 3]
    for cid in (1, 2, 3):
        mine = [e for e in spans if e[1] == cid]
        assert mine[0][0] == root  # the root opens first ...
        assert [e[0] for e in mine].count(root) == 1
        t0, t1 = mine[0][2], mine[0][3]
        for e in mine[1:]:  # ... and encloses its call's spans
            assert t0 <= e[2] <= e[3] <= t1
        assert {e[0] for e in mine[1:]} == {f"fbtt.{x}" for x in layers}
    totals = profiling.span_totals()
    assert totals["calls"] == 3 and totals["dropped"] == 0
    assert totals["spans"][root]["count"] == 3
    assert totals["counters"]["lookups"] == 3 * B * L
    for s in totals["spans"].values():
        assert s["device_s"] is None and s["device_self_s"] is None


def test_cache_hits_off_the_folded_plan(tmp_path):
    call, batches, fp = _case("folded_serve")
    with profiling.trace(str(tmp_path)):
        for k in range(3):
            call(k)
    want = sum(int((cache_ops.cache_lookup(fp.cache, b) >= 0).sum())
               for b in batches)
    counters = profiling.span_totals()["counters"]
    assert 0 < want < 3 * B * L
    assert counters["cache_hits"] == want
    assert counters["lookups"] == 3 * B * L


@pytest.mark.parametrize("entry", ["serve", "step"])
def test_cache_hits_off_the_probe(entry, tmp_path):
    batches, offs = _batches(3, 2)
    cores = _cores(3)
    cache = _populated_cache(cores, batches)
    want = sum(int((cache_ops.cache_lookup(cache, b) >= 0).sum())
               for b in batches)
    params = fbt.TTEmbeddingParams(tuple(cores), (), cache)
    if entry == "serve":
        serve = fbt.make_serving_fn(P, Q, R, 1, B, device="cpu")

        def call(b):
            serve(params, b, offs)
    else:
        step = fbt.make_fused_train_step(P, Q, R, 1, B, probe_cache=True,
                                         device="cpu")
        dout = torch.zeros((1, B, D))

        def call(b):
            step(params, b, offs, dout, (0.0, 0.0))
    with profiling.trace(str(tmp_path)):
        for b in batches:
            call(b)
    counters = profiling.span_totals()["counters"]
    assert 0 < want < 2 * B * L
    assert counters["cache_hits"] == want
    assert counters["lookups"] == 2 * B * L


def test_chrome_trace_holds_every_span(monkeypatch, tmp_path):
    for i, case in enumerate(CASES):
        call, _, _ = _case(case, monkeypatch=monkeypatch)
        with profiling.trace(str(tmp_path / str(i))):
            call(0)
        text = "".join(f.read_text() for f in (tmp_path / str(i)).rglob(
            "*.json"))
        root, layers = SPANS_OF[case]
        names = set(re.findall(r'"name": "(fbtt\.[a-z]+)"', text))
        assert names == {root} | {f"fbtt.{x}" for x in layers}, case


class _Ev:
    """A stand-in for a CUDA timing event at ``ms`` on the stream."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_self_time_is_duration_less_children():
    # call 1: a root (0-10 s host, 0-8 ms device) with two children, the
    # second holding a grandchild; call 2: a root alone
    profiling._REC.spans.extend([
        ["fbtt.step", 1, 0.0, 10.0, _Ev(0.0), _Ev(8.0)],
        ["fbtt.fwd", 1, 1.0, 3.0, _Ev(1.0), _Ev(2.5)],
        ["fbtt.bwd", 1, 4.0, 9.0, _Ev(3.0), _Ev(7.0)],
        ["fbtt.pool", 1, 5.0, 6.0, _Ev(4.0), _Ev(4.5)],
        ["fbtt.step", 2, 11.0, 12.0, _Ev(9.0), _Ev(9.25)],
    ])
    s = profiling.span_totals()["spans"]
    assert s["fbtt.step"]["count"] == 2
    assert s["fbtt.step"]["host_s"] == pytest.approx(11.0)
    assert s["fbtt.step"]["host_self_s"] == pytest.approx(11.0 - 2 - 5)
    assert s["fbtt.step"]["device_s"] == pytest.approx(8.25e-3)
    assert s["fbtt.step"]["device_self_s"] == pytest.approx(
        (8.25 - 1.5 - 4.0) * 1e-3)
    assert s["fbtt.bwd"]["host_self_s"] == pytest.approx(4.0)
    assert s["fbtt.bwd"]["device_self_s"] == pytest.approx(3.5e-3)
    assert s["fbtt.pool"]["host_self_s"] == pytest.approx(1.0)


def test_self_time_of_a_traced_step(tmp_path):
    call, _, _ = _case("flat_step")
    with profiling.trace(str(tmp_path)):
        call(0)
    spans = profiling._REC.spans
    root = spans[0]
    inner = spans[1:]
    # direct children: not inside another child of the root
    kids = [e for e in inner if not any(
        o is not e and o[2] <= e[2] and e[3] <= o[3] for o in inner)]
    want = (root[3] - root[2]) - sum(e[3] - e[2] for e in kids)
    got = profiling.span_totals()["spans"]["fbtt.step"]["host_self_s"]
    assert got == pytest.approx(want, rel=1e-9, abs=1e-12)
    assert 0 < got < root[3] - root[2]


def test_cap_drops_spans_and_counts_them(monkeypatch, tmp_path):
    call, _, _ = _case("generic_step")
    with profiling.trace(str(tmp_path)):
        call(0)
    per_call = len(profiling._REC.spans)
    monkeypatch.setattr(profiling, "SPAN_CAP", per_call + 2)
    call, _, _ = _case("generic_step")
    with profiling.trace(str(tmp_path)):
        for k in range(3):
            call(k)
    totals = profiling.span_totals()
    assert len(profiling._REC.spans) == per_call + 2
    assert totals["dropped"] == 3 * per_call - (per_call + 2)
    assert totals["calls"] == 2


def test_annotate_off_is_a_null_context():
    assert not profiling.enabled()
    with profiling.annotate("fbtt.fwd"):
        pass

    @profiling.annotated("fbtt.plan")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert profiling._REC.spans == [] and profiling._REC.depth == 0


def test_counters_host_and_device_parts():
    profiling.count("launches.demo")
    profiling.count("launches.demo", 2)
    profiling.count("cache_hits", 10, less=torch.tensor(4, dtype=torch.int32))
    profiling.count("cache_hits", 5, less=torch.tensor(1))
    assert profiling.counter("launches.demo") == 3
    assert profiling.counter("cache_hits") == 10
    assert profiling.counter("never") == 0
    assert profiling.span_totals()["counters"] == {"launches.demo": 3,
                                                   "cache_hits": 10}
    profiling.reset()
    assert profiling.counter("cache_hits") == 0


class _ProfEv:
    """A stand-in for a profiler's event: host (``parent``) or device
    (``us`` long)."""

    def __init__(self, name, id_=0, parent=None, us=None):
        self.name, self.id, self.cpu_parent = name, id_, parent
        self.device_type = (torch.autograd.DeviceType.CPU if us is None
                            else torch.autograd.DeviceType.CUDA)
        self.time_range = type("T", (), {"start": 100.0,
                                         "end": 100.0 + (us or 0.0)})()


def test_kernels_by_span_take_the_innermost_span():
    step = _ProfEv("fbtt.step", 1)
    bwd = _ProfEv("fbtt.bwd", 2, step)
    fwd = _ProfEv("fbtt.fwd", 3, step)
    index = _ProfEv("aten::index", 4, bwd)
    other = _ProfEv("aten::x", 5, step)
    events = [
        step, bwd, fwd, index, other,
        # runtime calls, each with its device operation's correlation id
        _ProfEv("cudaLaunchKernel", 101, index),
        _ProfEv("cudaLaunchKernel", 102, index),
        _ProfEv("cudaLaunchKernel", 103, _ProfEv("aten::sort", 6, other)),
        _ProfEv("cudaLaunchKernel", 104, fwd),  # the port's own kernel
        _ProfEv("cudaLaunchKernel", 105, None),
        _ProfEv("gather", 101, us=30.0), _ProfEv("gather", 102, us=10.0),
        _ProfEv("sortk", 103, us=5.0), _ProfEv("seg_transform_kernel", 104, us=7.0),
        _ProfEv("add", 105, us=1.0),
        _ProfEv("fbtt.fwd", 0, us=9.0),  # a span's device-side annotation
    ]
    got = profiling.kernels_by_span(events)
    assert got == {
        "fbtt.bwd": {"gather": [2, pytest.approx(40e-6)]},
        "fbtt.step": {"sortk": [1, pytest.approx(5e-6)]},
        "fbtt.fwd": {"seg_transform_kernel": [1, pytest.approx(7e-6)]},
        "(none)": {"add": [1, pytest.approx(1e-6)]},
    }
    text = profiling.by_span_text(got, 2, "step").splitlines()
    assert text[1] == "  fbtt.bwd: 20.0"  # the largest first, per call
    assert text[2].split() == ["20.0", "x1", "gather"]
    assert text[-2:] == ["  (none): 0.5", "          0.5  x0.5  add"]


def _reader(name):
    from h100_bench import spec

    return spec.metric_reader(name)


def test_readers_none_on_cpu_device_times(tmp_path):
    call, _, _ = _case("folded_serve")
    with profiling.trace(str(tmp_path)):
        for k in range(2):
            call(k)
    assert profiling.span_totals()["spans"]["fbtt.serve"]["device_s"] is None
    for name in READERS:
        kind = name.rsplit(".", 1)[1]
        assert _reader(name).read({"kind": kind}) is None, name


def test_span_names_are_the_documented_layers():
    """Every span the port opens is one of PERF.md's eleven names (the
    DLRM-DCNv2 step's ``fbtt.dense`` and ``fbtt.tables``, and the
    collectives' ``fbtt.comm``, among them)."""
    src = "".join(p.read_text() for p in
                  (ROOT / "fbtt_embedding_tpu_torch").rglob("*.py"))
    used = set(re.findall(r'annotated?\("(fbtt\.[a-z]+)"\)', src))
    assert used == {"fbtt.step", "fbtt.serve", "fbtt.dense", "fbtt.tables",
                    "fbtt.comm"} | {f"fbtt.{x}" for x in LAYERS}
    perf = (ROOT / "PERF.md").read_text()
    for name in used:
        assert f"`{name}`" in perf, name
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["per_layer"]}
    assert set(READERS) <= names
