"""Profiling and performance accounting.

Counterpart of ``fbtt_embedding_tpu.utils.profiling``:

  * :func:`trace`: a ``torch.profiler`` capture (CPU, and CUDA where a card
    is present) written as a Chrome trace into a directory.
  * :func:`annotate` (a ``with`` block) and :func:`annotated` (a
    decorator): the program's layer spans, ``fbtt.<layer>``. A span is on
    only while a ``torch.profiler`` records (checked at every entry; no
    knob); off, it costs that check. On, it enters
    ``record_function(name)``, so the span sits in the profiler's trace on
    its clock beside the kernels it launched, and it appends to this
    process's record: its name, the id of its call (the outermost span
    open around it, a step's ``fbtt.step`` or a request's ``fbtt.serve``),
    its host start and end, and on the card a pair of timing events from a
    pool, recorded on the current stream. A span neither synchronises nor
    adds a device operation; the record holds at most ``SPAN_CAP`` spans
    and counts the ones it drops.
  * :func:`count` and :func:`counter`: the program's counters, one
    registry: the kernels' launches (``launches.<kernel>``, always on), the
    folded serve's CUDA graphs (``serve_graph.captures``,
    ``serve_graph.replays``, always on; ``utils.graphs``) and, while spans
    are on, ``lookups``, ``cache_hits``,
    ``serve_graph.spanned_replays``, ``span_reduce.split_spans`` (the
    spans the gradient passes' span reduce adds in more than one chunk;
    ``ops.kernels.seg_accum``) and ``comm.<collective>_bytes`` (the bytes
    this rank puts into each kind of collective; ``parallel.
    collectives``, whose calls are ``fbtt.comm`` spans). :func:`counted_apart` keeps a block's
    counts out of the registry (a capture's launches).
  * :func:`span_totals`: the one readout (it synchronises once): per span
    name its count, host seconds and device seconds (the stream time
    between its events; None on the CPU), each in total and self (less
    its child spans); the calls, the dropped spans and the counters.
    :func:`reset` empties the record and the counters.
  * :func:`kernels_by_span`: a finished profile's device time per kernel,
    under the innermost span open around its launch.
  * :func:`tt_flops`: the reference's FLOP model
    (``tt_embeddings_benchmark.py:153-159``) generalised to any tt_ndim.
  * :func:`slope_time`: seconds per step as the slope between two step
    counts, which takes the fixed cost of a run (launch, synchronise) out.
  * :func:`speed_of_light`: a roofline estimate of one training step of a
    lookup config on the current card.

Spans and counters serve one call at a time: the spans a call's autograd
backward opens on the engine's device thread join that call, since its
caller waits inside it.
"""

from __future__ import annotations

import contextlib
import functools
import os
from time import perf_counter
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# whether a torch.profiler records (on this thread, or on the autograd
# engine's thread working for it): the gate of every span
enabled = torch.autograd._profiler_enabled

SPAN_CAP = 1 << 15  # spans the record holds; later ones are dropped
_OFF = contextlib.nullcontext()  # a span while no profiler records


class _Record:
    """The spans and counters of this process (``_REC``)."""

    def __init__(self):
        # per span: [name, call id, host start, host end, start event,
        # end event]; host end None while open, events None on the CPU
        self.spans: List[list] = []
        self.dropped = 0
        self.depth = 0   # spans open now
        self.call = 0    # id of the latest call
        self.counts: Dict[str, int] = {}
        self.device_counts: Dict[str, torch.Tensor] = {}
        self.free_events: List = []

    def event(self):
        """A timing event recorded on the current stream now, or None
        where this process has not used the card."""
        if not torch.cuda.is_initialized():
            return None
        ev = (self.free_events.pop() if self.free_events
              else torch.cuda.Event(enable_timing=True))
        ev.record()
        return ev


_REC = _Record()


class _Span:
    """One open span (:func:`annotate` while a profiler records)."""

    __slots__ = ("name", "entry", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _REC
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if rec.depth == 0:
            rec.call += 1
        rec.depth += 1
        if len(rec.spans) >= SPAN_CAP:
            rec.dropped += 1
            self.entry = None
        else:
            self.entry = [self.name, rec.call, perf_counter(), None,
                          rec.event(), None]
            rec.spans.append(self.entry)
        return self

    def __exit__(self, *exc):
        rec = _REC
        try:
            if self.entry is not None:
                self.entry[5] = rec.event()
                self.entry[3] = perf_counter()
        finally:
            rec.depth -= 1
            self.rf.__exit__(*exc)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write a Chrome trace (``chrome://tracing``,
    Perfetto) into ``log_dir``; yields the ``torch.profiler.profile``. The
    span record and the counters start empty (:func:`reset`), so that
    :func:`span_totals` after the block reads this capture."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{id(prof)}.json"))


def annotate(name: str):
    """A span named ``name`` around a ``with`` block: recorded while a
    profiler records (:func:`enabled`), else nothing."""
    return _Span(name) if enabled() else _OFF


def annotated(name: str):
    """Decorator: each call of the function is a span (:func:`annotate`)."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not enabled():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def count(name: str, n: int = 1, less: Optional[torch.Tensor] = None):
    """Add ``n`` to the counter ``name`` on the host; ``less``, a 0-d
    device tensor, is taken off on the device (one in-place operation, no
    synchronisation) and read at readout."""
    rec = _REC
    rec.counts[name] = rec.counts.get(name, 0) + n
    if less is not None:
        acc = rec.device_counts.get(name)
        if acc is None:
            acc = rec.device_counts[name] = torch.zeros(
                (), dtype=torch.int64, device=less.device)
        acc.sub_(less)


def counter(name: str) -> int:
    """The counter ``name`` (0 if never counted); synchronises where it has
    a device part."""
    acc = _REC.device_counts.get(name)
    return _REC.counts.get(name, 0) + (int(acc) if acc is not None else 0)


@contextlib.contextmanager
def counted_apart():
    """Keep the host counts made inside the block apart: yields a dict
    that holds them (``{name: n}``) at the block's end, when the counters
    are back where they stood before it."""
    rec = _REC
    before = dict(rec.counts)
    made: Dict[str, int] = {}
    try:
        yield made
    finally:
        for name, n in rec.counts.items():
            if n != before.get(name, 0):
                made[name] = n - before.get(name, 0)
        rec.counts.clear()
        rec.counts.update(before)


def reset() -> None:
    """Empty the span record, number calls from 1 again and zero every
    counter (between calls); the spans' timing events go back to the
    pool."""
    rec = _REC
    rec.free_events.extend(ev for e in rec.spans for ev in e[4:6]
                           if ev is not None)
    rec.spans.clear()
    rec.dropped = rec.call = 0
    rec.counts.clear()
    rec.device_counts.clear()


def span_totals() -> dict:
    """The record read out (one synchronisation where it holds device
    events): ``{"calls": calls with a span, "dropped": spans the cap left
    out, "spans": {name: {"count", "host_s", "host_self_s", "device_s",
    "device_self_s"}}, "counters": {name: value}}``. Self time is the span's
    less its child spans' (those of its call that it encloses); the device
    seconds are the stream time between a span's events, None on the CPU.
    Spans still open are left out."""
    rec = _REC
    if torch.cuda.is_initialized() and any(
            e[4] is not None for e in rec.spans):
        torch.cuda.synchronize()
    spans: Dict[str, dict] = {}
    stack: List[list] = []  # [call, host end, totals, host s, device s]
    calls = set()
    for name, call, t0, t1, e0, e1 in rec.spans:
        if t1 is None:
            continue
        host = t1 - t0
        dev = (e0.elapsed_time(e1) * 1e-3
               if e0 is not None and e1 is not None else None)
        while stack and (stack[-1][0] != call or stack[-1][1] < t1):
            stack.pop()
        tot = spans.setdefault(name, {
            "count": 0, "host_s": 0.0, "host_self_s": 0.0,
            "device_s": None if dev is None else 0.0,
            "device_self_s": None if dev is None else 0.0})
        tot["count"] += 1
        tot["host_s"] += host
        tot["host_self_s"] += host
        if dev is not None and tot["device_s"] is not None:
            tot["device_s"] += dev
            tot["device_self_s"] += dev
        if stack:
            parent = stack[-1]
            parent[2]["host_self_s"] -= host
            if dev is not None and parent[2]["device_self_s"] is not None:
                parent[2]["device_self_s"] -= dev
        stack.append([call, t1, tot])
        calls.add(call)
    counters = {k: counter(k) for k in
                set(rec.counts) | set(rec.device_counts)}
    return {"calls": len(calls), "dropped": rec.dropped, "spans": spans,
            "counters": counters}


def kernels_by_span(events, prefix: str = "fbtt.") -> Dict[str, dict]:
    """``{span: {kernel: [launches, device s]}}`` from a finished
    ``torch.profiler.profile``'s ``events()``: each device operation under
    the innermost span named ``prefix...`` open around the runtime call
    that queued it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ..., which
    shares the operation's correlation id), ``"(none)"`` outside every such
    span. The runtime call, unlike the PyTorch operator the profiler links
    an operation to, also finds the port's own kernels, which no operator
    launches."""
    from torch.autograd import DeviceType

    runtime = {ev.id: ev for ev in events
               if ev.device_type == DeviceType.CPU
               and ev.name.startswith("cu")}
    out: Dict[str, dict] = {}
    for ev in events:
        if (ev.device_type != DeviceType.CUDA or ev.name.startswith(prefix)
                or getattr(ev, "is_user_annotation", False)):
            continue  # not device work (a span's device-side annotation)
        up = runtime.get(ev.id)
        while up is not None and not up.name.startswith(prefix):
            up = up.cpu_parent
        slot = out.setdefault(up.name if up is not None else "(none)",
                              {}).setdefault(ev.name, [0, 0.0])
        slot[0] += 1
        slot[1] += (ev.time_range.end - ev.time_range.start) * 1e-6
    return out


def by_span_text(by_span: Dict[str, dict], calls: int, unit: str,
                 top: int = 8) -> str:
    """:func:`kernels_by_span`'s result as text: each span's device
    microseconds per ``unit`` (one of ``calls``), the largest first, and
    under it its ``top`` kernels by time with their launches per call."""
    lines = [f"device time by span, us/{unit} (each kernel under the "
             "innermost span open around its launch):"]
    for span, kernels in sorted(by_span.items(), key=lambda kv: -sum(
            s for _, s in kv[1].values())):
        total = sum(s for _, s in kernels.values())
        lines.append(f"  {span}: {total * 1e6 / calls:.1f}")
        for name, (n, s) in sorted(kernels.items(),
                                   key=lambda kv: -kv[1][1])[:top]:
            lines.append(f"    {s * 1e6 / calls:9.1f}  x{n / calls:g}  "
                         f"{name[:100]}")
    return "\n".join(lines)

def tt_flops(
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    nnz: int,
    fwd_bwd_factor: float = 3.0,
) -> float:
    """Chain-contraction FLOPs for ``nnz`` lookups.

    Generalizes the reference model (``tt_embeddings_benchmark.py:153-159``):
    per lookup the chain runs (T-1) GEMMs with dims
    ``m_t = prod(q_0..q_t), k_t = r_{t+1}, n_t = q_{t+1} * r_{t+2}``;
    2 MACs each; x ``fwd_bwd_factor`` (3.0 = fwd + two bwd GEMM passes).
    """
    q = list(tt_q_shapes)
    r = list(tt_ranks)
    if len(r) == len(q) - 1:
        r = [1] + r + [1]
    macs = 0
    m = q[0]
    for t in range(1, len(q)):
        macs += m * r[t] * q[t] * r[t + 1]
        m *= q[t]
    return fwd_bwd_factor * 2.0 * macs * nnz


def slope_time(
    run_k: Callable[[int], None],
    iters: int = 100,
    k1: Optional[int] = None,
) -> float:
    """Seconds per step: the slope between ``run_k(k1)`` and
    ``run_k(iters)`` on the host clock, after a warm-up ``run_k(3)``.

    ``run_k(k)`` must run k steps and then synchronise the device
    (``torch.cuda.synchronize()``), so each reading ends when the device
    has finished."""
    if k1 is None:
        k1 = max(iters // 10, 2)
    run_k(3)
    t0 = perf_counter()
    run_k(k1)
    t1 = perf_counter()
    run_k(iters)
    t2 = perf_counter()
    return ((t2 - t1) - (t1 - t0)) / (iters - k1)


# (dense bf16 tensor-core TFLOP/s, HBM GB/s) per device kind, keyed as
# ``torch.cuda.get_device_name()`` names the card: the data sheet's figures
# for NVIDIA H100 80GB HBM3 (SXM) at its 700.00 W power limit; a card set
# to a lower limit runs slower. Unknown kinds take the fallback below.
_DEVICE_SPECS = {
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),
    "cpu": (1.0, 50.0),
}
_FALLBACK_SPECS = (100.0, 800.0)


def speed_of_light(
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    nnz: int,
    batch_size: int,
    device_kind: Optional[str] = None,
) -> dict:
    """Roofline estimate for one fused train step at this config.

    Compute: the chain's forward and backward FLOPs (:func:`tt_flops`).
    Memory: cores in and updated out, indices, pooled output and cotangent
    (the per-lookup gathers counted as free). ``device_kind`` defaults to
    ``torch.cuda.get_device_name()`` ("cpu" where torch sees no card).
    Returns seconds and the binding resource."""
    if device_kind is None:
        device_kind = (torch.cuda.get_device_name()
                       if torch.cuda.is_available() else "cpu")
    tflops, gbs = _DEVICE_SPECS.get(device_kind, _FALLBACK_SPECS)
    q = list(tt_q_shapes)
    r = list(tt_ranks)
    if len(r) == len(q) - 1:
        r = [1] + r + [1]
    flops = tt_flops(q, r, nnz)
    d = int(np.prod(q))
    core_elems = sum(
        p * r[i] * q[i] * r[i + 1] for i, p in enumerate(tt_p_shapes)
    )
    bytes_moved = (
        2 * 4 * core_elems          # cores in + updated out
        + 4 * nnz * 4               # indices + rowidx-ish
        + 2 * 4 * batch_size * d    # pooled out + cotangent
    )
    t_compute = flops / (tflops * 1e12)
    t_memory = bytes_moved / (gbs * 1e9)
    return {
        "device": device_kind,
        "flops": flops,
        "bytes": bytes_moved,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_sol_s": max(t_compute, t_memory),
        "bound": "compute" if t_compute > t_memory else "memory",
    }
