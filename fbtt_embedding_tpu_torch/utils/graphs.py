"""CUDA graphs of a call's device work, captured per call signature.

A serve of frozen weights is a fixed sequence of ~100 small launches whose
shapes follow from the request's; issued one by one from Python, they
leave the card idle while the host dispatches. :class:`ShapeGraphs`
decides, per signature of a call (whatever makes its launches differ:
shapes, dtypes, the state they read), how the call runs:

* a signature's first call runs eagerly: the warm-up (lazy
  initialisation, a kernel library's first-use choices), so that a stream
  of ever-new shapes pays no capture;
* its second call captures, then is served by replay; later calls replay;
* no capture is made while the program's spans are on
  (``profiling.enabled``): a signature met first under a profiler runs
  eagerly;
* at most ``MAX_GRAPHS`` (8) captures are kept, the least recently used
  dropped first; a signature's capture is dropped with its ``owner``, the
  object that holds the state the graphs read (they read it by address).

:func:`capture_stages` captures named stages of a call, each into its own
``torch.cuda.CUDAGraph`` over one private memory pool, and replays each
inside the span of its name, so that the spans' events bracket each
replay on the stream.

Counters, always on like ``launches.<kernel>``: ``serve_graph.captures``
(one per signature captured) and ``serve_graph.replays`` (one per call
served by replay); while spans are on also ``serve_graph.spanned_replays``
(the calls of a profile served by replay). The launches a capture counts
are taken back out (``profiling.counted_apart``) and added again at each
replay, so a replayed call counts the launches an eager call does.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from fbtt_embedding_tpu_torch.utils import profiling

MAX_GRAPHS = 8      # captures a ShapeGraphs keeps
_SEEN_MAX = 64      # signatures met once that it remembers


class ShapeGraphs:
    """The engagement rule of a call's CUDA graphs, by signature (see the
    module docstring). ``capture`` is a function, so the rule runs without
    a card."""

    def __init__(self):
        self._seen: OrderedDict = OrderedDict()   # met once (warmed up)
        self._kept: OrderedDict = OrderedDict()   # -> (replay, launches)
        self._owners: Dict[int, weakref.finalize] = {}

    def __len__(self) -> int:
        return len(self._kept)

    def __call__(self, signature, owner, eager: Callable,
                 capture: Callable, *args):
        """``eager(*args)`` or ``capture(*args) -> replay`` then
        ``replay(*args)``, as the rule says for ``(owner, signature)``."""
        key = (id(owner), signature)
        hit = self._kept.get(key)
        spans = profiling.enabled()
        if spans:  # present, if only as 0, in every profile of a call
            profiling.count("serve_graph.spanned_replays", 0)
        if hit is None:
            if spans or key not in self._seen:
                self._watch(owner)
                self._seen[key] = None
                self._seen.move_to_end(key)
                while len(self._seen) > _SEEN_MAX:
                    self._seen.popitem(last=False)
                return eager(*args)
            del self._seen[key]
            with profiling.counted_apart() as launches:
                replay = capture(*args)
            hit = self._kept[key] = (replay, launches)
            profiling.count("serve_graph.captures")
            while len(self._kept) > MAX_GRAPHS:
                self._kept.popitem(last=False)
        else:
            self._kept.move_to_end(key)
        replay, launches = hit
        for name, n in launches.items():
            profiling.count(name, n)
        profiling.count("serve_graph.replays")
        if spans:
            profiling.count("serve_graph.spanned_replays")
        return replay(*args)

    def _watch(self, owner) -> None:
        oid = id(owner)
        if oid not in self._owners:
            self._owners[oid] = weakref.finalize(
                owner, _forget, weakref.ref(self), oid)

    def _forget_owner(self, oid: int) -> None:
        self._owners.pop(oid, None)
        for table in (self._seen, self._kept):
            for key in [k for k in table if k[0] == oid]:
                del table[key]


def _forget(graphs_ref, oid: int) -> None:
    """An owner died: drop what its serve kept of it (if the serve lives)."""
    graphs = graphs_ref()
    if graphs is not None:
        graphs._forget_owner(oid)


def _clone(x):
    if isinstance(x, (tuple, list)):
        return tuple(t.clone() for t in x)
    return None if x is None else x.clone()


def _copy_into(static, x) -> None:
    if isinstance(static, tuple):
        for s, t in zip(static, x):
            s.copy_(t)
    elif static is not None:
        static.copy_(x)


def capture_stages(stages: Sequence[Tuple[str, Callable[[dict], None]]],
                   inputs: dict):
    """Capture ``stages``, ``[(span name, fn(st))]`` run in order on one
    dict ``st`` that starts as static copies of ``inputs`` (tensors, tuples
    of tensors, or None) and takes each stage's outputs, each stage into its
    own CUDA graph over one private memory pool (the outputs a later stage
    reads stay alive in ``st``). Returns ``replay(inputs) -> st``: the
    request's tensors copied into the static ones, then each graph replayed
    on the current stream inside the span of its name. Nothing runs at
    capture; the first replay computes."""
    static = {k: _clone(v) for k, v in inputs.items()}
    st = dict(static)
    pool = torch.cuda.graph_pool_handle()
    graphs: List[Tuple[str, torch.cuda.CUDAGraph]] = []
    # captured on a side stream, as torch.cuda.graph does, without its
    # synchronisation and emptying of the allocator's cache
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for name, fn in stages:
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool=pool)
            try:
                fn(st)
            finally:
                g.capture_end()
            graphs.append((name, g))
    torch.cuda.current_stream().wait_stream(side)

    def replay(inputs: dict) -> dict:
        for k, x in inputs.items():
            _copy_into(static[k], x)
        for name, g in graphs:
            with profiling.annotate(name):
                g.replay()
        return st

    return replay
