"""The collectives of the multi-GPU layer, one wrapper per operation.

Every collective of ``parallel`` goes through these wrappers, on an explicit
process group (a mesh axis's, or the world's):

- :func:`all_reduce_sum`: one ``all_reduce(SUM)`` of several tensors,
  flattened into one buffer;
- :func:`all_gather_cat`: the group's tensors concatenated along dim 0 in
  group-rank order;
- :func:`all_to_all`: ``all_to_all_single`` on dim 0 (equal splits).

NCCL takes CUDA tensors; gloo takes CPU tensors and, for these three
operations, CUDA tensors too (it copies them through pinned host memory
itself: ``scripts/probe_gloo_cuda.py`` on the H100 machine's PyTorch 2.11),
so a world of several ranks on one card runs on gloo with the tensors
where they are. A backend that refuses a call raises.

Each wrapper counts its calls in ``calls``. Inside :func:`timed` each call
also synchronises the card before and after and adds its host time: the
collectives' share of a step, at the cost of the overlap they would have.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Sequence

import torch
import torch.distributed as dist

_TIMERS: List[dict] = []


@contextlib.contextmanager
def _counted(fn, device: torch.device):
    """Count one call of the wrapper ``fn``; inside :func:`timed`, time it
    between two synchronisations."""
    fn.calls += 1
    if not _TIMERS:
        yield
        return
    sync = device.type == "cuda"
    if sync:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if sync:
        torch.cuda.synchronize(device)
    for t in _TIMERS:
        t["ms"] += (time.perf_counter() - t0) * 1e3
        t["calls"] += 1


@contextlib.contextmanager
def timed():
    """Time every collective inside the block: yields ``{"ms": host
    milliseconds, "calls": n}``, filled as the calls run."""
    rec = {"ms": 0.0, "calls": 0}
    _TIMERS.append(rec)
    try:
        yield rec
    finally:
        _TIMERS.remove(rec)


def all_reduce_sum(tensors: Sequence[torch.Tensor],
                   group=None) -> List[torch.Tensor]:
    """The sums over ``group`` of ``tensors`` (one dtype and device), by one
    ``all_reduce(SUM)`` of a flattened copy: new tensors, in order, views
    of that one buffer."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    with _counted(all_reduce_sum, flat.device):
        dist.all_reduce(flat, group=group)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_gather_cat(t: torch.Tensor, group=None) -> torch.Tensor:
    """The group's ``t`` (same shape on every rank) concatenated along dim
    0, in group-rank order."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(n)]
    with _counted(all_gather_cat, t.device):
        dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """``all_to_all_single``: dim 0 of ``t`` in as many equal blocks as the
    group has ranks, block ``j`` sent to rank ``j``; the result's block
    ``i`` is what rank ``i`` sent."""
    t = t.contiguous()
    out = torch.empty_like(t)
    with _counted(all_to_all, t.device):
        dist.all_to_all_single(out, t, group=group)
    return out


for _fn in (all_reduce_sum, all_gather_cat, all_to_all):
    _fn.calls = 0
