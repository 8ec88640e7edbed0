"""Profiling and performance accounting.

Counterpart of ``fbtt_embedding_tpu.utils.profiling``:

  * :func:`trace`: a ``torch.profiler`` capture (CPU, and CUDA where a card
    is present) written as a Chrome trace into a directory.
  * :func:`annotate`: a named region inside a capture.
  * :func:`tt_flops`: the reference's FLOP model
    (``tt_embeddings_benchmark.py:153-159``) generalised to any tt_ndim.
  * :func:`slope_time`: seconds per step as the slope between two step
    counts, which takes the fixed cost of a run (launch, synchronise) out.
  * :func:`speed_of_light`: a roofline estimate of one training step of a
    lookup config on the current card.
"""

from __future__ import annotations

import contextlib
import os
from time import perf_counter
from typing import Callable, Optional, Sequence

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write a Chrome trace (``chrome://tracing``,
    Perfetto) into ``log_dir``; yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{id(prof)}.json"))


def annotate(name: str):
    """Named region inside a :func:`trace` capture."""
    return torch.profiler.record_function(name)


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
