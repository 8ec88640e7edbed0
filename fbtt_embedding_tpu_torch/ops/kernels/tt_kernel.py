"""Core layouts shared by the flat pipeline.

Counterpart of the layout helpers of ``fbtt_embedding_tpu/ops/pallas/
tt_kernel.py``. The generic per-lookup kernels of that module (B4, B5) are
not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def kernel_core_layouts(tt_cores: Sequence[torch.Tensor], tt_p_shapes,
                        tt_q_shapes, tt_ranks) -> Tuple[torch.Tensor, ...]:
    """Module storage ``[T, p, r*q*r']`` -> kernel layouts (pure reshapes):
    core 0 ``[T*p0, q0, r1]``, middle cores ``[T*p, r, q*r']``, the last
    core ``[T*p, r, q]``."""
    ndim = len(tt_p_shapes)
    t = tt_cores[0].shape[0]
    out = []
    for i in range(ndim):
        p, qq = tt_p_shapes[i], tt_q_shapes[i]
        ra, rb = tt_ranks[i], tt_ranks[i + 1]
        if i == 0:
            out.append(tt_cores[0].reshape(t * p, qq, rb))
        elif i == ndim - 1:
            out.append(tt_cores[i].reshape(t * p, ra, qq))
        else:
            out.append(tt_cores[i].reshape(t * p, ra, qq * rb))
    return tuple(out)


def grads_to_module_layout(dgs: Sequence[torch.Tensor], tt_p_shapes,
                           tt_q_shapes, tt_ranks,
                           num_tables: int) -> Tuple[torch.Tensor, ...]:
    """Kernel-layout gradients -> module storage ``[T, p_t, r_t*q_t*r_{t+1}]``
    (pure reshapes)."""
    return tuple(
        dgs[i].reshape(num_tables, tt_p_shapes[i],
                       tt_ranks[i] * tt_q_shapes[i] * tt_ranks[i + 1])
        for i in range(len(tt_p_shapes)))
