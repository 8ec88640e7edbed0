"""The ``FBTT_*`` environment knobs the port reads.

A copy of the JAX package's registry (``fbtt_embedding_tpu/utils/knobs.py``)
cut to the one knob that means something here:

``FBTT_DG0`` ("fused" | "onehot", default "onehot")
    How the flat pipeline's backward gets the first core's gradient.
    "onehot": the innermost gradient pass (kernel B3) writes the float32
    cotangent dz0 and a float32 one-hot product reduces it. "fused": kernel
    B6 folds dG0 into that pass and dz0 never reaches device memory. Read
    at every call.

The TPU's grid, span-block and layout knobs are not carried over: the
Hopper kernels pick their own blocks.
"""

from __future__ import annotations

import os
from typing import Optional

# knob name -> (kind, default as documented)
PERF_KNOBS = {
    "FBTT_DG0": ("str", "onehot"),
}


def get_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """Raw knob value (``default`` when unset). ``name`` must be
    registered: an unknown knob is a programming error."""
    if name not in PERF_KNOBS:
        raise KeyError(f"unregistered knob {name!r}")
    return os.environ.get(name, default)
