"""The ``FBTT_*`` environment knobs the port reads.

The port's copy of the JAX package's registry
(``fbtt_embedding_tpu/utils/knobs.py``), with the knobs that mean something
on the card. Each is an environment variable read at every call (nothing is
traced, so a change takes effect at the next call). Every default is the
setting the library picks by itself; "unset" is the production setting,
and a knob is an A/B instrument. A knob chooses between two exact
schedules and never hides a kernel: a forced setting that cannot run raises
as the unforced path would. Kernels: B1 ``seg_transform``, B2
``seg_fused_i2``, B3 ``seg_accum``, B6 ``seg_accum_dg0``; launch counts
below are per training step of the headline model (p=[200, 220, 250],
q=[4, 4, 4], ranks [32, 32], pooling 20).

``FBTT_DG0`` ("onehot"; default: B6 where it fits)
    How the flat pipeline's backward gets the first core's gradient
    (``tt_flat._dg0_fused_gate``). By default B6 folds dG0 into the
    innermost gradient pass and dz0 never reaches device memory, wherever
    ``dg0_fits`` takes the pass's staging dtype and widths (q0, r1,
    q1*r2); elsewhere, and everywhere under "onehot", that pass (B3)
    writes the float32 cotangent dz0 and a float32 one-hot product
    reduces it. Any other value is the default: the rule reads nothing
    but the dtype and the widths. "onehot" is the JAX package's default,
    which suits the TPU's matrix unit; on the card its float32 product
    costs more than B6 at every size measured. At B=512: default B1 1,
    B2 1, B6 1, B3 0; "onehot" B1 1, B2 1, B3 1.
``FBTT_PAIR`` ("0" | "1", default auto: nza >= 16384)
    The first pass's G0xG1 pair-product table (``tt_flat._pair_gate``).
    With it, a per-call ``[T*p0*p1 + 1, q0*q1*r2]`` table replaces the z0
    gather, B1's first pass and one permute; the backward recomputes z0.
    "1" takes it at any nza, "0" never, anything else means auto. Neither
    overrides the structural gate (``pair_structural_ok``: tt_ndim >= 3,
    pair ids in int32, the table within 96 MiB). Every lookup that builds
    a plan reads it: ``FlatLookup``, ``flat_train_apply``, the modules,
    the DLRM's ``fixed_pool_lookup`` and the sharded steps. The folded
    serve builds its table once and takes the structural gate alone, as
    the JAX package's ``make_serving_fold`` does. At B=512: default B1 1,
    B2 1, B6 1; "1": B1 0, B2 1, B6 1.
``FBTT_FUSED_APPLY`` ("0" | "1", default auto: nnz <= 32768)
    Whether ``make_fused_train_step`` (and the sharded steps, through the
    same ``_forward_backward``) runs ``flat_train_apply``, whose last core
    is one fused forward + backward pass (B2), or differentiates
    ``FlatLookup`` (B1 forward on every pass, B3 backward on every pass
    but the first, which B6 takes). "1" takes the fused apply at any nnz,
    "0" never, anything else means auto; ``impl`` "auto" or
    "pallas_sorted" and an exact flat config are still required. The
    module's backward differentiates ``FlatLookup`` and does not read it.
    At B=512: "0" gives B1 2, B2 0, B3 1, B6 1; at B=2048 (nnz 40960, pair
    mode by default): default B1 1, B2 0, B3 1, B6 1, "1" B1 0, B2 1, B6
    1.

Not carried, from the JAX package's eleven:

- ``FBTT_SEG``, ``FBTT_SPAN_BLOCK``, ``FBTT_SPP``, ``FBTT_TRIP_SB``,
  ``FBTT_TRIP``: the TPU's grid segments, span blocks and trip blocks. The
  port's segment (``tt_flat.SEG = 64``) is one CTA of the kernels, and
  B6's path rule (``dg0_fits``) is sized for it.
- ``FBTT_ACC_T``: transposed gradient accumulators, a TPU lane layout.
- ``FBTT_PACK_PERM``: uint32-packed bf16 rows for the sort-order
  permutes, a TPU gather layout.
- ``FBTT_HOT_SCATTER``: the port has one scatter for the cache rows
  (``ops/hot_scatter.py``), so "0" would change nothing.

Process config for ``parallel/multihost.py`` (not perf knobs):
``FBTT_COORDINATOR``, ``FBTT_NUM_PROCESSES``, ``FBTT_PROCESS_ID``.

``python -m fbtt_embedding_tpu_torch.utils.knobs`` prints the settings.
"""

from __future__ import annotations

import os
from typing import Optional

# knob name -> (kind, default as documented)
PERF_KNOBS = {
    "FBTT_DG0": ("str", "B6 where dg0_fits"),
    "FBTT_PAIR": ("bool01", "auto (nza >= 16384)"),
    "FBTT_FUSED_APPLY": ("bool01", "auto (nnz <= 32768)"),
}

CONFIG_ENV = ("FBTT_COORDINATOR", "FBTT_NUM_PROCESSES", "FBTT_PROCESS_ID")


def get_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """Raw knob value (``default`` when unset). ``name`` must be
    registered: an unknown knob is a programming error."""
    if name not in PERF_KNOBS and name not in CONFIG_ENV:
        raise KeyError(f"unregistered knob {name!r}")
    return os.environ.get(name, default)


def get_int(name: str) -> Optional[int]:
    """Integer knob, or None when unset or empty."""
    v = get_str(name)
    return int(v) if v else None


def describe() -> str:
    """The perf knobs' settings, one line each with its default."""
    lines = ["FBTT_* knob settings (unset = the library's own choice):"]
    for name, (_, default) in PERF_KNOBS.items():
        v = os.environ.get(name)
        lines.append(f"  {name:<18} = {v if v is not None else '<unset>':<10}"
                     f" (default: {default})")
    return "\n".join(lines)


if __name__ == "__main__":
    print(describe())
