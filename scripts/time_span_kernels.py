#!/usr/bin/env python3
"""Time the span kernels B1, B2, B3 and B6 of one checkout on the headline batch.

Usage: ``python3 scripts/time_span_kernels.py [--root DIR] [--dtype
float32] [--ndim4]`` on a machine with one CUDA card and ``nvcc``.
``--root`` names the checkout whose ``fbtt_embedding_tpu_torch`` is
imported and built (default: this one), so that two versions of the
kernels can be timed on the same inputs on one card: ``chip_smoke.py``
runs it on an older tree unpacked into ``build/ab_old/`` and on this one,
in turns.

The inputs are what a B=512, pooling-20 training step of the headline model
(p=[200,220,250], q=[4,4,4], ranks [32,32], random cores from seed 0)
hands each kernel, on a uniform and a Zipf(1.05) batch from ``--seed``,
made by the package's own plan and table helpers: B1 on the first pass
(i1) and the last pass (i2, as in the serve), B2 on the last pass
(i2), B3 on the first pass (i1, float32 z, as in the fused step) and on the
last pass (bfloat16 z, as in the two-pass backward of the autograd path),
B6 on the first pass and what it replaces there (B3 with a float32 z, then
the float32 one-hot dG0 product, ``tt_flat._dg0``, as the onehot step runs
them), all staged in ``--dtype`` (bfloat16 by default, as
the step stages them). ``--ndim4`` adds B2 and B3 (z in the staging dtype)
on the last pass of a tt_ndim-4 model (q=[4]*4, ranks 32: G[j] 32 x 4
over 16 sub-blocks of x [nnz, 4*512], y [nnz, 4*64]) in float32 and
bfloat16, on ``chip_smoke.span_case``'s Zipf(1.3) span table over 90 core
rows. A package whose wrappers take ``mm`` gets the
block-diagonal fold of the pass (what its pipeline passes); one whose
wrappers do not runs the dense slab, as its pipeline did (asked per
wrapper: B1 took no ``mm`` before B2 and B3 did). Times are device
time per call, the summed durations of the call's kernels over 20 calls
under ``torch.profiler`` (``chip_smoke.device_ms``). Prints one JSON line:
``{"root": ..., "us": {pass: {batch: us}}, "parts": {pass: {batch:
{kernel: us}}}, "sm_mhz": {pass: {batch: MHz}}}``, the SM clock read in
each window (``chip_smoke.sm_clock_mhz``).
"""

import argparse
import inspect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
P, Q, R = [200, 220, 250], [4, 4, 4], [1, 32, 32, 1]
E, D = 200 * 220 * 250, 64
B, POOL = 512, 20


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--ndim4", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_span_kernels: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (  # imports no package at import time
        device_ms,
        kernel_name,
        span_case,
    )

    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np

    import fbtt_embedding_tpu_torch as fbt
    from fbtt_embedding_tpu_torch.ops.kernels import tt_flat
    from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import seg_accum
    from fbtt_embedding_tpu_torch.ops.kernels.seg_accum_dg0 import (
        seg_accum_dg0,
    )
    from fbtt_embedding_tpu_torch.ops.kernels.seg_fused_i2 import seg_fused_i2
    from fbtt_embedding_tpu_torch.ops.kernels.seg_transform import (
        seg_transform,
    )

    folds = "mm" in inspect.signature(seg_accum).parameters
    b1_folds = "mm" in inspect.signature(seg_transform).parameters
    seg = tt_flat.SEG
    dt = getattr(torch, args.dtype)
    cores = fbt.init_tt_cores(np.random.default_rng(0), "uniform", 1, E, D,
                              P, Q, R)
    tcores = fbt.params_from_jax(cores, device="cuda").tt_cores
    g0f, _, tables, widths = tt_flat._flat_setup(tcores, P, Q, R, dt)
    rng = np.random.default_rng(args.seed)
    n = B * POOL
    batches = (("uniform", rng.integers(0, E, size=n)),
               ("zipf1.05", (rng.zipf(1.05, size=n) - 1) % E))
    d_out = torch.as_tensor(rng.standard_normal((1, B, D)),
                            dtype=torch.float32, device="cuda")
    us, parts, clocks = {}, {}, {}

    def timed(name, label, fn):
        dev, per, mhz = device_ms(fn)
        us.setdefault(name, {})[label] = dev * 1e3
        clocks.setdefault(name, {})[label] = mhz
        parts.setdefault(name, {})[label] = {
            kernel_name(k): v * 1e3 for k, v in per.items()}

    for label, ids in batches:
        idx = torch.as_tensor(ids, device="cuda")
        offs = torch.arange(0, n + 1, POOL, device="cuda")
        rowidx, _ = fbt.rowidx_from_offsets(offs, n, 1, B)
        plan, _ = tt_flat._build_plan(idx, rowidx, None, None, None, P, 1, B,
                                      seg=seg)
        z0 = tt_flat._z0(plan, g0f, P[0])

        def span(ti):
            return plan.runs[ti - 1], plan.first[ti - 1], plan.cnt[ti - 1]

        def b1_kw(ti):
            mm, bw_in, bw_out = widths[ti - 1]
            return dict(blocks=Q[0], bw_in=bw_in, bw_out=bw_out,
                        p_rows=P[ti], seg=seg, out_dtype=dt,
                        **({"mm": mm} if b1_folds else {}))

        x1 = seg_transform(*span(1), z0, tables[0], **b1_kw(1))[
            plan.perm_fwd[0].long()]
        dz2 = tt_flat._row_cotangents(d_out, plan, B, D, dt)

        def kw(ti):
            mm, bw_x, bw_y = widths[ti - 1]
            out = dict(blocks=Q[0], bw_x=bw_x, bw_y=bw_y, p_rows=P[ti],
                       seg=seg)
            if folds:
                out["mm"] = mm
            return out

        dz1 = seg_fused_i2(*span(2), x1, dz2, tables[1], **kw(2))[1][
            plan.perm_bwd[0].long()]
        i0c = tt_flat._i0c(plan, P[0])
        calls = {
            "B1 i1": lambda: seg_transform(*span(1), z0, tables[0],
                                           **b1_kw(1)),
            "B1 i2": lambda: seg_transform(*span(2), x1, tables[1],
                                           **b1_kw(2)),
            "B2 i2": lambda: seg_fused_i2(*span(2), x1, dz2, tables[1],
                                          **kw(2)),
            "B3 i1": lambda: seg_accum(*span(1), z0, dz1, tables[0],
                                       z_dtype=torch.float32, **kw(1)),
            "B3 i2": lambda: seg_accum(*span(2), x1, dz2, tables[1],
                                       z_dtype=dt, **kw(2)),
            "B6 i1": lambda: seg_accum_dg0(
                *span(1), z0, dz1, i0c, tables[0], tp0=P[0],
                **{k: v for k, v in kw(1).items() if k != "mm"}),
            "B3 i1 + one-hot dG0": lambda: tt_flat._dg0(
                plan, seg_accum(*span(1), z0, dz1, tables[0],
                                z_dtype=torch.float32, **kw(1))[1],
                P[0], Q[0], R[1]),
        }
        for name, fn in calls.items():
            timed(name, label, fn)
    if args.ndim4:
        blocks, bw_x, bw_y, p_rows, mm = 4, 512, 64, 90, 16
        for sdt in (torch.float32, torch.bfloat16):
            runs, first, cnt, x, y, table = span_case(
                rng, n, blocks, bw_x, bw_y, p_rows, sdt, seg, y_width=bw_y,
                mm=mm)
            skw = dict(blocks=blocks, bw_x=bw_x, bw_y=bw_y, p_rows=p_rows,
                       seg=seg, **({"mm": mm} if folds else {}))
            sargs = (runs, first, cnt, x, y, table)
            name = str(sdt).replace("torch.", "")
            timed(f"B2 ndim4 pass 3 {name}", "zipf1.3",
                  lambda: seg_fused_i2(*sargs, **skw))
            timed(f"B3 ndim4 pass 3 {name}", "zipf1.3",
                  lambda: seg_accum(*sargs, z_dtype=sdt, **skw))
    print(json.dumps({"root": str(Path(fbt.__file__).parents[1]),
                      "dtype": args.dtype, "folds": folds,
                      "b1_folds": b1_folds, "us": us,
                      "parts": parts, "sm_mhz": clocks}))


if __name__ == "__main__":
    main()
