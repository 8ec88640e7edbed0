#!/usr/bin/env python3
"""Build, check and time the generic kernels B4 and B5 on a GPU.

Usage: ``python3 scripts/check_generic_kernels.py [--root DIR]`` from the
root of a checkout, on a machine with one CUDA card and ``nvcc``
(~30 s). ``--root`` names the checkout whose ``fbtt_embedding_tpu_torch``
is imported and built (default: this one), so that two versions of the
kernels are checked and timed on the same inputs on one card:
``chip_smoke.py`` runs it on an older tree unpacked into ``build/ab_old/``
and on this one, in turns.

For each case (the headline model at B=512, pooling 20, uniform and Zipf
1.05 row ids; a tt_ndim-2 model, uniform and Zipf; a tt_ndim-4 model; the
billion-row tt_ndim-4 model, p=[125,200,200,200], q=[2,4,2,4], ranks 32,
at B=512, pooling 20, uniform and Zipf; a rank-64 model; two weighted
tables; a live-count tail), with random cores
from seed 2, it runs ``tt_fwd`` and ``tt_bwd`` twice each on the card,
holds them against ``tt_fwd_plain`` / ``tt_bwd_plain`` (forward rtol =
atol = 1e-5, gradients rtol 1e-4, atol 1e-5), checks that each kernel's
two runs are bitwise equal, and times both kernels as device time per
call (the summed durations of the call's kernels over 20 calls under
``torch.profiler``, ``chip_smoke.device_ms``, with the SM clock read in
each window) and between CUDA events (``chip_smoke.cuda_ms``). B4 gets
its pivot orders as the step's forward builds them (``core1``: core 1's,
and at tt_ndim 4 core 2's too, where the package's ``tt_fwd`` takes it),
so their sorts are not timed. It prints each
kernel's path where the package has a path query (``tt_fwd.fwd_path``,
``tt_bwd.bwd_path``; an older tree runs the chain pass) and the
compiler's register report first. It runs WARM_S seconds of float32
products before the first case, so that a fresh process does not time the
card at its idle clocks. The last line is one JSON object: ``{"root":
..., "card": ..., "cases": {name: {"path": ..., "tt_fwd_path": ...,
"tt_bwd_path": ..., "tt_fwd_us": .., "tt_bwd_us": .., "tt_fwd_mhz": ..,
"tt_bwd_mhz": .., "tt_fwd_event_us": .., "tt_bwd_event_us": ..,
"tt_fwd_parts": {kernel: us}, "tt_bwd_parts": {kernel: us}}}}`` (``path``
is B5's, as before). Exits 1 if a check fails.
"""

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 2
WARM_S = 2.0  # seconds of float32 products before the first case

CASES = [  # name, p, q, inner ranks, B, pooling, tables, zipf, weights, live
    ("headline uniform", [200, 220, 250], [4, 4, 4], [32, 32], 512, 20, 1,
     False, False, None),
    ("headline zipf1.05", [200, 220, 250], [4, 4, 4], [32, 32], 512, 20, 1,
     True, False, None),
    ("ndim2 uniform", [3300, 3300], [8, 8], [32], 512, 20, 1, False, False,
     None),
    ("ndim2 zipf1.05", [3300, 3300], [8, 8], [32], 512, 20, 1, True, False,
     None),
    ("ndim4", [60] * 4, [4] * 4, [32] * 3, 64, 8, 1, False, False, None),
    ("ndim4 billion uniform", [125, 200, 200, 200], [2, 4, 2, 4], [32] * 3,
     512, 20, 1, False, False, None),
    ("ndim4 billion zipf1.05", [125, 200, 200, 200], [2, 4, 2, 4], [32] * 3,
     512, 20, 1, True, False, None),
    ("rank64", [200, 220, 250], [4, 4, 4], [64, 64], 512, 20, 1, False,
     False, None),
    ("T=2 weighted", [200, 220, 250], [4, 4, 4], [32, 32], 128, 20, 2,
     False, True, None),
    ("live-count tail", [200, 220, 250], [4, 4, 4], [32, 32], 256, 20, 1,
     True, True, 0.75),
]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("check_generic_kernels: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (  # imports no package at import time
        cuda_ms,
        device_ms,
        generic_inputs,
        kernel_name,
        mhz_text,
    )

    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np

    import fbtt_embedding_tpu_torch as fbt
    from fbtt_embedding_tpu_torch.ops.kernels import _build
    from fbtt_embedding_tpu_torch.ops.kernels import tt_bwd as bwd_mod
    from fbtt_embedding_tpu_torch.ops.kernels import tt_fwd as fwd_mod
    from fbtt_embedding_tpu_torch.ops.kernels import tt_kernel as K
    from fbtt_embedding_tpu_torch.ops.kernels.tt_fwd import chain_dims

    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s "
          f"({Path(fbt.__file__).parent})")
    for stem in ("tt_fwd", "tt_bwd"):
        for line in libs[stem].with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(stem, line.strip())
    t0 = time.perf_counter()
    a = torch.randn(4096, 4096, device="cuda")
    while time.perf_counter() - t0 < WARM_S:
        a = torch.tanh(a @ a)
        torch.cuda.synchronize()
    ok = True
    out = {}
    for name, p, q, ranks, b, pool, tables, zipf, weights, live in CASES:
        gk, idx, rowv, wv, order, starts, sched, dout = generic_inputs(
            np.random.default_rng(SEED), p, q, ranks, b, pool, tables,
            zipf, weights, live)
        fargs = (gk, idx, rowv, wv, order, starts)
        bargs = (gk, idx, rowv, wv, dout, *sched)
        # the pivot orders: core 1's, and at tt_ndim 4 core 2's too (an
        # older tree's chain pass at tt_ndim 4 reads none)
        fkw = ({"core1": tuple(x[1:3] if len(p) == 4 else x[1]
                               for x in sched[:2])}
               if "core1" in inspect.signature(fbt.tt_fwd).parameters else {})
        out_k = fbt.tt_fwd(*fargs, **fkw)
        out_2 = fbt.tt_fwd(*fargs, **fkw)
        g1 = fbt.tt_bwd(*bargs, seg=K.SEG)
        g2 = fbt.tt_bwd(*bargs, seg=K.SEG)
        torch.cuda.synchronize()
        repeat = (torch.equal(out_k, out_2)
                  and all(torch.equal(x, y) for x, y in zip(g1, g2)))
        ref = fbt.tt_fwd_plain(*fargs)
        gref = fbt.tt_bwd_plain(*bargs, seg=K.SEG)
        errs = [(x - y).abs().max().item() for x, y in zip(g1, gref)]
        case_ok = repeat
        try:
            torch.testing.assert_close(out_k, ref, rtol=1e-5, atol=1e-5)
            for x, y in zip(g1, gref):
                torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)
        except AssertionError as ex:
            case_ok = False
            print(ex)
        ok = ok and case_ok
        path = (bwd_mod.bwd_path(*chain_dims(gk), card=True)
                if hasattr(bwd_mod, "bwd_path") else ("chain", None))
        fpath = (fwd_mod.fwd_path(*chain_dims(gk), card=True)
                 if hasattr(fwd_mod, "fwd_path") else ("chain", None))
        f_ms, f_parts, f_mhz = device_ms(lambda: fbt.tt_fwd(*fargs, **fkw))
        f_us = f_ms * 1e3
        b_ms, b_parts, b_mhz = device_ms(
            lambda: fbt.tt_bwd(*bargs, seg=K.SEG))
        f_ev = cuda_ms(lambda: fbt.tt_fwd(*fargs, **fkw), reps=10,
                       inner=5) * 1e3
        b_ev = cuda_ms(lambda: fbt.tt_bwd(*bargs, seg=K.SEG), reps=10,
                       inner=5) * 1e3
        fparts, parts = {}, {}
        for got, src in ((fparts, f_parts), (parts, b_parts)):
            for k, v in src.items():  # a pivot pass per template instance
                label = kernel_name(k, templates=True)
                got[label] = got.get(label, 0.0) + v * 1e3
        out[name] = {"path": path[0], "tt_fwd_path": fpath[0],
                     "tt_bwd_path": path[0], "tt_fwd_us": f_us,
                     "tt_bwd_us": b_ms * 1e3, "tt_fwd_mhz": f_mhz,
                     "tt_bwd_mhz": b_mhz, "tt_fwd_event_us": f_ev,
                     "tt_bwd_event_us": b_ev, "tt_fwd_parts": fparts,
                     "tt_bwd_parts": parts}
        print(f"{name}: p={p} q={q} ranks={ranks} T={tables} B={b} pooling "
              f"{pool} (nnz {idx.shape[1]}, {int((rowv < 0).sum())} dead): "
              f"B4 path {fpath[0]} (chunk {fpath[1]}), B5 path {path[0]} "
              f"(chunk {path[1]}); forward max_abs_err "
              f"{(out_k - ref).abs().max().item():.2e}, gradients "
              + ", ".join(f"{x:.2e}" for x in errs)
              + f"; B4 and B5 bitwise repeatable {repeat}; ok {case_ok}; "
              f"device B4 {f_us:.2f} us ("
              + " + ".join(f"{k} {v:.2f}" for k, v in fparts.items())
              + f"; {mhz_text(f_mhz)}), B5 {b_ms * 1e3:.2f} us ("
              + " + ".join(f"{k} {v:.2f}" for k, v in parts.items())
              + f"; {mhz_text(b_mhz)}); events B4 {f_ev:.2f} us, B5 "
              f"{b_ev:.2f} us [{card}]")
    print(json.dumps({"root": str(Path(fbt.__file__).parents[1]),
                      "card": card, "ok": ok, "cases": out}))
    if not ok:
        raise SystemExit("check_generic_kernels: FAILED")


if __name__ == "__main__":
    main()
