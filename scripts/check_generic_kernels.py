#!/usr/bin/env python3
"""Build, check and time the generic kernels B4 and B5 on a GPU.

Usage: ``python3 scripts/check_generic_kernels.py`` from the root of a
checkout, on a machine with one CUDA card and ``nvcc`` (~20 s).

For each case (the headline model at B=512, pooling 20, uniform and Zipf
1.05 row ids; a tt_ndim-2, a tt_ndim-4 and a rank-64 model; two weighted
tables; a live-count tail), with random cores from seed 0, it runs
``tt_fwd`` and ``tt_bwd`` (twice) on the card, holds them against
``tt_fwd_plain`` / ``tt_bwd_plain`` (forward rtol = atol = 1e-5, gradients
rtol 1e-4, atol 1e-5), checks that the two B5 runs are bitwise equal, and
prints the kernels' times (CUDA events, mean of 20 back-to-back launches
after 3 warm-ups). It prints the compiler's register report first. A
quicker loop than ``chip_smoke.py`` for work on these two kernels; to
compare two versions, run it from both trees in one call.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CASES = [  # p, q, inner ranks, B, pooling, tables, zipf, weights, live
    ([200, 220, 250], [4, 4, 4], [32, 32], 512, 20, 1, False, False, None),
    ([200, 220, 250], [4, 4, 4], [32, 32], 512, 20, 1, True, False, None),
    ([100, 100], [8, 8], [32], 512, 8, 1, False, False, None),
    ([20, 20, 20, 20], [4, 4, 4, 4], [32, 32, 32], 64, 8, 1, False, False,
     None),
    ([20, 22, 25], [4, 4, 4], [16, 16], 64, 8, 2, False, True, None),
    ([200, 220, 250], [4, 4, 4], [32, 32], 128, 20, 1, False, True, 1500),
    ([30, 30, 30], [4, 4, 4], [64, 64], 64, 8, 1, False, False, None),
]


def mean_ms(fn, n=20):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("check_generic_kernels: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import fbtt_embedding_tpu_torch as fbt
    from fbtt_embedding_tpu_torch.ops.kernels import _build
    from fbtt_embedding_tpu_torch.ops.kernels import tt_kernel as K

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s")
    for stem in ("tt_fwd", "tt_bwd"):
        for line in libs[stem].with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(stem, line.strip())
    ok = True
    for p, q, ranks, b, pool, tables, zipf, weights, live in CASES:
        rfull = [1] + ranks + [1]
        e, d = int(np.prod(p)), int(np.prod(q))
        rng = np.random.default_rng(0)
        nnz = tables * b * pool

        def dev(a, dtype=torch.int32):
            return torch.as_tensor(a, dtype=dtype, device="cuda")

        cores = [dev(c, torch.float32) for c in fbt.init_tt_cores(
            rng, "uniform", tables, e, d, p, q, rfull)]
        ids = ((rng.zipf(1.05, size=nnz) - 1) % e if zipf
               else rng.integers(0, e, size=nnz))
        rowidx = dev(np.arange(nnz) // pool % b)
        tbl = dev(np.arange(nnz) // (b * pool)) if tables > 1 else None
        w = dev(rng.random(nnz), torch.float32) if weights else None
        lc = dev([live]) if live is not None else None
        parts = fbt.decompose_indices(dev(ids, torch.int64), p)
        dout = dev(rng.normal(size=(tables * b, d)), torch.float32)
        gk = K._kernel_cores(cores, p, q, rfull)
        idx, rowv, wv = K.block_inputs(parts, rowidx, tbl, w, lc, p, tables,
                                       b)
        order, starts = K.bag_order(rowv, tables * b)
        sched = K.core_orders(idx, rowv, [tables * x for x in p], K.SEG)
        fargs = (gk, idx, rowv, wv, order, starts)
        bargs = (gk, idx, rowv, wv, dout, *sched)
        out = fbt.tt_fwd(*fargs)
        g1 = fbt.tt_bwd(*bargs, seg=K.SEG)
        g2 = fbt.tt_bwd(*bargs, seg=K.SEG)
        torch.cuda.synchronize()
        repeat = all(torch.equal(x, y) for x, y in zip(g1, g2))
        ref = fbt.tt_fwd_plain(*fargs)
        gref = fbt.tt_bwd_plain(*bargs, seg=K.SEG)
        errs = [(x - y).abs().max().item() for x, y in zip(g1, gref)]
        case_ok = repeat
        try:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
            for x, y in zip(g1, gref):
                torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)
        except AssertionError as ex:
            case_ok = False
            print(ex)
        ok = ok and case_ok
        f_ms = mean_ms(lambda: fbt.tt_fwd(*fargs))
        b_ms = mean_ms(lambda: fbt.tt_bwd(*bargs, seg=K.SEG))
        print(f"p={p} q={q} ranks={ranks} T={tables} B={b} pooling {pool} "
              f"zipf={zipf} weights={weights} live={live}: forward max_abs_"
              f"err {(out - ref).abs().max().item():.2e}, gradients "
              + ", ".join(f"{x:.2e}" for x in errs)
              + f"; B5 bitwise repeatable {repeat}; ok {case_ok}; B4 "
              f"{f_ms * 1e3:.1f} us, B5 {b_ms * 1e3:.1f} us "
              f"[{torch.cuda.get_device_name(0)}]")
    if not ok:
        raise SystemExit("check_generic_kernels: FAILED")


if __name__ == "__main__":
    main()
