#!/usr/bin/env python3
"""Build, check and time kernel B6 (``seg_accum_dg0``) on a GPU.

Usage: ``python3 scripts/check_dg0_kernel.py`` from the root of a checkout,
on a machine with one CUDA card and ``nvcc`` (~20 s).

For each case (the headline i1 pass at B=512, pooling 20, with uniform and
with Zipf(1.05)-skewed first-core rows; a tt_ndim-4 pass; two tables,
tp0 = 2 * p0), in float32 and in bfloat16 staging, on span tables with
Zipf-skewed core rows and a sentinel tail of dead rows (``chip_smoke.
span_case``), it runs ``seg_accum_dg0`` twice, checks that the two runs are
bitwise equal, holds both outputs against ``seg_accum_dg0_plain`` (rtol =
atol = 1e-5) and prints the times of B6 and of what it replaces (B3 with a
float32 z plus the one-hot dG0 product), CUDA events, mean of 20
back-to-back calls after 3 warm-ups. It prints the compiler's register
report first. With ``--profile`` it also prints the device time of each of
B6's three kernels on the headline bfloat16 case (``torch.profiler``, 20
calls). A quicker loop than ``chip_smoke.py`` for work on B6.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CASES = [  # name, blocks, bw_x, bw_y, p_rows, nza, tp0, zipf i0
    ("headline i1, uniform i0", 4, 32, 128, 220, 10240, 200, False),
    ("headline i1, zipf i0", 4, 32, 128, 220, 10240, 200, True),
    ("ndim4 q=[4]*4 r=[32]*3 pass 1", 4, 32, 128, 60, 2048, 60, False),
    ("T=2 headline i1", 4, 32, 128, 440, 10240, 400, False),
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


def profile(fn, n=20):
    """Device time per call of each CUDA kernel ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof

    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for ev in p.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0))
        if dev_us and ev.count >= n and "kernel" in ev.key.lower():
            print(f"  {ev.key[:70]}: {dev_us / n:.1f} us per call")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("check_dg0_kernel: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from chip_smoke import i0_rows, span_case
    from fbtt_embedding_tpu_torch.ops.kernels import _build
    from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import seg_accum
    from fbtt_embedding_tpu_torch.ops.kernels.seg_accum_dg0 import (
        seg_accum_dg0,
        seg_accum_dg0_plain,
    )
    from fbtt_embedding_tpu_torch.ops.kernels.tt_flat import SEG

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s")
    for line in libs["seg_accum_dg0"].with_suffix(".log").read_text() \
            .splitlines():
        if "registers" in line or "spill" in line:
            print("seg_accum_dg0", line.strip())
    ok = True
    rng = np.random.default_rng(0)
    tol = dict(rtol=1e-5, atol=1e-5)
    for name, blocks, bw_x, bw_y, p_rows, nza, tp0, zipf in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            runs, first, cnt, x, y, table = span_case(
                rng, nza, blocks, bw_x, bw_y, p_rows, dtype, SEG,
                y_width=bw_y)
            i0c = i0_rows(rng, runs, p_rows, nza, tp0, zipf)
            kw = dict(blocks=blocks, bw_x=bw_x, bw_y=bw_y, p_rows=p_rows,
                      seg=SEG)
            args = (runs, first, cnt, x, y, i0c, table)
            got = seg_accum_dg0(*args, tp0=tp0, **kw)
            again = seg_accum_dg0(*args, tp0=tp0, **kw)
            torch.cuda.synchronize()
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            want = seg_accum_dg0_plain(*args, tp0=tp0, **kw)
            errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
            case_ok = repeat
            try:
                for a, b in zip(got, want):
                    torch.testing.assert_close(a, b, **tol)
            except AssertionError as ex:
                case_ok = False
                print(ex)
            ok = ok and case_ok
            live = i0c < tp0
            iota = torch.arange(tp0, dtype=torch.int32, device="cuda")

            def unfused():
                _, z = seg_accum(runs, first, cnt, x, y, table,
                                 z_dtype=torch.float32, **kw)
                oh = (torch.where(live, i0c, -1)[:, None]
                      == iota[None, :]).float()
                return torch.matmul(oh.t(), z)

            k_ms = mean_ms(lambda: seg_accum_dg0(*args, tp0=tp0, **kw))
            u_ms = mean_ms(unfused)
            print(f"{name} {str(dtype)[6:]} (nza {nza}, tp0 {tp0}): "
                  f"max_abs_err acc {errs[0]:.2e}, dG0 {errs[1]:.2e}; "
                  f"bitwise repeatable {repeat}; ok {case_ok}; B6 "
                  f"{k_ms * 1e3:.1f} us, B3 + one-hot dG0 {u_ms * 1e3:.1f} us "
                  f"[{torch.cuda.get_device_name(0)}]")
            if "--profile" in sys.argv and name == CASES[0][0] \
                    and dtype == torch.bfloat16:
                profile(lambda: seg_accum_dg0(*args, tp0=tp0, **kw))
    if not ok:
        raise SystemExit("check_dg0_kernel: FAILED")


if __name__ == "__main__":
    main()
