#!/usr/bin/env python3
"""Build, check and time kernel B6 (``seg_accum_dg0``) on a GPU.

Usage: ``python3 scripts/check_dg0_kernel.py [--profile] [--chunks]`` from
the root of a checkout, on a machine with one CUDA card and ``nvcc`` (~30
s; ``--chunks`` ~1 min more).

For each case (the headline i1 pass at B=512, pooling 20, with uniform and
with Zipf(1.05)-skewed first-core rows; a tt_ndim-4 pass; two tables,
tp0 = 2 * p0; widths whose dz0 rows do not fit over the y rows, bw_y 48;
the headline with keys >= tp0 on live rows and valid keys on the sentinel
span's rows), in float32 and in bfloat16 staging, on span tables with
Zipf-skewed core rows and a sentinel tail of dead rows (``chip_smoke.
span_case``), it prints the path the library's rule gives (and fails where
its Python copy, ``dg0_path``, differs), runs ``seg_accum_dg0`` twice on
that path and on every other path that takes the widths, checks that the
two runs are bitwise equal, holds both outputs against
``seg_accum_dg0_plain`` (rtol = atol = 1e-5) and prints the times of B6
and of what it replaces (B3 with a float32 z plus the one-hot dG0
product), CUDA events, mean of 20 back-to-back calls after 3 warm-ups. It
prints the compiler's register report first. With ``--profile`` it also
prints, on the headline bfloat16 cases, the device time of B6 on each path
that takes them, kernel by kernel, and of B3 plus the one-hot product
(``chip_smoke.device_ms``: 20 calls under ``torch.profiler``). A quicker
loop than ``chip_smoke.py`` for work on B6.

Last, the training step's i1 pass (``e11m-train-b65536-zipf``: B=65536,
pooling 20, ids Zipf(1.05) over E = 200 * 220 * 250 as ``h100_bench``
draws them, sorted by i1, nza 1,310,720, nseg 20480, tp0 200; bfloat16
only, ``chip_smoke.train_case``): the plain version would take tens of GB
there (``chip_smoke.py`` runs it block by block), so
acc is held against B3's and dG0, B6's and the one-hot product's, against
a float64 sum of B3's float32 dz0 rows (max |error| / max |dG0| <= 1e-5),
and B6 twice bitwise; with ``--profile`` its kernels' device times beside
B3 plus the one-hot product's.

With ``--chunks``, kernel 2 alone (``span_reduce``, the span reduce B2, B3
and B6 share) on random partial tiles over the spans of the training
cell's i1 pass (tiles of 4096 floats, B6's there, and 8192, the DLRM
cell's i1 tile), of its i2 pass (128, B3's folded tile), of the i1 pass at
smaller batches of the same ids (B=512 to 8192, pooling 20) and of the
headline B=512 i1 pass with Zipf(1.3) and with uniform core rows: its
device time at each chunk of ``SWEEP_CHUNKS`` (0: one chunk a span, the
single pass), the rule's (``span_chunk``) starred.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CASES = [  # name, blocks, bw_x, bw_y, p_rows, nza, tp0, first-core rows
    ("headline i1, uniform i0", 4, 32, 128, 220, 10240, 200, "uniform"),
    ("headline i1, zipf i0", 4, 32, 128, 220, 10240, 200, "zipf"),
    ("ndim4 q=[4]*4 r=[32]*3 pass 1", 4, 32, 128, 60, 2048, 60, "uniform"),
    ("T=2 headline i1", 4, 32, 128, 440, 10240, 400, "uniform"),
    ("dz0 tile widths, bw_y 48", 4, 32, 48, 220, 10240, 200, "uniform"),
    ("headline i1, keys >= tp0 on live rows", 4, 32, 128, 220, 10240, 200,
     "guard"),
]


SWEEP_CHUNKS = (0, 8, 16, 32, 64, 128, 256, 512)


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


def b6_kernel_name(full):
    """A kernel's name, with the B6 epilogue the tensor-core kernel runs
    and the span reduce's pass."""
    from chip_smoke import kernel_name

    for tag, what in (("ZKeyed<true>", " (dz0 over y)"),
                      ("ZKeyed<false>", " (dz0 tile)")):
        if tag in full:
            return kernel_name(full) + what
    if kernel_name(full) == "span_reduce_kernel":
        return kernel_name(full, True)
    return kernel_name(full)


def check_train(profile, card):
    """The training shape: B6 against B3 and a float64 dG0, twice bitwise,
    times beside B3 plus the one-hot product. Returns whether it held."""
    import torch

    from chip_smoke import DG0_TRAIN, device_ms, train_case
    from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import seg_accum
    from fbtt_embedding_tpu_torch.ops.kernels.seg_accum_dg0 import (
        seg_accum_dg0,
    )
    from fbtt_embedding_tpu_torch.ops.kernels.tt_flat import SEG

    name, blocks, bw_x, bw_y, p_rows, nza, tp0 = DG0_TRAIN
    runs, first, cnt, x, y, table, i0c = train_case(
        27, nza, blocks, bw_x, bw_y, p_rows, tp0)
    kw = dict(blocks=blocks, bw_x=bw_x, bw_y=bw_y, p_rows=p_rows, seg=SEG)
    args = (runs, first, cnt, x, y, i0c, table)
    iota = torch.arange(tp0, dtype=torch.int32, device="cuda")

    def unfused():
        acc, z = seg_accum(runs, first, cnt, x, y, table,
                           z_dtype=torch.float32, **kw)
        oh = (i0c[:, None] == iota[None, :]).float()
        return acc, torch.matmul(oh.t(), z)

    def fused():
        return seg_accum_dg0(*args, tp0=tp0, **kw)

    got, again = fused(), fused()
    b3_acc, z = seg_accum(runs, first, cnt, x, y, table,
                          z_dtype=torch.float32, **kw)
    want = torch.zeros((tp0, blocks * bw_x), dtype=torch.float64,
                       device="cuda").index_add_(0, i0c.long(), z.double())
    del z
    onehot = unfused()[1]
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    scale = want.abs().max().item()
    err = (got[1].double() - want).abs().max().item() / scale
    err_oh = (onehot.double() - want).abs().max().item() / scale
    acc_err = (got[0] - b3_acc).abs().max().item() / \
        b3_acc.abs().max().item()
    hot = int((i0c == 0).sum())
    ok = repeat and err <= 1e-5 and acc_err <= 1e-5
    print(f"{name} bfloat16 (nza {nza}, nseg {nza // SEG}, tp0 {tp0}, "
          f"row 0 {hot} rows in {int((i0c.view(-1, SEG) == 0).any(1).sum())}"
          f" segments): acc against B3 {acc_err:.2e}, dG0 against float64 "
          f"{err:.2e} (the one-hot product {err_oh:.2e}), max relative; "
          f"bitwise repeatable {repeat}; ok {ok}")
    del got, again, b3_acc, want, onehot
    k_ms = mean_ms(fused, n=10)
    u_ms = mean_ms(unfused, n=10)
    print(f"  B6 {k_ms * 1e3:.1f} us, B3 + one-hot dG0 {u_ms * 1e3:.1f} us "
          f"between events [{card}]")
    if profile:
        for what, fn in (("B6", fused), ("B3 + one-hot dG0", unfused)):
            dev, per, mhz = device_ms(fn, n=10)
            print(f"  {what} on the device: {dev * 1e3:.2f} us ("
                  + " + ".join(f"{b6_kernel_name(k)} {v * 1e3:.2f}"
                               for k, v in per.items())
                  + f"; SM {mhz} MHz) [{card}]")
    return ok


def sweep_chunks(card):
    """Kernel 2's device time by chunk (see the module docstring)."""
    import numpy as np
    import torch

    from chip_smoke import DG0_TRAIN_P, device_ms, kernel_name
    from fbtt_embedding_tpu_torch.ops.kernels import seg_accum as sa
    from fbtt_embedding_tpu_torch.ops.kernels.tt_flat import SEG, _span_table

    p0, p1, p2 = DG0_TRAIN_P
    rng = np.random.default_rng(30)
    ids = rng.zipf(1.05, size=65536 * 20) % (p0 * p1 * p2)
    small = 10240
    cases = [  # name, sorted keys, p_rows, tiles
        ("training i1", (ids // p2) % p1, p1, (4096, 8192)),
        ("training i2", ids % p2, p2, (128,)),
    ] + [
        (f"B={b} i1", (ids[:b * 20] // p2) % p1, p1, (4096,))
        for b in (512, 1024, 2048, 4096, 8192)
    ] + [
        ("B=512 i1, Zipf(1.3) rows", (rng.zipf(1.3, small) - 1) % p1, p1,
         (4096,)),
        ("B=512 i1, uniform rows", rng.integers(0, p1, small), p1, (4096,)),
    ]
    rule = sa.span_chunk
    try:
        for name, keys, p_rows, tiles in cases:
            nza = keys.shape[0]
            keys = torch.as_tensor(np.sort(keys).astype(np.int32),
                                   device="cuda")
            runs = _span_table(keys, p_rows, nza // SEG)[0]
            nseg = nza // SEG
            for tile in tiles:
                partial = torch.randn((nseg + p_rows, tile), device="cuda")
                star = rule(nseg, p_rows)
                cells = []
                for chunk in sorted(set(SWEEP_CHUNKS) | {star}):
                    sa.span_chunk = lambda *_, c=chunk: c
                    _, per, mhz = device_ms(lambda: sa.span_reduce(
                        runs, partial, p_rows=p_rows, seg=SEG), n=10)
                    us = sum(v for k, v in per.items()
                             if kernel_name(k) == "span_reduce_kernel") * 1e3
                    cells.append(f"{chunk}{'*' if chunk == star else ''} "
                                 f"{us:.2f}")
                print(f"span reduce, {name} (nseg {nseg}, p_rows {p_rows}, "
                      f"tile {tile}), us by chunk: " + ", ".join(cells)
                      + f" (SM {mhz} MHz) [{card}]")
                del partial
    finally:
        sa.span_chunk = rule


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("check_dg0_kernel: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from chip_smoke import device_ms, i0_rows, span_case
    from fbtt_embedding_tpu_torch.ops.kernels import _build
    from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import seg_accum
    from fbtt_embedding_tpu_torch.ops.kernels.seg_accum_dg0 import (
        PATH_NAMES,
        dg0_path,
        dg0_takes,
        seg_accum_dg0,
        seg_accum_dg0_plain,
    )
    from fbtt_embedding_tpu_torch.ops.kernels.tt_flat import SEG

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s")
    for line in libs["seg_accum_dg0"].with_suffix(".log").read_text() \
            .splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("seg_accum_dg0", line.strip())
    card = torch.cuda.get_device_name(0)
    ok = True
    rng = np.random.default_rng(0)
    tol = dict(rtol=1e-5, atol=1e-5)
    for name, blocks, bw_x, bw_y, p_rows, nza, tp0, rows in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            runs, first, cnt, x, y, table = span_case(
                rng, nza, blocks, bw_x, bw_y, p_rows, dtype, SEG,
                y_width=bw_y)
            i0c = i0_rows(rng, runs, p_rows, nza, tp0, rows == "zipf")
            if rows == "guard":
                live_end = int(runs[p_rows])
                bad = torch.as_tensor(rng.choice(live_end, 64, replace=False),
                                      device="cuda")
                i0c[bad[:32]] = tp0
                i0c[bad[32:]] = tp0 + 7
                i0c[live_end:] = torch.as_tensor(
                    rng.integers(0, tp0, nza - live_end), dtype=torch.int32,
                    device="cuda")
            kw = dict(blocks=blocks, bw_x=bw_x, bw_y=bw_y, p_rows=p_rows,
                      tp0=tp0, seg=SEG)
            args = (runs, first, cnt, x, y, i0c, table)
            path = dg0_path(bf16, SEG, blocks, bw_x, bw_y, card=True)
            rule = dg0_path(bf16, SEG, blocks, bw_x, bw_y)
            if path != rule:
                ok = False
                print(f"FAILED: {name}: the library's path {path}, its Python "
                      f"copy's {rule}")
            want = seg_accum_dg0_plain(*args, **kw)
            for p in sorted((p for p in PATH_NAMES
                             if dg0_takes(p, bf16, SEG, blocks, bw_x, bw_y)),
                            key=lambda p: p != path):
                got = seg_accum_dg0(*args, path=p, **kw)
                again = seg_accum_dg0(*args, path=p, **kw)
                torch.cuda.synchronize()
                repeat = all(torch.equal(a, b) for a, b in zip(got, again))
                errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
                case_ok = repeat
                try:
                    for a, b in zip(got, want):
                        torch.testing.assert_close(a, b, **tol)
                except AssertionError as ex:
                    case_ok = False
                    print(ex)
                ok = ok and case_ok
                print(f"{name} {str(dtype)[6:]} (nza {nza}, tp0 {tp0}), "
                      f"{PATH_NAMES[p]}"
                      f"{' (the rule)' if p == path else ''}: max_abs_err acc "
                      f"{errs[0]:.2e}, dG0 {errs[1]:.2e}; bitwise repeatable "
                      f"{repeat}; ok {case_ok}")
            live = i0c < tp0
            iota = torch.arange(tp0, dtype=torch.int32, device="cuda")

            def unfused():
                _, z = seg_accum(runs, first, cnt, x, y, table,
                                 z_dtype=torch.float32,
                                 **{k: v for k, v in kw.items()
                                    if k != "tp0"})
                oh = (torch.where(live, i0c, -1)[:, None]
                      == iota[None, :]).float()
                return torch.matmul(oh.t(), z)

            k_ms = mean_ms(lambda: seg_accum_dg0(*args, **kw))
            u_ms = mean_ms(unfused)
            print(f"  B6 {k_ms * 1e3:.1f} us, B3 + one-hot dG0 "
                  f"{u_ms * 1e3:.1f} us between events [{card}]")
            if "--profile" in sys.argv and bf16 \
                    and name.startswith("headline i1,") and rows != "guard":
                calls = [(f"B6, {PATH_NAMES[p]}",
                          lambda p=p: seg_accum_dg0(*args, path=p, **kw))
                         for p in PATH_NAMES
                         if dg0_takes(p, bf16, SEG, blocks, bw_x, bw_y)]
                for what, fn in calls + [("B3 + one-hot dG0", unfused)]:
                    dev, per, mhz = device_ms(fn)
                    print(f"  {what} on the device: {dev * 1e3:.2f} us ("
                          + " + ".join(f"{b6_kernel_name(k)} {v * 1e3:.2f}"
                                       for k, v in per.items())
                          + f"; SM {mhz} MHz) [{card}]")
    ok = check_train("--profile" in sys.argv, card) and ok
    if "--chunks" in sys.argv:
        sweep_chunks(card)
    if not ok:
        raise SystemExit("check_dg0_kernel: FAILED")


if __name__ == "__main__":
    main()
