#!/usr/bin/env python3
"""Drive fbtt_embedding_tpu_torch on one NVIDIA GPU and check it.

Usage: ``python3 chip_smoke.py`` from the root of a checkout (needs one
CUDA card and ``nvcc``). Phases, each printing its own lines:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every kernel of ``fbtt_embedding_tpu_torch/csrc`` into
   ``build/`` (one ``nvcc`` per source, all at once) and load it;
3. kernels vs plain: the segment-transform kernel (B1) at both headline
   pass shapes in float32 and bfloat16, and at one tt_ndim-2 and one
   tt_ndim-4 pass; the fused last-core training pass (B2) and the gradient
   pass (B3) at the headline training pass shapes and at two tt_ndim-4
   passes whose slabs take several staging chunks, in float32 and bfloat16
   (B3 with float32 and bfloat16 z), on Zipf-skewed span tables with a
   sentinel tail, each run twice and required bitwise equal; the generic
   forward (B4) and backward (B5) in float32 on the headline batch
   (uniform and Zipf 1.05), a tt_ndim-2 and a tt_ndim-4 model, two tables
   with weights and a live-count tail, B5 run twice and required bitwise
   equal;
4. serve: the headline model (p=[200,220,250], q=[4,4,4], ranks [32,32]:
   E=11M, D=64) with random cores from seed 0 serves five requests of
   B=512 at pooling 20 (uniform and Zipf 1.05 row ids) and one of B=1024
   (pair mode), each held against the plain ``tt_rows`` path in float32,
   with the kernel's launch count checked per request; then the same
   model serves B=512 uniform and Zipf requests with ``impl="pallas"``
   (kernel B4) against the plain path in float32, B4 once per request;
5. train: the same model trains with fused SGD: five steps of B=512 at
   pooling 20 (uniform and Zipf 1.05), one of B=1024 (pair mode) and one
   of B=2048 (nnz 40960: autograd through the flat lookup), then one
   Adagrad step of B=512; each step's output and updated cores are held
   against the plain float32 step (``impl="xla", precision="highest"``)
   run from the same params, with the launches of B1, B2 and B3 checked
   per step, and TF32 checked off; then ``impl="pallas"`` (B4 forward, B5
   backward, float32) takes two SGD steps of B=512 (uniform, Zipf), one of
   B=2048 and one Adagrad step of B=512, each held against the plain
   float32 step, with B4 and B5 once and B1-B3 never per step;
6. times (CUDA events / host clock, medians): each kernel pass beside its
   bound and its plain version (B4 and B5 on a uniform and a Zipf batch),
   the serve per request, the training step per call at B=512, 1024 and
   2048, the ``impl="pallas"`` serve and step at B=512, ``torch.nn.EmbeddingBag(11M, 64,
   mode="sum")`` forward on the serve's batch and, sparse, forward +
   backward + ``torch.optim.SGD`` step on the training batch.

Prints a JSON line of the kernels, then as its last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

P, Q, R = [200, 220, 250], [4, 4, 4], [1, 32, 32, 1]
E, D = 200 * 220 * 250, 64
B, POOL = 512, 20
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,    # CUDA cores, no tensor cores
              "bfloat16": 989e12}  # dense tensor-core rate
CSRC = "fbtt_embedding_tpu_torch/csrc/"
TT_FLAT = "fbtt_embedding_tpu/ops/pallas/tt_flat.py"
TT_KERNEL = "fbtt_embedding_tpu/ops/pallas/tt_kernel.py"
# (source, TPU kernel replaced) per kernel wrapper
KERNELS = {
    "seg_transform": (CSRC + "seg_transform.cu", TT_FLAT + ":338"),
    "seg_fused_i2": (CSRC + "seg_fused_i2.cu", TT_FLAT + ":774"),
    "seg_accum": (CSRC + "seg_accum.cu", TT_FLAT + ":436"),
    "tt_fwd": (CSRC + "tt_fwd.cu", TT_KERNEL + ":274"),
    "tt_bwd": (CSRC + "tt_bwd.cu", TT_KERNEL + ":400"),
}
PATHS = ("serve", "train", "serve_generic", "train_generic")
LR, EPS = 0.005, 1.0        # training steps of the check (EPS: Adagrad)
# bf16 staging against the float32 plain step: outputs within 5e-3 of
# max|out| (the serve's limit); each core's update within 3e-2 of its
# largest element (CPU rehearsal at B=64-128: up to 1.2e-2 under Zipf)
OUT_TOL, UPDATE_TOL = 5e-3, 3e-2
# the generic path (float32 throughout) against the plain float32 path:
# only the summation order differs
F32_OUT_TOL, F32_UPDATE_TOL = 1e-4, 1e-3
V100_US_PER_LOOKUP = 0.416  # BASELINE.md: the reference's published figure


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps=25, inner=10):
    """Median over ``reps`` samples of the per-call time of ``inner``
    back-to-back calls between two CUDA events, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def host_ms(fn, reps=25):
    """Median host-clock time of one call ending in a synchronise."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def span_case(rng, nza, blocks, bw_in, bw_out, p_rows, dtype, seg,
              y_width=None):
    """Kernel inputs with duplicate-heavy sorted keys (Zipf over the core
    rows, so many rows own no span), a sentinel tail of dead rows, and
    random x (and y, ``y_width`` wide) and table scaled so that outputs,
    and the hottest span's gradient sum, are of unit size."""
    import numpy as np
    import torch

    from fbtt_embedding_tpu_torch.ops.kernels.tt_flat import (
        SPAN_BLOCK,
        _span_table,
    )

    keys = (rng.zipf(1.3, size=nza) - 1) % p_rows
    keys[rng.random(nza) < 0.05] = p_rows  # dead lookups: sentinel span
    keys = np.sort(keys)
    # x and y rows scale so that the hottest span's sum of x^T y is ~1
    # (y only when there is one; B1's x stays unit-size, as before)
    hot = np.bincount(keys[keys < p_rows]).max() * blocks
    sx = hot ** -0.25 if y_width else 1.0
    keys = torch.as_tensor(keys.astype(np.int32), device="cuda")
    runs, first, cnt = _span_table(keys, p_rows, nza // seg, seg=seg)

    def draw(shape, scale):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32, device="cuda")

    x = draw((nza, blocks * bw_in), sx).to(dtype)
    table = draw(((p_rows + SPAN_BLOCK) * bw_in, bw_out),
                 1 / (sx * np.sqrt(max(bw_in, bw_out) if y_width else bw_in)))
    table[p_rows * bw_in:] = 0
    if y_width is None:
        return runs, first, cnt, x, table.to(dtype)
    y = draw((nza, blocks * y_width), sx).to(dtype)
    return runs, first, cnt, x, y, table.to(dtype)


def pass_bound(runs, nseg, x, blocks, bw_in, bw_out, p_rows, out_dtype):
    """(least ms, bound_by) for one pass on these inputs: each x row read
    once, each y row written once, each live slab read once, the span
    tables read once; multiply-adds of the live rows only."""
    import torch

    nza = x.shape[0]
    spans = runs[1:p_rows + 1] - runs[:p_rows]
    live_rows = int(spans.sum())
    live_slabs = int((spans > 0).sum())
    isz = x.element_size()
    osz = torch.empty((), dtype=out_dtype).element_size()
    nbytes = (nza * blocks * bw_in * isz + nza * blocks * bw_out * osz
              + live_slabs * bw_in * bw_out * isz
              + (runs.numel() + 2 * nseg) * 4)
    flops = 2.0 * live_rows * blocks * bw_in * bw_out
    peak = PEAK_FLOPS[str(x.dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def grad_pass_bound(runs, nseg, x, blocks, bw_x, bw_y, p_rows, z_dtype,
                    rows_out):
    """(least ms, bound_by) for one B3 (or, with ``rows_out``, B2) pass on
    these inputs: x and y read once, z (and rows) written once, each live
    slab read once, acc written once, the span tables read once;
    multiply-adds of the live rows only (two products, three for B2)."""
    import torch

    nza = x.shape[0]
    spans = runs[1:p_rows + 1] - runs[:p_rows]
    live_rows = int(spans.sum())
    live_slabs = int((spans > 0).sum())
    isz = x.element_size()
    zsz = torch.empty((), dtype=z_dtype).element_size()
    nbytes = (nza * blocks * (bw_x + bw_y) * isz + nza * blocks * bw_x * zsz
              + (nza * blocks * bw_y * isz if rows_out else 0)
              + live_slabs * bw_x * bw_y * isz + p_rows * bw_x * bw_y * 4
              + (runs.numel() + 2 * nseg) * 4)
    flops = 2.0 * live_rows * blocks * bw_x * bw_y * (3 if rows_out else 2)
    peak = PEAK_FLOPS[str(x.dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def generic_inputs(rng, p, q, ranks, b, pool, tables=1, zipf=False,
                   weights=False, live=None):
    """The generic kernels' arguments for one batch of random cores (from
    ``rng``) and uniform or Zipf(1.05) row ids, made by the host drivers'
    own helpers: (kernel cores, ids, pooled rows, weights, bag order, bag
    starts, the backward's schedule, dout)."""
    import numpy as np
    import torch

    import fbtt_embedding_tpu_torch as fbt
    from fbtt_embedding_tpu_torch.ops.kernels import tt_kernel

    rfull = [1] + list(ranks) + [1]
    e, d = int(np.prod(p)), int(np.prod(q))
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
    lc = dev([int(live * nnz)]) if live is not None else None
    parts = fbt.decompose_indices(dev(ids, torch.int64), p)
    gk = tt_kernel._kernel_cores(cores, p, q, rfull)
    idx, rowv, wv = tt_kernel.block_inputs(parts, rowidx, tbl, w, lc, p,
                                           tables, b)
    order, starts = tt_kernel.bag_order(rowv, tables * b)
    sched = tt_kernel.core_orders(idx, rowv, [tables * x for x in p],
                                  tt_kernel.SEG)
    dout = dev(rng.standard_normal((tables * b, d)), torch.float32)
    return gk, idx, rowv, wv, order, starts, sched, dout


def generic_bound(gk, idx, rowv, weights, tb, backward):
    """(least ms, bound_by) of B4 (or, with ``backward``, B5) on these
    inputs: the core rows the live lookups touch read once, ids, pooled
    rows and weights read once, the output written once (B4 ``[tb, D]``;
    B5 every core's gradient, and it reads ``dout``); multiply-adds of the
    live lookups only: the chain (B4), or the forward up to the last
    core's input, the cotangent back through every core and each core's
    outer product (B5)."""
    import torch

    from fbtt_embedding_tpu_torch.ops.kernels.tt_fwd import chain_dims

    q, r = chain_dims(gk)
    live = rowv >= 0
    n_live = int(live.sum())
    m = [1]
    for qq in q:
        m.append(m[-1] * qq)  # m[t + 1] = q_0 * .. * q_t
    nbytes = sum(int(torch.unique(idx[t][live]).numel()) * g[0].numel() * 4
                 for t, g in enumerate(gk))
    nbytes += (idx.numel() + rowv.numel()) * 4 + tb * m[-1] * 4
    if weights is not None:
        nbytes += weights.numel() * 4
    step = [m[t] * r[t] * q[t] * r[t + 1] for t in range(1, len(q))]
    if backward:
        nbytes += sum(g.numel() for g in gk) * 4
        macs = sum(step[:-1]) + 2 * sum(step)
    else:
        macs = sum(step)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * macs * n_live / PEAK_FLOPS["float32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def hold_step(line, out, ref_out, new, ref, old, out_tol, update_tol, what):
    """Hold a training step's output and core updates against the plain
    step's; returns ``line`` with the errors appended."""
    import torch

    scale = ref_out.abs().max().item()
    err = (out - ref_out).abs().max().item()
    line += f"; output max_abs_err {err:.3e} (limit {out_tol} x {scale:.3e})"
    if not err <= out_tol * scale:
        fail(f"{what}: output disagrees with the plain step")
    for t, (c_new, c_ref, c_old) in enumerate(zip(
            new.tt_cores, ref.tt_cores, old.tt_cores)):
        upd = (c_ref - c_old).abs().max().item()
        cerr = (c_new - c_ref).abs().max().item()
        line += (f"; core {t} max|dcore - dcore_plain| {cerr:.3e} "
                 f"(limit {update_tol} x max|dcore_plain| {upd:.3e})")
        if not (torch.isfinite(c_new).all() and cerr <= update_tol * upd):
            fail(f"{what}: core {t} update disagrees with the plain step")
    return line


def check_close(name, got, want, tol):
    """max |got - want| after asserting closeness at ``tol``."""
    import torch

    err = (got.float() - want.float()).abs().max().item() \
        if got.numel() else 0.0
    try:
        torch.testing.assert_close(got.float(), want.float(), **tol)
    except AssertionError as e:
        fail(f"{name}: kernel disagrees with its plain version: {e}")
    return err


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import numpy as np

    import fbtt_embedding_tpu_torch as fbt
    from fbtt_embedding_tpu_torch.ops.kernels import _build
    from fbtt_embedding_tpu_torch.ops.kernels import tt_flat, tt_kernel
    from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import (
        seg_accum,
        seg_accum_plain,
    )
    from fbtt_embedding_tpu_torch.ops.kernels.seg_fused_i2 import (
        seg_fused_i2,
        seg_fused_i2_plain,
    )
    from fbtt_embedding_tpu_torch.ops.kernels.seg_transform import (
        seg_transform,
        seg_transform_plain,
    )
    from fbtt_embedding_tpu_torch.ops.kernels.tt_bwd import tt_bwd, tt_bwd_plain
    from fbtt_embedding_tpu_torch.ops.kernels.tt_fwd import tt_fwd, tt_fwd_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = {"seg_transform": seg_transform, "seg_fused_i2": seg_fused_i2,
                "seg_accum": seg_accum, "tt_fwd": tt_fwd, "tt_bwd": tt_bwd}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"[device] torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)")

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    for stem in libs:
        _build.library(stem)
    print(f"[build] {len(libs)} kernel librar(ies) in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(str(p.relative_to(root)) for p in libs.values()))
    for stem, lib in libs.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {stem}: {line.strip()}")

    # 3. kernels vs plain
    rng = np.random.default_rng(0)
    seg = tt_flat.SEG
    f32_tol = dict(rtol=1e-5, atol=1e-5)
    bf16_tol = dict(rtol=8e-3, atol=1e-4)  # f32 sums rounded once: 1 ulp
    max_err = dict.fromkeys(wrappers, 0.0)
    cases = [  # name, blocks, bw_in, bw_out, p_rows, nza
        ("headline i1", 4, 32, 128, 220, 10240),
        ("headline i2", 4, 128, 16, 250, 10240),
        ("ndim2 q=[8,8] r=[32]", 8, 32, 8, 1000, 4096),
        ("ndim4 q=[4]*4 r=[32]*3 pass 2", 4, 128, 512, 90, 2048),
    ]
    for name, blocks, bw_in, bw_out, p_rows, nza in cases:
        for dtype in (torch.float32, torch.bfloat16):
            runs, first, cnt, x, table = span_case(
                rng, nza, blocks, bw_in, bw_out, p_rows, dtype, seg)
            kw = dict(blocks=blocks, bw_in=bw_in, bw_out=bw_out,
                      p_rows=p_rows, seg=seg, out_dtype=dtype)
            y = seg_transform(runs, first, cnt, x, table, **kw)
            torch.cuda.synchronize()
            ref = seg_transform_plain(runs, first, cnt, x, table, **kw)
            tol = f32_tol if dtype == torch.float32 else bf16_tol
            dead = runs[p_rows].item()
            if dead < nza and y[dead:].abs().max().item() != 0:
                fail(f"{name} {dtype}: sentinel rows are not zero")
            err = check_close(f"seg_transform {name}", y, ref, tol)
            max_err["seg_transform"] = max(max_err["seg_transform"], err)
            print(f"[kernel] seg_transform {name} {str(dtype)[6:]}: "
                  f"max_abs_err {err:.3e} (rtol {tol['rtol']}, "
                  f"atol {tol['atol']}) ok")

    # B2 and B3 at the headline training passes (B3: i1 with float32 z as
    # in the fused step, i2 as in the two-pass backward) and at two wider
    # passes, twice each
    grad_cases = [  # kernel, name, blocks, bw_x, bw_y, p_rows, nza
        ("seg_fused_i2", "headline i2", 4, 128, 16, 250, 10240),
        ("seg_accum", "headline i1", 4, 32, 128, 220, 10240),
        ("seg_accum", "headline i2", 4, 128, 16, 250, 10240),
        # slabs past one 64 KB staging chunk: tt_ndim 4, ranks 32
        ("seg_fused_i2", "ndim4 q=[4]*4 r=[32]*3 pass 3", 4, 512, 64, 90,
         2048),
        ("seg_accum", "ndim4 q=[4]*4 r=[32]*3 pass 2", 4, 128, 512, 90,
         2048),
    ]
    for kname, name, blocks, bw_x, bw_y, p_rows, nza in grad_cases:
        for dtype in (torch.float32, torch.bfloat16):
            runs, first, cnt, x, y, table = span_case(
                rng, nza, blocks, bw_x, bw_y, p_rows, dtype, seg,
                y_width=bw_y)
            kw = dict(blocks=blocks, bw_x=bw_x, bw_y=bw_y, p_rows=p_rows,
                      seg=seg)
            variants = ([{}] if kname == "seg_fused_i2" else
                        [dict(z_dtype=torch.float32),
                         dict(z_dtype=torch.bfloat16)])
            for extra in variants:
                fn = wrappers[kname]
                ref_fn = (seg_fused_i2_plain if kname == "seg_fused_i2"
                          else seg_accum_plain)
                got = fn(runs, first, cnt, x, y, table, **kw, **extra)
                again = fn(runs, first, cnt, x, y, table, **kw, **extra)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"{kname} {name}: two runs differ (not bitwise "
                         "repeatable)")
                want = ref_fn(runs, first, cnt, x, y, table, **kw, **extra)
                dead = runs[p_rows].item()
                for out in got[1:]:
                    if dead < nza and out[dead:].abs().max().item() != 0:
                        fail(f"{kname} {name}: sentinel rows are not zero")
                errs = [check_close(f"{kname} {name} acc", got[0], want[0],
                                    f32_tol)]
                for g, w in zip(got[1:], want[1:]):
                    tol = f32_tol if g.dtype == torch.float32 else bf16_tol
                    errs.append(check_close(f"{kname} {name}", g, w, tol))
                max_err[kname] = max(max_err[kname], *errs)
                outs = "acc, z" + (", rows" if len(got) == 3 else "")
                zdt = str(got[1].dtype)[6:]
                print(f"[kernel] {kname} {name} {str(dtype)[6:]} (z {zdt}):"
                      f" max_abs_err {outs} "
                      + ", ".join(f"{e:.3e}" for e in errs)
                      + " (acc rtol = atol = 1e-5; float32 outputs the same,"
                      " bfloat16 one ulp), bitwise repeatable, ok")

    # B4 and B5 in float32 on whole batches (the generic path has no
    # bfloat16 staging); B5 twice each
    grad_tol = dict(rtol=1e-4, atol=1e-5)  # the JAX suite's, for gradients
    gen_cases = [  # name, p, q, inner ranks, B, pooling, tables, zipf,
        #            weights, live share
        ("headline uniform", P, Q, R[1:-1], B, POOL, 1, False, False, None),
        ("headline zipf1.05", P, Q, R[1:-1], B, POOL, 1, True, False, None),
        ("ndim2 q=[8,8] r=[32]", [3300, 3300], [8, 8], [32], B, POOL, 1,
         False, False, None),
        ("ndim4 q=[4]*4 r=[32]*3", [60] * 4, [4] * 4, [32] * 3, 64, 8, 1,
         False, False, None),
        ("T=2 weighted", P, Q, R[1:-1], 128, POOL, 2, False, True, None),
        ("live-count tail", P, Q, R[1:-1], 256, POOL, 1, True, True, 0.75),
    ]
    for name, p_, q_, r_, b_, pool, tables, zipf, wts, live in gen_cases:
        gk, gidx, rowv, wv, order, starts, sched, dout = generic_inputs(
            rng, p_, q_, r_, b_, pool, tables, zipf, wts, live)
        out = tt_fwd(gk, gidx, rowv, wv, order, starts)
        g1 = tt_bwd(gk, gidx, rowv, wv, dout, *sched, seg=tt_kernel.SEG)
        g2 = tt_bwd(gk, gidx, rowv, wv, dout, *sched, seg=tt_kernel.SEG)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(g1, g2)):
            fail(f"tt_bwd {name}: two runs differ (not bitwise repeatable)")
        ferr = check_close(f"tt_fwd {name}", out,
                           tt_fwd_plain(gk, gidx, rowv, wv, order, starts),
                           f32_tol)
        want = tt_bwd_plain(gk, gidx, rowv, wv, dout, *sched,
                            seg=tt_kernel.SEG)
        gerrs = [check_close(f"tt_bwd {name} core {t}", a, c, grad_tol)
                 for t, (a, c) in enumerate(zip(g1, want))]
        max_err["tt_fwd"] = max(max_err["tt_fwd"], ferr)
        max_err["tt_bwd"] = max(max_err["tt_bwd"], *gerrs)
        print(f"[kernel] tt_fwd / tt_bwd {name} (nnz {gidx.shape[1]}, "
              f"{int((rowv < 0).sum())} dead): max_abs_err forward "
              f"{ferr:.3e} (rtol = atol = 1e-5), core gradients "
              + ", ".join(f"{e:.3e}" for e in gerrs)
              + " (rtol 1e-4, atol 1e-5), tt_bwd bitwise repeatable, ok")

    # 4. serve at full width
    cores = fbt.init_tt_cores(np.random.default_rng(0), "uniform", 1, E, D,
                              P, Q, R)
    params = fbt.params_from_jax(cores, device="cuda")
    serve = fbt.make_serving_fn(P, Q, R, 1, B, device="cuda")
    serve_big = fbt.make_serving_fn(P, Q, R, 1, 2 * B, device="cuda")
    plain = fbt.make_serving_fn(P, Q, R, 1, B, impl="xla", device="cuda")
    plain_big = fbt.make_serving_fn(P, Q, R, 1, 2 * B, impl="xla",
                                    device="cuda")
    req_rng = np.random.default_rng(1)

    def request(b, zipf):
        n = b * POOL
        if zipf:
            idx = (req_rng.zipf(1.05, size=n) - 1) % E
        else:
            idx = req_rng.integers(0, E, size=n)
        return (torch.as_tensor(idx, device="cuda"),
                torch.arange(0, n + 1, POOL, device="cuda"))

    requests = [(B, z) + request(B, z)
                for z in (False, True, False, True, False)]
    requests.append((2 * B, False) + request(2 * B, False))
    torch.cuda.synchronize()

    outs = []
    zero_counts()
    for b, _, idx, offs in requests:
        before = seg_transform.launches
        out = (serve if b == B else serve_big)(params, idx, offs)
        outs.append(out)
        want = 2 if b == B else 1
        if seg_transform.launches - before != want:
            fail(f"B={b}: {seg_transform.launches - before} kernel launches,"
                 f" expected {want}")
    torch.cuda.synchronize()
    serve_launches = counts()
    for (b, zipf, idx, offs), out in zip(requests, outs):
        ref = (plain if b == B else plain_big)(params, idx, offs)
        if out.shape != (1, b, D) or not torch.isfinite(out).all():
            fail(f"B={b}: bad output {tuple(out.shape)}")
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        mode = "pair" if b != B else "two-pass"
        print(f"[serve] B={b} pooling {POOL} "
              f"{'zipf1.05' if zipf else 'uniform'} ({mode}): max_abs_err "
              f"{err:.3e} vs plain f32, limit {OUT_TOL * scale:.3e} "
              f"({OUT_TOL} x max|out| {scale:.3e})")
        if not err <= OUT_TOL * scale:
            fail(f"B={b}: serve disagrees with the plain path")
    print(f"[serve] launches on the serving path: {serve_launches}")

    # the generic path: impl="pallas", kernel B4 once per request
    gserve = fbt.make_serving_fn(P, Q, R, 1, B, impl="pallas", device="cuda")
    greqs = [r for r in requests if r[0] == B][:2]  # uniform, Zipf
    zero_counts()
    gouts = []
    for b, _, idx, offs in greqs:
        before = counts()
        gouts.append(gserve(params, idx, offs))
        got = {k: v - before[k] for k, v in counts().items()}
        if got != {**dict.fromkeys(wrappers, 0), "tt_fwd": 1}:
            fail(f"serve impl='pallas' B={b}: launches {got}, expected "
                 "tt_fwd 1 and nothing else")
    torch.cuda.synchronize()
    gserve_launches = counts()
    for (b, zipf, idx, offs), out in zip(greqs, gouts):
        ref = plain(params, idx, offs)
        if out.shape != (1, b, D) or not torch.isfinite(out).all():
            fail(f"serve impl='pallas' B={b}: bad output {tuple(out.shape)}")
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        print(f"[serve] impl='pallas' B={b} pooling {POOL} "
              f"{'zipf1.05' if zipf else 'uniform'}: max_abs_err {err:.3e} "
              f"vs plain f32, limit {F32_OUT_TOL * scale:.3e} "
              f"({F32_OUT_TOL} x max|out| {scale:.3e}); launches B4 1, B1 0")
        if not err <= F32_OUT_TOL * scale:
            fail(f"serve impl='pallas' B={b}: disagrees with the plain path")
    print(f"[serve] launches on the impl='pallas' serving path: "
          f"{gserve_launches}")

    # 5. train at full width
    def clone(prm):
        return fbt.TTEmbeddingParams(
            tuple(c.clone() for c in prm.tt_cores),
            tuple(s_.clone() for s_ in prm.optimizer_state), None)

    def train_batch(b, zipf):
        idx, offs = request(b, zipf)
        d_out = torch.as_tensor(req_rng.standard_normal((1, b, D)),
                                dtype=torch.float32, device="cuda")
        return idx, offs, d_out

    sgd_steps = {b: fbt.make_fused_train_step(P, Q, R, 1, b, device="cuda")
                 for b in (B, 2 * B, 4 * B)}
    sgd_plain = {b: fbt.make_fused_train_step(
        P, Q, R, 1, b, impl="xla", precision="highest", device="cuda")
        for b in (B, 2 * B, 4 * B)}
    ada = fbt.OptimType.EXACT_ADAGRAD
    ada_step = fbt.make_fused_train_step(P, Q, R, 1, B, optimizer=ada,
                                         device="cuda")
    ada_plain = fbt.make_fused_train_step(P, Q, R, 1, B, optimizer=ada,
                                          impl="xla", precision="highest",
                                          device="cuda")
    expect = {  # launches per step: (B1, B2, B3)
        "fused": (1, 1, 1), "fused, pair": (0, 1, 1), "autograd": (1, 0, 2)}
    plan = [(B, z, "sgd", "fused")
            for z in (False, True, False, True, False)]
    plan += [(2 * B, False, "sgd", "fused, pair"),
             (4 * B, False, "sgd", "autograd"), (B, False, "adagrad",
                                                 "fused")]
    batches = [train_batch(b, z) for b, z, _, _ in plan]
    tparams = fbt.params_from_jax(cores, device="cuda")
    aparams = None
    torch.cuda.synchronize()
    train_launches = dict.fromkeys(wrappers, 0)
    for (b, zipf, opt, path), (idx, offs, d_out) in zip(plan, batches):
        if opt == "adagrad":
            state = [torch.zeros_like(c) for c in tparams.tt_cores]
            aparams = fbt.TTEmbeddingParams(
                tuple(c.clone() for c in tparams.tt_cores), tuple(state),
                None)
            prm, kstep, pstep = aparams, ada_step, ada_plain
        else:
            prm, kstep, pstep = tparams, sgd_steps[b], sgd_plain[b]
        old = clone(prm)
        zero_counts()
        out, new = kstep(prm, idx, offs, d_out, (LR, EPS))
        torch.cuda.synchronize()
        got = counts()
        ref_out, ref = pstep(clone(old), idx, offs, d_out, (LR, EPS))
        for k in wrappers:
            train_launches[k] += got[k]
        want = {**dict.fromkeys(wrappers, 0), **dict(zip(
            ("seg_transform", "seg_fused_i2", "seg_accum"), expect[path]))}
        if got != want:
            fail(f"train B={b} ({path}): launches {got}, expected {want}")
        if out.shape != (1, b, D) or not torch.isfinite(out).all():
            fail(f"train B={b}: bad output {tuple(out.shape)}")
        line = (f"[train] {opt} B={b} pooling {POOL} "
                f"{'zipf1.05' if zipf else 'uniform'} ({path}): launches "
                f"B1 {got['seg_transform']} B2 {got['seg_fused_i2']} "
                f"B3 {got['seg_accum']}")
        print(hold_step(line, out, ref_out, new, ref, old, OUT_TOL,
                        UPDATE_TOL, f"train B={b} {opt}"))
        if opt != "adagrad":
            tparams = new
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    if tf32 != (False, "highest"):
        fail(f"TF32 is on after training: allow_tf32, precision = {tf32}")
    print(f"[train] TF32 off: matmul.allow_tf32 {tf32[0]}, float32 matmul "
          f"precision {tf32[1]!r}")
    print(f"[train] launches on the training path: {train_launches}")

    # the generic path: impl="pallas", B4 forward and B5 backward, float32
    gsteps = {b: fbt.make_fused_train_step(P, Q, R, 1, b, impl="pallas",
                                           device="cuda") for b in (B, 4 * B)}
    gada = fbt.make_fused_train_step(P, Q, R, 1, B, optimizer=ada,
                                     impl="pallas", device="cuda")
    gplan = [(B, False, "sgd"), (B, True, "sgd"), (4 * B, False, "sgd"),
             (B, False, "adagrad")]
    gbatches = [train_batch(b, z) for b, z, _ in gplan]
    gparams = fbt.params_from_jax(cores, device="cuda")
    per_step = {**dict.fromkeys(wrappers, 0), "tt_fwd": 1, "tt_bwd": 1}
    torch.cuda.synchronize()
    gtrain_launches = dict.fromkeys(wrappers, 0)
    for (b, zipf, opt), (idx, offs, d_out) in zip(gplan, gbatches):
        if opt == "adagrad":
            prm = fbt.TTEmbeddingParams(
                tuple(c.clone() for c in gparams.tt_cores),
                tuple(torch.zeros_like(c) for c in gparams.tt_cores), None)
            kstep, pstep = gada, ada_plain
        else:
            prm, kstep, pstep = gparams, gsteps[b], sgd_plain[b]
        old = clone(prm)
        zero_counts()
        out, new = kstep(prm, idx, offs, d_out, (LR, EPS))
        torch.cuda.synchronize()
        got = counts()
        ref_out, ref = pstep(clone(old), idx, offs, d_out, (LR, EPS))
        for k in wrappers:
            gtrain_launches[k] += got[k]
        if got != per_step:
            fail(f"train impl='pallas' B={b}: launches {got}, expected "
                 f"{per_step}")
        if out.shape != (1, b, D) or not torch.isfinite(out).all():
            fail(f"train impl='pallas' B={b}: bad output {tuple(out.shape)}")
        line = (f"[train] impl='pallas' {opt} B={b} pooling {POOL} "
                f"{'zipf1.05' if zipf else 'uniform'}: launches B4 "
                f"{got['tt_fwd']} B5 {got['tt_bwd']}, B1-B3 0")
        print(hold_step(line, out, ref_out, new, ref, old, F32_OUT_TOL,
                        F32_UPDATE_TOL, f"train impl='pallas' B={b} {opt}"))
        if opt != "adagrad":
            gparams = new
    print(f"[train] launches on the impl='pallas' training path: "
          f"{gtrain_launches}")

    # 6. times, on the inputs the B=512 uniform serve hands the kernels
    idx, offs = requests[0][2], requests[0][3]
    rowidx, _ = fbt.rowidx_from_offsets(offs, idx.shape[0], 1, B)
    plan0, nza = tt_flat._build_plan(idx, rowidx, None, None, None, P, 1, B,
                                     seg=seg)
    dt = torch.bfloat16
    tcores = fbt.params_from_jax(cores, device="cuda").tt_cores
    g0f, _, tables, widths = tt_flat._flat_setup(tcores, P, Q, R, dt)
    x = tt_flat._z0(plan0, g0f, P[0])
    times = {}
    for ti in (1, 2):
        _, bw_in, bw_out = widths[ti - 1]
        args = (plan0.runs[ti - 1], plan0.first[ti - 1], plan0.cnt[ti - 1],
                x, tables[ti - 1])
        kw = dict(blocks=Q[0], bw_in=bw_in, bw_out=bw_out, p_rows=P[ti],
                  seg=seg, out_dtype=dt)
        k_ms = cuda_ms(lambda: seg_transform(*args, **kw))
        p_ms = cuda_ms(lambda: seg_transform_plain(*args, **kw))
        b_ms, b_by = pass_bound(plan0.runs[ti - 1],
                                plan0.first[ti - 1].numel(), x, Q[0], bw_in,
                                bw_out, P[ti], dt)
        times.setdefault("seg_transform", []).append((k_ms, p_ms, b_ms, b_by))
        print(f"[time] seg_transform pass i{ti} (x {tuple(x.shape)} bf16, "
              f"bw {bw_in}->{bw_out}): kernel {k_ms * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.2f} us ({b_by}), plain {p_ms * 1e3:.2f} us "
              f"[{card}]")
        y = seg_transform(*args, **kw)
        if ti == 1:
            x = y[plan0.perm_fwd[0].long()]

    # the training step's B2 (i2) and B3 (i1, float32 z), on a uniform and
    # a Zipf(1.05) B=512 batch (the first two serve requests); the uniform
    # one's times go into the kernels' line
    d_out = batches[0][2]
    for label, (ridx, roffs) in (("uniform", requests[0][2:4]),
                                 ("zipf1.05", requests[1][2:4])):
        rrow, _ = fbt.rowidx_from_offsets(roffs, ridx.shape[0], 1, B)
        rplan, _ = tt_flat._build_plan(ridx, rrow, None, None, None, P, 1, B,
                                       seg=seg)
        z0 = tt_flat._z0(rplan, g0f, P[0])
        _, bw_in, bw_out = widths[0]
        x1 = seg_transform(
            rplan.runs[0], rplan.first[0], rplan.cnt[0], z0, tables[0],
            blocks=Q[0], bw_in=bw_in, bw_out=bw_out, p_rows=P[1], seg=seg,
            out_dtype=dt)[rplan.perm_fwd[0].long()]
        dz = tt_flat._row_cotangents(d_out, rplan, B, D, dt)
        for kname, ti in (("seg_fused_i2", 2), ("seg_accum", 1)):
            _, bw_x, bw_y = widths[ti - 1]
            xs, ys = (x1, dz) if ti == 2 else (z0, dz)
            args = (rplan.runs[ti - 1], rplan.first[ti - 1],
                    rplan.cnt[ti - 1], xs, ys, tables[ti - 1])
            kw = dict(blocks=Q[0], bw_x=bw_x, bw_y=bw_y, p_rows=P[ti],
                      seg=seg)
            if kname == "seg_accum":
                kw["z_dtype"] = torch.float32
            fn = wrappers[kname]
            ref_fn = seg_fused_i2_plain if kname == "seg_fused_i2" \
                else seg_accum_plain
            k_ms = cuda_ms(lambda: fn(*args, **kw))
            p_ms = cuda_ms(lambda: ref_fn(*args, **kw))
            b_ms, b_by = grad_pass_bound(
                rplan.runs[ti - 1], rplan.first[ti - 1].numel(), xs, Q[0],
                bw_x, bw_y, P[ti], kw.get("z_dtype", dt),
                kname == "seg_fused_i2")
            if label == "uniform":
                times[kname] = [(k_ms, p_ms, b_ms, b_by)]
            if kname == "seg_fused_i2":  # dZ1, s2 -> s1: B3's y
                dz = fn(*args, **kw)[1][rplan.perm_bwd[0].long()]
            print(f"[time] {kname} pass i{ti}, {label} batch (x "
                  f"{tuple(xs.shape)}, y {tuple(ys.shape)} bf16, bw "
                  f"{bw_x}x{bw_y}): kernel {k_ms * 1e3:.2f} us, bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}), plain {p_ms * 1e3:.2f} us "
                  f"[{card}]")

    serve_ms = host_ms(lambda: serve(params, idx, offs))
    big_ms = host_ms(lambda: serve_big(params, *requests[-1][2:]))
    print(f"[time] serve B={B} pooling {POOL}: {serve_ms:.3f} ms/request, "
          f"{serve_ms * 1e3 / idx.shape[0]:.4f} us/lookup [{card}]")
    print(f"[time] serve B={2 * B} pooling {POOL} (pair mode): "
          f"{big_ms:.3f} ms/request, "
          f"{big_ms * 1e3 / requests[-1][2].shape[0]:.4f} us/lookup [{card}]")

    # the training step per call; a small learning rate keeps the repeated
    # in-place updates of a scratch copy of the params finite
    scratch = fbt.params_from_jax(cores, device="cuda")
    step_ms = {}
    for (b, _, _, path), batch in list(zip(plan, batches))[4:7]:
        step = sgd_steps[b]
        ms = host_ms(lambda: step(scratch, *batch, (1e-4, EPS)))
        step_ms[b] = ms
        print(f"[time] train step SGD B={b} pooling {POOL} ({path}): "
              f"{ms:.3f} ms/step, {ms * 1e3 / (b * POOL):.4f} us/lookup "
              f"[{card}]")
    # the generic kernels on a uniform and a Zipf(1.05) headline batch;
    # the uniform one's times go into the kernels' line
    for label, zipf in (("uniform", False), ("zipf1.05", True)):
        gk, gidx, rowv, wv, order, starts, sched, dout = generic_inputs(
            np.random.default_rng(2), P, Q, R[1:-1], B, POOL, zipf=zipf)
        fargs = (gk, gidx, rowv, wv, order, starts)
        bargs = (gk, gidx, rowv, wv, dout, *sched)
        kseg = dict(seg=tt_kernel.SEG)
        for kname, fn, ref_fn, args, kw in (
                ("tt_fwd", tt_fwd, tt_fwd_plain, fargs, {}),
                ("tt_bwd", tt_bwd, tt_bwd_plain, bargs, kseg)):
            k_ms = cuda_ms(lambda: fn(*args, **kw))
            p_ms = cuda_ms(lambda: ref_fn(*args, **kw), reps=5, inner=3)
            b_ms, b_by = generic_bound(gk, gidx, rowv, wv, B,
                                       kname == "tt_bwd")
            if label == "uniform":
                times[kname] = [(k_ms, p_ms, b_ms, b_by)]
            print(f"[time] {kname} headline B={B} pooling {POOL} {label} "
                  f"(nnz {gidx.shape[1]}, float32): kernel {k_ms * 1e3:.2f}"
                  f" us, bound {b_ms * 1e3:.2f} us ({b_by}), plain "
                  f"{p_ms * 1e3:.2f} us [{card}]")

    gserve_ms = host_ms(lambda: gserve(params, idx, offs))
    print(f"[time] serve impl='pallas' B={B} pooling {POOL}: {gserve_ms:.3f} "
          f"ms/request, {gserve_ms * 1e3 / idx.shape[0]:.4f} us/lookup (flat "
          f"path {serve_ms:.3f} ms) [{card}]")
    gbatch = gbatches[0]
    gstep = gsteps[B]
    gstep_ms = host_ms(lambda: gstep(scratch, *gbatch, (1e-4, EPS)))
    print(f"[time] train step SGD impl='pallas' B={B} pooling {POOL}: "
          f"{gstep_ms:.3f} ms/step, {gstep_ms * 1e3 / (B * POOL):.4f} "
          f"us/lookup (flat path {step_ms[B]:.3f} ms) [{card}]")
    print(f"[time] reference: the published fbtt figure, fwd+bwd with fused "
          f"SGD at B={B} pooling {POOL} on a V100 (BASELINE.md): "
          f"{V100_US_PER_LOOKUP} us/lookup (another card; not measured here)")

    free, _ = torch.cuda.mem_get_info()
    need = E * D * 4
    if free > 3 * need:
        bag = torch.nn.EmbeddingBag(E, D, mode="sum", include_last_offset=True,
                                    device="cuda")
        with torch.no_grad():
            bag_ms = host_ms(lambda: bag(idx, offs))
        print(f"[time] nn.EmbeddingBag({E}, {D}, sum) forward B={B} pooling "
              f"{POOL}: {bag_ms:.3f} ms/request, "
              f"{bag_ms * 1e3 / idx.shape[0]:.4f} us/lookup [{card}]")
        del bag
        sbag = torch.nn.EmbeddingBag(E, D, mode="sum", sparse=True,
                                     include_last_offset=True, device="cuda")
        opt = torch.optim.SGD(sbag.parameters(), lr=1e-4)
        tidx, toffs, tdout = batches[4]

        def bag_step():
            opt.zero_grad(set_to_none=True)
            sbag(tidx, toffs).backward(tdout[0])
            opt.step()

        bag_train_ms = host_ms(bag_step)
        print(f"[time] nn.EmbeddingBag({E}, {D}, sum, sparse) forward + "
              f"backward + SGD step B={B} pooling {POOL}: "
              f"{bag_train_ms:.3f} ms/step, "
              f"{bag_train_ms * 1e3 / tidx.shape[0]:.4f} us/lookup [{card}]")
        del sbag, opt
    else:
        print(f"[time] nn.EmbeddingBag yardsticks: not measured "
              f"({free / 2**30:.1f} GiB free, needs {3 * need / 2**30:.1f})")

    by_path = dict(zip(PATHS, (serve_launches, train_launches,
                               gserve_launches, gtrain_launches)))
    kernels = []
    for name, rows in times.items():
        src, replaces = KERNELS[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {path: c[name] for path, c in
                                 by_path.items()},
            "max_abs_err": max_err[name],
            "ms": sum(r[0] for r in rows),
            "plain_ms": sum(r[1] for r in rows),
            "bound_ms": sum(r[2] for r in rows),
            "bound_by": ("bytes" if all(r[3] == "bytes" for r in rows)
                         else "operations"),
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
