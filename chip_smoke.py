#!/usr/bin/env python3
"""Drive fbtt_embedding_tpu_torch on one NVIDIA GPU and check it.

Usage: ``python3 chip_smoke.py`` from the root of a checkout (needs one
CUDA card and ``nvcc``). Phases, each printing its own lines:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every kernel of ``fbtt_embedding_tpu_torch/csrc`` into
   ``build/`` and load it;
3. kernel vs plain: the segment-transform kernel (B1) against its plain
   PyTorch version on the card, at both headline pass shapes in float32
   and bfloat16, and at one tt_ndim-2 and one tt_ndim-4 pass;
4. serve: the headline model (p=[200,220,250], q=[4,4,4], ranks [32,32]:
   E=11M, D=64) with random cores from seed 0 serves five requests of
   B=512 at pooling 20 (uniform and Zipf 1.05 row ids) and one of B=1024
   (pair mode), each held against the plain ``tt_rows`` path in float32,
   with the kernel's launch count checked per request;
5. times (CUDA events / host clock, medians): each pass's kernel beside
   its bound and its plain version, the serve per request, and
   ``torch.nn.EmbeddingBag(11M, 64, mode="sum")`` on the same batch.

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
SOURCE = "fbtt_embedding_tpu_torch/csrc/seg_transform.cu"
REPLACES = "fbtt_embedding_tpu/ops/pallas/tt_flat.py:338"


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


def span_case(rng, nza, blocks, bw_in, bw_out, p_rows, dtype, seg):
    """Kernel inputs with duplicate-heavy sorted keys (Zipf over the core
    rows, so many rows own no span), a sentinel tail of dead rows, and
    random x and table scaled so that outputs are of unit size."""
    import numpy as np
    import torch

    from fbtt_embedding_tpu_torch.ops.kernels.tt_flat import (
        SPAN_BLOCK,
        _span_table,
    )

    keys = (rng.zipf(1.3, size=nza) - 1) % p_rows
    keys[rng.random(nza) < 0.05] = p_rows  # dead lookups: sentinel span
    keys = torch.as_tensor(np.sort(keys).astype(np.int32), device="cuda")
    runs, first, cnt = _span_table(keys, p_rows, nza // seg, seg=seg)
    x = torch.as_tensor(rng.standard_normal((nza, blocks * bw_in)),
                        dtype=torch.float32, device="cuda").to(dtype)
    table = torch.as_tensor(
        rng.standard_normal(((p_rows + SPAN_BLOCK) * bw_in, bw_out))
        / np.sqrt(bw_in), dtype=torch.float32, device="cuda")
    table[p_rows * bw_in:] = 0
    return runs, first, cnt, x, table.to(dtype)


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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import numpy as np

    import fbtt_embedding_tpu_torch as fbt
    from fbtt_embedding_tpu_torch.ops.kernels import _build
    from fbtt_embedding_tpu_torch.ops.kernels import tt_flat
    from fbtt_embedding_tpu_torch.ops.kernels.seg_transform import (
        seg_transform,
        seg_transform_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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

    # 3. kernel vs plain
    rng = np.random.default_rng(0)
    seg = tt_flat.SEG
    cases = [  # name, blocks, bw_in, bw_out, p_rows, nza
        ("headline i1", 4, 32, 128, 220, 10240),
        ("headline i2", 4, 128, 16, 250, 10240),
        ("ndim2 q=[8,8] r=[32]", 8, 32, 8, 1000, 4096),
        ("ndim4 q=[4]*4 r=[32]*3 pass 2", 4, 128, 512, 90, 2048),
    ]
    max_err = 0.0
    for name, blocks, bw_in, bw_out, p_rows, nza in cases:
        for dtype in (torch.float32, torch.bfloat16):
            runs, first, cnt, x, table = span_case(
                rng, nza, blocks, bw_in, bw_out, p_rows, dtype, seg)
            kw = dict(blocks=blocks, bw_in=bw_in, bw_out=bw_out,
                      p_rows=p_rows, seg=seg, out_dtype=dtype)
            y = seg_transform(runs, first, cnt, x, table, **kw)
            torch.cuda.synchronize()
            ref = seg_transform_plain(runs, first, cnt, x, table, **kw)
            if dtype == torch.float32:
                tol = dict(rtol=1e-5, atol=1e-5)
            else:  # f32 sums in another order, rounded once: <= 1 bf16 ulp
                tol = dict(rtol=8e-3, atol=1e-4)
            err = (y.float() - ref.float()).abs().max().item()
            dead = runs[p_rows].item()
            if dead < nza and y[dead:].abs().max().item() != 0:
                fail(f"{name} {dtype}: sentinel rows are not zero")
            torch.testing.assert_close(y.float(), ref.float(), **tol)
            max_err = max(max_err, err)
            print(f"[kernel] seg_transform {name} {str(dtype)[6:]}: "
                  f"max_abs_err {err:.3e} (rtol {tol['rtol']}, "
                  f"atol {tol['atol']}) ok")

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
    seg_transform.launches = 0
    for b, _, idx, offs in requests:
        before = seg_transform.launches
        out = (serve if b == B else serve_big)(params, idx, offs)
        outs.append(out)
        want = 2 if b == B else 1
        if seg_transform.launches - before != want:
            fail(f"B={b}: {seg_transform.launches - before} kernel launches,"
                 f" expected {want}")
    torch.cuda.synchronize()
    launches = seg_transform.launches
    for (b, zipf, idx, offs), out in zip(requests, outs):
        ref = (plain if b == B else plain_big)(params, idx, offs)
        if out.shape != (1, b, D) or not torch.isfinite(out).all():
            fail(f"B={b}: bad output {tuple(out.shape)}")
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        mode = "pair" if b != B else "two-pass"
        print(f"[serve] B={b} pooling {POOL} "
              f"{'zipf1.05' if zipf else 'uniform'} ({mode}): max_abs_err "
              f"{err:.3e} vs plain f32, limit {5e-3 * scale:.3e} "
              f"(5e-3 x max|out| {scale:.3e})")
        if not err <= 5e-3 * scale:
            fail(f"B={b}: serve disagrees with the plain path")
    print(f"[serve] seg_transform launches on the main path: {launches}")

    # 5. times, on the inputs the B=512 serve hands the kernel
    idx, offs = requests[0][2], requests[0][3]
    rowidx, _ = fbt.rowidx_from_offsets(offs, idx.shape[0], 1, B)
    plan, nza = tt_flat._build_plan(idx, rowidx, None, None, None, P, 1, B,
                                    seg=seg)
    dt = torch.bfloat16
    g0f, _, tables, widths = tt_flat._flat_setup(params.tt_cores, P, Q, R, dt)
    i0c = torch.where(plan.alive1, plan.i0_s1,
                      torch.full_like(plan.i0_s1, P[0]))
    x = g0f[i0c.long()]
    rows = []
    for ti in (1, 2):
        _, bw_in, bw_out = widths[ti - 1]
        args = (plan.runs[ti - 1], plan.first[ti - 1], plan.cnt[ti - 1], x,
                tables[ti - 1])
        kw = dict(blocks=Q[0], bw_in=bw_in, bw_out=bw_out, p_rows=P[ti],
                  seg=seg, out_dtype=dt)
        k_ms = cuda_ms(lambda: seg_transform(*args, **kw))
        p_ms = cuda_ms(lambda: seg_transform_plain(*args, **kw))
        b_ms, b_by = pass_bound(plan.runs[ti - 1], plan.first[ti - 1].numel(),
                                x, Q[0], bw_in, bw_out,
                                P[ti], dt)
        rows.append((k_ms, p_ms, b_ms, b_by))
        print(f"[time] seg_transform pass i{ti} (x {tuple(x.shape)} bf16, "
              f"bw {bw_in}->{bw_out}): kernel {k_ms * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.2f} us ({b_by}), plain {p_ms * 1e3:.2f} us "
              f"[{card}]")
        y = seg_transform(*args, **kw)
        if ti == 1:
            x = y[plan.perm_fwd[0].long()]

    serve_ms = host_ms(lambda: serve(params, idx, offs))
    big_ms = host_ms(lambda: serve_big(params, *requests[-1][2:]))
    print(f"[time] serve B={B} pooling {POOL}: {serve_ms:.3f} ms/request, "
          f"{serve_ms * 1e3 / idx.shape[0]:.4f} us/lookup [{card}]")
    print(f"[time] serve B={2 * B} pooling {POOL} (pair mode): "
          f"{big_ms:.3f} ms/request, "
          f"{big_ms * 1e3 / requests[-1][2].shape[0]:.4f} us/lookup [{card}]")

    free, _ = torch.cuda.mem_get_info()
    need = E * D * 4
    if free > 2 * need:
        bag = torch.nn.EmbeddingBag(E, D, mode="sum", include_last_offset=True,
                                    device="cuda")
        with torch.no_grad():
            bag_ms = host_ms(lambda: bag(idx, offs))
        del bag
        print(f"[time] nn.EmbeddingBag({E}, {D}, sum) forward B={B} pooling "
              f"{POOL}: {bag_ms:.3f} ms/request, "
              f"{bag_ms * 1e3 / idx.shape[0]:.4f} us/lookup [{card}]")
    else:
        print(f"[time] nn.EmbeddingBag yardstick: not measured "
              f"({free / 2**30:.1f} GiB free, needs {2 * need / 2**30:.1f})")

    k_ms = sum(r[0] for r in rows)
    kernels = [{
        "name": "seg_transform",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": sum(r[1] for r in rows),
        "bound_ms": sum(r[2] for r in rows),
        "bound_by": ("bytes" if all(r[3] == "bytes" for r in rows)
                     else "operations"),
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
