#!/usr/bin/env python3
"""Where the time of one serve of fbtt_embedding_tpu_torch goes, on a GPU.

Usage: ``python3 scripts/profile_torch_serve.py [--batch 512] [--iters 20]
[--impl pallas | --folded [--quantize]] [--root DIR]`` from the root of a
checkout, on a machine
with one CUDA card. ``--root`` names the checkout whose
``fbtt_embedding_tpu_torch`` is imported and built (default: this one), so
that an older tree unpacked into ``build/ab_old/`` is profiled by the same
script.

Serves the headline model (p=[200,220,250], q=[4,4,4], ranks [32,32]; random
cores from seed 0) at pooling 20 under ``torch.profiler`` and prints:
the host-clock time per request without the profiler and under it, the
device time per request summed over all kernels, the device busy share
(device time over the host time without the profiler), the device
operations (kernel launches and copies) per request, and the CUDA kernels
and host operators ranked by time. ``--impl pallas`` profiles the generic
per-lookup serve (kernel B4, float32) in place of the flat pipeline;
``--folded`` the weight-folded serve (``make_folded_serving_fn``: the pair
table gathered, B1 once; ``--quantize`` its int8 fold), the fold made once
before the timing. ``--trace PATH`` also writes the Chrome trace.
"""

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--trace", help="write the Chrome trace here")
    ap.add_argument("--impl", choices=("auto", "pallas"), default="auto",
                    help="the serve's lookup path (make_serving_fn)")
    ap.add_argument("--folded", action="store_true",
                    help="the weight-folded serve (make_folded_serving_fn)")
    ap.add_argument("--quantize", action="store_true",
                    help="with --folded: the int8 fold")
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose package is profiled")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import fbtt_embedding_tpu_torch as fbt

    p, q, r = [200, 220, 250], [4, 4, 4], [1, 32, 32, 1]
    e, pool, b = 200 * 220 * 250, 20, args.batch
    cores = fbt.init_tt_cores(np.random.default_rng(0), "uniform", 1, e, 64,
                              p, q, r)
    params = fbt.params_from_jax(cores, device="cuda")
    rng = np.random.default_rng(1)
    idx = torch.as_tensor(rng.integers(0, e, size=b * pool), device="cuda")
    offs = torch.arange(0, b * pool + 1, pool, device="cuda")
    if args.folded:
        fold, fserve = fbt.make_folded_serving_fn(
            p, q, r, 1, b, impl=args.impl,
            quantize="int8" if args.quantize else None, device="cuda")
        fp = fold(params)

        def serve():
            return fserve(fp, idx, offs)
    else:
        unfolded = fbt.make_serving_fn(p, q, r, 1, b, impl=args.impl,
                                       device="cuda")

        def serve():
            return unfolded(params, idx, offs)

    for _ in range(5):
        serve()
    torch.cuda.synchronize()
    # the host clock without the profiler, which adds its own cost to every
    # operation it records
    bare = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        bare.append((time.perf_counter() - t0) * 1e3)

    host = []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.iters):
            t0 = time.perf_counter()
            serve()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
    card = torch.cuda.get_device_name(0)
    events = prof.key_averages()
    dev = [ev for ev in events
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(ev.self_device_time_total for ev in dev) / 1e3 / args.iters
    launches = sum(ev.count for ev in dev) / args.iters
    host_ms, bare_ms = statistics.median(host), statistics.median(bare)
    what = f" impl={args.impl}" if args.impl != "auto" else ""
    if args.folded:
        what += " folded" + (" int8" if args.quantize else "")
    print(f"[profile] {card} serve B={b} pooling {pool}{what}: host "
          f"{bare_ms:.3f} ms/request (median, without the profiler), "
          f"{host_ms:.3f} ms/request (under it), device {dev_ms:.3f} ms/"
          f"request (kernel sum), device busy share {dev_ms / bare_ms:.3f} "
          f"(over the host time without the profiler), {launches:.1f} "
          f"device ops/request "
          f"(kernel launches and copies); package {Path(fbt.__file__).parent}")
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    print(events.table(sort_by="self_cpu_time_total", row_limit=25))
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
