#!/usr/bin/env python3
"""Where the time of one training step of fbtt_embedding_tpu_torch goes, on
a GPU.

Usage: ``python3 scripts/profile_torch_train.py [--batch 512] [--iters 20]
[--count] [--impl pallas] [--native OPTIM] [--wide] [--root DIR]`` from
the root of a checkout, on a
machine with one CUDA card. ``--root`` names the checkout whose ``fbtt_embedding_tpu_torch``
is imported and built (default: this one), so that an older tree unpacked
into ``build/ab_old/`` is profiled by the same script.

Runs the fused SGD step (``make_fused_train_step``) of the headline model
(p=[200,220,250], q=[4,4,4], ranks [32,32]; random cores from seed 0) at
pooling 20 under ``torch.profiler`` and prints: the host-clock time per
step without the profiler and under it, the device time per step summed
over all kernels, the device busy
share (device time over the host time without the profiler), the device
operations per step
(kernel launches and copies), and the CUDA kernels and host operators
ranked by time, then the device time under each of the program's
layer spans (``fbtt.*``, ``profiling.kernels_by_span``) with its
kernels: the layer that owns each kernel. ``--count`` turns LFU
counting on, as the reference
benchmark's step does (``use_cache``; a direct-mode cache with
``hashtbl_size`` = E and ``cache_size`` = E / 10). ``--impl pallas``
profiles the generic per-lookup step (kernels B4 and B5, float32) in place
of the flat pipeline. ``--native ADAM`` (any ``OptimType`` name) runs
that optimizer's own update (``optim_semantics="native"``, state from
``native_optim_init``) in place of SGD. ``--wide`` profiles the table of
p=[1300, 1300, 1300] (E = 2.197e9, past 2^31) at the same widths: uniform
int64 ids as wide key rows, and with ``--count`` the wide-key cache
(``hashtbl_size`` 2^24, ``cache_size`` 2^20). ``--trace PATH`` also
writes the Chrome trace. ``FBTT_DG0=onehot`` in the environment profiles
the step with B3 and the one-hot product in place of kernel B6.
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
    ap.add_argument("--count", action="store_true",
                    help="LFU counting on (direct mode, cache_size E/10)")
    ap.add_argument("--trace", help="write the Chrome trace here")
    ap.add_argument("--impl", choices=("auto", "pallas"), default="auto",
                    help="the step's lookup path (pallas: kernels B4, B5)")
    ap.add_argument("--native", metavar="OPTIM",
                    help="an OptimType name, run with its own update")
    ap.add_argument("--wide", action="store_true",
                    help="the 2.197e9-row table, wide key rows and cache")
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose package is profiled")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import fbtt_embedding_tpu_torch as fbt

    p = [1300, 1300, 1300] if args.wide else [200, 220, 250]
    q, r = [4, 4, 4], [1, 32, 32, 1]
    e, pool, b = int(np.prod(p)), 20, args.batch
    cores = fbt.init_tt_cores(np.random.default_rng(0), "uniform", 1, e, 64,
                              p, q, r)
    params = fbt.params_from_jax(cores, device="cuda")
    if args.count and args.wide:
        params.cache = fbt.make_cache_state(2 ** 24, 2 ** 20, 64,
                                            wide_keys=3, device="cuda")
    elif args.count:
        params.cache = fbt.make_cache_state(e, e // 10, 64,
                                            num_embeddings=e, device="cuda")
    optim = fbt.OptimType.SGD
    kw = {}
    if args.native:
        optim = getattr(fbt.OptimType, args.native)
        params.optimizer_state = fbt.native_optim_init(optim,
                                                       params.tt_cores)
        kw["optim_semantics"] = "native"
    step = fbt.make_fused_train_step(p, q, r, 1, b, optimizer=optim,
                                     use_cache=args.count, impl=args.impl,
                                     device="cuda", **kw)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, e, size=b * pool, dtype=np.int64)
    idx = torch.as_tensor(fbt.wide_keyrows(ids, p) if args.wide else ids,
                          device="cuda")
    offs = torch.arange(0, b * pool + 1, pool, device="cuda")
    d_out = torch.as_tensor(rng.standard_normal((1, b, 64)),
                            dtype=torch.float32, device="cuda")
    lr_eps = (1e-4, 1.0)  # small: the repeated in-place updates stay finite
    for _ in range(5):
        step(params, idx, offs, d_out, lr_eps)
    torch.cuda.synchronize()
    # the host clock without the profiler, which adds its own cost to every
    # operation it records
    bare = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        step(params, idx, offs, d_out, lr_eps)
        torch.cuda.synchronize()
        bare.append((time.perf_counter() - t0) * 1e3)

    host = []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.iters):
            t0 = time.perf_counter()
            step(params, idx, offs, d_out, lr_eps)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
    card = torch.cuda.get_device_name(0)
    events = prof.key_averages()
    # device work only, not the program's spans' device-side annotations
    dev = [ev for ev in events
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(ev, "is_user_annotation", False)]
    dev_ms = sum(ev.self_device_time_total for ev in dev) / 1e3 / args.iters
    launches = sum(ev.count for ev in dev) / args.iters
    host_ms, bare_ms = statistics.median(host), statistics.median(bare)
    what = (" with LFU counting" if args.count else "") + (
        f" impl={args.impl}" if args.impl != "auto" else "") + (
        f" (wide key rows, p={p})" if args.wide else "")
    opt = f"native {args.native}" if args.native else "SGD"
    print(f"[profile] {card} train step {opt} B={b} pooling {pool}{what}: host "
          f"{bare_ms:.3f} ms/step (median, without the profiler), "
          f"{host_ms:.3f} ms/step (under it), device {dev_ms:.3f} ms/step "
          f"(kernel sum), device busy share {dev_ms / bare_ms:.3f} (over "
          f"the host time without the profiler), {launches:.1f} device "
          f"ops/step (kernel launches and copies); package {Path(fbt.__file__).parent}")
    # wide names: the two gradient kernels differ only in template arguments
    print(events.table(sort_by="self_device_time_total", row_limit=30,
                       max_name_column_width=110))
    print(events.table(sort_by="self_cpu_time_total", row_limit=25))
    if hasattr(fbt.profiling, "kernels_by_span"):  # older trees: none
        print(fbt.profiling.by_span_text(
            fbt.profiling.kernels_by_span(prof.events()), args.iters,
            "step"))
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
