#!/usr/bin/env python3
"""Where the time of a multi-GPU training step or serve of
fbtt_embedding_tpu_torch goes, rank by rank.

Usage: ``python3 scripts/profile_torch_multi.py [--world 2] [--backend
gloo] [--batch 1024] [--iters 10] [--dlrm | --serving [--quantized] |
--cache-mode replicated|owned] [--trace DIR]`` from the root of a
checkout, on a machine with a CUDA card. Launches ``--world`` processes
(one rank each, on the visible cards in turn; several ranks on one card
need ``--backend gloo``: NCCL takes one rank a card), each of which runs,
on the headline model (p=[200,220,250], q=[4,4,4], ranks [32,32]; random
cores from seed 0) at pooling 20 and global batch ``--batch``:

* by default the data-parallel fused SGD step
  (``make_sharded_fused_train_step``) with LFU counting on (a direct-mode
  cache of ``hashtbl_size`` E and ``cache_size`` E / 10, uniform ids);
* ``--dlrm``: the table-sharded DLRM step (8 tables of E=1M, ``(dp, mp)
  = (1, world)``, global B=512);
* ``--serving``: the data-parallel folded serve (``make_dp_serving_fn``;
  ``--quantized``: the int8 fold), Zipf(1.05) ids probing the cache
  counted on 20 Zipf batches of 512 and populated (the counterpart of the
  JAX package's ``scripts/bench_sharded.py --serving``);
* ``--cache-mode replicated|owned``: the SGD step probing that populated
  cache, replicated on every rank (``make_sharded_fused_train_step`` with
  ``probe_cache``) or owned by rows (``make_row_owned_fused_train_step``
  after ``make_row_owned_populate``), Zipf(1.05) ids (the counterpart of
  ``bench_sharded.py --cache-mode``);

and prints per rank: the host-clock ms per call, the device ms per call
and the device operations per call under ``torch.profiler``, the device
busy share (device over host), the collectives' host ms per call (each
collective between two synchronisations, in a run of its own) and their
share of the call, and the largest kernels. ``--trace DIR`` writes each
rank's Chrome trace there (``rank<r>.json``).
"""

import argparse
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _rank(args) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT))
    import fbtt_embedding_tpu_torch as fbt
    from fbtt_embedding_tpu_torch.examples import train_dlrm
    from fbtt_embedding_tpu_torch.models import dlrm
    from fbtt_embedding_tpu_torch.parallel import collectives
    from fbtt_embedding_tpu_torch.parallel import host_local_slice

    fbt.initialize_distributed(args.init, args.world, args.rank,
                               backend=args.backend, device="cuda",
                               timeout_s=300)
    cuda = torch.device("cuda", torch.cuda.current_device())
    if args.dlrm:
        mesh = fbt.make_mesh((1, args.world), ("dp", "mp"))
        cfg = dlrm.DLRMConfig(
            num_tables=8, num_embeddings=1_000_000, embedding_dim=64,
            tt_p_shapes=[100, 100, 100], tt_q_shapes=[4, 4, 4],
            tt_ranks=[32, 32], dense_dim=13,
            bottom_mlp_dims=[512, 256, 64], top_mlp_dims=[512, 256, 1],
            pooling_factor=8)
        params = dlrm.shard_dlrm_params(
            dlrm.init_dlrm_params(cfg, seed=0, device=cuda), cfg, mesh)
        dense, idx, labels = train_dlrm.make_batch(
            np.random.default_rng(8), cfg, 512, cuda)
        rows = (("dp", "mp"),)
        batch = (host_local_slice(mesh, rows, dense),
                 host_local_slice(mesh, ("mp", "dp"), idx),
                 host_local_slice(mesh, rows, labels))
        step = dlrm.make_dlrm_train_step(cfg, mesh=mesh, learning_rate=1e-4,
                                         device=cuda)
        what = "table-sharded DLRM step, global B=512"

        def fn():
            step(params, *batch)
    else:
        p, q, r = [200, 220, 250], [4, 4, 4], [1, 32, 32, 1]
        e, d, pool = 200 * 220 * 250, 64, 20
        mesh = fbt.make_mesh((args.world,), ("dp",))
        rng = np.random.default_rng(0)
        params = fbt.params_from_jax(
            fbt.init_tt_cores(rng, "uniform", 1, e, d, p, q, r), device=cuda)
        c_size = (e // 10) // args.world * args.world
        params.cache = fbt.make_cache_state(e, c_size, d, num_embeddings=e,
                                            device=cuda)
        zipf = args.serving or args.cache_mode is not None
        if zipf:  # the populated cache of Zipf traffic
            for _ in range(20):
                fbt.update_cache_state(params.cache, torch.as_tensor(
                    (rng.zipf(1.05, size=512 * pool) - 1) % e, device=cuda))
            counting = params.cache
            params.cache = fbt.cache_populate(counting, params.tt_cores, p,
                                              q, r)
            idx = ((rng.zipf(1.05, size=(1, args.batch, pool)) - 1) % e)
        else:
            idx = rng.integers(0, e, size=(1, args.batch, pool))
        dout = rng.normal(size=(1, args.batch, d)).astype(np.float32)
        idx = torch.tensor(host_local_slice(mesh, (None, "dp"),
                                            idx.astype(np.int32)),
                           device=cuda)
        dout = torch.tensor(host_local_slice(mesh, (None, "dp"), dout),
                            device=cuda)
        traffic = (f"global B={args.batch} pooling {pool}"
                   + (f", Zipf 1.05 probing a populated cache of {c_size} "
                      "rows" if zipf else ""))
        if args.serving:
            fold, serve = fbt.make_dp_serving_fn(
                mesh, p, q, r, 1, args.batch, pool,
                quantize="int8" if args.quantized else None, device=cuda)
            fp = fold(params)
            kind = "int8" if args.quantized else "bf16"
            what = f"data-parallel folded {kind} serve, {traffic}"

            def fn():
                serve(fp, idx)
        elif args.cache_mode == "owned":
            populate = fbt.make_row_owned_populate(mesh, p, q, r, c_size,
                                                   device=cuda)
            cnt, w_own, o_own = populate(counting, params.tt_cores)
            params.cache = cnt
            step = fbt.make_row_owned_fused_train_step(
                mesh, p, q, r, c_size, args.batch, pool, device=cuda)
            what = f"row-owned-cache SGD step, {traffic}"

            def fn():
                step(params, w_own, o_own, idx, dout, (1e-4, 1.0))
        else:
            step = fbt.make_sharded_fused_train_step(
                mesh, p, q, r, 1, args.batch, pool, use_cache=True,
                probe_cache=args.cache_mode == "replicated", device=cuda)
            what = ((f"replicated-cache SGD step, {traffic}"
                     if args.cache_mode else
                     f"data-parallel SGD step with LFU counting, {traffic}"))

            def fn():
                step(params, idx, dout, (1e-4, 1.0))

    n = args.iters
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    host = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(host)
    with collectives.timed() as rec:
        for _ in range(n):
            fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    ops = 0
    for ev in prof.events():
        # device work only, not the program's spans' device-side annotations
        if ev.device_type == DeviceType.CUDA and not getattr(
                ev, "is_user_annotation", False):
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3 / n)
            ops += 1
    dev_ms = sum(kernels.values())
    coll_ms = rec["ms"] / n
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[multi-profile] rank {args.rank} of {args.world} "
          f"({args.backend}), {what}: host {host_ms:.3f} ms/call, device "
          f"{dev_ms:.3f} ms/call ({ops / n:g} device operations a call), "
          f"busy {dev_ms / host_ms:.3f}; collectives {coll_ms:.3f} ms host "
          f"time a call ({rec['calls'] / n:g} calls), "
          f"{coll_ms / host_ms:.3f} of the call's host time; largest "
          "kernels (ms/call): " + ", ".join(
              f"{name[:60]} {ms:.4f}" for name, ms in top)
          + f" [{card}]", flush=True)
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace,
                                              f"rank{args.rank}.json"))
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--backend", default=None,
                    help="default: gloo for several ranks on one card, "
                         "else nccl")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=10)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--dlrm", action="store_true")
    mode.add_argument("--serving", action="store_true")
    mode.add_argument("--cache-mode", choices=("replicated", "owned"),
                      default=None)
    ap.add_argument("--quantized", action="store_true",
                    help="with --serving: the int8 fold")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--init", default=None)
    args = ap.parse_args()
    if args.quantized and not args.serving:
        ap.error("--quantized goes with --serving")
    if args.rank is not None:
        _rank(args)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_multi: no CUDA card", file=sys.stderr)
        return 1
    backend = args.backend or (
        "gloo" if args.world > torch.cuda.device_count() else "nccl")
    sys.path.insert(0, str(ROOT))
    from fbtt_embedding_tpu_torch.ops.kernels import _build

    _build.build_all()  # once here, not in every rank
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        cmd = [sys.executable, __file__, "--world", str(args.world),
               "--backend", backend, "--batch", str(args.batch), "--iters",
               str(args.iters), "--init", init]
        cmd += ["--dlrm"] if args.dlrm else []
        cmd += ["--serving"] if args.serving else []
        cmd += ["--quantized"] if args.quantized else []
        cmd += ["--cache-mode", args.cache_mode] if args.cache_mode else []
        cmd += ["--trace", args.trace] if args.trace else []
        procs = [subprocess.Popen(cmd + ["--rank", str(r)])
                 for r in range(args.world)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return 0 if not any(rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
