#!/usr/bin/env python3
"""Which collectives a backend takes on CUDA tensors, on this machine.

``parallel.collectives`` calls the backend on the tensors where they lie,
so a world of several ranks on one card (gloo: NCCL takes one rank a
card) needs gloo to take CUDA tensors for the three collectives the
multi-GPU layer uses. This script finds out: a world of ``--world``
processes on the visible card(s) runs each of them on CUDA tensors and
checks its result, printing one line per operation (``takes cuda`` /
``refused: <error>`` / ``wrong result``).

    python3 scripts/probe_gloo_cuda.py [--backend gloo] [--world 2]

Needs a CUDA card; exits non-zero without one.
"""

import argparse
import os
import subprocess
import sys
import tempfile


def _rank(args) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(args.rank % torch.cuda.device_count())
    dist.init_process_group(args.backend, init_method=args.init,
                            world_size=args.world, rank=args.rank)
    n, r = args.world, args.rank
    dev = torch.device("cuda", torch.cuda.current_device())

    def all_reduce():
        t = torch.full((1000,), float(r + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == n * (n + 1) / 2).all())

    def all_gather():
        t = torch.full((5,), float(r), device=dev)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t)
        return all(bool((p == i).all()) for i, p in enumerate(parts))

    def all_to_all():
        t = torch.arange(n * 4, device=dev, dtype=torch.float32) + 100 * r
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        want = torch.cat([torch.arange(4, device=dev, dtype=torch.float32)
                          + 4 * r + 100 * j for j in range(n)])
        return bool(torch.equal(out, want))

    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("all_to_all", all_to_all)):
        try:  # a probe: the refusal is the finding
            ok = fn()
            torch.cuda.synchronize()
            verdict = "takes cuda" if ok else "wrong result"
        except RuntimeError as e:
            verdict = f"refused: {str(e).splitlines()[0][:160]}"
        if r == 0:
            print(f"[probe] {args.backend} {name} on cuda tensors, world "
                  f"{n}: {verdict}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--init", default=None)
    args = ap.parse_args()
    if args.rank is not None:
        _rank(args)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA card", file=sys.stderr)
        return 1
    print(f"[probe] torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--backend", args.backend, "--world",
             str(args.world), "--rank", str(r), "--init", init])
            for r in range(args.world)]
        rcs = [p.wait(timeout=300) for p in procs]
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
