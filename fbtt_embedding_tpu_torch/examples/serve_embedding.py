"""Serving walkthrough: train a TT embedding, freeze it, serve requests.

The inference half of the user journey through the public API:

  1. Train a cached ``TTEmbeddingBag`` for a few steps (fused sparse SGD,
     LFU counting) and promote the hot rows with ``cache_populate()``.
  2. Freeze for serving (``freeze_for_serving``): a one-time weight fold
     builds the pass tables and the G0xG1 pair table, so every serve
     skips the first kernel pass and the forward permute. ``--quantize``
     keeps the pair table and the cache's rows as per-row int8.
  3. Serve requests of any size through the bucketed front-end
     (``make_bucketed_serving_fn``): each (batch, nnz) rounds up to a fixed
     bucket grid.
  4. Check every served batch against the module's forward.

Run (``-m fbtt_embedding_tpu_torch.examples.serve_embedding``)::

    python -m ...serve_embedding                     # E=1M, on the card
    python -m ...serve_embedding --tiny --device cpu # seconds on the CPU
    python -m ...serve_embedding --quantize          # int8 folded tables

The counterpart of the JAX package's ``examples/serve_embedding.py``, with
the same flags and ``--device`` (``cuda`` unless given).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--quantize", action="store_true",
                    help="fold int8 pair/cache tables")
    ap.add_argument("--train-steps", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from fbtt_embedding_tpu_torch import (
        OptimType,
        TTEmbeddingBag,
        make_bucketed_serving_fn,
    )

    if args.tiny:
        e, d, p, q, ranks = 216, 16, [6, 6, 6], [4, 2, 2], [8, 8]
        cache_size, hashtbl = 32, 216
        # approx-normal init leaves a tiny table with large rows (std ~4 at
        # E=216), where lr 0.002 diverges: a tame init and lr for the toy
        dist, lr = "uniform", 5e-4
    else:
        e, d, p, q, ranks = 1_000_000, 64, [100, 100, 100], [4, 4, 4], \
            [32, 32]
        cache_size, hashtbl = 10_000, 1_000_000
        dist, lr = "approx-normal", 0.002

    emb = TTEmbeddingBag(
        num_embeddings=e, embedding_dim=d, tt_p_shapes=p, tt_q_shapes=q,
        tt_ranks=ranks, optimizer=OptimType.SGD, learning_rate=lr,
        sparse=True, use_cache=True, cache_size=cache_size,
        hashtbl_size=hashtbl, weight_dist=dist, device=args.device)

    # --- 1. train briefly so the fold has real weights and a warm cache --
    rng = np.random.default_rng(0)
    b, L = 64, 8
    target = torch.as_tensor(rng.normal(size=(d,)).astype(np.float32),
                             device=args.device)
    for _ in range(args.train_steps):
        idx = (rng.zipf(1.5, size=b * L) % e).astype(np.int64)
        offs = np.arange(0, b * L + 1, L, dtype=np.int64)
        out = emb(idx, offs)
        emb.backward(2.0 * (out - target[None]) / b)
    emb.cache_populate()

    def host(x):
        return x.detach().cpu().numpy()

    # --- 2. freeze: one fixed-shape batch through the fold ---------------
    quant = "int8" if args.quantize else None
    tol = 0.06 if args.quantize else 5e-3
    folded_fixed, serve_fixed = emb.freeze_for_serving(
        batch_size=64, quantize=quant)
    fb, fl = 64, 4
    fidx = (rng.zipf(1.5, size=fb * fl) % e).astype(np.int64)
    foffs = np.arange(0, fb * fl + 1, fl, dtype=np.int64)
    fixed_out = host(serve_fixed(folded_fixed, fidx.astype(np.int32),
                                 foffs.astype(np.int32)))[0]
    fixed_ref = host(emb(fidx, foffs, warmup=False))
    fscale = max(1e-6, float(np.abs(fixed_ref).max()))
    fixed_err = float(np.abs(fixed_out - fixed_ref).max()) / fscale
    assert fixed_err < tol, fixed_err

    # --- 3. the bucketed front-end ---------------------------------------
    fold, serve = make_bucketed_serving_fn(
        emb.tt_p_shapes, emb.tt_q_shapes, emb.tt_ranks, num_tables=1,
        batch_buckets=[16, 64], nnz_buckets=[128, 512], quantize=quant,
        device=args.device)
    folded = fold(emb.params)

    # --- 4. serve odd request sizes, check against the module forward ----
    max_err, served = 0.0, 0
    for breq, lreq in [(5, 7), (16, 8), (41, 3), (64, 2)]:
        nnz = breq * lreq
        idx = (rng.zipf(1.5, size=nnz) % e).astype(np.int64)
        offs = np.arange(0, nnz + 1, lreq, dtype=np.int64)
        got = host(serve(folded, idx, offs))[0]
        expect = host(emb(idx, offs, warmup=False))
        assert np.isfinite(expect).all(), "training diverged (NaN weights)"
        scale = max(1e-6, float(np.abs(expect).max()))
        # max() of Python floats drops a NaN (max(0.0, nan) == 0.0): check
        # each error before it is folded in
        err = float(np.abs(got - expect).max()) / scale
        assert np.isfinite(err), "serving output not finite"
        max_err = max(max_err, err)
        served += breq
    assert max_err < tol, (max_err, tol)
    hit = emb.cache_hit_rate()
    print(f"served {served} bags across 4 request shapes; "
          f"max rel err vs training forward {max_err:.2e}; "
          f"cache hit rate {hit:.2f}"
          + (" (int8 folded tables)" if args.quantize else ""))
    return {"max_rel_err": max_err, "served": served, "hit_rate": hit}


if __name__ == "__main__":
    main()
