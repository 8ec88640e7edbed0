"""TT-EmbeddingBag benchmark CLI (reference ``tt_embeddings_benchmark.py``).

Counterpart of ``fbtt_embedding_tpu/benchmark.py``, with the same flags as
the reference's click CLI (``tt_embeddings_benchmark.py:124-133``):
``--batch-size --iters --pooling-factor --p-shapes --q-shapes --ranks
--sparse --optimizer --run-baseline``, the request generator's knobs
(``--alpha`` Zipf, ``--reuse``, ``--weighted``, ``--fp16``,
``--long-index``), LFU counting (``--use-cache``, ``--count-interval``),
``--impl`` and the same GFLOPS / BW accounting
(``tt_embeddings_benchmark.py:153-159,188-192``: forward-chain MACs x2, x3
for the forward and the backward's two GEMM passes); plus ``--device``
(``cuda`` unless given).

It times the port's fused training step (``make_fused_train_step``) by the
slope between two step counts (``utils.profiling.slope_time``): k steps
in a Python loop, then one synchronise. ``--run-baseline`` times the
reference's own baseline, ``torch.nn.EmbeddingBag(E, D, mode="sum",
sparse=True)`` with ``torch.optim.SGD(lr=0.01)``, forward + backward on
the same ``d_output``.

Run: ``python -m fbtt_embedding_tpu_torch.benchmark [options]``
"""

from __future__ import annotations

import argparse
import logging
from typing import List

import numpy as np

logger = logging.getLogger("fbtt_benchmark")


def validate_list(param_str: str) -> List[int]:
    values = []
    for v in param_str.strip().split(","):
        if int(v) <= 0:
            raise ValueError(f"Invalid parameter '{param_str}'")
        values.append(int(v))
    return values


def generate_requests(
    rng: np.random.Generator,
    iters: int,
    b: int,
    t: int,
    length: int,
    num_embeddings: int,
    reuse: float = 0.0,
    alpha: float = 1.0,
    weighted: bool = False,
    fp16: bool = False,
    long_index: bool = True,
):
    """Request generator (reference ``generate_requests``,
    ``tt_embeddings_benchmark.py:37-91``): uniform or Zipf indices with an
    optional inter-batch reuse rate; CSR layout with
    ``include_last_offset=True`` semantics. A copy of the JAX package's:
    the same ``rng`` gives the same requests, bit for bit."""
    nnz = t * b * length
    if alpha <= 1.0:
        all_indices = rng.integers(0, num_embeddings,
                                   size=(iters, t, b * length))
    else:
        all_indices = rng.zipf(alpha, size=(iters, t, b * length)) \
            % num_embeddings
    for it in range(iters - 1):
        for tt in range(t):
            reused = rng.permutation(b * length)[: int(b * length * reuse)]
            all_indices[it + 1, tt, reused] = all_indices[it, tt, reused]
    # reference --long-index default: int64 indices/offsets
    # (tt_embeddings_benchmark.py:130,96-98)
    idx_dtype = np.int64 if long_index else np.int32
    offsets = np.arange(0, nnz + 1, length, dtype=idx_dtype)
    w_dtype = np.float16 if fp16 else np.float32
    out = []
    for it in range(iters):
        w = rng.standard_normal(nnz).astype(w_dtype) if weighted else None
        out.append((all_indices[it].reshape(-1).astype(idx_dtype), offsets,
                    w))
    return out


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--iters", type=int, default=100)
    parser.add_argument("--pooling-factor", type=int, default=20)
    parser.add_argument("--p-shapes", type=validate_list,
                        default="200,220,250")
    parser.add_argument("--q-shapes", type=validate_list, default="4,4,4")
    parser.add_argument("--ranks", type=validate_list, default="32,32")
    parser.add_argument("--sparse", action="store_true", default=True)
    parser.add_argument("--no-sparse", dest="sparse", action="store_false")
    parser.add_argument("--optimizer", default="sgd",
                        choices=["sgd", "adagrad"])
    parser.add_argument("--use-cache", action="store_true", default=True)
    parser.add_argument("--no-cache", dest="use_cache", action="store_false")
    parser.add_argument(
        "--count-interval", type=int, default=1,
        help="sampled LFU counting: count every k-th step with k-scaled "
             "increments (1 = reference parity, count every step)")
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--reuse", type=float, default=0.0)
    parser.add_argument("--weighted", action="store_true")
    parser.add_argument("--fp16", action="store_true",
                        help="generate per-sample weights in fp16 "
                             "(reference generator parity)")
    parser.add_argument("--long-index", dest="long_index",
                        action="store_true", default=True,
                        help="int64 indices/offsets (reference default)")
    parser.add_argument("--no-long-index", dest="long_index",
                        action="store_false")
    parser.add_argument("--impl", default="auto",
                        choices=["auto", "pallas_sorted", "pallas", "xla"])
    parser.add_argument("--run-baseline", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None) -> dict:
    """Run the benchmark; returns its numbers (``tt_us_per_nnz``, and with
    ``--run-baseline`` ``baseline_us_per_nnz``) beside the log lines."""
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logger.setLevel(logging.INFO)
    args = _parser().parse_args(argv)
    for name in ("p_shapes", "q_shapes", "ranks"):
        if isinstance(getattr(args, name), str):
            setattr(args, name, validate_list(getattr(args, name)))

    import torch

    from fbtt_embedding_tpu_torch import (
        OptimType,
        TTEmbeddingParams,
        init_tt_cores,
        make_cache_state,
        make_fused_train_step,
    )
    from fbtt_embedding_tpu_torch.utils.profiling import slope_time

    device = torch.device(args.device)
    p, q, ranks = args.p_shapes, args.q_shapes, args.ranks
    rfull = [1] + ranks + [1]
    b, length = args.batch_size, args.pooling_factor
    num_embeddings = int(np.prod(p))
    embedding_dim = int(np.prod(q))
    nnz = b * length
    optim = OptimType.SGD if args.optimizer == "sgd" else \
        OptimType.EXACT_ADAGRAD

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(args.seed)
    (indices_np, offsets_np, w_np), = generate_requests(
        rng, 1, b, 1, length, num_embeddings,
        reuse=args.reuse, alpha=args.alpha, weighted=args.weighted,
        fp16=args.fp16, long_index=args.long_index,
    )
    indices = torch.as_tensor(indices_np, device=device)
    offsets = torch.as_tensor(offsets_np, device=device)
    sample_weights = (None if w_np is None else
                      torch.as_tensor(w_np.astype(np.float32), device=device))

    # FLOP model, reference tt_embeddings_benchmark.py:153-159
    if len(q) >= 3:
        flop = (
            q[0] * rfull[1] * q[1] * rfull[2]
            + q[0] * q[1] * rfull[2] * q[2]
        ) * 2.0 * nnz
    else:
        flop = q[0] * rfull[1] * q[1] * 2.0 * nnz
    bw = 4.0 * nnz * embedding_dim

    cores = tuple(
        torch.tensor(c, device=device)
        for c in init_tt_cores(
            rng, "uniform", 1, num_embeddings, embedding_dim, p, q, rfull)
    )
    opt_state = () if optim == OptimType.SGD else tuple(
        torch.zeros_like(c) for c in cores)
    cache = (
        make_cache_state(num_embeddings, int(0.1 * num_embeddings),
                         embedding_dim, "none",
                         num_embeddings=num_embeddings, device=device)
        if args.use_cache else None
    )
    params = TTEmbeddingParams(cores, opt_state, cache)
    ci = max(1, args.count_interval)
    step = make_fused_train_step(
        p, q, rfull, num_tables=1, batch_size=b, optimizer=optim,
        use_cache=args.use_cache, probe_cache=False, impl=args.impl,
        count_interval=ci, device=device,
    )
    d_output = torch.as_tensor(
        (rng.random((1, b, embedding_dim)) * 0.1).astype(np.float32),
        device=device)
    lr_eps = (0.01, 1e-10)

    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    logger.info("device: %s, impl: %s, sparse: %s, optimizer: %s",
                kind, args.impl, args.sparse, optim)
    logger.info("p_shapes: %s, q_shapes: %s, ranks: %s", p, q, ranks)
    logger.info("B: %s, E: %s, D: %s, nnz: %s, alpha: %s",
                b, num_embeddings, embedding_dim, nnz, args.alpha)

    def timed(k):
        # each trip = one counting step + (ci - 1) non-counting steps;
        # the update is in place
        for _ in range(k):
            for j in range(ci):
                step(params, indices, offsets, d_output, lr_eps,
                     weights=sample_weights, count=(j == 0))
        sync()

    k1 = max(args.iters // (10 * ci), 2)
    time_per_iter = slope_time(timed, max(args.iters // ci, k1 + 2), k1) / ci
    result = {"device": kind, "nnz": nnz,
              "tt_us_per_nnz": time_per_iter / nnz * 1e6}
    logger.info(
        "TTEmbeddingBag FWD-BWD time/nnz: %.3f usecs, GFLOPS: %.3f, BW: %.3f",
        time_per_iter / nnz * 1e6,
        3.0 * flop / time_per_iter / 1e9,
        3.0 * bw / time_per_iter / 1e9,
    )

    if args.run_baseline:
        # the reference's baseline (tt_embeddings_benchmark.py:195-211): an
        # uncompressed EmbeddingBag, sparse gradients, SGD
        bag = torch.nn.EmbeddingBag(
            num_embeddings, embedding_dim, mode="sum", sparse=True,
            include_last_offset=True, device=device)
        opt = torch.optim.SGD(bag.parameters(), lr=0.01)

        def timed_base(k):
            for _ in range(k):
                opt.zero_grad(set_to_none=True)
                out = bag(indices, offsets, per_sample_weights=sample_weights)
                out.backward(d_output[0])
                opt.step()
            sync()

        t_base = slope_time(timed_base, args.iters, k1)
        result["baseline_us_per_nnz"] = t_base / nnz * 1e6
        logger.info(
            "EmbeddingBag FWD-BWD time/nnz: %.3f usecs, BW: %.3f",
            t_base / nnz * 1e6, 3.0 * bw / t_base / 1e9,
        )
        logger.info(
            "TT vs uncompressed: %.2fx %s (compression %.0fx)",
            max(t_base / time_per_iter, time_per_iter / t_base),
            "faster" if time_per_iter < t_base else "slower",
            num_embeddings * embedding_dim * 4
            / sum(c.numel() * 4 for c in cores),
        )
    return result


if __name__ == "__main__":
    main()
