"""End-to-end DLRM training walkthrough: train -> checkpoint -> resume -> eval.

The whole user journey for the flagship model through the public API:

  1. Build a TT-compressed DLRM (``models/dlrm.py``): 8 embedding tables
     stored as TT cores (~1000x smaller than dense tables at the default
     sizes), bottom and top MLPs, pairwise interaction.
  2. Train with the SGD step on a synthetic CTR task whose labels ride the
     table-0 x table-1 interaction.
  3. Checkpoint mid-run (``utils/checkpoint.py``), simulate a restart by
     restoring into freshly initialised params, and require the restore
     to give a bitwise-equal forward before continuing.
  4. Evaluate held-out AUC.

Run (``-m fbtt_embedding_tpu_torch.examples.train_dlrm``)::

    python -m ...train_dlrm                       # full size, on the card
    python -m ...train_dlrm --tiny --device cpu   # seconds on the CPU

The counterpart of the JAX package's ``examples/train_dlrm.py``, with the
same flags and ``--device`` (``cuda`` unless given).

``--mesh dp,mp`` trains the table-sharded DLRM (cores sharded over ``mp``,
the dense tower data-parallel) in a launched world of ``dp * mp`` ranks,
one per card::

    torchrun --nproc-per-node 4 -m fbtt_embedding_tpu_torch.examples.train_dlrm --mesh 2,2

Every rank draws the same global batches and trains on its block; each
checkpoints its own block (``mid_run.rank<r>``); the held-out AUC is taken
over the gathered logits. Rank 0 prints the result's JSON fields.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float(
        (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def make_batch(rng, cfg, b, device="cuda"):
    """Synthetic CTR batch: label=1 iff the same hot row id appears in
    table 0 and table 1 (the signal lives in the interaction dot). Made
    with numpy (the JAX package's batch for the same ``rng``), then moved
    to ``device``."""
    import torch

    hot = np.arange(4)
    dense = rng.normal(size=(b, cfg.dense_dim)).astype(np.float32)
    # negatives draw from [4, E) so they can never contain a hot row
    indices = rng.integers(
        len(hot), cfg.num_embeddings,
        size=(cfg.num_tables, b, cfg.pooling_factor)).astype(np.int32)
    labels = rng.integers(0, 2, size=b).astype(np.float32)
    for i in range(b):
        if labels[i] > 0.5:
            h = hot[rng.integers(0, len(hot))]
            indices[0, i, 0] = h
            indices[1, i, 0] = h
    return tuple(torch.as_tensor(a, device=device)
                 for a in (dense, indices, labels))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--tiny", action="store_true",
                    help="small shapes for a CPU smoke run")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temp dir)")
    ap.add_argument("--mesh", default=None,
                    help="dp,mp sizes for multi-GPU, e.g. '2,2' (run in a "
                         "launched world of dp * mp ranks)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from fbtt_embedding_tpu_torch.models.dlrm import DLRMConfig
    from fbtt_embedding_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        make_table_sharded_lookup,
    )

    if args.tiny:
        cfg = DLRMConfig(
            num_tables=2, num_embeddings=216, embedding_dim=16,
            tt_p_shapes=[6, 6, 6], tt_q_shapes=[4, 2, 2],
            tt_ranks=[8, 8], dense_dim=4,
            bottom_mlp_dims=[16, 16], top_mlp_dims=[32, 1],
            pooling_factor=2)
        args.batch_size = min(args.batch_size, 128)
    else:
        cfg = DLRMConfig(
            num_tables=8, num_embeddings=1_000_000, embedding_dim=64,
            tt_p_shapes=[100, 100, 100], tt_q_shapes=[4, 4, 4],
            tt_ranks=[32, 32], dense_dim=13,
            bottom_mlp_dims=[512, 256, 64], top_mlp_dims=[512, 256, 1],
            pooling_factor=8)
    dev = args.device
    mesh, own_world, lookup = None, False, None
    if args.mesh:
        dp, mp = (int(v) for v in args.mesh.split(","))
        own_world = not dist.is_initialized()
        if not initialize_distributed(device=dev):
            raise ValueError(
                "--mesh needs a launched world of dp * mp ranks: torchrun "
                "--nproc-per-node N -m fbtt_embedding_tpu_torch.examples."
                "train_dlrm --mesh dp,mp (or FBTT_COORDINATOR, "
                "FBTT_NUM_PROCESSES and FBTT_PROCESS_ID on every process)")
        mesh = make_mesh((dp, mp), ("dp", "mp"),
                         device_type=torch.device(dev).type)
        if torch.device(dev).type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        lookup = make_table_sharded_lookup(mesh, cfg.tt_p_shapes,
                                           cfg.tt_q_shapes, cfg.tt_ranks)
    try:
        result = _train(args, cfg, dev, mesh, lookup)
    finally:
        if own_world:
            dist.destroy_process_group()
    return result


def _train(args, cfg, dev, mesh, lookup) -> dict:
    """The walkthrough's journey on ``dev``: one device, or this rank's
    block on ``mesh`` (``lookup``: the table-sharded lookup)."""
    import torch.distributed as dist

    from fbtt_embedding_tpu_torch.models.dlrm import (
        dlrm_forward,
        init_dlrm_params,
        make_dlrm_train_step,
        shard_dlrm_params,
    )
    from fbtt_embedding_tpu_torch.parallel import host_local_slice
    from fbtt_embedding_tpu_torch.parallel.collectives import all_gather_cat
    from fbtt_embedding_tpu_torch.utils import checkpoint

    def params_for(seed):
        p = init_dlrm_params(cfg, seed=seed, device=dev)
        return p if mesh is None else shard_dlrm_params(p, cfg, mesh)

    def batch(rng, b):
        dense, idx, labels = make_batch(rng, cfg, b, dev)
        if mesh is None:
            return dense, idx, labels
        rows = (("dp", "mp"),)
        return (host_local_slice(mesh, rows, dense),
                host_local_slice(mesh, ("mp", "dp"), idx),
                host_local_slice(mesh, rows, labels))

    rng = np.random.default_rng(0)
    params = params_for(0)
    step = make_dlrm_train_step(cfg, mesh=mesh, learning_rate=args.lr,
                                device=dev)
    rank = 0 if mesh is None else dist.get_rank()

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="dlrm_ckpt_")
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt_path = os.path.join(
        ckpt_dir, "mid_run" if mesh is None else f"mid_run.rank{rank}")
    half = args.steps // 2
    losses = []  # device tensors: read once, after training
    for _ in range(half):
        loss, params = step(params, *batch(rng, args.batch_size))
        losses.append(loss)

    # --- checkpoint, "crash", restore, verify, continue -----------------
    # Probe forward from the IN-MEMORY trained params BEFORE saving: the
    # restore check below must prove the checkpoint reproduces the live
    # state, not merely that two restores agree with each other.
    probe = batch(np.random.default_rng(7), args.batch_size)
    before = dlrm_forward(params, cfg, probe[0], probe[1], lookup)
    checkpoint.save(ckpt_path, params)
    fresh = params_for(99)  # a restarted process
    params = checkpoint.restore(ckpt_path, like=fresh)
    after = dlrm_forward(params, cfg, probe[0], probe[1], lookup)
    np.testing.assert_array_equal(before.cpu().numpy(), after.cpu().numpy())

    for _ in range(args.steps - half):
        loss, params = step(params, *batch(rng, args.batch_size))
        losses.append(loss)

    # --- held-out eval ----------------------------------------------------
    d_te, i_te, y_te = batch(np.random.default_rng(1), 2048)
    logits = dlrm_forward(params, cfg, d_te, i_te, lookup)
    if mesh is not None:  # the blocks in rank order are the batch's
        logits, y_te = all_gather_cat(logits), all_gather_cat(y_te)
    test_auc = auc(y_te.cpu().numpy(), logits.cpu().numpy())
    losses = [float(v) for v in losses]
    result = {
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "losses": losses,
        "auc": test_auc,
        "ckpt": ckpt_path,
        "devices": 1 if mesh is None else mesh.size(),
    }
    if rank == 0:
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"held-out AUC {test_auc:.4f}; checkpoint at {ckpt_path}")
        if mesh is not None:
            print(json.dumps({k: result[k] for k in (
                "first_loss", "last_loss", "auc", "ckpt", "devices")}))
    return result


if __name__ == "__main__":
    main()
