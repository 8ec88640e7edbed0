"""DLRM-style recommendation model over TT-compressed embedding tables.

Counterpart of ``fbtt_embedding_tpu.models.dlrm``: a dense tower (bottom
MLP -> pairwise dot interaction -> top MLP) fed by ``T`` TT-compressed
tables. The lookup is the port's ``pooled_tt_lookup`` (the flat pipeline's
kernels on the card), differentiated by autograd through ``FlatLookup``;
the MLPs and the interaction are ``torch.matmul`` / ``einsum``, as the JAX
package computes them outside any kernel. On a mesh the cores are
table-sharded and the embeddings exchanged (``parallel.sharded``), the
dense tower data-parallel.

All state lives in :class:`DLRMParams`; :func:`make_dlrm_train_step`
updates it in place (the JAX step donates its buffers).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from fbtt_embedding_tpu_torch.parallel.collectives import all_reduce_sum
from fbtt_embedding_tpu_torch.parallel.mesh import axis_group, axis_size
from fbtt_embedding_tpu_torch.parallel.sharded import (
    fixed_pool_lookup,
    make_table_sharded_lookup,
    shard_params_for_table_parallel,
)
from fbtt_embedding_tpu_torch.utils._tree import leaves_with_paths, map_leaves
from fbtt_embedding_tpu_torch.utils.init import init_tt_cores


@dataclass
class MLPParams:
    weights: Tuple[torch.Tensor, ...]  # [fan_in, fan_out] each
    biases: Tuple[torch.Tensor, ...]   # [fan_out] each


@dataclass
class DLRMParams:
    """TT cores (module layout ``[T, p_t, r_t*q_t*r_{t+1}]``) and the two
    MLPs, float32; the leaves in the JAX package's ``DLRMParams`` order."""

    tt_cores: Tuple[torch.Tensor, ...]
    bottom_mlp: MLPParams
    top_mlp: MLPParams


class DLRMConfig:
    """Static model configuration (the JAX package's, same defaults)."""

    def __init__(
        self,
        num_tables: int = 8,
        num_embeddings: int = 1_000_000,
        embedding_dim: int = 64,
        tt_p_shapes: Sequence[int] = (100, 100, 100),
        tt_q_shapes: Sequence[int] = (4, 4, 4),
        tt_ranks: Sequence[int] = (32, 32),
        dense_dim: int = 13,
        bottom_mlp_dims: Sequence[int] = (512, 256, 64),
        top_mlp_dims: Sequence[int] = (512, 256, 1),
        pooling_factor: int = 10,
    ):
        assert int(np.prod(tt_q_shapes)) == embedding_dim
        assert bottom_mlp_dims[-1] == embedding_dim, (
            "bottom MLP must project dense features to embedding_dim"
        )
        self.num_tables = num_tables
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.tt_p_shapes = list(tt_p_shapes)
        self.tt_q_shapes = list(tt_q_shapes)
        self.tt_ranks = (
            [1] + list(tt_ranks) + [1]
            if len(tt_ranks) == len(tt_p_shapes) - 1 else list(tt_ranks)
        )
        self.dense_dim = dense_dim
        self.bottom_mlp_dims = list(bottom_mlp_dims)
        self.top_mlp_dims = list(top_mlp_dims)
        self.pooling_factor = pooling_factor

    @property
    def interaction_dim(self) -> int:
        # pairwise dots among (num_tables + 1) vectors + the bottom output
        f = self.num_tables + 1
        return f * (f - 1) // 2 + self.embedding_dim


def _init_mlp(rng: np.random.Generator, dims: Sequence[int],
              device) -> MLPParams:
    ws, bs = [], []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        bound = np.sqrt(6.0 / (fan_in + fan_out))
        ws.append(torch.tensor(
            rng.uniform(-bound, bound, size=(fan_in, fan_out))
            .astype(np.float32), device=device))
        bs.append(torch.zeros((fan_out,), dtype=torch.float32,
                              device=device))
    return MLPParams(tuple(ws), tuple(bs))


def init_dlrm_params(cfg: DLRMConfig, seed: int = 0,
                     weight_dist: str = "approx-normal",
                     device="cuda") -> DLRMParams:
    """Random parameters from one ``np.random.default_rng(seed)`` drawn in
    the JAX package's order (cores, bottom MLP, top MLP): bitwise the JAX
    package's for the same seed. approx-normal (the reference default)
    keeps each core's magnitude bounded away from zero; "normal" cores
    scale as 1/sqrt(E) each, and the chain's gradients vanish at large E."""
    rng = np.random.default_rng(seed)
    cores = tuple(
        torch.tensor(c, device=device)
        for c in init_tt_cores(
            rng, weight_dist, cfg.num_tables, cfg.num_embeddings,
            cfg.embedding_dim, cfg.tt_p_shapes, cfg.tt_q_shapes, cfg.tt_ranks,
        )
    )
    bottom = _init_mlp(rng, [cfg.dense_dim] + cfg.bottom_mlp_dims, device)
    top = _init_mlp(rng, [cfg.interaction_dim] + cfg.top_mlp_dims, device)
    return DLRMParams(cores, bottom, top)


def dlrm_params_from_jax(params, device="cuda", mesh=None,
                         table_axis: str = "mp") -> DLRMParams:
    """The JAX package's ``DLRMParams`` (its leaves as numpy arrays, or any
    object with the same fields) -> this package's, every tensor a copy on
    ``device``; with ``mesh``, this rank's block of the cores
    (:func:`shard_dlrm_params`)."""
    def put(a):
        return torch.tensor(np.asarray(a), device=device)

    def mlp(m):
        return MLPParams(tuple(put(w) for w in m.weights),
                         tuple(put(b) for b in m.biases))

    cores = (tuple(put(c) for c in params.tt_cores) if mesh is None else
             shard_params_for_table_parallel(mesh, params.tt_cores,
                                             table_axis, device))
    return DLRMParams(cores, mlp(params.bottom_mlp), mlp(params.top_mlp))


def shard_dlrm_params(params: DLRMParams, cfg: DLRMConfig, mesh,
                      table_axis: str = "mp") -> DLRMParams:
    """This rank's parameters for the table-sharded step: its contiguous
    block of ``T / mp`` tables of every core and copies of the MLPs (which
    every rank holds), on the params' device. Raises ValueError when ``mp``
    does not divide ``cfg.num_tables``."""
    device = params.tt_cores[0].device
    return DLRMParams(
        shard_params_for_table_parallel(mesh, params.tt_cores, table_axis,
                                        device),
        map_leaves(lambda t: t.detach().to(device, copy=True),
                   params.bottom_mlp),
        map_leaves(lambda t: t.detach().to(device, copy=True),
                   params.top_mlp))


def _mlp_apply(mlp: MLPParams, x: torch.Tensor,
               final_activation: bool = False) -> torch.Tensor:
    n = len(mlp.weights)
    for i, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
        x = x @ w + b
        if i < n - 1 or final_activation:
            x = torch.relu(x)
    return x


def _interact(bottom_out: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Dot-product feature interaction (DLRM style).

    bottom_out: [B, D]; emb: [T, B, D]. Returns [B, T*(T+1)/2 + D]: the
    upper-triangle pairwise dots among the T+1 feature vectors, after the
    dense projection."""
    feats = torch.cat([bottom_out[None], emb], dim=0)  # [F, B, D]
    f = feats.shape[0]
    gram = torch.einsum("fbd,gbd->bfg", feats, feats)  # [B, F, F]
    iu, ju = torch.triu_indices(f, f, 1, device=gram.device)  # numpy's order
    pairs = gram[:, iu, ju]
    return torch.cat([bottom_out, pairs], dim=-1)


def dlrm_forward(
    params: DLRMParams,
    cfg: DLRMConfig,
    dense: torch.Tensor,        # [B, dense_dim]
    indices: torch.Tensor,      # [T, B, L] int32
    lookup_fn=None,
) -> torch.Tensor:
    """Logits [B]. ``lookup_fn(cores, indices) -> [T, B, D]`` overrides the
    embedding lookup; the default is :func:`fixed_pool_lookup` with
    ``impl="auto"`` (the flat pipeline's kernels on the card, bf16
    staging)."""
    if lookup_fn is None:
        emb = fixed_pool_lookup(params.tt_cores, indices, cfg.tt_p_shapes,
                                cfg.tt_q_shapes, cfg.tt_ranks)
    else:
        emb = lookup_fn(params.tt_cores, indices)
    bottom_out = _mlp_apply(params.bottom_mlp, dense)
    z = _interact(bottom_out, emb)
    return _mlp_apply(params.top_mlp, z)[:, 0]


def _bce_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(_bce_terms(logits, labels))


def make_dlrm_train_step(
    cfg: DLRMConfig,
    mesh=None,
    learning_rate: float = 0.01,
    device="cuda",
    impl: str = "auto",
    precision: Optional[str] = None,
    table_axis: str = "mp",
    batch_axis: str = "dp",
):
    """SGD train step ``step(params, dense, indices, labels) -> (loss,
    params)``.

    The BCE loss of :func:`dlrm_forward`, the gradient of every tensor of
    ``params`` by autograd (the cores' through the lookup of ``impl`` and
    ``precision``: with "auto", ``FlatLookup``, whose backward runs the
    gradient pass kernel B3 on the card) and ``p -= learning_rate * g``,
    **in place**: ``params`` is returned updated, as the JAX step donates
    it. The batch may be numpy arrays or tensors and goes to ``device``,
    where the params must be. The loss is a 0-d device tensor: the step
    never synchronises with the host.

    ``mesh`` (a ``DeviceMesh`` with ``table_axis`` and, optionally,
    ``batch_axis``): the JAX package's hybrid-parallel step. ``params`` is
    this rank's (:func:`shard_dlrm_params`): its block of ``T / mp`` tables
    of the cores, the whole MLPs. The batch is this rank's block:
    ``indices [T / mp, B / dp, L]`` (tables over ``table_axis``, batch over
    ``batch_axis``), ``dense [B / (dp * mp), dense_dim]`` and ``labels [B /
    (dp * mp)]`` at its row-major ``(dp, mp)`` coordinate. The embeddings
    go through the all_to_all exchange (``make_table_sharded_lookup``);
    each rank's loss term is its sum over the global batch size, so one
    all-reduce (sum) over every rank gives the MLPs' gradients and the
    loss of the global batch, while the cores' gradients come back through
    the exchange and are summed over ``batch_axis`` alone."""
    device = torch.device(device)
    lr = float(learning_rate)
    if mesh is None:
        def lookup(cores, indices):
            return fixed_pool_lookup(cores, indices, cfg.tt_p_shapes,
                                     cfg.tt_q_shapes, cfg.tt_ranks,
                                     precision=precision, impl=impl)
        everyone, n_batch = None, 1
    else:
        if table_axis not in (getattr(mesh, "mesh_dim_names", None) or ()):
            raise ValueError(f"mesh {mesh!r} has no table axis "
                             f"{table_axis!r} (parallel.make_mesh)")
        b_axis = batch_axis if batch_axis in mesh.mesh_dim_names else None
        lookup = make_table_sharded_lookup(
            mesh, cfg.tt_p_shapes, cfg.tt_q_shapes, cfg.tt_ranks,
            table_axis=table_axis, batch_axis=b_axis, precision=precision,
            impl=impl)
        batch_all = (b_axis, table_axis) if b_axis else (table_axis,)
        everyone = axis_group(mesh, batch_all)
        n_batch = int(np.prod([axis_size(mesh, a) for a in batch_all]))

    def step(params: DLRMParams, dense, indices, labels):
        dense = torch.as_tensor(dense, dtype=torch.float32, device=device)
        indices = torch.as_tensor(indices, device=device)
        labels = torch.as_tensor(labels, dtype=torch.float32, device=device)
        leaves = [t for _, t in leaves_with_paths(params)]
        with torch.enable_grad():
            # the graph's inputs: leaves sharing the params' storage
            view = map_leaves(lambda t: t.detach().requires_grad_(), params)
            live = [t for _, t in leaves_with_paths(view)]
            logits = dlrm_forward(view, cfg, dense, indices, lookup)
            if everyone is None:
                loss = bce_loss(logits, labels)
            else:
                loss = (_bce_terms(logits, labels).sum()
                        / (labels.shape[0] * n_batch))
            grads = list(torch.autograd.grad(loss, live))
        if everyone is not None:
            # the MLPs' gradients and the loss summed over every rank; the
            # cores' came back exact from the exchange and the dp sum
            n_cores = len(params.tt_cores)
            *mlp_grads, loss = all_reduce_sum(
                grads[n_cores:] + [loss.detach().reshape(1)], everyone)
            grads[n_cores:] = mlp_grads
            loss = loss.reshape(())
        with torch.no_grad():
            torch._foreach_add_(leaves, grads, alpha=-lr)
        return loss.detach(), params

    return step
