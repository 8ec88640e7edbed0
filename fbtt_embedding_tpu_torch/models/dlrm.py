"""DLRM-style recommendation model over TT-compressed embedding tables.

Counterpart of ``fbtt_embedding_tpu.models.dlrm`` on one device: a dense
tower (bottom MLP -> pairwise dot interaction -> top MLP) fed by ``T``
TT-compressed tables. The lookup is the port's ``pooled_tt_lookup`` (the
flat pipeline's kernels on the card), differentiated by autograd through
``FlatLookup``; the MLPs and the interaction are ``torch.matmul`` /
``einsum``, as the JAX package computes them outside any kernel.

All state lives in :class:`DLRMParams`; :func:`make_dlrm_train_step`
updates it in place (the JAX step donates its buffers).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from fbtt_embedding_tpu_torch.ops.lookup import pooled_tt_lookup
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


def dlrm_params_from_jax(params, device="cuda") -> DLRMParams:
    """The JAX package's ``DLRMParams`` (its leaves as numpy arrays, or any
    object with the same fields) -> this package's, every tensor a copy on
    ``device``."""
    def put(a):
        return torch.tensor(np.asarray(a), device=device)

    def mlp(m):
        return MLPParams(tuple(put(w) for w in m.weights),
                         tuple(put(b) for b in m.biases))

    return DLRMParams(tuple(put(c) for c in params.tt_cores),
                      mlp(params.bottom_mlp), mlp(params.top_mlp))


def fixed_pool_lookup(
    cores: Sequence[torch.Tensor],
    indices: torch.Tensor,  # [T, B, L] int32
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    weights: Optional[torch.Tensor] = None,  # [T, B, L]
    precision: Optional[str] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Pooled lookup of ``[T, B, L]`` indices (every bag L lookups) ->
    ``[T, B, D]`` float32 through :func:`pooled_tt_lookup`, differentiable
    with respect to the cores (the JAX package's
    ``parallel.sharded._fixed_pool_lookup``)."""
    t, b, length = indices.shape
    nnz = t * b * length
    pos = torch.arange(nnz, dtype=torch.int32, device=indices.device)
    rowidx = (pos // length) % b
    tableidx = pos // (b * length)
    return pooled_tt_lookup(
        cores, tt_p_shapes, tt_q_shapes, tt_ranks, b, indices.reshape(nnz),
        rowidx, tableidx if t > 1 else None,
        weights=(None if weights is None
                 else weights.reshape(nnz).to(torch.float32)),
        precision=precision, impl=impl)


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


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(
        torch.clamp_min(logits, 0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def make_dlrm_train_step(
    cfg: DLRMConfig,
    mesh=None,
    learning_rate: float = 0.01,
    device="cuda",
    impl: str = "auto",
    precision: Optional[str] = None,
):
    """SGD train step ``step(params, dense, indices, labels) -> (loss,
    params)`` on one device.

    The BCE loss of :func:`dlrm_forward`, the gradient of every tensor of
    ``params`` by autograd (the cores' through the lookup of ``impl`` and
    ``precision``: with "auto", ``FlatLookup``, whose backward runs the
    gradient pass kernel B3 on the card) and ``p -= learning_rate * g``,
    **in place**: ``params`` is returned updated, as the JAX step donates
    it. The batch may be numpy arrays or tensors and goes to ``device``,
    where the params must be. The loss is a 0-d device tensor: the step
    never synchronises with the host.

    ``mesh``: the table-sharded multi-GPU step is not ported yet; passing
    one raises NotImplementedError."""
    if mesh is not None:
        raise NotImplementedError(
            "make_dlrm_train_step(mesh=...): the table-sharded DLRM step is "
            "multi-GPU work (ROADMAP A7), not ported yet")
    device = torch.device(device)
    lr = float(learning_rate)

    def lookup(cores, indices):
        return fixed_pool_lookup(cores, indices, cfg.tt_p_shapes,
                                 cfg.tt_q_shapes, cfg.tt_ranks,
                                 precision=precision, impl=impl)

    def step(params: DLRMParams, dense, indices, labels):
        dense = torch.as_tensor(dense, dtype=torch.float32, device=device)
        indices = torch.as_tensor(indices, device=device)
        labels = torch.as_tensor(labels, dtype=torch.float32, device=device)
        leaves = [t for _, t in leaves_with_paths(params)]
        with torch.enable_grad():
            # the graph's inputs: leaves sharing the params' storage
            view = map_leaves(lambda t: t.detach().requires_grad_(), params)
            live = [t for _, t in leaves_with_paths(view)]
            loss = bce_loss(dlrm_forward(view, cfg, dense, indices, lookup),
                            labels)
            grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            torch._foreach_add_(leaves, list(grads), alpha=-lr)
        return loss.detach(), params

    return step
