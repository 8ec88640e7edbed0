"""Plain float32 reference of MLPerf DLRM-DCNv2 with TT-compressed tables:
the forward, the loss, the gradients by autograd and the optimizers, in
plain PyTorch with TF32 off. It imports nothing of the program and no JAX.

Written from the published description: MLCommons Training
``recommendation_v2/torchrec_dlrm`` (TorchRec's ``DLRM_DCN``:
``DenseArch``, ``SparseArch``, ``InteractionDCNArch`` with
``LowRankCrossNet``, ``OverArch``), and TT-Rec (arXiv:2101.11714) for the
TT tables:

* each sparse feature is the sum of its bag's rows (``EmbeddingBag``,
  mode sum; a lookup's weight, where given, scales its row);
* the bottom MLP's output, then the pooled rows in feature order, are
  concatenated into ``x0 [B, (F + 1) D]``; each cross layer is ``x_{l+1}
  = x0 * (x_l V_l W_l + b_l) + x_l``; the top MLP gives one logit; every
  MLP layer but the top MLP's last is followed by ReLU;
* the loss is the mean BCE with logits;
* Adagrad (lr, eps, state from 0): element-wise ``s += g^2; w -= lr * g /
  (sqrt(s) + eps)`` for the MLPs and the cross network
  (``torch.optim.Adagrad``); row-wise for the plain tables (TorchRec's
  fused embedding optimizer, FBGEMM's exact row-wise Adagrad: ``s_row +=
  mean(g_row^2)``, rows with no gradient unchanged); SGD ``w -= lr * g``.

Departures from the published model, all the benchmark cell's:

* the features in ``spec["tt_features"]`` are TT tables (TT-Rec's model):
  core ``t`` of the group is ``[T_tt, p_t, r_t * q_t * r_{t+1}]``, each row
  laid out ``[r_t, q_t, r_{t+1}]``; an id splits into per-core ids ``(id //
  prod(p[t+1:])) % p_t``; its row is the chain ``G_0[i_0] .. G_{n-1}
  [i_{n-1}]`` read as ``[q_0 .. q_{n-1}]``;
* the TT cores take element-wise Adagrad (TT-Rec's rule for cores);
* ids, dense features, labels and weights are synthetic.

``model`` (a dict of tensors): ``"tt"`` the group's cores, ``"plain"``
one ``[rows, D]`` table per plain feature in feature order, ``"bottom"``
and ``"top"`` lists of ``(w [fan_in, fan_out], b)``, ``"cross"`` a list of
``(v [N, k], w [k, N], b [N])``. ``spec`` (a dict): ``"pooling"`` per
feature, ``"tt_features"``, and the TT shape ``"p"``, ``"q"``, ``"ranks"``
(full, ``[1, .., 1]``). A batch is ``(dense [B, 13], sparse, labels [B],
weights)``: one ``[B, L_f]`` id tensor per feature, weights None or one
``[B, L_f]`` tensor per feature.

``stage``: the precision the products are staged in, for the control:
every input of every product (the TT chain's and the tower's), each TT
row and the cotangents coming back rounded to it (``"fp8"``: e4m3 with a
per-tensor scale; ``"bf16"``), products accumulated in float32. None:
float32. The TT lookups run ``block`` at a time, the backward recomputing
each block's rows, so that the card holds the reference at full size.

The benchmark holds a copy of this file, byte for byte:
``h100_bench/reference/dlrm_dcnv2_plain.py``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

BLOCK = 1 << 16   # TT lookups a block


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(x: torch.Tensor, stage: Optional[str]) -> torch.Tensor:
    if stage is None:
        return x
    if stage == "fp8":
        scale = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    if stage == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown stage {stage!r}")


class _Stage(torch.autograd.Function):
    """Round on the way forward and the cotangent on the way back."""

    @staticmethod
    def forward(ctx, x, stage):
        ctx.stage = stage
        return round_to(x, stage)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.stage), None


def _st(x, stage):
    return x if stage is None else _Stage.apply(x, stage)


def _mm(a, b, stage):
    return _st(a, stage) @ _st(b, stage)


def tt_rows(cores, table: int, p, q, r, ids, stage=None) -> torch.Tensor:
    """Rows ``[n, D]`` of table ``table`` of the TT group for ``ids``."""
    idx, parts, stride = ids.to(torch.int64), [], 1
    for pt in reversed(p):
        parts.insert(0, (idx // stride) % pt)
        stride *= pt
    n = idx.shape[0]
    z = _st(cores[0][table][parts[0]].reshape(n, q[0], r[1]), stage)
    for t in range(1, len(p)):
        g = _st(cores[t][table][parts[t]].reshape(n, r[t], q[t] * r[t + 1]),
                stage)
        z = torch.bmm(z, g).reshape(n, -1, r[t + 1])
        if t < len(p) - 1:
            z = _st(z, stage)
    return _st(z.reshape(n, -1), stage)


def _tt_pooled(cores, k, spec, ids, weights, stage, block):
    """Table ``k``'s bags ``[B, D]`` from ``ids [B, L]``, ``block`` lookups
    at a time (differentiable with respect to ``cores``)."""
    b, length = ids.shape
    flat = ids.reshape(-1)
    w = None if weights is None else weights.reshape(-1).float()
    bag = torch.arange(b, device=ids.device).repeat_interleave(length)
    out = None
    for s in range(0, flat.shape[0], block):
        rows = tt_rows(cores, k, spec["p"], spec["q"], spec["ranks"],
                       flat[s:s + block], stage)
        if w is not None:
            rows = rows * w[s:s + block, None]
        add = torch.zeros((b, rows.shape[1]), device=rows.device).index_add(
            0, bag[s:s + block], rows)
        out = add if out is None else out + add
    return out


def _mlp(layers, x, stage, last_relu):
    for i, (w, b) in enumerate(layers):
        x = _mm(x, w, stage) + b
        if last_relu or i < len(layers) - 1:
            x = torch.relu(x)
    return x


def tower(model, dense, feats, stage=None) -> torch.Tensor:
    """Logits ``[B]`` of the dense tower over the pooled rows ``feats`` (one
    ``[B, D]`` per feature, in feature order)."""
    x0 = torch.cat([_mlp(model["bottom"], dense, stage, True)] + list(feats),
                   1)
    x = x0
    for v, w, b in model["cross"]:
        x = x0 * (_mm(_mm(x, v, stage), w, stage) + b) + x
    return _mlp(model["top"], x, stage, False)[:, 0]


def _plain_pooled(table, ids, weights):
    rows = table[ids.to(torch.int64)]
    if weights is not None:
        rows = rows * weights[..., None].float()
    return rows.sum(1)


def _pooled(model, spec, sparse, weights, stage, block):
    """Every feature's bags, in feature order (the TT ones without
    gradient)."""
    plain = iter(model["plain"])
    out = []
    for f, ids in enumerate(sparse):
        w = None if weights is None else weights[f]
        if f in spec["tt_features"]:
            with torch.no_grad():
                out.append(_tt_pooled(model["tt"], spec["tt_features"].index(
                    f), spec, ids, w, stage, block))
        else:
            out.append(_plain_pooled(next(plain), ids, w))
    return out


def forward(model, spec, batch, stage=None, block: int = BLOCK):
    """Logits ``[B]`` (no gradient)."""
    no_tf32()
    dense, sparse, _, weights = batch
    with torch.no_grad():
        return tower(model, dense, _pooled(model, spec, sparse, weights,
                                           stage, block), stage)


def grads(model, spec, batch, stage=None, block: int = BLOCK):
    """``(loss, logits, gradients)``: the gradients as ``model`` is laid
    out."""
    no_tf32()
    dense, sparse, labels, weights = batch
    live = {k: [t.detach().requires_grad_() for t in v]
            for k, v in (("tt", model["tt"]), ("plain", model["plain"]))}
    for k in ("bottom", "cross", "top"):
        live[k] = [tuple(t.detach().requires_grad_() for t in layer)
                   for layer in model[k]]
    with torch.enable_grad():
        feats = _pooled(live, spec, sparse, weights, stage, block)
        tt_feats = [feats[f].requires_grad_() for f in spec["tt_features"]]
        logits = tower(live, dense, feats, stage)
        loss = F.binary_cross_entropy_with_logits(logits, labels.float())
        dense_leaves = live["plain"] + [t for k in ("bottom", "cross", "top")
                                        for layer in live[k] for t in layer]
        got = torch.autograd.grad(loss, dense_leaves + tt_feats)
    g_plain = list(got[:len(live["plain"])])
    g_tower = iter(got[len(live["plain"]):len(dense_leaves)])
    d_tt = got[len(dense_leaves):]
    g_tt = [torch.zeros_like(c) for c in model["tt"]]
    for k, f in enumerate(spec["tt_features"]):
        ids = sparse[f]
        w = None if weights is None else weights[f]
        nb = max(block // max(ids.shape[1], 1), 1)   # bags a block
        for s in range(0, ids.shape[0], nb):
            cores = [c.detach().requires_grad_() for c in model["tt"]]
            with torch.enable_grad():
                out = _tt_pooled(cores, k, spec, ids[s:s + nb],
                                 None if w is None else w[s:s + nb], stage,
                                 block)
                for acc, g in zip(g_tt, torch.autograd.grad(
                        out, cores, d_tt[k][s:s + nb])):
                    acc += g
    out = {"tt": g_tt, "plain": g_plain}
    for k in ("bottom", "cross", "top"):
        out[k] = [tuple(next(g_tower) for _ in layer) for layer in model[k]]
    return loss.detach(), logits.detach(), out


def leaves(tree) -> list:
    """A model's (or its gradients' or state's) tensors in a fixed order:
    the cores, the plain tables, then the bottom MLP, the cross network and
    the top MLP layer by layer."""
    return list(tree["tt"]) + list(tree["plain"]) + [
        t for k in ("bottom", "cross", "top") for layer in tree[k]
        for t in layer]


def init_state(model) -> dict:
    """Adagrad's zero state: per element, and per row for the plain
    tables."""
    return {"tt": [torch.zeros_like(c) for c in model["tt"]],
            "plain": [t.new_zeros(t.shape[0]) for t in model["plain"]],
            **{k: [tuple(torch.zeros_like(t) for t in layer)
                   for layer in model[k]]
               for k in ("bottom", "cross", "top")}}


def update(model, state, g, lr: float, eps: float,
           optimizer: str = "adagrad") -> None:
    """One optimizer step, in place."""
    with torch.no_grad():
        n_tt, n_plain = len(model["tt"]), len(model["plain"])
        for i, (w, s, gi) in enumerate(zip(leaves(model), leaves(state),
                                           leaves(g))):
            if optimizer == "sgd":
                w -= lr * gi
            elif n_tt <= i < n_tt + n_plain:
                s += torch.mean(gi * gi, 1)
                w -= lr * gi / (s.sqrt() + eps)[:, None]
            else:
                s += gi * gi
                w -= lr * gi / (s.sqrt() + eps)


def steps(model, spec, batches: Sequence, lr: float, eps: float = 1e-8,
          optimizer: str = "adagrad", stage=None, block: int = BLOCK,
          on_step: Optional[Callable] = None):
    """Train ``model`` in place on ``batches`` in turn: ``(losses, logits,
    state)``, one loss and one ``[B]`` of logits per step, and the
    optimizer's state after the last. ``on_step(k, model, state)`` after
    step ``k`` (from 1)."""
    state = init_state(model)
    losses, logits = [], []
    for k, batch in enumerate(batches, 1):
        loss, out, g = grads(model, spec, batch, stage, block)
        update(model, state, g, lr, eps, optimizer)
        losses.append(loss)
        logits.append(out)
        if on_step is not None:
            on_step(k, model, state)
    return losses, logits, state
