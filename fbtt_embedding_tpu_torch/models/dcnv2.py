"""MLPerf DLRM-DCNv2 over TT-compressed and plain embedding tables.

The model of MLPerf Training's ``recommendation_v2`` (TorchRec's DLRM with
``--interaction_type dcn``): ``F`` multi-hot sparse features, each summed
over its bag from a table of its own, and a dense tower: the bottom MLP,
the concatenation of its output and the ``F`` pooled rows (bottom output
first, then the features in order), a low-rank cross network (TorchRec's
``LowRankCrossNet``: ``x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l``) and the
top MLP, trained on the mean BCE of its logits.

The features named in ``tt_features`` share one TT shape and form one TT
group ``[T_tt, p_t, r_t*q_t*r_{t+1}]``, looked up by one
:func:`~fbtt_embedding_tpu_torch.ops.lookup.pooled_tt_lookup` call (on the
card the flat pipeline's kernels, differentiated by ``FlatLookup``), each
table with its own bag size (:func:`~fbtt_embedding_tpu_torch.ops.indexing.
multi_hot_positions`). The other features are plain tables, exact, held in
one buffer (table ``k`` at rows ``plain_offsets[k]`` onward) and pooled by
``torch.nn.functional.embedding_bag``.

Precision: float32 parameters and optimizer state. On the card the TT
lookup stages in bfloat16 and the tower's products run under
``torch.autocast(bfloat16)``; ``precision="highest"`` keeps both in
float32, as on the CPU.

Optimizers: ``"adagrad"`` (TorchRec's DLRM-DCNv2 training): element-wise
Adagrad on the TT cores (TT-Rec's rule, ``ops.fused_optim.adagrad_step``)
and on the tower (``torch.optim.Adagrad``'s update), exact row-wise Adagrad
on the plain tables (TorchRec's fused embedding optimizer: ``s_row +=
mean(g_row^2)``, ``w_row -= lr * g_row / (sqrt(s_row) + eps)``, on the rows
a batch touches); ``"sgd"``: ``w -= lr * g`` on every leaf.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fbtt_embedding_tpu_torch.models.dlrm import (
    MLPParams,
    _mlp_apply,
    bce_loss,
)
from fbtt_embedding_tpu_torch.ops.fused_optim import adagrad_step, sgd_step
from fbtt_embedding_tpu_torch.ops.indexing import multi_hot_positions
from fbtt_embedding_tpu_torch.ops.kernels.bag_pool import bag_pool
from fbtt_embedding_tpu_torch.ops.lookup import pooled_tt_lookup, staging_dtype
from fbtt_embedding_tpu_torch.parallel import collectives
from fbtt_embedding_tpu_torch.utils import profiling
from fbtt_embedding_tpu_torch.utils._tree import leaves_with_paths, map_leaves
from fbtt_embedding_tpu_torch.utils.init import init_tt_cores

OPTIMIZERS = ("adagrad", "sgd")


class DCNv2Config:
    """Static configuration. ``num_embeddings`` and ``pooling`` give each
    sparse feature's rows and multi-hot size, in feature order;
    ``tt_features`` the features held in TT form, every one with the TT
    shape ``tt_p_shapes`` / ``tt_q_shapes`` / ``tt_ranks`` (``prod(p)`` at
    least its rows); the others are plain tables."""

    def __init__(
        self,
        num_embeddings: Sequence[int],
        pooling: Sequence[int],
        tt_features: Sequence[int],
        tt_p_shapes: Sequence[int],
        tt_q_shapes: Sequence[int],
        tt_ranks: Sequence[int],
        embedding_dim: int = 128,
        dense_dim: int = 13,
        bottom_mlp_dims: Sequence[int] = (512, 256, 128),
        top_mlp_dims: Sequence[int] = (1024, 1024, 512, 256, 1),
        dcn_num_layers: int = 3,
        dcn_low_rank_dim: int = 512,
    ):
        nf = len(num_embeddings)
        tt = sorted(set(int(f) for f in tt_features))
        if len(pooling) != nf or not tt or tt[0] < 0 or tt[-1] >= nf \
                or len(tt) == nf:
            raise ValueError(
                f"{nf} features with pooling {list(pooling)}: tt_features "
                f"{list(tt_features)} must name some, not all, of them")
        if int(np.prod(tt_q_shapes)) != embedding_dim:
            raise ValueError(f"prod(tt_q_shapes) {list(tt_q_shapes)} != "
                             f"embedding_dim {embedding_dim}")
        e_tt = int(np.prod(tt_p_shapes))
        if any(num_embeddings[f] > e_tt for f in tt):
            raise ValueError(f"a TT feature has more rows than prod(p) "
                             f"{e_tt}")
        if bottom_mlp_dims[-1] != embedding_dim or top_mlp_dims[-1] != 1:
            raise ValueError("the bottom MLP must end at embedding_dim and "
                             "the top MLP at one logit")
        self.num_embeddings = [int(n) for n in num_embeddings]
        self.pooling = [int(n) for n in pooling]
        self.tt_features = tuple(tt)
        self.plain_features = tuple(f for f in range(nf) if f not in tt)
        self.tt_p_shapes = list(tt_p_shapes)
        self.tt_q_shapes = list(tt_q_shapes)
        self.tt_ranks = (
            [1] + list(tt_ranks) + [1]
            if len(tt_ranks) == len(tt_p_shapes) - 1 else list(tt_ranks))
        self.embedding_dim = embedding_dim
        self.dense_dim = dense_dim
        self.bottom_mlp_dims = list(bottom_mlp_dims)
        self.top_mlp_dims = list(top_mlp_dims)
        self.dcn_num_layers = dcn_num_layers
        self.dcn_low_rank_dim = dcn_low_rank_dim

    @property
    def num_features(self) -> int:
        return len(self.num_embeddings)

    @property
    def interaction_dim(self) -> int:
        """The cross network's width: the bottom output and every pooled
        row, concatenated."""
        return (self.num_features + 1) * self.embedding_dim

    @property
    def plain_offsets(self) -> list:
        """First row of each plain table in the plain buffer, then its
        total rows."""
        rows = [self.num_embeddings[f] for f in self.plain_features]
        return [0] + np.cumsum(rows).tolist()

    def lookups(self, features=None) -> int:
        """Lookups a sample makes (of ``features``; all by default)."""
        fs = range(self.num_features) if features is None else features
        return sum(self.pooling[f] for f in fs)


@dataclass
class CrossParams:
    """The low-rank cross network: per layer ``v [N, rank]``, ``w [rank,
    N]`` and ``b [N]`` (``x @ v @ w + b``), ``N`` the interaction width."""

    v: Tuple[torch.Tensor, ...]
    w: Tuple[torch.Tensor, ...]
    b: Tuple[torch.Tensor, ...]


@dataclass
class DCNv2Params:
    """Every leaf float32: the TT group's cores (module layout ``[T_tt,
    p_t, r_t*q_t*r_{t+1}]``), the plain tables in one buffer ``[rows,
    D]``, the MLPs (weights ``[fan_in, fan_out]``) and the cross network;
    ``optimizer_state`` one tensor per trainable leaf in
    :func:`trainable_leaves` order (the plain tables' a row state
    ``[rows]``), empty for SGD."""

    tt_cores: Tuple[torch.Tensor, ...]
    plain: torch.Tensor
    bottom_mlp: MLPParams
    cross: CrossParams
    top_mlp: MLPParams
    optimizer_state: Tuple[torch.Tensor, ...] = ()


class DCNv2Batch(NamedTuple):
    """One batch: ``dense [B, dense_dim]``, ``sparse`` one ``[B, L_f]``
    int tensor of row ids per feature, ``labels [B]`` (0 or 1) and,
    optionally, ``weights``: one ``[B, L_f]`` float tensor per feature
    scaling each lookup (TorchRec's weighted features)."""

    dense: torch.Tensor
    sparse: Tuple[torch.Tensor, ...]
    labels: torch.Tensor
    weights: Optional[Tuple[torch.Tensor, ...]] = None


def _tower(params: DCNv2Params):
    return (params.bottom_mlp, params.cross, params.top_mlp)


def trainable_leaves(params: DCNv2Params) -> list:
    """The trainable tensors: the cores, the plain buffer, then the tower's
    leaves (bottom MLP, cross network, top MLP)."""
    return (list(params.tt_cores) + [params.plain]
            + [t for _, t in leaves_with_paths(_tower(params))])


def init_optimizer_state(params: DCNv2Params, optimizer: str = "adagrad"):
    """Zero optimizer state for ``params`` (``()`` for SGD)."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer {optimizer!r} is not one of "
                         f"{OPTIMIZERS}")
    if optimizer == "sgd":
        return ()
    return tuple(
        t.new_zeros(t.shape[:1]) if t is params.plain else torch.zeros_like(t)
        for t in trainable_leaves(params))


def _uniform(gen, shape, bound, device):
    return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound


def _init_linear(gen, dims, device) -> MLPParams:
    """``nn.Linear``'s default: weight and bias uniform on +-1/sqrt(fan_in)."""
    ws, bs = [], []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(fan_in)
        ws.append(_uniform(gen, (fan_in, fan_out), bound, device))
        bs.append(_uniform(gen, (fan_out,), bound, device))
    return MLPParams(tuple(ws), tuple(bs))


def init_dcnv2_params(cfg: DCNv2Config, seed: int = 0, device="cuda",
                      optimizer: str = "adagrad",
                      tt_cores: Optional[Sequence[torch.Tensor]] = None
                      ) -> DCNv2Params:
    """Random parameters and zero optimizer state. The TT cores are
    ``tt_cores`` where given, else TT-Rec's uniform cores
    (``utils.init.init_tt_cores``, ``np.random.default_rng(seed)``); the
    rest is drawn on ``device`` from a ``torch.Generator`` seeded with
    ``seed``: plain tables uniform on +-sqrt(1/rows) (TorchRec's default),
    the MLPs as ``nn.Linear``, the cross network as TorchRec's
    ``LowRankCrossNet`` (Xavier-normal kernels, zero bias)."""
    dev = torch.device(device)
    if tt_cores is None:
        rng = np.random.default_rng(seed)
        tt_cores = [torch.tensor(c, device=dev) for c in init_tt_cores(
            rng, "uniform", len(cfg.tt_features), int(np.prod(
                cfg.tt_p_shapes)), cfg.embedding_dim, cfg.tt_p_shapes,
            cfg.tt_q_shapes, cfg.tt_ranks)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2 ** 63)
    offs = cfg.plain_offsets
    plain = torch.cat([_uniform(gen, (b - a, cfg.embedding_dim),
                                np.sqrt(1.0 / (b - a)), dev)
                       for a, b in zip(offs[:-1], offs[1:])])
    bottom = _init_linear(gen, [cfg.dense_dim] + cfg.bottom_mlp_dims, dev)
    n, k = cfg.interaction_dim, cfg.dcn_low_rank_dim
    std = np.sqrt(2.0 / (n + k))
    layers = range(cfg.dcn_num_layers)
    cross = CrossParams(
        tuple(torch.randn((n, k), generator=gen, device=dev) * std
              for _ in layers),
        tuple(torch.randn((k, n), generator=gen, device=dev) * std
              for _ in layers),
        tuple(torch.zeros(n, device=dev) for _ in layers))
    top = _init_linear(gen, [n] + cfg.top_mlp_dims, dev)
    params = DCNv2Params(tuple(c.float() for c in tt_cores), plain, bottom,
                         cross, top)
    params.optimizer_state = init_optimizer_state(params, optimizer)
    return params


class _Layout(NamedTuple):
    """What a batch size fixes: the TT group's ``rowidx`` / ``tableidx``
    (per-table bag sizes), the plain tables' ``embedding_bag`` offsets,
    each plain lookup's table base row and bag, and the order of the
    tower's input (0 the bottom output, then the TT group's and the plain
    tables' pooled rows by feature)."""

    tt_rowidx: torch.Tensor
    tt_tableidx: torch.Tensor
    plain_offsets: torch.Tensor
    plain_base: torch.Tensor
    plain_bag: torch.Tensor
    order: Tuple[int, ...]


def _layout(cfg: DCNv2Config, batch_size: int, device) -> _Layout:
    tt_row, tt_tab = multi_hot_positions(
        batch_size, [cfg.pooling[f] for f in cfg.tt_features], device)
    pl_pool = [cfg.pooling[f] for f in cfg.plain_features]
    pl_row, pl_tab = multi_hot_positions(batch_size, pl_pool, device)
    lengths = torch.tensor(pl_pool, device=device).repeat_interleave(
        batch_size)
    offsets = torch.cat([lengths.new_zeros(1), torch.cumsum(lengths, 0)])
    base = torch.tensor(cfg.plain_offsets[:-1], device=device)[pl_tab.long()]
    slot = {f: 1 + i for i, f in enumerate(cfg.tt_features)}
    slot.update({f: 1 + len(cfg.tt_features) + i
                 for i, f in enumerate(cfg.plain_features)})
    return _Layout(tt_row, tt_tab, offsets, base,
                   pl_tab * batch_size + pl_row,
                   (0,) + tuple(slot[f] for f in range(cfg.num_features)))


def _cat(parts, features, device, dtype=None):
    return torch.cat([torch.as_tensor(parts[f], device=device, dtype=dtype)
                      .reshape(-1) for f in features])


def _lookups(params: DCNv2Params, cfg: DCNv2Config, lay: _Layout,
             batch: DCNv2Batch, batch_size: int, device, precision, impl):
    """The pooled rows: the TT group's ``[T_tt, B, D]`` (differentiable
    with respect to the cores given), the plain tables' ``[T_plain * B,
    D]``, and the plain lookups' global rows and weights (for the
    update)."""
    f32 = torch.float32
    w = batch.weights
    tt = pooled_tt_lookup(
        params.tt_cores, cfg.tt_p_shapes, cfg.tt_q_shapes, cfg.tt_ranks,
        batch_size, _cat(batch.sparse, cfg.tt_features, device),
        lay.tt_rowidx, lay.tt_tableidx,
        weights=None if w is None else _cat(w, cfg.tt_features, device, f32),
        precision=precision, impl=impl)
    with profiling.annotate("fbtt.tables"):
        ids = _cat(batch.sparse, cfg.plain_features, device,
                   torch.int64) + lay.plain_base
        pw = None if w is None else _cat(w, cfg.plain_features, device, f32)
        plain = F.embedding_bag(ids, params.plain.detach(), lay.plain_offsets,
                                mode="sum", per_sample_weights=pw,
                                include_last_offset=True)
    return tt, plain, ids, pw


def _tower_logits(tower, cfg: DCNv2Config, dense, tt, plain, lay: _Layout,
                  bf16: bool) -> torch.Tensor:
    """Logits ``[B]`` float32 of the dense tower over the pooled rows, its
    products in bfloat16 under autocast where ``bf16``."""
    bottom_mlp, cross, top_mlp = tower
    b = dense.shape[0]
    with torch.autocast(dense.device.type, dtype=torch.bfloat16,
                        enabled=bf16):
        parts = [_mlp_apply(bottom_mlp, dense, final_activation=True)
                 .float()]
        parts += list(tt.unbind(0)) + list(
            plain.reshape(-1, b, cfg.embedding_dim).unbind(0))
        x0 = torch.stack([parts[i] for i in lay.order], 1).reshape(b, -1)
        x = x0
        for v, w, bias in zip(cross.v, cross.w, cross.b):
            x = x0 * ((x @ v) @ w + bias) + x
        return _mlp_apply(top_mlp, x)[:, 0].float()


def _dense_batch(batch: DCNv2Batch, device):
    return (torch.as_tensor(batch.dense, dtype=torch.float32, device=device),
            torch.as_tensor(batch.labels, dtype=torch.float32, device=device))


def dcnv2_forward(params: DCNv2Params, cfg: DCNv2Config, batch: DCNv2Batch,
                  precision: Optional[str] = None,
                  impl: str = "auto") -> torch.Tensor:
    """Logits ``[B]`` float32 (no gradient)."""
    dev = params.plain.device
    dense, _ = _dense_batch(batch, dev)
    b = dense.shape[0]
    lay = _layout(cfg, b, dev)
    with torch.no_grad():
        tt, plain, _, _ = _lookups(params, cfg, lay, batch, b, dev,
                                   precision, impl)
        return _tower_logits(_tower(params), cfg, dense, tt, plain, lay,
                             staging_dtype(dev, precision) == torch.bfloat16)


def _adagrad(leaves, state, grads, lr, eps) -> None:
    """``torch.optim.Adagrad``'s update (no decay), in place."""
    torch._foreach_addcmul_(state, grads, grads)
    std = torch._foreach_sqrt(state)
    torch._foreach_add_(std, eps)
    torch._foreach_addcdiv_(leaves, grads, std, value=-lr)


def _sum_by_row(ids, d_pooled, bag, weights, tb: int):
    """Each row's lookups summed: the lookups sorted by row, one
    ``bag_pool`` over each run of a row's lookups (bitwise repeatable, no
    host synchronisation). ``(rows sorted, each one's run, sums [tb, D])``:
    the runs' sums first, zeros past them (``tb`` at least the runs).
    ``bag`` maps a lookup to its row of ``d_pooled`` (None: its own)."""
    n = ids.shape[0]
    rows, order = torch.sort(ids, stable=True)
    start = torch.ones(n, dtype=torch.bool, device=ids.device)
    start[1:] = rows[1:] != rows[:-1]
    run = torch.cumsum(start, 0, dtype=torch.int32) - 1
    g = bag_pool(run, tb, rows=d_pooled,
                 slot=order if bag is None else bag[order],
                 weights=None if weights is None else weights[order])
    return rows, run, g


def _rowwise_update(weight, state, rows, g, optimizer, lr, eps) -> None:
    """The plain tables' update of the rows ``rows`` by their gradients
    ``g [len(rows), D]``, in place: a row may come more than once, each
    time with the same gradient, so that every write of a row is the same
    value and the scatter's order does not matter."""
    if optimizer == "sgd":
        weight.index_put_((rows,), weight[rows] - lr * g)
        return
    s = state[rows] + torch.mean(g * g, 1)
    state.index_put_((rows,), s)
    step = lr * g / (s.sqrt() + eps)[:, None]
    weight.index_put_((rows,), weight[rows] - step)


def _update_plain(weight, state, ids, weights, d_pooled, bag, optimizer, lr,
                  eps) -> None:
    """The plain tables' update from their pooled rows' cotangents
    ``d_pooled [T_plain * B, D]``, in place, on the rows ``ids`` touch:
    each row's lookups summed (:func:`_sum_by_row`), then every lookup
    writes its row's new value."""
    rows, run, g = _sum_by_row(ids, d_pooled, bag, weights, ids.shape[0])
    _rowwise_update(weight, state, rows, g[run.long()], optimizer, lr, eps)


class _Exchange(NamedTuple):
    """How a data-parallel step sums the plain tables' gradients over its
    process group, fixed by the batch size and the group's size. A table
    whose dense gradient costs an all-reduce no more bytes than gathering
    its rows costs (``2 rows <= world * bound``, ``bound = min(rows,
    lookups a rank makes)``) is summed dense: ``dense_lookups`` (its
    lookups, in the plain lookups' order) into ``dense_rows`` (the plain
    buffer's rows of the dense gradient), lookup ``i``'s row of it ``ids[i]
    + dense_shift[i]``. The others exchange rows: each rank sums its own
    lookups of them (``rows_lookups``) row by row into ``bound`` slots (the
    sum of their bounds) and gathers every rank's slots. A slot that no
    row fills holds a zero gradient of its row in ``slot_rows`` (slot
    ``j`` of table ``k``'s range, table ``k``'s row ``j``): a zero adds
    nothing and leaves an untouched row's update the identity, and the
    slots' rows differ, so no row gathers a long run of them."""

    dense_lookups: torch.Tensor
    dense_shift: torch.Tensor
    dense_slot: torch.Tensor
    dense_rows: torch.Tensor
    rows_lookups: torch.Tensor
    rows_slot: torch.Tensor
    slot_rows: torch.Tensor

    @property
    def bound(self) -> int:
        return self.slot_rows.shape[0]


def _exchange(cfg: DCNv2Config, lay: _Layout, batch_size: int, world: int,
              device) -> _Exchange:
    offs = cfg.plain_offsets
    dense, shift, dense_rows, rows, slot_rows = [], [], [], [], []
    start = r_dense = 0
    for k, f in enumerate(cfg.plain_features):
        n_rows, n = offs[k + 1] - offs[k], batch_size * cfg.pooling[f]
        sel = torch.arange(start, start + n, device=device)
        start += n
        bound = min(n_rows, n)
        if 2 * n_rows <= world * bound:
            dense.append(sel)
            shift.append(torch.full((n,), r_dense - offs[k], device=device))
            dense_rows.append(torch.arange(offs[k], offs[k + 1],
                                           device=device))
            r_dense += n_rows
        else:
            rows.append(sel)
            slot_rows.append(torch.arange(offs[k], offs[k] + bound,
                                          device=device))

    def cat(parts):
        return (torch.cat(parts) if parts
                else torch.zeros(0, dtype=torch.int64, device=device))

    dense_lookups, rows_lookups = cat(dense), cat(rows)
    return _Exchange(dense_lookups, cat(shift), lay.plain_bag[dense_lookups],
                     cat(dense_rows), rows_lookups,
                     lay.plain_bag[rows_lookups], cat(slot_rows))


def _plain_sums(xch: _Exchange, ids, weights, d_pooled):
    """This rank's plain-table gradients as a data-parallel step sums
    them: the dense tables' ``[len(xch.dense_rows), D]``, and the
    exchanged tables' row sums in ``xch.bound`` slots with their rows
    (``(rows [bound], sums [bound, D])``; None where no table exchanges
    rows)."""
    sel = xch.dense_lookups
    g_dense = d_pooled.new_zeros((0, d_pooled.shape[1]))
    if sel.shape[0]:   # sorted by row: bag_pool's fast route
        rows, order = torch.sort(ids[sel] + xch.dense_shift, stable=True)
        g_dense = bag_pool(
            rows, xch.dense_rows.shape[0], rows=d_pooled,
            slot=xch.dense_slot[order],
            weights=None if weights is None else weights[sel][order])
    if not xch.bound:
        return g_dense, None
    sel = xch.rows_lookups
    rows, run, g = _sum_by_row(
        ids[sel], d_pooled, xch.rows_slot,
        None if weights is None else weights[sel], xch.bound)
    return g_dense, (xch.slot_rows.scatter(0, run.long(), rows), g)


def make_dcnv2_train_step(cfg: DCNv2Config, batch_size: int,
                          optimizer: str = "adagrad",
                          learning_rate: float = 0.005, eps: float = 1e-8,
                          device="cuda", impl: str = "auto",
                          precision: Optional[str] = None, group=None):
    """Train step ``step(params, batch) -> (loss, logits, params)``.

    The mean BCE of the tower's logits; the tower's gradients and the
    pooled rows' cotangents by autograd, the cores' through the TT
    lookup's backward (``FlatLookup`` on the card), the plain tables' from
    their cotangents; then ``optimizer`` (see the module docstring) on
    every leaf, **in place**: ``params`` (and its optimizer state) is
    returned updated. ``loss`` (0-d) and ``logits`` (``[B]``) are device
    tensors: the step never synchronises with the host.

    ``group``: a ``torch.distributed`` process group (the world's:
    ``torch.distributed.group.WORLD``) over which the step is data
    parallel. ``batch_size`` and ``batch`` are then this rank's block of a
    global batch ``world`` times as large, every rank holding the same
    ``params``, and the step is one step on the global batch: each rank's
    gradients are scaled by ``1 / world`` (the loss is the global batch's
    mean) and summed over the group before the same update on every rank,
    which leaves the replicas equal. The cores', the tower's and the
    smaller plain tables' (:class:`_Exchange`) in one ``all_reduce``; the
    other plain tables' row by row, since row-wise Adagrad is not linear in
    the gradient: each rank sums its lookups of a row, the ranks' row sums
    are gathered, padded to a fixed count so that nothing waits on the
    host, and summed again. ``loss`` and ``logits`` stay this rank's.

    Spans (while a profiler records): ``fbtt.step`` the root, with the
    counters ``lookups`` (every feature's) and ``tt_lookups`` (the TT
    group's); ``fbtt.tables`` the plain tables' pool and update;
    ``fbtt.dense`` the tower's forward and backward; ``fbtt.optim`` the
    cores' and the tower's update; ``fbtt.comm`` each collective, with the
    counters ``comm.all_reduce_bytes`` and ``comm.all_gather_bytes``
    (``parallel.collectives``); the TT lookup's own ``fbtt.plan``,
    ``fbtt.fwd``, ``fbtt.pool`` and ``fbtt.bwd``."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer {optimizer!r} is not one of "
                         f"{OPTIMIZERS}")
    dev = torch.device(device)
    lay = _layout(cfg, batch_size, dev)
    bf16 = staging_dtype(dev, precision) == torch.bfloat16
    lr, eps = float(learning_rate), float(eps)
    n_all, n_tt = (batch_size * cfg.lookups(),
                   batch_size * cfg.lookups(cfg.tt_features))
    n_cores = len(cfg.tt_p_shapes)
    if group is not None:
        world = torch.distributed.get_world_size(group)
        xch = _exchange(cfg, lay, batch_size, world, dev)

    @profiling.annotated("fbtt.step")
    def step(params: DCNv2Params, batch: DCNv2Batch):
        if profiling.enabled():
            profiling.count("lookups", n_all)
            profiling.count("tt_lookups", n_tt)
        dense, labels = _dense_batch(batch, dev)
        cores = tuple(c.detach().requires_grad_() for c in params.tt_cores)
        with torch.enable_grad():
            tt, plain, ids, pw = _lookups(
                DCNv2Params(cores, params.plain, *_tower(params)), cfg, lay,
                batch, batch_size, dev, precision, impl)
        with profiling.annotate("fbtt.dense"):
            tower = map_leaves(lambda t: t.detach().requires_grad_(),
                               _tower(params))
            x_tt = tt.detach().requires_grad_()
            x_plain = plain.requires_grad_()
            live = [t for _, t in leaves_with_paths(tower)]
            with torch.enable_grad():
                logits = _tower_logits(tower, cfg, dense, x_tt, x_plain, lay,
                                       bf16)
                loss = bce_loss(logits, labels)
                *g_tower, d_tt, d_plain = torch.autograd.grad(
                    loss if group is None else loss / world,
                    live + [x_tt, x_plain])
        g_cores = torch.autograd.grad(tt, cores, d_tt)
        state = params.optimizer_state
        s_plain = state[n_cores] if state else None
        with torch.no_grad():
            if group is None:
                with profiling.annotate("fbtt.tables"):
                    _update_plain(params.plain, s_plain, ids, pw, d_plain,
                                  lay.plain_bag, optimizer, lr, eps)
            else:
                with profiling.annotate("fbtt.tables"):
                    g_dense, slots = _plain_sums(xch, ids, pw, d_plain)
                summed = collectives.all_reduce_sum(
                    [*g_cores, *g_tower, g_dense], group)
                g_cores, g_tower = summed[:n_cores], summed[n_cores:-1]
                if slots is not None:
                    slots = [collectives.all_gather_cat(t, group)
                             for t in slots]
                with profiling.annotate("fbtt.tables"):
                    _rowwise_update(params.plain, s_plain, xch.dense_rows,
                                    summed[-1], optimizer, lr, eps)
                    if slots is not None:
                        _update_plain(params.plain, s_plain, slots[0], None,
                                      slots[1], None, optimizer, lr, eps)
            with profiling.annotate("fbtt.optim"):
                leaves = [t for _, t in leaves_with_paths(_tower(params))]
                if optimizer == "sgd":
                    sgd_step(params.tt_cores, g_cores, lr)
                    torch._foreach_add_(leaves, g_tower, alpha=-lr)
                else:
                    adagrad_step(params.tt_cores, state[:n_cores], g_cores,
                                 lr, eps)
                    _adagrad(leaves, list(state[n_cores + 1:]), g_tower, lr,
                             eps)
        return loss.detach(), logits.detach(), params

    return step
