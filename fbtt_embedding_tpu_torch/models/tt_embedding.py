"""TT-compressed embedding serving and training, in PyTorch.

Counterpart of the functional entries of ``fbtt_embedding_tpu.models.
tt_embedding``: ``make_serving_fn`` builds a forward-only pooled lookup and
``make_fused_train_step`` the one-call training step (forward, backward
and the fused update: the reference's SGD / Adagrad, or with
``optim_semantics="native"`` each optimizer's own math) over parameters
held in
:class:`TTEmbeddingParams`. Both take the flat sorted-run pipeline by
default and the generic per-lookup kernels (B4 forward, B5 backward) with
``impl="pallas"``. With a :class:`~fbtt_embedding_tpu_torch.ops.cache.
CacheState` in the params, the step counts row frequencies (``use_cache``)
and both entries probe the LFU cache (``probe_cache``): cache hits are
served from the decompressed rows and reach the TT kernels only as dead
lookups. The modules :class:`TableBatchedTTEmbeddingBag` and
:class:`TTEmbeddingBag` (``torch.nn.Module``) run the same lookups and
updates through the stateful forward / ``backward(d_output)`` flow, and
:func:`tt_embedding_forward` is the plain differentiable forward.
:func:`make_folded_serving_fn` folds frozen cores into the serve's tables
once (the pair table on kernel B1; an int8 option), with
:func:`refold_cache`, the bucketed front-end
:func:`make_bucketed_serving_fn` and the modules' ``freeze_for_serving``.
Tables of 2^31 rows or more take wide key rows, and their cache the
wide-key (int64 row id) layout.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from enum import Enum, unique
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fbtt_embedding_tpu_torch.ops import cache as cache_ops
from fbtt_embedding_tpu_torch.ops.cache import CacheState
from fbtt_embedding_tpu_torch.ops.contraction import (
    tt_matrix_to_full,
    tt_rows,
    validate_tt_shapes,
)
from fbtt_embedding_tpu_torch.ops.fused_optim import (
    adagrad_step,
    native_optim_init,
    native_optim_step,
    sgd_step,
)
from fbtt_embedding_tpu_torch.ops.indexing import (
    decompose_indices64,
    rowidx_from_offsets,
    split_wide_keyrows,
    wide_keyrows,
)
from fbtt_embedding_tpu_torch.ops.kernels import tt_flat
from fbtt_embedding_tpu_torch.ops.kernels.bag_pool import CacheRows, bag_pool
from fbtt_embedding_tpu_torch.ops.kernels.tt_flat import flat_train_apply
from fbtt_embedding_tpu_torch.ops.lookup import (
    masked_weights,
    pad_cores_for_flat,
    pool_rows,
    pooled_tt_lookup,
    route,
    staging_dtype,
    tt_path_inputs,
    unpad_flat_output,
)
from fbtt_embedding_tpu_torch.utils import graphs as graphs_ops
from fbtt_embedding_tpu_torch.utils import knobs, profiling
from fbtt_embedding_tpu_torch.utils.decompose import tt_decompose
from fbtt_embedding_tpu_torch.utils.init import init_tt_cores
from fbtt_embedding_tpu_torch.utils.shapes import suggested_tt_shapes

logger = logging.getLogger(__name__)


@unique
class OptimType(Enum):
    """Optimizer names (reference ``tt_embeddings_ops.py:18-33``).

    Under the default ``optim_semantics="reference"`` only two behaviours
    exist, as in the reference: SGD/EXACT_SGD run the fused SGD update,
    everything else the fused full-element Adagrad. Under ``"native"`` each
    name runs its own update (``ops.fused_optim.native_optim_step``:
    row-wise Adagrad, Adam, LAMB, their partial row-wise forms, LARS), and
    SGD and EXACT_ADAGRAD the same updates as the reference's. All updates
    are deterministic, so SGD == EXACT_SGD."""

    SGD = "sgd"
    EXACT_SGD = "exact_sgd"
    LAMB = "lamb"
    ADAM = "adam"
    EXACT_ADAGRAD = "exact_adagrad"
    EXACT_ROWWISE_ADAGRAD = "exact_row_wise_adagrad"
    LARS_SGD = "lars_sgd"
    PARTIAL_ROWWISE_ADAM = "partial_row_wise_adam"
    PARTIAL_ROWWISE_LAMB = "partial_row_wise_lamb"

    def __str__(self) -> str:
        return self.value


_SGD_OPTIMS = (OptimType.SGD, OptimType.EXACT_SGD)
# above this many lookups the step differentiates the two-pass lookup
# instead of running flat_train_apply (the JAX package's crossover), unless
# FBTT_FUSED_APPLY says otherwise (_fused_apply_gate)
_FUSED_APPLY_NNZ_MAX = 32768


_CACHE_FIELDS = ("keys", "freq", "slots", "weight", "opt_state")


@dataclass
class TTEmbeddingParams:
    """TT cores in module layout ``[T, p_t, r_t*q_t*r_{t+1}]`` (float32),
    optimizer state, and the LFU cache (a ``CacheState``, or None)."""

    tt_cores: Tuple[torch.Tensor, ...]
    optimizer_state: Tuple[torch.Tensor, ...] = ()
    cache: Optional[CacheState] = None


def params_from_jax(tt_cores_np: Sequence, optimizer_state_np: Sequence = (),
                    device="cuda", cache: Any = None) -> TTEmbeddingParams:
    """Parameters of the JAX package, as numpy arrays in module layout
    (``np.asarray`` of its ``TTEmbeddingParams`` fields; tensors are taken
    too), -> this package's :class:`TTEmbeddingParams` on ``device``, every
    tensor a copy. ``cache``: the JAX ``CacheState``, or any object or
    mapping with its five fields (``keys``, ``freq``, ``slots``,
    ``weight``, ``opt_state``) as arrays, in any layout (direct, hashed or
    wide). Each tensor keeps its dtype: the native optimizers' 0-d int32
    step counter stays one."""
    def put(a):  # a copy: the params never alias the caller's arrays
        if isinstance(a, torch.Tensor):
            return a.detach().to(device, copy=True)
        return torch.tensor(np.asarray(a), device=device)

    cores = tuple(put(c).float() for c in tt_cores_np)
    cstate = None
    if cache is not None:
        get = cache.__getitem__ if isinstance(cache, dict) else \
            lambda f: getattr(cache, f)
        cstate = CacheState(*(put(get(f)) for f in _CACHE_FIELDS))
    return TTEmbeddingParams(cores, tuple(put(s) for s in optimizer_state_np),
                             cstate)


def params_from_state_dict(state: dict, tt_ndim: int, with_cache: bool,
                           device="cuda") -> TTEmbeddingParams:
    """A module state dict (the JAX module's or this package's: names
    ``tt_cores.{i}``, ``optimizer_state.{i}``, ``cache.keys|freq|slots|
    weight|opt_state``; numpy arrays or tensors) -> :class:`TTEmbedding
    Params` on ``device`` (copies), the cache's fields read where
    ``with_cache``.

    The optimizer state has as many entries as the dict holds, but at
    least one per core (the SGD family saves empty arrays): fewer means a
    truncated or renamed checkpoint and raises KeyError, as the JAX
    module's ``load_state_dict`` does."""
    cores = [state[f"tt_cores.{i}"] for i in range(tt_ndim)]
    opt_state = []
    while f"optimizer_state.{len(opt_state)}" in state:
        opt_state.append(state[f"optimizer_state.{len(opt_state)}"])
    if len(opt_state) < tt_ndim:
        raise KeyError(
            f"state dict has {len(opt_state)} optimizer_state.* entries; "
            f"expected at least {tt_ndim} (one per TT core, empty arrays "
            "for the SGD family)")
    cache = ({f: state[f"cache.{f}"] for f in _CACHE_FIELDS}
             if with_cache else None)
    return params_from_jax(cores, opt_state, device=device, cache=cache)


def _native_semantics(optim_semantics: str) -> bool:
    """Whether ``optim_semantics`` is "native"; a name other than
    "reference" or "native" raises ValueError."""
    if optim_semantics not in ("reference", "native"):
        raise ValueError(f"unknown optim_semantics {optim_semantics!r}")
    return optim_semantics == "native"


@profiling.annotated("fbtt.pool")
def _pool_cached_rows(cached_rows, rowidx, tableidx, num_tables, bs,
                      weights=None, cache: Optional[CacheRows] = None):
    """Pool cache-served rows into ``[T, B, D]`` by ``bag_pool``, in bag
    order: ``cached_rows``, one per lookup (already weighted), or
    ``cache``, the cache's rows read at each lookup's location and
    multiplied by its weight (``weights``, 1 where None) and scale."""
    seg = rowidx if tableidx is None else tableidx * bs + rowidx
    return bag_pool(seg, num_tables * bs, rows=cached_rows, weights=weights,
                    cache=cache).reshape(num_tables, bs, -1)


def _cached_pool(out, cache, locations, weights, rowidx, tbl, num_tables,
                 bs, scale=None):
    """``out`` plus the cache-served lookups' rows, pooled; ``scale``: the
    per-row scales of int8 rows (an int8 fold's cache), which join each
    lookup's weight in one float32 factor."""
    if locations is None:
        return out
    with profiling.annotate("fbtt.cache"):
        return out + _pool_cached_rows(
            None, rowidx, tbl, num_tables, bs, weights,
            cache=CacheRows(cache.weight, locations, scale))


def _count_lookups(nnz: int, locations=None, plan=None) -> None:
    """While spans are on (``profiling.enabled``), the counters
    ``lookups`` (``nnz``) and, where the call probed the cache
    (``locations``), ``cache_hits``: the probed lookups less those the TT
    path serves, read off the flat ``plan`` where the caller holds one (one
    device operation), else counted from ``locations``."""
    if not profiling.enabled():
        return
    profiling.count("lookups", nnz)
    if locations is not None:
        live = (tt_flat.live_lookups(plan) if plan is not None
                else (locations < 0).sum())
        profiling.count("cache_hits", nnz, less=live)


def _probe(cache: Optional[CacheState], keys):
    """Each lookup's cache row (-1: not cached) where there is a cache,
    else None."""
    if cache is None:
        return None
    with profiling.annotate("fbtt.cache"):
        return cache_ops.cache_lookup(cache, keys)


def make_serving_fn(
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    num_tables: int,
    batch_size: int,
    probe_cache: bool = True,
    precision: Optional[str] = None,
    impl: str = "auto",
    device="cuda",
):
    """Build the serving lookup ``serve(params, indices, offsets,
    weights=None, *, bs=batch_size) -> [T, B, D]`` (float32, on
    ``device``).

    ``indices`` is ``[nnz]`` row ids, or the wide key rows ``int32
    [nnz, 2 + ndim]`` (``ops.indexing.wide_keyrows``) for tables past
    int32; ``offsets`` has ``T*bs + 1`` table-major entries. Inputs may be
    numpy arrays or tensors; they are moved to ``device``, where the
    params must already be. Forward only: no counting, no backward state.
    ``impl`` as ``ops.lookup.route`` resolves it.

    ``probe_cache`` with a cache in the params: lookups the cache holds are
    served from its rows; on the flat pipeline they are dead lookups the
    kernels skip, on the other paths they get weight 0. Wide key rows
    probe a wide-key cache (``make_cache_state(..., wide_keys=ndim)``) by
    their ``(hi, lo)`` columns and feed their part columns to the lookup;
    flat ids against a wide cache, or wide rows against another, raise
    ValueError."""
    shapes = (tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(tt_ranks))
    ndim = len(tt_p_shapes)
    device = torch.device(device)

    @profiling.annotated("fbtt.serve")
    def serve(params: TTEmbeddingParams, indices, offsets, weights=None, *,
              bs: int = batch_size):
        cache = params.cache if probe_cache else None
        indices, parts, nnz, keys = _lookup_inputs(indices, ndim, device)
        offsets = torch.as_tensor(offsets, device=device)
        if weights is not None:
            weights = torch.as_tensor(weights, device=device,
                                      dtype=torch.float32)
        rowidx, tableidx = rowidx_from_offsets(offsets, nnz, num_tables, bs)
        tbl = tableidx if num_tables > 1 else None
        locations = _probe(cache, keys)
        _count_lookups(nnz, locations)
        # the JAX serve's skip rule: the generic serve packs nothing
        dead, w_p = None, weights
        if locations is not None:
            if route(*shapes, num_tables, bs, impl).kind == "flat":
                dead = locations >= 0
            else:
                w_p = masked_weights(locations < 0, weights)
        out = pooled_tt_lookup(
            params.tt_cores, *shapes, bs, indices, rowidx, tbl,
            weights=w_p, precision=precision, impl=impl, dead_mask=dead,
            idx_parts=parts)
        return _cached_pool(out, cache, locations, weights, rowidx, tbl,
                            num_tables, bs)

    return serve


@dataclass
class FoldedServingParams:
    """Frozen-weight serving state (:func:`make_folded_serving_fn`).

    Flat mode: ``setup`` holds the folded pass tables and the pair table
    (:func:`~fbtt_embedding_tpu_torch.ops.kernels.tt_flat.make_serving_fold`;
    no cores are carried) and ``cache`` a copy of the LFU cache's keys,
    slots and rows (its ``freq`` and ``opt_state`` empty). Fallback
    mode (``impl`` "pallas" or "xla", or a config the flat pipeline cannot
    serve): ``params`` carries a copy of the parameters and serving runs
    :func:`make_serving_fn`.

    An int8 fold keeps the pair table in ``setup`` as a ``(q8, scale)``
    pair and the cache's rows as int8 (``cache.weight``) with their
    per-row scales in ``cache_scale``. ``torch.save`` / ``torch.load(...,
    weights_only=False)`` round-trip it."""

    setup: Optional[Tuple] = None
    params: Optional[TTEmbeddingParams] = None
    cache: Optional[CacheState] = None
    cache_scale: Optional[torch.Tensor] = None


def _frozen_cache(cache: Optional[CacheState], quantized: bool):
    """``(cache, cache_scale)``: a copy of what a serve reads of ``cache``
    (keys, slots and rows; the counts and the optimizer state are left
    empty), so that training or populating it later leaves the fold as it
    was; the rows as int8 with their scales where ``quantized``."""
    if cache is None:
        return None, None
    scale = None
    if quantized:
        weight, scale = tt_flat.quantize_rows_int8(cache.weight)
    else:
        weight = cache.weight.clone()
    empty = cache.freq.new_zeros((0,))
    return CacheState(cache.keys.clone(), empty, cache.slots.clone(), weight,
                      cache.opt_state.new_zeros((0,))), scale


def _fallback_fold(params: TTEmbeddingParams) -> FoldedServingParams:
    """A fallback-mode fold: a copy of the cores and the cache (the serve
    reads nothing else)."""
    return FoldedServingParams(params=TTEmbeddingParams(
        tuple(c.detach().clone() for c in params.tt_cores), (),
        _frozen_cache(params.cache, False)[0]))


def make_folded_serving_fn(
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    num_tables: int,
    batch_size: int,
    probe_cache: bool = True,
    precision: Optional[str] = None,
    impl: str = "auto",
    quantize: Optional[str] = None,
    device="cuda",
):
    """Weight-folded serving: returns ``(fold, serve)``.

    Frozen cores make every weight-derived array of the flat forward a
    constant: the first core's rows, the block-diagonal pass tables and,
    at tt_ndim >= 3, the G0xG1 pair table. ``fold(params) ->
    FoldedServingParams`` builds them once. ``serve(fp, indices, offsets,
    weights=None, *, bs=None) -> [T, B, D]`` (float32, on ``device``) then
    builds the plan, gathers the pair table's rows (no first pass, no z0
    gather, no s1 -> s2 permute), runs kernel B1 on the remaining pass(es)
    and pools. The pair table serves at any batch size, since its build is
    paid once: ``[T*p0*p1 + 1, q0*q1*r2]``, 45 MB in bfloat16 at the
    headline shape. ``bs`` overrides the batch size per call; a batch
    with ``T*bs`` not a multiple of 8 is padded inside and sliced after.
    Inputs and ``indices`` forms as :func:`make_serving_fn`'s; staging
    bfloat16 on the card, float32 on the CPU or with
    ``precision="highest"``.

    The fold is a snapshot, the cache included: after ``cache_populate``
    fold again, or swap in the new cache with :func:`refold_cache` while
    the cores are unchanged.

    On a CUDA ``device`` the serve replays CUDA graphs
    (``utils.graphs.ShapeGraphs``): per request signature (``bs``, the
    shapes and dtypes of ``indices``, ``offsets`` and ``weights``, and the
    ``fp`` served), the first call runs eagerly, the second captures its
    stages (the cache probe, the plan, the passes, the pool), each into a
    graph, and replays them; later calls copy the request into the
    graphs' inputs and replay, each stage inside its span. No capture is
    made while spans are on. Up to ``MAX_GRAPHS`` (8) signatures are kept,
    the least recently used dropped first, and an ``fp``'s graphs go with
    it. The answer is a fresh tensor each call, bitwise the eager one.

    ``quantize="int8"`` stores the pair table and the cache's rows as
    per-row int8 with float32 scales (half and a quarter of their bytes),
    dequantized after each row gather; B1 and the staging dtype do not
    change.

    The JAX package's configuration fallback is kept: where
    ``ops.lookup.route`` does not give ``impl`` the flat pipeline, ``fold``
    carries a copy of the params and ``serve`` is :func:`make_serving_fn`
    (a quantized fallback fold logs a warning and is not quantized)."""
    if quantize not in (None, "int8"):
        raise ValueError(
            f"quantize must be None or 'int8', got {quantize!r}")
    p, q = tuple(tt_p_shapes), tuple(tt_q_shapes)
    rfull = tuple(validate_tt_shapes(tt_p_shapes, tt_q_shapes, tt_ranks))
    device = torch.device(device)
    try:
        rt = route(p, q, rfull, num_tables, batch_size, impl)
    except ValueError:  # the fallback's serve raises it
        rt = None

    if rt is None or rt.kind != "flat":
        if quantize is not None:
            logger.warning(
                "make_folded_serving_fn(quantize=%r): the flat pipeline does "
                "not take this config or impl=%r; the fallback fold carries "
                "the original (unquantized) parameters.", quantize, impl)
        return _fallback_serving(make_serving_fn(
            p, q, rfull, num_tables, batch_size, probe_cache=probe_cache,
            precision=precision, impl=impl, device=device), batch_size)

    cdt = staging_dtype(device, precision)
    use_q, use_r, pad = rt.q, rt.r, rt.pad
    itemsize = torch.empty((), dtype=cdt).element_size()
    pair = tt_flat.pair_structural_ok(num_tables, p, use_q, use_r, itemsize)

    def fold(params: TTEmbeddingParams) -> FoldedServingParams:
        cores = params.tt_cores
        if pad is not None:
            cores = pad_cores_for_flat(cores, p, q, rfull, pad)
        with torch.no_grad():
            setup = tt_flat.make_serving_fold(
                [c.detach() for c in cores], p, use_q, use_r,
                compute_dtype=cdt, pair=pair, quantize=quantize)
            cache, cache_scale = _frozen_cache(
                params.cache if probe_cache else None, quantize == "int8")
        return FoldedServingParams(setup=setup, cache=cache,
                                   cache_scale=cache_scale)

    def stages(fp: FoldedServingParams, bcall: int):
        """The serve's device work as stages ``[(span, fn(st))]`` in order,
        each a function of the tensors in ``st`` (the request's
        ``indices``, ``offsets``, ``weights``) that adds its outputs there,
        its spans those of the helpers it calls; the glue joins the stage
        it feeds. ``st["out"]`` is the answer."""
        # the pooled rows T*b must be a multiple of 8: pad the batch, slice
        b_eff = bcall
        if (num_tables * b_eff) % 8 != 0:
            b_eff = -(-b_eff // 8) * 8
        cache = fp.cache if probe_cache else None
        # unpadded widths: the cache's rows pool with the TT rows, one pass
        one_pool = cache is not None and use_q == q

        def inputs(st):
            (st["idx"], st["parts"], st["nnz"],
             st["keys"]) = _lookup_inputs(st["indices"], len(p), device)
            st["loc"] = None

        def probe(st):
            inputs(st)
            st["loc"] = _probe(cache, st["keys"])

        def plan(st):
            if "nnz" not in st:
                inputs(st)
            rowidx, tableidx = rowidx_from_offsets(
                st["offsets"], st["nnz"], num_tables, bcall)
            st["rowidx"] = rowidx
            st["tbl"] = tableidx if num_tables > 1 else None
            loc = st["loc"]
            st["plan"], st["nza"] = tt_flat._build_plan(
                st["idx"], rowidx, st["tbl"], st["weights"], None, list(p),
                num_tables, b_eff,
                dead_mask=loc >= 0 if loc is not None else None,
                idx_parts=st["parts"], seg=tt_flat.SEG, pair=pair)

        def fwd(st):
            st["rows"], _ = tt_flat.flat_lookup_rows(
                None, p, use_q, use_r, st["plan"], compute_dtype=cdt,
                seg=tt_flat.SEG, setup=fp.setup, num_tables=num_tables)

        def pool(st):
            loc = st["loc"]
            out = tt_flat._pool_flat(
                st["rows"], st["plan"], num_tables * b_eff,
                cache=(CacheRows(cache.weight, loc, fp.cache_scale)
                       if one_pool else None))
            out = unpad_flat_output(out.reshape(num_tables, b_eff, -1),
                                    bcall, use_q, q[-1])
            if not one_pool:
                out = _cached_pool(out, cache, loc, st["weights"],
                                   st["rowidx"], st["tbl"], num_tables,
                                   bcall, scale=fp.cache_scale)
            st["out"] = out

        return ([("fbtt.cache", probe)] if cache is not None else []) + [
            ("fbtt.plan", plan), ("fbtt.fwd", fwd), ("fbtt.pool", pool)]

    def eager(fp: FoldedServingParams, bcall: int, req: dict):
        st = dict(req)
        for _, fn in stages(fp, bcall):
            fn(st)
        _count_lookups(st["nnz"], st["loc"], st["plan"])
        return st["out"]

    def capture(fp: FoldedServingParams, bcall: int, req: dict):
        run = graphs_ops.capture_stages(stages(fp, bcall), req)

        def replay(fp, bcall, req):
            st = run(req)
            _count_lookups(st["nnz"], st["loc"], st["plan"])
            return st["out"].clone()  # never the graph's own buffer

        return replay

    graphs = graphs_ops.ShapeGraphs() if device.type == "cuda" else None

    def request(fp: FoldedServingParams, indices, offsets, weights):
        if fp.setup is None:
            raise ValueError(
                "FoldedServingParams.setup is None (a fallback-mode fold: "
                "the flat pipeline did not take the config when it was "
                "folded) but this serve() was built for flat mode. Build "
                "the (fold, serve) pair again with make_folded_serving_fn, "
                "or serve with make_serving_fn.")
        if isinstance(indices, (tuple, list)):
            indices = tuple(torch.as_tensor(p_, device=device)
                            for p_ in indices)
        else:
            indices = torch.as_tensor(indices, device=device)
        if weights is not None:
            weights = torch.as_tensor(weights, device=device,
                                      dtype=torch.float32)
        return {"indices": indices,
                "offsets": torch.as_tensor(offsets, device=device),
                "weights": weights}

    @profiling.annotated("fbtt.serve")
    def serve(fp: FoldedServingParams, indices, offsets, weights=None, *,
              bs: Optional[int] = None):
        bcall = batch_size if bs is None else bs
        req = request(fp, indices, offsets, weights)
        if graphs is None:
            return eager(fp, bcall, req)
        signature = (bcall,) + tuple(
            _signature(req[k]) for k in ("indices", "offsets", "weights"))
        with torch.cuda.device(device):
            return graphs(signature, fp, eager, capture, fp, bcall, req)

    @profiling.annotated("fbtt.serve")
    def serve_eager(fp: FoldedServingParams, indices, offsets, weights=None,
                    *, bs: Optional[int] = None):
        return eager(fp, batch_size if bs is None else bs,
                     request(fp, indices, offsets, weights))

    serve._eager = serve_eager   # the same serve, never graphed (tests)
    serve._graphs = graphs
    return fold, serve


def _fallback_serving(plain, batch_size: int):
    """The folded serves' fallback mode: ``(_fallback_fold, serve)``,
    ``serve`` ``plain`` (:func:`make_serving_fn`) on the fold's copy."""

    def serve(fp: FoldedServingParams, indices, offsets, weights=None, *,
              bs: Optional[int] = None):
        return plain(fp.params, indices, offsets, weights,
                     bs=batch_size if bs is None else bs)

    return _fallback_fold, serve


def _signature(x):
    """What of a request's tensor (or tuple of tensors, or None) its
    launches depend on: shapes and dtypes."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_signature(t) for t in x)
    return tuple(x.shape), x.dtype


def refold_cache(fp: FoldedServingParams,
                 params: TTEmbeddingParams) -> FoldedServingParams:
    """A folded serving state with ``params``' cache in place of the one it
    was folded with, the pass and pair tables kept (``setup`` is the same
    object): for a cache populated again while the cores stayed as they
    were. A fallback-mode fold takes a copy of the whole ``params``. A
    quantized fold (cache scales, or a ``(q8, scale)`` pair table, which
    also marks a fold frozen before the cache existed) quantizes the new
    cache's rows."""
    if fp.setup is None:
        return _fallback_fold(params)
    quantized = fp.cache_scale is not None or isinstance(fp.setup[1], tuple)
    with torch.no_grad():
        cache, cache_scale = _frozen_cache(params.cache, quantized)
    return FoldedServingParams(setup=fp.setup, cache=cache,
                               cache_scale=cache_scale)


def _host_array(a) -> np.ndarray:
    """An array or tensor (any device) as numpy on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def make_bucketed_serving_fn(
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    num_tables: int,
    batch_buckets: Sequence[int],
    nnz_buckets: Sequence[int],
    probe_cache: bool = True,
    precision: Optional[str] = None,
    impl: str = "auto",
    quantize: Optional[str] = None,
    device="cuda",
):
    """Serving of requests of any size: returns ``(fold, serve)``, the fold
    of :func:`make_folded_serving_fn` at the largest batch bucket.

    ``serve(fp, indices, offsets, weights=None) -> [T, B, D]`` takes any
    ``B <= max(batch_buckets)`` and ``nnz <= max(nnz_buckets)`` (``offsets``
    with ``T*B + 1`` table-major entries), rounds both up to the smallest
    bucket that holds them, and lays the request out again on the host:
    each table's pad bags are empty, the pad lookups have weight 0 (the
    last pad bag holds them) and wide key rows pad with ``(hi, lo) = -1``,
    which no cache probe finds. The padded arrays go to ``device`` once;
    the output is sliced back to ``B``. Reading ``offsets`` on the host is
    the one synchronisation. A request past the largest bucket raises
    ValueError. Bucketing bounds the set of shapes a server meets, as the
    JAX package's does for its compiled programs."""
    bb = sorted(set(int(v) for v in batch_buckets))
    nb = sorted(set(int(v) for v in nnz_buckets))
    if not bb or not nb:
        raise ValueError("batch_buckets and nnz_buckets must be non-empty")
    device = torch.device(device)
    fold, serve = make_folded_serving_fn(
        tt_p_shapes, tt_q_shapes, tt_ranks, num_tables, bb[-1],
        probe_cache=probe_cache, precision=precision, impl=impl,
        quantize=quantize, device=device)

    def _bucket(v: int, buckets, what: str) -> int:
        for cap in buckets:
            if v <= cap:
                return cap
        raise ValueError(
            f"{what}={v} exceeds the largest configured bucket "
            f"{buckets[-1]}")

    def serve_any(fp: FoldedServingParams, indices, offsets, weights=None):
        idx = _host_array(indices)
        off = _host_array(offsets)
        t = num_tables
        if (off.shape[0] - 1) % t != 0:
            raise ValueError(
                f"offsets has {off.shape[0]} entries; expected T*B+1 "
                f"with T={t}")
        b = (off.shape[0] - 1) // t
        nnz = idx.shape[0]
        bs = _bucket(b, bb, "batch")
        nz = _bucket(nnz, nb, "nnz")

        if idx.ndim == 2:
            # wide key rows: pad keys (hi, lo) = -1 miss every cache probe;
            # their part columns stay 0, and their weight is 0
            idx_p = np.zeros((nz, idx.shape[1]), idx.dtype)
            idx_p[:nnz] = idx
            idx_p[nnz:, :2] = -1
        else:
            idx_p = np.zeros((nz,), idx.dtype)
            idx_p[:nnz] = idx
        w_p = np.zeros((nz,), np.float32)
        w_p[:nnz] = 1.0 if weights is None else _host_array(weights)
        # table-major CSR: table ti's real bags keep their spans, its pad
        # bags are empty (they start and end at its real end); the last pad
        # bag takes the padded tail of lookups, whose weights are 0
        off_p = np.empty((t * bs + 1,), off.dtype)
        off_p[0] = 0
        for ti in range(t):
            seg = off[ti * b:(ti + 1) * b + 1]
            off_p[ti * bs + 1:ti * bs + b + 1] = seg[1:]
            off_p[ti * bs + b + 1:(ti + 1) * bs + 1] = seg[-1]
        off_p[t * bs] = nz

        out = serve(fp, torch.as_tensor(idx_p, device=device),
                    torch.as_tensor(off_p, device=device),
                    torch.as_tensor(w_p, device=device), bs=bs)
        return out[:, :b]

    return fold, serve_any


def _lookup_inputs(indices, ndim: int, device):
    """``(indices or None, idx_parts or None, nnz, cache keys or None)`` from
    flat row ids (their own cache keys), a tuple of per-core parts (no
    cache keys), or wide key rows ``int32 [nnz, 2 + ndim]`` (the rows are
    the cache keys, their part columns the lookup's)."""
    if isinstance(indices, (tuple, list)):
        parts = tuple(torch.as_tensor(p_, device=device).to(torch.int32)
                      for p_ in indices)
        return None, parts, parts[0].shape[0], None
    indices = torch.as_tensor(indices, device=device)
    if indices.dim() == 2:
        parts, keys, nnz = split_wide_keyrows(indices, ndim)
        return None, parts, nnz, keys
    return indices, None, indices.shape[0], indices


def make_fused_train_step(
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    num_tables: int,
    batch_size: int,
    optimizer: OptimType = OptimType.SGD,
    use_cache: bool = False,
    probe_cache: bool = False,
    precision: Optional[str] = None,
    impl: str = "auto",
    count_interval: int = 1,
    optim_semantics: str = "reference",
    optim_hparams: Optional[dict] = None,
    device="cuda",
):
    """Build the training step ``step(params, indices, offsets, d_output,
    lr_eps, weights=None, *, bs=batch_size, count=True) -> (output,
    new_params)``: the pooled forward ``[T, bs, D]`` (float32), its
    backward for the given ``d_output`` and the fused update of the cores:
    under ``optim_semantics="reference"`` (the default) SGD
    (``OptimType.SGD``, ``EXACT_SGD``) or full-element Adagrad (every other
    name), under ``"native"`` each optimizer's own update
    (``ops.fused_optim.native_optim_step``; ``params.optimizer_state`` from
    ``native_optim_init``; ``optim_hparams`` overrides
    ``NATIVE_HPARAM_DEFAULTS``).

    ``indices`` is ``[nnz]`` row ids, a tuple of per-core index parts, or
    wide key rows ``int32 [nnz, 2 + ndim]``; ``offsets`` has ``T*bs + 1``
    table-major entries; ``lr_eps`` is ``(learning_rate, eps)``;
    ``weights`` scales each lookup in the forward and in the cotangents.
    Inputs may be numpy arrays or tensors and go to ``device``, where the
    params must be.

    The lookup takes the path ``ops.lookup.route`` gives ``impl``. On the
    flat pipeline unpadded, at nnz <= 32768 (or as ``FBTT_FUSED_APPLY``
    "0" / "1" says), the step runs ``flat_train_apply`` (kernels B1, B2, B3
    on the card, their plain versions on the CPU); otherwise autograd
    through ``pooled_tt_lookup`` (``FlatLookup``, ``GenericLookup``, or the
    plain ``tt_rows`` chain). ``precision="highest"`` stages the flat path in float32 on the card
    (bfloat16 by default).

    The LFU cache (``params.cache``, single table; flat row ids, or wide
    key rows with a wide-key cache, whose ``(hi, lo)`` columns key it): with
    ``use_cache`` each step with ``count`` (the default) adds
    ``count_interval`` to every looked-up row's count (call with ``count=
    (step % count_interval == 0)`` for sampled counting); with
    ``probe_cache`` the lookups the cache holds are served from its rows
    and updated there, by the optimizer's family under either semantics
    (SGD; ``EXACT_ADAGRAD`` with full ``[C, D]`` state; every other name
    row-wise Adagrad with ``[C]`` state), while the TT path skips them
    (``ops.lookup.tt_path_inputs``). A tuple of index
    parts with ``use_cache`` or ``probe_cache`` raises ValueError, as does
    a key layout the cache does not take (flat ids and a wide cache, wide
    rows and another).

    The update is made **in place**: ``params.tt_cores``,
    ``params.optimizer_state`` (reference Adagrad: one zero-initialised
    tensor per core; native: the step counter too) and the cache's tensors
    are overwritten and returned in ``new_params``, as the JAX step donates
    them. Copy the params first to keep them."""
    native = _native_semantics(optim_semantics)
    hparams = dict(optim_hparams) if optim_hparams else None
    ranks = validate_tt_shapes(tt_p_shapes, tt_q_shapes, tt_ranks)
    shapes = (tuple(tt_p_shapes), tuple(tt_q_shapes), tuple(ranks))
    ndim = len(tt_p_shapes)
    device = torch.device(device)

    @profiling.annotated("fbtt.step")
    def step(params: TTEmbeddingParams, indices, offsets, d_output, lr_eps,
             weights=None, *, bs: int = batch_size, count: bool = True):
        if isinstance(indices, (tuple, list)) and (use_cache or probe_cache):
            raise ValueError(
                "cached training takes flat row ids as `indices`, not a "
                "tuple of index parts")
        cache = params.cache
        lr, eps = (v if isinstance(v, torch.Tensor) else float(v)
                   for v in lr_eps)
        indices, parts, nnz, keys = _lookup_inputs(indices, ndim, device)
        offsets = torch.as_tensor(offsets, device=device)
        d_output = torch.as_tensor(d_output, device=device,
                                   dtype=torch.float32)
        if weights is not None:
            weights = torch.as_tensor(weights, device=device,
                                      dtype=torch.float32)
        rowidx, tableidx = rowidx_from_offsets(offsets, nnz, num_tables, bs)
        tbl = tableidx if num_tables > 1 else None
        locations = _count_and_probe(cache, keys, use_cache and count,
                                     probe_cache, count_interval)
        _count_lookups(nnz, locations)
        output, grads = _forward_backward(
            params.tt_cores, shapes, num_tables, bs, impl, precision, device,
            locations, indices, parts, rowidx, tbl, weights, d_output)
        output = _cached_pool(output, cache, locations, weights, rowidx, tbl,
                              num_tables, bs)
        new_cores, new_opt = _update_cores(optimizer, params.tt_cores,
                                           params.optimizer_state, grads, lr,
                                           eps, native, hparams)
        if locations is not None:
            _update_cache_rows(optimizer, cache, d_output, locations, rowidx,
                               lr, eps, weights)
        return output, TTEmbeddingParams(new_cores, new_opt, cache)

    return step


def _count_and_probe(cache: Optional[CacheState], keys, count: bool,
                     probe: bool, scale: int):
    """LFU counting of ``keys`` (flat row ids, or wide key rows for a wide
    cache) where ``count`` (in place; each id adds ``scale``), then each
    lookup's cache row (-1 = not cached) where ``probe``, else None."""
    if cache is None or not (count or probe):
        return None
    with profiling.annotate("fbtt.cache"):
        if count:
            cache_ops.update_cache_state(cache, keys, scale=scale)
        return cache_ops.cache_lookup(cache, keys) if probe else None


def _fused_apply_gate(nnz: int) -> bool:
    """Whether a step of ``nnz`` lookups may take ``flat_train_apply``:
    nnz <= ``_FUSED_APPLY_NNZ_MAX``, or as ``FBTT_FUSED_APPLY`` "0" / "1"
    says (read at every call; the JAX package's semantics)."""
    mode = knobs.get_str("FBTT_FUSED_APPLY", "auto")
    if mode in ("0", "1"):
        return mode == "1"
    return nnz <= _FUSED_APPLY_NNZ_MAX


def _forward_backward(cores, shapes, num_tables: int, bs: int, impl: str,
                      precision, device, locations, indices, parts, rowidx,
                      tbl, weights, d_output):
    """The training step's TT lookup and its core gradients for
    ``d_output``, before any update: ``(output [T, bs, D] without the cache
    rows, grads)``. Where :func:`_fused_apply_gate` allows, on a config the
    flat pipeline takes unpadded, ``flat_train_apply`` (B1, B2, B3 on the
    card); else autograd through ``pooled_tt_lookup`` (``FlatLookup``, the
    generic ``GenericLookup`` under ``impl="pallas"``, or the plain chain).
    The cache-served lookups (``locations``) are skipped as
    ``ops.lookup.tt_path_inputs`` says."""
    rt = route(*shapes, num_tables, bs, impl)
    indices_p, rowidx_p, tbl_p, w_p, dead, live = tt_path_inputs(
        rt, locations, indices, parts, rowidx, tbl, weights)
    if (rt.kind == "flat" and rt.pad is None
            and _fused_apply_gate(rowidx.shape[0])):
        with torch.no_grad():  # the gradients come out explicitly
            return flat_train_apply(
                cores, *shapes, bs, indices_p, rowidx_p, tbl_p, w_p, dead,
                d_output, compute_dtype=staging_dtype(device, precision),
                idx_parts=parts)
    leaves = [c.detach().requires_grad_() for c in cores]
    with torch.enable_grad():
        out = pooled_tt_lookup(
            leaves, *shapes, bs, indices_p, rowidx_p, tbl_p, weights=w_p,
            precision=precision, impl=impl, live_count=live, dead_mask=dead,
            idx_parts=parts)
        grads = torch.autograd.grad(out, leaves, d_output)
    return out.detach(), grads


@profiling.annotated("fbtt.optim")
def _update_cores(optimizer: OptimType, cores, optimizer_state, grads, lr,
                  eps, native: bool = False, hparams: Optional[dict] = None):
    """The fused update of the cores, in place; ``(cores, state)``. The
    reference semantics: SGD for the SGD family, full-element Adagrad for
    every other name; ``native``: ``native_optim_step``."""
    if native:
        return native_optim_step(optimizer, cores, optimizer_state, grads,
                                 lr, eps, hparams=hparams)
    if optimizer in _SGD_OPTIMS:
        return sgd_step(cores, grads, lr), tuple(optimizer_state)
    return adagrad_step(cores, optimizer_state, grads, lr, eps)


@profiling.annotated("fbtt.cache")
def _update_cache_rows(optimizer: OptimType, cache: CacheState, d_output,
                       locations, rowidx, lr, eps, weights):
    """The cache-served lookups' rows, in place, by the reference's update
    families under either semantics: SGD for the SGD family, full-element
    Adagrad (``[C, D]`` state) for ``EXACT_ADAGRAD``, row-wise Adagrad
    (``[C]``) otherwise."""
    if optimizer in _SGD_OPTIMS:
        cache_ops.cache_backward_sgd(cache, d_output, locations, rowidx, lr,
                                     weights=weights)
    elif optimizer == OptimType.EXACT_ADAGRAD:
        cache_ops.cache_backward_adagrad(cache, d_output, locations, rowidx,
                                         lr, eps, weights=weights)
    else:
        cache_ops.cache_backward_rowwise_adagrad_approx(
            cache, d_output, locations, rowidx, lr, eps, weights=weights)


def tt_embedding_forward(
    params: TTEmbeddingParams,
    tt_p_shapes: Sequence[int],
    tt_q_shapes: Sequence[int],
    tt_ranks: Sequence[int],
    batch_size: int,
    indices: torch.Tensor,
    rowidx: torch.Tensor,
    tableidx: Optional[torch.Tensor],
    cache_locations: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    precision: Optional[str] = None,
) -> torch.Tensor:
    """Pooled forward with the optional cache path, ``[T, B, D]`` float32,
    by the plain ``tt_rows`` chain (as the JAX function, which reaches no
    kernel).

    Differentiable by torch autograd with respect to ``params.tt_cores``
    and ``params.cache.weight`` (where they require grad): a lookup with
    ``cache_locations >= 0`` takes its cache row and sends its cotangent
    there, every other lookup its TT row and the cores. ``precision`` is
    accepted for the JAX signature; the chain runs in float32."""
    del precision
    num_tables = params.tt_cores[0].shape[0]
    rows = tt_rows(params.tt_cores, tt_p_shapes, tt_q_shapes, tt_ranks,
                   indices, tableidx)
    if cache_locations is not None and params.cache is not None:
        cached = cache_locations >= 0
        cached_rows = params.cache.weight[cache_locations.clamp(min=0).long()]
        rows = torch.where(cached[:, None], cached_rows, rows)
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    return pool_rows(rows, rowidx, tableidx, num_tables, batch_size)


class _BufferList(nn.Module):
    """Tensors held as buffers ``"0"``, ``"1"``, ...: in a parent's
    ``state_dict`` they are ``<name>.0``, ``<name>.1``, ... (the JAX
    module's ``optimizer_state.{i}``)."""

    def __init__(self, tensors: Sequence[torch.Tensor] = ()):
        super().__init__()
        for i, t in enumerate(tensors):
            self.register_buffer(str(i), t)

    def __len__(self) -> int:
        return len(self._buffers)

    def __iter__(self):
        return iter(self._buffers.values())

    def __getitem__(self, i: int) -> torch.Tensor:
        return list(self._buffers.values())[i]


class _CacheBuffers(nn.Module):
    """The LFU cache's five tensors as buffers (``cache.keys``, ``.freq``,
    ``.slots``, ``.weight``, ``.opt_state`` in a parent's ``state_dict``);
    :meth:`state` views them as a :class:`CacheState`, whose in-place
    updates are the buffers'."""

    def __init__(self, state: CacheState):
        super().__init__()
        self.load(state)

    def load(self, state: CacheState) -> None:
        """Hold ``state``'s tensors (not copies)."""
        for f in _CACHE_FIELDS:
            self.register_buffer(f, getattr(state, f))

    def state(self) -> CacheState:
        return CacheState(*(getattr(self, f) for f in _CACHE_FIELDS))


def _host_ids(indices) -> np.ndarray:
    """Row ids as int64 numpy on the host (tensors from any device)."""
    return np.asarray(_host_array(indices), dtype=np.int64).reshape(-1)


class TableBatchedTTEmbeddingBag(nn.Module):
    """Batched TT EmbeddingBag over ``num_tables`` same-shape tables: the
    JAX package's module, as a ``torch.nn.Module`` on this package's
    kernels.

    The constructor mirrors the reference's (``tt_embeddings_ops.py:
    435-599``), plus ``device`` (``"cuda"`` unless the caller passes
    ``"cpu"``, where every kernel runs its plain version). The cores are
    ``tt_cores``, an ``nn.ParameterList`` of ``[T, p_t, r_t q_t r_{t+1}]``
    float32 tensors drawn from ``np.random.default_rng(seed)`` (the JAX
    module's cores, bit for bit); ``state_dict()`` holds ``tt_cores.{i}``,
    ``optimizer_state.{i}`` (reference semantics: empty for the SGD family,
    else one zero-initialised tensor per core; ``optim_semantics=
    "native"``: ``native_optim_init``'s layout, ``2n + 1`` entries for the
    Adam family with the 0-d int32 step counter last) and, with
    ``use_cache``, ``cache.keys|freq|slots|weight|opt_state``: the JAX
    module's names. Native mode updates the cores by each optimizer's own
    math (``optim_hparams`` overrides ``NATIVE_HPARAM_DEFAULTS``); the
    cache rows keep the reference's update family.

    Use: ``out = m(indices, offsets)`` then ``m.backward(d_out)``. Sparse
    mode applies the fused update in place; dense mode (``sparse=False``)
    returns the gradients. The forward keeps the autograd graph of its
    lookup (``pooled_tt_lookup``: on the flat path kernel B1 forward and
    B3 and B6 (B3 alone under ``FBTT_DG0=onehot``) backward; with
    ``impl="pallas"`` B4 and B5), and ``backward`` takes the cores' gradients from that
    graph: the gradient JAX's module recomputes through the plain chain.
    The output is detached; where the forward ran without grad mode, or
    the cores changed since, ``backward`` runs the lookup again.

    A table of 2^31 rows or more (``prod(tt_p_shapes)`` past int32) takes
    int64 row ids, decomposed on the host; with ``use_cache`` its cache is
    the wide-key layout, ``cache_size`` and ``hashtbl_size`` must be given,
    and one host pass (``wide_keyrows``) makes both the cache's key rows and
    the lookup's parts."""

    def __init__(
        self,
        num_tables: int,
        num_embeddings: int,
        embedding_dim: int,
        tt_ranks: List[int],
        tt_p_shapes: Optional[List[int]] = None,
        tt_q_shapes: Optional[List[int]] = None,
        optimizer: OptimType = OptimType.SGD,
        learning_rate: float = 0.1,
        eps: float = 1.0e-10,
        sparse: bool = True,
        use_cache: bool = False,
        cache_size: int = 0,
        hashtbl_size: int = 0,
        weight_dist: str = "approx-normal",
        enforce_embedding_dim: bool = False,
        seed: int = 0,
        precision: Optional[str] = None,
        impl: str = "auto",
        cache_count_interval: int = 1,
        optim_semantics: str = "reference",
        optim_hparams: Optional[dict] = None,
        device="cuda",
    ) -> None:
        super().__init__()
        assert num_tables > 0
        assert num_embeddings > 0
        assert embedding_dim > 0
        assert num_tables == 1 or not use_cache, (
            "cannot use cache when num_tables != 1")
        native = _native_semantics(optim_semantics)
        self.tt_p_shapes: List[int] = (
            suggested_tt_shapes(num_embeddings, len(tt_ranks) + 1)
            if tt_p_shapes is None else list(tt_p_shapes))
        self.tt_q_shapes: List[int] = (
            suggested_tt_shapes(embedding_dim, len(tt_ranks) + 1,
                                allow_round_up=not enforce_embedding_dim)
            if tt_q_shapes is None else list(tt_q_shapes))
        assert len(self.tt_p_shapes) == len(self.tt_q_shapes)
        assert len(tt_ranks) + 1 == len(self.tt_p_shapes)
        assert int(np.prod(self.tt_p_shapes)) >= num_embeddings
        assert int(np.prod(self.tt_q_shapes)) == embedding_dim
        self.tt_ranks: List[int] = validate_tt_shapes(
            self.tt_p_shapes, self.tt_q_shapes, list(tt_ranks))
        self.tt_ndim = len(self.tt_p_shapes)
        self.num_tables = num_tables
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        # row ids past int32 decompose on the host in int64
        self._big_e = (int(np.prod(self.tt_p_shapes))
                       > np.iinfo(np.int32).max)
        if use_cache and self._big_e:
            # the E-row table and 0.1 E cache of the default sizing do not
            # fit at E >= 2^31: both sizes must be explicit
            assert cache_size > 0 and hashtbl_size > 0, (
                "use_cache with num_embeddings >= 2**31 requires explicit "
                "cache_size and hashtbl_size (the 0.1*E / E defaults do "
                "not fit)")
        self.optimizer = optimizer
        self.optim_semantics = optim_semantics
        self.optim_hparams = dict(optim_hparams) if optim_hparams else None
        self.learning_rate = float(learning_rate)
        self.eps = float(eps)
        self.sparse = sparse
        self.precision = precision
        self.impl = impl
        logger.info(
            "Creating TTEmbeddingBag tt_p_shapes: %s, tt_q_shapes: %s, "
            "tt_ranks: %s, sparse: %s, optimizer: %s, learning_rate: %s, "
            "eps: %s, use_cache: %s, cache_size: %s, hashtbl_size: %s",
            self.tt_p_shapes, self.tt_q_shapes, self.tt_ranks, sparse,
            optimizer, learning_rate, eps, use_cache, cache_size,
            hashtbl_size)

        cores_np = init_tt_cores(
            np.random.default_rng(seed), weight_dist, num_tables,
            num_embeddings, embedding_dim, self.tt_p_shapes,
            self.tt_q_shapes, self.tt_ranks)
        self.tt_cores = nn.ParameterList(
            nn.Parameter(torch.tensor(np.asarray(c, np.float32),
                                      device=device)) for c in cores_np)
        if native:
            state = list(native_optim_init(optimizer, self.tt_cores))
        elif optimizer in _SGD_OPTIMS:
            state = [torch.zeros((0,), dtype=torch.float32, device=device)
                     for _ in range(self.tt_ndim)]
        else:
            state = [torch.zeros_like(c) for c in self.tt_cores]
        self.optimizer_state = _BufferList(
            [s.detach() for s in state])

        self.use_cache = use_cache
        self.cache: Optional[_CacheBuffers] = None
        if use_cache:
            if cache_size <= 0:
                cache_size = int(0.1 * num_embeddings)
            if hashtbl_size <= 0:
                hashtbl_size = num_embeddings
            assert hashtbl_size >= cache_size
            if sparse and optimizer not in _SGD_OPTIMS:
                kind = ("full" if optimizer == OptimType.EXACT_ADAGRAD
                        else "rowwise")
            else:
                kind = "none"
            self.cache = _CacheBuffers(cache_ops.make_cache_state(
                hashtbl_size, cache_size, embedding_dim, kind,
                num_embeddings=None if self._big_e else num_embeddings,
                wide_keys=self.tt_ndim if self._big_e else 0,
                device=device))
        self.warmup = True
        # rows decompressed at a time by cache_populate (None: the
        # library's default)
        self.populate_chunk: Optional[int] = None
        self._saved_ctx: Optional[dict] = None
        # sampled LFU counting: every k-th forward counts, each id adding k
        self.cache_count_interval = max(1, int(cache_count_interval))
        self._count_calls = 0

    # ---------------------------------------------------------------- state

    def _device(self) -> torch.device:
        return self.tt_cores[0].device

    def _cache_state(self) -> Optional[CacheState]:
        return self.cache.state() if self.cache is not None else None

    @property
    def params(self) -> TTEmbeddingParams:
        """The module's tensors as :class:`TTEmbeddingParams`: views that
        share storage (``make_fused_train_step`` on them updates the module
        in place); clone them to keep a copy."""
        return TTEmbeddingParams(
            tuple(c.detach() for c in self.tt_cores),
            tuple(self.optimizer_state), self._cache_state())

    def load_params(self, params: TTEmbeddingParams) -> None:
        """Copy ``params`` into the module: the cores into its parameters,
        the optimizer state and the cache as copies on its device, each
        keeping its dtype (the native step counter stays int32)."""
        dev = self._device()
        with torch.no_grad():
            for c, new in zip(self.tt_cores, params.tt_cores):
                c.copy_(new)
        self.optimizer_state = _BufferList(
            [s.detach().to(dev, copy=True) for s in params.optimizer_state])
        if params.cache is None:
            self.cache = None
            return
        state = CacheState(*(getattr(params.cache, f).detach().to(
            dev, copy=True) for f in _CACHE_FIELDS))
        if self.cache is None:
            self.cache = _CacheBuffers(state)
        else:
            self.cache.load(state)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """Load a state dict of this module's or of the JAX module's names
        (numpy arrays or tensors; :func:`params_from_state_dict`). A
        truncated ``optimizer_state.*`` set raises KeyError. ``strict`` and
        ``assign`` are accepted for ``nn.Module``'s signature; the values
        are always copied."""
        del strict, assign
        self.load_params(params_from_state_dict(
            state_dict, self.tt_ndim, self.cache is not None,
            device=self._device()))

    def import_full_weight(self, weight, table: int = 0) -> None:
        """Load a trained dense ``[E, D]`` table (numpy or a tensor) into
        table ``table``'s cores by TT-SVD (:func:`~fbtt_embedding_tpu_torch.
        utils.decompose.tt_decompose`, on the host). Resets that table's
        optimizer-state slice (a native step counter, 0-d, is left as it
        is); a cache past warm-up is populated again from the new cores."""
        cores = tt_decompose(weight, self.tt_p_shapes, self.tt_q_shapes,
                             self.tt_ranks)
        assert 0 <= table < self.num_tables, (table, self.num_tables)
        with torch.no_grad():
            for c, new in zip(self.tt_cores, cores):
                c[table].copy_(torch.as_tensor(new))
            for s in self.optimizer_state:
                # the SGD family's are empty, a native step counter 0-d
                if s.dim() and s.numel():
                    s[table].zero_()
        if self.cache is not None and not self.warmup:
            self.cache_populate()

    def freeze_for_serving(self, batch_size: int, probe_cache: bool = True,
                           quantize: Optional[str] = None):
        """One-time weight fold for inference: ``(folded, serve)`` with
        ``serve(folded, indices, offsets, weights=None, *, bs=None) -> [T,
        B, D]`` (:func:`make_folded_serving_fn` with the module's shapes,
        ``precision``, ``impl`` and device; the cache is probed where
        ``probe_cache`` and the module has one). ``quantize="int8"`` keeps
        the pair table and the cache's rows as per-row int8.

        The fold is a copy of the current cores and cache: training on, or
        ``cache_populate``, leaves it as it was. Freeze again, or swap a new
        cache in with :func:`refold_cache`."""
        fold, serve = make_folded_serving_fn(
            self.tt_p_shapes, self.tt_q_shapes, self.tt_ranks,
            self.num_tables, batch_size,
            probe_cache=probe_cache and self.use_cache,
            precision=self.precision, impl=self.impl, quantize=quantize,
            device=self._device())
        return fold(self.params), serve

    # ----------------------------------------------------------------- api

    def full_weight(self) -> torch.Tensor:
        """The materialized ``[E', D]`` table (``E' = prod(p) >= E``),
        float32 on the cores' device, by :func:`tt_matrix_to_full`."""
        assert self.num_tables == 1, (
            "full_weight() only supported for num_tables == 1")
        assert not self._big_e, (
            "full_weight() would materialize >= 2**31 rows")
        with torch.no_grad():
            return tt_matrix_to_full(self.tt_p_shapes, self.tt_q_shapes,
                                     self.tt_ranks, list(self.tt_cores))

    def set_learning_rate(self, lr: float) -> None:
        self.learning_rate = float(lr)

    def get_params(self) -> List[torch.Tensor]:
        """The trainable tensors, the cores and (with a cache) the cache's
        rows, without changing the module (the reference's ``get_params``
        appends to its own ParameterList)."""
        params = list(self.tt_cores)
        if self.use_cache and self.cache is not None:
            params.append(self.cache.weight)
        return params

    # --------------------------------------------------------------- cache

    def reset_cache(self) -> None:
        if self.use_cache and self.cache is not None:
            cache_ops.reset_cache(self.cache.state())

    def update_cache(self, indices) -> None:
        """Count ``indices`` into the LFU table (in place); on a table of
        2^31 rows or more, as wide key rows made on the host."""
        if self.use_cache and self.cache is not None:
            if self._big_e:
                keys = torch.as_tensor(wide_keyrows(_host_ids(indices),
                                                    self.tt_p_shapes),
                                       device=self._device())
            else:
                keys = torch.as_tensor(indices,
                                       device=self._device()).reshape(-1)
            cache_ops.update_cache_state(self.cache.state(), keys)

    def cache_populate(self) -> None:
        """Keep the most counted rows, decompressed from the cores
        (``populate_chunk`` rows at a time), and end the warm-up."""
        if self.use_cache and self.cache is not None:
            self.cache.load(cache_ops.cache_populate(
                self.cache.state(), [c.detach() for c in self.tt_cores],
                self.tt_p_shapes, self.tt_q_shapes, self.tt_ranks,
                populate_chunk=self.populate_chunk))
            self.warmup = False

    def cache_hit_rate(self) -> float:
        """Fraction of the last forward's lookups served by the cache."""
        ctx = self._saved_ctx
        if not ctx or ctx.get("locations") is None:
            return 0.0
        return float((ctx["locations"] >= 0).float().mean())

    # ------------------------------------------------------------- forward

    def forward(self, indices, offsets, weights=None,
                warmup: Optional[bool] = None) -> torch.Tensor:
        """Pooled lookup ``[num_tables, B, D]`` (float32, detached).

        ``indices`` ``[nnz]`` row ids and ``offsets`` ``[T*B + 1]``
        table-major CSR offsets, numpy arrays or tensors; ``weights``
        ``[nnz]`` scale each lookup. With ``use_cache`` the forward counts
        the ids (every ``cache_count_interval``-th call, each adding the
        interval) and, past the warm-up, serves the cached ids from the
        cache's rows. ``warmup`` overrides ``self.warmup`` (whether the
        cache is probed) for this call; None defers to it. On a table of
        2^31 rows or more the ids are int64 and decompose on the host: with
        ``use_cache`` one pass (``wide_keyrows``) gives both the cache's key
        rows and the lookup's parts."""
        dev = self._device()
        t = self.num_tables
        parts = None
        if self._big_e and self.use_cache:
            keys = torch.as_tensor(wide_keyrows(_host_ids(indices),
                                                self.tt_p_shapes), device=dev)
            parts, keys, nnz = split_wide_keyrows(keys, self.tt_ndim)
            indices = None
        elif self._big_e:
            parts = tuple(torch.as_tensor(x, device=dev) for x in
                          decompose_indices64(_host_ids(indices),
                                              self.tt_p_shapes))
            indices, keys, nnz = None, None, parts[0].shape[0]
        else:
            indices = torch.as_tensor(indices, device=dev).reshape(-1).to(
                torch.int32)
            keys, nnz = indices, indices.shape[0]
        offsets = torch.as_tensor(offsets, device=dev).reshape(-1)
        assert (offsets.shape[0] - 1) % t == 0
        bs = (offsets.shape[0] - 1) // t
        if weights is not None:
            weights = torch.as_tensor(weights, device=dev,
                                      dtype=torch.float32).reshape(-1)
        warm = self.warmup if warmup is None else warmup
        count = self.use_cache and (
            self._count_calls % self.cache_count_interval == 0)
        if self.use_cache:
            self._count_calls += 1
        rowidx, tableidx = rowidx_from_offsets(offsets, nnz, t, bs)
        tbl = tableidx if t > 1 else None
        cache = self._cache_state()
        locations = _count_and_probe(
            cache, keys, count, self.use_cache and not warm and t == 1,
            self.cache_count_interval)
        rt = route(self.tt_p_shapes, self.tt_q_shapes, self.tt_ranks, t, bs,
                   self.impl)
        ctx = dict(lookup=tt_path_inputs(rt, locations, indices, parts,
                                         rowidx, tbl, weights) + (parts,),
                   rowidx=rowidx, tableidx=tbl, locations=locations,
                   weights=weights, batch_size=bs, graph=None)
        out = self._tt_lookup(ctx)
        if out.requires_grad:  # kept for backward, with the cores' versions
            ctx["graph"] = (out, [c._version for c in self.tt_cores])
        self._saved_ctx = ctx
        return _cached_pool(out.detach(), cache, locations, weights, rowidx,
                            tbl, t, bs)

    def _tt_lookup(self, ctx: dict) -> torch.Tensor:
        """The TT path of the forward on ``ctx``'s lookups."""
        indices, rowidx, tbl, w, dead, live, parts = ctx["lookup"]
        return pooled_tt_lookup(
            list(self.tt_cores), self.tt_p_shapes, self.tt_q_shapes,
            self.tt_ranks, ctx["batch_size"], indices, rowidx, tbl,
            weights=w, precision=self.precision, impl=self.impl,
            live_count=live, dead_mask=dead, idx_parts=parts)

    # ------------------------------------------------------------ backward

    def backward(self, d_output):
        """Apply the fused update (sparse) or return dense gradients.

        ``d_output``: the cotangent of the last forward's output, ``[T, B,
        D]`` (or ``[B, D]``). Sparse mode updates the cores (and, for the
        cache-served lookups, the cache rows and their optimizer state) in
        place and returns None, as the reference's backward mutates its
        weights. Dense mode returns ``(d_tt_cores, d_cache_weight)``; the
        latter is None unless the forward probed the cache."""
        assert self._saved_ctx is not None, "forward() must run first"
        ctx = self._saved_ctx
        d_output = torch.as_tensor(d_output, device=self._device(),
                                   dtype=torch.float32)
        if d_output.dim() == 2:
            d_output = d_output[None]
        grads = self._core_grads(ctx, d_output)
        locations, rowidx, weights = (ctx["locations"], ctx["rowidx"],
                                      ctx["weights"])
        cache = self._cache_state()
        if self.sparse:
            _update_cores(self.optimizer, tuple(self.tt_cores),
                          tuple(self.optimizer_state), grads,
                          self.learning_rate, self.eps,
                          self.optim_semantics == "native",
                          self.optim_hparams)
            if locations is not None and cache is not None:
                _update_cache_rows(self.optimizer, cache, d_output, locations,
                                   rowidx, self.learning_rate, self.eps,
                                   weights)
            return None
        d_cache_weight = None
        if locations is not None and cache is not None:
            d_cache_weight = cache_ops.cache_backward_dense(
                cache, d_output, locations, rowidx, weights)
        return grads, d_cache_weight

    def _core_grads(self, ctx: dict, d_output) -> List[torch.Tensor]:
        """The cores' gradients for ``d_output`` through the forward's
        graph, used once; the lookup runs again where there is none or the
        cores changed since. Cache-served lookups get none (dead lookups,
        or weight 0), weighted ones their weight's share."""
        graph, ctx["graph"] = ctx["graph"], None
        cores = list(self.tt_cores)
        with torch.enable_grad():
            if graph is not None and graph[1] == [c._version for c in cores]:
                out = graph[0]
            else:
                out = self._tt_lookup(ctx)
            return list(torch.autograd.grad(out, cores, d_output))


class TTEmbeddingBag(TableBatchedTTEmbeddingBag):
    """Single-table TT EmbeddingBag; ``forward`` returns ``[B, D]``
    (reference ``tt_embeddings_ops.py:889-934``). The LFU cache is on by
    default."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        tt_ranks: List[int],
        tt_p_shapes: Optional[List[int]] = None,
        tt_q_shapes: Optional[List[int]] = None,
        optimizer: OptimType = OptimType.SGD,
        learning_rate: float = 0.1,
        eps: float = 1.0e-10,
        sparse: bool = True,
        use_cache: bool = True,
        cache_size: int = 0,
        hashtbl_size: int = 0,
        weight_dist: str = "approx-normal",
        enforce_embedding_dim: bool = False,
        seed: int = 0,
        precision: Optional[str] = None,
        impl: str = "auto",
        cache_count_interval: int = 1,
        optim_semantics: str = "reference",
        optim_hparams: Optional[dict] = None,
        device="cuda",
    ) -> None:
        super().__init__(
            1, num_embeddings, embedding_dim, tt_ranks, tt_p_shapes,
            tt_q_shapes, optimizer, learning_rate, eps, sparse, use_cache,
            cache_size, hashtbl_size, weight_dist, enforce_embedding_dim,
            seed, precision, impl, cache_count_interval, optim_semantics,
            optim_hparams, device)

    def forward(self, indices, offsets, weights=None,
                warmup: Optional[bool] = None) -> torch.Tensor:
        """As :meth:`TableBatchedTTEmbeddingBag.forward`, ``[B, D]``."""
        return super().forward(indices, offsets, weights, warmup)[0]
