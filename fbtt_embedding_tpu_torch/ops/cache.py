"""Software LFU cache of decompressed hot embedding rows, in PyTorch.

Counterpart of ``fbtt_embedding_tpu/ops/cache.py``: a table that counts
per-row lookup frequencies, a populate step that keeps the top
``cache_size`` rows and decompresses them, a per-lookup probe
(``cache_location``, -1 = not cached) and the cached rows' forward and
optimizer updates. Two layouts, as in the JAX package:

* **direct** (``hashtbl_size >= num_embeddings``, the reference's default
  sizing): dense ``freq[E]`` / ``slots[E]`` tables, exact counts, ``keys``
  empty;
* **hashed**: an open-addressing table of int32 keys (MurmurHash3
  finalizer, linear probing over ``MAX_PROBES`` slots) whose claims are
  settled by the JAX package's deterministic two-round tournament;
* **wide** (``wide_keys=tt_ndim``, for tables of 2^31 rows or more): the
  hashed table keyed by int64 row ids split into int32 ``(hi, lo)``
  columns, each key row ``(hi, lo, part_0..part_{ndim-1})`` (the layout of
  :func:`~fbtt_embedding_tpu_torch.ops.indexing.wide_keyrows`), so that
  populate decompresses winners from their stored parts and no 64-bit id
  reaches the device.

A wide cache takes wide key rows and the other layouts flat row ids; the
other pairing raises ValueError.

The functions that update a state (counting, the cached rows' optimizers,
``reset_cache``) update its tensors **in place** and return the state, as
the JAX step donates its buffers. Integer counts are exact in any order;
float scatter-adds go through :func:`hot_scatter_add`, which adds each
row's updates in one fixed order on the card too. JAX's
``approx_max_k`` for tables above 2^21 rows is TPU tuning: populate takes
the exact top-k by a stable descending sort (ties: lowest index first, as
``jax.lax.top_k``). There is no Pallas kernel here: cache hits reach the
TT kernels only as dead lookups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from fbtt_embedding_tpu_torch.ops.contraction import tt_rows
from fbtt_embedding_tpu_torch.ops.hot_scatter import hot_scatter_add
from fbtt_embedding_tpu_torch.ops.indexing import (
    rowidx_from_offsets,
    wide_keyrows,
)

MAX_PROBES = 3  # the reference's (tt_embeddings_cuda.cu:29)
EMPTY_KEY = -1
DEFAULT_POPULATE_CHUNK = 8192  # rows decompressed at a time by populate
_M32 = 0xFFFFFFFF


@dataclass
class CacheState:
    """The cache's tensors (the JAX package's ``CacheState`` fields)."""

    keys: torch.Tensor       # int32 [H] (hashed) / [0] (direct) /
                             # [H, 2 + ndim] (wide)
    freq: torch.Tensor       # int32 [H] / [E]: LFU counts
    slots: torch.Tensor      # int32 [H] / [E]: slot or row -> cache row, -1
    weight: torch.Tensor     # float32 [C, D]: decompressed hot rows
    opt_state: torch.Tensor  # float32 [C] (rowwise) / [C, D] (full) / [0]

    @property
    def direct(self) -> bool:
        """True when counting is indexed by row id (no hash table)."""
        return self.keys.shape[0] == 0

    @property
    def wide(self) -> bool:
        """True for the wide-key (int64 row id) hashed layout."""
        return self.keys.dim() == 2

    @property
    def hashtbl_size(self) -> int:
        return self.keys.shape[0]

    @property
    def cache_size(self) -> int:
        return self.weight.shape[0]


def make_cache_state(hashtbl_size: int, cache_size: int, embedding_dim: int,
                     opt_state_kind: str = "none",
                     num_embeddings: Optional[int] = None,
                     wide_keys: int = 0, device="cuda") -> CacheState:
    """Allocate the cache tables on ``device``: direct mode when
    ``num_embeddings`` is given and ``hashtbl_size >= num_embeddings``,
    hashed otherwise; ``wide_keys=tt_ndim`` gives the wide-key hashed
    layout (keys ``int32 [H, 2 + tt_ndim]`` of ``EMPTY_KEY``; exclusive of
    direct mode). ``opt_state_kind``: "none", "rowwise" (``[C]``) or
    "full" (``[C, D]``)."""
    if opt_state_kind not in ("none", "rowwise", "full"):
        raise ValueError(f"unknown opt_state_kind {opt_state_kind!r}")
    f32, i32 = torch.float32, torch.int32
    opt_shape = {"rowwise": (cache_size,), "full": (cache_size,
                                                    embedding_dim)}
    opt = torch.zeros(opt_shape.get(opt_state_kind, (0,)), dtype=f32,
                      device=device)
    direct = (not wide_keys and num_embeddings is not None
              and hashtbl_size >= num_embeddings)
    n = num_embeddings if direct else hashtbl_size
    key_shape = ((hashtbl_size, 2 + int(wide_keys)) if wide_keys else
                 (0 if direct else hashtbl_size,))
    return CacheState(
        keys=torch.full(key_shape, EMPTY_KEY, dtype=i32, device=device),
        freq=torch.zeros((n,), dtype=i32, device=device),
        slots=torch.full((n,), -1, dtype=i32, device=device),
        weight=torch.zeros((cache_size, embedding_dim), dtype=f32,
                           device=device),
        opt_state=opt)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` holding uint32 values, in two
    16-bit halves of ``c`` so that no product passes 2^49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _murmur_fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors holding uint32
    values (PyTorch's uint32 lacks the arithmetic)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 values taken as uint32, held in int64 (-1 is 0xFFFFFFFF)."""
    return x.to(torch.int32).to(torch.int64) & _M32


def hash_keys(keys: torch.Tensor, table_size: int) -> torch.Tensor:
    """MurmurHash3 finalizer of the int32 row ids (taken as uint32, so -1
    is 0xFFFFFFFF), reduced mod ``table_size``: int32, bit for bit the JAX
    package's ``hash_keys``."""
    return (_murmur_fmix32(_u32(keys)) % table_size).to(torch.int32)


def hash_keys_wide(hi: torch.Tensor, lo: torch.Tensor,
                   table_size: int) -> torch.Tensor:
    """Hash of split int64 keys: the high word folded into the low one by a
    golden-ratio multiply mod 2^32, then :func:`hash_keys`' finalizer; bit
    for bit the JAX package's ``hash_keys_wide``."""
    x = _u32(lo) ^ _mul32(_u32(hi), 0x9E3779B1)
    return (_murmur_fmix32(x) % table_size).to(torch.int32)


# the JAX package's name for the host-side key rows of the wide layout
wide_cache_keys = wide_keyrows


def _check_layout(state: CacheState, keys: torch.Tensor) -> None:
    """Wide key rows go with a wide cache, flat row ids with the others."""
    rows = keys.dim() == 2
    if state.wide and not rows:
        raise ValueError(
            "a wide-key cache takes wide key rows int32 [nnz, 2 + ndim] "
            "(ops.indexing.wide_keyrows), got flat row ids of shape "
            f"{tuple(keys.shape)}")
    if rows and not state.wide:
        raise ValueError(
            f"wide key rows of shape {tuple(keys.shape)} against a "
            f"{'direct' if state.direct else 'hashed'} cache, which takes "
            "flat int32 row ids; a table of 2^31 rows or more needs "
            "make_cache_state(..., wide_keys=tt_ndim)")


def _claim_rounds(state: CacheState, h: torch.Tensor, first: torch.Tensor,
                  matches, new_keys: torch.Tensor) -> torch.Tensor:
    """Insert-or-find of each distinct key, in place of ``state.keys``: the
    JAX package's two-round tournament. ``h``: each sorted key's hash;
    ``first``: the keys to place (their run's first position, valid);
    ``matches(keys_at)``: whether a probed key entry is this key;
    ``new_keys``: what a winner writes into its slot. Each round probes
    ``MAX_PROBES`` slots at once, takes a match, else claims empty slots
    (lowest (probe, position) wins a slot, each key its earliest winning
    probe); the round's winners are written before the next. Returns each
    key's slot, ``H`` where it has none (dropped)."""
    h_size = state.hashtbl_size
    nnz = h.shape[0]
    dev = h.device
    slots = [((h + j) % h_size).long() for j in range(MAX_PROBES)]
    sent = torch.full((nnz,), h_size, dtype=torch.long, device=dev)

    def empty(k):
        return (k[:, 0] if k.dim() == 2 else k) == EMPTY_KEY

    def tournament(keys_table, unplaced):
        keys_at = [keys_table[s] for s in slots]
        match_j = [unplaced & matches(k) for k in keys_at]
        matched = torch.stack(match_j).any(0)
        match_slot = sent
        for j in range(MAX_PROBES - 1, -1, -1):
            match_slot = torch.where(match_j[j], slots[j], match_slot)
        cand = torch.cat([
            torch.where(unplaced & ~matched & empty(keys_at[j]), slots[j],
                        sent) for j in range(MAX_PROBES)])
        cand_sorted, order = torch.sort(cand, stable=True)
        win = torch.ones_like(cand_sorted, dtype=torch.bool)
        win[1:] = cand_sorted[1:] != cand_sorted[:-1]
        win_flat = torch.zeros(MAX_PROBES * nnz, dtype=torch.bool,
                               device=dev)
        win_flat[order] = win & (cand_sorted < h_size)
        win_j = win_flat.reshape(MAX_PROBES, nnz)
        won_slot = sent
        taken = torch.zeros(nnz, dtype=torch.bool, device=dev)
        for j in range(MAX_PROBES):
            take = win_j[j] & ~taken
            won_slot = torch.where(take, slots[j], won_slot)
            taken = taken | take
        return torch.where(matched, match_slot, won_slot), won_slot

    keys = state.keys
    unplaced = first
    placed_slot = sent
    for _ in range(2):
        placed, won_slot = tournament(keys, unplaced)
        # each slot has one winner and each key wins one slot: no clashes
        won = (won_slot < h_size).nonzero().squeeze(1)
        keys[won_slot[won]] = new_keys[won]
        placed_slot = torch.where(placed < h_size, placed, placed_slot)
        unplaced = unplaced & (placed == h_size)
    return placed_slot


def _run_counts(is_first: torch.Tensor) -> torch.Tensor:
    """Each sorted position's count of its run of equal keys."""
    nnz = is_first.shape[0]
    run_id = (torch.cumsum(is_first.to(torch.int32), 0) - 1).long()
    ones = torch.ones(nnz, dtype=torch.int32, device=is_first.device)
    return torch.zeros_like(ones).index_add_(0, run_id, ones)[run_id]


def update_cache_state(state: CacheState, indices: torch.Tensor,
                       scale: int = 1) -> CacheState:
    """LFU counting, in place: every row id adds ``scale`` to its count
    (``scale = k`` when counting every k-th step keeps expected counts
    unbiased).

    Direct mode: one int32 scatter-add into ``freq``; ids outside
    ``[0, E)`` add nothing. Hashed mode: duplicates are pre-aggregated and
    each distinct id matches its entry within ``MAX_PROBES`` linear-probe
    slots or claims the first empty one, claims settled by the JAX
    package's two-round tournament (lowest (probe, key) wins); ids that
    lose every probe and negative ids are dropped.

    Wide mode: ``indices`` are wide key rows ``int32 [nnz, 2 + ndim]``,
    keyed on their ``(hi, lo)`` columns (sorted as the JAX package sorts
    them, signed and lexicographic, stable); a winner writes its whole key
    row, and rows with ``hi < 0`` (negative ids, pads) are dropped."""
    _check_layout(state, indices)
    if state.wide:
        return _update_cache_state_wide(state, indices, scale)
    idx = indices.to(torch.int32)
    if state.direct:
        n = state.freq.shape[0]
        valid = (idx >= 0) & (idx < n)
        state.freq.index_add_(0, idx.clamp(0, n - 1).long(),
                              valid.to(torch.int32) * int(scale))
        return state
    idx, _ = torch.sort(idx)
    is_first = torch.ones(idx.shape[0], dtype=torch.bool, device=idx.device)
    is_first[1:] = idx[1:] != idx[:-1]
    placed = _claim_rounds(state, hash_keys(idx, state.hashtbl_size),
                           is_first & (idx >= 0), lambda k: k == idx, idx)
    return _add_counts(state, placed, _run_counts(is_first), scale)


def _add_counts(state: CacheState, placed_slot, cnt, scale: int):
    """``freq[slot] += cnt * scale`` for every placed key, in place."""
    h_size = state.hashtbl_size
    inc = torch.where(placed_slot < h_size, cnt * int(scale),
                      torch.zeros_like(cnt))
    state.freq.index_add_(0, placed_slot.clamp(max=h_size - 1), inc)
    return state


def _update_cache_state_wide(state: CacheState, keyrows: torch.Tensor,
                             scale: int = 1) -> CacheState:
    """The wide layout's counting (:func:`update_cache_state`): the key rows
    sorted by ``(hi, lo)`` as signed int32 pairs, lexicographic and stable
    (JAX's ``lax.sort(num_keys=2, is_stable=True)``), through one int64 key
    that keeps that order; the same two-round tournament as the hashed
    mode, keyed on ``(hi, lo)``."""
    rows = keyrows.to(torch.int32)
    key64 = (rows[:, 0].to(torch.int64) << 32) + (
        rows[:, 1].to(torch.int64) + 2 ** 31)
    key64, order = torch.sort(key64, stable=True)
    rows = rows[order]
    hi, lo = rows[:, 0], rows[:, 1]
    is_first = torch.ones(rows.shape[0], dtype=torch.bool,
                          device=rows.device)
    is_first[1:] = key64[1:] != key64[:-1]
    placed = _claim_rounds(
        state, hash_keys_wide(hi, lo, state.hashtbl_size),
        is_first & (hi >= 0), lambda k: (k[:, 0] == hi) & (k[:, 1] == lo),
        rows)
    return _add_counts(state, placed, _run_counts(is_first), scale)


def cache_lookup(state: CacheState, indices: torch.Tensor) -> torch.Tensor:
    """Per-lookup cache row (int32), -1 where the row is not cached; a
    negative id is always a miss. A wide cache takes wide key rows and
    probes their ``(hi, lo)`` columns; a row with ``hi < 0`` (a negative
    id, or a pad ``(hi, lo) = -1``) is a miss."""
    _check_layout(state, indices)
    if state.wide:
        hi, lo = indices[:, 0].to(torch.int32), indices[:, 1].to(torch.int32)
        h_size = state.hashtbl_size
        h = hash_keys_wide(hi, lo, h_size)
        loc = torch.full_like(hi, -1)
        found = hi < 0
        for probe in range(MAX_PROBES):
            slot = ((h + probe) % h_size).long()
            ks = state.keys[slot]
            hit = ~found & (ks[:, 0] == hi) & (ks[:, 1] == lo)
            loc = torch.where(hit, state.slots[slot], loc)
            found = found | hit
        return loc
    if state.direct:
        return direct_lookup(state.slots, indices)
    idx = indices.to(torch.int32)
    miss = torch.full_like(idx, -1)
    h_size = state.hashtbl_size
    h = hash_keys(idx, h_size)
    loc = miss
    found = torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
    for probe in range(MAX_PROBES):
        slot = ((h + probe) % h_size).long()
        hit = ~found & (state.keys[slot] == idx)
        loc = torch.where(hit, state.slots[slot], loc)
        found = found | hit
    return loc


def direct_lookup(slots: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """The direct layout's probe: ``slots[indices]`` (int32), -1 where an
    id lies outside the table (a negative id, a pad -1, misses)."""
    idx = indices.to(torch.int32)
    n = slots.shape[0]
    loc = slots[idx.clamp(0, n - 1).long()]
    return torch.where((idx >= 0) & (idx < n), loc, torch.full_like(idx, -1))


def _decompress_rows(tt_cores, tt_p_shapes, tt_q_shapes, tt_ranks, rows_idx,
                     chunk: Optional[int] = None) -> torch.Tensor:
    """``tt_rows`` of ``rows_idx`` -> ``[n, D]`` float32, ``chunk`` rows at
    a time, so the gather intermediates peak at one chunk (1.1M rows at the
    benchmark's cache size would not fit at once). ``rows_idx`` is ``[n]``
    row ids, or ``[n, ndim]`` per-core parts (the wide layout)."""
    chunk = chunk or DEFAULT_POPULATE_CHUNK
    n = rows_idx.shape[0]
    d = 1
    for q in tt_q_shapes:
        d *= int(q)
    out = torch.empty((n, d), dtype=torch.float32, device=rows_idx.device)
    with torch.no_grad():
        for s in range(0, n, chunk):
            ri = rows_idx[s:s + chunk]
            if ri.dim() == 2:
                out[s:s + chunk] = tt_rows(
                    tt_cores, tt_p_shapes, tt_q_shapes, tt_ranks, None,
                    idx_parts=[ri[:, t] for t in range(ri.shape[1])])
            else:
                out[s:s + chunk] = tt_rows(tt_cores, tt_p_shapes,
                                           tt_q_shapes, tt_ranks, ri)
    return out


def populate_plan(state: CacheState) -> Tuple[torch.Tensor, ...]:
    """The winner selection of :func:`cache_populate`: ``(new_keys,
    new_freq, new_slots, winner_rows, valid)``. ``winner_rows[s]`` is the
    row id to decompress into cache slot ``s`` (wide layout: its ``[ndim]``
    per-core parts, from the stored key row); ``valid[s]`` marks slots
    that won (count > 0). The top ``cache_size`` counts, ties lowest index
    first; the losers are evicted (key and count reset)."""
    c_size = state.cache_size
    occupied = (state.keys[:, 0] if state.wide else state.keys) != EMPTY_KEY
    counts = state.freq if state.direct else torch.where(
        occupied, state.freq, torch.full_like(state.freq, -1))
    n = counts.shape[0]
    if c_size > n:
        raise ValueError(f"cache_size {c_size} exceeds the {n} counted rows")
    top_freq, top = torch.sort(counts, descending=True, stable=True)
    top_freq, top = top_freq[:c_size], top[:c_size]
    valid = top_freq > 0
    dev = counts.device
    ranks = torch.arange(c_size, dtype=torch.int32, device=dev)
    won = valid.nonzero().squeeze(1)  # cache slots that won: distinct rows
    new_slots = torch.full((n,), -1, dtype=torch.int32, device=dev)
    new_slots[top[won]] = ranks[won]
    winner = torch.zeros((n,), dtype=torch.bool, device=dev)
    winner[top[won]] = True
    new_freq = torch.where(winner, state.freq, torch.zeros_like(state.freq))
    if state.direct:
        new_keys = state.keys
        winner_rows = torch.where(valid, top.to(torch.int32),
                                  torch.zeros_like(ranks))
    elif state.wide:
        new_keys = torch.where(winner[:, None], state.keys,
                               torch.full_like(state.keys, EMPTY_KEY))
        winner_rows = torch.where(valid[:, None], state.keys[top][:, 2:],
                                  torch.zeros((), dtype=torch.int32,
                                              device=dev))
    else:
        new_keys = torch.where(winner, state.keys,
                               torch.full_like(state.keys, EMPTY_KEY))
        winner_rows = torch.where(valid, state.keys[top],
                                  torch.zeros_like(ranks))
    return new_keys, new_freq, new_slots, winner_rows, valid


def cache_populate(state: CacheState, tt_cores: Sequence[torch.Tensor],
                   tt_p_shapes, tt_q_shapes, tt_ranks,
                   populate_chunk: Optional[int] = None) -> CacheState:
    """Keep the top ``cache_size`` rows by count, evict the rest, and
    decompress the winners into ``weight`` (``populate_chunk`` rows at a
    time): a new state, its optimizer state reset to zeros."""
    new_keys, new_freq, new_slots, winner_rows, valid = populate_plan(state)
    rows = _decompress_rows(tt_cores, tt_p_shapes, tt_q_shapes, tt_ranks,
                            winner_rows, chunk=populate_chunk)
    return CacheState(
        keys=new_keys, freq=new_freq, slots=new_slots,
        weight=torch.where(valid[:, None], rows, torch.zeros((), device=
                                                             rows.device)),
        opt_state=torch.zeros_like(state.opt_state))


def preprocess_indices(indices, offsets, num_tables: int, batch_size: int,
                       warmup: bool, cache_state: Optional[CacheState]):
    """``(indices, offsets)`` -> ``(indices, rowidx, tableidx,
    cache_locations)``; every location is -1 (the TT path) during warmup,
    without a cache or with several tables."""
    nnz = indices.shape[0]
    rowidx, tableidx = rowidx_from_offsets(offsets, nnz, num_tables,
                                           batch_size)
    if warmup or cache_state is None or num_tables != 1:
        locations = torch.full((nnz,), -1, dtype=torch.int32,
                               device=indices.device)
    else:
        locations = cache_lookup(cache_state, indices)
    return indices, rowidx, tableidx, locations


def cache_forward(state: CacheState, locations: torch.Tensor,
                  rowidx: torch.Tensor, batch_size: int,
                  output: torch.Tensor) -> torch.Tensor:
    """``output + `` the cached lookups' rows pooled into ``[1, B, D]``."""
    cached = locations >= 0
    rows = state.weight[locations.clamp(min=0).long()]
    rows = torch.where(cached[:, None], rows, torch.zeros((), device=
                                                          rows.device))
    pooled = torch.zeros((batch_size + 1, rows.shape[1]), dtype=rows.dtype,
                         device=rows.device)
    seg = torch.where((rowidx >= 0) & (rowidx < batch_size), rowidx,
                      torch.full_like(rowidx, batch_size))
    hot_scatter_add(pooled, seg, rows)
    return output + pooled[None, :batch_size]


def cache_row_grads(d_output: torch.Tensor, locations: torch.Tensor,
                    rowidx: torch.Tensor,
                    weights: Optional[torch.Tensor] = None):
    """``(d_rows [nnz, D]`` masked to the cached lookups, cached mask)``;
    ``d_output`` is ``[1, B, D]``, a weighted lookup's cotangent
    ``w * d_out[row]``."""
    cached = locations >= 0
    d_rows = d_output[0][rowidx.long()]
    if weights is not None:
        d_rows = d_rows * weights[:, None].to(d_rows.dtype)
    return torch.where(cached[:, None], d_rows,
                       torch.zeros((), device=d_rows.device)), cached


def _cache_loc(state: CacheState, locations, cached):
    return torch.where(cached, locations,
                       torch.full_like(locations, state.cache_size))


def cache_backward_dense(state: CacheState, d_output, locations, rowidx,
                         weights=None) -> torch.Tensor:
    """The dense gradient of ``weight``, ``[C, D]``."""
    d_rows, cached = cache_row_grads(d_output, locations, rowidx, weights)
    return hot_scatter_add(torch.zeros_like(state.weight),
                           _cache_loc(state, locations, cached), d_rows)


def cache_backward_sgd(state: CacheState, d_output, locations, rowidx,
                       learning_rate, weights=None) -> CacheState:
    """SGD on the cached rows the batch touched, in place."""
    d_rows, cached = cache_row_grads(d_output, locations, rowidx, weights)
    hot_scatter_add(state.weight, _cache_loc(state, locations, cached),
                    -learning_rate * d_rows)
    return state


def cache_backward_adagrad(state: CacheState, d_output, locations, rowidx,
                           learning_rate, eps, weights=None) -> CacheState:
    """Full-element Adagrad on the cached rows, in place (the
    ``EXACT_ADAGRAD`` family): with G the row's summed gradient, ``s +=
    G^2; w -= lr * G / (sqrt(s) + eps)``, over the whole ``[C, D]`` table
    as in the JAX package. Needs ``[C, D]`` optimizer state."""
    if state.opt_state.shape != state.weight.shape:
        raise ValueError(
            "cache_backward_adagrad needs full [cache_size, D] optimizer "
            f"state, got {tuple(state.opt_state.shape)} vs weight "
            f"{tuple(state.weight.shape)}; use "
            "cache_backward_rowwise_adagrad_approx for row-wise state")
    g = cache_backward_dense(state, d_output, locations, rowidx, weights)
    state.opt_state.add_(g * g)
    state.weight.sub_(learning_rate * g / (torch.sqrt(state.opt_state)
                                           + eps))
    return state


def cache_backward_rowwise_adagrad_approx(state: CacheState, d_output,
                                          locations, rowidx, learning_rate,
                                          eps, weights=None) -> CacheState:
    """Row-wise approximate Adagrad on the cached rows, in place: each
    row's state adds the mean square of every lookup's gradient, then every
    lookup updates its row with the row's final state. Needs ``[C]``
    optimizer state."""
    if tuple(state.opt_state.shape) != (state.cache_size,):
        raise ValueError(
            "cache_backward_rowwise_adagrad_approx needs row-wise "
            f"[cache_size] optimizer state, got "
            f"{tuple(state.opt_state.shape)}; use cache_backward_adagrad "
            "for full [cache_size, D] state")
    d_rows, cached = cache_row_grads(d_output, locations, rowidx, weights)
    loc = _cache_loc(state, locations, cached)
    gsq_mean = torch.sum(d_rows * d_rows, dim=-1) / d_rows.shape[-1]
    hot_scatter_add(state.opt_state, loc, gsq_mean)
    scale = learning_rate / (torch.sqrt(state.opt_state) + eps)
    per_lookup = scale[loc.clamp(0, state.cache_size - 1).long()] \
        * cached.to(torch.float32)
    hot_scatter_add(state.weight, loc, -per_lookup[:, None] * d_rows)
    return state


def reset_cache(state: CacheState) -> CacheState:
    """Clear the counting state (keys, counts, slots) in place."""
    state.keys.fill_(EMPTY_KEY)
    state.freq.zero_()
    state.slots.fill_(-1)
    return state
