"""Kernel 2 of the sorted-run passes, the span reduce (CPU).

- The plain model of its schedule (``span_reduce_sched_plain``: a span's
  partial tiles in chunks of consecutive tiles, then the chunk sums in
  chunk order, thread groups as the kernel's) against a plain float64
  per-span sum (within 1e-6 of the largest |acc|) and against the single
  pass's order (within 1e-5): a hot span over many chunks, spans of
  exactly C and C + 1 tiles, empty and one-tile spans, tiles of 128, 4096
  and 8192 floats. Slots no live span owns hold NaN: they are never read.
- The chunk rule (``span_chunk``) at the benchmark cells' shapes, and the
  grid bounds the launch sizes by (``reduce_sched_ints``) over random
  span tables.
- The counter ``span_reduce.split_spans`` on the CPU route of B2, B3, B6
  and ``span_reduce``: the spans the model splits, counted only while a
  profiler records.
"""

import numpy as np
import pytest
import torch

from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import (
    SPLIT_SPANS,
    reduce_sched_ints,
    seg_accum,
    span_chunk,
    span_reduce,
    span_reduce_sched_plain,
    span_tiles,
)
from fbtt_embedding_tpu_torch.ops.kernels.seg_accum_dg0 import seg_accum_dg0
from fbtt_embedding_tpu_torch.ops.kernels.seg_fused_i2 import seg_fused_i2
from fbtt_embedding_tpu_torch.ops.kernels.tt_kernel import segment_spans
from fbtt_embedding_tpu_torch.utils import profiling

SEG = 8  # rows a segment: small, so that spans meet many segments

# name: (rows of each span, chunk, chunks of each span)
LAYOUTS = {
    "hot span over many chunks": ([3, 8 * 37 + 5, 2, 9], 6,
                                  [1, 7, 1, 1]),
    "spans of exactly C and C + 1 tiles": ([8 * 6, 3, 8 * 7 - 3, 4], 6,
                                           [1, 1, 2, 1]),
    "empty and one-tile spans": ([0, 1, 0, 0, 7, 8 * 20, 0], 5,
                                 [1, 1, 1, 1, 1, 4, 1]),
}
TILES = [128, 4096, 8192]


def _runs(rows, dead=5):
    """``runs`` of spans with these row counts, then a sentinel span of
    ``dead`` rows padded to whole segments; and nseg."""
    live = int(np.sum(rows))
    nseg = -(-(live + dead) // SEG)
    runs = np.concatenate([[0], np.cumsum(rows), [nseg * SEG]])
    return torch.as_tensor(runs, dtype=torch.int32), nseg


def _partial(runs, p_rows, nseg, tile, seed):
    """Random tiles at every live span's slots, NaN at the others."""
    gen = torch.Generator().manual_seed(seed)
    part = torch.full((nseg + p_rows, tile), float("nan"))
    n, first = span_tiles(runs, p_rows, SEG)
    for j in range(p_rows):
        lo, hi = int(first[j]), int(first[j] + n[j])
        part[lo:hi] = torch.randn((hi - lo, tile), generator=gen)
    return part


def _per_span_sum(runs, part, p_rows):
    n, first = span_tiles(runs, p_rows, SEG)
    return torch.stack([part[int(f):int(f + k)].double().sum(0)
                        for f, k in zip(first, n)])


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_schedule_model_matches_per_span_sum(layout, tile):
    rows, chunk, want_chunks = LAYOUTS[layout]
    runs, nseg = _runs(rows)
    p_rows = len(rows)
    part = _partial(runs, p_rows, nseg, tile, len(rows) + tile)
    before = part.clone()
    acc, nch = span_reduce_sched_plain(runs, part, p_rows=p_rows, seg=SEG,
                                       chunk=chunk)
    assert torch.equal(part.isnan(), before.isnan())  # input untouched
    assert nch.tolist() == want_chunks
    want = _per_span_sum(runs, part, p_rows)
    assert not acc.isnan().any()
    scale = want.abs().max().item()
    assert (acc.double() - want).abs().max().item() <= 1e-6 * scale
    single, nch1 = span_reduce_sched_plain(runs, part, p_rows=p_rows,
                                           seg=SEG, chunk=0)
    assert (nch1 == 1).all()
    assert (acc - single).abs().max().item() <= 1e-5 * scale
    assert (acc[nch == 1] == single[nch == 1]).all()  # same order there
    n, _ = span_tiles(runs, p_rows, SEG)
    assert (acc[n == 0] == 0).all()


def test_single_pass_is_segment_order_per_thread_group():
    """At chunk 0 and wide tiles (one thread group) acc[j] is the float32
    sum of the span's tiles in segment order, added one by one."""
    rows = [8 * 11 + 3, 0, 5]
    runs, nseg = _runs(rows)
    part = _partial(runs, 3, nseg, 4096, 3)
    acc, _ = span_reduce_sched_plain(runs, part, p_rows=3, seg=SEG, chunk=0)
    n, first = span_tiles(runs, 3, SEG)
    for j in range(3):
        want = torch.zeros(4096)
        for slot in range(int(first[j]), int(first[j] + n[j])):
            want = want + part[slot]
        assert torch.equal(acc[j], want)


# name: (nseg, p_rows, chunk); the rule takes any tile's width
RULE_CASES = {
    "e11m train i1 (B6, tile 4096), B=65536": (20480, 220, 144),
    "e11m train i2 (B3, folded tile 128), B=65536": (20480, 250, 144),
    "dcnv2 train i1 (B6, T=5, tile 8192), B=8192": (19072, 2000, 146),
    "headline i1, B=512": (160, 220, 20),
    "one segment": (1, 220, 0),
    "fewer segments than the rule's chunk": (12, 200, 0),
}


@pytest.mark.parametrize("name", list(RULE_CASES))
def test_chunk_rule_at_the_cells_shapes(name):
    nseg, p_rows, want = RULE_CASES[name]
    chunk = span_chunk(nseg, p_rows)
    assert chunk == want
    if chunk:
        # both passes' chains are at most ~sqrt(nseg + p_rows) tiles
        assert (chunk - 1) ** 2 < nseg + p_rows <= chunk ** 2
        assert chunk < nseg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_bounds_hold(seed):
    """The chunks in all and the split spans stay within the bounds the
    launch sizes its grids and scratch by."""
    rng = np.random.default_rng(seed)
    p_rows = int(rng.integers(20, 300))
    rows = rng.zipf(1.3, p_rows) * rng.integers(0, 2, p_rows)
    rows[0] += 4000
    runs, nseg = _runs(rows)
    for chunk in (1, 2, 7, span_chunk(nseg, p_rows)):
        n, _ = span_tiles(runs, p_rows, SEG)
        nch = torch.clamp(-(-n // chunk), min=1)
        assert int(n.sum()) <= nseg + p_rows
        assert int(nch.sum()) <= reduce_sched_ints(nseg, p_rows, chunk) \
            - 2 * p_rows - 3
        assert int((nch > 1).sum()) <= (nseg + p_rows) // (chunk + 1)


def _pass_case(rows, blocks, bw_x, bw_y, seed):
    runs, nseg = _runs(rows)
    p_rows = len(rows)
    first, cnt = segment_spans(runs, nseg, SEG)
    gen = torch.Generator().manual_seed(seed)
    nza = nseg * SEG
    x = torch.randn((nza, blocks * bw_x), generator=gen)
    y = torch.randn((nza, blocks * bw_y), generator=gen)
    table = torch.randn((p_rows * bw_x, bw_y), generator=gen)
    return runs, first, cnt, x, y, table, nseg


# a hot span of 100 segments: the rule splits it (nseg ~ 120, chunk ~ 12)
HOT_ROWS = [SEG * 100 + 3, 17, 0, 40, 2, SEG * 13]


def _call(entry, rows):
    runs, first, cnt, x, y, table, nseg = _pass_case(rows, 2, 8, 16, 5)
    p_rows = len(rows)
    kw = dict(blocks=2, bw_x=8, bw_y=16, p_rows=p_rows, seg=SEG)
    if entry == "seg_accum":
        seg_accum(runs, first, cnt, x, y, table, **kw)
    elif entry == "seg_fused_i2":
        seg_fused_i2(runs, first, cnt, x, y, table, **kw)
    elif entry == "seg_accum_dg0":
        i0c = torch.zeros(x.shape[0], dtype=torch.int32)
        seg_accum_dg0(runs, first, cnt, x, y, i0c, table, tp0=4, **kw)
    else:
        span_reduce(runs, _partial(runs, p_rows, nseg, 8 * 16, 9),
                    p_rows=p_rows, seg=SEG)
    return runs, nseg, p_rows


@pytest.mark.parametrize("entry", ["seg_accum", "seg_fused_i2",
                                   "seg_accum_dg0", "span_reduce"])
def test_split_spans_counted_while_spans_are_on(entry):
    profiling.reset()
    try:
        runs, nseg, p_rows = _call(entry, HOT_ROWS)
        assert profiling.counter(SPLIT_SPANS) == 0  # no profiler: off
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            _call(entry, HOT_ROWS)
        chunk = span_chunk(nseg, p_rows)
        assert 0 < chunk < 100
        part = _partial(runs, p_rows, nseg, 8 * 16, 1)
        _, nch = span_reduce_sched_plain(runs, part, p_rows=p_rows, seg=SEG)
        assert int((nch > 1).sum()) == 2
        assert profiling.counter(SPLIT_SPANS) == 2
    finally:
        profiling.reset()


def test_span_reduce_cpu_route_and_checks():
    rows = [SEG * 30, 3, 0, SEG * 2 + 1]
    runs, nseg = _runs(rows)
    part = _partial(runs, 4, nseg, 4096, 4)
    acc = span_reduce(runs, part, p_rows=4, seg=SEG)
    want, _ = span_reduce_sched_plain(runs, part, p_rows=4, seg=SEG)
    assert torch.equal(acc, want)
    with pytest.raises(ValueError, match="span_reduce"):
        span_reduce(runs, part.double(), p_rows=4, seg=SEG)
    with pytest.raises(ValueError, match="span_reduce"):
        span_reduce(runs, part[:, :30], p_rows=4, seg=SEG)
    with pytest.raises(ValueError, match="span_reduce"):
        span_reduce(runs.long(), part, p_rows=4, seg=SEG)
