"""Kernel B6 (``seg_accum_dg0``) on the card, and the backward's default
route to it. No JAX here: these tests run on the H100 with

    python -m pytest tests/test_torch_port_dg0_card.py -m card --noconftest

and skip inside the test without a card.

- B6 at the training cell's i1 pass (B=65536, pooling 20, ids Zipf(1.05)
  over the 11M-row table as ``h100_bench`` draws them; nseg 20480, tp0
  200, row 0 keyed in nearly every segment): twice bitwise equal, acc
  against B3's, dG0 against the float32 one-hot product of B3's dz0
  (max |difference| within 1e-5 of max |dG0|: both are float32 sums of
  ~600k rows for row 0, in different orders);
- B6 bitwise equal to its schedule's plain model
  (``seg_accum_dg0_sched_plain``, run on a CPU copy) at the headline
  widths, nseg 600, tp0 4096: kernel 3 in chunks of 64 segments, more
  chunks than thread groups, row 0 in every segment. Each row's dz0 is
  one product (one nonzero y per block) and keys are distinct within a
  segment, so kernel 1's partials are exact and only kernel 3's order of
  adds decides the bits;
- ``FBTT_DG0`` unset: a flat lookup's backward launches B6 once and B3
  only above pass 1, and its gradients match "onehot"'s;
- kernel 2, the span reduce (``span_reduce``), at the training cell's i1
  spans (span 0 in about a quarter of the segments: split into chunks),
  tiles of 128, 4096 and 8192 floats: twice bitwise equal, bitwise equal
  to its schedule's plain model (``span_reduce_sched_plain``) run on a CPU
  copy of ``partial``, within 1e-5 of max |acc| of the single pass's order,
  never reading a slot no span owns (NaN there); B3 twice bitwise there,
  and ``span_reduce.split_spans`` counting, while a profiler records, the
  spans the model splits.
"""

import numpy as np
import pytest
import torch

from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import (
    SPLIT_SPANS,
    seg_accum,
    span_chunk,
    span_reduce,
    span_reduce_sched_plain,
    span_tiles,
)
from fbtt_embedding_tpu_torch.ops.kernels.seg_accum_dg0 import (
    _THREADS,
    dg0_chunk,
    seg_accum_dg0,
    seg_accum_dg0_sched_plain,
)
from fbtt_embedding_tpu_torch.ops.kernels.tt_flat import (
    SEG,
    SPAN_BLOCK,
    _span_table,
)
from fbtt_embedding_tpu_torch.utils import profiling

P, Q, R = (200, 220, 250), (4, 4, 4), (1, 32, 32, 1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return torch.device("cuda")


def _train_i1_pass(seed, dev, nnz=65536 * 20):
    """B6's arguments on the training cell's i1 pass, bfloat16: lookups
    sorted by i1, random x, y and G1 slabs."""
    from h100_bench.inputs import torch_gen, zipf

    gen = torch_gen(seed, 0, dev)
    ids = zipf(gen, 1.05, nnz, dev) % int(np.prod(P))
    i1 = (ids // P[2]) % P[1]
    order = torch.sort(i1, stable=True).indices
    keys = i1[order].to(torch.int32)
    i0c = (ids[order] // (P[1] * P[2])).to(torch.int32)
    runs, first, cnt = _span_table(keys, P[1], nnz // SEG)
    x = (torch.randn((nnz, Q[0] * R[1]), generator=gen, device=dev)
         * 0.05).to(torch.bfloat16)
    y = (torch.randn((nnz, Q[0] * Q[1] * R[2]), generator=gen, device=dev)
         * 0.05).to(torch.bfloat16)
    table = (torch.randn(((P[1] + SPAN_BLOCK) * R[1], Q[1] * R[2]),
                         generator=gen, device=dev) * 0.1)
    table[P[1] * R[1]:] = 0
    return runs, first, cnt, x, y, i0c, table.to(torch.bfloat16)


@pytest.mark.card
def test_b6_at_the_training_shape(card):
    runs, first, cnt, x, y, i0c, table = _train_i1_pass(2027, card)
    kw = dict(blocks=Q[0], bw_x=R[1], bw_y=Q[1] * R[2], p_rows=P[1],
              seg=SEG)
    assert (i0c.view(-1, SEG) == 0).any(1).float().mean() > 0.95
    acc, dg0 = seg_accum_dg0(runs, first, cnt, x, y, i0c, table,
                             tp0=P[0], **kw)
    acc2, dg02 = seg_accum_dg0(runs, first, cnt, x, y, i0c, table,
                               tp0=P[0], **kw)
    assert torch.equal(acc, acc2) and torch.equal(dg0, dg02)
    b3_acc, z = seg_accum(runs, first, cnt, x, y, table,
                          z_dtype=torch.float32, **kw)
    b3_acc2, z2 = seg_accum(runs, first, cnt, x, y, table,
                            z_dtype=torch.float32, **kw)
    assert torch.equal(b3_acc, b3_acc2) and torch.equal(z, z2)
    del z2
    iota = torch.arange(P[0], dtype=torch.int32, device=card)
    want = torch.matmul((i0c[:, None] == iota[None, :]).float().t(), z)
    err = ((dg0 - want).abs().max() / want.abs().max()).item()
    assert err <= 1e-5, err
    acc_err = ((acc - b3_acc).abs().max() / b3_acc.abs().max()).item()
    assert acc_err <= 1e-6, acc_err


def _exact_partials_case(nseg, tp0, p_rows, seed):
    """CPU inputs of B6 at the headline widths whose keyed partials are
    exact: one nonzero y per row and block (dz0 is one bfloat16 product),
    keys distinct within a segment and 0 in each; a sentinel tail."""
    blocks, bw_x, bw_y = Q[0], R[1], Q[1] * R[2]
    nza = nseg * SEG
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, p_rows, size=nza))
    keys[-SEG - 5:] = p_rows
    i0c = np.concatenate([
        np.concatenate([[0], 1 + rng.choice(tp0 - 1, SEG - 1, replace=False)])
        for _ in range(nseg)]).astype(np.int32)
    i0c[keys >= p_rows] = tp0
    y = np.zeros((nza, blocks, bw_y), dtype=np.float32)
    y[np.arange(nza)[:, None], np.arange(blocks)[None, :],
      rng.integers(0, bw_y, size=(nza, blocks))] = rng.standard_normal(
          (nza, blocks))
    table = rng.standard_normal(((p_rows + SPAN_BLOCK) * bw_x, bw_y))
    table[p_rows * bw_x:] = 0
    runs, first, cnt = _span_table(torch.as_tensor(keys.astype(np.int32)),
                                   p_rows, nseg)
    bf16 = torch.bfloat16
    x = torch.as_tensor(rng.standard_normal((nza, blocks * bw_x))).to(bf16)
    return (runs, first, cnt, x, torch.as_tensor(y.reshape(nza, -1)).to(bf16),
            torch.as_tensor(i0c), torch.as_tensor(table).to(bf16))


@pytest.mark.card
def test_b6_bitwise_its_schedule_model(card):
    nseg, tp0, p_rows = 600, 4096, 40
    args = _exact_partials_case(nseg, tp0, p_rows, 600)
    kw = dict(blocks=Q[0], bw_x=R[1], bw_y=Q[1] * R[2], p_rows=p_rows,
              tp0=tp0, seg=SEG)
    chunk = dg0_chunk(nseg, tp0)
    assert chunk == 64
    assert -(-nseg // chunk) > _THREADS // (Q[0] * R[1] // 4)
    want_acc, want_dg0, part, part_key = seg_accum_dg0_sched_plain(*args,
                                                                   **kw)
    assert (part_key[:-1, 0] == 0).all()  # row 0 in every segment
    # the order shows: the partials' float64 sum, rounded once, differs
    kept = part_key.reshape(-1) < tp0
    exact = torch.zeros(want_dg0.shape, dtype=torch.float64).index_add_(
        0, part_key.reshape(-1)[kept].long(),
        part.reshape(-1, part.shape[-1])[kept].double())
    assert not torch.equal(want_dg0, exact.float())
    acc, dg0 = seg_accum_dg0(*(a.to(card) for a in args), **kw)
    assert torch.equal(dg0.cpu(), want_dg0)
    acc_err = ((acc.cpu() - want_acc).abs().max()
               / want_acc.abs().max()).item()
    assert acc_err <= 1e-5, acc_err


@pytest.mark.card
def test_default_backward_launches_b6(card, monkeypatch):
    import fbtt_embedding_tpu_torch as fbt
    from fbtt_embedding_tpu_torch.ops.lookup import pooled_tt_lookup

    p, q, b, pooling = [20, 22, 25], [4, 4, 4], 512, 20
    rng = np.random.default_rng(7)
    cores = fbt.init_tt_cores(rng, "uniform", 1, int(np.prod(p)), 64, p, q,
                              list(R))
    nnz = b * pooling
    idx = torch.as_tensor((rng.zipf(1.05, nnz) - 1) % int(np.prod(p)),
                          device=card)
    rowidx = torch.arange(nnz, device=card, dtype=torch.int32) // pooling
    d_out = torch.as_tensor(rng.standard_normal((1, b, 64)),
                            dtype=torch.float32, device=card)
    grads = {}
    for mode in ("onehot", None):
        if mode is None:
            monkeypatch.delenv("FBTT_DG0", raising=False)
        else:
            monkeypatch.setenv("FBTT_DG0", mode)
        leaves = [torch.as_tensor(c, device=card).requires_grad_()
                  for c in cores]
        out = pooled_tt_lookup(leaves, p, q, R, b, idx, rowidx,
                               impl="pallas_sorted")
        before = {k: profiling.counter(f"launches.{k}")
                  for k in ("seg_accum", "seg_accum_dg0")}
        grads[mode] = torch.autograd.grad(out, leaves, d_out)
        torch.cuda.synchronize()
        got = {k: profiling.counter(f"launches.{k}") - v
               for k, v in before.items()}
        assert got == ({"seg_accum": 2, "seg_accum_dg0": 0}
                       if mode == "onehot"
                       else {"seg_accum": 1, "seg_accum_dg0": 1}), got
    for a, b_ in zip(grads[None], grads["onehot"]):
        scale = b_.abs().max()
        assert ((a - b_).abs().max() / scale).item() <= 1e-5


@pytest.mark.card
@pytest.mark.parametrize("tile", [128, 4096, 8192])
def test_span_reduce_bitwise_its_schedule_model(card, tile):
    runs, first, cnt = _train_i1_pass(3030, card)[:3]
    nseg, p_rows = first.shape[0], P[1]
    chunk = span_chunk(nseg, p_rows)
    n, slot = span_tiles(runs, p_rows, SEG)
    assert chunk > 0 and int(n.max()) > 20 * chunk  # span 0 splits
    gen = torch.Generator(device=card)
    gen.manual_seed(tile)
    owned = torch.zeros(nseg + p_rows, dtype=torch.bool, device=card)
    for j in range(p_rows):
        owned[int(slot[j]):int(slot[j] + n[j])] = True
    partial = torch.where(
        owned[:, None],
        torch.randn((nseg + p_rows, tile), generator=gen, device=card),
        torch.full((), float("nan"), device=card))
    got = span_reduce(runs, partial.clone(), p_rows=p_rows, seg=SEG)
    again = span_reduce(runs, partial.clone(), p_rows=p_rows, seg=SEG)
    assert torch.equal(got, again)
    host = partial.cpu()
    want, nch = span_reduce_sched_plain(runs.cpu(), host, p_rows=p_rows,
                                        seg=SEG)
    assert int(nch.max()) > 1
    assert torch.equal(got.cpu(), want)
    single, _ = span_reduce_sched_plain(runs.cpu(), host, p_rows=p_rows,
                                        seg=SEG, chunk=0)
    err = ((want - single).abs().max() / want.abs().max()).item()
    assert err <= 1e-5, err


@pytest.mark.card
def test_split_spans_counted_on_the_card(card):
    runs, first, cnt, x, y, i0c, table = _train_i1_pass(4040, card)
    kw = dict(blocks=Q[0], bw_x=R[1], bw_y=Q[1] * R[2], p_rows=P[1],
              seg=SEG)
    nseg = first.shape[0]
    chunk = span_chunk(nseg, P[1])
    want = int((span_tiles(runs, P[1], SEG)[0] > chunk).sum())
    assert want >= 1
    profiling.reset()
    try:
        seg_accum_dg0(runs, first, cnt, x, y, i0c, table, tp0=P[0], **kw)
        assert profiling.counter(SPLIT_SPANS) == 0  # no profiler: off
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            seg_accum_dg0(runs, first, cnt, x, y, i0c, table, tp0=P[0],
                          **kw)
        assert profiling.counter(SPLIT_SPANS) == want
    finally:
        profiling.reset()
