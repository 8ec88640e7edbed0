"""PyTorch port vs the JAX package: kernel B6 and ``FBTT_DG0`` (CPU).

- B6's plain version (``seg_accum_dg0_plain``: B3's plain pass and a
  float32 one-hot dG0) against the Pallas kernel ``_seg_accum_i1`` in
  interpret mode, rtol = atol = 1e-5, with a sentinel tail of dead rows;
- the plain model of the kernels' schedule (``seg_accum_dg0_sched_plain``:
  per-segment keyed partial rows, the fixed-order reduces) against both,
  rtol = atol = 1e-5: a sentinel tail, Zipf first-core rows with the hot
  row in every segment, T=2, a tt_ndim-4 first pass, keys >= tp0 inside
  live spans and valid keys on the sentinel span's rows;
- the path rule's Python copy (``dg0_path``) on both sides of each limit;
- ``flat_train_apply`` and the ``FlatLookup`` backward by default (B6)
  against the JAX package's own under ``FBTT_DG0=fused``, the JAX
  knob's value for its B6 (interpret mode), float32, rtol 1e-6: dead
  masks, pair mode, tt_ndim 2, 3 and 4, two tables; and ``FBTT_DG0``
  routing (B6 replaces B3 on the i1 pass by default; "onehot" gives it
  back);
- the knob registry and the wrapper's input checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbtt_embedding_tpu.ops.pallas import tt_flat as jflat
from fbtt_embedding_tpu_torch.ops.kernels import tt_flat as tflat
from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import seg_accum
from fbtt_embedding_tpu_torch.ops.kernels.seg_accum_dg0 import (
    PATH_NAMES,
    dg0_fits,
    dg0_path,
    seg_accum_dg0,
    seg_accum_dg0_plain,
    seg_accum_dg0_sched_plain,
)
from fbtt_embedding_tpu_torch.ops.lookup import pooled_tt_lookup as t_lookup
from fbtt_embedding_tpu_torch.utils import knobs
from fbtt_embedding_tpu_torch.utils import profiling as tprof
from test_torch_port_flat import CASES, make_case
from test_torch_port_train import _d_out, _j, _pass_inputs, _t

TIGHT = dict(rtol=1e-5, atol=1e-5)
FUSED = dict(rtol=1e-6, atol=1e-7)  # the JAX suite's FBTT_DG0 tolerance


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# blocks, bw_x (r1), bw_y, p_rows (T*p1), nza, seg, tp0 (T*p0)
DG0_SHAPES = [
    (4, 32, 128, 22, 512, 128, 20),   # the headline i1 pass, narrowed
    (2, 8, 16, 11, 384, 128, 7),
    (8, 8, 8, 40, 256, 64, 30),       # tt_ndim 2's only pass
    (4, 8, 64, 30, 256, 64, 40),      # T=2: tp0 = 2 * p0
]


def _dg0_inputs(shape):
    """B3's pass inputs plus first-core rows: random in [0, tp0) on the
    live rows, the sentinel tp0 on the sentinel span's rows."""
    blocks, bw_x, bw_y, p_rows, nza, seg, tp0 = shape
    keys, jtabs, ttabs, x, y, table = _pass_inputs(shape[:6], False)
    rng = np.random.default_rng(sum(shape))
    i0c = rng.integers(0, tp0, size=nza).astype(np.int32)
    i0c[keys >= p_rows] = tp0
    return keys, jtabs, ttabs, x, y, table, i0c


@pytest.mark.parametrize("shape", DG0_SHAPES)
def test_seg_accum_dg0_plain_matches_pallas_kernel(shape):
    blocks, bw_x, bw_y, p_rows, nza, seg, tp0 = shape
    keys, jtabs, ttabs, x, y, table, i0c = _dg0_inputs(shape)
    assert (keys >= p_rows).any()  # a sentinel tail is exercised
    want_acc, want_dg0 = jflat._seg_accum_i1(
        nza // seg, blocks, bw_x, bw_y, p_rows, tp0, "float32", True,
        *jtabs, jnp.asarray(x), jnp.asarray(y), jnp.asarray(i0c),
        jnp.asarray(table), seg=seg)
    kw = dict(blocks=blocks, bw_x=bw_x, bw_y=bw_y, p_rows=p_rows, tp0=tp0,
              seg=seg)
    args = (*ttabs, torch.as_tensor(x), torch.as_tensor(y),
            torch.as_tensor(i0c), torch.as_tensor(table))
    acc, dg0 = seg_accum_dg0_plain(*args, **kw)
    assert acc.dtype == dg0.dtype == torch.float32
    assert dg0.shape == (tp0, blocks * bw_x)
    np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc), **TIGHT)
    np.testing.assert_allclose(dg0.numpy(), np.asarray(want_dg0), **TIGHT)
    # acc is B3's; dG0 is the one-hot sum of B3's float32 z
    b3_acc, z = seg_accum(*args[:5], args[6], blocks=blocks, bw_x=bw_x,
                          bw_y=bw_y, p_rows=p_rows, seg=seg,
                          z_dtype=torch.float32)
    assert torch.equal(acc, b3_acc)
    live = i0c < tp0
    want = np.zeros((tp0, blocks * bw_x), np.float32)
    np.add.at(want, i0c[live], z.numpy()[live])
    np.testing.assert_allclose(dg0.numpy(), want, **TIGHT)
    # the wrapper takes the plain version on the CPU and launches nothing
    before = tprof.counter("launches.seg_accum_dg0")
    acc2, dg02 = seg_accum_dg0(*args, **kw)
    assert tprof.counter("launches.seg_accum_dg0") == before
    assert torch.equal(acc, acc2) and torch.equal(dg0, dg02)


def test_seg_accum_dg0_checks_inputs():
    shape = (2, 8, 8, 10, 128, 64, 9)
    _, _, ttabs, x, y, table, i0c = _dg0_inputs(shape)
    x, y, table, i0c = (torch.as_tensor(a) for a in (x, y, table, i0c))
    kw = dict(blocks=2, bw_x=8, bw_y=8, p_rows=10, tp0=9, seg=64)
    seg_accum_dg0(*ttabs, x, y, i0c, table, **kw)  # well-formed: runs
    for bad in (dict(i0c=i0c.long()), dict(i0c=i0c[:64]),
                dict(y=y[:, :8]), dict(table=table[:8])):
        a = dict(x=x, y=y, i0c=i0c, table=table, **{})
        a.update(bad)
        with pytest.raises(ValueError):
            seg_accum_dg0(*ttabs, a["x"], a["y"], a["i0c"], a["table"], **kw)
    with pytest.raises(ValueError):  # neither cpu nor cuda: no fallback
        seg_accum_dg0(*[t.to("meta") for t in ttabs], x.to("meta"),
                      y.to("meta"), i0c.to("meta"), table.to("meta"), **kw)


def test_dg0_gate_and_knobs(monkeypatch):
    f32, bf16 = torch.float32, torch.bfloat16
    gate = tflat._dg0_fused_gate
    # unset: B6 wherever a path takes the widths; where none does (the
    # CUDA-core path's float32 dz0 tile passes 128 KB of shared memory:
    # q0*r1 = 544 > 512 at seg 64), the one-hot
    monkeypatch.delenv("FBTT_DG0", raising=False)
    assert gate(bf16, 4, 32, 128) and gate(f32, 4, 32, 128)
    assert gate(f32, 4, 128, 128)
    assert not gate(f32, 4, 136, 128) and not gate(bf16, 4, 136, 128)
    # "onehot": B3 and the one-hot product at every width
    monkeypatch.setenv("FBTT_DG0", "onehot")
    assert not gate(bf16, 4, 32, 128) and not gate(f32, 4, 128, 128)
    assert dg0_fits(False, 64, 4, 128, 128)
    assert not dg0_fits(False, 64, 4, 136, 128)
    assert knobs.get_str("FBTT_DG0") == "onehot"
    assert knobs.PERF_KNOBS["FBTT_DG0"][1] == "B6 where dg0_fits"
    with pytest.raises(KeyError):
        knobs.get_str("FBTT_SEG")  # the TPU's knobs are not carried over


# blocks, bw_x, bw_y, seg, in bfloat16, path taken (2 tensor cores with
# dz0 over y, 1 tensor cores with a dz0 tile, 0 CUDA cores, -1 none): each
# limit of the rule from both sides
PATH_RULE_CASES = [
    (4, 32, 128, 64, True, 2),      # the headline i1 pass
    (4, 32, 128, 64, False, 0),     # float32: the CUDA cores
    (4, 24, 128, 64, True, 0),      # bw_x not a multiple of 16
    (4, 32, 64, 64, True, 2),       # 2*bw_x <= bw_y + 8 ...
    (4, 32, 48, 64, True, 1),       # ... or the dz0 tile
    (1, 64, 160, 64, True, 2),      # bw_x <= 64 ...
    (1, 80, 160, 64, True, 1),      # ... or the dz0 tile
    (4, 32, 320, 64, True, 2),      # B3's staging within 227 KB ...
    (4, 32, 336, 64, True, 0),      # ... or the CUDA cores
    (4, 80, 80, 64, True, 1),       # staging and dz0 tile within 227 KB ...
    (4, 96, 80, 64, True, 0),       # ... or the CUDA cores
    (1, 32, 128, 16, True, 2),      # seg * blocks a multiple of 16 ...
    (1, 32, 128, 8, True, 0),       # ... or the CUDA cores
    (4, 128, 128, 64, False, 0),    # the CUDA cores' dz0 tile <= 128 KB ...
    (4, 136, 128, 64, False, -1),   # ... or no path
    (32, 32, 64, 16, True, 2),      # blocks * bw_x <= 1024 ...
    (34, 32, 64, 16, True, -1),     # ... or no path
    (1, 8, 2048, 1, False, 0),      # widths up to 2048 ...
    (1, 8, 2056, 1, False, -1),     # ... or no path
]


@pytest.mark.parametrize("blocks,bw_x,bw_y,seg,bf16,want", PATH_RULE_CASES)
def test_dg0_path_rule(blocks, bw_x, bw_y, seg, bf16, want):
    got = dg0_path(bf16, seg, blocks, bw_x, bw_y)
    assert got == want, (got, PATH_NAMES.get(got))
    assert dg0_fits(bf16, seg, blocks, bw_x, bw_y) == (want >= 0)


# name, (blocks, bw_x (r1), bw_y, p_rows (T*p1), nza, seg, tp0 (T*p0))
SCHED_CASES = [
    ("sentinel tail", (4, 16, 32, 22, 512, 64, 20)),
    ("zipf i0, hot row in every segment", (4, 16, 32, 22, 512, 64, 20)),
    ("T=2", (4, 8, 64, 2 * 15, 256, 64, 2 * 20)),
    # q=[2,2,2,2], ranks [8,8,8] (test_torch_port_flat CASES[7]), pass 1
    ("ndim4 pass 1", (2, 8, 16, 9, 256, 64, 8)),
    ("keys >= tp0 in live spans", (2, 8, 16, 12, 256, 64, 10)),
]


def _sched_inputs(name, shape):
    keys, jtabs, ttabs, x, y, table, i0c = _dg0_inputs(shape)
    p_rows, nza, seg, tp0 = shape[3], shape[4], shape[5], shape[6]
    rng = np.random.default_rng(len(name))
    live = keys < p_rows
    if name.startswith("zipf"):
        i0c = ((rng.zipf(1.05, size=nza) - 1) % tp0).astype(np.int32)
        i0c[::seg] = 0  # the hot row has a row in every segment
        assert live[::seg].all()
        i0c[~live] = tp0
    if name.startswith("keys"):
        bad = rng.choice(np.flatnonzero(live), size=8, replace=False)
        i0c[bad[:4]] = tp0
        i0c[bad[4:]] = tp0 + 5
        # the sentinel span's rows carry valid keys: dropped all the same
        i0c[~live] = rng.integers(0, tp0, size=int((~live).sum()))
    return keys, jtabs, ttabs, x, y, table, i0c


@pytest.mark.parametrize("name,shape", SCHED_CASES)
def test_dg0_schedule_model_matches_plain_and_pallas(name, shape):
    blocks, bw_x, bw_y, p_rows, nza, seg, tp0 = shape
    keys, jtabs, ttabs, x, y, table, i0c = _sched_inputs(name, shape)
    assert (keys >= p_rows).any()  # a sentinel tail is exercised
    want_acc, want_dg0 = jflat._seg_accum_i1(
        nza // seg, blocks, bw_x, bw_y, p_rows, tp0, "float32", True,
        *jtabs, jnp.asarray(x), jnp.asarray(y), jnp.asarray(i0c),
        jnp.asarray(table), seg=seg)
    kw = dict(blocks=blocks, bw_x=bw_x, bw_y=bw_y, p_rows=p_rows, tp0=tp0,
              seg=seg)
    args = (*ttabs, torch.as_tensor(x), torch.as_tensor(y),
            torch.as_tensor(i0c), torch.as_tensor(table))
    acc, dg0, part, part_key = seg_accum_dg0_sched_plain(*args, **kw)
    plain_acc, plain_dg0 = seg_accum_dg0_plain(*args, **kw)
    for got, want in ((acc, plain_acc), (dg0, plain_dg0),
                      (acc, np.asarray(want_acc)),
                      (dg0, np.asarray(want_dg0))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    # the keyed rows: ascending distinct keys in [0, tp0), then INT_MAX;
    # each segment's count is its live rows' distinct keys
    nseg = nza // seg
    kept = (keys < p_rows) & (i0c >= 0) & (i0c < tp0)
    pk = part_key.numpy()
    for s in range(nseg):
        sl = slice(s * seg, (s + 1) * seg)
        want_keys = np.unique(i0c[sl][kept[sl]])
        n = want_keys.size
        np.testing.assert_array_equal(pk[s, :n], want_keys)
        assert (pk[s, n:] == np.iinfo(np.int32).max).all()
        assert not part[s, n:].any()
    if name.startswith("zipf"):
        assert (pk[:, 0] == 0).all()  # the hot row's partial in every segment


def _hot_row_check(blocks, bw_x, bw_y, p_rows, seg, tp0, nseg, chunk):
    """Kernel 3's schedule past one chunk and one group, the hot row keyed
    in every segment, against the plain version (dG0, a float32 sum of up
    to ~2000 rows a row in another order: max |difference| within 1e-5 of
    max |dG0|), and bitwise equal run to run; ``dg0_chunk`` gives
    ``chunk``, and there are more chunks than thread groups."""
    from fbtt_embedding_tpu_torch.ops.kernels.seg_accum_dg0 import (
        _THREADS,
        dg0_chunk,
    )

    nza = nseg * seg
    rng = np.random.default_rng(nseg)
    keys = np.sort(rng.integers(0, p_rows, size=nza))
    keys[-seg - 3:] = p_rows  # a sentinel tail
    i0c = ((rng.zipf(1.3, size=nza) - 1) % tp0).astype(np.int32)
    i0c[::seg] = 0  # the hot row has a row in every segment
    i0c[keys >= p_rows] = tp0
    i0c[-seg - 3:-seg] = 0
    runs, first, cnt = tflat._span_table(
        torch.as_tensor(keys.astype(np.int32)), p_rows, nseg, seg=seg)
    x = torch.as_tensor(rng.standard_normal((nza, blocks * bw_x)),
                        dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal((nza, blocks * bw_y)),
                        dtype=torch.float32)
    table = torch.as_tensor(
        rng.standard_normal(((p_rows + tflat.SPAN_BLOCK) * bw_x, bw_y)),
        dtype=torch.float32)
    args = (runs, first, cnt, x, y, torch.as_tensor(i0c), table)
    kw = dict(blocks=blocks, bw_x=bw_x, bw_y=bw_y, p_rows=p_rows, tp0=tp0,
              seg=seg)
    assert dg0_chunk(nseg, tp0) == chunk
    groups = _THREADS // (blocks * bw_x // 4)
    assert -(-nseg // chunk) > groups  # many chunks in every group
    acc, dg0, _, part_key = seg_accum_dg0_sched_plain(*args, **kw)
    assert (part_key[:-1, 0] == 0).all()  # the hot row in every segment
    want_acc, want_dg0 = seg_accum_dg0_plain(*args, **kw)
    torch.testing.assert_close(acc, want_acc, **TIGHT)
    err = (dg0 - want_dg0).abs().max() / want_dg0.abs().max()
    assert err <= 1e-5, err
    acc2, dg02, _, _ = seg_accum_dg0_sched_plain(*args, **kw)
    assert torch.equal(acc, acc2) and torch.equal(dg0, dg02)


def test_dg0_schedule_model_hot_row_over_many_chunks():
    """Chunks of 8 segments (``dg0_chunk``'s floor), nseg > 2048."""
    _hot_row_check(2, 8, 8, 40, 4, 40, 2056, chunk=8)


def test_dg0_schedule_model_hot_row_at_chunk_64():
    """Chunks of 64 segments (``dg0_chunk``'s cap, which the training
    cell's i1 pass takes), more of them than the headline widths' eight
    thread groups."""
    _hot_row_check(4, 32, 8, 40, 4, 4096, 600, chunk=64)


def _count(monkeypatch):
    """Count the plain calls behind seg_accum and seg_accum_dg0 in the
    flat pipeline (the CPU runs no kernel)."""
    calls = {"seg_accum": 0, "seg_accum_dg0": 0}

    def wrap(name, fn):
        def inner(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return inner

    monkeypatch.setattr(tflat, "seg_accum",
                        wrap("seg_accum", tflat.seg_accum))
    monkeypatch.setattr(tflat, "seg_accum_dg0",
                        wrap("seg_accum_dg0", tflat.seg_accum_dg0))
    return calls


# (CASES index, dead mask, seed): tt_ndim 3, two tables, tt_ndim 2, 4
APPLY_CASES = [(1, True, 21), (2, False, 3), (5, True, 4), (6, False, 5),
               (7, True, 6), (8, False, 7)]


@pytest.mark.parametrize("cid,dead,seed", APPLY_CASES)
def test_flat_train_apply_dg0_fused_matches_jax(monkeypatch, cid, dead,
                                                seed):
    monkeypatch.setenv("FBTT_DG0", "fused")  # JAX's B6; the port's default
    case = CASES[cid]
    rfull, cores, idx, rowidx, tab, w = make_case(**case, seed=seed)
    p, q, T, b = case["p"], case["q"], case.get("T", 1), case["b"]
    nnz = idx.shape[0]
    dmask = (np.arange(nnz) % 5 == 0) if dead else None
    d_out = _d_out(T, b, int(np.prod(q)))
    want_out, want = jflat.flat_train_apply(
        tuple(jnp.asarray(c) for c in cores), p, q, rfull, b, _j(idx),
        _j(rowidx), _j(tab), _j(w), _j(dmask), jnp.asarray(d_out),
        interpret=True)
    calls = _count(monkeypatch)
    out, got = tflat.flat_train_apply(
        [torch.as_tensor(c) for c in cores], p, q, rfull, b, _t(idx),
        _t(rowidx), _t(tab), _t(w), _t(dmask), torch.as_tensor(d_out))
    # tt_ndim 2: B2 is the only pass and dG0 stays the one-hot product
    assert calls["seg_accum_dg0"] == (len(p) > 2)
    assert calls["seg_accum"] == max(len(p) - 3, 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **FUSED)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **FUSED)


def test_flat_train_apply_dg0_fused_pair_mode(monkeypatch):
    """Pair mode (``FBTT_PAIR=1`` at a small nnz): B6's x is the
    recomputed z0."""
    monkeypatch.setenv("FBTT_DG0", "fused")
    monkeypatch.setenv("FBTT_PAIR", "1")
    case = CASES[1]
    rfull, cores, idx, rowidx, _, w = make_case(**case, seed=9)
    p, q, b = case["p"], case["q"], case["b"]
    dmask = np.arange(idx.shape[0]) % 7 == 0
    d_out = _d_out(1, b, 64)
    want_out, want = jflat.flat_train_apply(
        tuple(jnp.asarray(c) for c in cores), p, q, rfull, b, _j(idx),
        _j(rowidx), None, _j(w), _j(dmask), jnp.asarray(d_out),
        interpret=True)
    calls = _count(monkeypatch)
    out, got = tflat.flat_train_apply(
        [torch.as_tensor(c) for c in cores], p, q, rfull, b, _t(idx),
        _t(rowidx), None, _t(w), _t(dmask), torch.as_tensor(d_out))
    assert calls == {"seg_accum": 0, "seg_accum_dg0": 1}
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **FUSED)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **FUSED)


def _jax_vjp_grads(cores, p, q, rfull, b, idx, rowidx, tab, w, dead, d_out):
    from fbtt_embedding_tpu.ops.lookup import pooled_tt_lookup as j_lookup

    def f(cs):
        return j_lookup(cs, p, q, rfull, b, _j(idx), _j(rowidx), _j(tab),
                        weights=_j(w), impl="pallas_sorted", interpret=True,
                        dead_mask=_j(dead))

    _, vjp = jax.vjp(f, tuple(jnp.asarray(c) for c in cores))
    return [np.asarray(g) for g in vjp(jnp.asarray(d_out))[0]]


@pytest.mark.parametrize("cid,dead,pair", [(1, True, False), (2, False, False),
                                           (5, True, False), (7, True, False),
                                           (0, True, True)])
def test_flat_lookup_backward_dg0_fused_matches_jax(monkeypatch, cid, dead,
                                                    pair):
    """``FlatLookup``'s backward (B3 passes, then B6 on i1) against JAX's
    ``make_flat_vjp`` with the same knob."""
    monkeypatch.setenv("FBTT_DG0", "fused")
    if pair:
        monkeypatch.setenv("FBTT_PAIR", "1")
    case = CASES[cid]
    rfull, cores, idx, rowidx, tab, w = make_case(**case, seed=cid + 30)
    p, q, T, b = case["p"], case["q"], case.get("T", 1), case["b"]
    dmask = (np.random.default_rng(cid).random(idx.shape[0]) < 0.3
             if dead else None)
    d_out = _d_out(T, b, int(np.prod(q)))
    want = _jax_vjp_grads(cores, p, q, rfull, b, idx, rowidx, tab, w, dmask,
                          d_out)
    calls = _count(monkeypatch)
    leaves = [torch.as_tensor(c).requires_grad_() for c in cores]
    out = t_lookup(leaves, p, q, rfull, b, _t(idx), _t(rowidx), _t(tab),
                   weights=_t(w), impl="pallas_sorted", dead_mask=_t(dmask))
    got = torch.autograd.grad(out, leaves, torch.as_tensor(d_out))
    assert calls == {"seg_accum": len(p) - 2, "seg_accum_dg0": 1}
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b_, **FUSED)


def test_dg0_fused_matches_onehot(monkeypatch):
    """Same gradients with ``FBTT_DG0`` unset (B6 by default) as with
    "onehot" (the port alone); B6 runs pass 1, and B3 not."""
    case = CASES[3]
    rfull, cores, idx, rowidx, tab, w = make_case(**case, seed=12)
    p, q, b = case["p"], case["q"], case["b"]
    d_out = torch.as_tensor(_d_out(1, b, int(np.prod(q))))
    res = {}
    for mode in ("onehot", None):
        if mode is None:
            monkeypatch.delenv("FBTT_DG0", raising=False)
        else:
            monkeypatch.setenv("FBTT_DG0", mode)
        calls = _count(monkeypatch)
        res[mode] = tflat.flat_train_apply(
            [torch.as_tensor(c) for c in cores], p, q, rfull, b, _t(idx),
            _t(rowidx), None, None, None, d_out)
        assert calls["seg_accum_dg0"] == (mode != "onehot")
        assert calls["seg_accum"] == (mode == "onehot")
    out_o, g_o = res["onehot"]
    out_f, g_f = res[None]
    assert torch.equal(out_f, out_o)
    for a, b_ in zip(g_f, g_o):
        torch.testing.assert_close(a, b_, **FUSED)


def test_flat_lookup_backward_default_takes_b6(monkeypatch):
    """``FBTT_DG0`` unset: ``FlatLookup``'s backward runs B6 on pass 1
    (no B3 there) and gives the gradients of "onehot"."""
    case = CASES[1]
    rfull, cores, idx, rowidx, tab, w = make_case(**case, seed=33)
    p, q, b = case["p"], case["q"], case["b"]
    d_out = torch.as_tensor(_d_out(1, b, int(np.prod(q))))
    got = {}
    for mode in ("onehot", None):
        if mode is None:
            monkeypatch.delenv("FBTT_DG0", raising=False)
        else:
            monkeypatch.setenv("FBTT_DG0", mode)
        calls = _count(monkeypatch)
        leaves = [torch.as_tensor(c).requires_grad_() for c in cores]
        out = t_lookup(leaves, p, q, rfull, b, _t(idx), _t(rowidx), None,
                       weights=_t(w), impl="pallas_sorted")
        got[mode] = torch.autograd.grad(out, leaves, d_out)
        want_b3 = len(p) - 1 if mode == "onehot" else len(p) - 2
        assert calls == {"seg_accum": want_b3,
                         "seg_accum_dg0": int(mode is None)}
    for a, b_ in zip(got[None], got["onehot"]):
        torch.testing.assert_close(a, b_, **FUSED)
