"""PyTorch port vs the JAX package: kernel B6 and ``FBTT_DG0`` (CPU).

- B6's plain version (``seg_accum_dg0_plain``: B3's plain pass and a
  float32 one-hot dG0) against the Pallas kernel ``_seg_accum_i1`` in
  interpret mode, rtol = atol = 1e-5, with a sentinel tail of dead rows;
- ``flat_train_apply`` and the ``FlatLookup`` backward with
  ``FBTT_DG0=fused`` against the JAX package's own with the same knob
  (interpret mode), float32, rtol 1e-6: dead masks, pair mode, tt_ndim 2,
  3 and 4, two tables; and ``FBTT_DG0`` routing (B6 replaces B3 on the i1
  pass; off by default);
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
    dg0_fits,
    seg_accum_dg0,
    seg_accum_dg0_plain,
)
from fbtt_embedding_tpu_torch.ops.lookup import pooled_tt_lookup as t_lookup
from fbtt_embedding_tpu_torch.utils import knobs
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
    before = seg_accum_dg0.launches
    acc2, dg02 = seg_accum_dg0(*args, **kw)
    assert seg_accum_dg0.launches == before
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
    monkeypatch.delenv("FBTT_DG0", raising=False)
    assert not tflat._dg0_fused_gate(128)  # "onehot" by default
    monkeypatch.setenv("FBTT_DG0", "onehot")
    assert not tflat._dg0_fused_gate(128)
    monkeypatch.setenv("FBTT_DG0", "fused")
    assert tflat._dg0_fused_gate(128) and tflat._dg0_fused_gate(512)
    # the one Hopper limit: the segment's float32 dz0 tile in shared memory
    assert not tflat._dg0_fused_gate(520)
    assert dg0_fits(512, 64) and not dg0_fits(520, 64)
    assert knobs.get_str("FBTT_DG0") == "fused"
    with pytest.raises(KeyError):
        knobs.get_str("FBTT_SEG")  # the TPU's knobs are not carried over


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
    monkeypatch.setenv("FBTT_DG0", "fused")
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
    """Pair mode (gate forced): B6's x is the recomputed z0."""
    monkeypatch.setenv("FBTT_DG0", "fused")
    monkeypatch.setattr(tflat, "_pair_gate", lambda *a: True)
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
        monkeypatch.setattr(tflat, "_pair_gate", lambda *a: True)
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
    """Same gradients with the knob on and off (the port alone)."""
    case = CASES[3]
    rfull, cores, idx, rowidx, tab, w = make_case(**case, seed=12)
    p, q, b = case["p"], case["q"], case["b"]
    d_out = torch.as_tensor(_d_out(1, b, int(np.prod(q))))
    res = {}
    for mode in ("onehot", "fused"):
        monkeypatch.setenv("FBTT_DG0", mode)
        calls = _count(monkeypatch)
        res[mode] = tflat.flat_train_apply(
            [torch.as_tensor(c) for c in cores], p, q, rfull, b, _t(idx),
            _t(rowidx), None, None, None, d_out)
        assert calls["seg_accum_dg0"] == (mode == "fused")
        assert calls["seg_accum"] == (mode == "onehot")
    (out_f, g_f), (out_o, g_o) = res["fused"], res["onehot"]
    assert torch.equal(out_f, out_o)
    for a, b_ in zip(g_f, g_o):
        torch.testing.assert_close(a, b_, **FUSED)
