"""PyTorch port vs the JAX package: the fused training step (CPU).

- the gradient pass (B3) and the fused last-core pass (B2): their plain
  versions against the Pallas kernels ``_seg_accum`` / ``_seg_fused_i2_call``
  in interpret mode, rtol = atol = 1e-5, in float32 and with bfloat16
  outputs (on integer-valued inputs, so that every product and sum is exact
  and both sides round the same value);
- the block-diagonal fold (``mm`` = 2, 4) of both plain versions on a true
  ``kron(I_mm, G[j])`` table against the same Pallas kernels followed by
  ``_extract_bd_grad``, rtol = atol = 1e-5; the wrappers' checks of ``mm``
  and the fold they fall back to (``kernel_fold``);
- the flat lookup's gradients (``FlatLookup``) against JAX ``make_flat_vjp``
  in interpret mode, and ``flat_train_apply`` against its JAX counterpart,
  float32, rtol 1e-5;
- ``sgd_step`` / ``adagrad_step`` against the JAX functions;
- three SGD and three Adagrad steps of ``make_fused_train_step(device=
  "cpu")`` against JAX ``make_fused_train_step`` on the CPU (its XLA path),
  rtol 1e-4, atol 1e-5;
- a fresh process that trains through the port without importing JAX.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbtt_embedding_tpu import TTEmbeddingParams as JParams
from fbtt_embedding_tpu.models.tt_embedding import OptimType as JOptimType
from fbtt_embedding_tpu.models.tt_embedding import (
    make_fused_train_step as j_make_step,
)
from fbtt_embedding_tpu.ops import fused_optim as joptim
from fbtt_embedding_tpu.ops.lookup import pooled_tt_lookup as j_lookup
from fbtt_embedding_tpu.ops.pallas import tt_flat as jflat
from fbtt_embedding_tpu.ops.pallas import tt_kernel as jkernel
from fbtt_embedding_tpu_torch import (
    OptimType,
    TTEmbeddingParams,
    adagrad_step,
    make_cache_state,
    make_fused_train_step,
    params_from_jax,
    sgd_step,
    wide_keyrows,
)
from fbtt_embedding_tpu_torch.ops.kernels import tt_flat as tflat
from fbtt_embedding_tpu_torch.ops.kernels import tt_kernel as tkernel
from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import (
    cached_fold,
    diag_block_sum,
    kernel_fold,
    seg_accum,
    seg_accum_plain,
)
from fbtt_embedding_tpu_torch.ops.kernels.seg_fused_i2 import (
    seg_fused_i2,
    seg_fused_i2_plain,
)
from fbtt_embedding_tpu_torch.ops.lookup import pooled_tt_lookup as t_lookup
from fbtt_embedding_tpu_torch.utils import profiling as tprof
from test_torch_port_flat import CASES, KERNEL_SHAPES, make_case

ROOT = Path(__file__).resolve().parents[1]
TIGHT = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this module from
    crowding the other test workers' cores, and is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _pass_inputs(shape, integer):
    """Sorted Zipf keys with a sentinel tail, their span tables (JAX and
    port, checked equal), and x, y, table; integer-valued in [-3, 3] when
    ``integer`` (exact products and sums in float32), else normal and
    scaled so that z, rows and the hottest span's acc are of unit size
    (the absolute tolerance then reads on unit-scale sums)."""
    blocks, bw_x, bw_y, p_rows, nza, seg = shape
    rng = np.random.default_rng(sum(shape) + integer)
    keys = np.sort((rng.zipf(1.3, size=nza) - 1) % (p_rows + 1))
    keys = keys.astype(np.int32)
    jtabs = jflat._span_table(jnp.asarray(keys), p_rows, nza // seg, seg=seg)
    ttabs = tflat._span_table(torch.as_tensor(keys), p_rows, nza // seg,
                              seg=seg)
    for a, b in zip(jtabs, ttabs):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    def draw(scale, *size):
        if integer:
            return rng.integers(-3, 4, size=size).astype(np.float32)
        return (rng.normal(size=size) * scale).astype(np.float32)

    hot = np.bincount(keys).max() * blocks
    x = draw(hot ** -0.25, nza, blocks * bw_x)
    y = draw(hot ** -0.25, nza, blocks * bw_y)
    table = draw(hot ** 0.25 / np.sqrt(max(bw_x, bw_y)),
                 (p_rows + jflat.SPAN_BLOCK) * bw_x, bw_y)
    table[p_rows * bw_x:] = 0
    return keys, jtabs, ttabs, x, y, table


def _assert_span_zeros(acc, z_rows, keys, p_rows):
    """Sentinel rows are exact zeros, and so is the acc of an empty span."""
    dead = int(np.searchsorted(keys, p_rows))
    for z in z_rows:
        assert not z[dead:].any()
    empty = np.setdiff1d(np.arange(p_rows), keys)
    assert not acc[torch.as_tensor(empty, dtype=torch.long)].any()


@pytest.mark.parametrize("z_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_seg_accum_plain_matches_pallas_kernel(shape, z_dt):
    blocks, bw_x, bw_y, p_rows, nza, seg = shape
    integer = z_dt == "bfloat16"
    keys, jtabs, ttabs, x, y, table = _pass_inputs(shape, integer)
    want_acc, want_z = jflat._seg_accum(
        nza // seg, blocks, bw_x, bw_y, p_rows, "float32", z_dt, True,
        *jtabs, jnp.asarray(x), jnp.asarray(y), jnp.asarray(table), seg=seg)
    z_dtype = getattr(torch, z_dt)
    kw = dict(blocks=blocks, bw_x=bw_x, bw_y=bw_y, p_rows=p_rows, seg=seg,
              z_dtype=z_dtype)
    args = (*ttabs, torch.as_tensor(x), torch.as_tensor(y),
            torch.as_tensor(table))
    acc, z = seg_accum_plain(*args, **kw)
    assert acc.dtype == torch.float32 and z.dtype == z_dtype
    assert acc.shape == (p_rows, bw_x, bw_y)
    np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc), **TIGHT)
    np.testing.assert_allclose(z.float().numpy(),
                               np.asarray(want_z).astype(np.float32), **TIGHT)
    _assert_span_zeros(acc, [z], keys, p_rows)
    # the wrapper takes the plain version on the CPU and launches nothing
    before = tprof.counter("launches.seg_accum")
    acc2, z2 = seg_accum(*args, **kw)
    assert tprof.counter("launches.seg_accum") == before
    assert torch.equal(acc, acc2) and torch.equal(z, z2)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_seg_fused_i2_plain_matches_pallas_kernel(shape, dt):
    blocks, bw_x, bw_y, p_rows, nza, seg = shape
    keys, jtabs, ttabs, x, y, table = _pass_inputs(shape, dt == "bfloat16")
    acc_t = jflat._acc_transposed(bw_x, bw_y)
    jdt = jnp.dtype(dt)
    acc2d, want_z, want_rows = jflat._seg_fused_i2_call(
        nza // seg, blocks, bw_x, bw_y, p_rows, dt, True, acc_t=acc_t,
        sb=jflat.SPAN_BLOCK, trip="concat", seg=seg)(
        *jtabs, jnp.asarray(x, jdt), jnp.asarray(y, jdt),
        jnp.asarray(table, jdt))
    want_acc = jflat._acc_to_canonical(acc2d, p_rows, bw_x, bw_y, acc_t)
    tdt = getattr(torch, dt)
    kw = dict(blocks=blocks, bw_x=bw_x, bw_y=bw_y, p_rows=p_rows, seg=seg)
    args = (*ttabs, torch.as_tensor(x).to(tdt), torch.as_tensor(y).to(tdt),
            torch.as_tensor(table).to(tdt))
    acc, z, rows = seg_fused_i2_plain(*args, **kw)
    assert z.dtype == tdt and rows.dtype == tdt
    np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc), **TIGHT)
    for got, want in ((z, want_z), (rows, want_rows)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   **TIGHT)
    _assert_span_zeros(acc, [z, rows], keys, p_rows)
    before = tprof.counter("launches.seg_fused_i2")
    got = seg_fused_i2(*args, **kw)
    assert tprof.counter("launches.seg_fused_i2") == before
    assert all(torch.equal(a, b) for a, b in zip((acc, z, rows), got))


@pytest.mark.parametrize("fn", [seg_accum, seg_fused_i2])
def test_gradient_pass_wrappers_check_inputs(fn):
    shape = (2, 8, 8, 10, 128, 64)
    _, _, ttabs, x, y, table = _pass_inputs(shape, False)
    tabs = list(ttabs)
    x, y, table = (torch.as_tensor(a) for a in (x, y, table))
    kw = dict(blocks=2, bw_x=8, bw_y=8, p_rows=10, seg=64)
    fn(*tabs, x, y, table, **kw)  # well-formed: runs
    with pytest.raises(ValueError):  # wrong y width
        fn(*tabs, x, y[:, :8], table, **kw)
    with pytest.raises(ValueError):  # wrong x rows
        fn(*tabs, x[:64], y, table, **kw)
    with pytest.raises(ValueError):  # mixed dtypes
        fn(*tabs, x, y.double(), table, **kw)
    with pytest.raises(ValueError):  # table too short
        fn(*tabs, x, y, table[:8], **kw)
    with pytest.raises(ValueError):  # int64 span tables
        fn(tabs[0].long(), *tabs[1:], x, y, table, **kw)
    with pytest.raises(ValueError):  # runs shorter than p_rows + 2
        fn(tabs[0][:5], *tabs[1:], x, y, table, **kw)
    with pytest.raises(ValueError):  # neither cpu nor cuda: no fallback
        fn(*[t.to("meta") for t in tabs], x.to("meta"), y.to("meta"),
           table.to("meta"), **kw)
    if fn is seg_accum:
        with pytest.raises(ValueError):  # z in a dtype the kernel lacks
            fn(*tabs, x, y, table, z_dtype=torch.float16, **kw)


FOLD_SHAPES = [  # headline-like i2 (G 32x4 at mm 4), i1-like, a narrow one
    (4, 128, 16, 25, 512, 128),
    (4, 32, 128, 22, 512, 128),
    (2, 16, 64, 11, 384, 128),
]


def _fold_inputs(shape, mm, integer):
    """``_pass_inputs`` with the table replaced by a true block-diagonal
    one, ``kron(I_mm, G[j])`` from a numpy-seeded ``G`` (zero tail)."""
    blocks, bw_x, bw_y, p_rows, nza, seg = shape
    keys, jtabs, ttabs, x, y, _ = _pass_inputs(shape, integer)
    kx, ky = bw_x // mm, bw_y // mm
    rng = np.random.default_rng(sum(shape) + 7 * mm + integer)
    if integer:
        g = rng.integers(-3, 4, size=(p_rows, kx, ky)).astype(np.float32)
    else:
        hot = np.bincount(keys).max() * blocks
        g = (rng.normal(size=(p_rows, kx, ky)) * hot ** 0.25
             / np.sqrt(max(kx, ky))).astype(np.float32)
    bd = tflat._bd_table(torch.as_tensor(g), mm, torch.float32)
    table = np.concatenate([
        bd.reshape(p_rows * bw_x, bw_y).numpy(),
        np.zeros((jflat.SPAN_BLOCK * bw_x, bw_y), np.float32)])
    return keys, jtabs, ttabs, x, y, table


@pytest.mark.parametrize("mm", [2, 4])
@pytest.mark.parametrize("shape", FOLD_SHAPES)
def test_seg_accum_plain_fold_matches_pallas_kernel(shape, mm):
    blocks, bw_x, bw_y, p_rows, nza, seg = shape
    keys, jtabs, ttabs, x, y, table = _fold_inputs(shape, mm, False)
    acc_bd, want_z = jflat._seg_accum(
        nza // seg, blocks, bw_x, bw_y, p_rows, "float32", "float32", True,
        *jtabs, jnp.asarray(x), jnp.asarray(y), jnp.asarray(table), seg=seg)
    want_acc = jflat._extract_bd_grad(acc_bd, mm, bw_x // mm, bw_y // mm)
    kw = dict(blocks=blocks, bw_x=bw_x, bw_y=bw_y, p_rows=p_rows, seg=seg,
              z_dtype=torch.float32, mm=mm)
    args = (*ttabs, torch.as_tensor(x), torch.as_tensor(y),
            torch.as_tensor(table))
    acc, z = seg_accum_plain(*args, **kw)
    assert acc.shape == (p_rows, bw_x // mm, bw_y // mm)
    np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc), **TIGHT)
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), **TIGHT)
    _assert_span_zeros(acc, [z], keys, p_rows)
    before = tprof.counter("launches.seg_accum")
    acc2, z2 = seg_accum(*args, **kw)
    assert tprof.counter("launches.seg_accum") == before
    assert torch.equal(acc, acc2) and torch.equal(z, z2)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mm", [2, 4])
@pytest.mark.parametrize("shape", FOLD_SHAPES)
def test_seg_fused_i2_plain_fold_matches_pallas_kernel(shape, mm, dt):
    blocks, bw_x, bw_y, p_rows, nza, seg = shape
    keys, jtabs, ttabs, x, y, table = _fold_inputs(shape, mm,
                                                   dt == "bfloat16")
    acc_t = jflat._acc_transposed(bw_x, bw_y)
    jdt = jnp.dtype(dt)
    acc2d, want_z, want_rows = jflat._seg_fused_i2_call(
        nza // seg, blocks, bw_x, bw_y, p_rows, dt, True, acc_t=acc_t,
        sb=jflat.SPAN_BLOCK, trip="concat", seg=seg)(
        *jtabs, jnp.asarray(x, jdt), jnp.asarray(y, jdt),
        jnp.asarray(table, jdt))
    want_acc = jflat._extract_bd_grad(
        jflat._acc_to_canonical(acc2d, p_rows, bw_x, bw_y, acc_t), mm,
        bw_x // mm, bw_y // mm)
    tdt = getattr(torch, dt)
    kw = dict(blocks=blocks, bw_x=bw_x, bw_y=bw_y, p_rows=p_rows, seg=seg,
              mm=mm)
    args = (*ttabs, torch.as_tensor(x).to(tdt), torch.as_tensor(y).to(tdt),
            torch.as_tensor(table).to(tdt))
    acc, z, rows = seg_fused_i2_plain(*args, **kw)
    assert acc.shape == (p_rows, bw_x // mm, bw_y // mm)
    assert z.dtype == tdt and rows.dtype == tdt
    np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc), **TIGHT)
    for got, want in ((z, want_z), (rows, want_rows)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   **TIGHT)
    _assert_span_zeros(acc, [z, rows], keys, p_rows)
    before = tprof.counter("launches.seg_fused_i2")
    got = seg_fused_i2(*args, **kw)
    assert tprof.counter("launches.seg_fused_i2") == before
    assert all(torch.equal(a, b) for a, b in zip((acc, z, rows), got))


@pytest.mark.parametrize("fn", [seg_accum, seg_fused_i2])
def test_gradient_pass_wrappers_check_fold(fn):
    shape = (2, 16, 8, 10, 128, 64)
    _, _, ttabs, x, y, table = _pass_inputs(shape, False)
    args = (*ttabs, torch.as_tensor(x), torch.as_tensor(y),
            torch.as_tensor(table))
    kw = dict(blocks=2, bw_x=16, bw_y=8, p_rows=10, seg=64)
    assert fn(*args, mm=2, **kw)[0].shape == (10, 8, 4)
    for mm in (3, 16, 0):  # not a divisor of bw_x (16), of bw_y (8), < 1
        with pytest.raises(ValueError):
            fn(*args, mm=mm, **kw)


@pytest.mark.parametrize("mm, staged, want", [
    (4, {4, 2, 1}, (4, 1)),  # the whole fold stages
    (4, {2, 1}, (2, 1)),     # folded widths too narrow at 4: the next divisor
    (6, {3, 1}, (3, 1)),     # divisors only: 5 and 4 are skipped
    (4, set(), None),        # not even mm' = 1: raises
])
def test_kernel_fold_takes_the_largest_staged_divisor(mm, staged, want):
    calls = []

    def path_fn(in_bf16, seg, blocks, bw_x, bw_y, d):  # the library's query
        calls.append(d)
        return 1 if d in staged else -1

    if want is None:
        with pytest.raises(ValueError):
            kernel_fold("seg_accum", path_fn, True, 64, 4, 96, 48, mm)
        return
    assert kernel_fold("seg_accum", path_fn, True, 64, 4, 96, 48, mm) == want
    assert all(mm % d == 0 for d in calls)


def test_cached_fold_asks_the_library_once_per_widths():
    calls = []

    def path_fn(in_bf16, seg, blocks, bw_x, bw_y, d):
        calls.append((bw_x, d))
        return 1 if d <= 2 else -1

    for _ in range(3):
        assert cached_fold("test_kernel", path_fn, 1, 64, 4, 96, 48, 4) \
            == (2, 1)
    assert calls == [(96, 4), (96, 2)]
    assert cached_fold("test_kernel", path_fn, 1, 64, 4, 32, 48, 4) == (2, 1)
    assert calls[2:] == [(32, 4), (32, 2)]


def test_diag_block_sum_matches_extract_bd_grad():
    rng = np.random.default_rng(11)
    acc = rng.normal(size=(5, 4 * 8, 4 * 6)).astype(np.float32)
    for n in (1, 2, 4):
        want = jflat._extract_bd_grad(jnp.asarray(acc), n, 32 // n, 24 // n)
        got = diag_block_sum(torch.as_tensor(acc), n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_layout_helpers_match_jax():
    rng = np.random.default_rng(5)
    dgbd = rng.normal(size=(7, 4 * 8, 4 * 16)).astype(np.float32)
    for mm, r_t, w_t in ((4, 8, 16), (1, 32, 64), (2, 16, 32)):
        want = jflat._extract_bd_grad(jnp.asarray(dgbd), mm, r_t, w_t)
        got = tflat._extract_bd_grad(torch.as_tensor(dgbd), mm, r_t, w_t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    p, q, r = [5, 6, 7], [2, 4, 2], [1, 8, 4, 1]
    dgs = [rng.normal(size=(2 * p[i], r[i] * q[i] * r[i + 1]))
           .astype(np.float32) for i in range(3)]
    want = jkernel.grads_to_module_layout([jnp.asarray(g) for g in dgs], p, q,
                                          r, 2)
    got = tkernel.grads_to_module_layout([torch.as_tensor(g) for g in dgs],
                                         p, q, r, 2)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _d_out(T, b, D, seed=13):
    return np.random.default_rng(seed).normal(size=(T, b, D)).astype(
        np.float32)


def _jax_flat_grads(cores, p, q, rfull, b, idx, rowidx, tab, w,
                    dead=None, d_out=None):
    def f(cs):
        return j_lookup(cs, p, q, rfull, b, _j(idx), _j(rowidx), _j(tab),
                        weights=_j(w), impl="pallas_sorted", interpret=True,
                        dead_mask=_j(dead))

    out, vjp = jax.vjp(f, tuple(jnp.asarray(c) for c in cores))
    (grads,) = vjp(jnp.asarray(d_out))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_flat_grads(cores, p, q, rfull, b, idx, rowidx, tab, w, dead=None,
                     d_out=None, impl="pallas_sorted"):
    leaves = [torch.as_tensor(c).requires_grad_() for c in cores]
    out = t_lookup(leaves, p, q, rfull, b, _t(idx), _t(rowidx), _t(tab),
                   weights=_t(w), impl=impl, dead_mask=_t(dead))
    grads = torch.autograd.grad(out, leaves, torch.as_tensor(d_out))
    return out.detach().numpy(), [g.numpy() for g in grads]


GRAD = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_flat_lookup_grads_match_jax_vjp(case):
    """Plain, weighted, multi-table, tt_ndim 2-4 and odd-rank (padded)."""
    rfull, cores, idx, rowidx, tab, w = make_case(**case)
    p, q, T, b = case["p"], case["q"], case.get("T", 1), case["b"]
    d_out = _d_out(T, b, int(np.prod(q)))
    want_out, want = _jax_flat_grads(cores, p, q, rfull, b, idx, rowidx, tab,
                                     w, d_out=d_out)
    out, got = _port_flat_grads(cores, p, q, rfull, b, idx, rowidx, tab, w,
                                d_out=d_out)
    np.testing.assert_allclose(out, want_out, **TIGHT)
    for a, b_ in zip(got, want):
        assert a.shape == b_.shape
        np.testing.assert_allclose(a, b_, **GRAD)


def test_flat_lookup_dead_mask_grads_match_jax_vjp():
    case = CASES[1]
    rfull, cores, idx, rowidx, _, w = make_case(**case, seed=8)
    p, q, b = case["p"], case["q"], case["b"]
    dead = np.random.default_rng(3).random(idx.shape[0]) < 0.3
    d_out = _d_out(1, b, 64)
    want_out, want = _jax_flat_grads(cores, p, q, rfull, b, idx, rowidx, None,
                                     w, dead=dead, d_out=d_out)
    out, got = _port_flat_grads(cores, p, q, rfull, b, idx, rowidx, None, w,
                                dead=dead, d_out=d_out)
    np.testing.assert_allclose(out, want_out, **TIGHT)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a, b_, **GRAD)


@pytest.mark.parametrize("mode", ["pair", "dead", "live", "pair_dead"])
def test_flat_lookup_backward_plans_match_jax(mode):
    """The backward on explicit plans (pair mode needs nza >= 16384 to be
    chosen, so the plan is built with pair=True here)."""
    case = CASES[1]
    rfull, cores, idx, rowidx, _, w = make_case(**case, seed=6)
    p, q, b = case["p"], case["q"], case["b"]
    nnz = idx.shape[0]
    dead = (np.random.default_rng(2).random(nnz) < 0.4
            if "dead" in mode else None)
    live = np.asarray([nnz // 3], np.int32) if mode == "live" else None
    pair, seg = "pair" in mode, 64
    d_out = _d_out(1, b, 64)
    jcores = tuple(jnp.asarray(c) for c in cores)
    jp, nza = jflat._build_plan(_j(idx), _j(rowidx), None, _j(w), _j(live),
                                p, 1, b, dead_mask=_j(dead), seg=seg,
                                pair=pair)
    _, jstages = jflat.flat_lookup_forward(
        jcores, p, q, rfull, b, jp, nza, compute_dtype=jnp.float32,
        interpret=True, seg=seg)
    want = jflat.flat_lookup_backward(
        jcores, p, q, rfull, b, jp, nza, jstages, jnp.asarray(d_out),
        compute_dtype=jnp.float32, interpret=True, seg=seg)
    tcores = [torch.as_tensor(c) for c in cores]
    tp, _ = tflat._build_plan(_t(idx), _t(rowidx), None, _t(w), _t(live), p,
                              1, b, dead_mask=_t(dead), seg=seg, pair=pair)
    _, stages = tflat.flat_lookup_forward(tcores, p, q, rfull, b, tp, nza,
                                          seg=seg)
    assert (stages[0] is None) == pair
    got = tflat.flat_lookup_backward(tcores, p, q, rfull, b, tp, nza, stages,
                                     torch.as_tensor(d_out), seg=seg)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **GRAD)


def test_flat_lookup_function_pair_mode_grads(monkeypatch):
    """FlatLookup in pair mode (``FBTT_PAIR=1`` at a small nnz) against
    JAX's vjp under the same knob: the pair table and the recomputed z0
    give the same gradients."""
    monkeypatch.setenv("FBTT_PAIR", "1")
    case = CASES[0]
    rfull, cores, idx, rowidx, tab, w = make_case(**case, seed=4)
    p, q, b = case["p"], case["q"], case["b"]
    d_out = _d_out(1, b, 64)
    want_out, want = _jax_flat_grads(cores, p, q, rfull, b, idx, rowidx, tab,
                                     w, d_out=d_out)
    out, got = _port_flat_grads(cores, p, q, rfull, b, idx, rowidx, tab, w,
                                d_out=d_out)
    np.testing.assert_allclose(out, want_out, **TIGHT)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a, b_, **GRAD)


TRAIN_APPLY_CASES = [
    dict(case=1, dead=True, seed=21, L=4),  # the JAX suite's own case
    dict(case=0, dead=False, seed=2),
    dict(case=2, dead=True, seed=3),        # two tables
    dict(case=5, dead=False, seed=4),       # tt_ndim 2: B2 only
    dict(case=6, dead=True, seed=5),        # tt_ndim 2, weighted
    dict(case=7, dead=False, seed=6),       # tt_ndim 4: B1 x2, B2, B3 x2
    dict(case=8, dead=True, seed=7),
]


@pytest.mark.parametrize("tc", TRAIN_APPLY_CASES)
def test_flat_train_apply_matches_jax(tc):
    case = dict(CASES[tc["case"]])
    if "L" in tc:
        case["L"] = tc["L"]
    rfull, cores, idx, rowidx, tab, w = make_case(**case, seed=tc["seed"])
    p, q, T, b = case["p"], case["q"], case.get("T", 1), case["b"]
    nnz = idx.shape[0]
    dead = (np.arange(nnz) % 5 == 0) if tc["dead"] else None
    d_out = _d_out(T, b, int(np.prod(q)))
    want_out, want = jflat.flat_train_apply(
        tuple(jnp.asarray(c) for c in cores), p, q, rfull, b, _j(idx),
        _j(rowidx), _j(tab), _j(w), _j(dead), jnp.asarray(d_out),
        interpret=True)
    out, got = tflat.flat_train_apply(
        [torch.as_tensor(c) for c in cores], p, q, rfull, b, _t(idx),
        _t(rowidx), _t(tab), _t(w), _t(dead), torch.as_tensor(d_out))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **GRAD)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **GRAD)


def test_flat_train_apply_pair_mode(monkeypatch):
    """Pair mode (``FBTT_PAIR=1`` at a small nnz): B2 reads G01[pair_s2],
    B3's x is the recomputed z0; same result as JAX's train-apply under
    the same knob."""
    monkeypatch.setenv("FBTT_PAIR", "1")
    case = CASES[1]
    rfull, cores, idx, rowidx, _, w = make_case(**case, seed=9)
    p, q, b = case["p"], case["q"], case["b"]
    dead = np.arange(idx.shape[0]) % 7 == 0
    d_out = _d_out(1, b, 64)
    want_out, want = jflat.flat_train_apply(
        tuple(jnp.asarray(c) for c in cores), p, q, rfull, b, _j(idx),
        _j(rowidx), None, _j(w), _j(dead), jnp.asarray(d_out),
        interpret=True)
    out, got = tflat.flat_train_apply(
        [torch.as_tensor(c) for c in cores], p, q, rfull, b, _t(idx),
        _t(rowidx), None, _t(w), _t(dead), torch.as_tensor(d_out))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **GRAD)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **GRAD)


def _optim_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(1, 20, 32), (1, 22, 256), (1, 25, 32)]
    cores = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads[1][0, 3] = 0.0  # an untouched row
    state = [np.abs(rng.normal(size=s)).astype(np.float32) for s in shapes]
    return cores, grads, state


def test_sgd_step_matches_jax():
    cores, grads, _ = _optim_inputs(1)
    want = joptim.sgd_step([jnp.asarray(c) for c in cores],
                           [jnp.asarray(g) for g in grads], 0.05)
    tcores = [torch.tensor(c) for c in cores]  # copies: updated in place
    got = sgd_step(tcores, [torch.tensor(g) for g in grads], 0.05)
    assert all(a is b for a, b in zip(got, tcores))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_adagrad_step_matches_jax():
    cores, grads, state = _optim_inputs(2)
    want_c, want_s = joptim.adagrad_step(
        [jnp.asarray(c) for c in cores], [jnp.asarray(s) for s in state],
        [jnp.asarray(g) for g in grads], 0.05, 1e-3)
    tcores = [torch.tensor(c) for c in cores]
    tstate = [torch.tensor(s) for s in state]
    got_c, got_s = adagrad_step(tcores, tstate,
                                [torch.tensor(g) for g in grads], 0.05, 1e-3)
    assert all(a is b for a, b in zip(got_c, tcores))
    assert all(a is b for a, b in zip(got_s, tstate))
    for a, b in zip(list(got_c) + list(got_s), list(want_c) + list(want_s)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


STEP_CASES = [
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=3,
         weights=True),                                  # flat_train_apply
    dict(p=[16, 16, 16], q=[4, 4, 4], ranks=[8, 8], b=8, L=2, T=2),
    dict(p=[30, 40], q=[8, 8], ranks=[8], b=16, L=2),
    dict(p=[8, 9, 10, 11], q=[2, 4, 2, 2], ranks=[8, 8, 8], b=8, L=3),
    dict(p=[7, 9, 11], q=[3, 4, 5], ranks=[13, 12], b=8, L=4),  # padded
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=8, L=4100),  # vjp
]
# Adagrad's first step is lr*g/(|g|+eps): where g is near zero it
# magnifies the two sides' summation-order noise (~1e-7 on g) by 1/eps.
# eps = 1e-3 keeps that below lr*1e-4 = 1e-6, so it can neither flip a
# sign of the update nor reach the atol.
LR, EPS = 0.01, 1e-3


def _step_setup(case, optimizer, seed=17):
    p, q, ranks = case["p"], case["q"], case["ranks"]
    b, L, T = case["b"], case["L"], case.get("T", 1)
    rfull = [1] + list(ranks) + [1]
    E, D = int(np.prod(p)), int(np.prod(q))
    nnz = T * b * L
    rng = np.random.default_rng(seed)
    from fbtt_embedding_tpu_torch import init_tt_cores
    cores = init_tt_cores(rng, "uniform", T, E, D, p, q, rfull)
    state = [np.zeros_like(c) for c in cores] \
        if optimizer not in (OptimType.SGD, OptimType.EXACT_SGD) else []
    batches = []
    for _ in range(3):
        idx = rng.integers(0, E, size=nnz).astype(np.int32)
        offs = np.arange(0, nnz + 1, L, dtype=np.int32)
        w = (rng.random(nnz).astype(np.float32) if case.get("weights")
             else None)
        batches.append((idx, offs, rng.normal(size=(T, b, D)).astype(
            np.float32), w))
    return p, q, rfull, T, b, cores, state, batches


@pytest.mark.parametrize("optimizer", ["SGD", "EXACT_ADAGRAD"])
@pytest.mark.parametrize("case", STEP_CASES)
def test_fused_train_step_matches_jax(case, optimizer):
    p, q, rfull, T, b, cores, state, batches = _step_setup(
        case, getattr(OptimType, optimizer))
    jstep = j_make_step(p, q, rfull, T, b,
                        optimizer=getattr(JOptimType, optimizer))
    tstep = make_fused_train_step(p, q, rfull, T, b,
                                  optimizer=getattr(OptimType, optimizer),
                                  device="cpu")
    jparams = JParams(tuple(jnp.asarray(c) for c in cores),
                      tuple(jnp.asarray(s) for s in state), None)
    params = params_from_jax(cores, state, device="cpu")
    for idx, offs, d_out, w in batches:
        jout, jparams = jstep(jparams, jnp.asarray(idx), jnp.asarray(offs),
                              jnp.asarray(d_out),
                              (jnp.float32(LR), jnp.float32(EPS)), _j(w))
        out, params = tstep(params, idx, offs, d_out, (LR, EPS), w)
        assert out.shape == (T, b, int(np.prod(q)))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                                   atol=1e-5)
        for a, b_ in zip(list(params.tt_cores) + list(params.optimizer_state),
                         list(jparams.tt_cores)
                         + list(jparams.optimizer_state)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-4,
                                       atol=1e-5)


def test_fused_train_step_key_layouts_and_paths():
    """Flat ids, per-core parts and wide key rows train alike; impl="xla"
    (the plain tt_rows chain) agrees with the flat train-apply."""
    case = STEP_CASES[0]
    p, q, rfull, T, b, cores, _, batches = _step_setup(case, OptimType.SGD)
    idx, offs, d_out, w = batches[0]
    results = []
    for impl, keys in (("auto", idx), ("auto", wide_keyrows(idx, p)),
                       ("auto", tuple(torch.as_tensor(k) for k in
                                      wide_keyrows(idx, p)[:, 2:].T)),
                       ("xla", idx), ("pallas_sorted", idx)):
        step = make_fused_train_step(p, q, rfull, T, 4 * b, impl=impl,
                                     device="cpu")
        params = params_from_jax(cores, device="cpu")
        out, new = step(params, keys, offs, d_out, (LR, EPS), w, bs=b)
        assert new.tt_cores[0] is params.tt_cores[0]  # updated in place
        results.append((out, new.tt_cores))
    out0, cores0 = results[0]
    for out, cs in results[1:]:
        np.testing.assert_allclose(out.numpy(), out0.numpy(), rtol=1e-5,
                                   atol=1e-6)
        for a, b_ in zip(cs, cores0):
            np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_fused_train_step_unported_options_raise():
    """The native optimizers and the wide-key (int64) cache, once refused,
    now build; index parts cannot key a cache, and wide key rows cannot key
    a direct one (ValueError)."""
    p, q, r = [20, 22, 25], [4, 4, 4], [1, 8, 8, 1]
    assert callable(make_fused_train_step(p, q, r, 1, 8, device="cpu",
                                          optim_semantics="native"))
    with pytest.raises(ValueError):
        make_fused_train_step(p, q, r, 1, 8, optim_semantics="other",
                              device="cpu")
    cores = params_from_jax(
        [np.zeros((1, 20, 32), np.float32), np.zeros((1, 22, 256),
                                                     np.float32),
         np.zeros((1, 25, 32), np.float32)], device="cpu").tt_cores
    cache = make_cache_state(11000, 4, 64, num_embeddings=11000,
                             device="cpu")
    params = TTEmbeddingParams(cores, (), cache=cache)
    args = (np.arange(0, 17, 2), np.zeros((1, 8, 64), np.float32),
            (0.1, 0.1))
    idx = np.arange(16)
    for kw in (dict(use_cache=True), dict(probe_cache=True)):
        step = make_fused_train_step(p, q, r, 1, 8, device="cpu", **kw)
        with pytest.raises(ValueError, match="wide"):  # wide rows, direct
            step(params, wide_keyrows(idx, p), *args)
        with pytest.raises(ValueError):  # a tuple of index parts
            step(params, tuple(torch.as_tensor(k) for k in
                               wide_keyrows(idx, p)[:, 2:].T), *args)
    wide = make_cache_state(64, 4, 64, wide_keys=3, device="cpu")
    assert wide.wide and tuple(wide.keys.shape) == (64, 5)


def test_port_trains_without_jax():
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "import fbtt_embedding_tpu_torch as m\n"
        "from fbtt_embedding_tpu_torch.ops import fused_optim\n"
        "from fbtt_embedding_tpu_torch.ops.kernels import seg_accum, "
        "seg_fused_i2, tt_flat\n"
        "p, q, r = [20, 22, 25], [4, 4, 4], [1, 8, 8, 1]\n"
        "cores = m.init_tt_cores(np.random.default_rng(0), 'uniform', 1,"
        " 11000, 64, p, q, r)\n"
        "rng = np.random.default_rng(1)\n"
        "nat = m.params_from_jax(cores, device='cpu')\n"
        "nat.optimizer_state = m.native_optim_init(m.OptimType.ADAM,"
        " nat.tt_cores)\n"
        "adam = m.make_fused_train_step(p, q, r, 1, 8,"
        " optimizer=m.OptimType.ADAM, optim_semantics='native',"
        " device='cpu')\n"
        "out, nat = adam(nat, rng.integers(0, 11000, 16),"
        " np.arange(0, 17, 2), rng.normal(size=(1, 8, 64)), (0.01, 1e-3))\n"
        "assert int(nat.optimizer_state[-1]) == 1\n"
        "for opt in (m.OptimType.SGD, m.OptimType.EXACT_ADAGRAD):\n"
        "    state = [np.zeros_like(c) for c in cores] "
        "if opt != m.OptimType.SGD else []\n"
        "    params = m.params_from_jax(cores, state, device='cpu')\n"
        "    step = m.make_fused_train_step(p, q, r, 1, 8, optimizer=opt,"
        " device='cpu')\n"
        "    for _ in range(2):\n"
        "        out, params = step(params, rng.integers(0, 11000, 16),"
        " np.arange(0, 17, 2), rng.normal(size=(1, 8, 64)), (0.01, 0.1))\n"
        "        assert out.shape == (1, 8, 64)\n"
        "leaves = [torch.as_tensor(c).requires_grad_() for c in cores]\n"
        "out = m.pooled_tt_lookup(leaves, p, q, r, 8,"
        " torch.arange(16) * 577, torch.arange(16) // 2)\n"
        "out.sum().backward()\n"
        "assert all(c.grad is not None for c in leaves)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'"
        " or k.startswith('jax.') or k.startswith('fbtt_embedding_tpu.')"
        " or k == 'fbtt_embedding_tpu')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_fused_train_step_defaults_to_cuda():
    import inspect

    sig = inspect.signature(make_fused_train_step)
    assert sig.parameters["device"].default == "cuda"
