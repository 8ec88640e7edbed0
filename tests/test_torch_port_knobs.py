"""PyTorch port vs the JAX package: the knob registry (CPU).

The port's counterparts of ``tests/test_kernel_knobs.py``:

- the registry: the port's ``PERF_KNOBS`` agree with JAX's (name and kind)
  for each knob carried, and the carried names plus the ones written out
  here as not carried are JAX's eleven; ``CONFIG_ENV``; every ``"FBTT_*"``
  string of the port's package registered and every perf knob read;
  ``describe``, ``get_int``, the unknown-name guard and ``python -m``;
- ``FBTT_PAIR``: the port's ``_pair_gate`` equal to JAX's under the knob
  unset, "0", "1" and "x" over nza around 16384 and the structural
  failures (tt_ndim 2, a table past the budget); the pooled flat lookup
  and its core gradients under "1" and "0" at a small nnz against JAX's
  ``make_flat_vjp`` (interpret mode) under the same setting, tt_ndim 3 and
  4 with a dead mask, rtol 1e-5; every entry that plans a lookup reads
  it, and the serving fold does not (as JAX's);
- ``FBTT_FUSED_APPLY``: SGD and Adagrad steps of ``make_fused_train_step``
  under "0" at nnz <= 32768 and "1" above (pair mode on and off) against
  JAX's step, rtol 1e-4, with a spy on ``flat_train_apply`` showing which
  side ran; "0", "1", "auto" and "x" all build and run; the
  data-parallel, table-owned and row-owned steps read it too (a gloo
  world of one CPU process, in a subprocess).

Every knob is set with ``monkeypatch.setenv`` and read at the next call.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbtt_embedding_tpu.models.tt_embedding import OptimType as JOptimType
from fbtt_embedding_tpu.models.tt_embedding import (
    TTEmbeddingParams as JParams,
    make_fused_train_step as j_make_step,
)
from fbtt_embedding_tpu.ops.pallas import tt_flat as jflat
from fbtt_embedding_tpu.utils import knobs as jknobs
import fbtt_embedding_tpu_torch as T
from fbtt_embedding_tpu_torch.models import tt_embedding as tmodel
from fbtt_embedding_tpu_torch.ops.kernels import tt_flat as tflat
from fbtt_embedding_tpu_torch.parallel.sharded import fixed_pool_lookup
from fbtt_embedding_tpu_torch.utils import knobs
from test_torch_port_flat import CASES, make_case
from test_torch_port_train import EPS, LR, STEP_CASES, _step_setup

ROOT = Path(__file__).resolve().parents[1]
# JAX's knobs the port does not carry (the reasons: the registry's docstring)
NOT_CARRIED = {"FBTT_SEG", "FBTT_SPAN_BLOCK", "FBTT_SPP", "FBTT_TRIP_SB",
               "FBTT_TRIP", "FBTT_ACC_T", "FBTT_PACK_PERM",
               "FBTT_HOT_SCATTER"}
VJP = dict(rtol=1e-5, atol=1e-7)  # test_pair_fusion_matches_ndim4_vjp's
STEP = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _knobs_unset(monkeypatch):
    """Each test starts with the perf knobs unset."""
    for name in knobs.PERF_KNOBS:
        monkeypatch.delenv(name, raising=False)


def _set(monkeypatch, env):
    for k, v in env.items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)


# -------------------------------------------------------------- registry


def test_registry_matches_jax():
    assert set(knobs.PERF_KNOBS) == {"FBTT_DG0", "FBTT_PAIR",
                                     "FBTT_FUSED_APPLY"}
    for name, (kind, _) in knobs.PERF_KNOBS.items():
        assert jknobs.PERF_KNOBS[name][0] == kind, name
    assert not set(knobs.PERF_KNOBS) & NOT_CARRIED
    assert set(knobs.PERF_KNOBS) | NOT_CARRIED == set(jknobs.PERF_KNOBS)
    assert len(jknobs.PERF_KNOBS) == 11
    assert knobs.CONFIG_ENV == jknobs.CONFIG_ENV
    for name in NOT_CARRIED | set(knobs.PERF_KNOBS) | set(knobs.CONFIG_ENV):
        assert name in knobs.__doc__, name


def test_registry_covers_every_env_read():
    """Every ``"FBTT_*"`` string in the port's package is registered, and
    every perf knob is read somewhere."""
    pkg = Path(knobs.__file__).resolve().parents[1]
    found = set()
    for f in pkg.rglob("*.py"):
        found |= set(re.findall(r'"(FBTT_[A-Z0-9_]+)"', f.read_text()))
    registered = set(knobs.PERF_KNOBS) | set(knobs.CONFIG_ENV)
    assert found <= registered, found - registered
    assert set(knobs.PERF_KNOBS) <= found, set(knobs.PERF_KNOBS) - found
    for name in knobs.CONFIG_ENV:  # parallel/multihost.py reads them
        assert name in found


def test_describe_get_int_and_unknown_names(monkeypatch):
    out = knobs.describe()
    for name, (_, default) in knobs.PERF_KNOBS.items():
        assert name in out and default in out
    assert out.count("<unset>") == len(knobs.PERF_KNOBS)
    monkeypatch.setenv("FBTT_PAIR", "1")
    line = [ln for ln in knobs.describe().splitlines() if "FBTT_PAIR" in ln]
    assert len(line) == 1 and "= 1 " in line[0]
    assert knobs.get_str("FBTT_PAIR") == "1"
    assert knobs.get_str("FBTT_FUSED_APPLY", "auto") == "auto"
    monkeypatch.setenv("FBTT_NUM_PROCESSES", "4")
    assert knobs.get_int("FBTT_NUM_PROCESSES") == 4
    monkeypatch.delenv("FBTT_COORDINATOR", raising=False)
    assert knobs.get_str("FBTT_COORDINATOR") is None
    monkeypatch.setenv("FBTT_PROCESS_ID", "")
    assert knobs.get_int("FBTT_PROCESS_ID") is None
    for bad in ("FBTT_NOT_A_KNOB", "FBTT_SEG", "FBTT_HOT_SCATTER"):
        with pytest.raises(KeyError):
            knobs.get_str(bad)
        with pytest.raises(KeyError):
            knobs.get_int(bad)


def test_knobs_module_entry_point():
    env = {"PATH": "/usr/bin:/bin", "FBTT_FUSED_APPLY": "0",
           "PYTHONPATH": str(ROOT)}
    res = subprocess.run(
        [sys.executable, "-m", "fbtt_embedding_tpu_torch.utils.knobs"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1 + len(knobs.PERF_KNOBS)
    fa = [ln for ln in lines if "FBTT_FUSED_APPLY" in ln][0]
    assert "= 0 " in fa and "auto (nnz <= 32768)" in fa


# ------------------------------------------------------------- FBTT_PAIR

HEADLINE = ([200, 220, 250], [4, 4, 4], [1, 32, 32, 1])
GATE_SHAPES = [
    (1,) + HEADLINE,
    (2,) + HEADLINE,                                         # two tables
    (1, [30, 40], [8, 8], [1, 16, 1]),                       # tt_ndim 2
    (1, [8, 9, 10, 11], [2, 4, 2, 2], [1, 8, 8, 8, 1]),      # tt_ndim 4
    (1, [1300, 1300, 1300], [4, 4, 4], [1, 32, 32, 1]),      # 1.7 GB table
    (1, [100, 100, 100], [4, 4, 4], [1, 32, 32, 1]),         # the DLRM's
    (8, [100, 100, 100], [4, 4, 4], [1, 32, 32, 1]),
]
GATE_NZA = [0, 64, 4096, 16320, 16383, 16384, 16448, 32768, 65536]


@pytest.mark.parametrize("env", [None, "0", "1", "x"])
def test_pair_gate_matches_jax(monkeypatch, env):
    _set(monkeypatch, {"FBTT_PAIR": env})
    for t, p, q, r in GATE_SHAPES:
        for itemsize in (2, 4):
            structural = tflat.pair_structural_ok(t, p, q, r, itemsize)
            assert structural == jflat.pair_structural_ok(t, p, q, r,
                                                          itemsize)
            for nza in GATE_NZA:
                got = tflat._pair_gate(nza, t, p, q, r, itemsize)
                assert got == jflat._pair_gate(nza, t, p, q, r, itemsize), \
                    (env, t, p, nza, itemsize)
                want = structural and (env == "1" if env in ("0", "1")
                                       else nza >= 16384)
                assert got == want
    # the structural gate holds under "1": tt_ndim 2, a table past 96 MiB
    assert not tflat.pair_structural_ok(1, [30, 40], [8, 8], [1, 16, 1], 2)
    assert not tflat.pair_structural_ok(1, [1300] * 3, [4, 4, 4],
                                        [1, 32, 32, 1], 2)


def _plan_spy(monkeypatch):
    """Records the ``pair`` flag of every plan the port builds."""
    seen = []
    build = tflat._build_plan

    def spy(*a, **k):
        seen.append(k.get("pair", False))
        return build(*a, **k)

    monkeypatch.setattr(tflat, "_build_plan", spy)
    return seen


PAIR_VJP_CASES = [
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=3),
    dict(p=[5, 6, 7, 4], q=[2, 2, 4, 2], ranks=[8, 8, 8], b=8, L=6),
]


@pytest.mark.parametrize("pair", ["1", "0"])
@pytest.mark.parametrize("case", PAIR_VJP_CASES)
def test_pair_knob_flat_vjp_matches_jax(monkeypatch, case, pair):
    """``FBTT_PAIR`` at nnz far below 16384: the port's ``FlatLookup``
    (forward and core gradients, weights, a dead mask) against JAX's
    ``make_flat_vjp`` in interpret mode under the same setting."""
    monkeypatch.setenv("FBTT_PAIR", pair)
    rfull, cores, idx, rowidx, _, _ = make_case(**case, seed=11)
    p, q, b = case["p"], case["q"], case["b"]
    nnz = idx.shape[0]
    w = np.random.default_rng(5).random(nnz).astype(np.float32)
    dead = np.arange(nnz) % 7 == 0
    d_out = np.random.default_rng(13).normal(
        size=(1, b, int(np.prod(q)))).astype(np.float32)
    fn = jflat.make_flat_vjp(tuple(p), tuple(q), tuple(rfull), 1, b, False,
                             True, True, True, live_is_mask=True)
    want_out, vjp = jax.vjp(
        lambda cs: fn(cs, jnp.asarray(idx), jnp.asarray(rowidx), None,
                      jnp.asarray(w), jnp.asarray(dead)),
        tuple(jnp.asarray(c) for c in cores))
    want = vjp(jnp.asarray(d_out))[0]
    seen = _plan_spy(monkeypatch)
    leaves = [torch.as_tensor(c).requires_grad_() for c in cores]
    out = tflat.flat_forward(leaves, torch.as_tensor(idx),
                             torch.as_tensor(rowidx), None,
                             torch.as_tensor(w), torch.as_tensor(dead), p, q,
                             rfull, 1, b, live_is_mask=True)
    got = torch.autograd.grad(out, leaves, torch.as_tensor(d_out))
    assert seen == [pair == "1"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **VJP)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **VJP)


def test_pair_knob_reaches_every_planned_lookup(monkeypatch):
    """``FlatLookup``, ``flat_train_apply``, the fused step, the module and
    the DLRM's ``fixed_pool_lookup`` read ``FBTT_PAIR`` at every call;
    unset keeps nza < 16384 out of pair mode."""
    case = CASES[1]
    rfull, cores, idx, rowidx, _, w = make_case(**case, seed=3)
    p, q, b = case["p"], case["q"], case["b"]
    d = int(np.prod(q))
    tc = [torch.as_tensor(c) for c in cores]
    d_out = torch.ones(1, b, d)
    offs = np.arange(0, idx.shape[0] + 1, case["L"])
    step = T.make_fused_train_step(p, q, rfull, 1, b, device="cpu")
    module = T.TTEmbeddingBag(
        num_embeddings=int(np.prod(p)), embedding_dim=d, tt_ranks=rfull[1:-1],
        tt_p_shapes=p, tt_q_shapes=q, use_cache=False, weight_dist="uniform",
        device="cpu")
    seen = _plan_spy(monkeypatch)
    calls = [
        lambda: tflat.flat_forward(tc, torch.as_tensor(idx),
                                   torch.as_tensor(rowidx), None, None, None,
                                   p, q, rfull, 1, b),
        lambda: tflat.flat_train_apply(tc, p, q, rfull, b,
                                       torch.as_tensor(idx),
                                       torch.as_tensor(rowidx), None, None,
                                       None, d_out),
        lambda: step(T.params_from_jax(cores, device="cpu"), idx, offs,
                     d_out, (LR, EPS)),
        lambda: module(idx, offs),
        lambda: fixed_pool_lookup(
            tc, torch.as_tensor(idx.reshape(1, b, case["L"])), p, q, rfull),
    ]
    for env, want in ((None, False), ("1", True), ("0", False),
                      ("x", False), ("1", True)):
        _set(monkeypatch, {"FBTT_PAIR": env})
        for call in calls:
            seen.clear()
            call()
            assert seen == [want], (env, call)


def test_serving_fold_ignores_pair_knob(monkeypatch):
    """The fold builds its pair table once, under the structural gate
    alone, whatever ``FBTT_PAIR`` says: as JAX's ``make_serving_fold``."""
    monkeypatch.setenv("FBTT_PAIR", "0")
    case = CASES[0]
    rfull, cores, *_ = make_case(**case, seed=2)
    p, q = case["p"], case["q"]
    _, g01f, _ = tflat.make_serving_fold([torch.as_tensor(c) for c in cores],
                                         p, q, rfull)
    _, jg01f, _ = jflat.make_serving_fold(
        tuple(jnp.asarray(c) for c in cores), p, q, rfull)
    assert g01f is not None and jg01f is not None
    np.testing.assert_allclose(g01f.numpy(), np.asarray(jg01f), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------ FBTT_FUSED_APPLY


def _apply_spy(monkeypatch):
    """Records every call of ``flat_train_apply`` by the steps."""
    calls = []
    apply = tmodel.flat_train_apply

    def spy(*a, **k):
        calls.append(1)
        return apply(*a, **k)

    monkeypatch.setattr(tmodel, "flat_train_apply", spy)
    return calls


# (env, STEP_CASES index, flat_train_apply runs): nnz 48 and 32800
FUSED_APPLY_RUNS = [
    ({"FBTT_FUSED_APPLY": "0"}, 0, False),
    ({"FBTT_FUSED_APPLY": "0", "FBTT_PAIR": "1"}, 0, False),
    ({"FBTT_FUSED_APPLY": "1"}, 5, True),          # pair mode by nza
    ({"FBTT_FUSED_APPLY": "1", "FBTT_PAIR": "0"}, 5, True),
    ({}, 0, True),
    ({}, 5, False),
]


@pytest.mark.parametrize("optimizer", ["SGD", "EXACT_ADAGRAD"])
@pytest.mark.parametrize("run", FUSED_APPLY_RUNS,
                         ids=lambda r: f"{r[0]}-case{r[1]}")
def test_fused_apply_knob_step_matches_jax(monkeypatch, run, optimizer):
    """Three steps of ``make_fused_train_step`` under the knob against JAX's
    step on the same batches (JAX's CPU step differentiates its lookup:
    the same function); the spy says which side ran."""
    env, cid, fused = run
    _set(monkeypatch, env)
    case = STEP_CASES[cid]
    p, q, rfull, nt, b, cores, state, batches = _step_setup(
        case, getattr(T.OptimType, optimizer))
    nnz = batches[0][0].shape[0]
    assert (nnz > 32768) == (cid == 5)
    jstep = j_make_step(p, q, rfull, nt, b,
                        optimizer=getattr(JOptimType, optimizer))
    tstep = T.make_fused_train_step(p, q, rfull, nt, b,
                                    optimizer=getattr(T.OptimType, optimizer),
                                    device="cpu")
    jparams = JParams(tuple(jnp.asarray(c) for c in cores),
                      tuple(jnp.asarray(s) for s in state), None)
    params = T.params_from_jax(cores, state, device="cpu")
    calls = _apply_spy(monkeypatch)
    seen = _plan_spy(monkeypatch)
    for idx, offs, d_out, w in batches:
        jout, jparams = jstep(jparams, jnp.asarray(idx), jnp.asarray(offs),
                              jnp.asarray(d_out),
                              (jnp.float32(LR), jnp.float32(EPS)),
                              None if w is None else jnp.asarray(w))
        out, params = tstep(params, idx, offs, d_out, (LR, EPS), w)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **STEP)
        for a, b_ in zip(list(params.tt_cores) + list(params.optimizer_state),
                         list(jparams.tt_cores)
                         + list(jparams.optimizer_state)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_), **STEP)
    assert len(calls) == (3 if fused else 0)
    pair = env.get("FBTT_PAIR", "1" if cid == 5 else "0") == "1"
    assert seen == [pair] * 3


@pytest.mark.parametrize("mode", ["0", "1", "auto", "x"])
def test_fused_apply_gate_parses(monkeypatch, mode):
    """Every setting builds and runs a step; "0" never takes
    ``flat_train_apply``, anything but "0" does at nnz <= 32768, and the
    gate has JAX's semantics at every nnz."""
    monkeypatch.setenv("FBTT_FUSED_APPLY", mode)
    for nnz in (0, 1, 32767, 32768, 32769, 10 ** 6):
        jax_rule = mode != "0" and (mode == "1" or nnz <= 32768)
        assert tmodel._fused_apply_gate(nnz) == jax_rule
    p, q, rfull, b = [8, 8, 8], [4, 4, 4], [1, 8, 8, 1], 16
    step = T.make_fused_train_step(p, q, rfull, 1, b, device="cpu")
    calls = _apply_spy(monkeypatch)
    rng = np.random.default_rng(0)
    params = T.params_from_jax(
        T.init_tt_cores(rng, "uniform", 1, 512, 64, p, q, rfull),
        device="cpu")
    idx = rng.integers(0, 512, size=4 * b)
    out, _ = step(params, idx, np.arange(0, 4 * b + 1, 4),
                  rng.normal(size=(1, b, 64)).astype(np.float32), (LR, EPS))
    assert out.shape == (1, b, 64) and torch.isfinite(out).all()
    assert len(calls) == (mode != "0")


# the sharded steps on a gloo world of one CPU process: how many times each
# ran flat_train_apply (one step each) under FBTT_FUSED_APPLY, and its
# output's largest difference from the single-device step's
SHARDED_SCRIPT = r"""
import json, os, sys
import numpy as np, torch
import fbtt_embedding_tpu_torch as fbt
from fbtt_embedding_tpu_torch.models import tt_embedding as tmodel

torch.set_num_threads(1)
fbt.initialize_distributed(sys.argv[1], 1, 0, backend="gloo", device="cpu")
mesh = fbt.make_mesh((1, 1), device_type="cpu")
calls = []
apply = tmodel.flat_train_apply

def spy(*a, **k):
    calls.append(1)
    return apply(*a, **k)

tmodel.flat_train_apply = spy
p, q, r, b, L, C = [20, 22, 25], [4, 4, 4], [1, 8, 8, 1], 16, 3, 64
e, d = 20 * 22 * 25, 64
rng = np.random.default_rng(0)
cores = fbt.init_tt_cores(rng, "uniform", 1, e, d, p, q, r)
idx = rng.integers(0, e, size=(1, b, L)).astype(np.int32)
dout = (rng.normal(size=(1, b, d)) * 0.1).astype(np.float32)
lr_eps = (0.05, 1.0)
flat = (idx.reshape(-1), np.arange(0, b * L + 1, L))

def params(cache=None):
    return fbt.TTEmbeddingParams(
        fbt.params_from_jax(cores, device="cpu").tt_cores, (), cache)

def dp():
    step = fbt.make_sharded_fused_train_step(mesh, p, q, r, 1, b, L,
                                             device="cpu")
    return step(params(), idx, dout, lr_eps)[0]

def table_owned():
    step = fbt.make_table_sharded_fused_train_step(mesh, p, q, r, 1, b, L,
                                                   device="cpu")
    prm = fbt.shard_table_sharded_params(mesh, params(), device="cpu")
    return step(prm, idx, dout, lr_eps)[0]

def row_owned():
    cache = fbt.make_cache_state(e, C, d, num_embeddings=e, device="cpu")
    prm = params(cache)
    count = fbt.make_fused_train_step(p, q, r, 1, b, use_cache=True,
                                      device="cpu")
    count(params(cache), *flat, dout, (0.0, 1.0))
    populate = fbt.make_row_owned_populate(mesh, p, q, r, C, device="cpu")
    prm.cache, w_owned, opt_owned = populate(cache, prm.tt_cores)
    step = fbt.make_row_owned_fused_train_step(mesh, p, q, r, C, b, L,
                                               device="cpu")
    calls.clear()  # the counting step's own call
    return step(prm, w_owned, opt_owned, idx, dout, lr_eps)[0]

res = {}
for mode in ("unset", "0", "1"):
    if mode == "unset":
        os.environ.pop("FBTT_FUSED_APPLY", None)
    else:
        os.environ["FBTT_FUSED_APPLY"] = mode
    single = fbt.make_fused_train_step(p, q, r, 1, b, device="cpu")
    want = single(params(), *flat, dout, lr_eps)[0]
    for name, run in (("dp", dp), ("table_owned", table_owned)):
        calls.clear()
        out = run()
        res[f"{name} {mode}"] = [len(calls),
                                 float((out - want).abs().max())]
    row_owned()
    res[f"row_owned {mode}"] = [len(calls), 0.0]
print(json.dumps(res))
"""


def test_fused_apply_knob_reaches_the_sharded_steps(tmp_path):
    """The data-parallel, table-owned and row-owned steps read
    ``FBTT_FUSED_APPLY`` through the single-device step's lookup, on a
    gloo world of one process: "0" never runs ``flat_train_apply``, unset
    and "1" do at nnz 48, and the first two steps' outputs match the
    single-device step's under the same knob. (The row-owned step counts
    and populates first; the cache rows' update is its own.)"""
    import json

    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    res = subprocess.run(
        [sys.executable, "-c", SHARDED_SCRIPT,
         f"file://{tmp_path / 'rendezvous'}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    for name in ("dp", "table_owned", "row_owned"):
        for mode, runs in (("unset", 1), ("0", 0), ("1", 1)):
            n, err = got[f"{name} {mode}"]
            assert n == runs, (name, mode, n)
            assert err <= 1e-6, (name, mode, err)
