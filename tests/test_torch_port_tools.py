"""PyTorch port vs the JAX package: the tooling (CPU).

- checkpoint: ``save`` / ``restore`` and ``save_npz`` / ``restore_npz``
  round-trips of the DLRM's params and of a trained cached module's
  params (zero-size leaves included); restore onto ``like``'s dtype and
  device, the shape and path checks; an npz written by the JAX package
  restored into the port's ``DLRMParams`` and ``TTEmbeddingParams``, and
  the other way round; a leaf-count mismatch raising in both packages;
- guard: the cases of ``tests/test_guard.py`` (finite flag, the leaf
  named, the sampled step guard), with the bad leaf's name equal to the
  JAX package's on the same structure;
- profiling: ``tt_flops`` equal to the JAX package's on the cases of
  ``tests/test_profiling.py``; ``slope_time``'s overhead subtraction on a
  deterministic fake clock; ``speed_of_light``'s fields, its H100 row and
  its fallbacks; ``trace`` / ``annotate`` writing a trace on the CPU;
- the benchmark CLI: ``validate_list``, ``generate_requests`` bitwise the
  JAX package's for the same seed (uniform, Zipf, reuse, weighted, fp16,
  int32), and the CLI run in process at ``tests/test_benchmark_cli.py``'s
  tiny shape, and with LFU counting, Adagrad, weights and the
  ``nn.EmbeddingBag`` baseline.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbtt_embedding_tpu import benchmark as jbench
from fbtt_embedding_tpu.models import dlrm as jdlrm
from fbtt_embedding_tpu.utils import checkpoint as jckpt
from fbtt_embedding_tpu.utils import guard as jguard
from fbtt_embedding_tpu.utils import profiling as jprof
from fbtt_embedding_tpu_torch import benchmark as tbench
from fbtt_embedding_tpu_torch import params_from_jax
from fbtt_embedding_tpu_torch.models import dlrm as tdlrm
from fbtt_embedding_tpu_torch.utils import checkpoint as tckpt
from fbtt_embedding_tpu_torch.utils import guard as tguard
from fbtt_embedding_tpu_torch.utils import profiling as tprof
from fbtt_embedding_tpu_torch.utils._tree import leaves_with_paths, map_leaves
from test_checkpoint import _trained_module

DLRM_KW = dict(num_tables=2, num_embeddings=216, embedding_dim=16,
               tt_p_shapes=[6, 6, 6], tt_q_shapes=[4, 2, 2], tt_ranks=[8, 8],
               dense_dim=4, bottom_mlp_dims=[16, 16], top_mlp_dims=[32, 1],
               pooling_factor=2)


def _leaves(tree):
    return [np.asarray(t) for _, t in leaves_with_paths(tree)]


def _dlrm_pair(seed=0):
    """The same DLRM params in both packages."""
    jp = jdlrm.init_dlrm_params(jdlrm.DLRMConfig(**DLRM_KW), seed=seed)
    return jp, tdlrm.dlrm_params_from_jax(jp, device="cpu")


def _module_pair():
    """A trained cached JAX module's params (Adagrad state, a populated
    cache, zero-size cache optimizer state) and the port's copy."""
    jp = _trained_module().params
    tp = params_from_jax(jp.tt_cores, jp.optimizer_state, device="cpu",
                         cache=jp.cache)
    return jp, tp


# ---------------------------------------------------------------- checkpoint


@pytest.mark.parametrize("which", ["dlrm", "module", "tree"])
@pytest.mark.parametrize("fmt", ["torch", "npz"])
def test_checkpoint_roundtrip(tmp_path, which, fmt):
    if which == "dlrm":
        state, fresh = _dlrm_pair(0)[1], _dlrm_pair(99)[1]
    elif which == "module":
        state = _module_pair()[1]
        fresh = map_leaves(torch.zeros_like, state)
    else:  # dicts (keys out of order), tuples, None, an empty leaf
        state = {"b": (torch.arange(5, dtype=torch.int32), None),
                 "a": [torch.randn(3, 2), torch.zeros(0)]}
        fresh = {"b": (torch.zeros(5, dtype=torch.int32), None),
                 "a": [torch.zeros(3, 2), torch.ones(0)]}
    path = str(tmp_path / ("ck.npz" if fmt == "npz" else "ck"))
    if fmt == "npz":
        tckpt.save_npz(path, state)
        got = tckpt.restore_npz(path, like=fresh)
    else:
        tckpt.save(path, state)
        got = tckpt.restore(path, like=fresh)
    assert type(got) is type(state)
    want_pairs, got_pairs = leaves_with_paths(state), leaves_with_paths(got)
    assert [p for p, _ in got_pairs] == [p for p, _ in want_pairs]
    for (path_, w), (_, g) in zip(want_pairs, got_pairs):
        assert g.dtype == w.dtype and g.shape == w.shape, path_
        assert torch.equal(g, w), path_
        assert g.data_ptr() != w.data_ptr() or not w.numel()
    if which == "tree":
        assert list(got) == ["b", "a"] and got["b"][1] is None


def test_restore_follows_like_and_checks(tmp_path):
    _, tp = _dlrm_pair(0)
    path = str(tmp_path / "ck")
    tckpt.save(path, tp)
    # without like: each leaf by its path
    flat = tckpt.restore(path)
    assert list(flat)[:2] == [".tt_cores[0]", ".tt_cores[1]"]
    assert torch.equal(flat[".top_mlp.biases[1]"], tp.top_mlp.biases[1])
    # like's dtype wins
    like = map_leaves(lambda t: t.double(), tp)
    got = tckpt.restore(path, like=like)
    assert got.tt_cores[0].dtype == torch.float64
    assert torch.equal(got.tt_cores[0].float(), tp.tt_cores[0])
    # a shape or structure mismatch raises
    other = tdlrm.init_dlrm_params(
        tdlrm.DLRMConfig(**{**DLRM_KW, "top_mlp_dims": [16, 1]}), seed=0,
        device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(path, like=other)
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore(path, like={"x": tp.tt_cores})


@pytest.mark.parametrize("which", ["dlrm", "module"])
def test_npz_crosses_between_packages(tmp_path, which):
    jp, tp = _dlrm_pair(3) if which == "dlrm" else _module_pair()
    # JAX writes, the port restores into its own structure
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_npz(jpath, jp)
    like = map_leaves(torch.zeros_like, tp)
    got = tckpt.restore_npz(jpath, like=like)
    want = [np.asarray(x) for x in jax.tree.leaves(jp)]
    assert len(want) == len(_leaves(got))
    for w, g in zip(want, _leaves(got)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    # the port writes, JAX restores into its structure
    tpath = str(tmp_path / "port.npz")
    tckpt.save_npz(tpath, tp)
    back = jckpt.restore_npz(tpath, like=jp)
    for w, g in zip(want, jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_npz_leaf_count_mismatch_raises(tmp_path):
    jp, tp = _dlrm_pair(0)
    path = str(tmp_path / "short.npz")
    np.savez(path, *_leaves(tp)[:-1])
    with pytest.raises(AssertionError, match="checkpoint has 10 leaves, "
                                            "expected 11"):
        jckpt.restore_npz(path, like=jp)
    with pytest.raises(ValueError, match="checkpoint has 10 leaves, "
                                         "expected 11"):
        tckpt.restore_npz(path, like=tp)


# --------------------------------------------------------------------- guard


def test_finite_flag_clean_and_dirty():
    tree = {"a": torch.ones((3, 4)), "b": [torch.zeros(2), torch.arange(5)]}
    flag = tguard.finite_flag(tree)
    assert flag.shape == () and flag.dtype == torch.bool and bool(flag)
    tree["b"][0] = torch.tensor([0.0, float("nan")])
    assert not bool(tguard.finite_flag(tree))
    # integer leaves (LFU counts, index tables) are ignored
    assert bool(tguard.finite_flag(
        {"counts": torch.full((4,), 2**31 - 1, dtype=torch.int32)}))
    assert not bool(tguard.finite_flag({"x": torch.tensor([float("inf")])}))
    assert bool(tguard.finite_flag({}))


def _jax_guard_name(jtree, what="params"):
    with pytest.raises(jguard.NonFiniteError) as e:
        jguard.assert_finite(jtree, what)
    return e.value.leaf_path, str(e.value)


@pytest.mark.parametrize("where", ["dict", "dlrm_core", "dlrm_mlp"])
def test_assert_finite_names_the_leaf_as_jax(where):
    if where == "dict":
        jtree = {"cores": [jnp.ones(3), jnp.array([1.0, jnp.inf])]}
        ttree = {"cores": [torch.ones(3), torch.tensor([1.0, float("inf")])]}
    else:
        jtree, ttree = _dlrm_pair(0)
        if where == "dlrm_core":
            jtree = jtree.replace(tt_cores=(
                jtree.tt_cores[0], jtree.tt_cores[1].at[0, 1, 2].set(jnp.nan),
                jtree.tt_cores[2]))
            ttree.tt_cores[1][0, 1, 2] = float("nan")
        else:
            top = jtree.top_mlp
            jtree = jtree.replace(top_mlp=top.replace(biases=(
                top.biases[0].at[3].set(-jnp.inf), top.biases[1])))
            ttree.top_mlp.biases[0][3] = float("-inf")
    want_path, want_msg = _jax_guard_name(jtree)
    with pytest.raises(tguard.NonFiniteError) as e:
        tguard.assert_finite(ttree)
    assert e.value.leaf_path == want_path
    assert str(e.value) == want_msg
    if where == "dlrm_core":
        assert want_path == "params.tt_cores[1]"


def test_guard_step_samples_and_raises():
    calls = {"n": 0}

    def step(params, x):
        calls["n"] += 1
        return x, {k: v / x for k, v in params.items()}

    g = tguard.guard_step(step, every=2)
    params = {"w": torch.ones(4)}
    # first call: not checked (every=2) even though x=0 poisons params
    _, params = g(params, torch.tensor(0.0))
    assert calls["n"] == 1
    # second call trips the sampled check and names the leaf
    with pytest.raises(tguard.NonFiniteError, match="w"):
        g(params, torch.tensor(1.0))
    with pytest.raises(ValueError):
        tguard.guard_step(step, every=0)


def test_guard_step_clean_passthrough():
    def step(params, x):
        return x, {k: v + x for k, v in params.items()}

    g = tguard.guard_step(step, every=1)
    params = {"w": torch.zeros(3)}
    for i in range(3):
        out, params = g(params, torch.tensor(float(i)))
    np.testing.assert_allclose(params["w"].numpy(), 3.0)


def test_guard_step_over_the_dlrm_step():
    cfg = tdlrm.DLRMConfig(**DLRM_KW)
    _, params = _dlrm_pair(0)
    step = tguard.guard_step(
        tdlrm.make_dlrm_train_step(cfg, learning_rate=0.05, device="cpu"),
        every=2)
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(16, 4)).astype(np.float32)
    idx = rng.integers(0, 216, size=(2, 16, 2)).astype(np.int32)
    labels = rng.integers(0, 2, size=16).astype(np.float32)
    for _ in range(4):
        _, params = step(params, dense, idx, labels)
    params.tt_cores[2][1, 0, 0] = float("nan")
    step(params, dense, idx, labels)  # the third call: not sampled
    with pytest.raises(tguard.NonFiniteError) as e:
        step(params, dense, idx, labels)
    assert e.value.leaf_path.startswith("params.")


# ----------------------------------------------------------------- profiling


@pytest.mark.parametrize("q,r,nnz", [
    ([4, 4, 4], [32, 32], 10240), ([8, 8], [16], 100),
    ([2, 3, 4, 5], [7, 11, 13], 10), ([4, 4, 4], [1, 32, 32, 1], 7),
])
def test_tt_flops_matches_jax(q, r, nnz):
    assert tprof.tt_flops(q, r, nnz) == jprof.tt_flops(q, r, nnz)
    assert tprof.tt_flops(q, r, nnz, 1.0) == jprof.tt_flops(q, r, nnz, 1.0)


def test_slope_time_subtracts_fixed_overhead(monkeypatch):
    """A fake clock: each ``run_k(k)`` advances it by a fixed 1 ms of
    overhead plus 0.1 ms a step; the slope is the step's time exactly."""
    now = {"t": 100.0}
    per_step, overhead = 1e-4, 1e-3
    runs = []

    def run_k(k):
        runs.append(k)
        now["t"] += overhead + per_step * k

    monkeypatch.setattr(tprof, "perf_counter", lambda: now["t"])
    est = tprof.slope_time(run_k, iters=40, k1=4)
    assert runs == [3, 4, 40]
    assert est == pytest.approx(per_step, rel=1e-9)
    assert tprof.slope_time(run_k, iters=50) == pytest.approx(per_step,
                                                              rel=1e-9)
    assert runs[-2:] == [5, 50]


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "cpu",
                                  "Frobnicator 9000"])
def test_speed_of_light(kind):
    sol = tprof.speed_of_light([200, 220, 250], [4, 4, 4], [32, 32],
                               nnz=10240, batch_size=512, device_kind=kind)
    jsol = jprof.speed_of_light([200, 220, 250], [4, 4, 4], [32, 32],
                                nnz=10240, batch_size=512, device_kind=kind)
    assert sol["device"] == kind
    assert sol["bound"] in ("compute", "memory")
    assert sol["t_sol_s"] == max(sol["t_compute_s"], sol["t_memory_s"]) > 0
    assert sol["flops"] == tprof.tt_flops([4, 4, 4], [32, 32], 10240)
    assert sol["bytes"] == jsol["bytes"] and sol["flops"] == jsol["flops"]
    if kind == "NVIDIA H100 80GB HBM3":
        # the data sheet's 3.35 TB/s: the headline step is memory-bound
        assert sol["t_memory_s"] == pytest.approx(sol["bytes"] / 3.35e12)
        assert sol["t_compute_s"] == pytest.approx(sol["flops"] / 989e12)
        assert sol["bound"] == "memory"
    else:  # JAX's rows for the CPU and for an unknown kind
        assert sol == jsol


def test_speed_of_light_default_device():
    sol = tprof.speed_of_light([8, 8, 8], [2, 2, 2], [8, 8], nnz=64,
                               batch_size=8)
    want = torch.cuda.get_device_name() if torch.cuda.is_available() \
        else "cpu"
    assert sol["device"] == want


def test_trace_and_annotate_smoke(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.annotate("unit-smoke"):
            torch.square(torch.arange(8.0)).sum().item()
    files = list(tmp_path.rglob("*.json"))
    assert files, "trace produced no files"
    assert "unit-smoke" in files[0].read_text()
    assert any(e.key == "unit-smoke" for e in prof.key_averages())


# --------------------------------------------------------------------- CLI


def test_validate_list():
    assert tbench.validate_list("200,220,250") == [200, 220, 250]
    with pytest.raises(ValueError):
        tbench.validate_list("0,2")


@pytest.mark.parametrize("kw", [
    dict(iters=3, b=8, t=2, length=4, num_embeddings=1000, reuse=0.5),
    dict(iters=1, b=16, t=1, length=8, num_embeddings=10_000, alpha=1.5,
         weighted=True),
    dict(iters=2, b=8, t=1, length=4, num_embeddings=1000, weighted=True,
         fp16=True),
    dict(iters=1, b=8, t=1, length=4, num_embeddings=1000, long_index=False),
    dict(iters=2, b=512, t=1, length=20, num_embeddings=11_000_000,
         alpha=1.05, reuse=0.1),
])
def test_generate_requests_bitwise_jax(kw):
    want = jbench.generate_requests(np.random.default_rng(5), **kw)
    got = tbench.generate_requests(np.random.default_rng(5), **kw)
    assert len(got) == len(want) == kw["iters"]
    for (wi, wo, ww), (gi, go, gw) in zip(want, got):
        for w, g in ((wi, gi), (wo, go)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        if ww is None:
            assert gw is None
        else:
            assert gw.dtype == ww.dtype
            np.testing.assert_array_equal(gw, ww)


@pytest.mark.parametrize("extra,lines", [
    # tests/test_benchmark_cli.py's tiny shape, in process
    (["--impl", "xla", "--no-cache"], 1),
    # the defaults' counting step, Adagrad, weights and the baseline
    (["--optimizer", "adagrad", "--weighted", "--run-baseline"], 3),
])
def test_cli_in_process(caplog, extra, lines):
    argv = ["--batch-size", "16", "--pooling-factor", "2", "--iters", "4",
            "--p-shapes", "8,9,10", "--q-shapes", "4,2,2", "--ranks", "8,8",
            "--device", "cpu"] + extra
    with caplog.at_level(logging.INFO, logger="fbtt_benchmark"):
        res = tbench.main(argv)
    text = caplog.text
    assert "TTEmbeddingBag FWD-BWD time/nnz" in text
    assert "device: cpu" in text
    assert res["device"] == "cpu" and res["nnz"] == 32
    assert np.isfinite(res["tt_us_per_nnz"])
    if lines > 1:
        assert "EmbeddingBag FWD-BWD time/nnz" in text.replace(
            "TTEmbeddingBag FWD-BWD", "")
        assert "TT vs uncompressed" in text
        assert np.isfinite(res["baseline_us_per_nnz"])
