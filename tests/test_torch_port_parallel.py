"""PyTorch port vs the JAX package: the multi-GPU layer (CPU, gloo worlds).

The port runs as ``torch.distributed`` worlds of 2 and 4 CPU processes
(``fbtt_embedding_tpu_torch.examples.multihost_smoke``, one rank per
process, gloo, a ``file://`` rendezvous in ``tmp_path``), each world
launched once for the module with every case in one ``cases.npz``; the
workers import only the port. JAX runs the same cases on its 8-device CPU
mesh (``tests/conftest.py``) at the same mesh shape, on the first 2 or 4
devices. Every rank's result is its block; the blocks are assembled here.

Cases mirror ``tests/test_sharding.py`` (the mesh shapes, the
data-parallel and table-sharded lookups at (2, 2), (1, 4) and (1, 2) with
their gradients, the data-parallel fused step over its optimisers, table
batched, sampled counting, hashed and wide-key caches, the CSR padding and
adapter cases), ``tests/test_dlrm.py``'s mesh step at (2, 2) and
``tests/test_guard.py``'s replica drift, plus the two-process smoke of
``tests/test_multihost.py``. Tolerances: outputs and updates rtol 1e-5
(the float32 plain versions, only the summation order differs), counts
and keys exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fbtt_embedding_tpu.models import dlrm as jdlrm
from fbtt_embedding_tpu.models.tt_embedding import (
    OptimType,
    TTEmbeddingParams,
)
from fbtt_embedding_tpu.ops import cache as jc
from fbtt_embedding_tpu.parallel.mesh import make_mesh as j_make_mesh
from fbtt_embedding_tpu.parallel.sharded import (
    _fixed_pool_lookup,
    make_dp_lookup as j_dp_lookup,
    make_sharded_fused_train_step as j_sharded_step,
    make_table_sharded_lookup as j_table_lookup,
    shard_params_for_table_parallel as j_shard_cores,
)
from fbtt_embedding_tpu.utils.init import init_tt_cores
from fbtt_embedding_tpu_torch.ops.indexing import pad_csr_to_fixed
from fbtt_embedding_tpu_torch.parallel.mesh import default_mesh_shape
from test_dlrm import CFG as DLRM_CFG

ROOT = Path(__file__).resolve().parents[1]
P, Q, R = [8, 8, 8], [4, 4, 4], [1, 8, 8, 1]
E, D = 512, 64
OUT = dict(rtol=1e-5, atol=1e-5)
UPD = dict(rtol=1e-5, atol=1e-6)
LR_EPS = (0.05, 1e-10)


def _cores(num_tables, seed, p=P, q=Q, r=R, e=E, d=D):
    rng = np.random.default_rng(seed)
    cores = [np.asarray(c, np.float32) for c in init_tt_cores(
        rng, "uniform", num_tables, e, d, p, q, r)]
    return cores, rng


def _jmesh(shape, axes):
    n = int(np.prod(shape))
    return j_make_mesh(shape=shape, axis_names=axes,
                       devices=jax.devices()[:n])


def _seq(arrays, case, field, xs):
    for i, x in enumerate(xs):
        arrays[f"{case}/{field}/{i}"] = np.asarray(x)


# ------------------------------------------------------------- the cases

def _lookup_cases(world):
    """(spec, arrays) of the lookups: data-parallel over every rank, and
    table-sharded at the shapes of this world (T=8, B=16, L=4: the JAX
    tests'), with the cores' gradients of a squared error."""
    specs, arrays = [], {}
    cores, rng = _cores(2, 0)
    arrays["dp_lookup/indices"] = rng.integers(0, E, (2, 32, 5)).astype(
        np.int32)
    _seq(arrays, "dp_lookup", "cores", cores)
    specs.append(dict(name="dp_lookup", kind="dp_lookup", mesh=[world],
                      axes=["dp"], p=P, q=Q, r=R))
    shapes = [(1, 2)] if world == 2 else [(2, 2), (1, 4)]
    for shape in shapes:
        name = f"table_lookup_{shape[0]}x{shape[1]}"
        cores, rng = _cores(8, 0)
        _seq(arrays, name, "cores", cores)
        arrays[f"{name}/indices"] = rng.integers(0, E, (8, 16, 4)).astype(
            np.int32)
        arrays[f"{name}/target"] = rng.normal(size=(8, 16, D)).astype(
            np.float32)
        specs.append(dict(name=name, kind="table_lookup", mesh=list(shape),
                          p=P, q=Q, r=R))
    return specs, arrays


def _populated(cores, kind, cache_size, hot, hashtbl_size=E, **kw):
    """A JAX cache of the cores (D wide), counted on ``hot`` and
    populated."""
    cache = jc.make_cache_state(hashtbl_size, cache_size, D, kind, **kw)
    cache = jc.update_cache_state(cache, jnp.asarray(hot))
    return jc.cache_populate(cache, tuple(jnp.asarray(c) for c in cores),
                             P, Q, R)


def _step_case(name, world, cores, opt, cache, indices, d_out, weights=None,
               **spec):
    arrays = {}
    _seq(arrays, name, "cores", cores)
    _seq(arrays, name, "opt", opt)
    if cache is not None:
        _seq(arrays, name, "cache", [np.asarray(getattr(cache, f)) for f in (
            "keys", "freq", "slots", "weight", "opt_state")])
    arrays[f"{name}/indices"] = np.asarray(indices)
    arrays[f"{name}/d_out"] = np.asarray(d_out, np.float32)
    if weights is not None:
        arrays[f"{name}/weights"] = np.asarray(weights, np.float32)
    arrays[f"{name}/lr"] = np.float32(LR_EPS[0])
    arrays[f"{name}/eps"] = np.float32(LR_EPS[1])
    spec = dict(name=name, kind="dp_step", mesh=[world], axes=["dp"],
                p=spec.pop("p", P), q=spec.pop("q", Q), r=R, **spec)
    return spec, arrays


OPTIM_CASES = [("sgd", False), ("sgd", True), ("exact_adagrad", True),
               ("rowwise", True)]
OPTIMS = {"sgd": "SGD", "exact_adagrad": "EXACT_ADAGRAD",
          "rowwise": "EXACT_ROWWISE_ADAGRAD"}


def _optim_case(optim_name, use_cache, world):
    """``test_sharded_fused_train_step_matches_single_device``'s inputs."""
    t, b, length = 1, 32, 4
    nnz = t * b * length
    cores, rng = _cores(t, 11)
    is_sgd = optim_name == "sgd"
    opt = ([np.zeros(0, np.float32)] * len(cores) if is_sgd
           else [np.zeros_like(c) for c in cores])
    cache = None
    if use_cache:
        kind = {"sgd": "none", "exact_adagrad": "full",
                "rowwise": "rowwise"}[optim_name]
        cache = _populated(cores, kind, 32,
                           np.tile(np.arange(32), 8).astype(np.int32),
                           num_embeddings=E)
    idx = np.where(rng.random(nnz) < 0.5, rng.integers(0, 32, size=nnz),
                   rng.integers(0, E, size=nnz)).astype(np.int32)
    d_out = rng.normal(size=(t, b, D)).astype(np.float32) * 0.1
    w = rng.random(nnz).astype(np.float32).reshape(t, b, length)
    return _step_case(f"step_{optim_name}_{int(use_cache)}", world, cores,
                      opt, cache, idx.reshape(t, b, length), d_out, w,
                      T=t, B=b, L=length, optimizer=OPTIMS[optim_name],
                      use_cache=use_cache, probe_cache=use_cache)


def _native_case(world):
    """``optim_semantics="native"``: ADAM's own update (its moments and
    step counter from ``native_optim_init``), LFU counting on."""
    from fbtt_embedding_tpu.ops.fused_optim import native_optim_init

    t, b, length = 1, 32, 4
    cores, rng = _cores(t, 17)
    opt = [np.asarray(s) for s in native_optim_init(
        OptimType.ADAM, tuple(jnp.asarray(c) for c in cores))]
    cache = jc.make_cache_state(E, 32, D, "none", num_embeddings=E)
    idx = rng.integers(0, E, size=(t, b, length)).astype(np.int32)
    d_out = rng.normal(size=(t, b, D)).astype(np.float32) * 0.1
    return _step_case("step_native_adam", world, cores, opt, cache, idx,
                      d_out, T=t, B=b, L=length, optimizer="ADAM",
                      use_cache=True, optim_semantics="native")


def _pallas_case(world):
    """``impl="pallas"``: the step differentiates the generic lookup
    (``GenericLookup``, kernels B4 / B5 on the card) in place of
    ``flat_train_apply``; Adagrad, two tables."""
    t, b, length = 2, 16, 3
    cores, rng = _cores(t, 23)
    idx = rng.integers(0, E, size=(t, b, length)).astype(np.int32)
    d_out = rng.normal(size=(t, b, D)).astype(np.float32) * 0.1
    w = rng.random(size=(t, b, length)).astype(np.float32)
    return _step_case("step_pallas", world, cores,
                      [np.zeros_like(c) for c in cores], None, idx, d_out, w,
                      T=t, B=b, L=length, optimizer="EXACT_ADAGRAD",
                      impl="pallas")


def _table_batched_case(world):
    t, b, length = 3, 16, 2
    cores, rng = _cores(t, 5)
    idx = rng.integers(0, E, size=t * b * length).astype(np.int32)
    d_out = rng.normal(size=(t, b, D)).astype(np.float32) * 0.1
    return _step_case("step_table_batched", world, cores,
                      [np.zeros_like(c) for c in cores], None,
                      idx.reshape(t, b, length), d_out, T=t, B=b, L=length,
                      optimizer="EXACT_ADAGRAD")


def _sampled_case(world):
    """``test_sharded_fused_step_sampled_counting_and_cache_guard``: one
    call with ``count=False``, one with ``count=True`` (interval 2)."""
    q16 = [4, 2, 2]
    rng = np.random.default_rng(2)
    cores = [np.asarray(c, np.float32) for c in init_tt_cores(
        rng, "uniform", 1, E, 16, P, q16, R)]
    cache = jc.make_cache_state(E, 32, 16, "none", num_embeddings=E)
    b, length = 8, 4
    idx = rng.integers(0, E, size=(1, b, length)).astype(np.int32)
    d_out = rng.normal(size=(1, b, 16)).astype(np.float32) * 0.01
    spec, arrays = _step_case(
        "step_sampled", world, cores, [np.zeros(0, np.float32)] * 3, cache,
        idx, d_out, q=q16, T=1, B=b, L=length, optimizer="SGD",
        use_cache=True, count_interval=2,
        calls=[{"count": False}, {"count": True}])
    arrays["step_sampled/lr"] = np.float32(0.01)
    return spec, arrays


def _hashed_case(world):
    t, b, length = 1, 32, 4
    nnz = b * length
    cores, rng = _cores(t, 31)
    cache = _populated(cores, "none", 16,
                       np.tile(np.arange(16), 8).astype(np.int32),
                       hashtbl_size=128)
    assert not cache.direct and not cache.wide
    idx = np.where(rng.random(nnz) < 0.5, rng.integers(0, 16, size=nnz),
                   rng.integers(0, E, size=nnz)).astype(np.int32)
    d_out = rng.normal(size=(t, b, D)).astype(np.float32) * 0.1
    return _step_case("step_hashed", world, cores,
                      [np.zeros(0, np.float32)] * 3, cache,
                      idx.reshape(t, b, length), d_out, T=t, B=b, L=length,
                      optimizer="SGD", use_cache=True, probe_cache=True)


P_BIG = [1300, 1300, 1300]  # prod > 2**31: wide key rows


def _wide_case(world):
    e_big = int(np.prod(P_BIG))
    t, b, length = 1, 16, 4
    nnz = b * length
    rng = np.random.default_rng(33)
    cores = [np.asarray(c, np.float32) for c in init_tt_cores(
        rng, "uniform", 1, e_big, D, P_BIG, Q, R)]
    cache = jc.make_cache_state(256, 8, D, "none", wide_keys=3)
    hot = rng.integers(2**31, e_big, size=4, dtype=np.int64)
    cache = jc.update_cache_state(cache, jc.wide_cache_keys(np.tile(hot, 8),
                                                            P_BIG))
    cache = jc.cache_populate(cache, tuple(jnp.asarray(c) for c in cores),
                              P_BIG, Q, R)
    ids = np.where(rng.random(nnz) < 0.5, hot[rng.integers(0, 4, size=nnz)],
                   rng.integers(0, e_big, size=nnz, dtype=np.int64))
    ids[rng.choice(nnz, size=6, replace=False)] = -1  # pads
    keyrows = np.asarray(jc.wide_cache_keys(ids, P_BIG))
    d_out = rng.normal(size=(t, b, D)).astype(np.float32) * 0.1
    spec, arrays = _step_case(
        "step_wide", world, cores, [np.zeros(0, np.float32)] * 3, cache,
        keyrows.reshape(t, b, length, keyrows.shape[1]), d_out, p=P_BIG,
        T=t, B=b, L=length, optimizer="SGD", use_cache=True,
        probe_cache=True)
    # the port zeroes the pads' weight itself; JAX is given it (its wide
    # mode keeps weight 1 on pads without weights, ROADMAP §C)
    arrays["step_wide/jax_weights"] = (ids >= 0).astype(
        np.float32).reshape(t, b, length)
    return spec, arrays


def _ragged(rng, b, lmax, full_first=False):
    lens = rng.integers(0, lmax + 1, size=b)
    if full_first:
        lens[0], lens[1] = lmax, 1
    offsets = np.zeros(b + 1, np.int32)
    offsets[1:] = np.cumsum(lens)
    return offsets


def _csr_cases(world):
    """``test_csr_padding_feeds_sharded_step`` (weights),
    ``test_csr_pads_safe_without_weights_and_with_cached_last_row`` and
    ``test_csr_step_adapter_direct_csr_api`` (each rank's CSR block
    through ``csr_step_adapter``)."""
    out = []
    b = 32
    # padding with weights, Lmax 5
    rng = np.random.default_rng(41)
    cores, _ = _cores(1, 41)
    cache = _populated(cores, "none", 16,
                       np.tile(np.arange(16), 8).astype(np.int32),
                       num_embeddings=E)
    offs = _ragged(rng, b, 5)
    nnz = int(offs[-1])
    idx = np.where(rng.random(nnz) < 0.5, rng.integers(0, 16, size=nnz),
                   rng.integers(0, E, size=nnz)).astype(np.int32)
    w = rng.random(nnz).astype(np.float32)
    d_out = rng.normal(size=(1, b, D)).astype(np.float32) * 0.1
    idx_pad, w_pad = pad_csr_to_fixed(idx, offs, 1, b, 5, weights=w)
    spec, arrays = _step_case("csr_pad", world, cores,
                              [np.zeros(0, np.float32)] * 3, cache, idx_pad,
                              d_out, w_pad, T=1, B=b, L=5, optimizer="SGD",
                              use_cache=True, probe_cache=True)
    arrays.update({"csr_pad/csr_indices": idx, "csr_pad/csr_offsets": offs,
                   "csr_pad/csr_weights": w})
    out.append((spec, arrays))
    # pads without weights, the last row cached, Lmax 4
    cores, rng = _cores(1, 81)
    cache = _populated(cores, "none", 4, np.tile(
        np.array([E - 1, 0, 1, 2]), 8).astype(np.int32), num_embeddings=E)
    offs = _ragged(rng, b, 4, full_first=True)
    nnz = int(offs[-1])
    idx = np.where(rng.random(nnz) < 0.5, np.full(nnz, E - 1),
                   rng.integers(0, E, size=nnz)).astype(np.int32)
    d_out = rng.normal(size=(1, b, D)).astype(np.float32) * 0.1
    idx_pad, _ = pad_csr_to_fixed(idx, offs, 1, b, 4)
    spec, arrays = _step_case("csr_noweights", world, cores,
                              [np.zeros(0, np.float32)] * 3, cache, idx_pad,
                              d_out, T=1, B=b, L=4, optimizer="SGD",
                              use_cache=True, probe_cache=True)
    arrays.update({"csr_noweights/csr_indices": idx,
                   "csr_noweights/csr_offsets": offs})
    out.append((spec, arrays))
    # the adapter: each rank's CSR block, no cache
    cores, rng = _cores(1, 91)
    offs = _ragged(rng, b, 4)
    nnz = int(offs[-1])
    idx = rng.integers(0, E, size=nnz).astype(np.int32)
    d_out = rng.normal(size=(1, b, D)).astype(np.float32) * 0.1
    idx_pad, _ = pad_csr_to_fixed(idx, offs, 1, b, 4)
    spec, arrays = _step_case("csr_adapter", world, cores,
                              [np.zeros(0, np.float32)] * 3, None, idx_pad,
                              d_out, T=1, B=b, L=4, optimizer="SGD",
                              csr="adapter")
    arrays.update({"csr_adapter/csr_indices": idx,
                   "csr_adapter/csr_offsets": offs})
    out.append((spec, arrays))
    return out


DLRM_B, DLRM_STEPS, DLRM_LR = 32, 3, 0.05


def _dlrm_case():
    """``tests/test_dlrm.py::test_dlrm_sharded_matches_single_device`` at
    (dp, mp) = (2, 2)."""
    rng = np.random.default_rng(2)
    c = DLRM_CFG
    dense = rng.normal(size=(DLRM_B, c.dense_dim)).astype(np.float32)
    indices = rng.integers(0, c.num_embeddings, size=(
        c.num_tables, DLRM_B, c.pooling_factor)).astype(np.int32)
    labels = rng.integers(0, 2, size=(DLRM_B,)).astype(np.float32)
    params = jdlrm.init_dlrm_params(c, seed=3, weight_dist="normal")
    arrays = {"dlrm/dense": dense, "dlrm/indices": indices,
              "dlrm/labels": labels}
    _seq(arrays, "dlrm", "cores", params.tt_cores)
    for pre, m in (("bottom", params.bottom_mlp), ("top", params.top_mlp)):
        _seq(arrays, "dlrm", pre + "_w", m.weights)
        _seq(arrays, "dlrm", pre + "_b", m.biases)
    cfg = dict(num_tables=c.num_tables, num_embeddings=c.num_embeddings,
               embedding_dim=c.embedding_dim, tt_p_shapes=c.tt_p_shapes,
               tt_q_shapes=c.tt_q_shapes, tt_ranks=c.tt_ranks[1:-1],
               dense_dim=c.dense_dim, bottom_mlp_dims=c.bottom_mlp_dims,
               top_mlp_dims=c.top_mlp_dims, pooling_factor=c.pooling_factor)
    spec = dict(name="dlrm", kind="dlrm", mesh=[2, 2], cfg=cfg,
                steps=DLRM_STEPS, lr=DLRM_LR)
    return spec, arrays


def _world_cases(world):
    specs, arrays = _lookup_cases(world)
    parts = ([_optim_case(o, c, world) for o, c in OPTIM_CASES]
             + [_table_batched_case(world), _sampled_case(world),
                _hashed_case(world), _wide_case(world), _native_case(world),
                _pallas_case(world)]
             + _csr_cases(world)) if world == 4 else [
        _optim_case("sgd", True, world)]
    if world == 4:
        parts += [_dlrm_case()]
        specs += [dict(name="walkthrough", kind="walkthrough", mesh=[2, 2],
                       steps=WALK_STEPS),
                  dict(name="replicas", kind="replicas", mesh=[2, 2]),
                  dict(name="mesh", kind="mesh", mesh=[2, 2]),
                  dict(name="shard_error", kind="shard_error", mesh=[1, 4],
                       T=6)]
    else:
        specs.append(dict(name="shard_error", kind="shard_error",
                          mesh=[1, 2], T=3))
    for spec, a in parts:
        specs.append(spec)
        arrays.update(a)
    return specs, arrays


# ------------------------------------------------------------- the worlds

class _World:
    """A launched world of ``n`` ranks running every case of ``cases(n)``
    (this module's by default); :meth:`result` waits for it once."""

    def __init__(self, n: int, tmp: Path, cases=None):
        self.n, self.tmp = n, tmp
        specs, arrays = (cases or _world_cases)(n)
        self.specs = {s["name"]: s for s in specs}
        np.savez(tmp / "cases.npz", __spec__=np.asarray(json.dumps(specs)),
                 **arrays)
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                  "LOCAL_RANK", "FBTT_COORDINATOR", "FBTT_NUM_PROCESSES",
                  "FBTT_PROCESS_ID"):
            env.pop(k, None)
        self.procs = [subprocess.Popen(
            [sys.executable, "-m",
             "fbtt_embedding_tpu_torch.examples.multihost_smoke",
             "--coordinator", f"file://{tmp / 'rendezvous'}",
             "--num-processes", str(n), "--process-id", str(r),
             "--device", "cpu", "--timeout", "240",
             "--inputs", str(tmp / "cases.npz"),
             "--outputs", str(tmp / "out")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(ROOT)) for r in range(n)]
        self._res = None

    def result(self):
        if self._res is None:
            logs = []
            try:
                for p in self.procs:
                    out, err = p.communicate(timeout=400)
                    logs.append((p.returncode, out, err))
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for rc, out, err in logs:
                assert rc == 0, f"a rank failed (exit {rc}):\n{err[-4000:]}"
            ranks = []
            for r in range(self.n):
                with np.load(self.tmp / "out" / f"rank{r}.npz") as z:
                    ranks.append({k: z[k] for k in z.files})
            self._res = (logs, ranks)
        return self._res

    def ranks(self):
        return self.result()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds of 2 and 4 ranks, both launched at once."""
    made = {n: _World(n, tmp_path_factory.mktemp(f"world{n}"))
            for n in (2, 4)}
    yield made
    for w in made.values():
        for p in w.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _cat(ranks, key, axis=1):
    """The ranks' blocks of ``key`` concatenated in rank order."""
    return np.concatenate([r[key] for r in ranks], axis=axis)


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


# ------------------------------------------------------------- the tests

def test_make_mesh_shapes():
    """The default mesh shape of n = 1..8 devices is the JAX package's."""
    for n in range(1, 9):
        want = j_make_mesh(devices=jax.devices()[:n]).devices.shape
        assert default_mesh_shape(n) == tuple(want), n
        assert default_mesh_shape(n, 1) == (n,)


def test_two_process_smoke(worlds):
    """``tests/test_multihost.py``: each rank of the 2-process world passes
    the smoke (hybrid mesh, table-sharded lookup, data-parallel step) and
    prints MULTIHOST_OK; no worker imported JAX or the JAX package."""
    for n in (2, 4):
        logs, ranks = worlds[n].result()
        for rc, out, err in logs:
            assert "MULTIHOST_OK" in out, (out, err[-2000:])
        for r in ranks:
            assert int(r["__worker__/jax_imported"]) == 0


def test_dp_lookup_matches_local(worlds):
    ranks = worlds[4].ranks()
    cores, rng = _cores(2, 0)
    idx = rng.integers(0, E, (2, 32, 5)).astype(np.int32)
    mesh = _jmesh((4,), ("dp",))
    jcores = tuple(jnp.asarray(c) for c in cores)
    out = j_dp_lookup(mesh, P, Q, R)(jcores, jnp.asarray(idx))
    ref = _fixed_pool_lookup(jcores, jnp.asarray(idx), P, Q, R)
    got = _cat(ranks, "dp_lookup/out")
    np.testing.assert_allclose(got, np.asarray(out), **OUT)
    np.testing.assert_allclose(got, np.asarray(ref), **OUT)


@pytest.mark.parametrize("world,shape", [(4, (2, 2)), (4, (1, 4)),
                                         (2, (1, 2))])
def test_table_sharded_lookup_matches_local(worlds, world, shape):
    ranks = worlds[world].ranks()
    name = f"table_lookup_{shape[0]}x{shape[1]}"
    cores, rng = _cores(8, 0)
    idx = rng.integers(0, E, (8, 16, 4)).astype(np.int32)
    mesh = _jmesh(shape, ("dp", "mp"))
    lookup = j_table_lookup(mesh, P, Q, R)
    jcores = tuple(jnp.asarray(c) for c in cores)
    out = jax.jit(lookup)(j_shard_cores(mesh, jcores), jnp.asarray(idx))
    np.testing.assert_allclose(_cat(ranks, f"{name}/out"), np.asarray(out),
                               **OUT)


@pytest.mark.parametrize("world,shape", [(4, (2, 2)), (4, (1, 4)),
                                         (2, (1, 2))])
def test_table_sharded_gradients_match_local(worlds, world, shape):
    """Core gradients through the exchange (and the dp sum) equal JAX's:
    each rank holds its block of tables."""
    ranks = worlds[world].ranks()
    name = f"table_lookup_{shape[0]}x{shape[1]}"
    cores, rng = _cores(8, 0)
    idx = jnp.asarray(rng.integers(0, E, (8, 16, 4)).astype(np.int32))
    target = jnp.asarray(rng.normal(size=(8, 16, D)).astype(np.float32))
    mesh = _jmesh(shape, ("dp", "mp"))
    lookup = j_table_lookup(mesh, P, Q, R)
    grads = jax.jit(jax.grad(
        lambda c: jnp.mean((lookup(c, idx) - target) ** 2)))(
        j_shard_cores(mesh, tuple(jnp.asarray(c) for c in cores)))
    mp, tl = shape[1], 8 // shape[1]
    for i, g in enumerate(grads):
        g = np.asarray(g)
        for rank, res in enumerate(ranks):
            m = rank % mp
            np.testing.assert_allclose(res[f"{name}/grad/{i}"],
                                       g[m * tl:(m + 1) * tl], rtol=1e-5,
                                       atol=1e-7)


def _j_params(spec, cores, opt, cache):
    return TTEmbeddingParams(tuple(jnp.asarray(c) for c in cores),
                             tuple(jnp.asarray(o) for o in opt), cache)


def _check_step(ranks, name, out, prm, k=0):
    """The world's step ``k`` of case ``name`` against JAX's result: the
    output blocks in rank order, the replicated state equal on every rank
    and within rtol 1e-5 of JAX's, counts and keys exact."""
    pre = f"{name}/{k}"
    np.testing.assert_allclose(_cat(ranks, f"{pre}/out"), np.asarray(out),
                               **OUT)
    for i, c in enumerate(prm.tt_cores):
        np.testing.assert_allclose(_same_on_every_rank(ranks,
                                                       f"{pre}/core/{i}"),
                                   np.asarray(c), **UPD)
    for i, s in enumerate(prm.optimizer_state):
        np.testing.assert_allclose(_same_on_every_rank(ranks,
                                                       f"{pre}/opt/{i}"),
                                   np.asarray(s), **UPD)
    if prm.cache is not None:
        for f in ("keys", "freq", "slots"):
            np.testing.assert_array_equal(
                _same_on_every_rank(ranks, f"{pre}/cache/{f}"),
                np.asarray(getattr(prm.cache, f)))
        for f in ("weight", "opt_state"):
            np.testing.assert_allclose(
                _same_on_every_rank(ranks, f"{pre}/cache/{f}"),
                np.asarray(getattr(prm.cache, f)), **UPD)


def _run_jax_step(world, spec, arrays, **call):
    name = spec["name"]
    mesh = _jmesh((world,), ("dp",))
    cache = None
    fields = [arrays[f"{name}/cache/{i}"] for i in range(5)] \
        if f"{name}/cache/0" in arrays else None
    cores = [arrays[k] for k in sorted(a for a in arrays
                                       if a.startswith(f"{name}/cores/"))]
    opt = [arrays[k] for k in sorted(a for a in arrays
                                     if a.startswith(f"{name}/opt/"))]
    if fields is not None:
        cache = jc.CacheState(*(jnp.asarray(f) for f in fields))
    step = j_sharded_step(
        mesh, spec["p"], spec["q"], spec["r"], spec["T"], spec["B"],
        spec["L"], optimizer=OptimType[spec["optimizer"]],
        use_cache=spec.get("use_cache", False),
        probe_cache=spec.get("probe_cache", False),
        count_interval=spec.get("count_interval", 1),
        optim_semantics=spec.get("optim_semantics", "reference"))
    w = arrays.get(f"{name}/jax_weights", arrays.get(f"{name}/weights"))
    lr_eps = (jnp.float32(arrays[f"{name}/lr"]),
              jnp.float32(arrays[f"{name}/eps"]))
    return step(_j_params(spec, cores, opt, cache),
                jnp.asarray(arrays[f"{name}/indices"]),
                jnp.asarray(arrays[f"{name}/d_out"]), lr_eps,
                weights=None if w is None else jnp.asarray(w), **call)


@pytest.mark.parametrize("optim_name,use_cache", OPTIM_CASES)
def test_sharded_fused_train_step_matches_single_device(
        worlds, optim_name, use_cache):
    spec, arrays = _optim_case(optim_name, use_cache, 4)
    out, prm = _run_jax_step(4, spec, arrays)
    _check_step(worlds[4].ranks(), spec["name"], out, prm)


def test_sharded_fused_train_step_matches_on_two_ranks(worlds):
    """The cached SGD case on a world of 2 (JAX on 2 devices)."""
    spec, arrays = _optim_case("sgd", True, 2)
    out, prm = _run_jax_step(2, spec, arrays)
    _check_step(worlds[2].ranks(), spec["name"], out, prm)


def test_sharded_fused_train_step_table_batched(worlds):
    spec, arrays = _table_batched_case(4)
    out, prm = _run_jax_step(4, spec, arrays)
    _check_step(worlds[4].ranks(), spec["name"], out, prm)


def test_sharded_fused_step_sampled_counting_and_cache_guard(worlds):
    """count=False leaves the counts; count=True adds count_interval (2)
    per id, bitwise JAX's; a cache with num_tables != 1 raises."""
    spec, arrays = _sampled_case(4)
    ranks = worlds[4].ranks()
    for k, call in enumerate(spec["calls"]):
        out, prm = _run_jax_step(4, spec, arrays, **call)
        _check_step(ranks, spec["name"], out, prm, k)
    np.testing.assert_array_equal(ranks[0]["step_sampled/0/cache/freq"],
                                  arrays["step_sampled/cache/1"])
    from fbtt_embedding_tpu_torch.parallel.sharded import (
        make_sharded_fused_train_step,
    )

    with pytest.raises(ValueError, match="num_tables != 1"):
        make_sharded_fused_train_step(None, P, [4, 2, 2], R, 2, 8, 4,
                                      use_cache=True, device="cpu")


def test_sharded_fused_step_native_optim_matches(worlds):
    """``optim_semantics="native"`` (ADAM, counting on): the moments and
    the 0-d step counter replicated and equal to JAX's."""
    spec, arrays = _native_case(4)
    out, prm = _run_jax_step(4, spec, arrays)
    _check_step(worlds[4].ranks(), spec["name"], out, prm)


def test_sharded_fused_step_generic_path_matches(worlds):
    """``impl="pallas"``: autograd through the generic lookup on every
    rank, against JAX's step on its default path (float32 both)."""
    spec, arrays = _pallas_case(4)
    out, prm = _run_jax_step(4, spec, arrays)
    _check_step(worlds[4].ranks(), spec["name"], out, prm)


def test_sharded_fused_step_hashed_cache_matches_single_device(worlds):
    spec, arrays = _hashed_case(4)
    out, prm = _run_jax_step(4, spec, arrays)
    _check_step(worlds[4].ranks(), spec["name"], out, prm)


def test_sharded_fused_step_wide_keys_matches_single_device(worlds):
    """Wide key rows with pads: the port without weights against JAX given
    zero weights on the pads."""
    spec, arrays = _wide_case(4)
    out, prm = _run_jax_step(4, spec, arrays)
    _check_step(worlds[4].ranks(), spec["name"], out, prm)


@pytest.mark.parametrize("which", ["csr_pad", "csr_noweights",
                                   "csr_adapter"])
def test_csr_padding_feeds_sharded_step(worlds, which):
    """``test_csr_padding_feeds_sharded_step``,
    ``test_csr_pads_safe_without_weights_and_with_cached_last_row`` and
    ``test_csr_step_adapter_direct_csr_api``: the port's world on the
    padded (or, through the adapter, each rank's CSR) batch against JAX's
    sharded step on the same padded batch."""
    spec, arrays = dict((s["name"], (s, a)) for s, a in _csr_cases(4))[which]
    out, prm = _run_jax_step(4, spec, arrays)
    _check_step(worlds[4].ranks(), which, out, prm)


def test_dlrm_sharded_matches_single_device(worlds):
    """``tests/test_dlrm.py``'s hybrid-parallel step at (dp, mp) = (2, 2):
    three steps' losses within rtol 1e-5 and each rank's block of the
    cores, and the top MLP's weights, against JAX's mesh step."""
    ranks = worlds[4].ranks()
    _, arrays = _dlrm_case()
    mesh = _jmesh((2, 2), ("dp", "mp"))
    params = jdlrm.shard_dlrm_params(
        jdlrm.init_dlrm_params(DLRM_CFG, seed=3, weight_dist="normal"),
        DLRM_CFG, mesh)
    step = jdlrm.make_dlrm_train_step(DLRM_CFG, mesh=mesh,
                                      learning_rate=DLRM_LR)
    batch = tuple(jnp.asarray(arrays[f"dlrm/{k}"])
                  for k in ("dense", "indices", "labels"))
    losses = []
    for _ in range(DLRM_STEPS):
        loss, params = step(params, *batch)
        losses.append(float(loss))
    for res in ranks:
        np.testing.assert_allclose(res["dlrm/loss"], losses, rtol=1e-5)
    tl = DLRM_CFG.num_tables // 2
    for i, c in enumerate(params.tt_cores):
        c = np.asarray(c)
        for rank, res in enumerate(ranks):
            m = rank % 2
            np.testing.assert_allclose(res[f"dlrm/core/{i}"],
                                       c[m * tl:(m + 1) * tl], **UPD)
    for i, w in enumerate(params.top_mlp.weights):
        np.testing.assert_allclose(_same_on_every_rank(ranks,
                                                       f"dlrm/top_w/{i}"),
                                   np.asarray(w), **UPD)


WALK_STEPS = 10


def test_train_dlrm_example_mesh(worlds):
    """``examples.train_dlrm --tiny --mesh 2,2`` in the world of 4: the
    loss falls, every rank reads the same global loss, each rank's
    checkpoint exists, and the first two losses equal JAX's mesh step at
    (2, 2) on the same batches (rtol 1e-5)."""
    from fbtt_embedding_tpu_torch.examples import train_dlrm

    ranks = worlds[4].ranks()
    losses = _same_on_every_rank(ranks, "walkthrough/losses")
    assert len(losses) == WALK_STEPS and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    for r in ranks:
        assert int(r["walkthrough/ckpt_exists"]) == 1
        assert 0.0 <= float(r["walkthrough/auc"]) <= 1.0
    cfg = jdlrm.DLRMConfig(
        num_tables=2, num_embeddings=216, embedding_dim=16,
        tt_p_shapes=[6, 6, 6], tt_q_shapes=[4, 2, 2], tt_ranks=[8, 8],
        dense_dim=4, bottom_mlp_dims=[16, 16], top_mlp_dims=[32, 1],
        pooling_factor=2)
    mesh = _jmesh((2, 2), ("dp", "mp"))
    params = jdlrm.shard_dlrm_params(jdlrm.init_dlrm_params(cfg, seed=0),
                                     cfg, mesh)
    step = jdlrm.make_dlrm_train_step(cfg, mesh=mesh, learning_rate=0.05)
    rng = np.random.default_rng(0)
    for i in range(2):
        batch = train_dlrm.make_batch(rng, cfg, 128, device="cpu")
        loss, params = step(params, *(jnp.asarray(t.numpy()) for t in batch))
        np.testing.assert_allclose(losses[i], float(loss), rtol=1e-5)


def test_mesh_surface(worlds):
    """On the world of 4: the default mesh is JAX's (2, 2) with axes
    ("dp", "mp"), a one-axis mesh keeps its name, ``host_local_to_global``
    places a rank's block as it is, and the hybrid mesh (dp * mp not the
    world), a spec naming an axis twice and a dim that does not split
    raise ValueError."""
    want = j_make_mesh(devices=jax.devices()[:4])
    for r in worlds[4].ranks():
        assert list(r["mesh/default_shape"]) == list(want.devices.shape)
        assert list(r["mesh/default_names"]) == list(want.axis_names)
        assert list(r["mesh/one_axis_names"]) == ["mp"]
        assert list(r["mesh/block_shape"]) == [3, 2]
        assert list(r["mesh/raised"]) == [1, 1, 1]


def test_replica_agreement(worlds):
    """``tests/test_guard.py::test_replica_agreement``: replicated values
    pass on both axes; a per-rank value raises ReplicaDivergenceError on
    every rank."""
    for r in worlds[4].ranks():
        assert int(r["replicas/agree_ok"]) == 1
        assert int(r["replicas/diverge_raised"]) == 1


def test_table_count_mp_does_not_divide_raises(worlds):
    """T=6 over mp=4 and T=3 over mp=2 raise ValueError on every rank, as
    the JAX package's placement refuses them."""
    for n in (2, 4):
        for r in worlds[n].ranks():
            assert int(r["shard_error/raised"]) == 1
