"""PyTorch port vs the JAX package: ``tt_matrix_to_full`` and the TT-SVD
import (CPU).

- ``tt_matrix_to_full`` against JAX's on tt_ndim 2-4, two tables and
  ``table=1``, rtol 1e-5;
- ``tt_decompose`` against JAX's on ``tests/test_decompose.py``'s cases:
  both are the same numpy, so the cores are bitwise equal (the short table's
  zero padding included); the round trip, and the error falling with rank;
- ``import_full_weight`` on a module serving the table, against the JAX
  module doing the same (cache past warm-up repopulated, optimizer state
  reset);
- the package's exports, and a fresh process that imports the package and
  drives a module without loading JAX or the JAX package.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fbtt_embedding_tpu as J
from fbtt_embedding_tpu.ops.contraction import (
    tt_matrix_to_full as j_to_full,
)
from fbtt_embedding_tpu.utils.decompose import tt_decompose as j_decompose
from fbtt_embedding_tpu.utils.init import init_tt_cores as j_init
import fbtt_embedding_tpu_torch as T

ROOT = Path(__file__).resolve().parents[1]
TIGHT = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("p,q,ranks,num_tables,table", [
    ([8, 9], [4, 4], [12], 1, 0),
    ([7, 9, 11], [3, 4, 5], [13, 12], 1, 0),
    ([4, 4, 4, 4], [2, 2, 2, 2], [4, 5, 3], 1, 0),
    ([6, 6, 6], [4, 2, 2], [8, 8], 2, 1),
    ([7, 9], [3, 4], [6], 2, 0),
])
def test_tt_matrix_to_full_matches_jax(p, q, ranks, num_tables, table):
    rfull = [1] + ranks + [1]
    e, d = int(np.prod(p)), int(np.prod(q))
    cores = j_init(np.random.default_rng(len(p) + table), "normal",
                   num_tables, e, d, p, q, rfull)
    want = np.asarray(j_to_full(p, q, rfull, [jnp.asarray(c) for c in cores],
                                table=table))
    got = T.tt_matrix_to_full(p, q, ranks, [torch.as_tensor(c) for c in
                                            cores], table=table)
    assert got.shape == (e, d) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, **TIGHT)


def _full(cores_np, p, q, r):
    return _np(T.tt_matrix_to_full(p, q, r, [torch.as_tensor(c)[None]
                                             for c in cores_np]))


@pytest.mark.parametrize("p,q,ranks", [
    ([6, 6, 6], [4, 2, 2], [8, 8]),
    ([8, 9], [4, 4], [12]),
    ([4, 4, 4, 4], [2, 2, 2, 2], [4, 4, 4]),
])
def test_tt_decompose_bitwise_and_exact_roundtrip(p, q, ranks):
    """A matrix that is a TT of the configured ranks: the port's cores equal
    JAX's bit for bit and rebuild the matrix."""
    rfull = [1] + ranks + [1]
    e, d = int(np.prod(p)), int(np.prod(q))
    src = j_init(np.random.default_rng(0), "uniform", 1, e, d, p, q, rfull)
    w = _full([c[0] for c in src], p, q, rfull)
    want = j_decompose(w, p, q, ranks)
    got = T.tt_decompose(w, p, q, ranks)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(_full(got, p, q, rfull), w, rtol=1e-4,
                               atol=1e-5)
    # a tensor on the way in gives the same cores
    for a, b in zip(got, T.tt_decompose(torch.as_tensor(w), p, q, rfull)):
        np.testing.assert_array_equal(b, a)


def test_tt_decompose_error_falls_with_rank():
    p, q = [6, 6, 6], [4, 2, 2]
    w = np.random.default_rng(1).normal(size=(216, 16)).astype(np.float32)

    def err(ranks):
        cores = T.tt_decompose(w, p, q, ranks)
        for a, b in zip(j_decompose(w, p, q, ranks), cores):
            np.testing.assert_array_equal(b, a)
        back = _full(cores, p, q, [1] + ranks + [1])
        return float(np.linalg.norm(back - w) / np.linalg.norm(w))

    e2, e8, e24 = err([2, 2]), err([8, 8]), err([24, 12])
    assert e2 > e8 > e24
    assert err([64, 16]) < 1e-5  # zero-padded past the unfoldings' ranks


def test_tt_decompose_short_table_zero_pads_rows():
    p, q, ranks = [6, 6, 6], [4, 2, 2], [24, 12]
    w = np.random.default_rng(2).normal(size=(200, 16)).astype(np.float32)
    got = T.tt_decompose(w, p, q, ranks)
    for a, b in zip(j_decompose(w, p, q, ranks), got):
        np.testing.assert_array_equal(b, a)
    back = _full(got, p, q, [1] + ranks + [1])
    np.testing.assert_allclose(back[:200], w, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(back[200:], 0.0, atol=1e-5)


def test_import_full_weight_matches_jax_module():
    """tests/test_decompose.py's module case on both packages: the cache,
    engaged before the import, serves the imported rows; the optimizer
    state (Adagrad here, so not empty) is reset."""
    p, q, ranks = [6, 6, 6], [4, 2, 2], [24, 12]
    e, d = 216, 16
    w = np.random.default_rng(3).normal(size=(e, d)).astype(np.float32)
    kw = dict(num_embeddings=e, embedding_dim=d, tt_p_shapes=p,
              tt_q_shapes=q, tt_ranks=ranks, use_cache=True, cache_size=16,
              hashtbl_size=256, weight_dist="uniform", learning_rate=0.05)
    opt = "exact_adagrad"
    jm = J.TTEmbeddingBag(optimizer=J.OptimType(opt), **kw)
    tm = T.TTEmbeddingBag(optimizer=T.OptimType(opt), device="cpu", **kw)
    idx = np.arange(8, dtype=np.int64)
    offs = np.arange(9, dtype=np.int64)
    for m in (jm, tm):
        m.update_cache(np.arange(32, dtype=np.int32))
        m.cache_populate()
        m(idx, offs)
        m.backward(np.ones((8, d), np.float32))
        m.import_full_weight(w)
    assert float(tm.optimizer_state[0].abs().max()) == 0.0
    for a, b in zip(jm.tt_cores, tm.tt_cores):
        np.testing.assert_allclose(_np(b), np.asarray(a), **TIGHT)
    np.testing.assert_allclose(_np(tm.cache.weight),
                               np.asarray(jm.cache.weight), **TIGHT)
    np.testing.assert_allclose(_np(tm.full_weight()), w, rtol=2e-3,
                               atol=2e-3)
    out = _np(tm(idx, offs))
    assert tm.cache_hit_rate() > 0
    np.testing.assert_allclose(out, np.asarray(jm(idx, offs)), **TIGHT)
    np.testing.assert_allclose(out, w[:8], rtol=2e-3, atol=2e-3)


def test_import_full_weight_into_one_table():
    """``table=1`` of two: only that table's cores and state change."""
    p, q, ranks = [6, 6, 6], [4, 2, 2], [24, 12]
    w = np.random.default_rng(4).normal(size=(216, 16)).astype(np.float32)
    tm = T.TableBatchedTTEmbeddingBag(
        2, 216, 16, ranks, p, q, optimizer=T.OptimType.EXACT_ADAGRAD,
        weight_dist="uniform", device="cpu")
    for s in tm.optimizer_state:
        s.fill_(1.0)
    before = [_np(c).copy() for c in tm.tt_cores]
    tm.import_full_weight(w, table=1)
    for c, b, s in zip(tm.tt_cores, before, tm.optimizer_state):
        np.testing.assert_array_equal(_np(c)[0], b[0])
        assert (_np(s)[0] == 1).all() and (_np(s)[1] == 0).all()
    np.testing.assert_allclose(_full([_np(c)[1] for c in tm.tt_cores], p, q,
                                     [1] + ranks + [1]), w, rtol=2e-3,
                               atol=2e-3)


def test_module_exports():
    for name in ("TableBatchedTTEmbeddingBag", "TTEmbeddingBag",
                 "tt_embedding_forward", "tt_matrix_to_full", "tt_decompose"):
        assert name in T.__all__ and name in J.__all__, name
    assert issubclass(T.TTEmbeddingBag, torch.nn.Module)
    assert issubclass(T.TableBatchedTTEmbeddingBag, torch.nn.Module)


def test_port_modules_load_without_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import fbtt_embedding_tpu_torch as m\n"
        "from fbtt_embedding_tpu_torch.utils import decompose\n"
        "emb = m.TTEmbeddingBag(num_embeddings=1000, embedding_dim=16,"
        " tt_ranks=[8, 8], learning_rate=0.005, cache_size=32,"
        " device='cpu')\n"
        "rng = np.random.default_rng(0)\n"
        "for step in range(4):\n"
        "    idx = (rng.zipf(1.5, size=64) - 1) % 1000\n"
        "    out = emb(idx, np.arange(0, 65, 8))\n"
        "    assert out.shape == (8, 16)\n"
        "    emb.backward(np.ones((8, 16), np.float32))\n"
        "    if step == 1:\n"
        "        emb.cache_populate()\n"
        "assert emb.cache_hit_rate() > 0\n"
        "emb.import_full_weight(emb.full_weight())\n"
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
