"""PyTorch port vs the JAX package: the serving entry (CPU).

The port's ``make_serving_fn(device="cpu")`` (flat pipeline, the kernel's
plain version) against JAX ``make_serving_fn(probe_cache=False)`` on the
same cores and requests, within 2e-4 as ``tests/test_serving.py`` holds
the JAX serving paths; and a fresh process that imports the port (its
examples too), serves and serves a fold without importing JAX or the JAX
package.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbtt_embedding_tpu import TTEmbeddingParams as JParams
from fbtt_embedding_tpu.models.tt_embedding import (
    make_serving_fn as j_make_serving_fn,
)
from fbtt_embedding_tpu.ops.cache import wide_cache_keys
from fbtt_embedding_tpu_torch import (
    TTEmbeddingParams,
    init_tt_cores,
    make_cache_state,
    make_serving_fn,
    params_from_jax,
    wide_keyrows,
)

ROOT = Path(__file__).resolve().parents[1]

SERVE_CASES = [
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=3),
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], b=16, L=3, weights=True),
    dict(p=[16, 16, 16], q=[4, 4, 4], ranks=[8, 8], b=8, L=2, T=2),
    dict(p=[7, 9, 11], q=[3, 4, 5], ranks=[13, 12], b=8, L=4),
    dict(p=[30, 40], q=[8, 8], ranks=[8], b=16, L=2),
    dict(p=[8, 9, 10, 11], q=[2, 2, 2, 2], ranks=[8, 8, 8], b=16, L=2),
]


def _setup(case, seed=7):
    p, q, ranks = case["p"], case["q"], case["ranks"]
    b, L, T = case["b"], case["L"], case.get("T", 1)
    rfull = [1] + list(ranks) + [1]
    E, D = int(np.prod(p)), int(np.prod(q))
    nnz = T * b * L
    rng = np.random.default_rng(seed)
    cores = init_tt_cores(rng, "uniform", T, E, D, p, q, rfull)
    jparams = JParams(tuple(jnp.asarray(c) for c in cores),
                      tuple(jnp.zeros((0,), jnp.float32) for _ in cores),
                      None)
    indices = rng.integers(0, E, size=nnz).astype(np.int32)
    offsets = np.arange(0, nnz + 1, L, dtype=np.int32)
    w = rng.random(nnz).astype(np.float32) if case.get("weights") else None
    return p, q, rfull, T, b, cores, jparams, indices, offsets, w


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("case", SERVE_CASES)
def test_serve_matches_jax(case, impl):
    p, q, rfull, T, b, cores, jparams, idx, offs, w = _setup(case)
    jserve = j_make_serving_fn(p, q, rfull, num_tables=T, batch_size=b,
                               probe_cache=False)
    want = np.asarray(jserve(jparams, jnp.asarray(idx), jnp.asarray(offs),
                             None if w is None else jnp.asarray(w)))
    params = params_from_jax([np.asarray(c) for c in jparams.tt_cores],
                             [np.asarray(s) for s in jparams.optimizer_state],
                             device="cpu")
    serve = make_serving_fn(p, q, rfull, num_tables=T, batch_size=b,
                            probe_cache=False, impl=impl, device="cpu")
    got = serve(params, idx, offs, w)
    assert got.device.type == "cpu" and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_serve_wide_keyrows_match_jax():
    # int64 row ids as wide key rows: the part columns feed the lookup
    p, q, rfull = [20, 22, 25], [4, 4, 4], [1, 8, 8, 1]
    E, b, L = 20 * 22 * 25, 8, 3
    rng = np.random.default_rng(11)
    cores = init_tt_cores(rng, "uniform", 1, E, 64, p, q, rfull)
    idx64 = rng.integers(0, E, size=b * L).astype(np.int64)
    offs = np.arange(0, b * L + 1, L, dtype=np.int32)
    jparams = JParams(tuple(jnp.asarray(c) for c in cores), (), None)
    jserve = j_make_serving_fn(p, q, rfull, 1, b, probe_cache=False)
    want = np.asarray(jserve(jparams, wide_cache_keys(idx64, p),
                             jnp.asarray(offs)))
    serve = make_serving_fn(p, q, rfull, 1, b, device="cpu")
    params = params_from_jax(cores, device="cpu")
    got = serve(params, wide_keyrows(idx64, p), offs)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    flat_ids = serve(params, torch.as_tensor(idx64), torch.as_tensor(offs))
    np.testing.assert_allclose(got.numpy(), flat_ids.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_serve_bs_override_and_cache_guard():
    case = SERVE_CASES[0]
    p, q, rfull, T, b, cores, jparams, idx, offs, w = _setup(case)
    params = params_from_jax(cores, device="cpu")
    serve = make_serving_fn(p, q, rfull, 1, 4 * b, device="cpu")
    full = make_serving_fn(p, q, rfull, 1, b, device="cpu")(params, idx, offs)
    got = serve(params, idx, offs, bs=b)
    assert got.shape == (1, b, 64)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-7)
    # an empty cache serves nothing: the probing serve equals the plain one;
    # wide key rows with a cache wait for the wide-key cache
    cache = make_cache_state(int(np.prod(p)), 4, 64, num_embeddings=int(
        np.prod(p)), device="cpu")
    cached = TTEmbeddingParams(params.tt_cores, (), cache=cache)
    probing = make_serving_fn(p, q, rfull, 1, b, device="cpu")
    with pytest.raises(NotImplementedError):
        probing(cached, wide_keyrows(idx, p), offs)
    quiet = make_serving_fn(p, q, rfull, 1, b, probe_cache=False,
                            device="cpu")
    for fn in (probing, quiet):
        np.testing.assert_allclose(fn(cached, idx, offs).numpy(),
                                   full.numpy(), rtol=1e-6, atol=1e-7)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import fbtt_embedding_tpu_torch as m\n"
        "p, q, r = [20, 22, 25], [4, 4, 4], [1, 8, 8, 1]\n"
        "cores = m.init_tt_cores(np.random.default_rng(0), 'uniform', 1,"
        " 11000, 64, p, q, r)\n"
        "params = m.params_from_jax(cores, device='cpu')\n"
        "serve = m.make_serving_fn(p, q, r, 1, 8, device='cpu')\n"
        "out = serve(params, np.arange(16) * 577, np.arange(0, 17, 2))\n"
        "assert out.shape == (1, 8, 64)\n"
        "fold, fserve = m.make_folded_serving_fn(p, q, r, 1, 8,"
        " quantize='int8', device='cpu')\n"
        "fp = m.refold_cache(fold(params), params)\n"
        "assert fp.setup[1] is not None\n"
        "assert fserve(fp, np.arange(16) * 577, np.arange(0, 17, 2)).shape"
        " == (1, 8, 64)\n"
        "import fbtt_embedding_tpu_torch.examples.serve_embedding\n"
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
