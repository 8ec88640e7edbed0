"""PyTorch port vs the JAX package: shapes, init, indexing, contraction,
pooling and padding helpers (CPU).

Inputs come from numpy seeds and go through both packages; integer results
must be equal, float results within the stated tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbtt_embedding_tpu.ops import cache as jcache
from fbtt_embedding_tpu.ops import contraction as jcon
from fbtt_embedding_tpu.ops import indexing as jidx
from fbtt_embedding_tpu.ops import lookup as jlook
from fbtt_embedding_tpu.ops.pallas import tt_kernel as jkern
from fbtt_embedding_tpu.utils import init as jinit
from fbtt_embedding_tpu.utils import shapes as jshapes
from fbtt_embedding_tpu_torch.ops import contraction as tcon
from fbtt_embedding_tpu_torch.ops import indexing as tidx
from fbtt_embedding_tpu_torch.ops import lookup as tlook
from fbtt_embedding_tpu_torch.ops.kernels import tt_kernel as tkern
from fbtt_embedding_tpu_torch.utils import init as tinit
from fbtt_embedding_tpu_torch.utils import shapes as tshapes

SHAPES = [
    dict(p=[30, 40], q=[8, 8], ranks=[8], T=1),
    dict(p=[20, 22, 25], q=[4, 4, 4], ranks=[8, 8], T=1),
    dict(p=[16, 16, 16], q=[4, 4, 4], ranks=[8, 8], T=2),
    dict(p=[7, 9, 11], q=[3, 4, 5], ranks=[13, 12], T=1),
    dict(p=[8, 9, 10, 11], q=[2, 4, 2, 2], ranks=[8, 8, 8], T=2),
]


def _cores(case, seed=0):
    p, q, T = case["p"], case["q"], case["T"]
    rfull = [1] + list(case["ranks"]) + [1]
    rng = np.random.default_rng(seed)
    return rfull, tinit.init_tt_cores(
        rng, "uniform", T, int(np.prod(p)), int(np.prod(q)), p, q, rfull)


@pytest.mark.parametrize("n,d", [(11_000_000, 3), (1000, 3), (64, 3),
                                 (100_000, 2), (77, 4)])
def test_suggested_tt_shapes_match(n, d):
    assert tshapes.suggested_tt_shapes(n, d) == \
        jshapes.suggested_tt_shapes(n, d)


@pytest.mark.parametrize("dist", list(jinit.WEIGHT_DISTS))
def test_init_tt_cores_bitwise_equal(dist):
    p, q, r = [7, 9, 11], [3, 4, 5], [1, 13, 12, 1]
    a = jinit.init_tt_cores(np.random.default_rng(5), dist, 1, 693, 60,
                            p, q, r)
    b = tinit.init_tt_cores(np.random.default_rng(5), dist, 1, 693, 60,
                            p, q, r)
    assert tinit.core_shapes(1, p, q, r) == jinit.core_shapes(1, p, q, r)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("p", [[200, 220, 250], [30, 40], [8, 9, 10, 11]])
def test_decompose_indices_exact(p):
    rng = np.random.default_rng(1)
    idx = rng.integers(0, int(np.prod(p)), size=500).astype(np.int64)
    np.testing.assert_array_equal(tidx.tt_strides(p), jidx.tt_strides(p))
    a = jidx.decompose_indices(jnp.asarray(idx, jnp.int32), p)
    b = tidx.decompose_indices(torch.as_tensor(idx), p)
    for x, y in zip(a, b):
        assert y.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_wide_keyrows_match_jax_wide_cache_keys():
    p = [2000, 3000, 4000]  # prod(p) = 2.4e10 > 2**31
    rng = np.random.default_rng(2)
    idx = rng.integers(0, int(np.prod(p)), size=300).astype(np.int64)
    a = np.asarray(jcache.wide_cache_keys(idx, p))
    b = tidx.wide_keyrows(idx, p)
    np.testing.assert_array_equal(a, b)
    parts, rows, nnz = tidx.split_wide_keyrows(torch.as_tensor(b), 3)
    assert nnz == 300 and rows.shape == (300, 5)
    for t in range(3):
        np.testing.assert_array_equal(parts[t].numpy(), b[:, 2 + t])
    with pytest.raises(ValueError):
        tidx.split_wide_keyrows(torch.as_tensor(b[:, :4]), 3)


@pytest.mark.parametrize("offsets,T,B", [
    ([0, 2, 5, 5, 9], 1, 4),              # an empty bag
    ([0, 0, 3, 4, 4, 8, 8], 2, 3),        # empty bags, two tables
    ([0, 1, 2, 3, 4, 5, 6, 7, 8], 1, 8),
    ([0, 3, 3, 3, 3], 1, 4),              # trailing empty bags
])
def test_rowidx_from_offsets_exact(offsets, T, B):
    nnz = offsets[-1]
    a = jidx.rowidx_from_offsets(jnp.asarray(offsets, jnp.int32), nnz, T, B)
    b = tidx.rowidx_from_offsets(torch.as_tensor(offsets), nnz, T, B)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("case", SHAPES)
def test_tt_rows_match(case):
    rfull, cores = _cores(case)
    p, q, T = case["p"], case["q"], case["T"]
    rng = np.random.default_rng(3)
    idx = rng.integers(0, int(np.prod(p)), size=64).astype(np.int32)
    tab = rng.integers(0, T, size=64).astype(np.int32) if T > 1 else None
    a = jcon.tt_rows(tuple(jnp.asarray(c) for c in cores), p, q, rfull,
                     jnp.asarray(idx),
                     None if tab is None else jnp.asarray(tab))
    b = tcon.tt_rows([torch.as_tensor(c) for c in cores], p, q, rfull,
                     torch.as_tensor(idx),
                     None if tab is None else torch.as_tensor(tab))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                               atol=1e-6)


def test_validate_tt_shapes():
    assert tcon.validate_tt_shapes([4, 5, 6], [2, 2, 2], [3, 3]) == \
        jcon.validate_tt_shapes([4, 5, 6], [2, 2, 2], [3, 3])
    with pytest.raises(ValueError):
        tcon.validate_tt_shapes([4, 5, 6, 7, 8], [2] * 5, [3] * 4)
    with pytest.raises(ValueError):
        tcon.validate_tt_shapes([4, 5], [2, 2], [2, 3, 4])


@pytest.mark.parametrize("T", [1, 2])
def test_pool_rows_match(T):
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(40, 16)).astype(np.float32)
    rowidx = rng.integers(0, 8, size=40).astype(np.int32)
    tab = rng.integers(0, T, size=40).astype(np.int32)
    a = jlook.pool_rows(jnp.asarray(rows), jnp.asarray(rowidx),
                        jnp.asarray(tab), T, 8)
    b = tlook.pool_rows(torch.as_tensor(rows), torch.as_tensor(rowidx),
                        torch.as_tensor(tab), T, 8)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", SHAPES)
def test_flat_pad_plan_and_padded_cores_match(case):
    rfull, cores = _cores(case)
    p, q = case["p"], case["q"]
    for b in (8, 13):
        plan = tlook.flat_pad_plan(p, q, rfull, b)
        assert plan == jlook.flat_pad_plan(p, q, rfull, b)
        if plan is None:
            continue
        a = jlook.pad_cores_for_flat(tuple(jnp.asarray(c) for c in cores),
                                     p, q, rfull, plan)
        t = tlook.pad_cores_for_flat([torch.as_tensor(c) for c in cores],
                                     p, q, rfull, plan)
        for x, y in zip(a, t):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("case", SHAPES)
def test_kernel_core_layouts_match(case):
    rfull, cores = _cores(case)
    p, q = case["p"], case["q"]
    a = jkern.kernel_core_layouts(tuple(jnp.asarray(c) for c in cores),
                                  p, q, rfull)
    b = tkern.kernel_core_layouts([torch.as_tensor(c) for c in cores],
                                  p, q, rfull)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
