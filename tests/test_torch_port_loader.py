"""PyTorch port vs the JAX package: the native host loader and the CSR
re-layout (CPU).

- ``generate_batch`` bitwise equal to the JAX package's native library for
  the same seed (uniform, Zipf, weighted), its plain version to the JAX
  package's numpy body;
- ``decompose_indices_np`` / ``decompose_indices64_np``,
  ``expand_offsets_np``, ``csr_to_padded_np`` and
  ``ops.indexing.pad_csr_to_fixed`` exactly equal to the JAX package's and
  to their plain versions, the over-long bag and decreasing offsets
  raising;
- ``PrefetchLoader``: the batches of ``generate_batch`` in seed order,
  equal to the JAX package's loader, ``close`` ending the thread;
- the library is built into ``build/`` and a failed build raises;
- ``tests/test_native_loader.py``'s cases on the port (against the port's
  device-side ``decompose_indices`` / ``rowidx_from_offsets``).

Row ids are non-negative throughout: the library divides by truncation,
the plain versions by floor division (as in the JAX package).
"""

import numpy as np
import pytest
import torch

from fbtt_embedding_tpu import native as jnative
from fbtt_embedding_tpu.ops.indexing import pad_csr_to_fixed as j_pad
from fbtt_embedding_tpu_torch import native
from fbtt_embedding_tpu_torch.ops.indexing import (
    decompose_indices,
    pad_csr_to_fixed,
    rowidx_from_offsets,
)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX package's library must be the one built (its numpy fallback
    draws another stream)."""
    assert jnative.native_available()


def _jax_native_batch(seed, e, t, b, l, alpha, weighted):
    """The JAX package's native ``generate_batch`` into buffers filled with
    a sentinel (-7, NaN) where its library writes nothing: from 4096
    lookups, a worker thread whose range starts inside a 2^14-entry chunk
    writes only up to that chunk's end (ROADMAP §C)."""
    import ctypes

    lib = jnative._load()
    nnz = t * b * l
    idx = np.full(nnz, -7, np.int32)
    offs = np.full(t * b + 1, -7, np.int32)
    w = np.full(nnz if weighted else 0, np.nan, np.float32)
    lib.fbtt_generate_batch(
        ctypes.c_uint64(seed), ctypes.c_int64(e), t, b, l,
        ctypes.c_double(alpha), int(weighted), jnative._i32p(idx),
        jnative._i32p(offs), jnative._f32p(w))
    return idx, offs, (w if weighted else None)


@pytest.mark.parametrize("alpha,weighted", [(1.0, False), (1.05, False),
                                            (1.2, True), (0.5, True)])
@pytest.mark.parametrize("seed,e,t,b,l", [(7, 5000, 2, 16, 4),
                                          (123, 11_000_000, 1, 512, 20),
                                          (3, 1000, 3, 100, 70)])
def test_generate_batch_bitwise_jax(seed, e, t, b, l, alpha, weighted):
    """Every entry the JAX package's library writes is bitwise equal; the
    entries it leaves unwritten the port writes, in range."""
    got = native.generate_batch(seed, e, t, b, l, alpha=alpha,
                                weighted=weighted)
    want = _jax_native_batch(seed, e, t, b, l, alpha, weighted)
    if t * b * l < 4096:  # one thread: the whole batch is written
        assert (want[0] != -7).all()
    written = want[0] != -7
    np.testing.assert_array_equal(got[0][written], want[0][written])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].min() >= 0 and got[0].max() < e
    if weighted:
        np.testing.assert_array_equal(got[2][written], want[2][written])
        assert got[2].min() >= 0 and got[2].max() < 1
    else:
        assert got[2] is None
    # the JAX wrapper's batch agrees with it where its library writes
    jw = jnative.generate_batch(seed, e, t, b, l, alpha=alpha,
                                weighted=weighted)
    np.testing.assert_array_equal(jw[0][written], got[0][written])


def test_generate_batch_plain_is_the_numpy_body(monkeypatch):
    """The plain version is the JAX package's numpy fallback, bitwise."""
    monkeypatch.setattr(jnative, "_load", lambda: None)
    for alpha, weighted in ((1.0, False), (1.3, True)):
        got = native.generate_batch_plain(5, 3000, 2, 8, 3, alpha=alpha,
                                          weighted=weighted)
        want = jnative.generate_batch(5, 3000, 2, 8, 3, alpha=alpha,
                                      weighted=weighted)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_decompose_exact():
    rng = np.random.default_rng(0)
    p = [200, 220, 250]
    idx = rng.integers(0, int(np.prod(p)), 5000).astype(np.int32)
    got = native.decompose_indices_np(idx, p)
    np.testing.assert_array_equal(got, jnative.decompose_indices_np(idx, p))
    np.testing.assert_array_equal(got, native.decompose_indices_plain(idx,
                                                                      p))
    big = [1300, 1300, 1300]
    idx64 = rng.integers(0, int(np.prod(big)), 5000, dtype=np.int64)
    got = native.decompose_indices64_np(idx64, big)
    np.testing.assert_array_equal(got,
                                  jnative.decompose_indices64_np(idx64, big))
    np.testing.assert_array_equal(got, native.decompose_indices_plain(idx64,
                                                                      big))


def test_expand_offsets_exact():
    rng = np.random.default_rng(1)
    lens = rng.integers(0, 6, size=3 * 17)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    got = native.expand_offsets_np(offs, 3, 17)
    for g, w, pl in zip(got, jnative.expand_offsets_np(offs, 3, 17),
                        native.expand_offsets_plain(offs, 3, 17)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, pl)
    with pytest.raises(ValueError, match="offsets has shape"):
        native.expand_offsets_np(offs[:-1], 3, 17)


def _csr(rng, t, b, lmax):
    lens = rng.integers(0, lmax + 1, size=t * b)
    offs = np.zeros(t * b + 1, np.int32)
    offs[1:] = np.cumsum(lens)
    nnz = int(offs[-1])
    return (rng.integers(0, 1000, size=nnz).astype(np.int32), offs,
            rng.random(nnz).astype(np.float32), lens)


@pytest.mark.parametrize("t,b,lmax", [(3, 17, 6), (1, 32, 5), (2, 1, 1)])
def test_csr_to_padded_exact(t, b, lmax):
    """``test_csr_to_padded_native_matches_numpy`` on the port: the native
    re-layout, its plain version, ``pad_csr_to_fixed`` (numpy and tensor
    inputs) and the JAX package's, with and without weights."""
    idx, offs, w, lens = _csr(np.random.default_rng(7), t, b, lmax)
    for weights in (w, None):
        want = j_pad(idx, offs, t, b, lmax, weights=weights)
        for got in (native.csr_to_padded_np(idx, offs, t, b, lmax, weights),
                    native.csr_to_padded_plain(idx, offs, t, b, lmax,
                                               weights),
                    pad_csr_to_fixed(idx, offs, t, b, lmax, weights=weights),
                    pad_csr_to_fixed(torch.from_numpy(idx),
                                     torch.from_numpy(offs), t, b, lmax,
                                     weights=None if weights is None
                                     else torch.from_numpy(weights))):
            assert got[0].shape == (t, b, lmax) and got[0].dtype == np.int32
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    # pad slots: index -1, weight 0; real slots weight 1 without weights
    got_i, got_w = pad_csr_to_fixed(idx, offs, t, b, lmax)
    np.testing.assert_array_equal(got_w, (got_i >= 0).astype(np.float32))
    assert int((got_i >= 0).sum()) == idx.size


def test_csr_bad_bags_raise():
    idx, offs, w, lens = _csr(np.random.default_rng(3), 2, 9, 5)
    short = int(lens.max()) - 1
    for fn in (native.csr_to_padded_np, native.csr_to_padded_plain,
               pad_csr_to_fixed):
        with pytest.raises(ValueError, match="exceeds pooling_factor"):
            fn(idx, offs, 2, 9, short)
    bad = np.array([0, 3, 2, 6], np.int32)  # bag 1 of length -1
    for fn in (native.csr_to_padded_np, native.csr_to_padded_plain,
               pad_csr_to_fixed):
        with pytest.raises(ValueError, match="non-decreasing"):
            fn(np.arange(6, dtype=np.int32), bad, 1, 3, 5)
        with pytest.raises(ValueError, match="entries; expected"):
            fn(idx, offs[:-1], 2, 9, 5)


def test_prefetch_loader_order_and_close():
    loader = native.PrefetchLoader(1000, 2, 8, 3, alpha=1.1, weighted=True,
                                   num_batches=5, seed=5, depth=2)
    batches = list(loader)
    loader.close()
    assert len(batches) == 5
    jl = jnative.PrefetchLoader(1000, 2, 8, 3, alpha=1.1, weighted=True,
                                num_batches=5, seed=5, depth=2)
    for i, (got, want) in enumerate(zip(batches, jl)):
        direct = native.generate_batch(5 + i, 1000, 2, 8, 3, alpha=1.1,
                                       weighted=True)
        for g, w, d in zip(got, want, direct):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, d)
    jl.close()
    # closed mid-stream: the thread ends although nobody consumes
    endless = native.PrefetchLoader(1000, 1, 4, 2, depth=1)
    it = iter(endless)
    next(it)
    endless.close()
    assert not endless._thread.is_alive()


def test_library_in_build_dir_and_failed_build_raises(monkeypatch, tmp_path):
    lib = native.build()
    assert lib.exists() and "build" in lib.parts
    assert lib.parent.parent == native.BUILD_ROOT
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-DFBTT_NO_SUCH_FLAG", "-Werror",
                                            "-fno-such-option"))
    with pytest.raises(RuntimeError, match="g..? failed"):
        native.build(force=True)


# tests/test_native_loader.py's cases on the port

def test_generate_batch_shapes_and_determinism():
    idx, offs, w = native.generate_batch(7, 5000, 2, 16, 4, alpha=1.2,
                                         weighted=True)
    assert idx.shape == (2 * 16 * 4,) and offs.shape == (2 * 16 + 1,)
    assert w.shape == idx.shape and offs[-1] == idx.size
    assert idx.min() >= 0 and idx.max() < 5000
    idx2, _, w2 = native.generate_batch(7, 5000, 2, 16, 4, alpha=1.2)
    np.testing.assert_array_equal(idx, idx2)
    assert w2 is None


def test_zipf_skew():
    idx, _, _ = native.generate_batch(0, 10_000, 1, 64, 16, alpha=1.5)
    _, counts = np.unique(idx, return_counts=True)
    assert np.sort(counts)[::-1][0] > idx.size * 0.05


def test_decompose_matches_device_path():
    p = [200, 220, 250]
    idx, _, _ = native.generate_batch(1, int(np.prod(p)), 1, 32, 8)
    host = native.decompose_indices_np(idx, p)
    dev = np.stack([v.numpy() for v in decompose_indices(
        torch.from_numpy(idx), p)])
    np.testing.assert_array_equal(host, dev)


def test_expand_offsets_matches_device_path():
    rng = np.random.default_rng(0)
    lens = rng.integers(0, 6, size=3 * 17)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    r_h, t_h = native.expand_offsets_np(offs, 3, 17)
    r_d, t_d = rowidx_from_offsets(torch.from_numpy(offs), int(offs[-1]), 3,
                                   17)
    np.testing.assert_array_equal(r_h, r_d.numpy())
    np.testing.assert_array_equal(t_h, t_d.numpy())
