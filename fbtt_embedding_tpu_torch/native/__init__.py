"""Native host runtime: multithreaded batch synthesis and index preprocessing.

Counterpart of ``fbtt_embedding_tpu.native``, with its own copy of the C++
source (``loader.cpp``, the same arithmetic and random streams: a seed gives
bitwise the JAX package's native batches). The library is compiled with
``g++`` at first use into ``build/fbtt_torch_native/<hash>/`` beside the
package (the hash covers the source and the flags, so an edited source never
loads a stale library) and loaded with ``ctypes``.

There is no numpy fallback: a missing ``g++`` or a failed compile raises
with the compiler's output, as the CUDA kernels' build does. The numpy
bodies the JAX package falls back to are kept as the plain versions
(``*_plain``) that the tests hold the library against; ``generate_batch_
plain`` draws from numpy's generator, another stream than the library's.

Public surface:
  * :func:`generate_batch`: uniform / Zipf table-batched sparse features.
  * :func:`decompose_indices_np`, :func:`decompose_indices64_np`: host-side
    mixed-radix decomposition (int32 and int64 row ids).
  * :func:`expand_offsets_np`: CSR offsets -> (rowidx, tableidx).
  * :func:`csr_to_padded_np`: CSR -> fixed-pooling ``[T, B, L]``.
  * :class:`PrefetchLoader`: a background thread that keeps numpy batches
    ahead of the consumer (the upload to the card stays with the caller).
  * :func:`native_available` / :func:`build`.

Negative row ids: the library divides by truncation (C++), the plain
versions by floor division (numpy), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().with_name("loader.cpp")
BUILD_ROOT = _SRC.parents[2] / "build" / "fbtt_torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: list = []  # the loaded library, once built


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libfbtt_loader.so"


def build(force: bool = False) -> Path:
    """Compile ``loader.cpp`` into the build directory (unless a library of
    this source and these flags is there); returns its path. Raises
    RuntimeError with the compiler's output when the compile fails."""
    lib = _lib_path()
    if lib.exists() and not force:
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"],
            capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(
            "g++ not found: the native loader of fbtt_embedding_tpu_torch "
            "cannot be built") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {proc.returncode}) on "
                           f"{_SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic against a concurrent build
    return lib


def _load() -> ctypes.CDLL:
    with _LOCK:
        if _LIB:
            return _LIB[0]
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.fbtt_generate_batch.argtypes = [
            ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_double, ctypes.c_int32, i32p, i32p, f32p,
        ]
        lib.fbtt_generate_batch.restype = None
        lib.fbtt_decompose_indices.argtypes = [
            i32p, ctypes.c_int64, i32p, ctypes.c_int32, i32p]
        lib.fbtt_decompose_indices.restype = None
        lib.fbtt_decompose_indices64.argtypes = [
            i64p, ctypes.c_int64, i32p, ctypes.c_int32, i32p]
        lib.fbtt_decompose_indices64.restype = None
        lib.fbtt_expand_offsets.argtypes = [
            i32p, ctypes.c_int32, ctypes.c_int32, i32p, i32p]
        lib.fbtt_expand_offsets.restype = None
        lib.fbtt_csr_to_padded.argtypes = [
            i32p, f32p, i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, f32p]
        lib.fbtt_csr_to_padded.restype = ctypes.c_int64
        lib.fbtt_version.argtypes = []
        lib.fbtt_version.restype = ctypes.c_int32
        _LIB.append(lib)
        return lib


def native_available() -> bool:
    """Whether the library builds and loads (raises nothing; the entry
    points themselves raise when it does not)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _strides(p: np.ndarray) -> np.ndarray:
    strides = np.ones(len(p), np.int64)
    for t in range(len(p) - 2, -1, -1):
        strides[t] = strides[t + 1] * p[t + 1]
    return strides


def generate_batch(
    seed: int,
    num_embeddings: int,
    num_tables: int,
    batch_size: int,
    pooling_factor: int,
    alpha: float = 1.0,
    weighted: bool = False,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """One table-batched sparse batch ``(indices [T*B*L] int32, offsets
    [T*B+1] int32, weights [T*B*L] float32 or None)``, every bag
    ``pooling_factor`` long. ``alpha > 1`` draws Zipf(alpha) mod E (the
    reference benchmark's skewed traffic, ``tt_embeddings_benchmark.py:
    61-69``), else uniform. Deterministic for a seed on a host: a batch of
    4096 lookups or more is drawn by the host's threads, each restarting a
    stream at its range as the JAX package's library does, which leaves
    part of some ranges unwritten (ROADMAP §C); this copy writes them."""
    t, b, l = num_tables, batch_size, pooling_factor
    nnz = t * b * l
    lib = _load()
    indices = np.empty(nnz, np.int32)
    offsets = np.empty(t * b + 1, np.int32)
    weights = np.empty(nnz if weighted else 0, np.float32)
    lib.fbtt_generate_batch(
        ctypes.c_uint64(seed), ctypes.c_int64(num_embeddings), t, b, l,
        ctypes.c_double(alpha), int(weighted), _i32p(indices),
        _i32p(offsets), _f32p(weights))
    return indices, offsets, (weights if weighted else None)


def generate_batch_plain(
    seed: int,
    num_embeddings: int,
    num_tables: int,
    batch_size: int,
    pooling_factor: int,
    alpha: float = 1.0,
    weighted: bool = False,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """:func:`generate_batch`'s layout and distribution drawn from numpy's
    ``default_rng(seed)`` (the JAX package's fallback body): another random
    stream than the library's."""
    nnz = num_tables * batch_size * pooling_factor
    rng = np.random.default_rng(seed)
    if alpha <= 1.0:
        indices = rng.integers(0, num_embeddings, nnz).astype(np.int32)
    else:
        indices = (rng.zipf(alpha, nnz) % num_embeddings).astype(np.int32)
    offsets = np.arange(0, nnz + 1, pooling_factor, dtype=np.int32)
    weights = rng.random(nnz).astype(np.float32) if weighted else None
    return indices, offsets, weights


def decompose_indices_np(indices: np.ndarray, p_shapes) -> np.ndarray:
    """Mixed-radix decomposition of int32 row ids -> ``[ndim, nnz]`` int32,
    ``(id // prod(p[t+1:])) % p[t]``."""
    indices = np.ascontiguousarray(indices, np.int32).reshape(-1)
    p = np.ascontiguousarray(p_shapes, np.int32)
    out = np.empty((len(p), indices.size), np.int32)
    _load().fbtt_decompose_indices(
        _i32p(indices), ctypes.c_int64(indices.size), _i32p(p), len(p),
        _i32p(out))
    return out


def decompose_indices64_np(indices: np.ndarray, p_shapes) -> np.ndarray:
    """:func:`decompose_indices_np` of int64 row ids (tables of 2^31 rows or
    more); every part still fits int32."""
    indices = np.ascontiguousarray(indices, np.int64).reshape(-1)
    p = np.ascontiguousarray(p_shapes, np.int32)
    out = np.empty((len(p), indices.size), np.int32)
    _load().fbtt_decompose_indices64(
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(indices.size), _i32p(p), len(p), _i32p(out))
    return out


def decompose_indices_plain(indices: np.ndarray, p_shapes) -> np.ndarray:
    """Plain numpy version of :func:`decompose_indices_np` and
    :func:`decompose_indices64_np` (floor division)."""
    idx = np.asarray(indices, np.int64).reshape(-1)
    p = np.asarray(p_shapes, np.int64)
    strides = _strides(p)
    return np.stack([((idx // strides[t]) % p[t]).astype(np.int32)
                     for t in range(len(p))])


def expand_offsets_np(offsets: np.ndarray, num_tables: int,
                      batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Table-major CSR offsets (``T*B + 1`` entries) -> per-lookup
    ``(rowidx, tableidx)`` int32: bag ``b`` is row ``b % B`` of table
    ``b // B``."""
    offsets = np.ascontiguousarray(offsets, np.int32)
    if offsets.shape != (num_tables * batch_size + 1,):
        raise ValueError(f"offsets has shape {offsets.shape}; expected "
                         f"({num_tables * batch_size + 1},)")
    nnz = int(offsets[-1])
    rowidx = np.empty(nnz, np.int32)
    tableidx = np.empty(nnz, np.int32)
    _load().fbtt_expand_offsets(_i32p(offsets), num_tables, batch_size,
                                _i32p(rowidx), _i32p(tableidx))
    return rowidx, tableidx


def expand_offsets_plain(offsets: np.ndarray, num_tables: int,
                         batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Plain numpy version of :func:`expand_offsets_np`."""
    offsets = np.asarray(offsets, np.int64)
    nnz = int(offsets[-1])
    bag = np.searchsorted(offsets, np.arange(nnz), side="right") - 1
    return ((bag % batch_size).astype(np.int32),
            (bag // batch_size).astype(np.int32))


def _csr_checks(indices, offsets, t: int, b: int, l: int, weights):
    """The inputs of the CSR re-layout, checked; ``(indices, offsets,
    weights)`` as contiguous arrays."""
    indices = np.ascontiguousarray(indices, np.int32).reshape(-1)
    offsets = np.ascontiguousarray(offsets, np.int32).reshape(-1)
    if offsets.shape[0] != t * b + 1:
        raise ValueError(f"offsets has {offsets.shape[0]} entries; expected "
                         f"num_tables * batch_size + 1 = {t * b + 1}")
    lens = np.diff(offsets)
    if lens.min(initial=0) < 0:
        raise ValueError("offsets must be non-decreasing")
    if lens.max(initial=0) > l:
        raise ValueError(
            f"bag length {int(lens.max())} exceeds pooling_factor {l}")
    if offsets[0] < 0 or offsets[-1] > indices.shape[0]:
        raise ValueError(f"offsets span [{offsets[0]}, {offsets[-1]}) does "
                         f"not lie within the {indices.shape[0]} indices")
    if weights is not None:
        weights = np.ascontiguousarray(weights, np.float32).reshape(-1)
        if weights.shape != indices.shape:
            raise ValueError(f"weights has shape {weights.shape}; expected "
                             f"{indices.shape}")
    return indices, offsets, weights


def csr_to_padded_np(
    indices: np.ndarray,
    offsets: np.ndarray,
    num_tables: int,
    batch_size: int,
    pooling_factor: int,
    weights: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR (the reference's layout, ``tt_embeddings_ops.py:821-874``) ->
    fixed pooling ``(idx [T, B, L] int32, w [T, B, L] float32)`` for the
    multi-GPU steps: pad slots get index -1 (dropped by LFU counting in
    every table mode, missed by cache probes) and weight 0 (nothing forward
    or backward); the real slots the given weights, or 1. Raises ValueError
    for a bag longer than ``pooling_factor`` or offsets that decrease."""
    t, b, l = num_tables, batch_size, pooling_factor
    indices, offsets, weights = _csr_checks(indices, offsets, t, b, l,
                                            weights)
    idx_out = np.empty((t, b, l), np.int32)
    w_out = np.empty((t, b, l), np.float32)
    wp = (_f32p(weights) if weights is not None
          else ctypes.cast(None, ctypes.POINTER(ctypes.c_float)))
    over = _load().fbtt_csr_to_padded(_i32p(indices), wp, _i32p(offsets), t,
                                      b, l, _i32p(idx_out), _f32p(w_out))
    if over != 0:  # the checks above make this unreachable
        raise RuntimeError(f"csr_to_padded: {over} entries past the bags")
    return idx_out, w_out


def csr_to_padded_plain(
    indices: np.ndarray,
    offsets: np.ndarray,
    num_tables: int,
    batch_size: int,
    pooling_factor: int,
    weights: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Plain numpy version of :func:`csr_to_padded_np`."""
    t, b, l = num_tables, batch_size, pooling_factor
    indices, offsets, weights = _csr_checks(indices, offsets, t, b, l,
                                            weights)
    lens = np.diff(offsets)
    bag_of = np.repeat(np.arange(t * b), lens)
    j = np.arange(bag_of.size) - np.repeat(offsets[:-1] - offsets[0], lens)
    src = offsets[0] + np.arange(bag_of.size)
    idx_out = np.full((t * b, l), -1, np.int32)
    w_out = np.zeros((t * b, l), np.float32)
    idx_out[bag_of, j] = indices[src]
    w_out[bag_of, j] = 1.0 if weights is None else weights[src]
    return idx_out.reshape(t, b, l), w_out.reshape(t, b, l)


class PrefetchLoader:
    """Background-thread batch pipeline: yields :func:`generate_batch`'s
    ``(indices, offsets, weights)`` numpy batches for seeds ``seed``,
    ``seed + 1``, ..., up to ``depth`` batches ahead of the consumer, and
    ``num_batches`` of them (None: without end). The upload to the card
    stays with the caller. The library is built by the constructor, so a
    failed build raises there; a failure in the thread is raised by the
    iterator. :meth:`close` stops the thread and waits for it."""

    def __init__(
        self,
        num_embeddings: int,
        num_tables: int,
        batch_size: int,
        pooling_factor: int,
        alpha: float = 1.0,
        weighted: bool = False,
        seed: int = 0,
        depth: int = 4,
        num_batches: Optional[int] = None,
    ) -> None:
        _load()
        self._args = (num_embeddings, num_tables, batch_size, pooling_factor)
        self._alpha = alpha
        self._weighted = weighted
        self._seed = seed
        self._num_batches = num_batches
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item``, waiting for room; False once closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        i = 0
        try:
            while self._num_batches is None or i < self._num_batches:
                batch = generate_batch(self._seed + i, *self._args,
                                       alpha=self._alpha,
                                       weighted=self._weighted)
                if not self._put(batch):
                    return
                i += 1
            self._put(None)
        except Exception as e:  # handed to the consumer, which raises it
            self._put(e)

    def __iter__(self) -> Iterator:
        while True:
            batch = self._q.get()
            if batch is None:
                return
            if isinstance(batch, Exception):
                raise batch
            yield batch

    def close(self) -> None:
        """Stop the thread and wait for it (it checks for the stop every
        0.1 s and after each batch)."""
        self._stop.set()
        self._thread.join(60)
