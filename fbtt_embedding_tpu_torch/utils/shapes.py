"""Automatic TT shape factorization.

Equivalent of the reference's ``suggested_tt_shapes``
(``tt_embeddings_ops.py:359-418``) without the sympy/scipy dependency:
factorize ``n``, enumerate distinct factorizations into ``d`` factors, pick
the maximum-entropy (most balanced) one, optionally rounding ``n`` up to a
multiple of a power of 10 when that enables a more balanced factorization.

A copy of ``fbtt_embedding_tpu.utils.shapes`` (numpy only), kept here so
the port never imports the JAX package.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Iterator, List, Tuple


def prime_factorize(n: int) -> List[int]:
    """Prime factors of n (with multiplicity), ascending. Trial division."""
    assert n >= 1
    factors = []
    for p in (2, 3):
        while n % p == 0:
            factors.append(p)
            n //= p
    f = 5
    while f * f <= n:
        for p in (f, f + 2):
            while n % p == 0:
                factors.append(p)
                n //= p
        f += 6
    if n > 1:
        factors.append(n)
    return factors


def _divisors(n: int) -> List[int]:
    divs = []
    i = 1
    while i * i <= n:
        if n % i == 0:
            divs.append(i)
            if i != n // i:
                divs.append(n // i)
        i += 1
    return sorted(divs)


def factorizations(n: int, d: int) -> Iterator[Tuple[int, ...]]:
    """Distinct unordered factorizations of n into exactly d factors >= 1.

    Yielded non-decreasing. Factors of 1 are allowed (the reference pads its
    prime-factor list with 1s when there are fewer primes than d,
    ``tt_embeddings_ops.py:377-378``).
    """
    if d == 1:
        yield (n,)
        return

    def rec(m: int, k: int, lo: int):
        if k == 1:
            if m >= lo:
                yield (m,)
            return
        for a in _divisors(m):
            if a < lo:
                continue
            # Remaining k-1 factors are each >= a, so m//a >= a^(k-1).
            if a ** (k - 1) > m // a:
                if a > 1:
                    break
            for rest in rec(m // a, k - 1, a):
                yield (a,) + rest

    yield from rec(n, d, 1)


def _entropy(values: Tuple[int, ...]) -> float:
    total = float(sum(values))
    h = 0.0
    for v in values:
        p = v / total
        if p > 0:
            h -= p * math.log(p)
    return h


def _roundrobin_halves(values: Tuple[int, ...]) -> List[int]:
    """Reference's ``prepr`` ordering (``tt_embeddings_ops.py:391-395``):
    sort, split into halves, interleave small/large round-robin."""
    x = sorted(values)
    n = len(x)
    xf, xl = x[: n // 2], x[n // 2 :]
    out = []
    i = j = 0
    while i < len(xf) or j < len(xl):
        if i < len(xf):
            out.append(xf[i])
            i += 1
        if j < len(xl):
            out.append(xl[j])
            j += 1
    return out


@lru_cache(maxsize=256)
def _auto_shape(n: int, d: int) -> Tuple[int, ...]:
    best = None
    best_h = -1.0
    for f in factorizations(n, d):
        h = _entropy(f)
        if h > best_h:
            best_h = h
            best = f
    assert best is not None
    return tuple(_roundrobin_halves(best))


def suggested_tt_shapes(n: int, d: int = 3, allow_round_up: bool = True) -> List[int]:
    """Suggest a d-way factorization of n for TT p/q shapes.

    Mirrors the reference API (``tt_embeddings_ops.py:359-418``): when
    ``allow_round_up`` is True, ``n`` may be rounded up to a multiple of a
    power of ten when that yields a more balanced (higher-entropy)
    factorization; the product of the result is then >= n.
    """
    assert n > 0 and d > 0
    if allow_round_up:
        best = None
        best_h = -1.0
        for i in range(len(str(n))):
            n_i = int(math.ceil(n / 10**i)) * 10**i
            shape = _auto_shape(n_i, d)
            h = _entropy(shape)
            if h > best_h:
                best_h = h
                best = shape
        return list(best)
    return list(_auto_shape(n, d))
