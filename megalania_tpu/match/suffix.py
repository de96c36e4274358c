"""Suffix-array machinery: O(1) longest-common-extension queries.

The reference walks byte-by-byte to extend matches
(/root/reference/src/substring_enumerator.c:85-105) — a data-dependent
loop that cannot live inside a device scan.  Instead we precompute, per
block, the classic SA + LCP + sparse-table-RMQ structure so that
lce(a, b) = length of the longest common prefix of data[a:] and data[b:]
is a handful of gathers — usable both in host numpy (candidate-table
build) and inside the jitted anneal scan (rep-match validation).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


class LCEIndex(NamedTuple):
    rank: np.ndarray    # int32[n]   suffix rank of each position
    sparse: np.ndarray  # int32[K,n] sparse-table mins over the LCP array
    n: int


def suffix_array(data: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array (numpy argsort), O(n log^2 n)."""
    n = len(data)
    if n == 0:
        return np.zeros(0, np.int32)
    raw = np.asarray(data, np.int64)
    sa = np.argsort(raw, kind="stable").astype(np.int64)
    # densify ranks so the composite key rank*(n+1)+next fits without
    # collisions (raw byte values can exceed n)
    rank = np.empty(n, np.int64)
    sk = raw[sa]
    rank[sa] = np.concatenate([[0], np.cumsum(sk[1:] != sk[:-1])])
    k = 1
    tmp = np.empty(n, np.int64)
    while k < n:
        # sort by (rank[i], rank[i+k]) using a composite key
        second = np.full(n, -1, np.int64)
        second[: n - k] = rank[k:]
        key = rank * (n + 1) + (second + 1)
        sa = np.argsort(key, kind="stable")
        sk = key[sa]
        tmp[0] = 0
        tmp[1:] = np.cumsum(sk[1:] != sk[:-1])
        rank[sa] = tmp
        if tmp[-1] == n - 1:
            break
        k <<= 1
    return sa.astype(np.int32)


def lcp_array(data: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Kasai's algorithm: lcp[i] = lcp(suffix sa[i-1], suffix sa[i])."""
    n = len(sa)
    lcp = np.zeros(n, np.int32)
    if n == 0:
        return lcp
    rank = np.empty(n, np.int64)
    rank[sa] = np.arange(n)
    h = 0
    for i in range(n):
        r = rank[i]
        if r > 0:
            j = sa[r - 1]
            while i + h < n and j + h < n and data[i + h] == data[j + h]:
                h += 1
            lcp[r] = h
            if h:
                h -= 1
        else:
            h = 0
    return lcp


def build_lce(data) -> LCEIndex:
    """Build the LCE index for a block."""
    data = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    n = len(data)
    sa = suffix_array(data)
    lcp = None
    if n > (1 << 16):       # Kasai's Python loop is the big-n bottleneck
        try:
            from . import optparse_native as on
            if on.available():
                lcp = on.lcp(data, sa)
        except Exception:  # noqa: BLE001 — numpy fallback below
            lcp = None
    if lcp is None:
        lcp = lcp_array(data, sa)
    K = max(1, int(np.ceil(np.log2(max(n, 2)))))
    sparse = np.full((K, max(n, 1)), np.int32(1 << 30))
    if n:
        sparse[0, :n] = lcp
        for k in range(1, K):
            half = 1 << (k - 1)
            m = n - half
            if m > 0:
                sparse[k, :m] = np.minimum(sparse[k - 1, :m],
                                           sparse[k - 1, half:half + m])
            sparse[k, max(m, 0):] = sparse[k - 1, max(m, 0):]
    rank = np.empty(n, np.int32)
    rank[sa] = np.arange(n, dtype=np.int32)
    return LCEIndex(rank=rank, sparse=sparse, n=n)


def lce_np(index: LCEIndex, a, b):
    """Vectorized host LCE; a, b arrays of positions (a != b)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    ra, rb = index.rank[a].astype(np.int64), index.rank[b].astype(np.int64)
    lo = np.minimum(ra, rb) + 1
    hi = np.maximum(ra, rb) + 1          # query interval [lo, hi)
    span = np.maximum(hi - lo, 1)
    k = (np.frexp(span.astype(np.float64))[1] - 1).astype(np.int64)
    left = index.sparse[k, lo]
    right = index.sparse[k, hi - (1 << k)]
    return np.where(a == b, index.n - a, np.minimum(left, right))


def lce_jnp(rank, sparse, n, a, b):
    """Same query in jnp for use inside jitted scans.

    rank: int32[n]; sparse: int32[K, n]; a, b scalars or arrays of equal
    shape (clamped to valid range by the caller).
    """
    ra = rank[a]
    rb = rank[b]
    lo = jnp.minimum(ra, rb) + 1
    hi = jnp.maximum(ra, rb) + 1
    span = jnp.maximum(hi - lo, 1)
    k = 31 - jax_clz(span)
    left = sparse[k, lo]
    right = sparse[k, hi - (1 << k)]
    return jnp.where(a == b, n - a, jnp.minimum(left, right))


def jax_clz(x):
    import jax.lax as lax

    return lax.clz(jnp.asarray(x, jnp.int32))
