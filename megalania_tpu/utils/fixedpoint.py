"""64-bit fixed-point cost carried as an (hi, lo) int32 pair.

Costs are bits<<11; a 1 MiB block can exceed 2**31, and the program keeps
JAX's default 32-bit types (no global x64), so totals are held as
hi*2**16 + lo with 0 <= lo < 2**16 after normalization.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

LO_BITS = 16
LO_MASK = (1 << LO_BITS) - 1


def accumulate(hi, lo, delta):
    """Add a per-packet delta (< 2**30) and renormalize."""
    lo = lo + delta
    hi = hi + (lo >> LO_BITS)
    lo = lo & LO_MASK
    return hi, lo


def less(hi_a, lo_a, hi_b, lo_b):
    return (hi_a < hi_b) | ((hi_a == hi_b) & (lo_a < lo_b))


def to_float(hi, lo):
    return hi.astype(jnp.float32) * (1 << LO_BITS) + lo.astype(jnp.float32)


def to_int(hi, lo) -> int:
    """Host-side exact integer value."""
    return int(hi) * (1 << LO_BITS) + int(lo)


def argmin(hi, lo):
    """Exact lexicographic argmin over parallel (hi, lo) arrays.

    Two-stage: find min hi, then argmin of lo restricted to rows at the
    min (others forced to +inf).  Avoids float32 keys, whose 24-bit
    mantissa mis-ranks totals beyond 2**24 units."""
    min_hi = jnp.min(hi)
    masked_lo = jnp.where(hi == min_hi, lo, jnp.int32(2**31 - 1))
    return jnp.argmin(masked_lo)


# plain numpy: a module-level jnp constant would initialize the JAX
# backend at import time, locking the platform before the CLI's
# --platform flag (or a test's config update) can choose it
INF_HI = np.int32(2**31 - 1)
