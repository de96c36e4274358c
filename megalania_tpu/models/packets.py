"""Packed packet representation.

The annealing genome ("slab", reference: /root/reference/src/packet_slab.h:5)
is one packet per byte position.  On the device each packet is packed into
a single uint32 so a whole slab is one dense [n] vector:

    bits  0..19  dist   (MATCH: distance-1; LREP: rep-stack index 0..3)
    bits 20..28  len    (1..273)
    bits 29..30  type   (LIT=0, MATCH=1, SREP=2, LREP=3)
    bit  31      live   (set by the costing pass: position is a packet start)

dist < 2**20 limits blocks to 1 MiB, which is the block-sharding design
point (sequence scaling happens across blocks, not within a stream).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

LIT = 0
MATCH = 1
SREP = 2
LREP = 3

DIST_BITS = 20
LEN_SHIFT = 20
TYPE_SHIFT = 29
LIVE_SHIFT = 31

DIST_MASK = (1 << DIST_BITS) - 1
LEN_MASK = (1 << 9) - 1
TYPE_MASK = 3

MAX_BLOCK = 1 << DIST_BITS


def pack(ptype, dist, length, live=0):
    """Pack packet fields (arrays or scalars) into uint32."""
    ptype = jnp.asarray(ptype, jnp.uint32)
    dist = jnp.asarray(dist, jnp.uint32)
    length = jnp.asarray(length, jnp.uint32)
    live = jnp.asarray(live, jnp.uint32)
    return (
        (dist & DIST_MASK)
        | ((length & LEN_MASK) << LEN_SHIFT)
        | ((ptype & TYPE_MASK) << TYPE_SHIFT)
        | ((live & 1) << LIVE_SHIFT)
    )


def unpack(word):
    """-> (type, dist, len, live) as int32 arrays."""
    word = jnp.asarray(word, jnp.uint32)
    ptype = ((word >> TYPE_SHIFT) & TYPE_MASK).astype(jnp.int32)
    dist = (word & DIST_MASK).astype(jnp.int32)
    length = ((word >> LEN_SHIFT) & LEN_MASK).astype(jnp.int32)
    live = (word >> LIVE_SHIFT).astype(jnp.int32)
    return ptype, dist, length, live


def pack_np(ptype, dist, length, live=0):
    ptype = np.asarray(ptype, np.uint32)
    dist = np.asarray(dist, np.uint32)
    length = np.asarray(length, np.uint32)
    live = np.asarray(live, np.uint32)
    return (
        (dist & DIST_MASK)
        | ((length & LEN_MASK) << LEN_SHIFT)
        | ((ptype & TYPE_MASK) << TYPE_SHIFT)
        | ((live & 1) << np.uint32(LIVE_SHIFT))
    ).astype(np.uint32)


def unpack_np(word):
    word = np.asarray(word, np.uint32)
    ptype = ((word >> TYPE_SHIFT) & TYPE_MASK).astype(np.int32)
    dist = (word & DIST_MASK).astype(np.int32)
    length = ((word >> LEN_SHIFT) & LEN_MASK).astype(np.int32)
    live = (word >> np.uint32(LIVE_SHIFT)).astype(np.int32)
    return ptype, dist, length, live


def literal_slab(n: int) -> np.ndarray:
    """All-literal initial parse (reference: packet_slab.c:30-32)."""
    return pack_np(
        np.full(n, LIT), np.zeros(n, np.uint32), np.ones(n, np.uint32)
    )
