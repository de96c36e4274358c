"""Per-packet bit-op compilation: the vectorized packet encoder.

The reference encodes a packet by calling an encoder vtable once per bit
(/root/reference/src/lzma_packet_encoder.c).  Key observation enabling the
device design: within a single packet, every adaptive bit touches a
*distinct* probability slot (bit-tree node indices strictly grow;
header/len/dist groups are disjoint arrays).  A packet therefore compiles to a fixed-width
vector of NSLOTS (slot, bit, active) triples plus a direct-bits count —
one gather + one scatter per packet, fully vectorizable over chains.

Slot layout (order == emission order):
    0..4    packet-header flag bits
    5..14   length coder (MATCH/LREP)  -- or literal bits in 5..12 (LIT)
    15..20  distance pos-slot tree      (MATCH)
    [direct bits: logically between slot 20 and 21]
    21..25  pos_coder / align reverse tree (MATCH)

Semantics follow the LZMA spec as realized by the reference
(lzma_packet_encoder.c:5-194, probability_model.c:3-44); this module is a
re-derivation as vector math, not a translation.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import tables as T
from ..models import packets as P

NSLOTS = 26
_DIRECT_AFTER_SLOT = 20  # direct bits are emitted after this slot index


class BitPlan(NamedTuple):
    idx: jnp.ndarray        # int32[NSLOTS] prob-table slots
    bit: jnp.ndarray        # int32[NSLOTS] bit values 0/1
    active: jnp.ndarray     # bool[NSLOTS]
    n_direct: jnp.ndarray   # int32 scalar: number of direct (prob-free) bits
    direct_val: jnp.ndarray  # int32 scalar: their value (for emission)


def _tree_msb(value, nbits, base, nslots):
    """Bit-tree, MSB first: node m starts at 1, m = (m<<1)|bit each step.

    After j steps m == (1<<j) | (value >> (nbits-j)).
    """
    j = jnp.arange(nslots, dtype=jnp.int32)
    active = j < nbits
    m = (1 << j) | (value >> jnp.maximum(nbits - j, 0))
    bit = (value >> jnp.maximum(nbits - 1 - j, 0)) & 1
    return base + m, bit, active


def _tree_rev(value, nbits, base, nslots):
    """Bit-tree, LSB first: node m = (1<<j) | bit-reverse(low j bits)."""
    j = jnp.arange(nslots, dtype=jnp.int32)
    t = jnp.arange(nslots, dtype=jnp.int32)
    vbits = (value >> t) & 1
    sh = j[:, None] - 1 - t[None, :]
    rev = jnp.sum(
        jnp.where(sh >= 0, vbits[None, :] << jnp.maximum(sh, 0), 0), axis=1
    )
    m = (1 << j) | rev
    bit = (value >> j) & 1
    active = j < nbits
    return base + m, bit, active


def make_bit_plan(ptype, dist, length, ctx, dists, byte, match_byte,
                  prev_byte=None, lc: int = 0) -> BitPlan:
    """Compile one packet into its bit plan.

    ptype/dist/length: packet fields (LREP's `dist` is the rep-stack index).
    ctx/dists: coder state *before* the packet.  byte/match_byte: the data
    byte at the current position and the byte one rep0-distance back
    (match_byte only used when ctx >= 7).

    lc (static) selects the literal-context model: the top lc bits of
    prev_byte (the byte BEFORE this position; 0 at position 0) pick one
    of 2^lc literal prob sub-tables (LZMA spec; the reference hardcodes
    lc=0, /root/reference/src/lzma_packet_encoder.c:113 todo).
    """
    ptype = jnp.asarray(ptype, jnp.int32)
    dist = jnp.asarray(dist, jnp.int32)
    length = jnp.asarray(length, jnp.int32)
    ctx = jnp.asarray(ctx, jnp.int32)
    byte = jnp.asarray(byte, jnp.int32)
    match_byte = jnp.asarray(match_byte, jnp.int32)

    is_lit = ptype == P.LIT
    is_match = ptype == P.MATCH
    is_srep = ptype == P.SREP
    is_lrep = ptype == P.LREP
    is_rep = is_srep | is_lrep

    # ---- header flag bits (slots 0..4) --------------------------------
    b3 = is_lrep & (dist != 0)
    b4 = jnp.where(b3, (dist != 1).astype(jnp.int32), is_lrep.astype(jnp.int32))
    b5 = (dist != 2).astype(jnp.int32)
    h_idx = jnp.stack([
        T.IS_MATCH + (ctx << T.POS_BITS_MAX),
        T.IS_REP + ctx,
        T.IS_REP_G0 + ctx,
        jnp.where(b3, T.IS_REP_G1 + ctx, T.IS_REP0_LONG + (ctx << T.POS_BITS_MAX)),
        T.IS_REP_G2 + ctx,
    ])
    h_bit = jnp.stack([
        (~is_lit).astype(jnp.int32),
        is_rep.astype(jnp.int32),
        b3.astype(jnp.int32),
        b4,
        b5,
    ])
    h_act = jnp.stack([
        jnp.bool_(True),
        ~is_lit,
        is_rep,
        is_rep,
        is_rep & b3 & (b4 == 1),
    ])

    # ---- length coder (slots 5..14, MATCH/LREP) -----------------------
    len_active = is_match | is_lrep
    len2 = jnp.maximum(length - T.MATCH_LEN_MIN, 0)
    base = jnp.where(is_match, T.LEN, T.REP_LEN)
    c1 = len2 >= 8
    c2 = len2 >= 16
    tree_base = base + jnp.where(~c1, T.LEN_LOW, jnp.where(~c2, T.LEN_MID, T.LEN_HIGH))
    tree_nb = jnp.where(c2, 8, 3)
    tree_val = jnp.where(~c1, len2, jnp.where(~c2, len2 - 8, len2 - 16))
    lt_idx, lt_bit, lt_act = _tree_msb(tree_val, tree_nb, tree_base, 8)
    len_idx = jnp.concatenate([
        jnp.stack([base + T.LEN_CHOICE1, base + T.LEN_CHOICE2]), lt_idx
    ])
    len_bit = jnp.concatenate([
        jnp.stack([c1.astype(jnp.int32), c2.astype(jnp.int32)]), lt_bit
    ])
    len_act = jnp.concatenate([
        jnp.stack([len_active, len_active & c1]), lt_act & len_active
    ])

    # ---- literal bits (overlay slots 5..12, LIT only) -----------------
    j8 = jnp.arange(8, dtype=jnp.int32)
    lbits = (byte >> (7 - j8)) & 1
    mbits = (match_byte >> (7 - j8)) & 1
    # matched-byte context stays on while the match byte agrees bit-by-bit
    eq = (lbits == mbits).astype(jnp.int32)
    prefix_eq = jnp.concatenate([
        jnp.ones(1, jnp.int32), jnp.cumprod(eq)[:7]
    ])
    matched = (ctx >= 7).astype(jnp.int32) * prefix_eq
    symbol = (1 << j8) | (byte >> (8 - j8))
    lit_idx = T.LIT + symbol + matched * ((1 + mbits) << 8)
    if lc:
        lit_idx = lit_idx + (
            jnp.asarray(prev_byte, jnp.int32) >> (8 - lc)) * 0x300
    lit_act = jnp.concatenate([
        jnp.full(8, is_lit), jnp.zeros(2, jnp.bool_)
    ])
    lit_idx10 = jnp.concatenate([lit_idx, jnp.zeros(2, jnp.int32)])
    lit_bit10 = jnp.concatenate([lbits, jnp.zeros(2, jnp.int32)])

    mid_idx = jnp.where(is_lit, lit_idx10, len_idx)
    mid_bit = jnp.where(is_lit, lit_bit10, len_bit)
    mid_act = jnp.where(is_lit, lit_act, len_act)

    # ---- distance coder (slots 15..25, MATCH only) --------------------
    d = dist
    bl = 32 - jax.lax.clz(d)                    # bit length; clz(0) == 32
    nlb_t = jnp.maximum(bl - 2, 0)
    high = d >> nlb_t
    ps = jnp.where(d < 4, d, nlb_t * 2 + high)  # pos slot
    len_ctx = jnp.minimum(len2, 3)
    ds_idx, ds_bit, ds_act = _tree_msb(ps, 6, T.DIST_SLOT + 64 * len_ctx, 6)
    ds_act = ds_act & is_match

    midrange = (ps >= 4) & (ps < 14)
    nlb = jnp.where(midrange, (ps >> 1) - 1, 4)
    low = d & ((1 << nlb) - 1)
    rbase = jnp.where(midrange, T.POS_CODER + (high << nlb) - ps, T.ALIGN)
    rt_idx, rt_bit, rt_act = _tree_rev(low, nlb, rbase, 5)
    rt_act = rt_act & is_match & (ps >= 4)

    n_direct = jnp.where(is_match & (ps >= 14), nlb_t - 4, 0)
    direct_val = jnp.where(
        n_direct > 0, (d >> 4) & ((1 << jnp.maximum(n_direct, 0)) - 1), 0
    )

    idx = jnp.concatenate([h_idx, mid_idx, ds_idx, rt_idx])
    bit = jnp.concatenate([h_bit, mid_bit, ds_bit, rt_bit])
    active = jnp.concatenate([h_act, mid_act, ds_act, rt_act])
    return BitPlan(idx, bit, active, n_direct, direct_val)


# NOTE: the log2 table must be passed in as a *traced argument*, never
# closed over as a module-level constant: XLA's constant-folding passes
# choke on a 2048-entry constant feeding gathers inside a scan (measured
# 91s -> 0.5s compile time for a single packet step).


def plan_cost(probs, plan: BitPlan, log2, lc: int = 0):
    """Exact fixed-point cost (bits << 11) of the plan under `probs`.

    Read-only: no adaptation (all slots within a packet are distinct, so
    intra-packet adaptation cannot affect its own cost).
    """
    safe = jnp.where(plan.active, plan.idx, T.dead_slot(lc))
    p = probs[safe]
    c = log2[jnp.where(plan.bit == 1, T.PROB_ONE - p, p)]
    return jnp.sum(jnp.where(plan.active, c, 0)) + (plan.n_direct << T.PROB_BITS)


def apply_plan(probs, plan: BitPlan, log2, lc: int = 0):
    """Cost the plan and adapt the probability table.  -> (probs', cost)."""
    safe = jnp.where(plan.active, plan.idx, T.dead_slot(lc))
    p = probs[safe]
    c = log2[jnp.where(plan.bit == 1, T.PROB_ONE - p, p)]
    cost = jnp.sum(jnp.where(plan.active, c, 0)) + (plan.n_direct << T.PROB_BITS)
    adapted = jnp.where(
        plan.bit == 1,
        p - (p >> T.MOVE_BITS),
        p + ((T.PROB_ONE - p) >> T.MOVE_BITS),
    )
    newp = jnp.where(plan.active, adapted, p)
    return probs.at[safe].set(newp), cost
