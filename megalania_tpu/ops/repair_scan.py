"""Fused repair + exact-costing pass: one annealing move's heavy half.

Replaces the reference's encode-prefix / mutate / repair-tail walk
(/root/reference/src/packet_slab_neighbour.c:82-173) with a single
functional scan over the (already mutated) slab:

  * positions < q encode as-is;
  * positions >= q run the repair rules (literal<->short-rep flips by
    rep0 byte equality, long-rep re-aiming against the live rep stack,
    fallback to literal) before encoding;
  * the pass emits the repaired slab (with live bits) as its output, so
    accept/reject is a pure select — no undo stack;
  * at scan index u it records (ctx, dists, live_pos): the coder state at
    the next mutation site, consumed by the next iteration's proposer.

Partial re-cost (SURVEY §7's snapshot mitigation for the reference's
O(n)-per-move full re-encode, packet_slab_neighbour.c:154-173): the pass
can (a) START from a coder-state snapshot at position `start_pos`
(probs_in/carry_in) instead of position 0 — positions < start_pos pass
through verbatim and contribute their cost via the snapshot's hi/lo —
and (b) CAPTURE a snapshot of the full coder state entering position
`cap_pos` (cap_pos >= n means "after the last position", i.e. the final
state).  The caller must guarantee start_pos <= min(q, u) and
cap_pos <= q so the capture is valid for both the accepted and the
rejected slab (the prefix below the mutation site is shared).

Deviations from the reference, by design:
  * an unrepairable long rep falls back to literal/short-rep instead of
    a state-dependent top-K resample (which would put candidate search
    in every scan step); proposal-quality impact is absorbed by running
    many chains;
  * long-rep validity is checked against the precomputed per-position
    Pareto candidate table (shared row read) instead of an exact LCE
    query (per-chain gathers into [K, n] tables).  A rep distance absent
    from the table is treated as invalid — a safe false negative: the
    parse stays valid, the move is just slightly more conservative.
    This keeps the semantics identical between this scan and the walk
    kernel (kernels/repair_walk.h), which reads one shared table row
    per repaired long rep.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import bitplan
from . import tables as T
from ..models import lzma_state as S
from ..models import packets as P
from ..utils import fixedpoint as fp


class RepairCarry(NamedTuple):
    probs: jnp.ndarray
    ctx: jnp.ndarray
    dists: jnp.ndarray
    live_pos: jnp.ndarray
    cost_hi: jnp.ndarray
    cost_lo: jnp.ndarray
    since_mut: jnp.ndarray   # live packets processed at/after q
    rec_ctx: jnp.ndarray
    rec_dists: jnp.ndarray
    rec_live: jnp.ndarray
    ord: jnp.ndarray         # live-packet ordinal of the current packet


def _repair_entry(i, ptype, dist, length, carry: RepairCarry, data,
                  cand_d_row, cand_l_row, n, lrep_fallback="litsrep"):
    """Apply the repair rules to one packet under the current state.

    cand_d_row/cand_l_row: the [M] candidate-table row at position i
    (length 0 marks an empty slot), shared by all chains.
    """
    d0 = carry.dists[0]
    mb = data[jnp.clip(i - d0 - 1, 0, n - 1)]
    srep_ok = (i > 0) & (i >= d0 + 1) & (data[i] == mb)
    count_ok = carry.since_mut < 4
    ls_type = jnp.where(
        srep_ok & count_ok, P.SREP, jnp.where(srep_ok, ptype, P.LIT)
    )

    # long-rep re-aim: try current index, then stack order 0..3;
    # validity = the stack distance appears in the candidate row with
    # sufficient extension (false negatives allowed, see module doc)
    in_range = carry.dists + 1 <= i
    hit4 = jnp.any(
        (cand_d_row[None, :] == carry.dists[:, None])
        & (cand_l_row[None, :] >= length),
        axis=1,
    )
    valid4 = in_range & hit4
    cur_idx = jnp.clip(dist, 0, 3)
    cur_ok = valid4[cur_idx]
    first_valid = jnp.argmax(valid4)
    lrep_ok = cur_ok | valid4.any()
    lrep_idx = jnp.where(cur_ok, cur_idx, first_valid)
    fb_type = jnp.where(srep_ok & count_ok, P.SREP, P.LIT)

    is_ls = (ptype == P.LIT) | (ptype == P.SREP)
    is_lrep = ptype == P.LREP

    if lrep_fallback == "match":
        # reference-flavoured fallback (packet_slab_neighbour.c:104-109
        # resamples from the top-K; here: the longest table match at
        # this position, smallest distance on ties — state-free, so it
        # is identical across chains and kernels)
        ml = jnp.max(cand_l_row)
        bd = jnp.min(jnp.where(cand_l_row == ml, cand_d_row, 2**30))
        flen = jnp.minimum(ml, n - i)
        use_m = is_lrep & ~lrep_ok & (flen >= 2)
    else:
        bd = 0
        flen = 0
        use_m = jnp.bool_(False)

    new_type = jnp.where(
        is_ls, ls_type,
        jnp.where(is_lrep,
                  jnp.where(lrep_ok, P.LREP,
                            jnp.where(use_m, P.MATCH, fb_type)), ptype),
    )
    new_dist = jnp.where(is_lrep & lrep_ok, lrep_idx,
                         jnp.where(use_m, bd,
                                   jnp.where(is_ls | is_lrep, 0, dist)))
    new_len = jnp.where(use_m, flen,
                        jnp.where(is_lrep & ~lrep_ok, 1,
                                  jnp.where(is_ls, 1, length)))
    return new_type, new_dist, new_len


def repair_step(carry: RepairCarry, i, entry, q, u, data, cand_d_row,
                cand_l_row, log2, site_mode="byte",
                lrep_fallback="litsrep", start_pos=0, lc: int = 0):
    n = data.shape[0]
    active = i == carry.live_pos

    # record the coder state for the *next* iteration's mutation site.
    # site_mode "byte": u is a byte position -> the containing/following
    # live packet (weights sites by preceding length); "packet": u is a
    # live-packet ordinal -> uniform over live packets, the reference's
    # distribution (packet_slab_neighbour.c:162-163) up to the one-pass
    # staleness of the count the ordinal was drawn from.
    # Positions below start_pos are outside the walked region (the fused
    # kernel never visits their tiles), so they never record.
    if site_mode == "packet":
        at_u = active & (carry.ord == u)
    else:
        at_u = (i == u) & (i >= start_pos)
    carry = carry._replace(
        rec_ctx=jnp.where(at_u, carry.ctx, carry.rec_ctx),
        rec_dists=jnp.where(at_u, carry.dists, carry.rec_dists),
        rec_live=jnp.where(at_u, carry.live_pos, carry.rec_live),
    )

    ptype, dist, length, _ = P.unpack(entry)
    in_repair = active & (i >= q)
    r_type, r_dist, r_len = _repair_entry(
        i, ptype, dist, length, carry, data, cand_d_row, cand_l_row, n,
        lrep_fallback=lrep_fallback,
    )
    ptype = jnp.where(in_repair, r_type, ptype)
    dist = jnp.where(in_repair, r_dist, dist)
    length = jnp.where(in_repair, r_len, length)

    byte = data[i]
    match_byte = data[jnp.clip(i - carry.dists[0] - 1, 0, n - 1)]
    prev_byte = jnp.where(i > 0, data[jnp.maximum(i - 1, 0)], 0)
    plan = bitplan.make_bit_plan(
        ptype, dist, length, carry.ctx, carry.dists, byte, match_byte,
        prev_byte=prev_byte, lc=lc,
    )
    plan = plan._replace(
        active=plan.active & active,
        n_direct=jnp.where(active, plan.n_direct, 0),
    )
    probs, cost = bitplan.apply_plan(carry.probs, plan, log2, lc=lc)
    hi, lo = fp.accumulate(carry.cost_hi, carry.cost_lo, cost)

    out_entry = jnp.where(
        i < start_pos,                      # unwalked prefix: verbatim
        jnp.asarray(entry, jnp.uint32),
        jnp.where(
            active,
            P.pack(ptype, dist, length, live=1),
            jnp.asarray(entry, jnp.uint32)
            & jnp.uint32(~(1 << P.LIVE_SHIFT) & 0xFFFFFFFF),
        ),
    )
    carry = RepairCarry(
        probs=probs,
        ctx=jnp.where(active, S.ctx_next(carry.ctx, ptype), carry.ctx),
        dists=jnp.where(active, S.dists_next(carry.dists, ptype, dist),
                        carry.dists),
        live_pos=carry.live_pos + jnp.where(active, length, 0),
        cost_hi=hi,
        cost_lo=lo,
        since_mut=carry.since_mut + jnp.where(in_repair, 1, 0),
        rec_ctx=carry.rec_ctx,
        rec_dists=carry.rec_dists,
        rec_live=carry.rec_live,
        ord=carry.ord + jnp.where(active, 1, 0),
    )
    return carry, out_entry


def _init_carry(C: int, lc: int = 0) -> RepairCarry:
    return RepairCarry(
        probs=jnp.broadcast_to(
            jnp.asarray(T.init_probs_np(lc=lc), jnp.int32),
            (C, T.probs_pad(lc))),
        ctx=jnp.zeros(C, jnp.int32),
        dists=jnp.zeros((C, 4), jnp.int32),
        live_pos=jnp.zeros(C, jnp.int32),
        cost_hi=jnp.zeros(C, jnp.int32),
        cost_lo=jnp.zeros(C, jnp.int32),
        since_mut=jnp.zeros(C, jnp.int32),
        rec_ctx=jnp.zeros(C, jnp.int32),
        rec_dists=jnp.zeros((C, 4), jnp.int32),
        rec_live=jnp.zeros(C, jnp.int32),
        ord=jnp.zeros(C, jnp.int32),
    )


# The 16-field scalar-carry snapshot layout, shared bit-for-bit with the
# walk kernel's carry (kernels/repair_walk.h): one int32 per field.
CARRY16 = ("ctx", "d0", "d1", "d2", "d3", "live", "hi", "lo", "since",
           "rctx", "rd0", "rd1", "rd2", "rd3", "rlive", "pord")


def carry_to16(c: RepairCarry) -> jnp.ndarray:
    """RepairCarry scalars -> int32[C, 16] (probs excluded)."""
    return jnp.stack([
        c.ctx, c.dists[:, 0], c.dists[:, 1], c.dists[:, 2], c.dists[:, 3],
        c.live_pos, c.cost_hi, c.cost_lo, c.since_mut,
        c.rec_ctx, c.rec_dists[:, 0], c.rec_dists[:, 1],
        c.rec_dists[:, 2], c.rec_dists[:, 3], c.rec_live, c.ord,
    ], axis=1)


def carry_from16(probs, c16) -> RepairCarry:
    """int32[C, 16] + flat probs -> RepairCarry."""
    return RepairCarry(
        probs=probs, ctx=c16[:, 0], dists=c16[:, 1:5], live_pos=c16[:, 5],
        cost_hi=c16[:, 6], cost_lo=c16[:, 7], since_mut=c16[:, 8],
        rec_ctx=c16[:, 9], rec_dists=c16[:, 10:14], rec_live=c16[:, 14],
        ord=c16[:, 15],
    )


def repair_cost_batched(slabs, q, u, data, cand_dist, cand_len, log2,
                        unroll: int = 1, site_mode: str = "byte",
                        lrep_fallback: str = "litsrep",
                        start_pos=None, cap_pos=None,
                        probs_in=None, carry_in=None, lc: int = 0):
    """Run the fused pass for C chains in one scan.

    slabs: uint32[C, n] mutated slabs; q, u: int32[C];
    cand_dist/cand_len: int32[n, M] candidate table (len 0 = empty slot).

    start_pos (scalar): first walked position; positions below pass
    through verbatim, with their cost/state supplied by the snapshot
    (probs_in [C, PROBS_PAD] flat + carry_in [C, 16], see CARRY16).
    Defaults: start 0 with the fresh init state.
    cap_pos (scalar): position whose entering coder state is captured
    into the snapshot outputs; >= n (the default) captures the final
    state, preserving the historical "final probs" return.

    Chains are batched inside ONE scan (not a vmapped scan per chain),
    and the indexed tables (data/log2) ride the scan carry: on an H100
    (400 W limit) a full pass at n=65536, C=128 took 3.155 s with the
    tables in the carry and 3.221 s with them closed over.  The
    candidate table rows ride the scan's xs (one row per step), never a
    gather at all.

    Returns (new_slabs [C,n] with live bits, cost_hi[C], cost_lo[C],
    snap_probs [C,P] (final probs with the default cap), rec_ctx[C],
    rec_dists[C,4], rec_live[C], live_count[C], snap_carry [C,16]).
    """
    C, n = slabs.shape
    if start_pos is None:
        start_pos = jnp.int32(0)
    if cap_pos is None:
        cap_pos = jnp.int32(n)
    if probs_in is None:
        carry0 = _init_carry(C, lc)
    else:
        carry0 = carry_from16(probs_in, carry_in)
    snap0 = (carry0.probs, carry_to16(carry0))
    init = (carry0, snap0, (data, log2))

    def step(carry_tab, xs):
        carry, snap, (d, lg) = carry_tab
        i, entries, cd_row, cl_row = xs
        # capture the state *entering* position cap_pos (scalar branch:
        # only a copy when it fires, nothing otherwise).  `since` (row 8)
        # is pass-relative — it counts repairs from THIS pass's q — so
        # the snapshot stores 0, the value any later pass (whose q is
        # >= cap_pos by contract) would have at this position.
        snap = jax.lax.cond(
            i == cap_pos,
            lambda c, s: (c.probs, carry_to16(c).at[:, 8].set(0)),
            lambda c, s: s,
            carry, snap)
        body = jax.vmap(
            functools.partial(repair_step, site_mode=site_mode,
                              lrep_fallback=lrep_fallback,
                              start_pos=start_pos, lc=lc),
            in_axes=(0, None, 0, 0, 0, None, None, None, None),
        )
        carry, outs = body(carry, i, entries, q, u, d, cd_row, cl_row, lg)
        return (carry, snap, (d, lg)), outs

    (carry, snap, _), new_slabs = jax.lax.scan(
        step, init,
        (jnp.arange(n, dtype=jnp.int32), jnp.transpose(slabs),
         cand_dist, cand_len),
        unroll=unroll,
    )
    # cap_pos >= n: the capture point is "after the last position"
    past_end = cap_pos >= n
    snap_probs = jnp.where(past_end, carry.probs, snap[0])
    snap_c16 = jnp.where(past_end, carry_to16(carry).at[:, 8].set(0),
                         snap[1])
    return (jnp.transpose(new_slabs), carry.cost_hi, carry.cost_lo,
            snap_probs, carry.rec_ctx, carry.rec_dists, carry.rec_live,
            carry.ord, snap_c16)


def repair_cost(slab, q, u, data, cand_dist, cand_len, log2,
                unroll: int = 1):
    """Single-chain convenience wrapper over the batched pass."""
    outs = repair_cost_batched(slab[None], jnp.asarray(q, jnp.int32)[None],
                               jnp.asarray(u, jnp.int32)[None], data,
                               cand_dist, cand_len, log2, unroll=unroll)
    return tuple(o[0] for o in outs)
