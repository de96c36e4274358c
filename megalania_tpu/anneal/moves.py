"""Proposal generation: one annealing move per chain.

Mirrors the reference move distribution
(/root/reference/src/packet_slab_neighbour.c:119-152):

  * with p=1/2, a boundary move — shift one byte between a 1-byte packet
    and an adjacent match (shrink head / grow into predecessor);
  * otherwise (or when no boundary applies) a biased sample from the
    top-K next packets by amortized bit cost (cost/len, integer division
    as in top_k_packet_finder.c:115), choice = max of `bias_draws`
    uniforms with a forced-best escape, matching neighbour.c:56-72.

Difference from the reference: candidates come from the precomputed
dense Pareto table plus rep-stack LCE probes, and are *ranked* under the
chain's latest full-pass probability state (recorded ctx/dists at the site, final
probs of the last pass) instead of a freshly re-derived site state.  The
ranking is a proposal heuristic only — acceptance always uses the exact
cost from the repair scan — so the cost==size invariant is untouched.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..match.suffix import lce_jnp
from ..models import packets as P
from ..ops import bitplan, tables as T

SUBLENS = 3  # default lengths per (dist, maxlen) entry: m, m*2//3, 2
BIG = 2 ** 30        # plain int: no backend init at import


def _sublens(maxlen, k: int = SUBLENS):
    """[k] candidate lengths for one entry, duplicates masked.

    The reference enumerates EVERY length 2..ext per occurrence
    (/root/reference/src/substring_enumerator.c:85-105); a dense sweep
    is too wide for a fixed-width candidate tensor, so k spread points
    cover the range: the max, near-max cuts (the usual optima),
    fractions, and the minimum.  k=3 reproduces the historical {m, 2m/3, 2} exactly."""
    m = maxlen
    two = jnp.full_like(m, 2)
    gens = [
        m,
        jnp.maximum((m * 2) // 3, 2),
        two,
        jnp.maximum(m - 1, 2),
        jnp.maximum(m - 2, 2),
        jnp.maximum((m * 3) // 4, 2),
        jnp.maximum(m // 2, 2),
        jnp.maximum(m // 3, 2),
        jnp.maximum(m - 3, 2),
        jnp.full_like(m, 3),
    ]
    assert k <= len(gens), k
    lens = jnp.stack(gens[:k])
    keep = [jnp.ones_like(m, bool)]
    for j in range(1, k):
        uniq = jnp.ones_like(m, bool)
        for jj in range(j):
            uniq = uniq & (lens[j] != lens[jj])
        keep.append(uniq)
    return lens, jnp.stack(keep)


class Candidates(NamedTuple):
    ptype: jnp.ndarray   # int32[NC]
    dist: jnp.ndarray    # int32[NC]
    length: jnp.ndarray  # int32[NC]
    valid: jnp.ndarray   # bool[NC]


def gather_candidates(q, rec_dists, data, rank, sparse, cand_dist, cand_len,
                      cand_count, sublens: int = SUBLENS) -> Candidates:
    """Assemble the candidate set at site q (cf. packet_enumerator.c:57-74)."""
    n = data.shape[0]
    M = cand_dist.shape[1]
    SL = sublens

    # literal — always legal
    t_lit = jnp.array([P.LIT], jnp.int32)
    d_lit = jnp.array([0], jnp.int32)
    l_lit = jnp.array([1], jnp.int32)
    v_lit = jnp.array([True])

    # short rep: byte equality at rep0
    d0 = rec_dists[0]
    mb = data[jnp.clip(q - d0 - 1, 0, n - 1)]
    v_srep = (q > 0) & (q >= d0 + 1) & (data[jnp.clip(q, 0, n - 1)] == mb)
    t_srep = jnp.array([P.SREP], jnp.int32)
    d_srep = jnp.array([0], jnp.int32)
    l_srep = jnp.array([1], jnp.int32)

    # long reps: for each stack slot, extension via LCE
    src = jnp.clip(q - rec_dists - 1, 0, n - 1)
    in_range = (rec_dists + 1 <= q)
    ext4 = jnp.minimum(
        lce_jnp(rank, sparse, n, jnp.full(4, q, jnp.int32), src),
        T.MATCH_LEN_MAX,
    )
    ext4 = jnp.where(in_range, ext4, 0)
    lens4, keep4 = _sublens(ext4, SL)        # [SL, 4]
    t_lrep = jnp.full((SL, 4), P.LREP, jnp.int32)
    d_lrep = jnp.broadcast_to(jnp.arange(4, dtype=jnp.int32), (SL, 4))
    v_lrep = keep4 & (ext4 >= T.MATCH_LEN_MIN)[None, :] & (lens4 <= ext4)

    # matches from the Pareto table
    row_d = cand_dist[q]                     # [M]
    row_l = cand_len[q]
    row_valid = jnp.arange(M) < cand_count[q]
    lensM, keepM = _sublens(row_l, SL)       # [SL, M]
    t_m = jnp.full((SL, M), P.MATCH, jnp.int32)
    d_m = jnp.broadcast_to(row_d, (SL, M))
    v_m = (keepM & row_valid[None, :] & (lensM >= T.MATCH_LEN_MIN)
           & (lensM <= row_l[None, :]))

    ptype = jnp.concatenate([t_lit, t_srep, t_lrep.ravel(), t_m.ravel()])
    dist = jnp.concatenate([d_lit, d_srep, d_lrep.ravel(), d_m.ravel()])
    length = jnp.concatenate([l_lit, l_srep, lens4.ravel(), lensM.ravel()])
    valid = jnp.concatenate([v_lit, v_srep[None], v_lrep.ravel(), v_m.ravel()])
    return Candidates(ptype, dist, length, valid)


def rank_candidates(cands: Candidates, rank_probs, rec_ctx, rec_dists,
                    byte, match_byte, log2, prev_byte=0, lc: int = 0):
    """Amortized bit cost (cost // len) per candidate under ranking state.

    rank_probs is the chain's flat probability row (ops/tables.py), the
    snapshot the repair pass emitted."""
    def one(t, d, l):
        plan = bitplan.make_bit_plan(t, d, l, rec_ctx, rec_dists, byte,
                                     match_byte, prev_byte=prev_byte, lc=lc)
        return bitplan.plan_cost(rank_probs, plan, log2, lc=lc)

    costs = jax.vmap(one)(cands.ptype, cands.dist, cands.length)
    metric = costs // jnp.maximum(cands.length, 1)
    return jnp.where(cands.valid, metric, BIG)


def biased_topk_choice(metric, valid, k, key, bias_draws=8,
                       force_best_prob=0.125, force_best=False):
    """Reference sampling rule over the K cheapest candidates.

    Returns the index (into the candidate arrays) of the selected packet.
    """
    neg, idx = jax.lax.top_k(-metric, k)          # ascending by metric
    count = jnp.minimum(jnp.sum(valid), k)
    k_draw, k_force = jax.random.split(key)
    draws = jax.random.randint(k_draw, (bias_draws,), 0,
                               jnp.maximum(count, 1))
    choice = jnp.max(draws)
    forced = force_best | (jax.random.uniform(k_force) < force_best_prob)
    choice = jnp.where(forced, count - 1, choice)
    sel = jnp.clip(count - 1 - choice, 0, k - 1)
    return idx[sel], count > 0


def enumerate_candidates(slab, q, rec_dists, data, rank, sparse,
                         cand_dist, cand_len, cand_count,
                         sublens: int = SUBLENS) -> Candidates:
    """Candidate set at the (clipped) site, minus the incumbent packet.

    Pure enumeration: no probability reads."""
    n = data.shape[0]
    qc = jnp.clip(q, 0, n - 1)
    cur_t, cur_d, cur_l, _ = P.unpack(slab[qc])
    cands = gather_candidates(qc, rec_dists, data, rank, sparse, cand_dist,
                              cand_len, cand_count, sublens=sublens)
    same_as_cur = (
        (cands.ptype == cur_t) & (cands.dist == cur_d)
        & (cands.length == cur_l)
    )
    return cands._replace(valid=cands.valid & ~same_as_cur)


def select_mutation(slab, q, rec_dists, cands: Candidates, metric, key,
                    data, top_k=20):
    """Boundary move or biased top-K resample; returns the two mutated
    cell values (v0 at qc, v1 at qc+1) WITHOUT writing the slab.

    The walk kernel (ops/repair_walk.py) substitutes these while it
    reads the slab, which saves a [C, n] scatter per pass; apply_cells
    below is the scatter form for the XLA path.  v0/v1 reproduce the
    historical double-write semantics exactly, including the qc == n-1
    case where the second write lands on the same cell and reverts the
    mutation."""
    n = data.shape[0]
    qc = jnp.clip(q, 0, n - 1)
    cur_t, cur_d, cur_l, _ = P.unpack(slab[qc])

    k_coin, k_topk = jax.random.split(key)
    coin = jax.random.uniform(k_coin) < 0.5

    # ---- boundary moves (neighbour.c:122-146) -------------------------
    has_next = qc + 1 < n
    nxt_t, nxt_d, nxt_l, _ = P.unpack(slab[jnp.clip(qc + 1, 0, n - 1)])
    first_is_match = (cur_t == P.MATCH) | (cur_t == P.LREP)
    shrink_ok = has_next & first_is_match & (cur_l > 2)

    second_is_match = (nxt_t == P.MATCH) | (nxt_t == P.LREP)
    sec_dist_resolved = jnp.where(
        nxt_t == P.LREP, rec_dists[jnp.clip(nxt_d, 0, 3)], nxt_d
    )
    rep_start = qc - sec_dist_resolved
    grow_ok = (
        has_next
        & ((cur_t == P.LIT) | (cur_t == P.SREP))
        & second_is_match
        & (nxt_l < T.MATCH_LEN_MAX)
        & (rep_start > 0)
        & (data[qc] == data[jnp.clip(rep_start - 1, 0, n - 1)])
    )
    do_shrink = coin & shrink_ok
    do_grow = coin & ~shrink_ok & grow_ok

    # ---- top-K resample ------------------------------------------------
    sel, any_valid = biased_topk_choice(metric, cands.valid, top_k, k_topk)
    sel_t = cands.ptype[sel]
    sel_d = cands.dist[sel]
    sel_l = cands.length[sel]

    # ---- the two mutated cells -----------------------------------------
    new_q = jnp.where(
        do_shrink, P.pack(P.LIT, 0, 1),
        jnp.where(
            do_grow, P.pack(nxt_t, nxt_d, nxt_l + 1),
            jnp.where(any_valid, P.pack(sel_t, sel_d, sel_l), slab[qc]),
        ),
    )
    new_q1 = jnp.where(
        do_shrink, P.pack(cur_t, cur_d, cur_l - 1),
        slab[jnp.clip(qc + 1, 0, n - 1)],
    )
    # qc == n-1: both historical writes hit cell qc, last one wins
    v0 = jnp.where(has_next, new_q, new_q1)
    return v0, new_q1


def apply_cells(slab, q, v0, v1):
    """Scatter the two mutated cells of select_mutation into the slab."""
    n = slab.shape[0]
    qc = jnp.clip(q, 0, n - 1)
    has_next = qc + 1 < n
    slab = slab.at[qc].set(v0)
    return slab.at[jnp.clip(qc + 1, 0, n - 1)].set(
        jnp.where(has_next, v1, v0))


def propose_cells(slab, q, rec_ctx, rec_dists, rank_probs, data, rank,
                  sparse, cand_dist, cand_len, cand_count, key, log2,
                  top_k=20, sublens=SUBLENS, lc: int = 0):
    """One proposed mutation for the chain: enumerate the candidates at
    the site, rank them under the chain's snapshot probabilities, and
    pick the move.  Returns the two mutated cells (select_mutation)."""
    n = data.shape[0]
    qc = jnp.clip(q, 0, n - 1)
    cands = enumerate_candidates(slab, q, rec_dists, data, rank, sparse,
                                 cand_dist, cand_len, cand_count,
                                 sublens=sublens)
    byte = data[qc]
    mb = data[jnp.clip(qc - rec_dists[0] - 1, 0, n - 1)]
    prev = jnp.where(qc > 0, data[jnp.maximum(qc - 1, 0)], 0)
    metric = rank_candidates(cands, rank_probs, rec_ctx, rec_dists, byte,
                             mb, log2, prev_byte=prev, lc=lc)
    return select_mutation(slab, q, rec_dists, cands, metric, key, data,
                           top_k=top_k)
