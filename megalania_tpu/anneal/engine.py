"""Chain-parallel annealing engine.

The reference anneals one chain serially: 3 steps x 200 epoch-restarts x
n moves, one full-file re-encode per move (/root/reference/src/main.c:
66-105).  Here C chains run the same Markov process in lockstep under
vmap — epochs become the chain axis — with a shared global best updated
by argmin every iteration and epoch restarts that reseed every chain
from the best parse (steps 1-2) or from all-literals (step 0), exactly
mirroring the reference schedule at matched move budget.

Everything inside `run_iters` is one jitted scan: proposal, fused
repair+cost pass, Metropolis-style acceptance (the reference's cooling
rule, main.c:86), best tracking, restarts.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..match import candidates as C_
from ..match.suffix import build_lce
from ..models import packets as P
from ..ops import repair_scan, repair_walk, tables as T
from ..utils import fixedpoint as fp
from . import moves
from .config import AnnealConfig


class BlockContext(NamedTuple):
    """Per-block read-only arrays, shared by all chains."""
    data: jnp.ndarray        # int32[n]
    rank: jnp.ndarray        # int32[n]
    sparse: jnp.ndarray      # int32[K, n]
    cand_dist: jnp.ndarray   # int32[n, M]
    cand_len: jnp.ndarray    # int32[n, M]
    cand_count: jnp.ndarray  # int32[n]
    log2: jnp.ndarray        # int32[2048]
    init_slab: jnp.ndarray   # uint32[n] initial parse (cfg.init)


def resolve_kernel(cfg: AnnealConfig) -> str:
    """The fused repair+cost pass's kernel: "cuda" (the walk kernel,
    ops/repair_walk.py) on a GPU backend, "xla" (ops/repair_scan.py)
    elsewhere.  A forced "cuda" on another backend raises."""
    backend = jax.default_backend()
    if cfg.kernel == "auto":
        return "cuda" if backend == "gpu" else "xla"
    if cfg.kernel == "cuda" and backend != "gpu":
        raise ValueError(
            f"kernel='cuda' needs a GPU backend, not {backend!r}; use "
            "kernel='xla' or 'auto'")
    return cfg.kernel


def sweep_tile(n: int) -> int:
    """Positions per stratum of the sweep schedule: the smallest power of
    two >= n/16 within [256, 2048], at most n.  Partial re-costs start
    and capture at multiples of it, so a smaller tile skips more of the
    prefix per pass and a larger one spreads sites over fewer strata."""
    t = 256
    while t < 2048 and t * 16 < n:
        t *= 2
    return max(1, min(t, n))


def effective_schedule(cfg: AnnealConfig) -> str:
    """Site schedule actually used: packet-ordinal sites have no byte
    position to sweep, so they force the "random" full-walk schedule."""
    return "random" if cfg.site_mode == "packet" else cfg.site_schedule


def _repair_cost(state_slabs, q, u, ctx: BlockContext, cfg: AnnealConfig,
                 mut0=None, mut1=None, start_pos=None, cap_pos=None,
                 probs_in=None, carry_in=None):
    """Dispatch the fused repair+cost pass to the configured kernel.

    mut0/mut1: optional per-row mutated cell values for sites q/q+1,
    which the walk kernel substitutes while it reads the slab; the XLA
    scan takes them pre-applied (mut0 is None).

    start_pos/cap_pos (tile-aligned scalars) + probs_in / carry_in:
    partial re-cost — the pass starts from the snapshot at start_pos and
    captures a new snapshot entering cap_pos (None = capture the final
    state).  Both kernels implement identical semantics, bit for bit
    (tests/test_repair_walk.py)."""
    kw = dict(site_mode=cfg.site_mode, lrep_fallback=cfg.lrep_fallback,
              start_pos=start_pos, cap_pos=cap_pos, probs_in=probs_in,
              carry_in=carry_in, lc=cfg.lc)
    if resolve_kernel(cfg) == "cuda":
        return repair_walk.repair_cost_walk(
            state_slabs, q, u, ctx.data, ctx.cand_dist, ctx.cand_len,
            ctx.log2, mut0=mut0, mut1=mut1, **kw)
    assert mut0 is None
    return repair_scan.repair_cost_batched(
        state_slabs, q, u, ctx.data, ctx.cand_dist, ctx.cand_len,
        ctx.log2, **kw)


class ChainState(NamedTuple):
    slab: jnp.ndarray        # uint32[C, n]
    cost_hi: jnp.ndarray     # int32[C]
    cost_lo: jnp.ndarray     # int32[C]
    rank_probs: jnp.ndarray  # int32[C, probs_pad(lc)] flat rows: the
    #   snapshot probabilities from the last pass — under the sweep
    #   schedule the state at the snapshot position (causally exact for
    #   the current slab prefix), under "random" the final probs
    rec_ctx: jnp.ndarray     # int32[C]
    rec_dists: jnp.ndarray   # int32[C, 4]
    rec_live: jnp.ndarray    # int32[C]
    live_count: jnp.ndarray  # int32[C] live packets after the last pass
    key: jnp.ndarray         # PRNG keys [C]
    snap_carry: jnp.ndarray  # int32[C, 16] scalar-carry snapshot
    #   (repair_scan.CARRY16 layout), companion to rank_probs


class AnnealState(NamedTuple):
    chains: ChainState
    best_slab: jnp.ndarray   # uint32[n]
    best_hi: jnp.ndarray     # int32
    best_lo: jnp.ndarray     # int32
    it_in_epoch: jnp.ndarray  # int32 scalar (shared cooling clock)
    epochs_done: jnp.ndarray  # int32 scalar
    moves_done: jnp.ndarray  # int32 scalar (accepted+rejected, all chains)
    # sweep-schedule scalars (shared by all chains of the block)
    sweep_j: jnp.ndarray     # int32: stratum index; 0 = fresh full walk
    snap_pos: jnp.ndarray    # int32: position of the held snapshot
    u_prev: jnp.ndarray      # int32: last shared recording site
    skey: jnp.ndarray        # PRNG key for shared (per-block) draws


def make_context(data: bytes, cfg: AnnealConfig) -> BlockContext:
    """Host-side block preprocessing: LCE index + candidate table."""
    arr = np.frombuffer(bytes(data), np.uint8)
    idx = build_lce(arr)
    tab = C_.build_candidates(arr, cfg.max_candidates, cfg.max_walk, idx)
    if cfg.init in ("optimal", "mixed_opt"):
        # the DP is host-side: seed_slab builds its own (far wider)
        # Pareto table than the anneal's per-position one above
        from ..match import optparse
        init_slab, _ = optparse.seed_slab(arr, cfg, index=idx)
    elif cfg.init in ("greedy", "mixed"):
        init_slab = C_.greedy_slab(arr, tab)
    else:
        init_slab = np.asarray(P.literal_slab(len(arr)))
    return BlockContext(
        data=jnp.asarray(arr.astype(np.int32)),
        rank=jnp.asarray(idx.rank),
        sparse=jnp.asarray(idx.sparse),
        cand_dist=jnp.asarray(tab.dist),
        cand_len=jnp.asarray(tab.length),
        cand_count=jnp.asarray(tab.count),
        log2=jnp.asarray(T.LOG2_TABLE_I32),
        init_slab=jnp.asarray(init_slab),
    )


def init_state(ctx: BlockContext, cfg: AnnealConfig) -> AnnealState:
    """Fresh chains on the all-literal parse, costed once."""
    n = ctx.data.shape[0]
    C = cfg.chains
    slab0 = jnp.broadcast_to(ctx.init_slab, (C, n))
    if cfg.init in ("mixed", "mixed_opt"):
        # a cfg.mixed_greedy_frac share of chains start from the greedy
        # parse, the rest from all-literals: the first epoch's
        # best-exchange keeps whichever start suits the data.  The
        # period-8 pattern spreads both kinds across contiguous chain
        # shards (mesh sharding slices chains in order).
        lit = jnp.asarray(P.literal_slab(n))
        g8 = max(0, min(8, round(cfg.mixed_greedy_frac * 8)))
        # (i*g8 % 8) >= g8 interleaves the two kinds with period <= 8
        # and reduces to the historical odd-chains-literal pattern at
        # the 0.5 default (bit-compatible with the r3 benchmarks)
        use_lit = ((jnp.arange(C) * g8 % 8) >= g8)[:, None]
        slab0 = jnp.where(use_lit, lit, slab0)
    all_keys = jax.random.split(jax.random.PRNGKey(cfg.seed), C + 1)
    keys, skey = all_keys[:C], all_keys[C]
    ks = jax.vmap(lambda k: jax.random.split(k, 2))(keys)
    keys_out, k_u = ks[:, 0], ks[:, 1]
    u = jax.vmap(lambda k: jax.random.randint(k, (), 0, n))(k_u)
    slabs, hi, lo, probs, rctx, rdists, rlive, count, snapc = _repair_cost(
        slab0, jnp.full(C, n, jnp.int32), u, ctx, cfg
    )
    chains = ChainState(
        slab=slabs, cost_hi=hi, cost_lo=lo, rank_probs=probs,
        rec_ctx=rctx, rec_dists=rdists, rec_live=rlive, live_count=count,
        key=keys_out, snap_carry=snapc,
    )
    return AnnealState(
        chains=chains,
        best_slab=slabs[0],
        best_hi=hi[0],
        best_lo=lo[0],
        it_in_epoch=jnp.int32(0),
        epochs_done=jnp.int32(0),
        moves_done=jnp.int32(0),
        sweep_j=jnp.int32(0),        # first iteration = fresh full walk
        snap_pos=jnp.int32(0),
        u_prev=jnp.int32(0),
        skey=skey,
    )


def _propose(slabs, q, rec_ctx, rec_dists, rank_probs, keys,
             ctx: BlockContext, cfg: AnnealConfig):
    """One proposed mutation per row (rows = chains, or chains x
    proposals).

    Returns (slab_for_pass, mut0, mut1): for the walk kernel the slab is
    returned unmutated plus the two mutated cells it substitutes while
    reading; for the XLA scan the cells are scattered here and mut0/mut1
    are None."""
    v0, v1 = jax.vmap(
        functools.partial(moves.propose_cells, top_k=cfg.top_k,
                          sublens=cfg.sublens, lc=cfg.lc),
        in_axes=(0, 0, 0, 0, 0, None, None, None, None, None, None, 0,
                 None),
    )(slabs, q, rec_ctx, rec_dists, rank_probs, ctx.data, ctx.rank,
      ctx.sparse, ctx.cand_dist, ctx.cand_len, ctx.cand_count, keys,
      ctx.log2)
    if resolve_kernel(cfg) == "cuda":
        return slabs, v0, v1
    return jax.vmap(moves.apply_cells)(slabs, q, v0, v1), None, None


def _chains_iter(state: AnnealState, ctx: BlockContext, step,
                 cfg: AnnealConfig, axis_name=None):
    """One lockstep move for all C chains (chain-batched, single scan).

    With cfg.proposals = P > 1, each chain evaluates P independent
    proposals in the same fused pass (they ride the chain axis —
    SURVEY §2's proposal parallelism; the reference costs exactly one,
    main.c:78-102) and keeps the exact-best of the P before the
    acceptance rule.  Each costed proposal is one reference move.

    Under the sweep schedule the pass is a PARTIAL re-cost: it starts
    from the snapshot captured by the previous pass (always at/below
    every chain's mutation site, so the cost stays exact) and records /
    captures at a shared, tile-stratified low-to-high site.

    Returns (ChainState, skey_next, stratum_base, cap_pos)."""
    chains = state.chains
    n = ctx.data.shape[0]
    Cn = chains.slab.shape[0]
    Pn = cfg.proposals
    sched = effective_schedule(cfg)
    ks = jax.vmap(lambda k: jax.random.split(k, 4))(chains.key)
    key_next, k_prop, k_u, k_acc = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]
    sk = jax.random.split(state.skey, 2)
    skey_next, k_su = sk[0], sk[1]

    if sched == "sweep":
        tile = sweep_tile(n)
        j = state.sweep_j                # pass counter within the sweep
        fresh_sweep = j == 0
        # start at the held snapshot (fresh init state at sweep start)
        start_pos = jnp.where(fresh_sweep, 0, state.snap_pos)
        stratum = jnp.minimum((j // cfg.sweep_repeats) * tile, n - 1)
        width = jnp.maximum(jnp.minimum(tile, n - stratum), 1)
        u_min = stratum                   # lower bound for the capture
        probs_c = jnp.where(fresh_sweep, jnp.int32(T.PROB_INIT),
                            chains.rank_probs)
        carry_c = jnp.where(fresh_sweep, jnp.int32(0), chains.snap_carry)
    else:
        start_pos = None                 # full walk
        u_min = jnp.int32(0)
        probs_c = carry_c = None
        carry16 = jnp.zeros((Cn, 16), jnp.int32)

    base_carry = carry_c if carry_c is not None else carry16
    fresh = chains.rec_live >= n         # recorded site ran off the end
    # a fresh chain mutates at the snapshot's live_pos (carry slot 5 —
    # repair_scan.CARRY16), not the tile-aligned start_pos: the snapshot
    # boundary can fall mid-packet, and a dead-cell site would be
    # silently skipped by the walk (a wasted move)
    q = jnp.where(fresh, base_carry[:, 5], chains.rec_live)
    rec_ctx = jnp.where(fresh, base_carry[:, 0], chains.rec_ctx)
    rec_dists = jnp.where(fresh[:, None], base_carry[:, 1:5],
                          chains.rec_dists)

    if sched == "sweep":
        # capture at the highest tile boundary valid for EVERY chain:
        # <= every mutation site q this pass (so the snapshot holds for
        # accepted and rejected slabs alike) and <= every chain's
        # recording site u (the next pass mutates at rec_live(u) >= u).
        # Under shard_map (axis_name set) "every chain" means every
        # chain of the BLOCK, not the local shard — the pmin keeps the
        # snapshot position (and with it the ranking state) identical
        # to the single-device trajectory, so mesh sharding never
        # changes the compressed bytes (tests/test_parallel.py).
        qmin = jnp.min(q)
        if axis_name is not None:
            qmin = jax.lax.pmin(qmin, axis_name)
        cap_pos = jnp.minimum(qmin, u_min) // tile * tile
        cap_pos = jnp.maximum(cap_pos, start_pos)
    else:
        cap_pos = None                   # capture the final state

    if Pn > 1:
        def rep(x):
            return jnp.repeat(x, Pn, axis=0)
        k_prop = jax.vmap(lambda k: jax.random.split(k, Pn))(k_prop)
        k_prop = k_prop.reshape((Cn * Pn,) + k_prop.shape[2:])
        k_u = jax.vmap(lambda k: jax.random.split(k, Pn))(k_u)
        k_u = k_u.reshape((Cn * Pn,) + k_u.shape[2:])
        slab_in, q_in, rctx_in, rdists_in, probs_in, lc_in = (
            rep(chains.slab), rep(q), rep(rec_ctx), rep(rec_dists),
            rep(chains.rank_probs), rep(chains.live_count))
        probs_snap = None if probs_c is None else rep(probs_c)
        carry_snap = None if carry_c is None else rep(carry_c)
    else:
        slab_in, q_in, rctx_in, rdists_in, probs_in, lc_in = (
            chains.slab, q, rec_ctx, rec_dists, chains.rank_probs,
            chains.live_count)
        probs_snap, carry_snap = probs_c, carry_c

    slab_prop, mut0, mut1 = _propose(slab_in, q_in, rctx_in, rdists_in,
                                     probs_in, k_prop, ctx, cfg)
    if sched == "sweep":
        # every row draws its OWN site inside the shared stratum: the
        # tile-skip only needs the sites' tile to be known, and
        # independent sites keep the chains decorrelated (a shared site
        # measurably cost ~1% ratio at matched budget)
        u = stratum + jax.vmap(
            lambda k: jax.random.randint(k, (), 0, width))(k_u)
    elif cfg.site_mode == "packet":
        hi_u = jnp.maximum(lc_in, 1)
        u = jax.vmap(lambda k, h: jax.random.randint(k, (), 0, h))(
            k_u, hi_u)
    else:
        u = jax.vmap(lambda k: jax.random.randint(k, (), 0, n))(k_u)
    (new_slab, hi, lo, probs, rctx, rdists, rlive, count,
     snapc) = _repair_cost(
        slab_prop, q_in, u, ctx, cfg, mut0=mut0, mut1=mut1,
        start_pos=start_pos, cap_pos=cap_pos,
        probs_in=probs_snap, carry_in=carry_snap,
    )

    if Pn > 1:
        # exact lexicographic best-of-P per chain
        hi2 = hi.reshape(Cn, Pn)
        lo2 = lo.reshape(Cn, Pn)
        mh = jnp.min(hi2, axis=1, keepdims=True)
        ml = jnp.where(hi2 == mh, lo2, jnp.int32(2**31 - 1))
        w = jnp.argmin(ml, axis=1)

        def sel(x):
            return x.reshape(Cn, Pn, *x.shape[1:])[jnp.arange(Cn), w]
        new_slab, hi, lo, probs, rctx, rdists, rlive, count, snapc = (
            sel(new_slab), sel(hi), sel(lo), sel(probs), sel(rctx),
            sel(rdists), sel(rlive), sel(count), sel(snapc))

    # acceptance: first / better / cooled transition (main.c:86).
    # accept="greedy" zeroes the exploratory transition — the polish
    # mode for optimum-parse seeds (cfg.accept rationale).
    iters = jnp.float32(cfg.iters(n))
    i_f = jnp.float32(state.it_in_epoch)
    p_trans = jnp.sqrt(iters) / (
        i_f * i_f + 1.0 + jnp.float32(step) * iters * 0.5
    )
    if cfg.accept == "greedy":
        p_trans = jnp.float32(0.0)
    trans = jax.vmap(jax.random.uniform)(k_acc) < p_trans
    if cfg.accept == "mixed":
        # acceptance race: even GLOBAL chain ids keep the cooled
        # transition, odd ids anneal greedily (global ids so mesh
        # sharding reproduces the single-device trajectory)
        gid = jnp.arange(Cn)
        if axis_name is not None:
            gid = gid + jax.lax.axis_index(axis_name) * Cn
        trans = trans & (gid % 2 == 0)
    first = chains.cost_hi == fp.INF_HI
    better = fp.less(hi, lo, chains.cost_hi, chains.cost_lo)
    accept = first | better | trans

    slab_cur = jnp.where(accept[:, None], new_slab, chains.slab)
    cost_hi = jnp.where(accept, hi, chains.cost_hi)
    cost_lo = jnp.where(accept, lo, chains.cost_lo)
    new_chains = ChainState(
        slab=slab_cur, cost_hi=cost_hi, cost_lo=cost_lo, rank_probs=probs,
        rec_ctx=rctx, rec_dists=rdists, rec_live=rlive, live_count=count,
        key=key_next, snap_carry=snapc,
    )
    cap_out = cap_pos if cap_pos is not None else jnp.int32(0)
    u_out = u_min                        # stratum base (diagnostics)
    return new_chains, skey_next, u_out, cap_out


def anneal_iteration(state: AnnealState, ctx: BlockContext,
                     cfg: AnnealConfig, axis_name=None) -> AnnealState:
    """One lockstep move across all chains + best/restart bookkeeping.

    axis_name: shard_map chain axis when the block's chains are split
    over devices (parallel/mesh.py) — used for the global sweep-snapshot
    pmin and for global move accounting; None on a single device."""
    n = ctx.data.shape[0]
    iters = cfg.iters(n)
    sched = effective_schedule(cfg)
    # serial epochs folded onto the chain axis.  With an init race
    # (mixed/mixed_opt) step 0 must span >= 2 epochs: at chains >=
    # num_epochs the plain fold gives epochs_per_step = 1, so the very
    # first restart would already reseed every chain from the global
    # best and the losing-start trajectories (the per-file insurance
    # the race exists for) would die after a single epoch.
    min_eps = 2 if cfg.init in ("mixed", "mixed_opt") else 1
    epochs_per_step = max(min_eps, -(-cfg.num_epochs // cfg.chains))
    step = jnp.minimum(state.epochs_done // epochs_per_step,
                       cfg.num_steps - 1)

    chains, skey_next, u_base, cap_pos = _chains_iter(state, ctx, step,
                                                      cfg, axis_name)

    # global best (reference keeps one best slab, main.c:89-92)
    b = fp.argmin(chains.cost_hi, chains.cost_lo)
    cand_hi = chains.cost_hi[b]
    cand_lo = chains.cost_lo[b]
    improved = fp.less(cand_hi, cand_lo, state.best_hi, state.best_lo)
    best_slab = jnp.where(improved, chains.slab[b], state.best_slab)
    best_hi = jnp.where(improved, cand_hi, state.best_hi)
    best_lo = jnp.where(improved, cand_lo, state.best_lo)

    # epoch restart (main.c:70-77): step 0 from the initial parse
    # (cfg.init: greedy or the reference's literals), else from best
    it = state.it_in_epoch + 1
    restart = it >= iters
    lit = ctx.init_slab
    # next step after this epoch increments epochs_done
    next_step = jnp.minimum((state.epochs_done + 1) // epochs_per_step,
                            cfg.num_steps - 1)
    Cn = chains.slab.shape[0]
    if cfg.init in ("mixed", "mixed_opt"):
        # keep the greedy/literal chain split across step-0 restarts:
        # without this, the first restart reseeds EVERY chain from the
        # greedy init_slab and the literal-annealing trajectories (the
        # ones that win on text) die after one epoch.  Chain identity
        # must be GLOBAL under shard_map or the mesh pattern would
        # diverge from the single-device one.
        g8 = max(0, min(8, round(cfg.mixed_greedy_frac * 8)))
        gid = jnp.arange(Cn)
        if axis_name is not None:
            gid = gid + jax.lax.axis_index(axis_name) * Cn
        use_lit = ((gid * g8 % 8) >= g8)[:, None]
        init_rows = jnp.where(use_lit, jnp.asarray(P.literal_slab(n)), lit)
    else:
        init_rows = jnp.broadcast_to(lit, chains.slab.shape)
    reseed = jnp.where(next_step == 0, init_rows,
                       jnp.broadcast_to(best_slab, chains.slab.shape))
    chains = chains._replace(
        slab=jnp.where(restart, reseed, chains.slab),
        cost_hi=jnp.where(restart, jnp.full(Cn, fp.INF_HI), chains.cost_hi),
        cost_lo=jnp.where(restart, jnp.zeros(Cn, jnp.int32), chains.cost_lo),
        rec_ctx=jnp.where(restart, jnp.zeros(Cn, jnp.int32), chains.rec_ctx),
        rec_dists=jnp.where(restart, jnp.zeros((Cn, 4), jnp.int32),
                            chains.rec_dists),
        rec_live=jnp.where(restart, jnp.zeros(Cn, jnp.int32),
                           chains.rec_live),
    )
    # sweep bookkeeping: advance the stratum; a wrap or an epoch restart
    # resets to the fresh full-walk stratum 0 (the reseeded slab
    # invalidates the snapshot)
    if sched == "sweep":
        tile = sweep_tile(n)
        n_tiles = -(-n // tile)
        sweep_len = n_tiles * cfg.sweep_repeats
        j_next = state.sweep_j + 1
        j_next = jnp.where((j_next >= sweep_len) | restart, 0, j_next)
    else:
        j_next = jnp.int32(0)
    return AnnealState(
        chains=chains,
        best_slab=best_slab,
        best_hi=best_hi,
        best_lo=best_lo,
        it_in_epoch=jnp.where(restart, 0, it),
        epochs_done=state.epochs_done + jnp.where(restart, 1, 0),
        # count the BLOCK's moves, not the local shard's: under the mesh
        # each chain shard holds Cn = C/axis_size rows, and moves_done
        # drives resume accounting (compressor) and the progress metric
        moves_done=state.moves_done + Cn * cfg.proposals * (
            1 if axis_name is None else jax.lax.axis_size(axis_name)),
        sweep_j=j_next,
        snap_pos=cap_pos,
        u_prev=u_base,
        skey=skey_next,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "n_iters"))
def run_iters(state: AnnealState, ctx: BlockContext, cfg: AnnealConfig,
              n_iters: int) -> AnnealState:
    """n_iters lockstep iterations as one compiled scan.

    The block context rides the scan carry (unchanged each step), as
    repair_scan.repair_cost_batched does with its tables.
    """
    def body(carry, _):
        s, c = carry
        return (anneal_iteration(s, c, cfg), c), ()

    (state, _), _ = jax.lax.scan(body, (state, ctx), None, length=n_iters)
    return state


def best_cost_bytes(state: AnnealState) -> float:
    """Predicted output size in bytes (header 13 + flush 5 + entropy)."""
    perp = fp.to_int(state.best_hi, state.best_lo)
    return 18 + perp / 16384.0
