"""Device-mesh scale-out: blocks x chains over two mesh axes.

The reference has no parallelism (SURVEY.md §2: none exists).  The mesh
follows the algorithm (the GPUs of a host are joined all to all):

  * axis "block": independent LZMA blocks, data-parallel (no
    communication between blocks except the final ordered gather);
  * axis "chain": annealing chains of one block spread over devices
    (a per-move argmin-all-reduce of the best parse).

`sharded_step` shard_maps the single-block iteration over both axes; the
cross-device best exchange rides all_gathers on the chain axis.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as PSpec
from jax import shard_map

from ..anneal import engine
from ..anneal.config import AnnealConfig
from ..utils import fixedpoint as fp

BLOCK_AXIS = "block"
CHAIN_AXIS = "chain"


def make_mesh(n_blocks: int = 1, devices: Sequence | None = None) -> Mesh:
    """Mesh over available devices: blocks outer, chains inner.

    The block-axis size must divide both the device count (mesh shape)
    and n_blocks (even sharding of the stacked block dimension)."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    total = devs.size
    b = min(n_blocks, total)
    while total % b or n_blocks % b:
        b -= 1
    return Mesh(devs.reshape(b, total // b), (BLOCK_AXIS, CHAIN_AXIS))


def _exchange_best(best_slab, hi, lo, axis):
    """Cross-device argmin of (hi, lo) with slab broadcast.

    Exact lexicographic (hi, lo) selection — float32 keys lose the low
    bits once costs exceed 2**24 fixed-point units, which a ~100 KB
    block of entropy does (utils/fixedpoint.py docstring).
    """
    his = jax.lax.all_gather(hi, axis)
    los = jax.lax.all_gather(lo, axis)
    slabs = jax.lax.all_gather(best_slab, axis)
    i = fp.argmin(his, los)
    return slabs[i], his[i], los[i]


def _local_step(state: engine.AnnealState, ctx: engine.BlockContext,
                cfg: AnnealConfig, n_iters: int) -> engine.AnnealState:
    """n_iters iterations on the local chain shard + best exchange.

    Per move only the (hi, lo) SCALARS cross devices; the [n]-sized slab
    all_gather runs just once up front (to replicate the best across the
    shard) and then only on iterations where the global best actually
    improves (an unconditional per-move slab gather would move
    256 KiB x devices per move at n=65536).  The improvement predicate
    is replicated — every device computes it from all-gathered scalars
    against the replicated previous global best — so the conditional
    collective branches identically everywhere."""
    bs, bh, bl = _exchange_best(state.best_slab, state.best_hi,
                                state.best_lo, CHAIN_AXIS)
    state = state._replace(best_slab=bs, best_hi=bh, best_lo=bl)

    def body(carry, _):
        s, c = carry
        prev_hi, prev_lo = s.best_hi, s.best_lo      # replicated invariant
        s = engine.anneal_iteration(s, c, cfg, axis_name=CHAIN_AXIS)
        his = jax.lax.all_gather(s.best_hi, CHAIN_AXIS)   # scalars only
        los = jax.lax.all_gather(s.best_lo, CHAIN_AXIS)
        i = fp.argmin(his, los)
        changed = fp.less(his[i], los[i], prev_hi, prev_lo)

        def fetch(slab):
            slabs = jax.lax.all_gather(slab, CHAIN_AXIS)
            return slabs[i]

        bs = jax.lax.cond(changed, fetch, lambda slab: slab, s.best_slab)
        # on no-change, every device's best_* already equals the
        # previous (replicated) global best — anneal_iteration only
        # updates its local best when it beats that value
        bh = jnp.where(changed, his[i], prev_hi)
        bl = jnp.where(changed, los[i], prev_lo)
        return (s._replace(best_slab=bs, best_hi=bh, best_lo=bl), c), ()

    (state, _), _ = jax.lax.scan(body, (state, ctx), None, length=n_iters)
    return state


def sharded_step(mesh: Mesh, cfg: AnnealConfig, n_iters: int):
    """Build the pjit-able multi-block, multi-device step.

    Operands are stacked over a leading block axis:
      states: AnnealState with leading [B, ...] on every leaf
      ctxs:   BlockContext with leading [B, ...]
    Chains of each block are sharded over CHAIN_AXIS; blocks over
    BLOCK_AXIS.
    """
    chain_sharded = {"slab", "cost_hi", "cost_lo", "rank_probs", "rec_ctx",
                     "rec_dists", "rec_live", "live_count", "key",
                     "snap_carry"}

    def state_spec():
        chains = engine.ChainState(
            **{f: PSpec(BLOCK_AXIS, CHAIN_AXIS) for f in chain_sharded}
        )
        return engine.AnnealState(
            chains=chains,
            best_slab=PSpec(BLOCK_AXIS),
            best_hi=PSpec(BLOCK_AXIS),
            best_lo=PSpec(BLOCK_AXIS),
            it_in_epoch=PSpec(BLOCK_AXIS),
            epochs_done=PSpec(BLOCK_AXIS),
            moves_done=PSpec(BLOCK_AXIS),
            # sweep scalars: identical on every chain shard of a block
            # (derived from the replicated per-block skey)
            sweep_j=PSpec(BLOCK_AXIS),
            snap_pos=PSpec(BLOCK_AXIS),
            u_prev=PSpec(BLOCK_AXIS),
            skey=PSpec(BLOCK_AXIS),
        )

    ctx_spec = engine.BlockContext(
        data=PSpec(BLOCK_AXIS), rank=PSpec(BLOCK_AXIS),
        sparse=PSpec(BLOCK_AXIS), cand_dist=PSpec(BLOCK_AXIS),
        cand_len=PSpec(BLOCK_AXIS), cand_count=PSpec(BLOCK_AXIS),
        # log2 is stacked per block like the rest of the context so the
        # inner map sees uniform leading dims
        log2=PSpec(BLOCK_AXIS),
        init_slab=PSpec(BLOCK_AXIS),
    )

    def per_block(state, ctx):
        # inside shard_map: leading block dim is the local shard (size
        # B/b).  lax.map (not vmap) over it: a device runs its blocks
        # one after another, and the walk kernel is never batched.
        return jax.lax.map(
            lambda sc: _local_step(sc[0], sc[1], cfg, n_iters),
            (state, ctx))

    fn = shard_map(
        per_block, mesh=mesh,
        in_specs=(state_spec(), ctx_spec),
        out_specs=state_spec(),
        check_vma=False,
    )
    return jax.jit(fn)


def replicate_for_blocks(items):
    """Stack per-block pytrees along a new leading axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *items)
