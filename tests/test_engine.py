"""Anneal engine: end-to-end on small blocks (CPU)."""
import lzma

import numpy as np
import pytest

from megalania_tpu.anneal import engine
from megalania_tpu.anneal.config import AnnealConfig
from megalania_tpu.models import packets as P
from megalania_tpu.runtime import pyemit
from megalania_tpu.utils import fixedpoint as fp

DATA = (b"the quick brown fox jumps over the lazy dog. "
        b"the quick brown fox jumps over the lazy dog? " * 2)


@pytest.fixture(scope="module")
def cfg():
    # init="literal" preserves this module's original premise: the
    # anneal must beat the all-literals parse (the reference's start)
    return AnnealConfig(chains=8, max_candidates=8, max_walk=64, top_k=12,
                        init="literal")


@pytest.fixture(scope="module")
def annealed(cfg):
    ctx = engine.make_context(DATA, cfg)
    state = engine.init_state(ctx, cfg)
    lit_cost = fp.to_int(state.best_hi, state.best_lo)
    state = engine.run_iters(state, ctx, cfg, 60)
    return ctx, state, lit_cost


def test_engine_improves_over_literals(annealed):
    _, state, lit_cost = annealed
    best = fp.to_int(state.best_hi, state.best_lo)
    assert best < lit_cost, (best, lit_cost)


def test_best_slab_is_valid_and_cost_exact(annealed):
    _, state, _ = annealed
    slab = np.asarray(state.best_slab)
    # emitted stream must decode bit-exactly
    blob = pyemit.emit(DATA, slab)
    assert lzma.decompress(blob, format=lzma.FORMAT_ALONE) == DATA
    # engine's best cost must equal the oracle cost of the best slab
    want = pyemit.parse_cost(DATA, slab)
    got = fp.to_int(state.best_hi, state.best_lo)
    assert got == want
    # and predict the real size
    assert abs((18 + got / 16384.0) - len(blob)) < 2.5


def test_chain_costs_exact(annealed):
    """Every chain's current cost must be the exact cost of its slab."""
    _, state, _ = annealed
    ch = state.chains
    for c in range(0, np.asarray(ch.slab).shape[0], 3):
        hi, lo = int(ch.cost_hi[c]), int(ch.cost_lo[c])
        if hi == int(fp.INF_HI):
            continue  # just restarted
        want = pyemit.parse_cost(DATA, np.asarray(ch.slab[c]))
        assert fp.to_int(np.int32(hi), np.int32(lo)) == want, c


def test_deterministic(cfg):
    ctx = engine.make_context(DATA, cfg)
    s1 = engine.run_iters(engine.init_state(ctx, cfg), ctx, cfg, 10)
    s2 = engine.run_iters(engine.init_state(ctx, cfg), ctx, cfg, 10)
    assert fp.to_int(s1.best_hi, s1.best_lo) == fp.to_int(s2.best_hi, s2.best_lo)
    np.testing.assert_array_equal(np.asarray(s1.best_slab),
                                  np.asarray(s2.best_slab))


def test_proposal_parallelism():
    """P proposals per chain per pass: runs, counts moves as P x chains,
    and converges at least as well as P=1 at matched iteration count."""
    import jax.numpy as jnp
    from megalania_tpu.anneal import engine
    from megalania_tpu.anneal.config import AnnealConfig
    from megalania_tpu.utils import fixedpoint as fp

    data = (b"pack my box with five dozen liquor jugs. " * 8)[:256]
    cfg1 = AnnealConfig(chains=8, max_candidates=8, max_walk=32, top_k=12)
    cfgP = AnnealConfig(chains=8, max_candidates=8, max_walk=32, top_k=12,
                        proposals=3)
    ctx = engine.make_context(data, cfg1)
    s1 = engine.run_iters(engine.init_state(ctx, cfg1), ctx, cfg1, 24)
    sP = engine.run_iters(engine.init_state(ctx, cfgP), ctx, cfgP, 24)
    assert int(sP.moves_done) == 3 * int(s1.moves_done)
    # best-of-3 at equal iterations should not be worse
    assert fp.to_int(sP.best_hi, sP.best_lo) <= fp.to_int(
        s1.best_hi, s1.best_lo)


def test_greedy_init_beats_literals_and_anneals(cfg):
    """cfg.init='greedy' (SURVEY §7): the greedy longest-match parse
    costs less than all-literals, the anneal never regresses from it,
    and the result still decodes bit-exactly."""
    gcfg = AnnealConfig(chains=8, max_candidates=8, max_walk=64, top_k=12,
                        init="greedy")
    gctx = engine.make_context(DATA, gcfg)
    gstate = engine.init_state(gctx, gcfg)
    greedy_cost = fp.to_int(gstate.best_hi, gstate.best_lo)

    lctx = engine.make_context(DATA, cfg)
    lstate = engine.init_state(lctx, cfg)
    lit_cost = fp.to_int(lstate.best_hi, lstate.best_lo)
    assert greedy_cost < lit_cost, (greedy_cost, lit_cost)

    out = engine.run_iters(gstate, gctx, gcfg, 40)
    best = fp.to_int(out.best_hi, out.best_lo)
    assert best <= greedy_cost
    blob = pyemit.emit(DATA, np.asarray(out.best_slab))
    assert lzma.decompress(blob, format=lzma.FORMAT_ALONE) == DATA


def test_mixed_split_survives_restart():
    """At chains >= num_epochs the init race (greedy/literal chain
    split) must survive the first epoch restart: step 0 spans >= 2
    epochs, so the restart reseeds from the SPLIT init rows, not from
    the global best."""
    c = AnnealConfig(chains=8, num_epochs=4, iters_per_epoch=4,
                     max_candidates=8, max_walk=64, top_k=12,
                     init="mixed")
    ctx = engine.make_context(DATA, c)
    state = engine.init_state(ctx, c)
    # run exactly through the first restart (it_in_epoch reaches iters)
    state = engine.run_iters(state, ctx, c, 4)
    assert int(state.epochs_done) == 1
    slabs = np.asarray(state.chains.slab)
    lit = np.asarray(P.literal_slab(len(DATA)))
    greedy = np.asarray(ctx.init_slab)
    assert not np.array_equal(greedy, lit)   # data must have matches
    # g8=4 => odd chains literal, even chains greedy (engine pattern)
    for i in range(8):
        want = lit if (i * 4 % 8) >= 4 else greedy
        assert np.array_equal(slabs[i], want), f"chain {i} lost its seed"
