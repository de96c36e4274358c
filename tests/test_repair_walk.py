"""The repair+cost walk kernel == the XLA scan, bit for bit.

The walk's source (megalania_tpu/kernels/repair_walk.h) builds twice: as
the CUDA kernel and as a host library registered for the CPU platform.
These tests run the host build, so the kernel's arithmetic, its wrapper
(ops/repair_walk.py) and the engine's dispatch are checked without a
GPU; the `gpu` test at the end repeats the comparison on the card.
"""
import ctypes

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from megalania_tpu.anneal import engine
from megalania_tpu.anneal.config import AnnealConfig
from megalania_tpu.models import packets as P
from megalania_tpu.ops import repair_scan, repair_walk, tables as T

DATA = (b"abra cadabra abra cadabra! abracadabra? "
        b"the rain in spain falls mainly on the plain. " * 3)[:192]
C = 8
NAMES = ("slab", "hi", "lo", "probs", "rec_ctx", "rec_dists", "rec_live",
         "live_count", "snap_carry")


@pytest.fixture(scope="module")
def ctx():
    cfg = AnnealConfig(chains=C, max_candidates=8, max_walk=48)
    return engine.make_context(DATA, cfg)


def _check(got, want):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


def _both(ctx, slabs, q, u, **kw):
    got = repair_walk.repair_cost_walk(
        slabs, q, u, ctx.data, ctx.cand_dist, ctx.cand_len, ctx.log2, **kw)
    want = repair_scan.repair_cost_batched(
        slabs, q, u, ctx.data, ctx.cand_dist, ctx.cand_len, ctx.log2, **kw)
    return got, want


def _mutated_slabs(ctx, rng):
    n = ctx.data.shape[0]
    base = P.literal_slab(n)
    slabs = np.broadcast_to(base, (C, n)).copy()
    cd = np.asarray(ctx.cand_dist)
    cl = np.asarray(ctx.cand_len)
    for c in range(C):
        for _ in range(6):
            i = int(rng.integers(2, n - 4))
            m = int(rng.integers(0, cd.shape[1]))
            if cl[i, m] >= 2:
                slabs[c, i] = P.pack_np(
                    P.MATCH, cd[i, m], min(int(cl[i, m]), n - i))
            slabs[c, int(rng.integers(1, n))] = P.pack_np(
                P.LREP, int(rng.integers(0, 4)), 2)
            slabs[c, int(rng.integers(1, n))] = P.pack_np(P.SREP, 0, 1)
    q = jnp.asarray(rng.integers(0, n // 2, C), jnp.int32)
    u = jnp.asarray(rng.integers(0, n, C), jnp.int32)
    return jnp.asarray(slabs), q, u


def _walk_cfg(monkeypatch, **kw):
    """An engine config on the walk kernel, run through its host build:
    the backend check that keeps kernel='cuda' off a CPU is bypassed."""
    monkeypatch.setattr(engine, "resolve_kernel", lambda cfg: cfg.kernel)
    return AnnealConfig(chains=C, max_candidates=8, max_walk=48, top_k=12,
                        kernel="cuda", **kw)


def test_walk_layout_matches_tables():
    """The walk's compiled-in probability layout is ops/tables.py's."""
    lib = repair_walk.load("cpu")
    out = (ctypes.c_int32 * 16)()
    lib.meg_walk_layout(out)
    want = [T.IS_MATCH, T.IS_REP, T.IS_REP_G0, T.IS_REP_G1, T.IS_REP_G2,
            T.IS_REP0_LONG, T.LEN, T.REP_LEN, T.DIST_SLOT, T.ALIGN,
            T.POS_CODER, T.LIT, T.LEN_LOW, T.LEN_MID, T.LEN_HIGH, 26]
    assert list(out) == want


def test_engine_walk_matches_xla(ctx, monkeypatch):
    """Whole-engine smoke: same trajectory under both kernels."""
    cfg_x = AnnealConfig(chains=C, max_candidates=8, max_walk=48,
                         top_k=12, kernel="xla")
    sx = engine.run_iters(engine.init_state(ctx, cfg_x), ctx, cfg_x, 12)
    cfg_w = _walk_cfg(monkeypatch)
    sw = engine.run_iters(engine.init_state(ctx, cfg_w), ctx, cfg_w, 12)
    assert int(sx.best_hi) == int(sw.best_hi)
    assert int(sx.best_lo) == int(sw.best_lo)
    np.testing.assert_array_equal(np.asarray(sx.best_slab),
                                  np.asarray(sw.best_slab))


def test_walk_parity_mutated(ctx, rng):
    slabs, q, u = _mutated_slabs(ctx, rng)
    _check(*_both(ctx, slabs, q, u))


def test_walk_inkernel_mutation_matches_scatter(ctx, rng):
    """In-stream substitution of the two mutated cells at q/q+1 ==
    scatter-writing them into the slab first, bit for bit — including
    q == n-1, where only the q cell exists."""
    n = ctx.data.shape[0]
    slabs, q, u = _mutated_slabs(ctx, rng)
    q = q.at[0].set(n - 1)                       # last-position edge case
    mut0 = jnp.asarray(
        P.pack_np(P.SREP, np.zeros(C, np.int64), np.ones(C, np.int64)))
    mut1 = jnp.asarray(
        P.pack_np(P.LREP, rng.integers(0, 4, C), np.full(C, 2)))

    qc = jnp.clip(q, 0, n - 1)
    has_next = qc + 1 < n
    scattered = slabs.at[jnp.arange(C), qc].set(mut0)
    scattered = scattered.at[jnp.arange(C), jnp.clip(qc + 1, 0, n - 1)].set(
        jnp.where(has_next, mut1, mut0))
    want = repair_scan.repair_cost_batched(
        scattered, q, u, ctx.data, ctx.cand_dist, ctx.cand_len, ctx.log2)
    got = repair_walk.repair_cost_walk(
        slabs, q, u, ctx.data, ctx.cand_dist, ctx.cand_len, ctx.log2,
        mut0=mut0, mut1=mut1)
    _check(got, want)


@pytest.mark.parametrize("cap", [0, 37, 64, 150, 191, 192])
def test_walk_parity_capture_positions(ctx, rng, cap):
    """The snapshot entering cap_pos — at the start, inside a dead run,
    at a live packet, at the last position, and past the end."""
    slabs, q, u = _mutated_slabs(ctx, rng)
    _check(*_both(ctx, slabs, q, u, cap_pos=jnp.int32(cap)))


def test_walk_parity_packet_site_mode(ctx, rng):
    """site_mode='packet': ordinal site selection + live count."""
    slabs, q, _ = _mutated_slabs(ctx, rng)
    u = jnp.asarray(rng.integers(0, 64, C), jnp.int32)  # ordinals
    got, want = _both(ctx, slabs, q, u, site_mode="packet")
    _check(got, want)
    assert int(np.asarray(want[7]).min()) > 0   # counts are real


def test_engine_packet_site_mode(ctx):
    """Engine smoke under the reference's uniform-over-live-packets
    site rule; output parse stays valid (cost finite, decodes)."""
    cfg = AnnealConfig(chains=C, max_candidates=8, max_walk=48,
                       top_k=12, site_mode="packet")
    s = engine.run_iters(engine.init_state(ctx, cfg), ctx, cfg, 12)
    assert int(s.best_hi) < 2**30
    assert int(s.moves_done) == 12 * C


def test_walk_parity_lrep_fallback_match(ctx, rng):
    """lrep_fallback='match' (reference-flavoured repair)."""
    slabs, q, u = _mutated_slabs(ctx, rng)
    got, want = _both(ctx, slabs, q, u, lrep_fallback="match")
    _check(got, want)
    # the variant must actually fire on this input: some repaired
    # entries become matches where litsrep would have produced literals
    base = repair_scan.repair_cost_batched(
        slabs, q, u, ctx.data, ctx.cand_dist, ctx.cand_len, ctx.log2)
    assert not np.array_equal(np.asarray(want[0]), np.asarray(base[0]))


def test_partial_recost_parity(ctx, rng):
    """Snapshot-based partial re-cost: a pass that starts from the
    snapshot captured by an earlier pass is bit-identical to a full walk
    from position 0 — walk kernel and scan, all nine outputs."""
    n = ctx.data.shape[0]
    slabs, q, u = _mutated_slabs(ctx, rng)
    # pass 1: full walk, capture the state entering position 64
    p1, w1 = _both(ctx, slabs, q, u, cap_pos=jnp.int32(64))
    _check(p1, w1)

    # pass 2: mutation sites >= capture position; snapshot start == full
    q2 = jnp.asarray(rng.integers(128, n, C), jnp.int32)
    u2 = jnp.asarray(rng.integers(64, n, C), jnp.int32)
    slab1 = p1[0]
    for fn in (repair_walk.repair_cost_walk,
               repair_scan.repair_cost_batched):
        full = fn(slab1, q2, u2, ctx.data, ctx.cand_dist, ctx.cand_len,
                  ctx.log2)
        part = fn(slab1, q2, u2, ctx.data, ctx.cand_dist, ctx.cand_len,
                  ctx.log2, start_pos=jnp.int32(64), probs_in=p1[3],
                  carry_in=p1[8])
        _check(part, full)


def test_engine_sweep_matches_random_cost_exactness(ctx):
    """The sweep schedule produces a different trajectory than 'random'
    (different site draws) but every accepted cost stays exact: re-cost
    the final best slab from scratch and compare bit for bit."""
    cfg = AnnealConfig(chains=C, max_candidates=8, max_walk=48, top_k=12,
                       site_schedule="sweep")
    s = engine.run_iters(engine.init_state(ctx, cfg), ctx, cfg, 24)
    best = jnp.broadcast_to(s.best_slab, (C, s.best_slab.shape[0]))
    n = ctx.data.shape[0]
    out = repair_scan.repair_cost_batched(
        best, jnp.full(C, n, jnp.int32), jnp.zeros(C, jnp.int32),
        ctx.data, ctx.cand_dist, ctx.cand_len, ctx.log2)
    assert int(out[1][0]) == int(s.best_hi), (int(out[1][0]),
                                              int(s.best_hi))
    assert int(out[2][0]) == int(s.best_lo)


def test_engine_sweep_deterministic(ctx):
    """Sweep schedule: same seed -> identical best."""
    cfg = AnnealConfig(chains=C, max_candidates=8, max_walk=48, top_k=12,
                       site_schedule="sweep")
    s1 = engine.run_iters(engine.init_state(ctx, cfg), ctx, cfg, 16)
    s2 = engine.run_iters(engine.init_state(ctx, cfg), ctx, cfg, 16)
    assert int(s1.best_hi) == int(s2.best_hi)
    assert int(s1.best_lo) == int(s2.best_lo)
    np.testing.assert_array_equal(np.asarray(s1.best_slab),
                                  np.asarray(s2.best_slab))


def test_walk_dead_run_parity(ctx):
    """A long match makes positions 61..129 a dead run in every chain:
    the walk skips it in one copy.  Results stay bit-identical to the
    scan, with a mutation cell, a recording site and the capture point
    all inside the dead run."""
    n = ctx.data.shape[0]
    base = np.asarray(P.literal_slab(n)).copy()
    slabs = np.broadcast_to(base, (C, n)).copy()
    # a MATCH packet passes the repair rules unchanged, so any
    # (dist, len) works for costing parity — both sides cost this slab
    start, L = 60, 70
    slabs[:, start] = P.pack_np(P.MATCH, 7, L)
    slabs = jnp.asarray(slabs)
    q = jnp.full(C, 40, jnp.int32)          # repair from before the match
    u = jnp.asarray(np.arange(85, 85 + 2 * C, 2), jnp.int32)
    mut0 = jnp.full(C, P.pack_np(P.SREP, 0, 1), jnp.uint32)
    mut1 = jnp.full(C, P.pack_np(P.LIT, 0, 1), jnp.uint32)
    got = repair_walk.repair_cost_walk(
        slabs, jnp.full(C, 90, jnp.int32), u, ctx.data, ctx.cand_dist,
        ctx.cand_len, ctx.log2, mut0=mut0, mut1=mut1,
        cap_pos=jnp.int32(95))
    scattered = slabs.at[:, 90].set(mut0).at[:, 91].set(mut1)
    want = repair_scan.repair_cost_batched(
        scattered, jnp.full(C, 90, jnp.int32), u, ctx.data,
        ctx.cand_dist, ctx.cand_len, ctx.log2, cap_pos=jnp.int32(95))
    _check(got, want)
    plain = _both(ctx, slabs, q, u)
    _check(*plain)
    assert int(np.asarray(plain[1][6])[0]) == start + L  # rec_live sane


def test_walk_parity_lc3(ctx, rng):
    """lc=3 literal contexts in the walk == the scan, bit for bit."""
    slabs, q, u = _mutated_slabs(ctx, rng)
    got, want = _both(ctx, slabs, q, u, lc=3)
    _check(got, want)
    assert np.asarray(got[3]).shape == (C, T.probs_pad(3))
    # and the costs really differ from the lc=0 model on this text
    want0 = repair_scan.repair_cost_batched(
        slabs, q, u, ctx.data, ctx.cand_dist, ctx.cand_len, ctx.log2)
    assert not np.array_equal(np.asarray(want[1]), np.asarray(want0[1]))


def test_engine_lc3_walk_matches_xla(ctx, monkeypatch):
    """Whole-engine trajectory at lc=3: walk kernel == XLA path."""
    cfg_x = AnnealConfig(chains=C, max_candidates=8, max_walk=48,
                         top_k=12, kernel="xla", lc=3)
    sx = engine.run_iters(engine.init_state(ctx, cfg_x), ctx, cfg_x, 10)
    cfg_w = _walk_cfg(monkeypatch, lc=3)
    sw = engine.run_iters(engine.init_state(ctx, cfg_w), ctx, cfg_w, 10)
    assert int(sx.best_hi) == int(sw.best_hi)
    assert int(sx.best_lo) == int(sw.best_lo)
    np.testing.assert_array_equal(np.asarray(sx.best_slab),
                                  np.asarray(sw.best_slab))


def test_kernel_choice():
    """auto picks the XLA scan off a GPU; a forced CUDA kernel on the CPU
    raises instead of running anything else."""
    assert jax.default_backend() == "cpu"
    assert engine.resolve_kernel(AnnealConfig()) == "xla"
    assert engine.resolve_kernel(AnnealConfig(kernel="xla")) == "xla"
    with pytest.raises(ValueError, match="GPU backend"):
        engine.resolve_kernel(AnnealConfig(kernel="cuda"))


def test_forced_cuda_kernel_raises_in_engine(ctx):
    cfg = AnnealConfig(chains=C, max_candidates=8, max_walk=48,
                       kernel="cuda")
    with pytest.raises(ValueError, match="GPU backend"):
        engine.init_state(ctx, cfg)


def test_sweep_tile_rule():
    """The sweep stratum width is a rule of n alone: 2048 at the 64 KiB
    default block, n/16 rounded up to a power of two within
    [256, 2048], never above n."""
    assert engine.sweep_tile(1 << 16) == 2048
    assert engine.sweep_tile(1 << 20) == 2048
    assert engine.sweep_tile(1 << 15) == 2048
    assert engine.sweep_tile(1 << 14) == 1024
    assert engine.sweep_tile(5000) == 512
    assert engine.sweep_tile(2048) == 256
    assert engine.sweep_tile(192) == 192
    assert engine.sweep_tile(1) == 1


def test_walk_wrapper_shapes(ctx):
    """The wrapper's outputs have the scan's shapes and dtypes."""
    n = ctx.data.shape[0]
    slabs = jnp.broadcast_to(jnp.asarray(P.literal_slab(n)), (3, n))
    q = jnp.zeros(3, jnp.int32)
    got, want = _both(ctx, slabs, q, q, lc=1)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
    assert got[3].shape == (3, T.probs_pad(1))


@pytest.fixture
def gpu():
    """The first device, when it is a GPU (decided here, never at
    import: the CPU test run skips)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return dev


@pytest.mark.gpu
def test_walk_on_gpu_matches_scan_on_cpu(ctx, rng, gpu):
    """The CUDA build == the scan run on the host, all nine outputs."""
    slabs, q, u = _mutated_slabs(ctx, rng)
    args = (slabs, q, u, ctx.data, ctx.cand_dist, ctx.cand_len, ctx.log2)
    with jax.default_device(gpu):
        got = repair_walk.repair_cost_walk(*args, lrep_fallback="match")
    cpu = jax.devices("cpu")[0]
    want = repair_scan.repair_cost_batched(
        *jax.device_put(args, cpu), lrep_fallback="match")
    _check(got, want)
