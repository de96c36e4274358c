"""Aux subsystems as wired into the product (SURVEY.md §5.3-5.5):
checkpoint/resume through compress_block, failures that raise, metrics,
config guards, exact fixed-point argmin, the compile-cache helper."""
import lzma
import os

import numpy as np
import pytest

import jax.numpy as jnp

from megalania_tpu import compressor
from megalania_tpu.anneal.config import AnnealConfig
from megalania_tpu.utils import fixedpoint as fp
from megalania_tpu.utils.metrics import MetricsLogger

DATA = (b"checkpointed annealing must resume bit-identically. " * 3)


@pytest.fixture(scope="module")
def cfg():
    return AnnealConfig(chains=8, max_candidates=8, max_walk=64, top_k=12)


def test_resume_bit_identical(cfg, tmp_path):
    """kill-after-k-segments + resume == uninterrupted run, bit-exact.

    The PRNG keys ride the checkpoint (utils/checkpoint.py), so the
    continuation replays the exact move sequence (SURVEY.md §5.4 /
    reference determinism property, main.c:68)."""
    moves = 8 * 40  # 40 iters at 8 chains

    straight = compressor.compress_block(
        DATA, cfg, total_moves=moves, segment_iters=10).stream

    ck = str(tmp_path / "blk.npz")
    # simulate a crash: run only the first 2 segments, checkpointing each
    with pytest.raises(KeyboardInterrupt):
        seen = {"n": 0}

        def bomb(info):
            seen["n"] += 1
            if seen["n"] == 2:
                raise KeyboardInterrupt

        compressor.compress_block(
            DATA, cfg, total_moves=moves, segment_iters=10,
            checkpoint_path=ck, checkpoint_every=1, progress=bomb)
    assert os.path.exists(ck)

    resumed = compressor.compress_block(
        DATA, cfg, total_moves=moves, segment_iters=10,
        checkpoint_path=ck, resume=True).stream
    assert resumed == straight
    assert lzma.decompress(resumed, format=lzma.FORMAT_ALONE) == DATA


def test_failing_block_raises(cfg, monkeypatch):
    """A block that fails raises out of compress: it is not retried on
    another kernel behind the caller's back."""
    calls = {"n": 0}

    def broken(*a, **k):
        calls["n"] += 1
        raise RuntimeError("injected kernel failure")

    monkeypatch.setattr(compressor, "compress_block", broken)
    with pytest.raises(RuntimeError, match="injected kernel failure"):
        compressor.compress(DATA, cfg, total_moves=8 * 8)
    assert calls["n"] == 1


def test_failing_mesh_path_raises(cfg, monkeypatch):
    """With several devices and full blocks, a mesh failure raises
    instead of silently re-running block by block."""
    import dataclasses
    import jax
    assert len(jax.devices()) > 1
    calls = {"mesh": 0, "block": 0}

    def broken_mesh(*a, **k):
        calls["mesh"] += 1
        raise RuntimeError("injected mesh failure")

    def block(*a, **k):
        calls["block"] += 1
        raise AssertionError("per-block path must not run")

    monkeypatch.setattr(compressor, "_compress_blocks_mesh", broken_mesh)
    monkeypatch.setattr(compressor, "compress_block", block)
    bcfg = dataclasses.replace(cfg, block_size=64)
    with pytest.raises(RuntimeError, match="injected mesh failure"):
        compressor.compress(DATA[:128], bcfg, total_moves=8 * 8)
    assert calls == {"mesh": 1, "block": 0}


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and nothing else
    is configured; unset, the cache is the checkout's fixed directory."""
    import jax
    from megalania_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", None)
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir is None

        monkeypatch.delenv(compile_cache.ENV)
        got = compile_cache.enable()
        assert got == compile_cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == got
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(root, ".jax_cache")
        ignored = open(os.path.join(root, ".gitignore")).read().split()
        assert ".jax_cache/" in ignored
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_metrics_jsonl(cfg, tmp_path):
    path = str(tmp_path / "m.jsonl")
    m = MetricsLogger(jsonl_path=path)
    compressor.compress_block(DATA, cfg, total_moves=8 * 8,
                              segment_iters=4, metrics=m)
    import json
    recs = [json.loads(l) for l in open(path)]
    assert recs and all("best_bytes" in r and "moves" in r for r in recs)
    assert recs[-1]["iter"] == recs[-1]["iters"]


def test_config_guards():
    # blocks beyond the packed 1 MiB cap are allowed (wide DP-only
    # pipeline, tests/test_wide.py) up to the wide limit:
    AnnealConfig(block_size=(1 << 20) + 1)
    with pytest.raises(ValueError):
        AnnealConfig(block_size=(64 << 20) + 1)  # > MAX_WIDE_BLOCK
    with pytest.raises(ValueError):
        AnnealConfig(kernel="pallas2")           # a retired kernel name
    with pytest.raises(TypeError):
        AnnealConfig(ranker="kernel")            # option removed


def test_fp_argmin_exact():
    """float32 keys collapse above 2**24; fp.argmin must not."""
    hi = jnp.asarray([1 << 10, 1 << 10, (1 << 10) + 1], jnp.int32)
    lo = jnp.asarray([7, 6, 0], jnp.int32)
    assert int(fp.argmin(hi, lo)) == 1
    # a case float32 gets wrong: hi*2**16+lo differs only in low bits
    hi = jnp.asarray([1 << 14, 1 << 14], jnp.int32)
    lo = jnp.asarray([3, 2], jnp.int32)
    f = fp.to_float(hi, lo)
    assert float(f[0]) == float(f[1])  # float key is blind here...
    assert int(fp.argmin(hi, lo)) == 1  # ...exact argmin is not


def test_checkpoint_forward_compat(cfg, tmp_path):
    """An npz written before AnnealState grew the sweep
    fields must still load (safe defaults, sweep_j=0 forces a fresh
    full-walk re-cost); one missing REQUIRED array must raise a clear
    incompatibility error, not a bare KeyError."""
    from megalania_tpu.anneal import engine
    from megalania_tpu.utils import checkpoint as ck

    ctx = engine.make_context(DATA, cfg)
    state = engine.init_state(ctx, cfg)
    path = str(tmp_path / "new.npz")
    ck.save(path, state)

    # strip the round-3 additions, as an old writer would have
    old = dict(np.load(path))
    legacy = {k: v for k, v in old.items()
              if k not in ("chains.snap_carry", "sweep_j", "snap_pos",
                           "u_prev", "skey")}
    oldpath = str(tmp_path / "old.npz")
    np.savez(oldpath, **legacy)
    loaded = ck.load(oldpath)
    assert loaded.chains.snap_carry.shape == state.chains.snap_carry.shape
    assert int(loaded.sweep_j) == 0           # forces full-walk re-cost
    # the loaded state must run
    out = engine.run_iters(loaded, ctx, cfg, 2)
    assert int(out.moves_done) > int(loaded.moves_done)

    broken = {k: v for k, v in old.items() if k != "chains.slab"}
    badpath = str(tmp_path / "bad.npz")
    np.savez(badpath, **broken)
    with pytest.raises(ValueError, match="incompatible checkpoint"):
        ck.load(badpath)


def test_resume_accounting_with_proposals(cfg, tmp_path):
    """moves_done accumulates chains*proposals per iteration; a resumed
    run must reconstruct ITERATIONS (not over-count by the proposals
    factor and stop early) and continue bit-identically."""
    import dataclasses
    pcfg = dataclasses.replace(cfg, proposals=2)
    moves = 8 * 2 * 30  # 30 iters at 8 chains x 2 proposals

    straight = compressor.compress_block(
        DATA, pcfg, total_moves=moves, segment_iters=10).stream

    ck = str(tmp_path / "blkp.npz")
    with pytest.raises(KeyboardInterrupt):
        seen = {"n": 0}

        def bomb(info):
            seen["n"] += 1
            if seen["n"] == 1:
                raise KeyboardInterrupt

        compressor.compress_block(
            DATA, pcfg, total_moves=moves, segment_iters=10,
            checkpoint_path=ck, checkpoint_every=1, progress=bomb)

    res = compressor.compress_block(
        DATA, pcfg, total_moves=moves, segment_iters=10,
        checkpoint_path=ck, resume=True)
    assert res.stream == straight
    # the resumed run must actually complete the full budget
    assert res.moves == moves


def test_checkpoint_extra_metadata(cfg, tmp_path):
    """extra.* arrays ride the same atomically-replaced npz as the state
    (mesh block ids can never go stale against the state)."""
    from megalania_tpu.anneal import engine
    from megalania_tpu.utils import checkpoint as ck_mod

    ctx = engine.make_context(DATA, cfg)
    state = engine.init_state(ctx, cfg)
    path = str(tmp_path / "meta.npz")
    ck_mod.save(path, state, extra={"block_ids": np.asarray([3, 5, 9])})
    assert list(ck_mod.load_extra(path, "block_ids")) == [3, 5, 9]
    assert ck_mod.load_extra(path, "missing_key") is None
    loaded = ck_mod.load(path)     # extra.* must not disturb state load
    assert np.array_equal(np.asarray(loaded.chains.slab),
                          np.asarray(state.chains.slab))


def test_dp_only_mode(cfg, tmp_path):
    """total_moves=0 emits the --init parse without annealing; the
    container still round-trips (multi-block and single-block)."""
    import dataclasses
    ocfg = dataclasses.replace(cfg, init="optimal", block_size=128)
    blob = compressor.compress(DATA, ocfg, total_moves=0)
    assert compressor.decompress(blob) == DATA
    one = dataclasses.replace(cfg, init="optimal")
    blob1 = compressor.compress(DATA, one, total_moves=0)
    assert compressor.decompress(blob1) == DATA
    import lzma
    assert lzma.decompress(blob1, format=lzma.FORMAT_ALONE) == DATA
