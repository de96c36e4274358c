#!/usr/bin/env python3
"""Smoke test of the compressor on an NVIDIA GPU: the quickest proof that
the system still starts on the card and gives the right bytes.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the two mesh paths only

One-GPU phases, in one process:
  build   the CUDA walk kernel (nvcc, kernels/Makefile) and the native
          seed and emitter libraries; their fallbacks are refused.
  64k     compressor.compress on one 64 KiB block at the CLI defaults
          (128 chains, optimal seed, lc=0, sweep, cooled), 16 + 64
          anneal iterations; decoded with Python's lzma (FORMAT_ALONE),
          and the engine's predicted size must equal the emitted size
          within 2.5 B.
  step    the compiled anneal step at (n=65536, C=128): compile seconds,
          memory_analysis(), seconds per iteration, moves/s, the walk
          kernel's and the proposal's share of an iteration.
  1mib    compressor.compress on a 1 MiB input, DP-only (moves=0): host
          Viterbi seed plus device emission, same decode and size checks.
  parity  the walk kernel on the GPU against repair_scan on the CPU
          device, all nine outputs at zero tolerance, n=65536, C=128,
          lc=0 and lc=3, mutated slabs and a partial re-cost; then a
          16-iteration engine trajectory, kernel on the GPU vs XLA on the
          CPU (C=32).
Four-GPU phase: 4 x 64 KiB through compressor.compress across cards
(block axis 4) against use_mesh=False on one card, and one block's chains
sharded over the four cards against the single-device trajectory.

Inputs come from tools/corpus.  Any failed check exits non-zero; without
a GPU it exits non-zero before any phase.  The last line of stdout is
{"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import lzma
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N64K = 1 << 16
CHAINS = 128
WARM, TIMED = 16, 64          # anneal iterations: warm-up, timed
SEG = 16                      # iterations per compiled step call


def log(msg: str) -> None:
    print(msg, flush=True)


def corpus(name: str) -> bytes:
    with open(os.path.join(HERE, "tools", "corpus", name), "rb") as f:
        return f.read()


def input_64k():
    data = (corpus("survey.md") + corpus("pallas.md"))[:N64K]
    return "tools/corpus/survey.md+pallas.md[:65536]", data


def input_1mib():
    text = corpus("survey.md") + corpus("pallas.md") + corpus("engine.py")
    data = (text + corpus("libc.so"))[:1 << 20]
    return ("tools/corpus/survey.md+pallas.md+engine.py+libc.so"
            "[:1048576]"), data


def xz_size(data: bytes):
    if shutil.which("xz") is None:
        return "not measured (no xz binary)"
    out = subprocess.run(["xz", "--format=lzma", "-9e", "-c"], input=data,
                         capture_output=True, check=True)
    return len(out.stdout)


def decisions(data: bytes, slab) -> int:
    """Adaptive binary decisions the range coder codes for this parse."""
    import jax.numpy as jnp
    import numpy as np
    from megalania_tpu.ops import emit_plan

    d = jnp.asarray(np.frombuffer(data, np.uint8).astype(np.int32))
    active = emit_plan.emit_plan_jit(jnp.asarray(slab), d)[2]
    return int(jnp.sum(active))


def check_stream(label: str, data: bytes, blob: bytes, predicted: float,
                 slab):
    """lzma round trip, and predicted size vs emitted size.  The cost
    model's log2 table truncates each decision's cost by less than
    1/2048 bit, so the emitted stream may exceed the prediction by that
    much per decision (1/16384 B) on top of the coder's 2.5 B slack; it
    never falls below it."""
    if lzma.decompress(blob, format=lzma.FORMAT_ALONE) != data:
        raise AssertionError(f"{label}: lzma round trip differs")
    k = decisions(data, slab)
    gap = len(blob) - predicted
    bound = 2.5 + k / 16384.0
    log(f"[{label}] bytes in {len(data)}  out {len(blob)}  predicted "
        f"{predicted:.2f}  (out - predicted {gap:.2f} B, bound {bound:.2f} "
        f"B for {k} decisions)  xz -9e {xz_size(data)}  lzma round trip ok")
    if not -2.5 <= gap <= bound:
        raise AssertionError(f"{label}: predicted {predicted:.2f} B vs "
                             f"emitted {len(blob)} B")


class Spy:
    """Records the arguments and results of a compressor internal during
    one call of an entry point (the smoke test checks values compress()
    keeps to itself: block results, the emitted parse, the context)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.seen = []
        self.args = []
        self.seconds = []

    def __enter__(self):
        def wrapper(*a, **k):
            t = time.perf_counter()
            out = self.real(*a, **k)
            self.seconds.append(time.perf_counter() - t)
            self.seen.append(out)
            self.args.append(a)
            return out
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def timed(fn, *args):
    import jax
    t = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t


def phase_build():
    import jax
    from megalania_tpu.match import optparse_native
    from megalania_tpu.ops import repair_walk, tables as T
    from megalania_tpu.runtime import emit as emit_mod

    t = time.perf_counter()
    lib = repair_walk.load("gpu")
    t_cuda = time.perf_counter() - t
    t = time.perf_counter()
    if not (optparse_native.available() and emit_mod.native_available()):
        raise AssertionError("native seed/emitter libraries did not load")
    t_native = time.perf_counter() - t
    per_sm = lib.meg_walk_blocks_per_sm(T.probs_pad(0))
    sms = jax.devices()[0].core_count
    log(f"[build] CUDA walk kernel built+loaded {t_cuda:.3f} s; native "
        f"seed (libmeg_opt) and emitter (libmeg_emit) loaded "
        f"{t_native:.3f} s")
    log(f"[build] walk occupancy: {per_sm} resident chains (warps) per SM "
        f"at lc=0, {sms} SMs; {CHAINS} chains fill "
        f"{min(CHAINS, sms)}/{sms} SMs")


def phase_64k(cfg):
    from megalania_tpu import compressor
    from megalania_tpu.anneal import engine
    from megalania_tpu.runtime import emit as emit_mod

    name, data = input_64k()
    log(f"[64k] input {name}")
    moves = cfg.chains * (WARM + TIMED)
    t = time.perf_counter()
    with Spy(compressor, "compress_block") as blocks, \
            Spy(engine, "make_context") as ctxs, \
            Spy(emit_mod, "emit") as emits:
        blob = compressor.compress(data, cfg, total_moves=moves)
    dt = time.perf_counter() - t
    res = blocks.seen[0]
    log(f"[64k] compressor.compress {dt:.3f} s end to end (set-up, "
        f"compile and {WARM + TIMED} iterations), kernel={res.kernel}, "
        f"moves {res.moves}; of it make_context (host index, candidates, "
        f"seed) {ctxs.seconds[0]:.3f} s, emit {emits.seconds[0]:.3f} s")
    if res.kernel != "cuda":
        raise AssertionError(f"expected the CUDA walk, ran {res.kernel}")
    check_stream("64k", data, blob, res.predicted_bytes, emits.args[0][1])
    return data, ctxs.seen[0]


def phase_step(cfg, ctx):
    import jax
    from megalania_tpu.anneal import engine
    from megalania_tpu.ops import repair_walk

    state0 = engine.init_state(ctx, cfg)
    t = time.perf_counter()
    compiled = engine.run_iters.lower(state0, ctx, cfg=cfg,
                                      n_iters=SEG).compile()
    log(f"[step] compile run_iters(n_iters={SEG}) "
        f"{time.perf_counter() - t:.3f} s")
    log(f"[step] memory_analysis: {compiled.memory_analysis()}")
    state, t_warm = timed(compiled, state0, ctx)
    assert WARM == SEG
    t_run = 0.0
    for _ in range(TIMED // SEG):
        state, dt = timed(compiled, state, ctx)
        t_run += dt
    per_iter = t_run / TIMED
    log(f"[step] n={ctx.data.shape[0]} C={cfg.chains}: warm-up {WARM} iterations "
        f"{t_warm:.3f} s; timed {TIMED} iterations {t_run:.3f} s: "
        f"{per_iter * 1e3:.3f} ms/iteration, "
        f"{cfg.chains * TIMED / t_run:.1f} moves/s")

    ch = state.chains
    n = ctx.data.shape[0]
    walk = jax.jit(lambda s, q, u: repair_walk.repair_cost_walk(
        s, q, u, ctx.data, ctx.cand_dist, ctx.cand_len, ctx.log2,
        lrep_fallback=cfg.lrep_fallback))
    q = jax.numpy.zeros(cfg.chains, jax.numpy.int32)
    u = jax.numpy.full(cfg.chains, n // 2, jax.numpy.int32)
    timed(walk, ch.slab, q, u)
    t_walk = min(timed(walk, ch.slab, q, u)[1] for _ in range(5))
    prop = jax.jit(lambda st: engine._propose(
        st.chains.slab, st.chains.rec_live, st.chains.rec_ctx,
        st.chains.rec_dists, st.chains.rank_probs, st.chains.key, ctx,
        cfg))
    timed(prop, state)
    t_prop = min(timed(prop, state)[1] for _ in range(5))
    log(f"[step] walk kernel, full walk from 0: {t_walk * 1e3:.3f} ms "
        f"({t_walk / per_iter:.1%} of an iteration, whose walks are "
        f"partial); proposal {t_prop * 1e3:.3f} ms "
        f"({t_prop / per_iter:.1%} of an iteration)")


def phase_1mib():
    import jax.numpy as jnp
    import numpy as np
    from megalania_tpu import compressor
    from megalania_tpu.anneal.config import AnnealConfig
    from megalania_tpu.ops import repair_walk, tables as T
    from megalania_tpu.runtime import emit as emit_mod

    name, data = input_1mib()
    log(f"[1mib] input {name}")
    cfg = AnnealConfig(chains=CHAINS, block_size=1 << 20)
    t = time.perf_counter()
    with Spy(emit_mod, "emit") as emits:
        blob = compressor.compress(data, cfg, total_moves=0)
    log(f"[1mib] compressor.compress (moves=0) "
        f"{time.perf_counter() - t:.3f} s end to end; of it emit "
        f"{emits.seconds[0]:.3f} s, the rest is the host seed")
    slab = jnp.asarray(emits.args[0][1])[None]
    n = len(data)
    arr = jnp.asarray(np.frombuffer(data, np.uint8).astype(np.int32))
    none = jnp.zeros((n, 1), jnp.int32)
    out = repair_walk.repair_cost_walk(
        slab, jnp.full(1, n, jnp.int32), jnp.zeros(1, jnp.int32), arr,
        none, none, jnp.asarray(T.LOG2_TABLE_I32))
    hi, lo = int(out[1][0]), int(out[2][0])
    check_stream("1mib", data, blob, 18 + (hi * 65536 + lo) / 16384.0,
                 slab[0])


def _mutate(rng, slab, cand_dist, cand_len, rows):
    """rows copies of slab, each with matches, long and short reps
    written at random sites (the test suite's mutation recipe)."""
    import numpy as np
    from megalania_tpu.models import packets as P

    n = slab.shape[0]
    out = np.broadcast_to(slab, (rows, n)).copy()
    k = 48
    r = np.repeat(np.arange(rows), k)
    i = rng.integers(2, n - 4, rows * k)
    m = rng.integers(0, cand_dist.shape[1], rows * k)
    ok = cand_len[i, m] >= 2
    out[r[ok], i[ok]] = P.pack_np(
        P.MATCH, cand_dist[i[ok], m[ok]],
        np.minimum(cand_len[i[ok], m[ok]], n - i[ok]))
    out[r, rng.integers(1, n, rows * k)] = P.pack_np(
        P.LREP, rng.integers(0, 4, rows * k), np.full(rows * k, 2))
    out[r, rng.integers(1, n, rows * k)] = P.pack_np(
        P.SREP, np.zeros(rows * k, np.int64), np.ones(rows * k, np.int64))
    return out


def _same(label, got, want):
    import numpy as np
    names = ("slab", "hi", "lo", "probs", "rec_ctx", "rec_dists",
             "rec_live", "live_count", "snap_carry")
    for nm, g, w in zip(names, got, want):
        if not np.array_equal(np.asarray(g), np.asarray(w)):
            raise AssertionError(f"{label}: output {nm} differs")


def phase_parity(cfg, ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from megalania_tpu.anneal import engine
    from megalania_tpu.models import packets as P
    from megalania_tpu.ops import repair_scan, repair_walk

    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(cfg.seed)
    n = ctx.data.shape[0]
    C = CHAINS
    tabs = (ctx.data, ctx.cand_dist, ctx.cand_len, ctx.log2)
    tabs_cpu = jax.device_put(tabs, cpu)
    cd, cl = np.asarray(ctx.cand_dist), np.asarray(ctx.cand_len)
    scan = jax.jit(repair_scan.repair_cost_batched,
                   static_argnames=("lc", "lrep_fallback"))
    cap1, start2, cap2 = n // 2, n // 2, 3 * n // 4
    for lc in (0, 3):
        kw = dict(lc=lc, lrep_fallback="match")
        slabs = jnp.asarray(_mutate(rng, np.asarray(ctx.init_slab), cd, cl,
                                    C))
        q = jnp.asarray(rng.integers(0, n // 2, C), jnp.int32)
        u = jnp.asarray(rng.integers(0, n, C), jnp.int32)
        t = time.perf_counter()
        g1 = jax.block_until_ready(repair_walk.repair_cost_walk(
            slabs, q, u, *tabs, cap_pos=jnp.int32(cap1), **kw))
        t_g = time.perf_counter() - t
        t = time.perf_counter()
        w1 = jax.block_until_ready(scan(
            *jax.device_put((slabs, q, u), cpu), *tabs_cpu,
            cap_pos=jnp.int32(cap1), **kw))
        t_c = time.perf_counter() - t
        _same(f"lc={lc} full walk", g1, w1)
        # partial re-cost from the pass-1 snapshot, with the proposal's
        # two cells substituted in the kernel and scattered for the scan
        q2 = jnp.asarray(rng.integers(cap2, n - 1, C), jnp.int32)
        u2 = jnp.asarray(rng.integers(start2, n, C), jnp.int32)
        v0 = jnp.asarray(np.where(
            rng.random(C) < 0.5,
            P.pack_np(P.LREP, rng.integers(0, 4, C), np.full(C, 2)),
            P.pack_np(P.SREP, np.zeros(C, np.int64), np.ones(C, np.int64))))
        v1 = g1[0][jnp.arange(C), q2 + 1]
        part = dict(start_pos=jnp.int32(start2), cap_pos=jnp.int32(cap2),
                    probs_in=g1[3], carry_in=g1[8])
        g2 = repair_walk.repair_cost_walk(g1[0], q2, u2, *tabs, mut0=v0,
                                          mut1=v1, **part, **kw)
        scattered = g1[0].at[jnp.arange(C), q2].set(v0)
        w2 = scan(*jax.device_put((scattered, q2, u2), cpu), *tabs_cpu,
                  **jax.device_put(part, cpu), **kw)
        _same(f"lc={lc} partial re-cost", g2, w2)
        log(f"[parity] lc={lc} n={n} C={C}: nine outputs equal (full walk "
            f"with capture at {cap1}, partial re-cost {start2}..{n} with "
            f"capture at {cap2}); walk on GPU {t_g:.3f} s incl. compile, "
            f"scan on CPU {t_c:.3f} s incl. compile")

    tcfg = dataclasses.replace(cfg, chains=32)
    sg = engine.run_iters(engine.init_state(ctx, tcfg), ctx, tcfg, 16)
    xcfg = dataclasses.replace(tcfg, kernel="xla")
    ctx_cpu = jax.device_put(ctx, cpu)
    with jax.default_device(cpu):
        sx = engine.run_iters(engine.init_state(ctx_cpu, xcfg), ctx_cpu,
                              xcfg, 16)
    same = (int(sg.best_hi) == int(sx.best_hi)
            and int(sg.best_lo) == int(sx.best_lo)
            and np.array_equal(np.asarray(sg.best_slab),
                               np.asarray(sx.best_slab)))
    log(f"[parity] 16-iteration trajectory n={n} C=32, kernel on GPU vs "
        f"XLA on CPU: best {int(sg.best_hi)}/{int(sg.best_lo)} vs "
        f"{int(sx.best_hi)}/{int(sx.best_lo)}: "
        f"{'identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("engine trajectory differs between devices")


def phase_four():
    import jax
    import numpy as np
    from megalania_tpu import compressor
    from megalania_tpu.anneal import engine
    from megalania_tpu.anneal.config import AnnealConfig
    from megalania_tpu.parallel import mesh as mesh_mod

    devs = jax.devices()
    if len(devs) != 4:
        raise AssertionError(f"--four needs 4 GPUs, found {len(devs)}")
    cfg = AnnealConfig(chains=CHAINS)
    _, block = input_64k()
    data = b"".join(block[k:] + block[:k] for k in (0, 1, 2, 3))
    log(f"[four] input 4 x 64 KiB rotations of the 64k input")
    moves = 4 * CHAINS * 32
    t = time.perf_counter()
    with Spy(mesh_mod, "sharded_step") as steps:
        blob4 = compressor.compress(data, cfg, total_moves=moves)
    t4 = time.perf_counter() - t
    if not steps.seen:
        raise AssertionError("compress did not take the mesh path")
    t = time.perf_counter()
    blob1 = compressor.compress(data, cfg, total_moves=moves,
                                use_mesh=False)
    t1 = time.perf_counter() - t
    if blob4 != blob1:
        raise AssertionError("mesh bytes differ from the one-card bytes")
    if compressor.decompress(blob4) != data:
        raise AssertionError("mesh container does not round-trip")
    log(f"[four] blocks across cards: {len(blob4)} B identical to "
        f"use_mesh=False; mesh {t4:.3f} s, one card {t1:.3f} s")

    ctx = engine.make_context(block, cfg)
    state = engine.init_state(ctx, cfg)
    m = mesh_mod.make_mesh(1, devs)
    assert m.shape[mesh_mod.CHAIN_AXIS] == 4, m.shape
    step = mesh_mod.sharded_step(m, cfg, 16)
    stack = mesh_mod.replicate_for_blocks
    t = time.perf_counter()
    out = jax.block_until_ready(step(stack([state]), stack([ctx])))
    ts = time.perf_counter() - t
    on = {d.id for d in out.chains.slab.sharding.device_set}
    if len(on) != 4:
        raise AssertionError(f"chain shards sit on devices {on}")
    t = time.perf_counter()
    ref = jax.block_until_ready(engine.run_iters(state, ctx, cfg, 16))
    tr = time.perf_counter() - t
    if not (int(ref.best_hi) == int(out.best_hi[0])
            and int(ref.best_lo) == int(out.best_lo[0])
            and np.array_equal(np.asarray(ref.best_slab),
                               np.asarray(out.best_slab[0]))):
        raise AssertionError("chain-sharded trajectory differs")
    log(f"[four] chains across cards: n={len(block)} C={CHAINS} "
        f"({CHAINS // 4} per card) on devices {sorted(on)}, 16 iterations: best cost and slab "
        f"identical to one device; sharded {ts:.3f} s, one device "
        f"{tr:.3f} s (both incl. compile)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)

    import jax
    from megalania_tpu.anneal.config import AnnealConfig
    from megalania_tpu.utils import compile_cache, gpu_info

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found "
              f"{dev.platform!r}", file=sys.stderr)
        return 1
    log(f"[cache] {compile_cache.enable()}")
    log(f"[card] {gpu_info.card_line()}")
    log(f"[device] {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    t0 = time.perf_counter()
    if args.four:
        phase_build()
        phase_four()
    else:
        cfg = AnnealConfig(chains=CHAINS)         # the CLI defaults
        phase_build()
        _, ctx = phase_64k(cfg)
        phase_step(cfg, ctx)
        phase_1mib()
        phase_parity(cfg, ctx)
    log(f"[total] {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
