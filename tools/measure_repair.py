#!/usr/bin/env python3
"""Time the repair+cost pass on a GPU: the CUDA walk kernel against
XLA's position scan (ops/repair_scan.py), at (n=65536, C=128) and
(n=2048, C=512), with a zero-tolerance parity check of the walk against
the scan run on the CPU device.

    python tools/measure_repair.py            # walk kernel only
    python tools/measure_repair.py --xla      # + the scan on the GPU and
                                              #   both anneal iteration times
    python tools/measure_repair.py --e2e-xla  # only chip_smoke's 64 KiB phase
                                              #   end to end on the XLA scan
Every line names the card (nvidia-smi name, power limit).  Exits non-zero
without a GPU.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def _time(fn, *args, reps=5):
    """(first call incl. compile, min, median of `reps` more) seconds."""
    import jax
    t = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return first, min(ts), statistics.median(ts)


def shape_case(n, C, with_xla, card, rng):
    import dataclasses
    import jax
    import jax.numpy as jnp
    import numpy as np
    from megalania_tpu.anneal import engine
    from megalania_tpu.anneal.config import AnnealConfig
    from megalania_tpu.ops import repair_scan, repair_walk

    _, block = cs.input_64k()
    data = block[:n]
    cfg = AnnealConfig(chains=C)
    ctx = engine.make_context(data, cfg)
    slabs = jnp.asarray(cs._mutate(rng, np.asarray(ctx.init_slab),
                                   np.asarray(ctx.cand_dist),
                                   np.asarray(ctx.cand_len), C))
    q = jnp.asarray(rng.integers(0, n // 2, C), jnp.int32)
    u = jnp.asarray(rng.integers(0, n, C), jnp.int32)
    tabs = (ctx.data, ctx.cand_dist, ctx.cand_len, ctx.log2)
    kw = dict(lrep_fallback="match")
    walk = jax.jit(lambda s, q, u, *t: repair_walk.repair_cost_walk(
        s, q, u, *t, **kw))
    first, best, med = _time(walk, slabs, q, u, *tabs)
    got = walk(slabs, q, u, *tabs)
    cpu = jax.devices("cpu")[0]
    want = jax.jit(repair_scan.repair_cost_batched,
                   static_argnames=("lrep_fallback",))(
        *jax.device_put((slabs, q, u) + tabs, cpu), **kw)
    cs._same(f"n={n} C={C}", got, want)
    print(f"[{card}] n={n} C={C} walk kernel: full pass {best * 1e3:.3f} ms "
          f"min, {med * 1e3:.3f} ms median of 5 (first call incl. compile "
          f"{first:.3f} s); nine outputs equal the CPU scan", flush=True)
    if not with_xla:
        return
    scan = jax.jit(lambda s, q, u, *t: repair_scan.repair_cost_batched(
        s, q, u, *t, **kw))
    first, best, med = _time(scan, slabs, q, u, *tabs, reps=2)
    print(f"[{card}] n={n} C={C} XLA scan: full pass {best * 1e3:.3f} ms "
          f"min, {med * 1e3:.3f} ms median of 2 (first call incl. compile "
          f"{first:.3f} s)", flush=True)
    for kernel in ("cuda", "xla"):
        kcfg = dataclasses.replace(cfg, kernel=kernel)
        state = engine.init_state(ctx, kcfg)
        step = engine.run_iters.lower(state, ctx, cfg=kcfg,
                                      n_iters=cs.SEG).compile()
        state = jax.block_until_ready(step(state, ctx))
        t = time.perf_counter()
        jax.block_until_ready(step(state, ctx))
        dt = (time.perf_counter() - t) / cs.SEG
        print(f"[{card}] n={n} C={C} anneal iteration, kernel={kernel}: "
              f"{dt * 1e3:.3f} ms ({C / dt:.1f} moves/s; second "
              f"{cs.SEG}-iteration call)", flush=True)


def e2e_64k(card):
    """§1(a) end to end with the XLA scan, for the kernel comparison."""
    import dataclasses
    from megalania_tpu import compressor
    from megalania_tpu.anneal.config import AnnealConfig

    _, data = cs.input_64k()
    cfg = dataclasses.replace(AnnealConfig(chains=cs.CHAINS), kernel="xla")
    t = time.perf_counter()
    blob = compressor.compress(data, cfg,
                               total_moves=cs.CHAINS * (cs.WARM + cs.TIMED))
    print(f"[{card}] 64k compressor.compress kernel=xla: "
          f"{time.perf_counter() - t:.3f} s end to end, {len(blob)} B",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--xla", action="store_true")
    ap.add_argument("--e2e-xla", action="store_true")
    args = ap.parse_args()
    import jax
    import numpy as np
    from megalania_tpu.utils import compile_cache, gpu_info

    if jax.devices()[0].platform != "gpu":
        print("measure_repair: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    compile_cache.enable()
    card = gpu_info.card_line()
    if args.e2e_xla:
        e2e_64k(card)
        return 0
    rng = np.random.default_rng(7)
    for n, C in ((1 << 16, 128), (2048, 512)):
        shape_case(n, C, args.xla, card, rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
