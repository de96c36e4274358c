#!/usr/bin/env python3
"""Benchmark: anneal moves/sec on one GPU vs the reference C implementation.

Baseline (BASELINE.md): reference does 16.9k moves/s at n=2000 on one CPU
core, where one move = one full-parse re-cost.  We measure the identical
unit of work — one exact full-block re-cost + repair per chain per
iteration — on one chip with C parallel chains.

Two shapes are measured (the small-block rate alone over-represents the
framework):
  * n=2048   — baseline continuity with the reference's measured n=2000;
  * n=65536  — the config.block_size design point.  The reference's
    per-move cost is linear in n (full re-encode per move,
    packet_slab_neighbour.c:154-173), so its extrapolated rate there is
    16.9k * 2000/65536 ~= 515.8 moves/s.

Prints the device and the card's power limit, then ONE JSON line; the
headline value stays the n=2048 rate, the design-point rate rides in
"design_point_n65536".  Exits non-zero without a GPU; a failing row fails
the run.
"""
import json
import os
import sys
import time

N = 2048                 # match the reference's measured n=2000 scale
CHAINS = int(os.environ.get("BENCH_CHAINS", "512"))
BASELINE_MOVES_PER_S = 16900.0   # reference @ n=2000 (BASELINE.md)
N64K = 1 << 16
CHAINS64K = int(os.environ.get("BENCH_CHAINS_64K", "512"))
# fair steady-state window: a full sweep cycle (n_tiles * sweep_repeats
# passes) so the average walk start is the sweep's true average — a
# short window over-samples whichever strata it lands on
ITERS64K = int(os.environ.get("BENCH_ITERS_64K", "0"))   # 0 = one sweep
BASELINE_64K = BASELINE_MOVES_PER_S * 2000.0 / N64K   # ~515.8 moves/s


def measure(n, chains, iters, data_path, init=None):
    import jax
    from megalania_tpu.anneal import engine
    from megalania_tpu.anneal.config import AnnealConfig

    data = open(data_path, "rb").read()
    data = (data * (n // len(data) + 1))[:n]
    # base rows pin init="mixed": the historical early-phase measurement
    # (cross-round comparability); the converged row passes "optimal".
    # accept pins the "cooled" rule for the same reason.
    kwargs = {"init": "mixed" if init is None else init,
              "accept": "cooled"}
    cfg = AnnealConfig(
        chains=chains,
        proposals=int(os.environ.get("BENCH_PROPOSALS", "1")),
        **kwargs,
    )
    if iters == 0:    # one full sweep cycle (see ITERS64K note)
        iters = (-(-n // engine.sweep_tile(n))) * cfg.sweep_repeats
    ctx = engine.make_context(data, cfg)
    state = engine.init_state(ctx, cfg)

    # warm up with the SAME program shape as the timed run (one compile).
    # The timed window measures the sustained steady-state rate: a real
    # run is 600n moves, so the first iterations are startup noise.
    state = engine.run_iters(state, ctx, cfg, iters)
    jax.block_until_ready(state)

    t0 = time.time()
    state = engine.run_iters(state, ctx, cfg, iters)
    jax.block_until_ready(state)
    dt = time.time() - t0
    moves = chains * iters * cfg.proposals
    return moves / dt, dt, engine.best_cost_bytes(state), iters


def main():
    import jax
    from megalania_tpu.utils import compile_cache, gpu_info

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write("bench: needs an NVIDIA GPU; JAX found %r\n"
                         % dev.platform)
        return 1
    compile_cache.enable()
    print("device: %s %s x%d; card: %s" % (
        dev.platform, dev.device_kind, len(jax.devices()),
        gpu_info.card_line()), flush=True)

    here = os.path.dirname(__file__) or "."
    iters = int(os.environ.get("BENCH_ITERS", "512"))
    mps, dt, best, iters = measure(N, CHAINS, iters,
                                   os.path.join(here, "SURVEY.md"))

    out = {
        "metric": "anneal_moves_per_sec",
        "value": round(mps, 1),
        "unit": "moves/s",
        "vs_baseline": round(mps / BASELINE_MOVES_PER_S, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if os.environ.get("BENCH_SKIP_64K", "0") != "1":
        mps64, dt64, best64, iters64 = measure(
            N64K, CHAINS64K, ITERS64K, os.path.join(here, "SURVEY.md"))
        # converged-state rate: real runs converge to tight parses whose
        # long matches the walk skips; an optimum-parse seed reproduces
        # that state from the first iteration
        mpsC, dtC, bestC, itersC = measure(
            N64K, CHAINS64K, ITERS64K, os.path.join(here, "SURVEY.md"),
            init="optimal")
        out["design_point_n65536"] = {
            "moves_per_s": round(mps64, 1),
            "vs_baseline": round(mps64 / BASELINE_64K, 3),
            "converged_moves_per_s": round(mpsC, 1),
            "converged_vs_baseline": round(mpsC / BASELINE_64K, 3),
        }
    print(json.dumps(out))
    # context for humans, stderr only
    sys.stderr.write(
        "n=%d chains=%d iters=%d dt=%.2fs best=%.2fB backend=%s\n" % (
            N, CHAINS, iters, dt, best, jax.default_backend(),
        )
    )
    if "design_point_n65536" in out:
        sys.stderr.write(
            "n=%d chains=%d iters=%d dt=%.2fs best=%.2fB (design point)\n"
            % (N64K, CHAINS64K, iters64, dt64, best64))
    return 0


if __name__ == "__main__":
    sys.exit(main())
