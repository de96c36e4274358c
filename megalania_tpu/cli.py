"""CLI: the reference's `megalania filename` interface, extended.

`python -m megalania_tpu.cli compress FILE` writes the compressed stream
to stdout and progress to stderr, like /root/reference/src/main.c:28-99;
plus decompress/verify subcommands and config flags for every knob.
"""
from __future__ import annotations

import argparse
import sys
import time

from .anneal.config import AnnealConfig
from . import compressor


def _progress_printer(t0):
    def cb(info):
        if "mesh_blocks" in info:       # mesh fast path: B blocks at once
            head = "mesh %d blocks" % info["mesh_blocks"]
        else:
            head = "block %d/%d" % (info.get("block", 0) + 1,
                                    info.get("blocks", 1))
        sys.stderr.write(
            "%s  current file size: %.2f  iter %d/%d  "
            "epochs: %d  moves: %d  %.1fs\n" % (
                head, info["best_bytes"], info["iter"], info["iters"],
                info.get("epochs", 0), info["moves"], time.time() - t0,
            )
        )
    return cb


def main(argv=None):
    ap = argparse.ArgumentParser(prog="megalania-tpu")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="force the JAX backend (some environments ignore "
                    "JAX_PLATFORMS; this uses jax.config, which always works)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host: jax.distributed.initialize from "
                    "JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
                    "JAX_PROCESS_ID; blocks are round-robined over hosts "
                    "and the container gathered in order (parallel/"
                    "multihost.py)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="anneal-compress a file")
    c.add_argument("file")
    c.add_argument("-o", "--output", default="-")
    c.add_argument("--chains", type=int, default=128,
                   help="parallel annealing chains (128 = the measured "
                   "ratio sweet spot at matched budgets)")
    c.add_argument("--block-size", type=int, default=1 << 16)
    c.add_argument("--moves", type=int, default=None,
                   help="total anneal moves (default: reference budget; "
                   "0 = DP-only mode, emit the --init parse directly "
                   "without annealing)")
    c.add_argument("--proposals", type=int, default=1,
                   help="proposals costed per chain per pass (best-of-P)")
    c.add_argument("--top-k", type=int, default=20)
    c.add_argument("--sublens", type=int, default=3,
                   help="candidate lengths evaluated per match entry")
    c.add_argument("--init", default="optimal",
                   choices=["greedy", "literal", "mixed", "optimal",
                            "mixed_opt"],
                   help="initial parse: greedy longest-match, the "
                   "reference's all-literals, a greedy/literal chain "
                   "split (mixed), the price-driven optimum-parse DP "
                   "(optimal — the best measured 64 KiB seed), or an "
                   "optimal/literal split (mixed_opt)")
    c.add_argument("--mixed-greedy-frac", type=float, default=0.5,
                   help="greedy share of chains under --init mixed "
                   "(rounded to eighths)")
    c.add_argument("--opt-candidates", type=int, default=64,
                   help="Pareto table width for the optimum-parse seed")
    c.add_argument("--opt-walk", type=int, default=1024,
                   help="occurrence-chain walk bound for the seed table")
    c.add_argument("--opt-passes", type=int, default=16,
                   help="price-feedback passes (converges by ~24)")
    c.add_argument("--opt-window", type=int, default=0,
                   help="price-snapshot window bytes (0 = sweep "
                   "{256,512,1024} and keep the exact-cost best)")
    c.add_argument("--lc", type=int, default=0,
                   help="literal context bits, 0..4 (xz defaults to 3; "
                   "the reference only supports 0)")
    c.add_argument("--seed", type=int, default=1673551)
    c.add_argument("--quiet", action="store_true")
    c.add_argument("--kernel", default="auto",
                   choices=["auto", "xla", "cuda"],
                   help="fused repair+cost kernel (auto: the CUDA walk "
                   "on a GPU, the XLA scan elsewhere)")
    c.add_argument("--site-mode", default="byte",
                   choices=["byte", "packet"],
                   help="mutation-site distribution (packet = the "
                   "reference's uniform-over-live-packets rule)")
    c.add_argument("--site-schedule", default="sweep",
                   choices=["sweep", "random"],
                   help="mutation-site schedule (sweep enables snapshot "
                   "partial re-cost; random = per-chain uniform sites, "
                   "always a full walk)")
    c.add_argument("--accept", default="cooled",
                   choices=["cooled", "greedy", "mixed"],
                   help="acceptance rule: cooled = reference cooling "
                   "(the measured matched-budget winner from swept "
                   "seeds), greedy = improvements only, mixed = half "
                   "the chains each (race, shared best)")
    c.add_argument("--lrep-fallback", default="match",
                   choices=["litsrep", "match"],
                   help="repair fallback for unrepairable long reps")
    c.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="checkpoint directory (per-block state + streams)")
    c.add_argument("--checkpoint-every", type=int, default=4,
                   help="segments between checkpoint saves")
    c.add_argument("--resume", action="store_true",
                   help="continue from an existing checkpoint")
    c.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                   help="append structured per-segment metrics as JSONL")

    d = sub.add_parser("decompress", help="decode .lzma/.mlz")
    d.add_argument("file")
    d.add_argument("-o", "--output", default="-")

    v = sub.add_parser("verify", help="round-trip check")
    v.add_argument("original")
    v.add_argument("compressed")

    args = ap.parse_args(argv)

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    from .utils import compile_cache
    compile_cache.enable()
    if args.distributed:
        from .parallel import multihost
        multihost.initialize()

    if args.cmd == "compress":
        data = open(args.file, "rb").read()
        cfg = AnnealConfig(
            chains=args.chains, block_size=args.block_size,
            top_k=args.top_k, seed=args.seed, kernel=args.kernel,
            proposals=args.proposals,
            site_mode=args.site_mode, lrep_fallback=args.lrep_fallback,
            sublens=args.sublens, init=args.init,
            site_schedule=args.site_schedule, lc=args.lc,
            mixed_greedy_frac=args.mixed_greedy_frac,
            accept=args.accept,
            opt_candidates=args.opt_candidates, opt_walk=args.opt_walk,
            opt_passes=args.opt_passes, opt_window=args.opt_window,
        )
        progress = None if args.quiet else _progress_printer(time.time())
        metrics = None
        if args.metrics_jsonl:
            from .utils.metrics import MetricsLogger
            metrics = MetricsLogger(jsonl_path=args.metrics_jsonl)
        blob = compressor.compress(data, cfg, total_moves=args.moves,
                                   progress=progress,
                                   checkpoint_dir=args.checkpoint,
                                   checkpoint_every=args.checkpoint_every,
                                   resume=args.resume, metrics=metrics)
        out = sys.stdout.buffer if args.output == "-" else open(
            args.output, "wb")
        out.write(blob)
        out.flush()
        sys.stderr.write(
            "in: %d bytes  out: %d bytes  ratio: %.4f\n"
            % (len(data), len(blob), len(blob) / max(len(data), 1))
        )
    elif args.cmd == "decompress":
        blob = open(args.file, "rb").read()
        data = compressor.decompress(blob)
        out = sys.stdout.buffer if args.output == "-" else open(
            args.output, "wb")
        out.write(data)
        out.flush()
    else:
        original = open(args.original, "rb").read()
        blob = open(args.compressed, "rb").read()
        ok = compressor.decompress(blob) == original
        print("OK" if ok else "MISMATCH")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
