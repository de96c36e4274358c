"""Annealer configuration.

Every compile-time constant of the reference driver becomes a field here
(reference values cited from /root/reference/src/main.c:45-99,
packet_slab_neighbour.c:64-65, packet_enumerator.c:6-7).
"""
from __future__ import annotations

import dataclasses

# blocks beyond the packed format's 1 MiB (annealable) cap run the
# host-side wide-distance optimum-parse pipeline; 64 MiB matches xz's
# -9 dictionary
MAX_WIDE_BLOCK = 64 << 20


@dataclasses.dataclass(frozen=True)
class AnnealConfig:
    # LZMA properties (reference: lc=lp=pb=0, main.c:45).  lc>0 (literal
    # context bits of the previous byte, xz's default is lc=3) is
    # supported by both repair kernels — a ratio lever on text the
    # reference binary lacks entirely (lzma_packet_encoder.c:113 todo).
    lc: int = 0
    lp: int = 0
    pb: int = 0
    dict_size: int = 0x400000          # header field (lzma_header_encoder.c:16)

    # schedule (reference: 3 steps x 200 epochs x n iters, main.c:66-69)
    num_steps: int = 3
    num_epochs: int = 200              # reference epochs; chains divide this
    # lockstep iterations per epoch-restart.  The reference restarts
    # every n MOVES (main.c:70); with C lockstep chains an epoch of
    # 16n/C iterations reseeds from the global best every ~16n moves —
    # measured the dominant matched-budget ratio lever (earlier round:
    # restarting ~20x per reference budget closed most of the gap to
    # the reference binary).  None = this scaled default; a block
    # length n is the old once-per-budget behavior (iters_per_epoch=n).
    iters_per_epoch: int | None = None

    # proposal distribution
    top_k: int = 20                    # beam size (main.c:49)
    bias_draws: int = 8                # max-of-8 draw bias (neighbour.c:64)
    force_best_prob: float = 0.125     # 1/8 forced best (neighbour.c:65)
    boundary_prob: float = 0.5         # boundary-move coin (neighbour.c:122)

    # candidate tables (dense Pareto tables, match/candidates.py)
    max_candidates: int = 16
    max_walk: int = 96
    sublens: int = 3                   # lengths evaluated per candidate
    # optimum-parse initializer (native Viterbi, match/optparse_native):
    # the DP is host-side, so it affords a much WIDER Pareto table than
    # the anneal's per-position one, plus dense 2..273 length
    # enumeration.  Measured at the 64 KiB design point (earlier round):
    # seed quality keeps improving to M=64/walk=1024; window 512 B price
    # snapshots track the adaptive model closely.
    opt_candidates: int = 64
    opt_walk: int = 1024
    opt_passes: int = 16
    opt_window: int = 0      # 0 = sweep {256, 512, 1024}, keep best
    # initial parse: "greedy" (longest-match walk over the candidate
    # table, SURVEY §7), "literal" (the reference's all-literals,
    # main.c:71), "mixed" (greedy/literal chain split — the first
    # epoch's best-exchange keeps whichever start suits the data),
    # "optimal" (price-driven shortest-path DP, match/optparse.py —
    # xz-class parse quality; the annealer becomes a strict refiner), or
    # "mixed_opt" (optimal/literal chain split).  "optimal" is the
    # r5 default: the native Viterbi seed dominated every measured
    # scale (2 KiB slices through 1 MiB blocks, earlier round).
    init: str = "optimal"
    # fraction of chains seeded from the greedy parse under init="mixed"
    # (rounded to eighths; the rest start all-literals).  0.5 is the
    # historical half/half; lower favors text, higher favors binary
    # (earlier round: the mixed tradeoff was binary -4% / text +1%).
    mixed_greedy_frac: float = 0.5

    # acceptance rule: "cooled" = the reference's cooling transition
    # (accept-worse w.p. ~ sqrt(iters)/(i^2+...), main.c:86) — right for
    # weak starts that need escapes; "greedy" = accept only strict
    # improvements — right for strong seeds (measured: from an optimum-
    # parse seed the cooled schedule's exploratory acceptances are net
    # destructive in an earlier round: full budget ended WORSE than 25%);
    # "mixed" = an acceptance RACE — even global chain ids run cooled,
    # odd run greedy, sharing one global best (restart reseeds cross-
    # pollinate the arms).  Measured per-file winners split between the
    # two rules at matched budget under the PRE-sweep seeds; with the
    # window-swept seeds the full-width cooled rule won or tied every
    # corpus file (earlier round), so "cooled" stays the default and the
    # race remains an option for unknown data.
    accept: str = "cooled"

    # parallel structure
    chains: int = 64                   # parallel annealing chains per block
    proposals: int = 1                 # proposals costed per chain per pass
    #   (best-of-P before acceptance; the reference costs 1, main.c:78)
    block_size: int = 1 << 16          # block sharding unit (<= 1 MiB)

    # kernel for the fused repair+cost pass: "auto" (the CUDA walk on a
    # GPU backend, the XLA scan elsewhere), "cuda" or "xla"
    kernel: str = "auto"

    # mutation-site distribution: "byte" picks a byte position (site =
    # containing/following live packet, weights by preceding length);
    # "packet" picks uniformly over live packets, the reference's rule
    # (packet_slab_neighbour.c:162-163), using the previous pass's count
    site_mode: str = "byte"
    # mutation-site schedule: "sweep" samples the recording site from a
    # low-to-high tile-stratified sweep SHARED by all chains, enabling
    # partial re-cost (each pass restarts from a coder-state snapshot at
    # the last tile boundary before the previous site — SURVEY §7's
    # mitigation for the reference's O(n)-per-move full re-encode,
    # packet_slab_neighbour.c:154-173; ~2x fewer positions walked);
    # "random" is the independent per-chain uniform site draw (always a
    # full walk from 0).  site_mode="packet" forces "random".
    site_schedule: str = "sweep"
    # passes spent in each sweep stratum before advancing.  >1 amortizes
    # the full-walk ramp at the start of each sweep: within a stratum,
    # later passes start at that stratum's own tile boundary.  Site
    # coverage stays uniform (sweep_repeats draws per stratum).
    sweep_repeats: int = 4
    # repair fallback for an un-re-aimable long rep: "match"
    # (reference-flavoured: best table match at the site, approximating
    # the reference's in-repair top-K resample,
    # packet_slab_neighbour.c:104-109 — measured better or neutral on
    # every corpus file) or "litsrep" (plain literal/short-rep)
    lrep_fallback: str = "match"

    seed: int = 1673551                # reference seed (main.c:68)

    def __post_init__(self):
        if not (0 <= self.lc <= 4):
            raise ValueError("lc must be in 0..4")
        if self.lp != 0 or self.pb != 0:
            raise ValueError("only lp=pb=0 is implemented (like the "
                             "reference, main.c:45)")
        # annealable blocks are capped by the packed 20-bit dist field
        # (P.MAX_BLOCK = 1 MiB); larger blocks run the host-side
        # wide-distance DP-only pipeline (compressor, total_moves=0)
        if not (0 < self.block_size <= MAX_WIDE_BLOCK):
            raise ValueError(
                f"block_size={self.block_size} exceeds the "
                f"{MAX_WIDE_BLOCK}-byte wide-pipeline limit")
        if self.chains < 1:
            raise ValueError("chains must be >= 1")
        if self.proposals < 1:
            raise ValueError("proposals must be >= 1")
        if not (1 <= self.sublens <= 10):
            raise ValueError("sublens must be in 1..10 (moves._sublens)")
        if min(self.opt_candidates, self.opt_walk, self.opt_passes) < 1:
            raise ValueError("opt_* fields must be >= 1")
        if self.opt_window < 0:
            raise ValueError("opt_window must be >= 0 (0 = auto sweep)")
        if self.kernel not in ("auto", "xla", "cuda"):
            raise ValueError(f"unknown kernel {self.kernel!r}")
        if self.site_mode not in ("byte", "packet"):
            raise ValueError(f"unknown site_mode {self.site_mode!r}")
        if self.site_schedule not in ("sweep", "random"):
            raise ValueError(
                f"unknown site_schedule {self.site_schedule!r}")
        if self.sweep_repeats < 1:
            raise ValueError("sweep_repeats must be >= 1")
        if self.lrep_fallback not in ("litsrep", "match"):
            raise ValueError(
                f"unknown lrep_fallback {self.lrep_fallback!r}")
        if self.accept not in ("cooled", "greedy", "mixed"):
            raise ValueError(f"unknown accept {self.accept!r}")
        if self.init not in ("greedy", "literal", "mixed", "optimal",
                             "mixed_opt"):
            raise ValueError(f"unknown init {self.init!r}")

    def iters(self, n: int) -> int:
        if self.iters_per_epoch:
            return self.iters_per_epoch
        return max(32, min(16 * n // max(self.chains, 1), n))
