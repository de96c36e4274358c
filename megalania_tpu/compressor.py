"""Top-level compression API: file bytes -> .lzma / .mlz container.

Integrates the aux subsystems (SURVEY.md §5.3-5.5) the reference lacks:
per-block checkpoint/resume (exact, PRNG keys included) and structured
metrics.  A failing block or mesh run raises: nothing is retried on
another kernel or device behind the caller's back.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from .anneal import engine
from .anneal.config import AnnealConfig
from .parallel import blocks as blocks_mod
from .runtime import emit as emit_mod
from .utils import checkpoint as ckpt_mod
from .utils import fixedpoint as fp
from .utils.metrics import MetricsLogger


@dataclass
class BlockResult:
    stream: bytes
    raw_len: int
    predicted_bytes: float
    moves: int
    seconds: float
    kernel: str = "auto"


def reference_budget(n: int, cfg: AnnealConfig) -> int:
    """Total moves the reference would spend on an n-byte input
    (3 steps x 200 epochs x n iters, main.c:66-69)."""
    return cfg.num_steps * cfg.num_epochs * max(n, 1)


def _seed_slab(data: bytes, cfg: AnnealConfig):
    """Host-only initial parse for the DP-only (total_moves=0) mode —
    the same seed builder make_context uses (match/optparse.seed_slab),
    without touching a device.

    Returns (slab, dists): dists is None for packed-format blocks and
    the full-width distance array for wide (> 1 MiB) blocks, which
    always use the optimum parse (the only wide-capable builder)."""
    from .match import candidates as C_
    from .match import optparse
    from .match.suffix import build_lce
    from .models import packets as P

    arr = np.frombuffer(bytes(data), np.uint8)
    wide = len(arr) > P.MAX_BLOCK
    if cfg.init == "literal" and not wide:
        return np.asarray(P.literal_slab(len(arr))), None
    if wide or cfg.init in ("optimal", "mixed_opt"):
        return optparse.seed_slab(arr, cfg, wide=wide)
    idx = build_lce(arr)
    tab = C_.build_candidates(arr, cfg.max_candidates, cfg.max_walk, idx)
    return C_.greedy_slab(arr, tab), None


def compress_block(
    data: bytes,
    cfg: AnnealConfig,
    total_moves: Optional[int] = None,
    segment_iters: int = 256,
    progress: Optional[Callable[[dict], None]] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 4,
    resume: bool = False,
    metrics: Optional[MetricsLogger] = None,
    block_id: int = 0,
) -> BlockResult:
    """Anneal one block and emit its .lzma stream.

    checkpoint_path: npz file updated every `checkpoint_every` segments;
    with resume=True an existing file continues the run exactly (the
    PRNG keys are part of the state, so the continuation is
    bit-identical to an uninterrupted run).
    """
    t0 = time.time()
    n = len(data)
    if n == 0:
        return BlockResult(emit_mod.emit(b"", np.zeros(0, np.uint32)), 0,
                           18.0, 0, time.time() - t0)
    if total_moves == 0:
        # DP-only mode: emit the configured initial parse directly (the
        # optimum-parse seed needs no annealing to be competitive at
        # large blocks, and this skips the n-sized engine compile)
        slab, dists = _seed_slab(data, cfg)
        stream = emit_mod.emit(data, slab, dict_size=cfg.dict_size,
                               lc=cfg.lc, dists=dists)
        return BlockResult(stream=stream, raw_len=n, predicted_bytes=0.0,
                           moves=0, seconds=time.time() - t0,
                           kernel="none")
    from .models import packets as P
    if n > P.MAX_BLOCK:
        raise ValueError(
            f"blocks over {P.MAX_BLOCK} bytes exceed the packed dist "
            "field and run the wide DP-only pipeline: pass "
            "total_moves=0 (CLI --moves 0)")
    if total_moves is None:
        total_moves = reference_budget(n, cfg)
    # one move = one costed proposal (the reference's unit, main.c:78);
    # an iteration costs chains * proposals of them
    iters = max(1, total_moves // (cfg.chains * cfg.proposals))

    ctx = engine.make_context(data, cfg)
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state = ckpt_mod.load(checkpoint_path)
        # moves_done counts chains*proposals per iteration; reconstruct
        # completed ITERATIONS (the unit the loop below advances by)
        done = int(state.moves_done) // (cfg.chains * cfg.proposals)
    else:
        state = engine.init_state(ctx, cfg)
        done = 0
    segs = 0
    seg_t = time.time()
    seg_moves = 0
    while done < iters:
        seg = min(segment_iters, iters - done)
        state = engine.run_iters(state, ctx, cfg, seg)
        done += seg
        segs += 1
        if checkpoint_path and (segs % checkpoint_every == 0
                                or done >= iters):
            ckpt_mod.save(checkpoint_path, state)
        now = time.time()
        moves_now = int(state.moves_done)
        mps = (moves_now - seg_moves) / max(now - seg_t, 1e-9)
        seg_t, seg_moves = now, moves_now
        info = {
            "block": block_id,
            "iter": done,
            "iters": iters,
            "moves": moves_now,
            "moves_per_sec": round(mps, 1),   # per chip (north-star metric)
            "best_bytes": round(engine.best_cost_bytes(state), 2),
            "epochs": int(state.epochs_done),
        }
        if metrics is not None:
            metrics.log(**info)
        if progress is not None:
            progress(info)
    slab = np.asarray(state.best_slab)
    stream = emit_mod.emit(data, slab, dict_size=cfg.dict_size, lc=cfg.lc)
    return BlockResult(
        stream=stream,
        raw_len=n,
        predicted_bytes=engine.best_cost_bytes(state),
        moves=int(state.moves_done),
        seconds=time.time() - t0,
        kernel=engine.resolve_kernel(cfg),
    )


def _compress_blocks_mesh(
    parts: List[bytes],
    cfg: AnnealConfig,
    moves_per_block: Optional[int],
    segment_iters: int = 256,
    progress: Optional[Callable[[dict], None]] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 4,
    resume: bool = False,
    metrics: Optional[MetricsLogger] = None,
    block_ids: Optional[List[int]] = None,
) -> List[BlockResult]:
    """Anneal equal-sized blocks CONCURRENTLY over the device mesh.

    Blocks shard over the mesh's block axis, each block's chains over
    the chain axis with per-move exact best-exchange
    (parallel/mesh.py).  This is the scale-out the reference lacks
    entirely (SURVEY.md §2: parallelism NONE); the final ordered gather
    of the ragged compressed streams happens host-side below.
    """
    import jax
    from .parallel import mesh as mesh_mod

    t0 = time.time()
    B = len(parts)
    n = len(parts[0])
    assert all(len(p) == n for p in parts), "mesh path needs equal blocks"
    m = mesh_mod.make_mesh(B)
    ctxs = [engine.make_context(p, cfg) for p in parts]
    ctx_stack = mesh_mod.replicate_for_blocks(ctxs)

    if moves_per_block is None:
        moves_per_block = reference_budget(n, cfg)
    iters = max(1, moves_per_block // (cfg.chains * cfg.proposals))

    if block_ids is None:
        block_ids = list(range(B))
    # legacy sidecar (pre-r5 checkpoints); new saves embed the ids in
    # the npz itself so state and ids can never go stale independently
    ids_path = checkpoint_path + ".ids.json" if checkpoint_path else None
    states = None
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        # the saved stack is keyed by block ids: a
        # resumed run may carry FEWER blocks (some block{bi}.lzma already
        # emitted), so re-slice the stack to the current block list
        saved = ckpt_mod.load_extra(checkpoint_path, "block_ids")
        if saved is not None:
            saved_ids = [int(x) for x in saved]
        elif ids_path and os.path.exists(ids_path):
            import json
            with open(ids_path) as f:
                saved_ids = json.load(f)
        else:
            saved_ids = list(range(B))
        if all(bi in saved_ids for bi in block_ids):
            loaded = ckpt_mod.load(checkpoint_path)
            sel = np.asarray([saved_ids.index(bi) for bi in block_ids])
            states = (loaded if len(sel) == len(saved_ids)
                      and (sel == np.arange(len(sel))).all()
                      else jax.tree.map(lambda x: x[sel], loaded))
            done = int(np.asarray(states.moves_done)[0]) // (
                cfg.chains * cfg.proposals)
    if states is None:
        states = mesh_mod.replicate_for_blocks(
            [engine.init_state(c, cfg) for c in ctxs])
        done = 0

    step_fns = {}
    segs = 0
    seg_t = time.time()
    seg_moves = 0
    while done < iters:
        seg = min(segment_iters, iters - done)
        if seg not in step_fns:
            step_fns[seg] = mesh_mod.sharded_step(m, cfg, seg)
        states = step_fns[seg](states, ctx_stack)
        done += seg
        segs += 1
        if checkpoint_path and (segs % checkpoint_every == 0
                                or done >= iters):
            # block ids ride inside the (atomically replaced) npz, so a
            # crash can never pair fresh state with stale ids
            ckpt_mod.save(checkpoint_path, states,
                          extra={"block_ids": np.asarray(block_ids)})
        his = np.asarray(states.best_hi)
        los = np.asarray(states.best_lo)
        now = time.time()
        moves_now = int(np.asarray(states.moves_done).sum())
        mps = (moves_now - seg_moves) / max(now - seg_t, 1e-9)
        seg_t, seg_moves = now, moves_now
        info = {
            "mesh_blocks": B,
            "iter": done,
            "iters": iters,
            "moves": moves_now,
            "moves_per_sec": round(mps, 1),
            "best_bytes": round(sum(
                18 + fp.to_int(h, l) / 16384.0 for h, l in zip(his, los)
            ), 2),
            "epochs": int(np.asarray(states.epochs_done).min()),
        }
        if metrics is not None:
            metrics.log(**info)
        if progress is not None:
            progress(info)

    best_slabs = np.asarray(states.best_slab)
    his = np.asarray(states.best_hi)
    los = np.asarray(states.best_lo)
    dt = time.time() - t0
    results = []
    for bi, part in enumerate(parts):
        stream = emit_mod.emit(part, best_slabs[bi], dict_size=cfg.dict_size,
                               lc=cfg.lc)
        results.append(BlockResult(
            stream=stream, raw_len=len(part),
            predicted_bytes=18 + fp.to_int(his[bi], los[bi]) / 16384.0,
            moves=iters * cfg.chains * cfg.proposals, seconds=dt / B,
            kernel=engine.resolve_kernel(cfg),
        ))
    return results


def compress(
    data: bytes,
    cfg: AnnealConfig = AnnealConfig(),
    total_moves: Optional[int] = None,
    progress: Optional[Callable[[dict], None]] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 4,
    resume: bool = False,
    metrics: Optional[MetricsLogger] = None,
    use_mesh: bool = True,
) -> bytes:
    """Compress to a plain .lzma (single block) or .mlz container.

    With more than one device and at least two full blocks, the full
    blocks anneal together over the device mesh; the ragged tail block
    and every use_mesh=False run go block by block on the default
    device.  Completed block streams are persisted under checkpoint_dir
    so a resumed run re-does only unfinished blocks.
    """
    parts = blocks_mod.split_blocks(data, cfg.block_size)
    results: List[Optional[BlockResult]] = [None] * len(parts)
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)

    # Multi-host: each process owns a round-robin share of the blocks;
    # the ordered ragged gather below reassembles the container
    # identically on every host (SURVEY §5.8).
    import jax
    from .parallel import multihost
    multi = jax.process_count() > 1
    mine = set(multihost.my_blocks(len(parts))) if multi else set(
        range(len(parts)))

    # Mesh fast path: all the full-size blocks anneal concurrently over
    # the device mesh; the ragged tail block falls through to the
    # per-block loop below.
    full = [bi for bi in range(len(parts))
            if len(parts[bi]) == cfg.block_size and bi in mine]
    mesh_done = []
    # the mesh only pays with >1 device (blocks ride the mesh axes); on
    # one device it is pure shard_map overhead
    if len(jax.devices()) < 2:
        use_mesh = False
    if total_moves == 0:
        use_mesh = False               # DP-only mode is host-side
    if use_mesh and len(full) >= 2:
        mesh_ck = (os.path.join(checkpoint_dir, "mesh.npz")
                   if checkpoint_dir else None)
        already = [bi for bi in full if checkpoint_dir and resume
                   and os.path.exists(
                       os.path.join(checkpoint_dir, f"block{bi}.lzma"))]
        todo = [bi for bi in full if bi not in already]
        moves = (max(1, total_moves // len(parts))
                 if total_moves is not None else None)
        if todo:
            rs = _compress_blocks_mesh(
                [parts[bi] for bi in todo], cfg, moves,
                progress=progress, checkpoint_path=mesh_ck,
                checkpoint_every=checkpoint_every, resume=resume,
                metrics=metrics, block_ids=todo)
            for bi, r in zip(todo, rs):
                results[bi] = r
                if checkpoint_dir:
                    with open(os.path.join(
                            checkpoint_dir, f"block{bi}.lzma"), "wb") as f:
                        f.write(r.stream)
            mesh_done = todo
            if mesh_ck and os.path.exists(mesh_ck):
                os.unlink(mesh_ck)
            if mesh_ck and os.path.exists(mesh_ck + ".ids.json"):
                os.unlink(mesh_ck + ".ids.json")

    for bi in range(len(parts)):
        if bi not in mine or bi in mesh_done:
            continue
        part = parts[bi]
        done_path = (os.path.join(checkpoint_dir, f"block{bi}.lzma")
                     if checkpoint_dir else None)
        if resume and done_path and os.path.exists(done_path):
            results[bi] = BlockResult(
                open(done_path, "rb").read(), len(part), 0.0, 0, 0.0)
            continue
        ck_path = (os.path.join(checkpoint_dir, f"block{bi}.npz")
                   if checkpoint_dir else None)
        moves = None
        if total_moves is not None:
            moves = (0 if total_moves == 0
                     else max(1, total_moves // len(parts)))
        res = compress_block(
            part, cfg, moves, progress=progress,
            checkpoint_path=ck_path, checkpoint_every=checkpoint_every,
            resume=resume, metrics=metrics, block_id=bi,
        )
        results[bi] = res
        if done_path:
            with open(done_path, "wb") as f:
                f.write(res.stream)
            if ck_path and os.path.exists(ck_path):
                os.unlink(ck_path)

    if multi:
        streams = multihost.gather_streams(
            {bi: results[bi].stream for bi in mine}, len(parts))
        if len(streams) == 1:
            return streams[0]
        return blocks_mod.pack_container(streams,
                                         [len(p) for p in parts])

    if len(results) == 1:
        return results[0].stream
    return blocks_mod.pack_container(
        [r.stream for r in results], [r.raw_len for r in results]
    )


def decompress(blob: bytes) -> bytes:
    return blocks_mod.decompress(blob)
