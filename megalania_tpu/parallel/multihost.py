"""Multi-host bring-up + the ordered ragged stream gather (SURVEY §5.8).

The reference has no communication backend at all (SURVEY.md §2:
includes are libc-only).  The multi-host scale-out uses:

  * `jax.distributed.initialize` for process bootstrap,
  * mesh axes {block, chain} from parallel/mesh.py,
  * and — the one genuinely new communication pattern — an ORDERED
    gather of variable-length range-coded block streams to host 0.

Compressed blocks are ragged (entropy-coded length is data-dependent),
so the gather pads each stream to the global max, all-gathers bytes and
true lengths over the process group, and host 0 reassembles in block
order.  Collectives ride `jax.experimental.multihost_utils`, which
degrades to identity in a single process — so the same code path runs
everywhere (unit tests exercise it on one process; real multi-host runs
exercise the same calls across hosts).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> int:
    """Bootstrap jax.distributed from args or the standard env vars.

    Returns this host's process index (0 in single-process mode).
    No-op when neither args nor JAX_COORDINATOR_ADDRESS are set.
    """
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return 0
    kw = {}
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    jax.distributed.initialize(coordinator_address=coordinator, **kw)
    return jax.process_index()


def my_blocks(n_blocks: int) -> List[int]:
    """Round-robin block ownership for this process."""
    import jax

    p, np_ = jax.process_index(), jax.process_count()
    return [bi for bi in range(n_blocks) if bi % np_ == p]


def gather_streams(local: Dict[int, bytes], n_blocks: int) -> List[bytes]:
    """Ordered ragged gather: {block_id: stream} per host -> full list.

    Every process calls this; every process returns the same ordered
    list (all-gather semantics), so host 0 can write the container and
    the others can verify.  Pads to the global max stream length — the
    only dense-shape-friendly way to move ragged bytes through
    collectives — then trims by the gathered true lengths.
    """
    import jax
    from jax.experimental import multihost_utils as mhu

    if jax.process_count() == 1:
        missing = [bi for bi in range(n_blocks) if bi not in local]
        assert not missing, f"missing blocks {missing}"
        return [local[bi] for bi in range(n_blocks)]

    # dense [n_blocks] length vector; 0 = not mine
    lens = np.zeros(n_blocks, np.int64)
    for bi, s in local.items():
        lens[bi] = len(s)
    all_lens = np.asarray(mhu.process_allgather(lens))   # [P, n_blocks]
    true_lens = all_lens.max(axis=0)
    cap = int(true_lens.max()) if n_blocks else 0

    buf = np.zeros((n_blocks, cap), np.uint8)
    for bi, s in local.items():
        buf[bi, :len(s)] = np.frombuffer(s, np.uint8)
    all_buf = np.asarray(mhu.process_allgather(buf))     # [P, n_blocks, cap]
    merged = all_buf.max(axis=0)    # streams are disjoint across processes

    out = []
    for bi in range(n_blocks):
        if true_lens[bi] == 0 and bi in local:
            out.append(local[bi])   # genuinely empty stream edge case
        else:
            out.append(merged[bi, :true_lens[bi]].tobytes())
    return out
