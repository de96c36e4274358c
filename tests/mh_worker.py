"""Worker for test_multihost_two_processes: one real jax.distributed
process.  Usage: python mh_worker.py <process_id> <port>."""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)        # no fake device count here

import jax  # noqa: E402

jax.config.update("jax_cpu_collectives_implementation", "gloo")

pid, port = int(sys.argv[1]), sys.argv[2]
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=pid)
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from megalania_tpu.parallel import multihost  # noqa: E402

n_blocks = 5
mine = multihost.my_blocks(n_blocks)
assert mine == [bi for bi in range(n_blocks) if bi % 2 == pid]
local = {bi: bytes([bi + 1]) * (10 + 7 * bi) for bi in mine}
out = multihost.gather_streams(local, n_blocks)
want = [bytes([bi + 1]) * (10 + 7 * bi) for bi in range(n_blocks)]
assert out == want, (pid, [len(o) for o in out])
print(f"proc{pid} OK", flush=True)
