"""The GPU repair+cost kernel, called through jax.ffi.

kernels/repair_walk.cu walks each chain's slab in one launch (one warp
per chain, the probability row in shared memory) with the contract of
ops/repair_scan.repair_cost_batched, output for output.  The same walk
source also builds for the host (kernels/repair_walk_cpu.cc); that build
is registered for the CPU platform so the tests can compare the kernel's
arithmetic with the scan without a GPU.

The libraries are built from the committed sources by kernels/Makefile at
first use (nvcc for the GPU, the host C++ compiler for the CPU).
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp

from . import tables as T
from ..utils import native_build

KERNEL_DIR = os.path.join(os.path.dirname(__file__), "..", "kernels")
TARGET = "megalania_repair_walk"
MISC = 32                       # kernels/repair_walk.h: misc row width

# platform -> (make target, library, handler symbol, jax.ffi platform)
_BUILDS = {
    "gpu": ("cuda", "libmeg_walk_cuda.so", "MegRepairWalkCuda", "CUDA"),
    "cpu": ("cpu", "libmeg_walk_cpu.so", "MegRepairWalkCpu", "cpu"),
}


@functools.cache
def load(platform: str) -> ctypes.CDLL:
    """Build (if needed) and register the walk for `platform` ("gpu" or
    "cpu"); returns the loaded library."""
    target, name, symbol, ffi_platform = _BUILDS[platform]
    native_build.make(KERNEL_DIR, target,
                      {"JAX_FFI_INCLUDE": jax.ffi.include_dir()})
    lib = ctypes.CDLL(os.path.join(KERNEL_DIR, "build", name))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(getattr(lib, symbol)),
        platform=ffi_platform)
    return lib


def repair_cost_walk(slabs, q, u, data, cand_dist, cand_len, log2,
                     site_mode: str = "byte",
                     lrep_fallback: str = "litsrep",
                     start_pos=None, cap_pos=None,
                     probs_in=None, carry_in=None, lc: int = 0,
                     mut0=None, mut1=None):
    """repair_scan.repair_cost_batched on the walk kernel, same nine
    outputs.  The kernel runs on the default backend's platform.

    mut0/mut1 (optional uint32[C]): the proposal's two mutated cells,
    substituted while the kernel reads positions clip(q) and clip(q)+1 —
    the same slab the scatter in moves.apply_move would produce, without
    writing a [C, n] copy."""
    assert site_mode in ("byte", "packet"), site_mode
    assert lrep_fallback in ("litsrep", "match"), lrep_fallback
    load(jax.default_backend())
    C, n = slabs.shape
    P = T.probs_pad(lc)
    if probs_in is None:
        probs_in = jnp.broadcast_to(
            jnp.asarray(T.init_probs_np(lc=lc), jnp.int32), (C, P))
        carry_in = jnp.zeros((C, 16), jnp.int32)
    sc = jnp.stack([
        jnp.asarray(0 if start_pos is None else start_pos, jnp.int32),
        jnp.asarray(n if cap_pos is None else cap_pos, jnp.int32)])
    has_mut = mut0 is not None
    if not has_mut:
        mut0 = mut1 = jnp.zeros(C, jnp.uint32)
    out_slab, snap_probs, misc = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((C, n), jnp.uint32),
         jax.ShapeDtypeStruct((C, P), jnp.int32),
         jax.ShapeDtypeStruct((C, MISC), jnp.int32)),
        vmap_method="sequential",
    )(jnp.asarray(slabs, jnp.uint32), jnp.asarray(q, jnp.int32),
      jnp.asarray(u, jnp.int32), jnp.asarray(mut0, jnp.uint32),
      jnp.asarray(mut1, jnp.uint32), jnp.asarray(data, jnp.int32),
      jnp.asarray(cand_dist, jnp.int32), jnp.asarray(cand_len, jnp.int32),
      jnp.asarray(log2, jnp.int32), sc, jnp.asarray(probs_in, jnp.int32),
      jnp.asarray(carry_in, jnp.int32),
      lc=np.int32(lc), site_packet=np.int32(site_mode == "packet"),
      fb_match=np.int32(lrep_fallback == "match"),
      has_mut=np.int32(has_mut))
    return (out_slab, misc[:, 0], misc[:, 1], snap_probs, misc[:, 2],
            misc[:, 3:7], misc[:, 7], misc[:, 8], misc[:, 16:32])
