"""Host emission: parse -> .lzma bytes via the native op-stream emitter.

The op stream comes from the jitted emit_plan scan (single source of
truth for bit order); the C++ library only replays it through the range
coder.  Falls back to the pure-Python emitter when the shared library is
not built.
"""
from __future__ import annotations

import ctypes
import os
from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from ..ops import bitplan, emit_plan, tables as T
from ..utils import native_build
from . import pyemit

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmeg_emit.so")


@lru_cache(maxsize=1)
def _load_native():
    """Load (building if needed) the native emitter; None on failure."""
    try:
        native_build.make(_NATIVE_DIR, "libmeg_emit.so")
    except (OSError, RuntimeError):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    fn = lib.meg_emit_opstream
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # idx
        ctypes.POINTER(ctypes.c_int32),   # bit
        ctypes.POINTER(ctypes.c_uint8),   # active
        ctypes.POINTER(ctypes.c_int32),   # n_direct
        ctypes.POINTER(ctypes.c_int32),   # direct_val
        ctypes.c_int64,                   # n_positions
        ctypes.c_int32,                   # nslots
        ctypes.c_int32,                   # direct_after
        ctypes.c_int32,                   # num_probs
        ctypes.POINTER(ctypes.c_uint8),   # header
        ctypes.c_int64,                   # header_len
        ctypes.POINTER(ctypes.c_uint8),   # out
        ctypes.c_int64,                   # out_cap
    ]
    return fn


def native_available() -> bool:
    return _load_native() is not None


def emit_from_opstream(idx, bit, active, n_direct, direct_val,
                       header: bytes, lc: int = 0) -> bytes:
    """Replay an op stream (numpy arrays) through the native range coder."""
    fn = _load_native()
    idx = np.ascontiguousarray(idx, np.int32)
    bit = np.ascontiguousarray(bit, np.int32)
    active = np.ascontiguousarray(active, np.uint8)
    n_direct = np.ascontiguousarray(n_direct, np.int32)
    direct_val = np.ascontiguousarray(direct_val, np.int32)
    n, nslots = idx.shape
    hdr = np.frombuffer(header, np.uint8)
    # worst case ~11 bits/bit-op plus direct bits; be generous
    cap = len(header) + 16 + 2 * nslots * max(n, 1) + 8 * max(n, 1)
    out = np.empty(cap, np.uint8)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    size = fn(
        p(idx, ctypes.c_int32), p(bit, ctypes.c_int32),
        p(active, ctypes.c_uint8), p(n_direct, ctypes.c_int32),
        p(direct_val, ctypes.c_int32), n, nslots, 20, T.num_probs(lc),
        p(np.ascontiguousarray(hdr), ctypes.c_uint8), len(header),
        p(out, ctypes.c_uint8), cap,
    )
    if size < 0:
        raise RuntimeError("native emitter buffer overflow")
    return out[:size].tobytes()


def emit(data: bytes, slab: np.ndarray, dict_size: int = 0x400000,
         lc: int = 0, dists=None) -> bytes:
    """Parse -> complete .lzma stream (native path, Python fallback).

    dists: full-width distances for wide (> 1 MiB) blocks — those take
    the Python emitter (the op-stream plan is packed-format only)."""
    if _load_native() is None or len(data) == 0 or dists is not None:
        return pyemit.emit(data, slab, dict_size=dict_size, lc=lc,
                           dists=dists)
    d = jnp.asarray(np.frombuffer(data, np.uint8).astype(np.int32))
    idx, bit, active, n_direct, direct_val = (
        np.asarray(a) for a in emit_plan.emit_plan_jit(jnp.asarray(slab), d,
                                                       lc=lc)
    )
    header = pyemit.lzma_header(len(data), lc=lc, dict_size=dict_size)
    return emit_from_opstream(idx, bit, active, n_direct, direct_val,
                              header, lc=lc)
