"""ctypes bindings for the native optimum-parse engine.

The C++ library (runtime/native/optparse.cpp) implements the rep-aware
exact-ctx-state Viterbi DP and the exact adaptive cost/train pass; this
module owns the layout contract (offset vector from ops/tables.py) and
the numpy marshalling.  All semantics are parity-tested against the
pure-Python oracle (runtime/pyemit.py) in tests/test_optparse.py.
"""
from __future__ import annotations

import ctypes
import os
from functools import lru_cache

import numpy as np

from ..ops import tables as T
from ..utils import native_build

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "runtime",
                           "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmeg_opt.so")

# offset vector consumed by optparse.cpp (enum order there)
_OFFSETS = np.asarray([
    T.IS_MATCH, T.IS_REP, T.IS_REP_G0, T.IS_REP_G1, T.IS_REP_G2,
    T.IS_REP0_LONG, T.LEN, T.REP_LEN, T.DIST_SLOT, T.ALIGN, T.POS_CODER,
    T.LIT, T.POS_BITS_MAX, T.MATCH_LEN_MAX,
    T.LEN_CHOICE1, T.LEN_CHOICE2, T.LEN_LOW, T.LEN_MID, T.LEN_HIGH,
], dtype=np.int32)

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)


@lru_cache(maxsize=1)
def _load():
    """Load (building if needed) the native library; None on failure."""
    try:
        native_build.make(_NATIVE_DIR, "libmeg_opt.so")
    except (OSError, RuntimeError):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    ct = lib.meg_cost_train
    ct.restype = ctypes.c_int64
    ct.argtypes = [_U8P, ctypes.c_int64, _U32P, _U32P, ctypes.c_int32,
                   _I32P, _I32P, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, _I64P, _I32P, ctypes.c_int64]
    vt = lib.meg_optparse_viterbi
    vt.restype = ctypes.c_int64
    vt.argtypes = [_U8P, ctypes.c_int64, _I32P, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                   _I32P, _I32P, ctypes.c_int32, _I32P, _I32P,
                   ctypes.c_int32, _I64P, _I32P, ctypes.c_int64, _U32P,
                   _U32P]
    lp = lib.meg_lcp
    lp.restype = None
    lp.argtypes = [_U8P, ctypes.c_int64, _I32P, _I32P]
    return lib


def available() -> bool:
    return _load() is not None


def _p(a, t):
    return a.ctypes.data_as(t)


def cost_train(data: np.ndarray, slab: np.ndarray, lc: int = 0,
               nwin: int = 0, win_size: int = 0, dists=None):
    """Exact adaptive cost of a parse.

    Returns (perplexity, trained_probs[, snapshots]) — snapshots of the
    model at each win_size boundary when nwin > 0 (snapshot w = model
    state entering position w * win_size; window 0 is the fresh model).
    dists: optional full-width per-position MATCH distances (wide-block
    mode, > 1 MiB; overrides the packed 20-bit dist field).
    """
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(data, np.uint8)
    slab = np.ascontiguousarray(slab, np.uint32)
    if dists is not None:
        dists = np.ascontiguousarray(dists, np.uint32)
    probs = np.ascontiguousarray(T.init_probs_np(lc=lc))
    stride = probs.shape[-1]
    snaps = np.zeros((max(nwin, 1), stride), np.int32)
    log2 = np.ascontiguousarray(T.LOG2_TABLE_NP)
    perp = lib.meg_cost_train(
        _p(data, _U8P), len(data), _p(slab, _U32P),
        None if dists is None else _p(dists, _U32P), lc,
        _p(probs, _I32P),
        _p(snaps, _I32P) if nwin > 0 else None, nwin, win_size, stride,
        _p(log2, _I64P), _p(_OFFSETS, _I32P), len(_OFFSETS))
    if perp < 0:
        raise ValueError("malformed slab in native cost_train")
    if nwin > 0:
        return perp, probs, snaps
    return perp, probs


def lcp(data: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Native Kasai LCP array (semantics of match/suffix.lcp_array)."""
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(data, np.uint8)
    sa = np.ascontiguousarray(sa, np.int32)
    out = np.zeros(len(sa), np.int32)
    lib.meg_lcp(_p(data, _U8P), len(data), _p(sa, _I32P), _p(out, _I32P))
    return out


def viterbi_parse(data: np.ndarray, probs_win: np.ndarray,
                  cand_dist: np.ndarray, cand_len: np.ndarray,
                  rank: np.ndarray, sparse: np.ndarray,
                  lc: int = 0, win_size: int = 0, wide: bool = False):
    """One Viterbi pass over windowed static prices -> packed slab.

    probs_win: [nwin, stride] price snapshots (nwin == 1 reproduces the
    single static-price parse; win_size ignored then).
    wide: also return the full-width distance array (blocks > 1 MiB,
    where the packed 20-bit dist field truncates)."""
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(data, np.uint8)
    n = len(data)
    probs_win = np.ascontiguousarray(np.atleast_2d(probs_win), np.int32)
    nwin, stride = probs_win.shape
    if win_size <= 0:
        win_size = max(n, 1)
    cand_dist = np.ascontiguousarray(cand_dist, np.int32)
    cand_len = np.ascontiguousarray(cand_len, np.int32)
    M = cand_dist.shape[1] if cand_dist.ndim == 2 else 0
    rank = np.ascontiguousarray(rank, np.int32)
    sparse = np.ascontiguousarray(sparse, np.int32)
    K = sparse.shape[0]
    log2 = np.ascontiguousarray(T.LOG2_TABLE_NP)
    slab = np.empty(n, np.uint32)
    dw = np.empty(n, np.uint32) if wide else None
    rc = lib.meg_optparse_viterbi(
        _p(data, _U8P), n, _p(probs_win, _I32P), nwin, win_size, stride,
        lc, _p(cand_dist, _I32P), _p(cand_len, _I32P), M,
        _p(rank, _I32P), _p(sparse, _I32P), K, _p(log2, _I64P),
        _p(_OFFSETS, _I32P), len(_OFFSETS), _p(slab, _U32P),
        None if dw is None else _p(dw, _U32P))
    if rc < 0:
        raise ValueError("native viterbi failed")
    if wide:
        return slab, dw
    return slab
