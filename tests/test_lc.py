"""lc>0 literal-context model.

The reference hardcodes lc=0 with a todo
(/root/reference/src/lzma_packet_encoder.c:113); xz's default is lc=3 —
a known ratio lever on text.  These tests pin the three contracts:
cost scan == python oracle == emitted size, bit-exact xz decode of the
emitted stream, and the annealer end-to-end at lc=3.
"""
import lzma
import subprocess
import tempfile
import os

import numpy as np
import pytest
import jax.numpy as jnp

from megalania_tpu import compressor
from megalania_tpu.anneal.config import AnnealConfig
from megalania_tpu.match import candidates as C_
from megalania_tpu.match.suffix import build_lce
from megalania_tpu.models import packets as P
from megalania_tpu.ops import scan_cost
from megalania_tpu.runtime import emit as emit_mod
from megalania_tpu.runtime import pyemit
from megalania_tpu.utils import fixedpoint as fp

DATA = (b"literal context modelling helps text: the the the THE tHe "
        b"thorough, those, them, thus; 012345 012345 numbers too. " * 4)


def greedy_parse(data: bytes) -> np.ndarray:
    arr = np.frombuffer(data, np.uint8)
    idx = build_lce(arr)
    tab = C_.build_candidates(arr, 8, 64, idx)
    return np.asarray(C_.greedy_slab(arr, tab))


@pytest.mark.parametrize("lc", [1, 3])
def test_lc_cost_matches_oracle_and_emit(lc):
    slab = greedy_parse(DATA)
    want = pyemit.parse_cost(DATA, slab, lc=lc)
    hi, lo, _, _ = scan_cost.parse_cost_jit(
        jnp.asarray(slab),
        jnp.asarray(np.frombuffer(DATA, np.uint8).astype(np.int32)),
        lc=lc)
    assert fp.to_int(hi, lo) == want

    blob = pyemit.emit(DATA, slab, lc=lc)
    assert blob[0] == lc            # props byte = (pb*5+lp)*9+lc
    assert abs(len(blob) - (18 + want / 16384.0)) < 2.5
    assert lzma.decompress(blob, format=lzma.FORMAT_ALONE) == DATA

    # native op-stream emitter agrees byte-for-byte (or falls back)
    blob2 = emit_mod.emit(DATA, slab, lc=lc)
    assert blob2 == blob


def test_lc_changes_literal_cost():
    """lc=3 must actually condition on the previous byte: the cost of a
    text parse differs from lc=0 (same parse, different model)."""
    slab = greedy_parse(DATA)
    assert (pyemit.parse_cost(DATA, slab, lc=3)
            != pyemit.parse_cost(DATA, slab, lc=0))


def test_lc_xz_roundtrip_external():
    """Decode with the real xz binary, not just liblzma."""
    slab = greedy_parse(DATA)
    blob = pyemit.emit(DATA, slab, lc=3)
    with tempfile.NamedTemporaryFile(suffix=".lzma", delete=False) as f:
        f.write(blob)
        path = f.name
    try:
        r = subprocess.run(["xz", "--format=lzma", "-dc", path],
                           capture_output=True)
        assert r.stdout == DATA
    finally:
        os.unlink(path)


def test_lc_compress_end_to_end():
    """Annealed compression at lc=3 (XLA path) round-trips and the
    engine accepts the config."""
    cfg = AnnealConfig(chains=8, max_candidates=8, max_walk=48, top_k=12,
                       lc=3)
    blob = compressor.compress(DATA, cfg, total_moves=8 * 60)
    assert blob[13 - 13] == 3       # props byte leads the header
    assert compressor.decompress(blob) == DATA


def test_lc_config_guard():
    with pytest.raises(ValueError):
        AnnealConfig(lc=9)
    with pytest.raises(ValueError):
        AnnealConfig(lp=1)
