"""CLI + compressor: end-to-end file round trips."""
import subprocess
import sys

import pytest

from megalania_tpu import compressor
from megalania_tpu.anneal.config import AnnealConfig

CFG = AnnealConfig(chains=8, max_candidates=8, max_walk=32, top_k=12)
DATA = b"colorless green ideas sleep furiously. " * 6


def test_compress_roundtrip_single_block():
    blob = compressor.compress(DATA, CFG, total_moves=400)
    assert compressor.decompress(blob) == DATA
    assert len(blob) < len(DATA)


def test_compress_roundtrip_multi_block():
    cfg = AnnealConfig(chains=8, max_candidates=8, max_walk=32, top_k=12,
                       block_size=100)
    blob = compressor.compress(DATA, cfg, total_moves=400)
    assert blob[:4] == b"MLZ1"
    assert compressor.decompress(blob) == DATA


def test_cli_end_to_end(tmp_path):
    src = tmp_path / "input.txt"
    src.write_bytes(DATA)
    out = tmp_path / "out.lzma"
    dec = tmp_path / "dec.txt"
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin"}
    r = subprocess.run(
        [sys.executable, "-m", "megalania_tpu.cli", "compress", str(src),
         "-o", str(out), "--chains", "8", "--moves", "200", "--quiet"],
        cwd="/root/repo", env=env, capture_output=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr.decode()
    assert out.exists() and out.stat().st_size < len(DATA)
    r = subprocess.run(
        [sys.executable, "-m", "megalania_tpu.cli", "decompress", str(out),
         "-o", str(dec)],
        cwd="/root/repo", env=env, capture_output=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr.decode()
    assert dec.read_bytes() == DATA
    r = subprocess.run(
        [sys.executable, "-m", "megalania_tpu.cli", "verify", str(src),
         str(out)],
        cwd="/root/repo", env=env, capture_output=True, timeout=120,
    )
    assert r.returncode == 0 and b"OK" in r.stdout


def test_cli_rejects_retired_pallas_kernel():
    """A retired kernel name ('pallas') must be
    rejected at the argparse layer, not crash later in AnnealConfig."""
    from megalania_tpu import cli
    with pytest.raises(SystemExit):
        cli.main(["compress", "x", "--kernel", "pallas"])


def test_progress_printer_handles_mesh_info(capsys):
    """The progress printer must accept both the
    per-block info dict and the mesh-path one (no 'epochs'/'block')."""
    import time as _t
    from megalania_tpu import cli
    cb = cli._progress_printer(_t.time())
    cb({"block": 1, "blocks": 4, "best_bytes": 12.5, "iter": 3,
        "iters": 10, "epochs": 2, "moves": 24})
    cb({"mesh_blocks": 4, "best_bytes": 50.0, "iter": 3, "iters": 10,
        "moves": 96})                      # mesh dict: no block/epochs
    err = capsys.readouterr().err
    assert "block 2/4" in err and "mesh 4 blocks" in err
