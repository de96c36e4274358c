"""The card's identity for result lines, read without touching JAX."""
from __future__ import annotations

import subprocess


def card_line() -> str:
    """`name, power.limit` of every card, as nvidia-smi reports them.

    nvidia-smi runs as a child process, so no second process ever opens
    the card through JAX (one JAX process per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + out.stderr.strip())
    return out.stdout.strip()
