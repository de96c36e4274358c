"""Build the repository's native libraries from their committed sources.

Every shared library is built at first use by its directory's Makefile
and never committed, so a binary can never be stale against its source.
The build runs under an exclusive file lock: concurrent processes (test
workers, a smoke run) build once and then all see the finished file.
"""
from __future__ import annotations

import fcntl
import os
import subprocess


def make(directory: str, target: str, variables: dict | None = None) -> None:
    """`make -C directory target`, serialized across processes.

    Raises RuntimeError with make's output when the build fails."""
    args = ["make", "-C", directory, "-s", target]
    args += [f"{k}={v}" for k, v in (variables or {}).items()]
    with open(os.path.join(directory, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = subprocess.run(args, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {target} in {directory} failed:\n"
            f"{proc.stdout}{proc.stderr}")
