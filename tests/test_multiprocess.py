"""True multi-process jax.distributed execution:
two OS processes join one distributed job; the fused-Schur LM solve's
collectives cross the process boundary via Gloo (the CPU stand-in for
NCCL across hosts)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.slow
def test_two_process_distributed_solve():
    env = dict(os.environ)
    env.pop("MPSMOKE_RANK", None)
    out = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "multiprocess_smoke.py"),
         "--procs", "2", "--devices-per-proc", "2"],
        capture_output=True, text=True, timeout=540, env=env, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "OK" in out.stdout
