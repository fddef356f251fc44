"""The chip smoke test and the benchmark measure a GPU and nothing else:
without one they exit non-zero and print no result line (no CPU
fallback).  Decided inside each test, in a child process on the CPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_gpu():
    r = run([str(REPO / "chip_smoke.py")], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_refuses(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_without_gpu():
    r = run([str(REPO / "bench.py"), "--calls", "1", "--rounds", "1"], REPO)
    assert r.returncode != 0
    assert '"metric"' not in r.stdout
    assert "JAX found none" in r.stderr
