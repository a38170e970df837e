"""The benchmark runs only on a CUDA card: without one it exits 2 and prints
no result; in a directory that holds only ``BENCHMARK.json`` and the
benchmark it exits with another code than 0 and prints no result."""

import os
import shutil
import subprocess
import sys

from benchmark import harness

ARGS = ["-m", "benchmark.run", "--workload", "ft3d_eval", "--seed", str(2**33 + 1),
        "--seconds", "1", "--trace", "0"]


def bench(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *ARGS], capture_output=True, text=True, cwd=cwd,
                          env=env, timeout=300)


def test_no_card_no_result():
    out = bench(harness.ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CPU fallback" in out.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    out = bench(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
