"""The command as the benchmark's check runs it: no result without a card,
and none from a directory that holds only the benchmark's own files."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import spec
from pb_helpers import bench


def _run(cwd, cell):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=600)


def _has_result(stdout):
    try:
        json.loads(stdout.strip().splitlines()[-1])
        return True
    except (IndexError, ValueError):
        return False


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(spec.ROOT, bench()["workloads"][0]["name"])
    assert p.returncode == 2 and not _has_result(p.stdout)


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    for d in bench()["paths"]:
        shutil.copytree(spec.ROOT / d, tmp_path / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, bench()["workloads"][0]["name"])
    assert p.returncode != 0 and not _has_result(p.stdout)
