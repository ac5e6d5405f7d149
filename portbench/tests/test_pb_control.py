"""On the card: each cell at its own size with its control, the reference
in float8 put in the program's place.  The program's numbers stay within
the cell's limits and the control's break at least one of them; and a
serving cell with one replica's session caches left unfilled reads
``correct`` false.  Run with
``python -m pytest -m cuda portbench/tests/test_pb_control.py`` on a card."""

import json
import subprocess
import sys
import time

import pytest

from portbench import spec
from pb_helpers import bench, one_replica_state_unchanged

CELLS = [w["name"] for w in bench()["workloads"]]
SERVE = [c for c in CELLS if spec.find_cell(c).cell["driver"] == "serve"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", name,
                        "--seed", str(2**31 + 77), "--seconds", "10", "--trace", "0",
                        "--control", "1"], cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    limits = spec.find_cell(name).cell["limits"]
    assert out["correct"], out["checks"]
    assert any(out["checks"]["control_" + k]["value"] > v
               for k, v in limits.items() if "control_" + k in out["checks"]), out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVE)
def test_one_replica_fault_fails_at_the_cells_size(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.run import build_result
    cell = spec.find_cell(name)
    res = spec.driver(cell).run(cell, 2**31 + 81, 10.0, False, "cuda", time.perf_counter(),
                                tamper=one_replica_state_unchanged)
    out = build_result(cell, res, False, torch.cuda.get_device_name(0))
    assert not out["correct"], out["checks"]
