"""The port's examples (``repro_torch.examples.quickstart``,
``serve_diffusion`` and ``elastic_failover``) against the reference's
``examples/``.

Each runs as ``python -m repro_torch.examples.<name> --device cpu``, beside
the reference's script under ``JAX_PLATFORMS=cpu``, all six processes
started together.  quickstart's output (the DES, no device) equals the
reference's line for line; serve_diffusion's counters (served, prefix hit,
prefills, decode steps, replicas; not p50, p99 or wall) equal the
reference's for each of the three policies; elastic_failover's scale
events, sizing, recovery actions and elastic events equal the reference's,
and its losses (random weights of their own) are finite.
"""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
EXAMPLES = ("quickstart", "serve_diffusion", "elastic_failover")
TIMEOUT = 900              # each ~10-60 s alone; six run side by side
POLICIES = ("first-available", "max-compute-util", "good-cache-compute")
COUNTERS = ("served", "prefix_hit", "prefills", "decode_steps", "replicas")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "2",
           "JAX_PLATFORMS": "cpu"}
    procs = {}
    for name in EXAMPLES:
        port = [sys.executable, "-m", f"repro_torch.examples.{name}"]
        if name != "quickstart":
            port += ["--device", "cpu"]
        for side, cmd in (("port", port),
                          ("reference", [sys.executable, str(ROOT / "examples" / f"{name}.py")])):
            log = tmp / f"{side}_{name}.log"
            procs[(side, name)] = (subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=open(log, "w"),
                stderr=subprocess.STDOUT), log)
    out = {}
    try:
        for key, (p, log) in procs.items():
            p.wait(timeout=TIMEOUT)
            text = log.read_text()
            out[key] = text if p.returncode == 0 else f"rc {p.returncode}\n{text[-3000:]}"
            assert p.returncode == 0, out[key]
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _lines(text):
    """The example's own lines (no library warnings)."""
    return [ln for ln in text.splitlines()
            if not re.match(r"^(\[rank|W\d{4}|I\d{4}|\S+Warning|  warnings\.warn)", ln)]


def test_quickstart_prints_the_reference_lines(runs):
    port, ref = (_lines(runs[(s, "quickstart")]) for s in ("port", "reference"))
    assert any(ln.startswith("workload: 25000 tasks") for ln in ref)
    assert port == ref


def _counters(text):
    rows = {}
    for ln in _lines(text):
        m = re.match(r"^(\S+)\s+served=\s*(\d+) prefix_hit=\s*(\d+)% prefills=\s*(\d+) "
                     r"decode_steps=\s*(\d+) replicas=(\d+) ", ln)
        if m:
            rows[m.group(1)] = dict(zip(COUNTERS, map(int, m.groups()[1:])))
    return rows


@pytest.mark.parametrize("policy", POLICIES)
def test_serve_diffusion_counters_equal_the_reference(runs, policy):
    port, ref = (_counters(runs[(s, "serve_diffusion")]) for s in ("port", "reference"))
    assert set(ref) == set(POLICIES)
    assert port[policy] == ref[policy]
    assert port[policy]["served"] == 40


def test_serve_diffusion_prints_the_reference_lines_but_timings(runs):
    strip = re.compile(r" p50=.*$")
    port, ref = ([strip.sub("", ln) for ln in _lines(runs[(s, "serve_diffusion")])]
                 for s in ("port", "reference"))
    assert port == ref


def _losses(text):
    return [float(x) for x in re.findall(r"loss (-?[\d.]+|nan|inf)", text)]


def test_elastic_failover_events_equal_the_reference(runs):
    port, ref = (_lines(runs[(s, "elastic_failover")]) for s in ("port", "reference"))
    # every line but the losses: scale-up, sizing, recovery, scale-down,
    # steps trained and elastic events
    strip = re.compile(r"loss -?[\d.]+|loss nan|loss inf")
    assert [strip.sub("loss", ln) for ln in port] == [strip.sub("loss", ln) for ln in ref]
    assert any(ln.startswith("failure recovery: lost=['host1']") for ln in ref)
    assert any("elastic events: [5, 4]" in ln for ln in ref)
    losses = _losses("\n".join(port))
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses), losses


@pytest.mark.parametrize("name", ["serve_diffusion", "elastic_failover"])
def test_examples_run_on_the_card_unless_asked(name):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("checks the default on a host without a card")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises((RuntimeError, AssertionError)):
        mod.main([])
