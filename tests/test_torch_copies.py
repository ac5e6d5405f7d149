"""The port's package boundary: verbatim copies stay byte-identical to their
``repro`` sources, and ``repro_torch`` never imports JAX or ``repro``."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"


def _verbatim():
    files = sorted((REF / "configs").glob("*.py"))
    for pkg in ("core", "index", "obs"):
        files += sorted((REF / pkg).glob("*.py"))
    files += [REF / "diffusion" / f for f in ("tiers.py", "transfer.py", "prefetch.py")]
    files += [REF / "dispatch_vec" / "__init__.py", REF / "checkpoint" / "__init__.py"]
    files += [REF / "runtime" / f for f in
              ("router.py", "admission.py", "chaos.py", "fault_tolerance.py",
               "elastic.py")]
    files += [REF / "data" / f for f in ("__init__.py", "pipeline.py")]
    return [str(p.relative_to(REF)) for p in files]


VERBATIM = _verbatim()
PORT_FILES = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py"))
_ABS_REPRO = re.compile(r"^\s*(from|import)\s+repro(\.|\s|$)", re.M)
_JAX = re.compile(r"^\s*(import\s+jax|from\s+jax)|ml_dtypes", re.M)


# copies the port extends: every line of the reference's file, in order,
# with lines of the port's own between them (``ArchConfig``'s latent
# attention, YaRN and DeepSeek MoE fields, with defaults that leave every
# architecture of the reference as it is; the JAX package has no such model)
EXTENDED = ("configs/base.py",)


def _keeps_every_line(port: bytes, ref: bytes) -> bool:
    rest = iter(port.splitlines())
    return all(any(line == mine for mine in rest) for line in ref.splitlines())


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_is_byte_identical(rel):
    port, ref = (PORT / rel).read_bytes(), (REF / rel).read_bytes()
    if rel in EXTENDED:
        assert _keeps_every_line(port, ref), rel
    else:
        assert port == ref, rel


def _ref_registry():
    from repro.configs import ALL_ARCHS, get_arch
    return [get_arch(a) for a in ALL_ARCHS]


@pytest.mark.parametrize("ref", _ref_registry(), ids=lambda a: a.name)
def test_extended_arch_config_behaves_as_the_reference(ref):
    """``configs/base.py``'s added lines change nothing of the reference's
    architectures: the port's ``ArchConfig`` made from a reference
    architecture's fields, its added fields at their defaults, counts the
    same parameters and reduces to the same fields."""
    from dataclasses import asdict, fields

    from repro_torch.configs.base import ArchConfig
    port = ArchConfig(**asdict(ref))
    added = [f for f in fields(ArchConfig) if f.name not in asdict(ref)]
    assert added and all(getattr(port, f.name) == f.default for f in added)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    small, ref_small = asdict(port.reduced()), asdict(ref.reduced())
    assert {k: small[k] for k in ref_small} == ref_small
    assert all(small[f.name] == f.default for f in added)


def test_verbatim_set_covers_the_jax_free_control_plane():
    assert len(VERBATIM) > 30
    assert "configs/paper_workloads.py" in VERBATIM
    rel = "configs/paper_workloads.py"
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes()


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_neither_jax_nor_repro(rel):
    text = (PORT / rel).read_text()
    assert not _JAX.search(text), rel
    assert not _ABS_REPRO.search(text), rel


def test_chip_smoke_imports_neither_jax_nor_repro():
    text = (SRC.parent / "chip_smoke.py").read_text()
    assert not _JAX.search(text)
    assert not _ABS_REPRO.search(text)


def test_port_files_cover_training_and_the_examples():
    for rel in ("optim/adamw.py", "runtime/train_loop.py", "launch/train.py",
                "examples/__init__.py", "examples/train_100m.py",
                "examples/quickstart.py", "examples/serve_diffusion.py",
                "examples/elastic_failover.py", "trips.py",
                "models/sharding.py", "launch/mesh.py", "launch/shardings.py",
                "runtime/compression.py", "launch/dryrun.py", "launch/op_analysis.py",
                "launch/perf.py"):
        assert rel in PORT_FILES, rel


def test_launcher_imports_with_jax_and_repro_blocked():
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None          # any import of them raises ImportError
import repro_torch
import repro_torch.launch.serve
import repro_torch.launch.train
import repro_torch.examples.quickstart
import repro_torch.examples.serve_diffusion
import repro_torch.examples.elastic_failover
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = [k for k, v in sys.modules.items() if v is not None and (
    k in ("jax", "jaxlib", "ml_dtypes", "repro") or k.startswith(("jax.", "repro.")))]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
