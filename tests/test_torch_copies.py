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
    files = [p for p in sorted((REF / "configs").glob("*.py"))
             if p.name != "paper_workloads.py"]
    for pkg in ("core", "index", "obs"):
        files += sorted((REF / pkg).glob("*.py"))
    files += [REF / "diffusion" / f for f in ("tiers.py", "transfer.py", "prefetch.py")]
    files += [REF / "dispatch_vec" / "__init__.py"]
    files += [REF / "runtime" / f for f in
              ("router.py", "admission.py", "chaos.py", "fault_tolerance.py")]
    return [str(p.relative_to(REF)) for p in files]


VERBATIM = _verbatim()
PORT_FILES = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py"))
_ABS_REPRO = re.compile(r"^\s*(from|import)\s+repro(\.|\s|$)", re.M)
_JAX = re.compile(r"^\s*(import\s+jax|from\s+jax)|ml_dtypes", re.M)


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_is_byte_identical(rel):
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes(), rel


def test_verbatim_set_covers_the_jax_free_control_plane():
    assert len(VERBATIM) > 30
    assert "configs/paper_workloads.py" not in VERBATIM
    assert not (PORT / "configs" / "paper_workloads.py").exists()


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_neither_jax_nor_repro(rel):
    text = (PORT / rel).read_text()
    assert not _JAX.search(text), rel
    assert not _ABS_REPRO.search(text), rel


def test_chip_smoke_imports_neither_jax_nor_repro():
    text = (SRC.parent / "chip_smoke.py").read_text()
    assert not _JAX.search(text)
    assert not _ABS_REPRO.search(text)


def test_launcher_imports_with_jax_and_repro_blocked():
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None          # any import of them raises ImportError
import repro_torch
import repro_torch.launch.serve
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
